"""Where the LN-GRU kernel's time goes, on one CUDA card.

Run from the root of a checkout:  python3 ln_gru_breakdown.py [--out results.json]

Builds copies of ``sheeprl_tpu_torch/csrc/ln_gru.cu`` with parts switched off
(into ``build/ln_gru_breakdown/``, one nvcc each, all started together) and
times each at the Dreamer-V3 shapes of ``chip_smoke.py`` phase 3, with the
launch plan the wrapper picks, as device ms per call replayed from a CUDA
graph over rotating copies of W (``chip_smoke.time_device``). The copies give
wrong results on purpose; only their time is read. Variants:

- ``full``: the kernel as it is;
- ``no_finish``: the second launch left out;
- ``no_fma``: the product's FMAs left out (the copies still run);
- ``no_copy``: the W and x copies left out (the FMAs run on stale shared memory);
- ``skeleton``: no copies, no FMAs, no second launch: launch, pipeline
  barriers, the K-lane and cluster reductions, the stores;
- ``empty``: the first launch returns at once, no second launch;
- ``empty_finish``: the first launch returns at once, the second runs.

Beside them, ``graph_node`` times one small PyTorch kernel per call, the cost
of any launch in a graph. Without CUDA, exits 1.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import math
import subprocess
import sys
from pathlib import Path

import torch

import chip_smoke
from sheeprl_tpu_torch.ops import gru
from sheeprl_tpu_torch.ops._build import BUILD_DIR, NVCC_FLAGS, find_nvcc

SOURCE = Path(gru.LN_GRU.source_path)

# (anchor in the source, text put before it, text put after it), per switch
SWITCHES = {
    "NO_COPY": [
        ("    if (s < n_stages) load_stage(s, s);\n", "#ifndef NO_COPY\n", "#endif\n"),
        ("    if (next < n_stages) load_stage(next, next % kStages);\n", "#ifndef NO_COPY\n", "#endif\n"),
    ],
    "NO_FMA": [
        ("    float4 wv[kKPerLane];\n", "#ifndef NO_FMA\n", ""),
        ("        acc[r][3] = fmaf(xk[i], wv[i].w, acc[r][3]);\n      }\n    }\n", "", "#endif\n"),
    ],
    "NO_FINISH": [("  cudaLaunchConfig_t cfg = {};\n  cfg.gridDim = dim3(B, ", "#ifdef NO_FINISH\n  return 0;\n#endif\n", "")],
    "EMPTY": [('  asm volatile("griddepcontrol.launch_dependents;\\n" ::: "memory");\n', "", "#ifdef EMPTY\n  return;\n#endif\n")],
}
VARIANTS = {
    "full": [],
    "no_finish": ["NO_FINISH"],
    "no_fma": ["NO_FMA"],
    "no_copy": ["NO_COPY"],
    "skeleton": ["NO_COPY", "NO_FMA", "NO_FINISH"],
    "empty": ["EMPTY", "NO_FINISH"],
    "empty_finish": ["EMPTY"],
}


def switched_source() -> str:
    src = SOURCE.read_text()
    for edits in SWITCHES.values():
        for anchor, before, after in edits:
            if src.count(anchor) != 1:
                raise RuntimeError(f"ln_gru.cu changed: anchor not found once: {anchor!r}")
            src = src.replace(anchor, before + anchor + after)
    return src


def build_variants() -> dict:
    out_dir = BUILD_DIR.parent / "ln_gru_breakdown"
    out_dir.mkdir(parents=True, exist_ok=True)
    src = out_dir / "ln_gru_switched.cu"
    src.write_text(switched_source())
    procs = {}
    for name, switches in VARIANTS.items():
        lib = out_dir / f"{name}.so"
        cmd = [find_nvcc(), *NVCC_FLAGS, *(f"-D{s}" for s in switches), "-o", str(lib), str(src)]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True), lib)
    libs = {}
    for name, (proc, lib) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {name}:\n{log}")
        cdll = ctypes.CDLL(str(lib))
        cdll.ln_gru_forward.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 6 + [ctypes.c_float, ctypes.c_void_p]
        cdll.ln_gru_forward.restype = ctypes.c_int
        libs[name] = cdll
    return libs


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--out", default=None, help="also write the rows to this JSON file")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("[ln-gru-breakdown] torch.cuda.is_available() is false: this needs a CUDA card", file=sys.stderr)
        return 1
    card = chip_smoke.card_line()
    print(f"[ln-gru-breakdown] card: {card}", flush=True)
    device = torch.device("cuda", 0)
    libs = build_variants()
    _, consts = gru._kernel()
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    rows = []
    for preset, B, K, H in chip_smoke.GRU_SHAPES:
        inp, hx, w, b, scale, bias = chip_smoke.gru_case(B, K, H, seed=B + K, device=device)
        plan = gru._launch_plan(B, K, H, *consts, sms)
        weights = [w.clone() for _ in range(max(2, math.ceil(2 * chip_smoke.L2_BYTES / (4 * K * 3 * H))))]
        scratch = torch.empty(B * (3 * H + 2 * plan.groups), device=device)
        out = torch.empty(B, H, device=device)
        row = {"preset": preset, "B": B, "K": K, "H": H, "plan": vars(plan)}
        for name, lib in libs.items():
            def call(wi, lib=lib):
                err = lib.ln_gru_forward(
                    inp.data_ptr(), hx.data_ptr(), wi.data_ptr(), b.data_ptr(), scale.data_ptr(),
                    bias.data_ptr(), scratch.data_ptr(), out.data_ptr(), B, K, H, plan.tile_b,
                    plan.cluster, plan.k_chunk, 1e-3, torch.cuda.current_stream().cuda_stream,
                )
                if err != 0:
                    raise RuntimeError(f"{name}: cudaError {err}")
            row[f"{name}_ms"] = chip_smoke.time_device(call, weights, replays=50)
        row["graph_node_ms"] = chip_smoke.time_device(lambda wi: out.fill_(0.0), weights, replays=50)
        rows.append(row)
        print(f"[ln-gru-breakdown] {json.dumps(row)}", flush=True)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps({"card": card, "rows": rows}, indent=2))
    print(card)
    return 0


if __name__ == "__main__":
    sys.exit(main())

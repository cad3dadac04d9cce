"""Chip smoke of the PyTorch port (sheeprl_tpu_torch) on one CUDA card.

Run from the root of a checkout:  python3 chip_smoke.py [--out results.json]

Phases, in order; any failure exits non-zero and prints no result line:

1. report the card (nvidia-smi name and power limit) and the torch build;
   without CUDA, exit 1;
2. build every hand-written kernel of the port from csrc/ (one nvcc per
   source, all started together) and print the build time;
3. hold each kernel against its plain PyTorch version on the card (TF32 off
   for the plain version) at the Dreamer-V3 shapes, forward and gradient, and
   time the kernel, the plain version and one PyTorch library call computing
   the same product, each over rotating copies of the weights so that every
   launch reads them from device memory, as a serving tick does: device time
   per call (replayed from a CUDA graph) and wall time per eager call;
4. the main path: compose ``exp=dreamer_v3 env=dummy`` at the S preset (full
   width), build the agent on the card from the seed, write a checkpoint and
   its config.yaml into a temporary run dir, and serve it through
   ``serve_main`` with 4 slots and 4 concurrent env sessions of 512 steps;
   the kernels' launch counts are zeroed just before and read just after, and
   every kernel must have been launched at least once per tick. Then the
   batched serve step on the card is held against the same step on the CPU
   (the plain path) on the same weights, observations and noise. Last,
   serving ticks are profiled (device time by kernel, busy share);
5. print the ``kernels`` JSON line, the card line, and the final result line.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

from sheeprl_tpu_torch.ops import KERNELS, LN_GRU, ln_gru_step, ln_gru_step_plain
from sheeprl_tpu_torch.ops._build import build

# H100 SXM data-sheet peaks (dense): device memory rate, and float32 without
# tensor cores, the rate the LayerNorm-GRU kernel's FMAs run at
PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_FLOPS = 67e12
L2_BYTES = 50 * 1024 * 1024

# kernel vs plain: both float32 with TF32 off; sums over K <= 5120 products are
# taken in another order (split-K partials vs cuBLAS), and the LayerNorm
# divides the gate errors by the row's spread, so agreement to ~1e-6 is
# expected and 1e-4 is the bar
GRU_ATOL = 1e-4
# the batched serve step on the card vs on the CPU: the same float32 math
# through cuDNN/cuBLAS (TF32 off) vs the CPU kernels, 8 recurrent steps deep
SERVE_H_ATOL = 1e-3

# (preset, B, K, H): DV3 recurrent cells, K = dense_units + recurrent size
GRU_SHAPES = [
    ("S", 1, 1024, 512),
    ("S", 4, 1024, 512),
    ("S", 16, 1024, 512),
    ("S", 64, 1024, 512),
    ("L", 4, 2816, 2048),
    ("XL", 4, 5120, 4096),
]
MAIN_SHAPE = ("S", 4, 1024, 512)  # serving: 4 slots at the S preset

SLOTS = 4
SESSIONS = 4
MAX_SESSION_STEPS = 512  # long enough that the one cold first tick is not the p99


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def gru_case(B: int, K: int, H: int, seed: int, device) -> tuple:
    rng = np.random.default_rng(seed)
    arrs = (
        rng.standard_normal((B, K)),
        rng.standard_normal((B, H)),
        rng.standard_normal((K, 3 * H)) / math.sqrt(K),
        0.1 * rng.standard_normal(3 * H),
        1.0 + 0.1 * rng.standard_normal(3 * H),
        0.1 * rng.standard_normal(3 * H),
    )
    return tuple(torch.tensor(a, dtype=torch.float32, device=device) for a in arrs)


def time_calls(fn, weights, iters: int) -> float:
    """Mean wall ms per call of ``fn(w)`` cycling through ``weights``, host work
    (Python, allocation, launch) included: what one eager call costs."""
    for w in weights[:3]:
        fn(w)
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for i in range(iters):
        fn(weights[i % len(weights)])
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def time_device(fn, weights, replays: int = 20) -> float:
    """Mean device ms per call of ``fn(w)``: the calls, cycling through
    ``weights``, are captured once in a CUDA graph and replayed, so no host
    work sits between them."""
    calls = 2 * len(weights)
    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(stream):
        for w in weights[:3]:
            fn(w)
    torch.cuda.current_stream().wait_stream(stream)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for i in range(calls):
            fn(weights[i % len(weights)])
    graph.replay()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    del graph
    return start.elapsed_time(end) / (replays * calls)


def gru_bound(B: int, K: int, H: int) -> tuple:
    n = 3 * H
    bytes_moved = 4 * (B * K + B * H + K * n + 3 * n + B * H)
    flops = 2 * B * K * n + 12 * B * n
    t_bytes = bytes_moved / PEAK_BYTES_PER_S
    t_ops = flops / PEAK_F32_FLOPS
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def check_gru(device) -> dict:
    rows = []
    for preset, B, K, H in GRU_SHAPES:
        inp, hx, w, b, scale, bias = gru_case(B, K, H, seed=B + K, device=device)
        torch.backends.cuda.matmul.allow_tf32 = False
        ref = ln_gru_step_plain(inp, hx, w, b, scale, bias)
        out = ln_gru_step(inp, hx, w, b, scale, bias)
        torch.cuda.synchronize()
        err = float((out - ref).abs().max())
        if not (err <= GRU_ATOL and torch.isfinite(out).all()):
            raise AssertionError(f"LN-GRU kernel vs plain at {preset} B={B}: max abs err {err} > {GRU_ATOL}")
        row = {"preset": preset, "B": B, "K": K, "H": H, "max_abs_err": err}
        if (preset, B) == ("S", 4):
            args = [t.clone().requires_grad_(True) for t in (inp, hx, w, b, scale, bias)]
            g_out = torch.randn(B, H, device=device, generator=torch.Generator(device).manual_seed(0))
            grads_k = torch.autograd.grad(ln_gru_step(*args), args, g_out)
            grads_p = torch.autograd.grad(ln_gru_step_plain(*args), args, g_out)
            gerr = max(float((a - p).abs().max()) for a, p in zip(grads_k, grads_p))
            if gerr > GRU_ATOL:
                raise AssertionError(f"LN-GRU gradient vs plain at S B=4: max abs err {gerr}")
            row["grad_max_abs_err"] = gerr
        copies = max(2, math.ceil(2 * L2_BYTES / (4 * K * 3 * H)))
        weights = [w.clone() for _ in range(copies)]
        fns = {
            "": lambda wi: ln_gru_step(inp, hx, wi, b, scale, bias),
            "plain_": lambda wi: ln_gru_step_plain(inp, hx, wi, b, scale, bias),
            "library_": lambda wi: torch.matmul(inp, wi),
        }
        for prefix, fn in fns.items():
            row[f"{prefix}ms"] = time_device(fn, weights)
        for prefix, fn in fns.items():
            row[f"{prefix}call_ms"] = time_calls(fn, weights, 200 if K * H < 4_000_000 else 50)
        row["bound_ms"], row["bound_by"] = gru_bound(B, K, H)
        del weights
        rows.append(row)
        print(f"[chip-smoke] ln_gru {json.dumps(row)}", flush=True)
    return {"rows": rows, "max_abs_err": max(r["max_abs_err"] for r in rows)}


def main_path(out_dir: str) -> dict:
    import yaml

    from sheeprl_tpu_torch.algos.dreamer_v3.agent import build_agent
    from sheeprl_tpu_torch.algos.dreamer_v3.serve import action_space_dims
    from sheeprl_tpu_torch.config import compose
    from sheeprl_tpu_torch.interop.flax_to_torch import agent_to_flax
    from sheeprl_tpu_torch.parallel.fabric import Fabric
    from sheeprl_tpu_torch.serve.main import serve_main
    from sheeprl_tpu_torch.utils.checkpoint import save_checkpoint
    from sheeprl_tpu_torch.utils.env import make_env

    cfg = compose(
        [
            "exp=dreamer_v3",
            "env=dummy",
            "algo.cnn_keys.encoder=[rgb]",
            "algo.mlp_keys.encoder=[state]",
            "env.capture_video=False",
            f"+env.wrapper.n_steps={MAX_SESSION_STEPS}",
        ]
    )
    fabric = Fabric(accelerator="auto", float32_matmul_precision=cfg.float32_matmul_precision)
    env = make_env(cfg, cfg.seed, 0)()
    actions_dim, is_continuous = action_space_dims(env.action_space)
    agent = build_agent(fabric, actions_dim, is_continuous, cfg, env.observation_space, cfg.seed)
    n_params = sum(p.numel() for p in agent.parameters())
    run_dir = os.path.join(out_dir, "run")
    ckpt = os.path.join(run_dir, "version_0", "checkpoint", "ckpt_0_0.ckpt")
    save_checkpoint(ckpt, {"agent": agent_to_flax(agent)})
    with open(os.path.join(run_dir, "version_0", "config.yaml"), "w") as f:
        yaml.safe_dump(cfg.as_dict(), f, sort_keys=False)
    print(
        f"[chip-smoke] DV3 S agent: {n_params} parameters, recurrent K="
        f"{agent.world_model['recurrent_model'].cell.kernel.shape[0]}, 3H="
        f"{agent.world_model['recurrent_model'].cell.kernel.shape[1]}",
        flush=True,
    )
    del agent

    log_dir = os.path.join(out_dir, "serve")
    for spec in KERNELS:
        spec.launches = 0
    rc = serve_main(
        [
            f"checkpoint_path={run_dir}",
            f"serve.slots={SLOTS}",
            f"serve.sessions={SESSIONS}",
            f"serve.max_session_steps={MAX_SESSION_STEPS}",
            f"serve.log_dir={log_dir}",
        ]
    )
    launches = {spec.name: spec.launches for spec in KERNELS}
    with open(os.path.join(log_dir, "summary.json")) as f:
        summary = json.load(f)
    print(f"[chip-smoke] serve rc={rc} summary={json.dumps(summary)} launches={launches}", flush=True)
    if rc != 0:
        raise AssertionError(f"serve_main exited {rc}")
    if summary["sessions_completed"] != SESSIONS or summary["steps"] != SESSIONS * MAX_SESSION_STEPS:
        raise AssertionError(f"serving did not complete every session: {summary}")
    for name, count in launches.items():
        if count < summary["ticks"]:
            raise AssertionError(f"kernel {name} launched {count} times in {summary['ticks']} ticks")
    return {"summary": summary, "launches": launches, "ckpt": ckpt}


def serve_step_parity(ckpt: str) -> dict:
    """The batched DV3 serve step on the card vs on the CPU, same weights/noise."""
    from sheeprl_tpu_torch.algos.dreamer_v3.serve import get_serve_policy
    from sheeprl_tpu_torch.parallel.fabric import Fabric
    from sheeprl_tpu_torch.serve.main import build_serve_cfg
    from sheeprl_tpu_torch.utils.checkpoint import load_checkpoint

    state = load_checkpoint(ckpt)
    cfg = build_serve_cfg([f"checkpoint_path={ckpt}"])
    policies = {}
    for accel in ("gpu", "cpu"):
        fabric = Fabric(accelerator=accel, float32_matmul_precision="highest")
        policies[accel] = get_serve_policy(fabric, cfg, state)
    rng = np.random.default_rng(7)
    carries = {k: p.init_slots(SLOTS) for k, p in policies.items()}
    h_err, actions_equal, ticks = 0.0, 0, 8
    for _ in range(ticks):
        obs = {
            k: rng.integers(0, 256, (SLOTS, *s.shape)).astype(s.dtype)
            if np.issubdtype(s.dtype, np.integer)
            else rng.standard_normal((SLOTS, *s.shape)).astype(s.dtype)
            for k, s in policies["cpu"].obs_spec.items()
        }
        gumbel = -np.log(-np.log(rng.uniform(1e-12, 1.0, (SLOTS, policies["cpu"].noise_spec["repr"].size))))
        out = {}
        for accel, policy in policies.items():
            dev = policy.device
            obs_t = {k: torch.from_numpy(v).to(dev) for k, v in obs.items()}
            noise = {"repr": torch.tensor(gumbel, dtype=torch.float32, device=dev)}
            out[accel] = policy.step_slots(carries[accel], obs_t, noise)
            carries[accel] = out[accel][1]
        h_err = max(h_err, float((out["gpu"][1]["h"].cpu() - out["cpu"][1]["h"]).abs().max()))
        actions_equal += int(np.array_equal(out["gpu"][0].cpu().numpy(), out["cpu"][0].numpy()))
        if not torch.isfinite(out["gpu"][1]["h"]).all():
            raise AssertionError("non-finite recurrent state on the card")
    print(f"[chip-smoke] serve step card vs CPU: h max abs err {h_err}, actions equal {actions_equal}/{ticks}", flush=True)
    if h_err > SERVE_H_ATOL or actions_equal != ticks:
        raise AssertionError(f"serve step on the card disagrees with the CPU: h err {h_err}, actions {actions_equal}/{ticks}")
    return {"h_max_abs_err": h_err, "actions_equal": actions_equal, "ticks": ticks}


def profile_ticks(ckpt: str, ticks: int = 32) -> dict:
    """Where a serving tick's time goes: full-slot ticks of the slot table, as
    the serve verb configures it (TF32 per ``float32_matmul_precision``), under
    torch.profiler; device time by kernel, and the device's busy share of the
    ticks' wall time (the profiler's own host cost included)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from sheeprl_tpu_torch.algos.dreamer_v3.serve import get_serve_policy
    from sheeprl_tpu_torch.parallel.fabric import Fabric
    from sheeprl_tpu_torch.serve.main import build_serve_cfg
    from sheeprl_tpu_torch.serve.slots import SlotTable
    from sheeprl_tpu_torch.utils.checkpoint import load_checkpoint

    cfg = build_serve_cfg([f"checkpoint_path={ckpt}"])
    fabric = Fabric(accelerator="auto", float32_matmul_precision=cfg.float32_matmul_precision)
    policy = get_serve_policy(fabric, cfg, load_checkpoint(ckpt))
    table = SlotTable(policy, SLOTS, base_seed=0)
    obs = {k: spec.zeros(SLOTS) for k, spec in policy.obs_spec.items()}
    mask = np.ones(SLOTS, np.bool_)
    for _ in range(3):
        table.step(obs, mask)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(ticks):
            table.step(obs, mask)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    by_kernel, launches = {}, 0
    for ev in prof.events():
        if ev.device_type == DeviceType.CUDA:  # one event per kernel run on the card
            by_kernel[ev.name] = by_kernel.get(ev.name, 0.0) + ev.time_range.elapsed_us() / 1e3 / ticks
            launches += 1
    device_ms = sum(by_kernel.values())
    top = sorted(by_kernel.items(), key=lambda kv: -kv[1])[:10]
    out = {
        "ticks": ticks,
        "tick_wall_ms": wall_ms / ticks,
        "tick_device_ms": device_ms if device_ms > 0 else None,
        "device_busy_share": device_ms / (wall_ms / ticks) if device_ms > 0 else None,
        "kernels_per_tick": launches / ticks,
        "top_device_ms": top,
    }
    print(f"[chip-smoke] serve tick profile: {json.dumps(out)}", flush=True)
    return out


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--out", default=None, help="also write every measurement to this JSON file")
    args = parser.parse_args()

    if not torch.cuda.is_available():
        print("[chip-smoke] torch.cuda.is_available() is false: this smoke needs a CUDA card", file=sys.stderr)
        return 1
    card = card_line()
    print(f"[chip-smoke] card: {card}; torch {torch.__version__} (CUDA {torch.version.cuda})", flush=True)
    device = torch.device("cuda", 0)
    torch.zeros(1, device=device)  # create the CUDA context before any library call

    t0 = time.perf_counter()
    paths = build(KERNELS)
    print(f"[chip-smoke] built {len(paths)} kernel(s) in {time.perf_counter() - t0:.1f}s: "
          f"{', '.join(p.name for p in paths.values())}", flush=True)

    gru = check_gru(device)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as tmp:
        path = main_path(tmp)
        parity = serve_step_parity(path["ckpt"])
        profile = profile_ticks(path["ckpt"])

    main_row = next(r for r in gru["rows"] if (r["preset"], r["B"], r["K"], r["H"]) == MAIN_SHAPE)
    kernels = [
        {
            "name": LN_GRU.name,
            "route": LN_GRU.route,
            "source": f"sheeprl_tpu_torch/csrc/{LN_GRU.source}",
            "replaces": LN_GRU.replaces,
            "launches": path["launches"][LN_GRU.name],
            "max_abs_err": gru["max_abs_err"],
            "ms": main_row["ms"],
            "kernel_ms": main_row["ms"],
            "plain_ms": main_row["plain_ms"],
            "bound_ms": main_row["bound_ms"],
            "bound_by": main_row["bound_by"],
            "library_ms": main_row["library_ms"],
            "call_ms": main_row["call_ms"],
            "plain_call_ms": main_row["plain_call_ms"],
        }
    ]
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(
                {"card": card, "torch": torch.__version__, "gru": gru, "serve": path["summary"],
                 "launches": path["launches"], "serve_parity": parity, "serve_profile": profile,
                 "kernels": kernels},
                f, indent=2,
            )
    print(json.dumps({"kernels": kernels}))
    print(card_line())
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

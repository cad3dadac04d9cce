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
   per call (replayed from a CUDA graph) and wall time per eager call; check
   that two kernel calls on the same inputs are bitwise equal, and report the
   kernel's time over its bound and its achieved GB/s (the bytes the bound
   counts over its device time). Then the same at every shape with bf16
   operands (the kernel's bf16 instance against the plain version in bf16,
   one bf16 rounding, rtol = atol = 2^-7; the library call a bf16
   ``torch.matmul``; the bound at bf16's bytes and the tensor cores' peak);
4. the serving path: compose ``exp=dreamer_v3 env=dummy`` at the S preset
   (full width), build the agent on the card from the seed, write a
   checkpoint and its config.yaml into a temporary run dir, and serve it
   through ``serve_main`` with 4 slots and 4 concurrent env sessions of 512
   steps; the kernels' launch counts are zeroed just before and read just
   after, and every kernel must have been launched at least once per tick;
   the run's ``telemetry.jsonl`` (on by default) must hold windows whose
   device memory comes from ``torch.cuda.memory_stats``. Then the batched
   serve step on the card is held against the same step on the CPU (the plain
   path) on the same weights, observations and noise;
5. the training path (the slice's main path) through the entry points:
   ``run`` trains DV3 S at full width (``env=dummy``, 4 envs, batch 16 x 64,
   horizon 15) for a few gradient steps and writes a checkpoint, ``run``
   resumes from it for a few more, ``evaluation`` plays a test episode of
   it; the launch counts are zeroed just before each and read just after,
   and each gradient step must have launched the LN-GRU kernel 64 + 15 times
   besides one launch per batched policy step. Then one gradient step on the
   card against the same step on the CPU (TF32 off, T=16, B=4), and the
   seconds per gradient step at 16 x 64, eager, in float32 and then at
   ``fabric.precision=bf16-mixed``;
5a. the serving planes, on the first DV3 run's checkpoint (A) and the
   resumed run's (B): serve A with ``serve.reload.enabled`` on a watched run
   dir and publish B there (renamed into place, then its sidecar) once the
   first telemetry window is written; the reload event carries version 1,
   every session completes, and the LN-GRU kernel launched once a tick under
   both versions. The same with a ``reload_torn`` fault: the candidate is
   rejected, ``serve.weights.failures`` is 1 and version 0 serves to the end.
   A swap driven directly: the staging and apply times of the whole tree, and
   the step after it from a fixed carry bit-equal to a policy booted from B
   on the card and within the serve bar of the CPU's. ``serve.supervisor``
   with a ``crash`` fault at served step 200: one restart, exit 0. Ticks/s of
   the float32 serving run with telemetry on and off, in turns;
5b. the same slice at ``fabric.precision=bf16-mixed``: a shorter run,
   a resume and an evaluation through the entry points, every LN-GRU launch
   counted by dtype and all bf16 (79 a gradient step plus one a policy step);
   its checkpoint served through ``serve_main`` at bf16 (4 slots, 4 sessions
   of 512 steps, one bf16 launch a tick); the bf16 serve step card vs CPU
   from the same carries; two bf16 gradient steps card vs CPU beside the
   CPU's float32 steps (bars in ``train_step_parity``);
6. PPO (``exp=ppo``, CartPole-v1 at the exp's settings: 4 envs x 128 steps,
   minibatches of 64, 10 epochs, width 64) through the entry points on the
   card: 65536 policy steps with the metric log and the test episode (its
   reward must reach 100), a resume into version_1 for two more iterations,
   an evaluation; the event file must hold the losses, the episode reward
   and ``Time/sps_*``. A short ``exp=a2c`` run (finite losses, a
   checkpoint). Then one PPO train phase on the card vs the CPU (TF32 off)
   and three A2C RMSprop steps likewise, the seconds per PPO train phase and
   the ms of one host acting step. The PPO checkpoint is served through
   ``serve_main`` (4 slots, 4 sessions) and its greedy step held card vs CPU
   (logits within 1e-5, equal actions);
7. SAC (``exp=sac env.id=Pendulum-v1``, the exp's widths, batch and replay
   ratio, 4 envs) through the entry points on the card: 12,000 policy steps
   with the metric log and the test episode (its reward must reach -400), a
   resume into version_1, an evaluation; the checkpoint served through
   ``serve_main`` (4 slots, 4 sessions) and the batched greedy step held
   against the CPU's. A short ``exp=droq`` run (finite losses, a checkpoint,
   an evaluation). Then one SAC and one DroQ train phase on the card vs the
   CPU (TF32 off), the seconds per SAC gradient step and per DroQ train
   phase (G = 20) and the ms of one host acting step;
8. the profiles, under torch.profiler and only now (once it has run, later
   eager launches cost more host time): each phase-3 shape's device time by
   kernel name, with its kernel launches per call counted in a captured CUDA
   graph; serving ticks (device time by kernel, the LN-GRU kernel's launches
   by name, busy share); a training step in float32 and one in bf16 (the
   same, and its kernel count); a PPO train phase
   and a SAC train phase (busy share, device operations);
9. print the ``kernels`` JSON line, the card line, and the final result line.

The training phase launches with the config's defaults for video capture
(warned and skipped), the metric log (its event file must hold the losses,
``Params/replay_ratio`` and ``Time/sps_*``) and the replay buffer (memmap
files in the run's directory, carried by the checkpoints: the resumed run
must read them and add rows).

Phase 3 also covers the training shapes of the kernel: B = 16 (the posterior
scan) and B = 1024 (imagination's 16 x 64 rows), forward and gradient.
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
# bf16 operands could run on the tensor cores: their dense bf16 peak bounds
# the bf16 instance's operations
PEAK_BF16_FLOPS = 989e12
L2_BYTES = 50 * 1024 * 1024
BF16 = torch.bfloat16

# kernel vs plain: both float32 with TF32 off; sums over K <= 5120 products are
# taken in another order (split-K partials vs cuBLAS), and the LayerNorm
# divides the gate errors by the row's spread, so agreement to ~1e-6 is
# expected and 1e-4 is the bar
GRU_ATOL = 1e-4
# the bf16 instance vs the plain version in bf16: both sum the same bf16
# products in float32 (in other orders) and round the output to bf16 once, so
# an output may land on the neighbouring bf16 value: one bf16 rounding,
# rtol = atol = 2^-7 (the bar of tests/test_torch_gru.py's bf16 test)
GRU_BF16_TOL = 2**-7
# the batched serve step on the card vs on the CPU: the same float32 math
# through cuDNN/cuBLAS (TF32 off) vs the CPU kernels, 8 recurrent steps deep
SERVE_H_ATOL = 1e-3
SERVE_H_ATOL_BF16 = 2**-5  # one step from the same carry: see serve_step_parity

# (preset, B, K, H): DV3 recurrent cells, K = dense_units + recurrent size
GRU_SHAPES = [
    ("S", 1, 1024, 512),
    ("S", 4, 1024, 512),
    ("S", 16, 1024, 512),
    ("S", 64, 1024, 512),
    ("S", 1024, 1024, 512),  # imagination: B*T = 16*64 rows
    ("L", 4, 2816, 2048),
    ("XL", 4, 5120, 4096),
]
MAIN_SHAPE = ("S", 4, 1024, 512)  # serving: 4 slots at the S preset
# training: the posterior scan's batch, then imagination's rows
TRAIN_SHAPES = [("S", 16, 1024, 512), ("S", 1024, 1024, 512)]
GRAD_SHAPES = [MAIN_SHAPE, *TRAIN_SHAPES]

SLOTS = 4
SESSIONS = 4
MAX_SESSION_STEPS = 512  # long enough that the one cold first tick is not the p99


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def gru_case(B: int, K: int, H: int, seed: int, device, dtype=torch.float32) -> tuple:
    """inp, hx, w, b in ``dtype``; scale and bias float32."""
    rng = np.random.default_rng(seed)
    arrs = (
        rng.standard_normal((B, K)),
        rng.standard_normal((B, H)),
        rng.standard_normal((K, 3 * H)) / math.sqrt(K),
        0.1 * rng.standard_normal(3 * H),
        1.0 + 0.1 * rng.standard_normal(3 * H),
        0.1 * rng.standard_normal(3 * H),
    )
    out = [torch.tensor(a, dtype=torch.float32, device=device) for a in arrs]
    return (*(t.to(dtype) for t in out[:4]), *out[4:])


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


def gru_bytes(B: int, K: int, H: int, dtype=torch.float32) -> int:
    """Bytes one step must move: each input read once, the output written
    once; inp, hx, w, b and the output in ``dtype``, scale and bias float32."""
    n = 3 * H
    size = torch.tensor([], dtype=dtype).element_size()
    return size * (B * K + B * H + K * n + n + B * H) + 4 * 2 * n


def gru_bound(B: int, K: int, H: int, dtype=torch.float32) -> tuple:
    """The least time of one step in ms and what bounds it: the bytes over the
    memory rate, or the operations over float32's peak (the float32 instance)
    or over the bf16 tensor cores' (the bf16 instance)."""
    n = 3 * H
    flops = 2 * B * K * n + 12 * B * n
    t_bytes = gru_bytes(B, K, H, dtype) / PEAK_BYTES_PER_S
    t_ops = flops / (PEAK_BF16_FLOPS if dtype == BF16 else PEAK_F32_FLOPS)
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def graph_kernel_launches(fn) -> int:
    """Kernels one ``fn()`` launches: the kernel nodes of a CUDA graph that
    captures one call, counted through the CUDA runtime."""
    import ctypes

    for name in ("libcudart.so.12", "libcudart.so"):
        try:
            rt = ctypes.CDLL(name)  # the runtime torch loaded
            break
        except OSError:
            continue
    else:
        raise RuntimeError("libcudart not found: cannot count a graph's kernel nodes")
    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(stream):
        fn()
    torch.cuda.current_stream().wait_stream(stream)
    graph = torch.cuda.CUDAGraph(keep_graph=True)
    with torch.cuda.graph(graph):
        fn()
    raw = ctypes.c_void_p(graph.raw_cuda_graph())
    count = ctypes.c_size_t(0)
    if rt.cudaGraphGetNodes(raw, None, ctypes.byref(count)) != 0:
        raise RuntimeError("cudaGraphGetNodes failed")
    nodes = (ctypes.c_void_p * count.value)()
    if rt.cudaGraphGetNodes(raw, nodes, ctypes.byref(count)) != 0:
        raise RuntimeError("cudaGraphGetNodes failed")
    kernels = 0
    for node in nodes:
        kind = ctypes.c_int(-1)
        rt.cudaGraphNodeGetType(ctypes.c_void_p(node), ctypes.byref(kind))
        kernels += kind.value == 0  # cudaGraphNodeTypeKernel
    del graph
    return kernels


def device_events(prof):
    """The profile's device events: kernels and copies, without the ranges
    the profiler draws on the device for host annotations (such as
    ``Optimizer.step#Adam.step``), which span kernels already counted."""
    from torch.autograd import DeviceType

    return [ev for ev in prof.events()
            if ev.device_type == DeviceType.CUDA and not getattr(ev, "is_user_annotation", False)]


def device_ms_by_kernel(fn, weights, calls: int = 8) -> dict:
    """Device ms per launch of each kernel ``fn(w)`` runs, by name, under
    torch.profiler, eager, cycling through ``weights``. The calls are traced
    in a second profiler step, after a warm-up step; a kernel's time is the
    mean over the launches the trace holds."""
    from torch.profiler import ProfilerActivity, profile, schedule

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 schedule=schedule(wait=0, warmup=1, active=1, repeat=1)) as prof:
        for _ in range(2):  # warm-up step, then the traced step
            for i in range(calls):
                fn(weights[i % len(weights)])
            torch.cuda.synchronize()
            prof.step()
    total, count = {}, {}
    for ev in device_events(prof):
        if not ev.name.startswith("ProfilerStep"):
            total[ev.name] = total.get(ev.name, 0.0) + ev.time_range.elapsed_us() / 1e3
            count[ev.name] = count.get(ev.name, 0) + 1
    return {name: total[name] / count[name] for name in total}


def check_gru(device, dtype=torch.float32) -> dict:
    """Every ``GRU_SHAPES`` row with operands in ``dtype``: the kernel against
    the plain version on the card, the gradient at ``GRAD_SHAPES``, two calls
    bitwise equal; then the kernel's, the plain version's and ``torch.matmul``'s
    times and the bound."""
    bf16 = dtype == BF16
    tol = GRU_BF16_TOL if bf16 else GRU_ATOL
    tag = "bf16" if bf16 else "f32"
    size = torch.tensor([], dtype=dtype).element_size()
    rows = []
    for preset, B, K, H in GRU_SHAPES:
        inp, hx, w, b, scale, bias = gru_case(B, K, H, seed=B + K, device=device, dtype=dtype)
        torch.backends.cuda.matmul.allow_tf32 = False
        ref = ln_gru_step_plain(inp, hx, w, b, scale, bias)
        out = ln_gru_step(inp, hx, w, b, scale, bias)
        torch.cuda.synchronize()
        err = float((out.float() - ref.float()).abs().max())
        # float32: |err| <= 1e-4; bf16: |err| <= 2^-7 (1 + |ref|)
        excess = float(((out.float() - ref.float()).abs() - tol * (ref.float().abs() if bf16 else 0)).max())
        if not (out.dtype == dtype and excess <= tol and torch.isfinite(out.float()).all()):
            raise AssertionError(f"LN-GRU {tag} kernel vs plain at {preset} B={B}: max abs err {err} over the bar")
        row = {"preset": preset, "B": B, "K": K, "H": H, "dtype": tag, "max_abs_err": err}
        # no float atomics and fixed summation orders: a second call on the
        # same inputs gives the same bits
        again = ln_gru_step(inp, hx, w, b, scale, bias)
        torch.cuda.synchronize()
        row["bitwise_equal"] = bool(torch.equal(out, again))
        if not row["bitwise_equal"]:
            raise AssertionError(f"LN-GRU {tag} kernel at {preset} B={B}: two calls on the same inputs differ")
        if (preset, B, K, H) in GRAD_SHAPES:
            args = [t.clone().requires_grad_(True) for t in (inp, hx, w, b, scale, bias)]
            g_out = torch.randn(B, H, device=device, generator=torch.Generator(device).manual_seed(0)).to(dtype)
            grads_k = torch.autograd.grad(ln_gru_step(*args), args, g_out)
            grads_p = torch.autograd.grad(ln_gru_step_plain(*args), args, g_out)
            gerr = max(float((a.float() - p.float()).abs().max()) for a, p in zip(grads_k, grads_p))
            gexcess = max(float(((a.float() - p.float()).abs() - tol * (p.float().abs() if bf16 else 0)).max())
                          for a, p in zip(grads_k, grads_p))
            if gexcess > tol:
                raise AssertionError(f"LN-GRU {tag} gradient vs plain at {preset} B={B}: max abs err {gerr}")
            row["grad_max_abs_err"] = gerr
        copies = max(2, math.ceil(2 * L2_BYTES / (size * K * 3 * H)))
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
        row["bound_ms"], row["bound_by"] = gru_bound(B, K, H, dtype)
        row["kernel_over_bound"] = row["ms"] / row["bound_ms"]
        row["achieved_GBps"] = gru_bytes(B, K, H, dtype) / (row["ms"] * 1e-3) / 1e9
        del weights
        rows.append(row)
        print(f"[chip-smoke] ln_gru {json.dumps(row)}", flush=True)
    return {"rows": rows, "max_abs_err": max(r["max_abs_err"] for r in rows)}


def profile_gru(rows: list, device) -> None:
    """Adds to each phase-3 row the kernels one call launches (counted in a
    captured graph) and their device time by name (torch.profiler). Run after
    the serving phase, as the tick profile is: once the profiler has run in a
    process, later eager launches cost more host time, which would slow the
    served ticks."""
    for row in rows:
        dtype = BF16 if row["dtype"] == "bf16" else torch.float32
        inp, hx, w, b, scale, bias = gru_case(row["B"], row["K"], row["H"], seed=row["B"] + row["K"], device=device,
                                              dtype=dtype)
        row["launches_per_call"] = graph_kernel_launches(lambda: ln_gru_step(inp, hx, w, b, scale, bias))
        row["device_ms_by_kernel"] = device_ms_by_kernel(
            lambda wi: ln_gru_step(inp, hx, wi, b, scale, bias), [w, w.clone()]
        )
        print(f"[chip-smoke] ln_gru profile {row['dtype']} {row['preset']} B={row['B']}: {row['launches_per_call']} launches "
              f"per call, device ms {json.dumps(row['device_ms_by_kernel'])}", flush=True)


def _zero_launches() -> None:
    for spec in KERNELS:
        spec.zero_launches()


def _launches() -> dict:
    return {spec.name: spec.launches for spec in KERNELS}


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
    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated()  # what earlier phases left allocated
    _zero_launches()
    rc = serve_main(
        [
            f"checkpoint_path={run_dir}",
            f"serve.slots={SLOTS}",
            f"serve.sessions={SESSIONS}",
            f"serve.max_session_steps={MAX_SESSION_STEPS}",
            f"serve.log_dir={log_dir}",
        ]
    )
    launches = _launches()
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
    tel = check_telemetry("float32 serve", log_dir)
    print(f"[chip-smoke] float32 serving's peak device memory over what the process held before it: "
          f"{tel['hbm_peak_bytes'] - held} bytes ({held} held)", flush=True)
    return {"summary": summary, "launches": launches, "ckpt": ckpt, "hbm_peak_bytes": tel["hbm_peak_bytes"],
            "hbm_held_before": held}


TRAIN_ENVS = 4
# the exp's learning_starts (1024 policy steps, 256 iterations of 4 envs) and
# replay ratio (1: every iteration of 4 policy steps takes 4 gradient steps)
LEARNING_STARTS_ITERS = 256
STEADY_ITERS = 16  # iterations after the first training one: the steady-state window
FIRST_ITERS = LEARNING_STARTS_ITERS + STEADY_ITERS
# a resumed run waits learning_starts iterations again (acting with the
# player); its replay-ratio governor, restored from the checkpoint, skips the
# first training iteration, and the next 3 take 4 gradient steps each
RESUME_ITERS = FIRST_ITERS + LEARNING_STARTS_ITERS + 4
GRU_CALLS_PER_GRAD_STEP = 64 + 15  # the posterior scan over T, imagination over the horizon
# what the DV3 run's metric log must hold (metric.log_level=1, the default)
DV3_TAGS = ("Loss/world_model_loss", "Params/replay_ratio", "Time/sps_train", "Time/sps_env_interaction")
# one gradient step on the card vs on the CPU (TF32 off): the losses and
# gradient norms pass through 16 recurrent steps, a 15-step rollout and
# cuDNN/cuBLAS against the CPU's kernels; each within 1e-3 of the CPU's value,
# relative to its size (or to 1e-3 for the ones smaller than that)
TRAIN_STEP_RTOL = 1e-3
# the parameters after the steps: Adam's first steps move each weight by about
# its learning rate whatever the gradient's size, so a gradient within
# rounding of 0 may step either way on each side. Every weight lies within
# 2 lr a step of the CPU's, and all but a few within 1e-5 (a wrong update, a
# missing one or a wrong clip scale moves most weights by about lr = 1e-4)
TRAIN_PARAM_ATOL = 1e-5
TRAIN_PARAM_SHARE = 0.999
# the same two steps at bf16, both sides composing the same bf16 ops: the
# card's and the CPU's float32 sums (cuBLAS and cuDNN against the CPU's
# kernels) run in other orders, so some bf16 outputs land on the
# neighbouring value (2^-9 relative); those flips pass through the scans and
# the sums over the batch, as between the port and the JAX step on the CPU,
# where they reach 0.8-3.8% (tests/test_torch_bf16_train.py): each metric
# within 5% of the CPU's for the world model's metrics. The actor's and
# critic's losses and gradient norms sum over 15 x 1024 imagined steps whose
# sampled latents and actions flip wherever a logit plus its Gumbel noise
# lands on a bf16 tie the two sides break apart, and the actor's terms
# largely cancel (its gradient norm is ~0.01): those metrics take 25%, and
# their summed relative distance must stay below the CPU's float32 step's
# (a step computed in float32 lands ~97% away on the actor's two). The
# parameters take Adam's own bound (adam_step_bound): a weight whose tiny
# gradient has another sign on each side steps about lr the other way each
# step, whatever the gradient's size.
TRAIN_STEP_RTOL_BF16 = 5e-2
TRAIN_IMAGINED_RTOL_BF16 = 0.25
IMAGINED = ("Loss/policy_loss", "Loss/value_loss", "Grads/actor", "Grads/critic")
# DV3 S at fabric.precision=bf16-mixed through the entry points: a shorter
# run than the float32 one. learning_starts of 80 iterations (320 policy
# steps) gives each env 80 rows, more than a 64-step sequence; iterations
# 80 to 84 train (20 gradient steps). The resumed run waits the 80
# iterations again and trains in the 3 after the governor's skipped one.
BF16_PRECISION = "bf16-mixed"
BF16_LEARNING_STARTS_ITERS = 80
BF16_FIRST_ITERS = BF16_LEARNING_STARTS_ITERS + 4
BF16_RESUME_ITERS = BF16_FIRST_ITERS + BF16_LEARNING_STARTS_ITERS + 4


def train_overrides(run_dir: str = "") -> list:
    """DV3 S at full width with the exp's batch, sequence, replay ratio,
    learning_starts and buffer size, and the config's defaults otherwise: no
    ``env.capture_video`` override (the port warns and records nothing), the
    metric log at ``log_level`` 1, the buffer in memmap files and in the
    checkpoints. ``run_dir`` holds the run's logs, checkpoints and memmap
    files."""
    return [
        "exp=dreamer_v3",
        "env=dummy",
        "algo.cnn_keys.encoder=[rgb]",
        "algo.mlp_keys.encoder=[state]",
        f"env.num_envs={TRAIN_ENVS}",
        "algo.per_rank_batch_size=16",
        "algo.per_rank_sequence_length=64",
        *([f"hydra.run.dir={run_dir}"] if run_dir else []),
    ]


def read_scalars(log_dir: str) -> dict:
    """tag -> [(step, value)] of a run's TensorBoard event file, read by
    TensorBoard's own reader."""
    from tensorboard.backend.event_processing.event_accumulator import EventAccumulator

    ea = EventAccumulator(log_dir)
    ea.Reload()
    return {tag: [(e.step, e.value) for e in ea.Scalars(tag)] for tag in ea.Tags()["scalars"]}


def check_scalars(name: str, log_dir: str, tags) -> dict:
    """Fails unless the run's event file holds every tag in ``tags``, each with
    finite values; returns the scalars."""
    scalars = read_scalars(log_dir)
    missing = [t for t in tags if t not in scalars]
    bad = [t for t, points in scalars.items() if not all(math.isfinite(v) for _, v in points)]
    print(f"[chip-smoke] {name} event file: {len(scalars)} tags, {sum(map(len, scalars.values()))} points; "
          f"missing {missing}, non-finite {bad}", flush=True)
    if missing or bad:
        raise AssertionError(f"{name}: the event file lacks {missing} or holds non-finite {bad}")
    return scalars


def _check_train_run(name: str, summary: dict, launches: int) -> None:
    need = GRU_CALLS_PER_GRAD_STEP * summary["gradient_steps"] + summary["player_calls"]
    print(f"[chip-smoke] train {name}: {summary['gradient_steps']} gradient steps, {summary['player_calls']} "
          f"player calls, {summary['policy_steps']} policy steps in {summary['wall_seconds']:.2f}s "
          f"(train {summary['train_seconds']:.2f}s, env {summary['env_seconds']:.2f}s); LN-GRU launches "
          f"{launches} (need >= {need}); metrics {json.dumps(summary['metrics'])}", flush=True)
    if summary["gradient_steps"] < 1 or launches < need:
        raise AssertionError(f"train {name}: {summary['gradient_steps']} gradient steps, {launches} launches < {need}")
    if not all(math.isfinite(v) for v in summary["metrics"].values()):
        raise AssertionError(f"train {name}: non-finite metrics {summary['metrics']}")


def train_path(out_dir: str) -> dict:
    """The training slice's main path through the entry points a user calls:
    train, resume from the last checkpoint, evaluate it. The launch counts are
    zeroed just before each run and read just after."""
    from sheeprl_tpu_torch.cli import evaluation, run
    from sheeprl_tpu_torch.utils.checkpoint import load_checkpoint

    overrides = train_overrides(os.path.join(out_dir, "train"))
    out = {}
    _zero_launches()
    first = run(overrides + [f"algo.total_steps={TRAIN_ENVS * FIRST_ITERS}"])
    out["train"] = {"summary": first, "launches": _launches()}
    _check_train_run("first run", first, LN_GRU.launches)
    scalars = check_scalars("DV3 first run", first["log_dir"], DV3_TAGS)
    out["train"]["scalars"] = {t: scalars[t][-1] for t in DV3_TAGS}
    listed = open(first["checkpoint"] + ".memmap").read().split()
    if not (listed and all(os.path.isfile(f) for f in listed)):
        raise AssertionError(f"the first run's checkpoint lists memmap files that are not there: {listed}")
    if first["gradient_steps"] < 4:
        raise AssertionError(f"the first run took {first['gradient_steps']} gradient steps, fewer than 4")
    _zero_launches()
    resumed = run(overrides + [f"algo.total_steps={TRAIN_ENVS * RESUME_ITERS}",
                               f"checkpoint.resume_from={first['checkpoint']}"])
    out["resume"] = {"summary": resumed, "launches": _launches()}
    _check_train_run("resumed run", resumed, LN_GRU.launches)
    if not resumed["log_dir"].endswith("version_1"):
        raise AssertionError(f"the resumed run wrote {resumed['log_dir']}, not the run's version_1")
    # the resumed run read the first run's memmap files and added rows to them
    rows = {name: sum(b._pos for b in load_checkpoint(summary["checkpoint"])["rb"].buffer)
            for name, summary in (("first", first), ("resumed", resumed))}
    out["resume"]["buffer_rows"] = rows
    print(f"[chip-smoke] memmap buffer rows: first run's checkpoint {rows['first']}, resumed run's "
          f"{rows['resumed']}", flush=True)
    if not rows["resumed"] > rows["first"]:
        raise AssertionError(f"the resumed run added no rows to the memmap buffer: {rows}")
    _zero_launches()
    reward = evaluation([f"checkpoint_path={resumed['checkpoint']}"])
    out["evaluation"] = {"reward": reward, "launches": _launches()}
    print(f"[chip-smoke] evaluation: reward {reward}, LN-GRU launches {LN_GRU.launches}", flush=True)
    if not (math.isfinite(reward) and LN_GRU.launches >= 1):
        raise AssertionError(f"evaluation: reward {reward}, {LN_GRU.launches} launches")
    # the steady-state window of the first run: the iterations after the first
    # training one, without set-up, prefill, checkpoint writes or the test episode
    if first["steady_gradient_steps"] != first["steady_policy_steps"] or first["steady_policy_steps"] < 4 * STEADY_ITERS:
        raise AssertionError(f"the steady window took {first['steady_gradient_steps']} gradient steps in "
                             f"{first['steady_policy_steps']} policy steps, not one each at replay ratio 1")
    out["seconds_per_gradient_step"] = first["train_seconds"] / first["gradient_steps"]
    out["env_steps_per_s"] = first["steady_policy_steps"] / first["steady_seconds"]
    print(f"[chip-smoke] train: {out['seconds_per_gradient_step']:.4f} s per gradient step in the loop, "
          f"{out['env_steps_per_s']:.3f} env steps/s in the steady window of the first run "
          f"({first['steady_policy_steps']} policy steps, {first['steady_gradient_steps']} gradient steps in "
          f"{first['steady_seconds']:.3f}s)", flush=True)
    return out


def _s_trainers(devices, T: int, B: int, seed: int = 0, precision: str = "32-true"):
    """DV3 S trainers (the same weights from a seed) on each device at
    ``precision``, TF32 off, and one random batch of [T, B] rows on the CPU."""
    from sheeprl_tpu_torch.algos.dreamer_v3.agent import build_agent
    from sheeprl_tpu_torch.algos.dreamer_v3.dreamer_v3 import DV3Trainer, build_optimizers
    from sheeprl_tpu_torch.config import compose
    from sheeprl_tpu_torch.interop.flax_to_torch import agent_to_flax
    from sheeprl_tpu_torch.parallel.fabric import Fabric
    from sheeprl_tpu_torch.utils.env import make_env

    cfg = compose(train_overrides())
    space = make_env(cfg, 0, 0)().observation_space
    trainers, weights = {}, None
    for accel in devices:
        fabric = Fabric(accelerator=accel, precision=precision, float32_matmul_precision="highest")
        agent = build_agent(fabric, (2,), False, cfg, space, seed, weights)
        weights = weights or agent_to_flax(agent)
        trainers[accel] = DV3Trainer(agent, cfg, build_optimizers(cfg, agent))
    rng = np.random.default_rng(seed)
    terminated = (rng.uniform(size=(T, B, 1)) < 0.05).astype(np.float32)
    batch = {
        "rgb": rng.integers(0, 256, (T, B, 3, 64, 64)).astype(np.uint8),
        "state": rng.standard_normal((T, B, 10)).astype(np.float32),
        "actions": np.eye(2, dtype=np.float32)[rng.integers(0, 2, (T, B))],
        "rewards": rng.standard_normal((T, B, 1)).astype(np.float32),
        "terminated": terminated,
        "truncated": np.zeros((T, B, 1), np.float32),
        "is_first": np.concatenate([np.zeros((1, B, 1), np.float32), terminated[:-1]]),
    }
    return trainers, {k: torch.from_numpy(v) for k, v in batch.items()}


def _state_gap(card, cpu) -> dict:
    """The card trainer's state against the CPU's after the same steps: every
    parameter (the target critic's too) by its largest gap and by the share
    of entries within TRAIN_PARAM_ATOL, the worst leaf, and Moments relative
    to their size."""
    ours = {k: v.detach().cpu() for k, v in card.agent.state_dict().items()}
    theirs = cpu.agent.state_dict()
    gaps = {k: (ours[k] - v).abs() for k, v in theirs.items()}
    worst_leaf = max(gaps, key=lambda k: float(gaps[k].max()))
    flat = torch.cat([g.reshape(-1) for g in gaps.values()])
    moments = max(
        abs(float(card.moments[k]) - float(cpu.moments[k])) / max(abs(float(cpu.moments[k])), 1e-3)
        for k in cpu.moments
    )
    return {
        "param_max_abs_gap": float(flat.max()),
        "param_share_within_atol": float((flat <= TRAIN_PARAM_ATOL).float().mean()),
        "worst_leaf": worst_leaf,
        "moments_rel_gap": moments,
    }


def adam_step_bound(t: int, beta1: float, beta2: float) -> float:
    """The most one Adam step can move a weight, in units of lr, at step t:
    the bias-corrected ``m / sqrt(v)`` is at most this by Cauchy-Schwarz over
    the t gradients (1 at t = 1, 1.0014 at t = 2 with the betas 0.9, 0.999)."""
    total = sum(((1 - beta1) * beta1 ** (t - i)) ** 2 / ((1 - beta2) * beta2 ** (t - i)) for i in range(1, t + 1))
    return math.sqrt((1 - beta2**t) / (1 - beta1**t) ** 2 * total)


def train_step_parity(steps: int = 2, precision: str = "32-true") -> dict:
    """Two gradient steps on the card vs on the CPU at DV3 S width (T=16,
    B=4): the same weights, batches and noise. Every loss and gradient norm of
    each step (the second one's are taken at the weights the first update
    left), then the parameters, the target critic and Moments after the last
    one: what the card's Adam, clipping, target EMA and Moments did.

    At bf16 the CPU also takes the steps in float32 from the same noise, and
    the bars are: the world model's metrics within ``TRAIN_STEP_RTOL_BF16``
    of the CPU's bf16 values; the actor's and critic's (``IMAGINED``) within
    ``TRAIN_IMAGINED_RTOL_BF16``, and their summed relative distance below
    the CPU's float32 step's; the parameters within Adam's own bound, two
    sides stepping opposite ways by the most ``adam_step_bound`` allows;
    Moments within the bf16 bar."""
    T, B = 16, 4
    bf16 = precision.startswith("bf16")
    rtol = TRAIN_STEP_RTOL_BF16 if bf16 else TRAIN_STEP_RTOL
    trainers, batch = _s_trainers(("gpu", "cpu"), T, B, precision=precision)
    if bf16:
        trainers["cpu_f32"] = _s_trainers(("cpu",), T, B)[0]["cpu"]
    lr = max(group["lr"] for opt in trainers["cpu"].optimizers.values() for group in opt.param_groups)
    worst, per_step = 0.0, []
    for step in range(steps):
        noise = trainers["cpu"].draw_noise(T, B, torch.Generator().manual_seed(1 + step))
        metrics = {}
        for accel, trainer in trainers.items():
            dev = trainer.device
            out = trainer.train_step({k: v.to(dev) for k, v in batch.items()}, step,
                                     {k: v.to(dev, trainer.agent.dtype) for k, v in noise.items()})
            metrics[accel] = {k: float(v) for k, v in out.items()}
        if not all(math.isfinite(v) for v in metrics["gpu"].values()):
            raise AssertionError(f"train step {step} on the card: non-finite metrics {metrics['gpu']}")
        rel = {a: {k: abs(metrics[a][k] - v) / max(abs(v), 1e-3) for k, v in metrics["cpu"].items()}
               for a in metrics if a != "cpu"}
        if bf16:
            if not all(t.dtype == torch.float32 for t in trainers["gpu"].agent.parameters()):
                raise AssertionError("a bf16 train step left a parameter that is not float32")
            gap = max(v for k, v in rel["gpu"].items() if k not in IMAGINED)
            imagined = {a: sum(rel[a][k] for k in IMAGINED) for a in rel}
            if not (max(rel["gpu"][k] for k in IMAGINED) <= TRAIN_IMAGINED_RTOL_BF16
                    and imagined["gpu"] < imagined["cpu_f32"]):
                raise AssertionError(f"bf16 train step {step}: the actor's and critic's metrics on the card are not "
                                     f"within {TRAIN_IMAGINED_RTOL_BF16} of the CPU's bf16 ones, or no closer to them "
                                     f"than the CPU's float32 ones are: {json.dumps(rel)}")
        else:
            gap = max(rel["gpu"].values())
        worst = max(worst, gap)
        per_step.append({"worst_rel_err": gap, "rel_err": rel, **metrics})
    state = _state_gap(trainers["gpu"], trainers["cpu"])
    if bf16:
        betas = trainers["cpu"].optimizers["world_model"].param_groups[0]["betas"]
        # and a float32 rounding of each update of a weight below 2 in size
        param_bar = 2 * lr * sum(adam_step_bound(t, *betas) for t in range(1, steps + 1)) + 2 * steps * 2**-23
        share = 0.0
    else:
        param_bar, share = steps * 2 * lr, TRAIN_PARAM_SHARE
    print(f"[chip-smoke] train steps card vs CPU at {precision} (T={T}, B={B}, {steps} steps): worst relative "
          f"err of the metrics {worst} (bar {rtol}); state after the last step {json.dumps(state)} (bars: every "
          f"parameter within {param_bar:.4e}, a share >= {share} within {TRAIN_PARAM_ATOL}, Moments within "
          f"{rtol}); steps {json.dumps(per_step)}", flush=True)
    if worst > rtol:
        raise AssertionError(f"train steps at {precision} on the card disagree with the CPU: worst relative err {worst}")
    if not (state["param_max_abs_gap"] <= param_bar and state["param_share_within_atol"] >= share
            and state["moments_rel_gap"] <= rtol):
        raise AssertionError(f"the card's updates at {precision} disagree with the CPU's: {state}")
    return {"precision": precision, "worst_rel_err": worst, "state": state, "steps": per_step, "T": T, "B": B}


def time_train_steps(steps: int = 5, precision: str = "32-true") -> tuple:
    """Seconds per gradient step of DV3 S at the preset's batch (16 x 64) and
    ``precision``, eager, with TF32 as the config's float32 matmul precision
    sets it. Returns the timing and the warm trainer with its batch, for the
    profile."""
    from sheeprl_tpu_torch.parallel.fabric import apply_matmul_precision

    T, B = 64, 16
    trainers, batch = _s_trainers(("gpu",), T, B, seed=2, precision=precision)
    trainer = trainers["gpu"]
    apply_matmul_precision("high")  # the config's float32_matmul_precision
    batch = {k: v.to(trainer.device) for k, v in batch.items()}
    generator = torch.Generator(trainer.device).manual_seed(3)
    for cum in range(2):  # warm-up: cuDNN plans, the allocator
        trainer.train_step(batch, cum, trainer.draw_noise(T, B, generator))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for cum in range(2, 2 + steps):
        trainer.train_step(batch, cum, trainer.draw_noise(T, B, generator))
    torch.cuda.synchronize()
    out = {"precision": precision, "T": T, "B": B, "steps": steps,
           "seconds_per_gradient_step": (time.perf_counter() - t0) / steps}
    print(f"[chip-smoke] train step timing: {json.dumps(out)}", flush=True)
    return out, (trainer, batch, generator)


def profile_train_steps(warm: tuple, steps: int = 3) -> dict:
    """Under torch.profiler (last: it slows later eager launches), the
    device's busy share of a gradient step, its device time by kernel and the
    LN-GRU kernel's launches per step by name."""
    from torch.profiler import ProfilerActivity, profile

    trainer, batch, generator = warm
    T, B = batch["rewards"].shape[:2]
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for cum in range(10, 10 + steps):
            trainer.train_step(batch, cum, trainer.draw_noise(T, B, generator))
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3 / steps
    by_kernel, count = {}, {}
    for ev in device_events(prof):
        by_kernel[ev.name] = by_kernel.get(ev.name, 0.0) + ev.time_range.elapsed_us() / 1e3 / steps
        count[ev.name] = count.get(ev.name, 0) + 1
    device_ms = sum(by_kernel.values())
    out = {
        "steps": steps,
        "step_wall_ms": wall_ms,
        "step_device_ms": device_ms if device_ms > 0 else None,
        "device_busy_share": device_ms / wall_ms if device_ms > 0 else None,
        "kernels_per_step": sum(count.values()) / steps,
        "top_device_ms": sorted(by_kernel.items(), key=lambda kv: -kv[1])[:12],
        "ln_gru_device_ms": {n: ms for n, ms in by_kernel.items() if "ln_gru" in n},
        "ln_gru_launches_per_step": {n: c / steps for n, c in count.items() if "ln_gru" in n},
    }
    print(f"[chip-smoke] train step profile ({trainer.agent.dtype}): {json.dumps(out)}", flush=True)
    return out


def _bf16_launches(name: str, need: int) -> dict:
    """The LN-GRU kernel's launches of a bf16 run by dtype; fails unless
    every one took bf16 operands and there are at least ``need``."""
    by_dtype = dict(LN_GRU.launches_by_dtype)
    print(f"[chip-smoke] {name}: LN-GRU launches by dtype {by_dtype} (need >= {need}, all bfloat16)", flush=True)
    if by_dtype.get("bfloat16", 0) < max(need, 1) or by_dtype.get("bfloat16", 0) != LN_GRU.launches:
        raise AssertionError(f"{name}: LN-GRU launches by dtype {by_dtype}, need >= {need}, all bfloat16")
    return by_dtype


def train_path_bf16(out_dir: str) -> dict:
    """DV3 S at ``fabric.precision=bf16-mixed`` through the entry points: a
    short run, a resume from its checkpoint, an evaluation. The launch counts
    are zeroed just before each and read just after: every LN-GRU launch must
    take bf16 operands, 79 a gradient step plus one a policy step."""
    from sheeprl_tpu_torch.cli import evaluation, run

    overrides = train_overrides(os.path.join(out_dir, "train_bf16")) + [
        f"fabric.precision={BF16_PRECISION}",
        f"algo.learning_starts={TRAIN_ENVS * BF16_LEARNING_STARTS_ITERS}",
    ]
    out = {}
    _zero_launches()
    first = run(overrides + [f"algo.total_steps={TRAIN_ENVS * BF16_FIRST_ITERS}"])
    out["train"] = {"summary": first, "launches": _launches(),
                    "by_dtype": _bf16_launches("bf16 first run", GRU_CALLS_PER_GRAD_STEP * first["gradient_steps"]
                                               + first["player_calls"])}
    _check_train_run("bf16 first run", first, LN_GRU.launches)
    scalars = check_scalars("DV3 bf16 first run", first["log_dir"], DV3_TAGS)
    out["train"]["scalars"] = {t: scalars[t][-1] for t in DV3_TAGS}
    _zero_launches()
    resumed = run(overrides + [f"algo.total_steps={TRAIN_ENVS * BF16_RESUME_ITERS}",
                               f"checkpoint.resume_from={first['checkpoint']}"])
    out["resume"] = {"summary": resumed, "launches": _launches(),
                     "by_dtype": _bf16_launches("bf16 resumed run", GRU_CALLS_PER_GRAD_STEP * resumed["gradient_steps"]
                                                + resumed["player_calls"])}
    _check_train_run("bf16 resumed run", resumed, LN_GRU.launches)
    if not resumed["log_dir"].endswith("version_1"):
        raise AssertionError(f"the bf16 resumed run wrote {resumed['log_dir']}, not the run's version_1")
    _zero_launches()
    reward = evaluation([f"checkpoint_path={resumed['checkpoint']}"])
    out["evaluation"] = {"reward": reward, "launches": _launches(),
                         "by_dtype": _bf16_launches("bf16 evaluation", 1)}
    print(f"[chip-smoke] bf16 evaluation: reward {reward}", flush=True)
    if not math.isfinite(reward):
        raise AssertionError(f"bf16 evaluation: reward {reward}")
    out["seconds_per_gradient_step"] = first["train_seconds"] / first["gradient_steps"]
    out["ckpt"] = first["checkpoint"]
    return out


def serve_path_bf16(ckpt: str, out_dir: str) -> dict:
    """The bf16 run's checkpoint through ``serve_main`` at bf16-mixed: 4
    slots, 4 sessions of 512 steps; every session completes and every tick
    launches the LN-GRU kernel with bf16 operands."""
    from sheeprl_tpu_torch.serve.main import serve_main

    log_dir = os.path.join(out_dir, "serve_bf16")
    _zero_launches()
    rc = serve_main([
        f"checkpoint_path={ckpt}", f"fabric.precision={BF16_PRECISION}", f"serve.slots={SLOTS}",
        f"serve.sessions={SESSIONS}", f"serve.max_session_steps={MAX_SESSION_STEPS}",
        f"env.wrapper.n_steps={MAX_SESSION_STEPS}", f"serve.log_dir={log_dir}",
    ])
    launches = _launches()
    with open(os.path.join(log_dir, "summary.json")) as f:
        summary = json.load(f)
    print(f"[chip-smoke] bf16 serve rc={rc} summary={json.dumps(summary)} launches={launches}", flush=True)
    if rc != 0 or summary["sessions_completed"] != SESSIONS or summary["steps"] != SESSIONS * MAX_SESSION_STEPS:
        raise AssertionError(f"bf16 serving did not complete every session: rc {rc}, {summary}")
    by_dtype = _bf16_launches("bf16 serving", summary["ticks"])
    tel = check_telemetry("bf16 serve", log_dir)
    return {"summary": summary, "launches": launches, "by_dtype": by_dtype, "hbm_peak_bytes": tel["hbm_peak_bytes"]}


# -- the serving planes (hot reload, faults, supervisor, telemetry, PPO) ------------
RELOAD_SESSION_STEPS = 2048  # a long run, so the swap lands while every session is served
SUPERVISED_SESSION_STEPS = 128
CRASH_AT = 200  # served steps: the first attempt dies mid-run, holding all 4 sessions
TELEMETRY_ROUNDS = 4  # serving runs with telemetry on and off, this many times each, in alternating order
TELEMETRY_TICKS = 4096  # observe_tick calls timed alone


def read_events(log_dir: str) -> list:
    path = os.path.join(log_dir, "telemetry.jsonl")
    if not os.path.isfile(path):
        return []
    out = []
    with open(path) as f:
        for line in f:
            try:
                out.append(json.loads(line))
            except ValueError:
                pass  # a line in flight
    return out


def check_telemetry(name: str, log_dir: str) -> dict:
    """The serve run's ``telemetry.jsonl`` (on by default): a start event on
    the gpu, windows whose ``hbm`` comes from ``torch.cuda.memory_stats``, and
    a clean summary. Returns the peak device bytes and the windows."""
    events = read_events(log_dir)
    windows = [e for e in events if e["event"] == "window"]
    start = next((e for e in events if e["event"] == "start"), {})
    summary = next((e for e in events if e["event"] == "summary"), {})
    hbm = [w["hbm"] for w in windows]
    print(f"[chip-smoke] {name} telemetry: {len(events)} events, {len(windows)} windows, platform "
          f"{start.get('platform')}, last hbm {hbm[-1] if hbm else None}, peak {summary.get('hbm_peak_bytes')}, "
          f"compile {summary.get('compile')}", flush=True)
    if start.get("platform") != "gpu" or not windows or not summary.get("clean_exit"):
        raise AssertionError(f"{name}: telemetry start {start}, {len(windows)} windows, summary {summary}")
    if not all(h and h.get("bytes_in_use", 0) > 0 and h.get("peak_bytes", 0) > 0 for h in hbm):
        raise AssertionError(f"{name}: windows without device memory: {hbm}")
    return {"events": len(events), "windows": windows, "hbm_peak_bytes": summary.get("hbm_peak_bytes")}


def _serve_run_dir(ckpt: str, run_dir: str) -> str:
    """A run dir to serve from: ``ckpt``'s config.yaml and a copy of ``ckpt``
    with its sidecar. Returns the checkpoint directory."""
    import shutil

    ckpt_dir = os.path.join(run_dir, "version_0", "checkpoint")
    os.makedirs(ckpt_dir)
    shutil.copyfile(os.path.join(os.path.dirname(os.path.dirname(ckpt)), "config.yaml"),
                    os.path.join(run_dir, "version_0", "config.yaml"))
    publish(ckpt, os.path.join(ckpt_dir, "ckpt_0_0.ckpt"))
    return ckpt_dir


def publish(src: str, dst: str) -> None:
    """Publish a checkpoint as a trainer commits one: the file renamed into
    place, then its sha256 sidecar."""
    import shutil

    shutil.copyfile(src, dst + ".tmp")
    os.replace(dst + ".tmp", dst)
    shutil.copyfile(src + ".sha256", dst + ".sha256.tmp")
    os.replace(dst + ".sha256.tmp", dst + ".sha256")


def publish_after_first_window(log_dir: str, src: str, dst: str):
    """A thread that publishes ``src`` at ``dst`` once the serve run's first
    telemetry window is written (sessions are being served by then)."""
    import threading

    done = threading.Event()

    def run():
        while not done.is_set():
            if any(e["event"] == "window" for e in read_events(log_dir)):
                publish(src, dst)
                return
            done.wait(0.05)

    thread = threading.Thread(target=run, name="chip-smoke-publish", daemon=True)
    thread.start()
    return thread, done


def _serve_args(run_dir: str, log_dir: str, steps: int, *extra: str) -> list:
    return [f"checkpoint_path={run_dir}", f"serve.slots={SLOTS}", f"serve.sessions={SESSIONS}",
            f"serve.max_session_steps={steps}", f"env.wrapper.n_steps={steps}", f"serve.log_dir={log_dir}", *extra]


def _swap_window(windows: list) -> dict:
    """The request latency of the window that holds the swap (it serves two
    weight versions) against the median of the windows that do not."""
    swap = [w for w in windows if len((w["serve"].get("versions") or {})) > 1]
    steady = [w for w in windows[1:] if len((w["serve"].get("versions") or {})) == 1]
    if not swap or not steady:
        raise AssertionError(f"no window holds the swap, or none is without one: {len(swap)}, {len(steady)}")
    lat = swap[0]["serve"]["latency_ms"]
    step_ms = 1000.0 * swap[0]["phases"]["serve_step"] / swap[0]["serve"]["ticks"]
    return {
        "swap_window": {"p50_ms": lat["p50"], "p99_ms": lat["p99"], "step_ms_per_tick": step_ms,
                        "ticks": swap[0]["serve"]["ticks"]},
        "other_windows": {
            "p50_ms": float(np.median([w["serve"]["latency_ms"]["p50"] for w in steady])),
            "p99_ms": float(np.median([w["serve"]["latency_ms"]["p99"] for w in steady])),
            "step_ms_per_tick": float(np.median([1000.0 * w["phases"]["serve_step"] / w["serve"]["ticks"]
                                                 for w in steady])),
            "windows": len(steady),
        },
    }


def reload_path(ckpt_a: str, ckpt_b: str, out_dir: str) -> dict:
    """Hot reload through ``serve_main``: serve A with ``serve.reload.enabled``
    on its run dir and publish B there once serving has begun. The reload
    event carries version 1, every session completes, and the LN-GRU kernel
    ran once a tick under both versions."""
    from sheeprl_tpu_torch.serve.main import serve_main

    run_dir = os.path.join(out_dir, "reload_run")
    ckpt_dir = _serve_run_dir(ckpt_a, run_dir)
    log_dir = os.path.join(out_dir, "serve_reload")
    thread, done = publish_after_first_window(log_dir, ckpt_b, os.path.join(ckpt_dir, "ckpt_1_0.ckpt"))
    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated()
    _zero_launches()
    rc = serve_main(_serve_args(run_dir, log_dir, RELOAD_SESSION_STEPS, "serve.reload.enabled=true",
                                "serve.reload.poll_s=0.2"))
    launches = _launches()
    done.set()
    thread.join(timeout=60)
    with open(os.path.join(log_dir, "summary.json")) as f:
        summary = json.load(f)
    tel = check_telemetry("reload serve", log_dir)
    reloads = [e for e in read_events(log_dir) if e["event"] == "reload"]
    by_version = summary["ticks_by_version"]
    print(f"[chip-smoke] reload serve rc={rc} summary={json.dumps(summary)} launches={launches} "
          f"reload events={json.dumps(reloads)}", flush=True)
    if rc != 0 or summary["sessions_completed"] != SESSIONS or summary["steps"] != SESSIONS * RELOAD_SESSION_STEPS:
        raise AssertionError(f"reload serving did not complete every session: rc {rc}, {summary}")
    if [(e["status"], e["version"]) for e in reloads] != [("applied", 1)] or summary["weight_version"] != 1:
        raise AssertionError(f"the published checkpoint was not applied once as version 1: {reloads}")
    if not (by_version.get("0", 0) > 0 and by_version.get("1", 0) > 0):
        raise AssertionError(f"the swap did not land mid-run: ticks by version {by_version}")
    if launches[LN_GRU.name] != summary["ticks"]:
        raise AssertionError(f"LN-GRU launched {launches[LN_GRU.name]} times in {summary['ticks']} ticks "
                             f"({by_version} by version)")
    latency = _swap_window(tel["windows"])
    print(f"[chip-smoke] reload serve: {json.dumps(latency)}; swap stage {reloads[0]['stage_ms']:.3f} ms, apply "
          f"{reloads[0]['apply_ms']:.3f} ms (host); peak device memory {tel['hbm_peak_bytes'] - held} bytes over "
          f"the {held} held before serving", flush=True)
    return {"summary": summary, "launches": launches, "reload": reloads[0], "latency": latency,
            "hbm_peak_bytes": tel["hbm_peak_bytes"], "hbm_held_before": held}


def torn_reload_path(ckpt_a: str, ckpt_b: str, out_dir: str) -> dict:
    """The ``reload_torn`` fault: the published candidate is torn before it is
    read, it is rejected, and version 0 serves every session to the end."""
    from sheeprl_tpu_torch.resilience import faults
    from sheeprl_tpu_torch.serve.main import serve_main

    run_dir = os.path.join(out_dir, "torn_run")
    ckpt_dir = _serve_run_dir(ckpt_a, run_dir)
    log_dir = os.path.join(out_dir, "serve_torn")
    thread, done = publish_after_first_window(log_dir, ckpt_b, os.path.join(ckpt_dir, "ckpt_1_0.ckpt"))
    faults.reset_faults()
    _zero_launches()
    try:
        rc = serve_main(_serve_args(run_dir, log_dir, MAX_SESSION_STEPS, "serve.reload.enabled=true",
                                    "serve.reload.poll_s=0.1", "resilience.fault.kind=reload_torn",
                                    "resilience.fault.at_policy_step=1"))
    finally:
        faults.reset_faults()
    launches = _launches()
    done.set()
    thread.join(timeout=60)
    with open(os.path.join(log_dir, "summary.json")) as f:
        summary = json.load(f)
    tel = check_telemetry("torn reload serve", log_dir)
    reloads = [e for e in read_events(log_dir) if e["event"] == "reload"]
    failures = tel["windows"][-1]["serve"]["weights"]["failures"]
    print(f"[chip-smoke] torn reload serve rc={rc} summary={json.dumps(summary)} reload events={json.dumps(reloads)} "
          f"serve.weights.failures={failures}", flush=True)
    if rc != 0 or summary["sessions_completed"] != SESSIONS or summary["steps"] != SESSIONS * MAX_SESSION_STEPS:
        raise AssertionError(f"torn-reload serving did not complete every session: rc {rc}, {summary}")
    if [e["status"] for e in reloads] != ["rejected"] or failures != 1 or summary["weight_version"] != 0:
        raise AssertionError(f"the torn candidate was not rejected once while version 0 served: {reloads}, "
                             f"failures {failures}, version {summary['weight_version']}")
    if launches[LN_GRU.name] != summary["ticks"]:
        raise AssertionError(f"LN-GRU launched {launches[LN_GRU.name]} times in {summary['ticks']} ticks")
    return {"summary": summary, "launches": launches, "reload": reloads[0], "failures": failures}


def supervisor_path(ckpt: str, out_dir: str) -> dict:
    """``serve.supervisor.enabled`` with a ``crash`` fault at served step 200:
    the first attempt dies holding every session, the supervisor restarts it
    once in the process, the second serves every session, exit 0."""
    from sheeprl_tpu_torch.resilience import faults
    from sheeprl_tpu_torch.serve.main import serve_main

    log_dir = os.path.join(out_dir, "serve_supervised")
    faults.reset_faults()
    _zero_launches()
    try:
        rc = serve_main(_serve_args(os.path.dirname(os.path.dirname(os.path.dirname(ckpt))), log_dir,
                                    SUPERVISED_SESSION_STEPS, "serve.supervisor.enabled=true",
                                    "serve.supervisor.backoff=0", "resilience.fault.kind=crash",
                                    f"resilience.fault.at_policy_step={CRASH_AT}"))
    finally:
        faults.reset_faults()
    launches = _launches()
    with open(os.path.join(log_dir, "summary.json")) as f:
        summary = json.load(f)
    events = read_events(log_dir)
    restarts = [e for e in events if e["event"] == "restart"]
    print(f"[chip-smoke] supervised serve rc={rc} summary={json.dumps(summary)} restarts={json.dumps(restarts)} "
          f"launches={launches}", flush=True)
    if rc != 0 or len(restarts) != 1 or restarts[0]["sessions_lost"] != SESSIONS or summary["restarts"] != 1:
        raise AssertionError(f"the crash did not give one restart and exit 0: rc {rc}, {restarts}, {summary}")
    if summary["sessions_completed"] != SESSIONS or summary["steps"] != SESSIONS * SUPERVISED_SESSION_STEPS:
        raise AssertionError(f"the restarted attempt did not serve every session: {summary}")
    # the crashed attempt's ticks (CRASH_AT / SLOTS of them) launched the kernel too
    if launches[LN_GRU.name] < summary["ticks"] + CRASH_AT // SLOTS:
        raise AssertionError(f"LN-GRU launched {launches[LN_GRU.name]} times for {summary['ticks']} ticks "
                             f"after the restart and {CRASH_AT // SLOTS} before it")
    return {"summary": summary, "launches": launches, "restart": restarts[0]}


def _fixed_carry(policy, rng) -> tuple:
    """A carry, observations and posterior noise for ``SLOTS`` rows, on the CPU."""
    agent = policy.module
    carry = {
        "action": torch.from_numpy(np.eye(int(sum(agent.actions_dim)), dtype=np.float32)[rng.integers(0, 2, SLOTS)]),
        "h": torch.from_numpy(np.tanh(rng.standard_normal((SLOTS, agent.recurrent_state_size))).astype(np.float32)),
        "z": torch.from_numpy(np.eye(agent.discrete_size, dtype=np.float32)[
            rng.integers(0, agent.discrete_size, (SLOTS, agent.stochastic_size))].reshape(SLOTS, -1)),
    }
    obs = {k: rng.integers(0, 256, (SLOTS, *s.shape)).astype(s.dtype) if np.issubdtype(s.dtype, np.integer)
           else rng.standard_normal((SLOTS, *s.shape)).astype(s.dtype) for k, s in policy.obs_spec.items()}
    gumbel = -np.log(-np.log(rng.uniform(1e-12, 1.0, (SLOTS, policy.noise_spec["repr"].size)))).astype(np.float32)
    return carry, obs, gumbel


def _step_from(policy, carry, obs, gumbel) -> tuple:
    dev = policy.device
    with torch.no_grad():
        actions, new = policy.step_slots({k: v.to(dev) for k, v in carry.items()},
                                         {k: torch.from_numpy(v).to(dev) for k, v in obs.items()},
                                         {"repr": torch.from_numpy(gumbel).to(dev)})
    return actions.cpu(), {k: v.float().cpu() for k, v in new.items()}


def swap_parity(ckpt_a: str, ckpt_b: str, out_dir: str, repeats: int = 3) -> dict:
    """A swap from A to B driven directly (``WeightReloader.step`` on the
    reload thread's side of the stream, the server's swap under its lock), TF32
    off: the staging and apply times of the whole DV3 S tree; then the batched
    step from a fixed carry after the swap equals, bit for bit, the step of a
    policy booted from B on the card, and the CPU's B step within the serve bar
    (h within 1e-3, every env action equal)."""
    import shutil

    from sheeprl_tpu_torch.algos.dreamer_v3.serve import get_serve_policy
    from sheeprl_tpu_torch.parallel.fabric import Fabric
    from sheeprl_tpu_torch.serve.main import build_serve_cfg
    from sheeprl_tpu_torch.serve.reload import CheckpointReloadSource, WeightReloader
    from sheeprl_tpu_torch.serve.server import PolicyServer
    from sheeprl_tpu_torch.utils.checkpoint import load_checkpoint

    watch = os.path.join(out_dir, "swap_watch")
    os.makedirs(watch)
    boot = os.path.join(watch, "ckpt_0_0.ckpt")
    publish(ckpt_a, boot)
    cfg = build_serve_cfg([f"checkpoint_path={ckpt_a}"])
    fabric = Fabric(accelerator="gpu", float32_matmul_precision="highest")
    swapped = get_serve_policy(fabric, cfg, load_checkpoint(ckpt_a))
    server = PolicyServer(swapped, slots=SLOTS)
    reloader = WeightReloader(server, CheckpointReloadSource(watch, current_path=boot))
    publish(ckpt_b, os.path.join(watch, "ckpt_1_0.ckpt"))
    tree_bytes = sum(t.numel() * t.element_size() for t in swapped.module.state_dict().values())
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    if reloader.step() != 1:
        raise AssertionError("the reloader did not stage B as version 1")
    poll_ms = (time.perf_counter() - t0) * 1e3
    timings = []
    tree = load_checkpoint(ckpt_b)["agent"]
    for i in range(repeats + 1):
        if i:  # the same tree staged again: the stage and the apply alone
            server.update_params(reloader.stager.stage(tree), 1)
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        with server._cond:
            server._apply_pending_params_locked()
        end.record()
        end.synchronize()
        timings.append({"stage_ms": server.last_swap["stage_ms"], "apply_host_ms": server.last_swap["apply_ms"],
                        "apply_device_ms": start.elapsed_time(end)})
    shutil.rmtree(watch)
    booted = get_serve_policy(fabric, cfg, load_checkpoint(ckpt_b))
    cpu = get_serve_policy(Fabric(accelerator="cpu"), cfg, load_checkpoint(ckpt_b))
    carry, obs, gumbel = _fixed_carry(cpu, np.random.default_rng(13))
    out = {name: _step_from(p, carry, obs, gumbel) for name, p in (("swapped", swapped), ("booted", booted),
                                                                   ("cpu", cpu))}
    vs_booted = max(float((out["swapped"][1][k] - out["booted"][1][k]).abs().max()) for k in ("h", "z", "action"))
    vs_cpu = float((out["swapped"][1]["h"] - out["cpu"][1]["h"]).abs().max())
    actions_equal = bool(torch.equal(out["swapped"][0], out["cpu"][0]))
    result = {"tree_bytes": tree_bytes, "poll_and_stage_ms": poll_ms, "timings": timings,
              "max_abs_err_vs_booted": vs_booted, "h_max_abs_err_vs_cpu": vs_cpu, "actions_equal_cpu": actions_equal}
    print(f"[chip-smoke] swap of the DV3 S tree ({tree_bytes} bytes): {json.dumps(result)} (bars: bitwise vs the "
          f"booted policy, h {SERVE_H_ATOL} and equal actions vs the CPU)", flush=True)
    if vs_booted != 0.0 or not torch.equal(out["swapped"][0], out["booted"][0]):
        raise AssertionError(f"the swapped policy's step differs from a policy booted from B: {vs_booted}")
    if not (vs_cpu <= SERVE_H_ATOL and actions_equal):
        raise AssertionError(f"the swapped policy's step disagrees with the CPU's: h {vs_cpu}, actions {actions_equal}")
    return result


def telemetry_cost(ckpt: str, out_dir: str) -> dict:
    """What the serving telemetry costs: ticks per second of the float32
    serving run (4 slots, 4 sessions of 512 steps) with telemetry on and off,
    in the order on, off, off, on, ... in one process; and the host time of
    ``ServingTelemetry.observe_tick`` alone, over ticks of 4 requests with a
    window every 256 steps, as the tick loop calls it."""
    from sheeprl_tpu_torch.parallel.fabric import Fabric
    from sheeprl_tpu_torch.serve.main import build_serve_cfg, serve_main
    from sheeprl_tpu_torch.serve.telemetry import ServingTelemetry

    run_dir = os.path.dirname(os.path.dirname(os.path.dirname(ckpt)))
    rates = {"on": [], "off": []}
    for i in range(TELEMETRY_ROUNDS):
        for mode in (("on", "off") if i % 2 == 0 else ("off", "on")):
            log_dir = os.path.join(out_dir, f"serve_telemetry_{mode}_{i}")
            rc = serve_main(_serve_args(run_dir, log_dir, MAX_SESSION_STEPS,
                                        f"serve.telemetry.enabled={str(mode == 'on').lower()}"))
            with open(os.path.join(log_dir, "summary.json")) as f:
                summary = json.load(f)
            if rc != 0 or summary["sessions_completed"] != SESSIONS:
                raise AssertionError(f"telemetry {mode} serving failed: rc {rc}, {summary}")
            if os.path.isfile(os.path.join(log_dir, "telemetry.jsonl")) != (mode == "on"):
                raise AssertionError(f"serve.telemetry.enabled={mode == 'on'} and a stream that says otherwise")
            rates[mode].append({"ticks_per_s": summary["ticks"] / summary["wall_s"],
                                "tick_ms_p50": summary["tick_ms_p50"], "tick_ms_p99": summary["tick_ms_p99"]})
    tel = ServingTelemetry(Fabric(accelerator="gpu"), build_serve_cfg([f"checkpoint_path={ckpt}"]),
                           os.path.join(out_dir, "telemetry_alone"))
    rng = np.random.default_rng(0)
    latencies = rng.gamma(2.0, 1.5, (TELEMETRY_TICKS, SLOTS)).tolist()
    t0 = time.perf_counter()
    for i in range(TELEMETRY_TICKS):
        tel.observe_tick(batch=SLOTS, slots=SLOTS, active=SLOTS, queue_depth=0, step_seconds=0.003,
                         wait_seconds=0.0005, latencies_ms=latencies[i], state_bytes=1 << 20, weight_version=0,
                         degraded=False)
    per_tick_us = (time.perf_counter() - t0) / TELEMETRY_TICKS * 1e6
    tel.close()
    medians = {mode: float(np.median([r["ticks_per_s"] for r in runs])) for mode, runs in rates.items()}
    out = {"runs": rates, "median_ticks_per_s": medians, "observe_tick_us": per_tick_us}
    print(f"[chip-smoke] serving with telemetry on vs off: {json.dumps(out)}", flush=True)
    return out


def ppo_serve_path(ckpt: str, out_dir: str) -> dict:
    """The PPO checkpoint through ``serve_main`` on the card (4 slots, 4
    greedy CartPole sessions); then the batched greedy step on the card
    against the CPU's on the same weights and observations (TF32 off): the
    actor's logits within 1e-5 and every action equal."""
    from sheeprl_tpu_torch.algos.ppo.serve import get_serve_policy
    from sheeprl_tpu_torch.parallel.fabric import Fabric
    from sheeprl_tpu_torch.serve.main import build_serve_cfg, serve_main
    from sheeprl_tpu_torch.utils.checkpoint import load_checkpoint

    log_dir = os.path.join(out_dir, "ppo_serve")
    _zero_launches()
    rc = serve_main([f"checkpoint_path={ckpt}", f"serve.slots={SLOTS}", f"serve.sessions={SESSIONS}",
                     f"serve.log_dir={log_dir}"])
    launches = _launches()
    with open(os.path.join(log_dir, "summary.json")) as f:
        summary = json.load(f)
    print(f"[chip-smoke] PPO serve rc={rc} summary={json.dumps(summary)} launches={launches}", flush=True)
    if rc != 0 or summary["sessions_completed"] != SESSIONS or summary["steps"] < SESSIONS:
        raise AssertionError(f"PPO serving did not complete every session: rc {rc}, {summary}")
    check_telemetry("PPO serve", log_dir)
    state = load_checkpoint(ckpt)
    cfg = build_serve_cfg([f"checkpoint_path={ckpt}"])
    policies = {accel: get_serve_policy(Fabric(accelerator=accel, float32_matmul_precision="highest"), cfg, state)
                for accel in ("gpu", "cpu")}
    obs = np.random.default_rng(17).uniform(-2, 2, (SLOTS, 4)).astype(np.float32)
    out = {}
    for accel, p in policies.items():
        t = {"state": torch.from_numpy(obs).to(p.device)}
        with torch.no_grad():
            logits = p.module({"state": t["state"]})[0][0].cpu()
        out[accel] = (p.step_slots({}, t, {})[0].cpu(), logits)
    err = float((out["gpu"][1] - out["cpu"][1]).abs().max())
    equal = bool(torch.equal(out["gpu"][0], out["cpu"][0]))
    print(f"[chip-smoke] PPO serve step card vs CPU: logits max abs err {err} (bar 1e-5), actions equal {equal}",
          flush=True)
    if not (err <= 1e-5 and equal):
        raise AssertionError(f"the PPO serve step on the card disagrees with the CPU: {err}, {equal}")
    return {"summary": summary, "launches": launches, "step_max_abs_err": err}


# PPO on CartPole-v1 at the exp's settings: 4 envs x 128 steps, minibatches
# of 64, 10 epochs, width 64, 65536 policy steps (128 train phases)
PPO_TOTAL_STEPS = 65536
PPO_STEPS_PER_ITER = 4 * 128
PPO_RESUME_ITERS = 2
PPO_TAGS = ("Loss/policy_loss", "Loss/value_loss", "Loss/entropy_loss", "Rewards/rew_avg",
            "Time/sps_train", "Time/sps_env_interaction")
PPO_MIN_TEST_REWARD = 100.0  # random play scores ~20 on CartPole
# one PPO train phase on the card vs on the CPU (TF32 off), 80 Adam updates:
# with the exp's eps of 1e-4, an update is proportional to its gradient
# below 1e-4, so float32 rounding gaps between cuBLAS and the CPU (~1e-6
# relative) stay that small through the updates, each at most ~lr = 1e-3:
# every parameter within 1e-4, the mean losses within 1e-4 relative
PPO_PARAM_ATOL = 1e-4
PPO_LOSS_RTOL = 1e-4
A2C_TOTAL_STEPS = 5120  # 256 train phases of 4 envs x 5 steps
# three RMSprop steps on the card vs the CPU from the same gradients: the
# same float32 expressions, the card's rsqrt may round another way
A2C_RMSPROP_ATOL = 1e-6


def ppo_path(out_dir: str) -> dict:
    """``exp=ppo`` through the entry points on the card: train for the exp's
    total steps with the metric log and the test episode, resume into
    version_1 for two more iterations, evaluate the last checkpoint. PPO
    reaches no TPU kernel: its launch counts are read to show that."""
    from sheeprl_tpu_torch.cli import evaluation, run

    overrides = ["exp=ppo", f"hydra.run.dir={os.path.join(out_dir, 'ppo')}"]
    out = {}
    _zero_launches()
    first = run(overrides + [f"algo.total_steps={PPO_TOTAL_STEPS}"])
    out["train"] = {"summary": first, "launches": _launches()}
    scalars = check_scalars("PPO first run", first["log_dir"], PPO_TAGS)
    out["train"]["scalars"] = {t: scalars[t][-1] for t in PPO_TAGS}
    steps = first["train_phases"] * 128
    out["seconds_per_train_phase_in_the_loop"] = first["train_seconds"] / first["train_phases"]
    out["seconds_per_vector_step_in_the_loop"] = first["env_seconds"] / steps
    print(f"[chip-smoke] PPO first run: {first['train_phases']} train phases, {first['policy_steps']} policy steps "
          f"in {first['wall_seconds']:.2f}s (train {first['train_seconds']:.2f}s, env {first['env_seconds']:.2f}s); "
          f"test reward {first['test_reward']} (bar >= {PPO_MIN_TEST_REWARD}); losses {json.dumps(first['metrics'])}; "
          f"last Time/sps_env_interaction {scalars['Time/sps_env_interaction'][-1][1]:.1f}, Time/sps_train "
          f"{scalars['Time/sps_train'][-1][1]:.1f}, Rewards/rew_avg {scalars['Rewards/rew_avg'][-1][1]:.1f}", flush=True)
    if first["train_phases"] != PPO_TOTAL_STEPS // PPO_STEPS_PER_ITER:
        raise AssertionError(f"PPO took {first['train_phases']} train phases")
    if not all(math.isfinite(v) for v in first["metrics"].values()):
        raise AssertionError(f"PPO: non-finite losses {first['metrics']}")
    if not (first["test_reward"] is not None and first["test_reward"] >= PPO_MIN_TEST_REWARD):
        raise AssertionError(f"PPO: test reward {first['test_reward']} < {PPO_MIN_TEST_REWARD}")
    _zero_launches()
    resumed = run(overrides + [f"algo.total_steps={PPO_TOTAL_STEPS + PPO_RESUME_ITERS * PPO_STEPS_PER_ITER}",
                               f"checkpoint.resume_from={first['checkpoint']}"])
    out["resume"] = {"summary": resumed, "launches": _launches()}
    print(f"[chip-smoke] PPO resumed run: {resumed['train_phases']} train phases into {resumed['log_dir']}, "
          f"losses {json.dumps(resumed['metrics'])}", flush=True)
    if not (resumed["log_dir"].endswith("version_1") and resumed["train_phases"] == PPO_RESUME_ITERS):
        raise AssertionError(f"PPO resume: {resumed['train_phases']} phases into {resumed['log_dir']}")
    if not all(math.isfinite(v) for v in resumed["metrics"].values()):
        raise AssertionError(f"PPO resume: non-finite losses {resumed['metrics']}")
    _zero_launches()
    reward = evaluation([f"checkpoint_path={resumed['checkpoint']}"])
    out["evaluation"] = {"reward": reward, "launches": _launches()}
    print(f"[chip-smoke] PPO evaluation: reward {reward}", flush=True)
    if not math.isfinite(reward):
        raise AssertionError(f"PPO evaluation: reward {reward}")
    return out


def a2c_path(out_dir: str) -> dict:
    """A short ``exp=a2c`` run on the card: finite losses, a checkpoint, the
    metric log."""
    from sheeprl_tpu_torch.cli import run

    _zero_launches()
    summary = run(["exp=a2c", f"algo.total_steps={A2C_TOTAL_STEPS}", f"hydra.run.dir={os.path.join(out_dir, 'a2c')}"])
    launches = _launches()
    check_scalars("A2C run", summary["log_dir"], ("Loss/policy_loss", "Loss/value_loss", "Time/sps_train"))
    print(f"[chip-smoke] A2C run: {summary['train_phases']} train phases in {summary['wall_seconds']:.2f}s, test "
          f"reward {summary['test_reward']}, losses {json.dumps(summary['metrics'])}, checkpoint "
          f"{os.path.basename(summary['checkpoint'] or '')}", flush=True)
    if not (summary["checkpoint"] and os.path.isfile(summary["checkpoint"])):
        raise AssertionError("A2C wrote no checkpoint")
    if not all(math.isfinite(v) for v in summary["metrics"].values()):
        raise AssertionError(f"A2C: non-finite losses {summary['metrics']}")
    return {"summary": summary, "launches": launches}


def _on_policy_agents(exp: str, devices, precision: str = "highest"):
    """The exp's agent on each device, the same weights from a seed; the cfg
    and the CartPole observation space."""
    from sheeprl_tpu_torch.algos.ppo.agent import build_agent
    from sheeprl_tpu_torch.config import compose
    from sheeprl_tpu_torch.parallel.fabric import Fabric
    from sheeprl_tpu_torch.utils.env import make_env

    cfg = compose([f"exp={exp}"])
    space = make_env(cfg, 0, 0)().observation_space
    agents = {}
    for accel in devices:
        fabric = Fabric(accelerator=accel, float32_matmul_precision=precision)
        agents[accel] = build_agent(fabric, (2,), False, cfg, space, 0)
    return agents, cfg


def _ppo_rollout(seed: int, T: int = 128, E: int = 4) -> tuple:
    rng = np.random.default_rng(seed)
    data = {
        "state": rng.standard_normal((T, E, 4)).astype(np.float32),
        "actions": np.eye(2, dtype=np.float32)[rng.integers(0, 2, (T, E))],
        "logprobs": -rng.uniform(0.1, 1.5, (T, E, 1)).astype(np.float32),
        "values": rng.standard_normal((T, E, 1)).astype(np.float32),
        "rewards": np.ones((T, E, 1), np.float32),
        "dones": (rng.uniform(size=(T, E, 1)) < 0.05).astype(np.float32),
    }
    return data, rng.standard_normal((E, 1)).astype(np.float32)


def _ppo_trainer(agent, cfg):
    from sheeprl_tpu_torch.algos.ppo.ppo import PPOTrainer, build_optimizer

    optimizer, schedule = build_optimizer(cfg, agent, PPO_TOTAL_STEPS // PPO_STEPS_PER_ITER)
    return PPOTrainer(agent, optimizer, cfg, schedule)


def ppo_train_phase_parity() -> dict:
    """One PPO train phase at the exp's shapes on the card vs on the CPU (TF32
    off): the same weights, rollout, next values and permutations."""
    agents, cfg = _on_policy_agents("ppo", ("gpu", "cpu"))
    data, next_values = _ppo_rollout(1)
    out = {}
    for accel, agent in agents.items():
        trainer = _ppo_trainer(agent, cfg)
        perms = trainer.draw_permutations(torch.Generator().manual_seed(2))
        dev = trainer.device
        losses = trainer.train_phase({k: torch.from_numpy(v).to(dev) for k, v in data.items()},
                                     torch.from_numpy(next_values).to(dev), perms, 0.2, 0.0)
        out[accel] = (losses.cpu(), [p.detach().cpu() for p in agent.parameters()])
    loss_gap = float(((out["gpu"][0] - out["cpu"][0]).abs() / out["cpu"][0].abs().clamp_min(1e-3)).max())
    param_gap = max(float((a - b).abs().max()) for a, b in zip(out["gpu"][1], out["cpu"][1]))
    res = {"losses_rel_gap": loss_gap, "param_max_abs_gap": param_gap, "card": out["gpu"][0].tolist(),
           "cpu": out["cpu"][0].tolist(), "updates": 80}
    print(f"[chip-smoke] PPO train phase card vs CPU (TF32 off, 80 updates): {json.dumps(res)} (bars: losses "
          f"{PPO_LOSS_RTOL} relative, every parameter {PPO_PARAM_ATOL})", flush=True)
    if not (loss_gap <= PPO_LOSS_RTOL and param_gap <= PPO_PARAM_ATOL):
        raise AssertionError(f"the PPO train phase on the card disagrees with the CPU: {res}")
    return res


def a2c_rmsprop_parity(steps: int = 3) -> dict:
    """The A2C optimizer (the exp's optax-semantics RMSprop) on the card vs on
    the CPU: the same weights and gradients, three steps."""
    from sheeprl_tpu_torch.config import instantiate

    agents, cfg = _on_policy_agents("a2c", ("gpu", "cpu"))
    opts = {accel: instantiate(cfg.algo.optimizer, agent.parameters()) for accel, agent in agents.items()}
    rng = np.random.default_rng(3)
    shapes = [tuple(p.shape) for p in agents["cpu"].parameters()]
    for _ in range(steps):
        grads = [rng.standard_normal(s).astype(np.float32) for s in shapes]
        for accel, agent in agents.items():
            for p, g in zip(agent.parameters(), grads):
                p.grad = torch.from_numpy(g).to(p.device)
            opts[accel].step()
    gap = max(float((a.detach().cpu() - b.detach()).abs().max())
              for a, b in zip(agents["gpu"].parameters(), agents["cpu"].parameters()))
    print(f"[chip-smoke] A2C RMSprop card vs CPU ({type(opts['gpu']).__name__}, {steps} steps): parameters within "
          f"{gap} (bar {A2C_RMSPROP_ATOL})", flush=True)
    if gap > A2C_RMSPROP_ATOL:
        raise AssertionError(f"RMSprop on the card disagrees with the CPU: {gap}")
    return {"param_max_abs_gap": gap, "steps": steps}


def time_ppo(phases: int = 5) -> tuple:
    """Seconds per PPO train phase on the card at the exp's shapes (TF32 as the
    config sets it), synchronized; and ms per acting step on the host (the
    host agent's forward and sample for 4 envs, one torch thread as the loop
    runs it). Returns the timings and the warm trainer with its inputs."""
    from sheeprl_tpu_torch.algos.ppo.agent import draw_policy_noise, policy_output
    from sheeprl_tpu_torch.algos.ppo.utils import prepare_obs

    agents, cfg = _on_policy_agents("ppo", ("gpu", "cpu"), precision="high")
    trainer = _ppo_trainer(agents["gpu"], cfg)
    data, next_values = _ppo_rollout(4)
    dev = trainer.device
    inputs = ({k: torch.from_numpy(v).to(dev) for k, v in data.items()}, torch.from_numpy(next_values).to(dev))
    generator = torch.Generator().manual_seed(5)
    trainer.train_phase(*inputs, trainer.draw_permutations(generator), 0.2, 0.0)  # warm-up
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(phases):
        trainer.train_phase(*inputs, trainer.draw_permutations(generator), 0.2, 0.0)
    torch.cuda.synchronize()
    out = {"phases": phases, "seconds_per_train_phase": (time.perf_counter() - t0) / phases}
    act, obs = agents["cpu"], {"state": data["state"][0]}
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    with torch.no_grad():
        def act_step():
            actor_outs, values = act(prepare_obs(obs, num_envs=4))
            return policy_output(actor_outs, values, (2,), False, noise=draw_policy_noise((2,), False, 4, generator, "cpu"))

        for _ in range(50):
            act_step()
        steps = 1000
        t0 = time.perf_counter()
        for _ in range(steps):
            act_step()
        out["ms_per_acting_step"] = (time.perf_counter() - t0) * 1e3 / steps
    torch.set_num_threads(threads)
    print(f"[chip-smoke] PPO timing: {json.dumps(out)}", flush=True)
    return out, (trainer, inputs, generator)


def profile_ppo_train_phase(warm: tuple) -> dict:
    """Under torch.profiler (last), the card's busy share of one PPO train
    phase and its device operations."""
    from torch.profiler import ProfilerActivity, profile

    trainer, inputs, generator = warm
    perms = trainer.draw_permutations(generator)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        trainer.train_phase(*inputs, perms, 0.2, 0.0)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    by_kernel, count = {}, 0
    for ev in device_events(prof):
        by_kernel[ev.name] = by_kernel.get(ev.name, 0.0) + ev.time_range.elapsed_us() / 1e3
        count += 1
    device_ms = sum(by_kernel.values())
    out = {
        "phase_wall_ms": wall_ms,
        "phase_device_ms": device_ms if device_ms > 0 else None,
        "device_busy_share": device_ms / wall_ms if device_ms > 0 else None,
        "device_operations": count,
        "top_device_ms": sorted(by_kernel.items(), key=lambda kv: -kv[1])[:8],
    }
    print(f"[chip-smoke] PPO train phase profile: {json.dumps(out)}", flush=True)
    return out


# SAC on Pendulum-v1 at the exp's settings (hidden 256 for the actor and the
# 2 critics, batch 256, replay ratio 1, learning_starts 100, 4 envs): 12,000
# policy steps (3,000 iterations, ~12,000 gradient steps). On the CPU three
# seeds' runs of 12,000 steps ended with test rewards of -3 to -122 and their
# last episodes averaging -118 to -161 (-262 to -145 already at 6,000 steps);
# random play scores about -1,200 and a solved policy about -150. The card's
# float32 rounding takes another trajectory, so the bar sits well below the
# CPU's results and well above random play
SAC_TOTAL_STEPS = 12000
SAC_STEPS_PER_ITER = 4
SAC_RESUME_STEPS = 400  # 100 more iterations: 25 wait for learning_starts again, then training
SAC_MIN_TEST_REWARD = -400.0
SAC_TAGS = ("Loss/value_loss", "Loss/policy_loss", "Loss/alpha_loss", "Rewards/rew_avg", "Time/sps_train",
            "Time/sps_env_interaction")
# DroQ, a short run at the exp's replay ratio 20: 50 iterations, the first
# train phase 1,600 critic updates (Ratio's first call counts the prefill),
# then 80 a phase
DROQ_TOTAL_STEPS = 200
# one SAC train phase (G = 4 gradient steps) and one DroQ train phase (G = 4
# critic updates, then the actor's) at the exp's widths on the card vs the
# CPU, TF32 off, from the same weights, block, normal draws and dropout masks.
# The actor's output heads are scaled by 0.1 first, so that the pre-squash
# samples stay near N(0, 1): on tanh's saturated tail the two devices' float32
# tanh may differ by ulps, which log(1 - tanh^2 + 1e-6) magnifies into the
# log-probs (tests/test_torch_sac_agent.py::test_squash_logprob_where_tanh_saturates).
# Adam's first updates move each weight by about lr = 3e-4 whatever the
# gradient's size; a gradient within rounding of 0 may step either way: every
# parameter within 1e-4, the losses within 1e-4 relative (or of 1e-3)
SAC_PARITY_G = 4
SAC_PARAM_ATOL = 1e-4
SAC_LOSS_RTOL = 1e-4
DROQ_TIMING_G = 20  # the per-phase critic updates of DroQ's replay ratio 20 at one env


def sac_path(out_dir: str) -> dict:
    """``exp=sac env.id=Pendulum-v1`` through the entry points on the card:
    train 12,000 policy steps with the config's defaults (video warned,
    metric log, memmap buffer in the checkpoint), the test episode's reward
    over the bar; resume into version_1; evaluate. SAC reaches no TPU kernel:
    its launch counts are read to show that."""
    from sheeprl_tpu_torch.cli import evaluation, run

    overrides = ["exp=sac", "env.id=Pendulum-v1", f"hydra.run.dir={os.path.join(out_dir, 'sac')}"]
    out = {}
    _zero_launches()
    first = run(overrides + [f"algo.total_steps={SAC_TOTAL_STEPS}"])
    out["train"] = {"summary": first, "launches": _launches()}
    scalars = check_scalars("SAC first run", first["log_dir"], SAC_TAGS)
    out["train"]["scalars"] = {t: scalars[t][-1] for t in SAC_TAGS}
    out["train"]["rew_avg_curve"] = scalars["Rewards/rew_avg"]
    out["seconds_per_gradient_step_in_the_loop"] = first["train_seconds"] / first["gradient_steps"]
    out["seconds_per_iteration_acting_in_the_loop"] = first["env_seconds"] / first["iterations"]
    print(f"[chip-smoke] SAC first run: {first['gradient_steps']} gradient steps in {first['train_phases']} train "
          f"phases, {first['policy_steps']} policy steps in {first['wall_seconds']:.2f}s (train "
          f"{first['train_seconds']:.2f}s, env {first['env_seconds']:.2f}s); test reward {first['test_reward']} "
          f"(bar >= {SAC_MIN_TEST_REWARD}); losses {json.dumps(first['metrics'])}; Rewards/rew_avg "
          f"{[(s, round(v, 1)) for s, v in scalars['Rewards/rew_avg']]}; last Time/sps_env_interaction "
          f"{scalars['Time/sps_env_interaction'][-1][1]:.1f}, Time/sps_train {scalars['Time/sps_train'][-1][1]:.1f}",
          flush=True)
    if first["policy_steps"] != SAC_TOTAL_STEPS or first["gradient_steps"] < SAC_TOTAL_STEPS - 200:
        raise AssertionError(f"SAC took {first['gradient_steps']} gradient steps in {first['policy_steps']} steps")
    if not all(math.isfinite(v) for v in first["metrics"].values()):
        raise AssertionError(f"SAC: non-finite losses {first['metrics']}")
    if not (first["test_reward"] is not None and first["test_reward"] >= SAC_MIN_TEST_REWARD):
        raise AssertionError(f"SAC: test reward {first['test_reward']} < {SAC_MIN_TEST_REWARD}")
    _zero_launches()
    resumed = run(overrides + [f"algo.total_steps={SAC_TOTAL_STEPS + SAC_RESUME_STEPS}",
                               f"checkpoint.resume_from={first['checkpoint']}"])
    out["resume"] = {"summary": resumed, "launches": _launches()}
    print(f"[chip-smoke] SAC resumed run: {resumed['gradient_steps']} gradient steps into {resumed['log_dir']}, "
          f"test reward {resumed['test_reward']}, losses {json.dumps(resumed['metrics'])}", flush=True)
    if not (resumed["log_dir"].endswith("version_1") and resumed["gradient_steps"] > 0):
        raise AssertionError(f"SAC resume: {resumed['gradient_steps']} gradient steps into {resumed['log_dir']}")
    if not all(math.isfinite(v) for v in resumed["metrics"].values()):
        raise AssertionError(f"SAC resume: non-finite losses {resumed['metrics']}")
    _zero_launches()
    reward = evaluation([f"checkpoint_path={resumed['checkpoint']}"])
    out["evaluation"] = {"reward": reward, "launches": _launches()}
    print(f"[chip-smoke] SAC evaluation: reward {reward}", flush=True)
    if not math.isfinite(reward):
        raise AssertionError(f"SAC evaluation: reward {reward}")
    out["ckpt"] = first["checkpoint"]
    return out


def sac_serve_path(ckpt: str, out_dir: str) -> dict:
    """The SAC checkpoint through ``serve_main`` on the card: 4 slots, 4
    sessions of Pendulum's 200 steps, greedy; then the batched greedy step on
    the card against the CPU's on the same weights and observations (TF32 off,
    within 1e-5: three float32 layers and a tanh)."""
    from sheeprl_tpu_torch.algos.sac.serve import get_serve_policy
    from sheeprl_tpu_torch.parallel.fabric import Fabric
    from sheeprl_tpu_torch.serve.main import build_serve_cfg, serve_main
    from sheeprl_tpu_torch.utils.checkpoint import load_checkpoint

    log_dir = os.path.join(out_dir, "sac_serve")
    _zero_launches()
    rc = serve_main([f"checkpoint_path={ckpt}", f"serve.slots={SLOTS}", f"serve.sessions={SESSIONS}",
                     f"serve.log_dir={log_dir}"])
    launches = _launches()
    with open(os.path.join(log_dir, "summary.json")) as f:
        summary = json.load(f)
    print(f"[chip-smoke] SAC serve rc={rc} summary={json.dumps(summary)}", flush=True)
    if rc != 0 or summary["sessions_completed"] != SESSIONS or summary["steps"] != SESSIONS * 200:
        raise AssertionError(f"SAC serving did not complete every session: rc {rc}, {summary}")
    state = load_checkpoint(ckpt)
    cfg = build_serve_cfg([f"checkpoint_path={ckpt}"])
    policies = {accel: get_serve_policy(Fabric(accelerator=accel, float32_matmul_precision="highest"), cfg, state)
                for accel in ("gpu", "cpu")}
    rng = np.random.default_rng(11)
    theta = rng.uniform(-np.pi, np.pi, (SLOTS, 1))
    obs = np.concatenate([np.cos(theta), np.sin(theta), rng.uniform(-8, 8, (SLOTS, 1))], axis=-1).astype(np.float32)
    actions = {accel: p.step_slots({}, {"state": torch.from_numpy(obs).to(p.device)}, {})[0].cpu()
               for accel, p in policies.items()}
    err = float((actions["gpu"] - actions["cpu"]).abs().max())
    print(f"[chip-smoke] SAC serve step card vs CPU: actions max abs err {err} (bar 1e-5)", flush=True)
    if not err <= 1e-5:
        raise AssertionError(f"the SAC serve step on the card disagrees with the CPU: {err}")
    return {"summary": summary, "launches": launches, "step_max_abs_err": err}


def droq_path(out_dir: str) -> dict:
    """A short ``exp=droq env.id=Pendulum-v1`` run on the card at the exp's
    widths and replay ratio: finite losses, a checkpoint, an evaluation."""
    from sheeprl_tpu_torch.cli import evaluation, run

    _zero_launches()
    summary = run(["exp=droq", "env.id=Pendulum-v1", f"algo.total_steps={DROQ_TOTAL_STEPS}",
                   f"hydra.run.dir={os.path.join(out_dir, 'droq')}"])
    launches = _launches()
    print(f"[chip-smoke] DroQ run: {summary['gradient_steps']} critic updates in {summary['train_phases']} train "
          f"phases in {summary['wall_seconds']:.2f}s (train {summary['train_seconds']:.2f}s), test reward "
          f"{summary['test_reward']}, losses {json.dumps(summary['metrics'])}, checkpoint "
          f"{os.path.basename(summary['checkpoint'] or '')}", flush=True)
    if not (summary["checkpoint"] and os.path.isfile(summary["checkpoint"])):
        raise AssertionError("DroQ wrote no checkpoint")
    if not (summary["metrics"] and all(math.isfinite(v) for v in summary["metrics"].values())):
        raise AssertionError(f"DroQ: non-finite losses {summary['metrics']}")
    _zero_launches()
    reward = evaluation([f"checkpoint_path={summary['checkpoint']}"])
    print(f"[chip-smoke] DroQ evaluation: reward {reward}", flush=True)
    if not math.isfinite(reward):
        raise AssertionError(f"DroQ evaluation: reward {reward}")
    return {"summary": summary, "launches": launches,
            "evaluation": {"reward": reward, "launches": _launches()}}


def _sac_trainers(algo: str, devices, precision: str = "highest", scale_heads: bool = True):
    """The exp's agent and trainer on each device, the same weights from a
    seed (the actor's heads scaled by 0.1 for the parity phases); the cfg."""
    from sheeprl_tpu_torch.algos.sac.sac import build_optimizers
    from sheeprl_tpu_torch.config import compose
    from sheeprl_tpu_torch.parallel.fabric import Fabric
    from sheeprl_tpu_torch.utils.env import make_env

    if algo == "droq":
        from sheeprl_tpu_torch.algos.droq.agent import build_agent
        from sheeprl_tpu_torch.algos.droq.droq import DroQTrainer as Trainer
    else:
        from sheeprl_tpu_torch.algos.sac.agent import build_agent
        from sheeprl_tpu_torch.algos.sac.sac import SACTrainer as Trainer
    cfg = compose([f"exp={algo}", "env.id=Pendulum-v1", "env.capture_video=False"])
    env = make_env(cfg, 0, 0)()
    trainers = {}
    for accel in devices:
        fabric = Fabric(accelerator=accel, float32_matmul_precision=precision)
        agent = build_agent(fabric, cfg, env.observation_space, env.action_space, 0)
        if scale_heads:
            with torch.no_grad():
                agent.actor.fc_mean.weight.mul_(0.1)
                agent.actor.fc_logstd.weight.mul_(0.1)
        trainers[accel] = Trainer(agent, build_optimizers(cfg, agent), cfg, -1.0, SAC_STEPS_PER_ITER)
    return trainers, cfg


def _replay_block(rng, leading) -> dict:
    th = rng.uniform(-np.pi, np.pi, (*leading, 1))
    obs = np.concatenate([np.cos(th), np.sin(th), rng.uniform(-8, 8, (*leading, 1))], axis=-1)
    return {
        "observations": obs.astype(np.float32),
        "next_observations": (obs + rng.normal(0, 0.05, obs.shape)).astype(np.float32),
        "actions": rng.uniform(-2, 2, (*leading, 1)).astype(np.float32),
        "rewards": -rng.uniform(0, 16, (*leading, 1)).astype(np.float32),
        "terminated": np.zeros((*leading, 1), np.float32),
        "truncated": np.zeros((*leading, 1), np.float32),
    }


def _run_phase(algo: str, trainer, block: dict, actor_block: dict, noise: dict, iter_num: int = 1):
    dev = trainer.device

    def on(tree):
        return {k: (torch.from_numpy(v) if isinstance(v, np.ndarray) else v).to(dev) for k, v in tree.items()}

    if algo == "droq":
        return trainer.train_phase(on(block), on(actor_block), on(noise))
    return trainer.train_phase(on(block), iter_num, on(noise))


def sac_train_phase_parity(algo: str) -> dict:
    """One SAC (or DroQ) train phase at the exp's widths on the card vs on the
    CPU (TF32 off): the same weights, replay block, normal draws and dropout
    masks (drawn once on the host)."""
    trainers, cfg = _sac_trainers(algo, ("gpu", "cpu"))
    B = int(cfg.algo.per_rank_batch_size)
    rng = np.random.default_rng(12)
    block, actor_block = _replay_block(rng, (SAC_PARITY_G, B)), _replay_block(rng, (B,))
    noise = trainers["cpu"].draw_noise(SAC_PARITY_G, B, torch.Generator().manual_seed(13))
    out = {}
    for accel, trainer in trainers.items():
        losses = _run_phase(algo, trainer, block, actor_block, noise)
        out[accel] = (losses.cpu(), [p.detach().cpu() for p in trainer.agent.parameters()])
    loss_gap = float(((out["gpu"][0] - out["cpu"][0]).abs() / out["cpu"][0].abs().clamp_min(1e-3)).max())
    param_gap = max(float((a - b).abs().max()) for a, b in zip(out["gpu"][1], out["cpu"][1]))
    res = {"losses_rel_gap": loss_gap, "param_max_abs_gap": param_gap, "card": out["gpu"][0].tolist(),
           "cpu": out["cpu"][0].tolist(), "G": SAC_PARITY_G, "batch": B}
    print(f"[chip-smoke] {algo} train phase card vs CPU (TF32 off, G={SAC_PARITY_G}): {json.dumps(res)} (bars: "
          f"losses {SAC_LOSS_RTOL} relative, every parameter {SAC_PARAM_ATOL})", flush=True)
    if not (loss_gap <= SAC_LOSS_RTOL and param_gap <= SAC_PARAM_ATOL):
        raise AssertionError(f"the {algo} train phase on the card disagrees with the CPU: {res}")
    return res


def time_sac(steps: int = 64, droq_phases: int = 5) -> tuple:
    """Seconds per SAC gradient step on the card at the exp's widths (a train
    phase of 64 steps, TF32 as the config sets it, synchronized), seconds per
    DroQ train phase of G = 20 critic updates, and ms per host acting step (the
    host actor's forward and sample for 4 envs, one torch thread as the loop
    runs it). Returns the timings and the warm SAC trainer with its inputs."""
    from sheeprl_tpu_torch.algos.sac.agent import squash_and_logprob

    out = {}
    rng = np.random.default_rng(14)
    generator = torch.Generator("cuda").manual_seed(15)
    trainers, cfg = _sac_trainers("sac", ("gpu",), precision="high", scale_heads=False)
    sac = trainers["gpu"]
    B = int(cfg.algo.per_rank_batch_size)
    block = _replay_block(rng, (steps, B))
    _run_phase("sac", sac, block, {}, sac.draw_noise(steps, B, generator))  # warm-up
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    _run_phase("sac", sac, block, {}, sac.draw_noise(steps, B, generator))
    torch.cuda.synchronize()
    out["seconds_per_sac_gradient_step"] = (time.perf_counter() - t0) / steps
    droq = _sac_trainers("droq", ("gpu",), precision="high", scale_heads=False)[0]["gpu"]
    dblock, actor_block = _replay_block(rng, (DROQ_TIMING_G, B)), _replay_block(rng, (B,))
    _run_phase("droq", droq, dblock, actor_block, droq.draw_noise(DROQ_TIMING_G, B, generator))  # warm-up
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(droq_phases):
        _run_phase("droq", droq, dblock, actor_block, droq.draw_noise(DROQ_TIMING_G, B, generator))
    torch.cuda.synchronize()
    out["seconds_per_droq_train_phase"] = (time.perf_counter() - t0) / droq_phases
    out["droq_critic_updates_per_phase"] = DROQ_TIMING_G
    act = _sac_trainers("sac", ("cpu",), scale_heads=False)[0]["cpu"].agent.actor
    obs = torch.from_numpy(block["observations"][0, :4])
    act_generator = torch.Generator().manual_seed(16)
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    with torch.no_grad():
        def act_step():
            mean, std = act(obs)
            eps = torch.randn(mean.shape, generator=act_generator)
            return squash_and_logprob(mean, std, eps, act.action_scale, act.action_bias)[0].numpy()

        for _ in range(50):
            act_step()
        n = 1000
        t0 = time.perf_counter()
        for _ in range(n):
            act_step()
        out["ms_per_acting_step"] = (time.perf_counter() - t0) * 1e3 / n
    torch.set_num_threads(threads)
    print(f"[chip-smoke] SAC/DroQ timing: {json.dumps(out)}", flush=True)
    return out, (sac, block, generator)


def profile_sac_train_phase(warm: tuple) -> dict:
    """Under torch.profiler (last), the card's busy share of one SAC train
    phase of the loop's G = 4 gradient steps, and its device operations."""
    from torch.profiler import ProfilerActivity, profile

    sac, block, generator = warm
    G = SAC_STEPS_PER_ITER
    part = {k: v[:G] for k, v in block.items()}
    B = part["rewards"].shape[1]
    noise = sac.draw_noise(G, B, generator)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        _run_phase("sac", sac, part, {}, noise)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    by_kernel, count = {}, 0
    for ev in device_events(prof):
        by_kernel[ev.name] = by_kernel.get(ev.name, 0.0) + ev.time_range.elapsed_us() / 1e3
        count += 1
    device_ms = sum(by_kernel.values())
    out = {
        "gradient_steps": G,
        "phase_wall_ms": wall_ms,
        "phase_device_ms": device_ms if device_ms > 0 else None,
        "device_busy_share": device_ms / wall_ms if device_ms > 0 else None,
        "device_operations": count,
        "device_operations_per_gradient_step": count / G,
        "top_device_ms": sorted(by_kernel.items(), key=lambda kv: -kv[1])[:8],
    }
    print(f"[chip-smoke] SAC train phase profile: {json.dumps(out)}", flush=True)
    return out


def serve_step_parity(ckpt: str, precision: str = "32-true") -> dict:
    """The batched DV3 serve step on the card vs on the CPU at ``precision``,
    same weights, observations and noise (in the policy's dtype), 8 ticks.

    float32: both run free from the same fresh carries; h within 1e-3 and
    every env action equal. bf16: a sampled posterior flips wherever a logit
    plus its Gumbel noise lands on a bf16 tie that the two sides break apart,
    and a flipped one-hot moves h by far more than a rounding, so each tick
    starts both sides from the CPU's carry: h within 2^-5 after one step (8
    bf16 roundings near |h| = 1), at least 95% of the sampled posterior
    variables and 90% of the env actions the same."""
    from sheeprl_tpu_torch.algos.dreamer_v3.serve import get_serve_policy
    from sheeprl_tpu_torch.parallel.fabric import Fabric
    from sheeprl_tpu_torch.serve.main import build_serve_cfg
    from sheeprl_tpu_torch.utils.checkpoint import load_checkpoint

    bf16 = precision.startswith("bf16")
    state = load_checkpoint(ckpt)
    cfg = build_serve_cfg([f"checkpoint_path={ckpt}"])
    policies = {}
    for accel in ("gpu", "cpu"):
        fabric = Fabric(accelerator=accel, precision=precision, float32_matmul_precision="highest")
        policies[accel] = get_serve_policy(fabric, cfg, state)
    rng = np.random.default_rng(7)
    carries = {k: p.init_slots(SLOTS) for k, p in policies.items()}
    h_err, actions_equal, z_equal, ticks = 0.0, 0, 0, 8
    noise_dtype = policies["cpu"].noise_spec["repr"].dtype
    discrete = policies["cpu"].module.discrete_size
    card = policies["gpu"].device
    for _ in range(ticks):
        obs = {
            k: rng.integers(0, 256, (SLOTS, *s.shape)).astype(s.dtype)
            if np.issubdtype(s.dtype, np.integer)
            else rng.standard_normal((SLOTS, *s.shape)).astype(s.dtype)
            for k, s in policies["cpu"].obs_spec.items()
        }
        gumbel = -np.log(-np.log(rng.uniform(1e-12, 1.0, (SLOTS, policies["cpu"].noise_spec["repr"].size))))
        if bf16:
            carries["gpu"] = {k: v.to(card) for k, v in carries["cpu"].items()}
        out = {}
        for accel, policy in policies.items():
            dev = policy.device
            obs_t = {k: torch.from_numpy(v).to(dev) for k, v in obs.items()}
            noise = {"repr": torch.tensor(gumbel, dtype=torch.float32, device=dev).to(noise_dtype)}
            out[accel] = policy.step_slots(carries[accel], obs_t, noise)
            carries[accel] = out[accel][1]
        h_err = max(h_err, float((out["gpu"][1]["h"].float().cpu() - out["cpu"][1]["h"].float()).abs().max()))
        actions_equal += int((out["gpu"][0].cpu() == out["cpu"][0]).sum())
        z = {a: o[1]["z"].float().cpu().reshape(SLOTS, -1, discrete).argmax(-1) for a, o in out.items()}
        z_equal += int((z["gpu"] == z["cpu"]).sum())
        if not torch.isfinite(out["gpu"][1]["h"].float()).all():
            raise AssertionError("non-finite recurrent state on the card")
    n_actions = ticks * int(out["cpu"][0].numel())
    n_z = ticks * int(z["cpu"].numel())
    h_bar, z_share, a_share = (SERVE_H_ATOL_BF16, 0.95, 0.9) if bf16 else (SERVE_H_ATOL, 0.0, 1.0)
    print(f"[chip-smoke] serve step card vs CPU at {precision}: h max abs err {h_err} (bar {h_bar}), posterior "
          f"samples equal {z_equal}/{n_z} (bar {z_share:.0%}), env actions equal {actions_equal}/{n_actions} "
          f"(bar {a_share:.0%})", flush=True)
    if h_err > h_bar or actions_equal < a_share * n_actions or z_equal < z_share * n_z:
        raise AssertionError(f"serve step at {precision} on the card disagrees with the CPU: h err {h_err}, "
                             f"samples {z_equal}/{n_z}, actions {actions_equal}/{n_actions}")
    return {"precision": precision, "h_max_abs_err": h_err, "samples_equal": z_equal, "samples": n_z,
            "actions_equal": actions_equal, "actions": n_actions, "ticks": ticks}


def profile_ticks(ckpt: str, ticks: int = 32) -> dict:
    """Where a serving tick's time goes: full-slot ticks of the slot table, as
    the serve verb configures it (TF32 per ``float32_matmul_precision``), under
    torch.profiler; device time by kernel, and the device's busy share of the
    ticks' wall time (the profiler's own host cost included)."""
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
    for ev in device_events(prof):  # one event per kernel run on the card
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
        # the port's own launches by name, wherever they rank
        "ln_gru_device_ms": {name: ms for name, ms in by_kernel.items() if "ln_gru" in name},
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
    gru_bf16 = check_gru(device, BF16)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as tmp:
        path = main_path(tmp)
        parity = serve_step_parity(path["ckpt"])
        train = train_path(tmp)
        train_parity = train_step_parity()
        # the serving planes: the first DV3 run's checkpoint (A) and the
        # resumed run's (B, the same run's version_1)
        ckpt_a, ckpt_b = (train[name]["summary"]["checkpoint"] for name in ("train", "resume"))
        planes = {"reload": reload_path(ckpt_a, ckpt_b, tmp), "torn_reload": torn_reload_path(ckpt_a, ckpt_b, tmp),
                  "swap": swap_parity(ckpt_a, ckpt_b, tmp), "supervisor": supervisor_path(path["ckpt"], tmp),
                  "telemetry_cost": telemetry_cost(path["ckpt"], tmp)}
        # seconds per gradient step in float32, then in bf16, one after the other
        train_timing, warm = time_train_steps()
        bf16 = {}
        bf16["timing"], warm_bf16 = time_train_steps(precision=BF16_PRECISION)
        bf16.update(train_path_bf16(tmp))
        bf16["serve"] = serve_path_bf16(bf16["ckpt"], tmp)
        bf16["serve_parity"] = serve_step_parity(bf16["ckpt"], BF16_PRECISION)
        bf16["train_parity"] = train_step_parity(precision=BF16_PRECISION)
        ppo = ppo_path(tmp)
        ppo["serve"] = ppo_serve_path(ppo["train"]["summary"]["checkpoint"], tmp)
        a2c = a2c_path(tmp)
        ppo["parity"] = ppo_train_phase_parity()
        a2c["rmsprop_parity"] = a2c_rmsprop_parity()
        ppo["timing"], ppo_warm = time_ppo()
        sac = sac_path(tmp)
        sac["serve"] = sac_serve_path(sac["ckpt"], tmp)
        droq = droq_path(tmp)
        sac["parity"] = sac_train_phase_parity("sac")
        droq["parity"] = sac_train_phase_parity("droq")
        sac["timing"], sac_warm = time_sac()
        profile_gru(gru["rows"] + gru_bf16["rows"], device)
        profile = profile_ticks(path["ckpt"])
        train_timing["profile"] = profile_train_steps(warm)
        bf16["timing"]["profile"] = profile_train_steps(warm_bf16)
        ppo["timing"]["profile"] = profile_ppo_train_phase(ppo_warm)
        sac["timing"]["profile"] = profile_sac_train_phase(sac_warm)
        del warm, warm_bf16, ppo_warm, sac_warm

    main_row = next(r for r in gru["rows"] if (r["preset"], r["B"], r["K"], r["H"]) == MAIN_SHAPE)
    train_rows = [r for r in gru["rows"] if (r["preset"], r["B"], r["K"], r["H"]) in TRAIN_SHAPES]
    keep = ("B", "K", "H", "ms", "plain_ms", "library_ms", "bound_ms", "bound_by", "max_abs_err",
            "grad_max_abs_err", "launches_per_call", "call_ms")
    kernels = [
        {
            "name": LN_GRU.name,
            "route": LN_GRU.route,
            "source": f"sheeprl_tpu_torch/csrc/{LN_GRU.source}",
            "replaces": LN_GRU.replaces,
            # the training slice's main path: the first training run
            "launches": train["train"]["launches"][LN_GRU.name],
            "launches_by_path": {
                "serve": path["launches"][LN_GRU.name],
                **{name: train[name]["launches"][LN_GRU.name] for name in ("train", "resume", "evaluation")},
                # PPO and A2C reach no TPU kernel
                **{f"ppo_{name}": ppo[name]["launches"][LN_GRU.name]
                   for name in ("train", "resume", "evaluation", "serve")},
                "a2c": a2c["launches"][LN_GRU.name],
                # SAC and DroQ reach no TPU kernel either
                **{f"sac_{name}": sac[name]["launches"][LN_GRU.name]
                   for name in ("train", "resume", "evaluation", "serve")},
                "droq": droq["launches"][LN_GRU.name],
                "droq_evaluation": droq["evaluation"]["launches"][LN_GRU.name],
                # DV3 S at fabric.precision=bf16-mixed: every launch with bf16 operands
                **{f"bf16_{name}": bf16[name]["launches"][LN_GRU.name]
                   for name in ("train", "resume", "evaluation", "serve")},
                # the serving planes: one launch a tick across the swap, under the
                # torn candidate, and in both attempts of the supervised run
                **{f"serve_{name}": planes[name]["launches"][LN_GRU.name]
                   for name in ("reload", "torn_reload", "supervisor")},
            },
            "launches_by_dtype": {
                name: bf16[name]["by_dtype"] for name in ("train", "resume", "evaluation", "serve")
            },
            "bf16_rows": [{k: r[k] for k in keep if k in r} for r in gru_bf16["rows"]],
            "bf16_max_abs_err": gru_bf16["max_abs_err"],
            "train_rows": [{k: r[k] for k in keep} for r in train_rows],
            "max_abs_err": gru["max_abs_err"],
            "ms": main_row["ms"],
            "kernel_ms": main_row["ms"],
            "plain_ms": main_row["plain_ms"],
            "bound_ms": main_row["bound_ms"],
            "bound_by": main_row["bound_by"],
            "library_ms": main_row["library_ms"],
            "kernel_over_bound": main_row["kernel_over_bound"],
            "launches_per_call": main_row["launches_per_call"],
            "call_ms": main_row["call_ms"],
            "plain_call_ms": main_row["plain_call_ms"],
        }
    ]
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(
                {"card": card, "torch": torch.__version__, "gru": gru, "serve": path["summary"],
                 "serve_hbm": {k: path[k] for k in ("hbm_peak_bytes", "hbm_held_before")},
                 "launches": path["launches"], "serve_parity": parity, "serve_profile": profile,
                 "train": train, "train_parity": train_parity, "train_timing": train_timing,
                 "gru_bf16": gru_bf16, "bf16": bf16, "serving_planes": planes,
                 "ppo": ppo, "a2c": a2c, "sac": sac, "droq": droq, "kernels": kernels},
                f, indent=2,
            )
    print(json.dumps({"kernels": kernels}))
    print(card_line())
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

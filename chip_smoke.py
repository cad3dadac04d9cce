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
   counts over its device time);
4. the serving path: compose ``exp=dreamer_v3 env=dummy`` at the S preset
   (full width), build the agent on the card from the seed, write a
   checkpoint and its config.yaml into a temporary run dir, and serve it
   through ``serve_main`` with 4 slots and 4 concurrent env sessions of 512
   steps; the kernels' launch counts are zeroed just before and read just
   after, and every kernel must have been launched at least once per tick.
   Then the batched serve step on the card is held against the same step on
   the CPU (the plain path) on the same weights, observations and noise;
5. the training path (the slice's main path) through the entry points:
   ``run`` trains DV3 S at full width (``env=dummy``, 4 envs, batch 16 x 64,
   horizon 15) for a few gradient steps and writes a checkpoint, ``run``
   resumes from it for a few more, ``evaluation`` plays a test episode of
   it; the launch counts are zeroed just before each and read just after,
   and each gradient step must have launched the LN-GRU kernel 64 + 15 times
   besides one launch per batched policy step. Then one gradient step on the
   card against the same step on the CPU (TF32 off, T=16, B=4), and the
   seconds per gradient step at 16 x 64, eager;
6. PPO (``exp=ppo``, CartPole-v1 at the exp's settings: 4 envs x 128 steps,
   minibatches of 64, 10 epochs, width 64) through the entry points on the
   card: 65536 policy steps with the metric log and the test episode (its
   reward must reach 100), a resume into version_1 for two more iterations,
   an evaluation; the event file must hold the losses, the episode reward
   and ``Time/sps_*``. A short ``exp=a2c`` run (finite losses, a
   checkpoint). Then one PPO train phase on the card vs the CPU (TF32 off)
   and three A2C RMSprop steps likewise, the seconds per PPO train phase and
   the ms of one host acting step;
7. the profiles, under torch.profiler and only now (once it has run, later
   eager launches cost more host time): each phase-3 shape's device time by
   kernel name, with its kernel launches per call counted in a captured CUDA
   graph; serving ticks (device time by kernel, the LN-GRU kernel's launches
   by name, busy share); a training step (the same, and its kernel count); a PPO train phase
   (busy share, device operations);
8. print the ``kernels`` JSON line, the card line, and the final result line.

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


def gru_bytes(B: int, K: int, H: int) -> int:
    """Bytes one step must move: each input read once, the output written once."""
    n = 3 * H
    return 4 * (B * K + B * H + K * n + 3 * n + B * H)


def gru_bound(B: int, K: int, H: int) -> tuple:
    n = 3 * H
    flops = 2 * B * K * n + 12 * B * n
    t_bytes = gru_bytes(B, K, H) / PEAK_BYTES_PER_S
    t_ops = flops / PEAK_F32_FLOPS
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
        # no float atomics and fixed summation orders: a second call on the
        # same inputs gives the same bits
        again = ln_gru_step(inp, hx, w, b, scale, bias)
        torch.cuda.synchronize()
        row["bitwise_equal"] = bool(torch.equal(out, again))
        if not row["bitwise_equal"]:
            raise AssertionError(f"LN-GRU kernel at {preset} B={B}: two calls on the same inputs differ")
        if (preset, B, K, H) in GRAD_SHAPES:
            args = [t.clone().requires_grad_(True) for t in (inp, hx, w, b, scale, bias)]
            g_out = torch.randn(B, H, device=device, generator=torch.Generator(device).manual_seed(0))
            grads_k = torch.autograd.grad(ln_gru_step(*args), args, g_out)
            grads_p = torch.autograd.grad(ln_gru_step_plain(*args), args, g_out)
            gerr = max(float((a - p).abs().max()) for a, p in zip(grads_k, grads_p))
            if gerr > GRU_ATOL:
                raise AssertionError(f"LN-GRU gradient vs plain at {preset} B={B}: max abs err {gerr}")
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
        row["kernel_over_bound"] = row["ms"] / row["bound_ms"]
        row["achieved_GBps"] = gru_bytes(B, K, H) / (row["ms"] * 1e-3) / 1e9
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
        inp, hx, w, b, scale, bias = gru_case(row["B"], row["K"], row["H"], seed=row["B"] + row["K"], device=device)
        row["launches_per_call"] = graph_kernel_launches(lambda: ln_gru_step(inp, hx, w, b, scale, bias))
        row["device_ms_by_kernel"] = device_ms_by_kernel(
            lambda wi: ln_gru_step(inp, hx, wi, b, scale, bias), [w, w.clone()]
        )
        print(f"[chip-smoke] ln_gru profile {row['preset']} B={row['B']}: {row['launches_per_call']} launches "
              f"per call, device ms {json.dumps(row['device_ms_by_kernel'])}", flush=True)


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
    for spec in KERNELS:
        spec.launches = 0
    first = run(overrides + [f"algo.total_steps={TRAIN_ENVS * FIRST_ITERS}"])
    out["train"] = {"summary": first, "launches": {spec.name: spec.launches for spec in KERNELS}}
    _check_train_run("first run", first, LN_GRU.launches)
    scalars = check_scalars("DV3 first run", first["log_dir"], DV3_TAGS)
    out["train"]["scalars"] = {t: scalars[t][-1] for t in DV3_TAGS}
    listed = open(first["checkpoint"] + ".memmap").read().split()
    if not (listed and all(os.path.isfile(f) for f in listed)):
        raise AssertionError(f"the first run's checkpoint lists memmap files that are not there: {listed}")
    if first["gradient_steps"] < 4:
        raise AssertionError(f"the first run took {first['gradient_steps']} gradient steps, fewer than 4")
    for spec in KERNELS:
        spec.launches = 0
    resumed = run(overrides + [f"algo.total_steps={TRAIN_ENVS * RESUME_ITERS}",
                               f"checkpoint.resume_from={first['checkpoint']}"])
    out["resume"] = {"summary": resumed, "launches": {spec.name: spec.launches for spec in KERNELS}}
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
    for spec in KERNELS:
        spec.launches = 0
    reward = evaluation([f"checkpoint_path={resumed['checkpoint']}"])
    out["evaluation"] = {"reward": reward, "launches": {spec.name: spec.launches for spec in KERNELS}}
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


def _s_trainers(devices, T: int, B: int, seed: int = 0):
    """DV3 S trainers (the same weights from a seed) on each device, TF32 off,
    and one random batch of [T, B] rows on the CPU."""
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
        fabric = Fabric(accelerator=accel, float32_matmul_precision="highest")
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


def train_step_parity(steps: int = 2) -> dict:
    """Two gradient steps on the card vs on the CPU at DV3 S width (T=16,
    B=4): the same weights, batches and noise. Every loss and gradient norm of
    each step (the second one's are taken at the weights the first update
    left), then the parameters, the target critic and Moments after the last
    one: what the card's Adam, clipping, target EMA and Moments did."""
    T, B = 16, 4
    trainers, batch = _s_trainers(("gpu", "cpu"), T, B)
    lr = max(group["lr"] for opt in trainers["cpu"].optimizers.values() for group in opt.param_groups)
    worst, per_step = 0.0, []
    for step in range(steps):
        noise = trainers["cpu"].draw_noise(T, B, torch.Generator().manual_seed(1 + step))
        metrics = {}
        for accel, trainer in trainers.items():
            dev = trainer.device
            out = trainer.train_step({k: v.to(dev) for k, v in batch.items()}, step,
                                     {k: v.to(dev) for k, v in noise.items()})
            metrics[accel] = {k: float(v) for k, v in out.items()}
        gap = max(abs(metrics["gpu"][k] - v) / max(abs(v), 1e-3) for k, v in metrics["cpu"].items())
        if not all(math.isfinite(v) for v in metrics["gpu"].values()):
            raise AssertionError(f"train step {step} on the card: non-finite metrics {metrics['gpu']}")
        worst = max(worst, gap)
        per_step.append({"worst_rel_err": gap, "card": metrics["gpu"], "cpu": metrics["cpu"]})
    state = _state_gap(trainers["gpu"], trainers["cpu"])
    print(f"[chip-smoke] train steps card vs CPU (T={T}, B={B}, {steps} steps): worst relative err of the "
          f"metrics {worst} (bar {TRAIN_STEP_RTOL}); state after the last step {json.dumps(state)} (bars: every "
          f"parameter within {steps} x 2 lr = {steps * 2 * lr:.1e}, a share >= {TRAIN_PARAM_SHARE} within "
          f"{TRAIN_PARAM_ATOL}, Moments within {TRAIN_STEP_RTOL}); steps {json.dumps(per_step)}", flush=True)
    if worst > TRAIN_STEP_RTOL:
        raise AssertionError(f"train steps on the card disagree with the CPU: worst relative err {worst}")
    if not (state["param_max_abs_gap"] <= steps * 2 * lr and state["param_share_within_atol"] >= TRAIN_PARAM_SHARE
            and state["moments_rel_gap"] <= TRAIN_STEP_RTOL):
        raise AssertionError(f"the card's updates disagree with the CPU's: {state}")
    return {"worst_rel_err": worst, "state": state, "steps": per_step, "T": T, "B": B}


def time_train_steps(steps: int = 5) -> tuple:
    """Seconds per gradient step of DV3 S at the preset's batch (16 x 64), eager,
    with TF32 as the config's float32 matmul precision sets it. Returns the
    timing and the warm trainer with its batch, for the profile."""
    from sheeprl_tpu_torch.parallel.fabric import apply_matmul_precision

    T, B = 64, 16
    trainers, batch = _s_trainers(("gpu",), T, B, seed=2)
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
    out = {"T": T, "B": B, "steps": steps, "seconds_per_gradient_step": (time.perf_counter() - t0) / steps}
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
    print(f"[chip-smoke] train step profile: {json.dumps(out)}", flush=True)
    return out


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


def _zero_launches() -> None:
    for spec in KERNELS:
        spec.launches = 0


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
    out["train"] = {"summary": first, "launches": {spec.name: spec.launches for spec in KERNELS}}
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
    out["resume"] = {"summary": resumed, "launches": {spec.name: spec.launches for spec in KERNELS}}
    print(f"[chip-smoke] PPO resumed run: {resumed['train_phases']} train phases into {resumed['log_dir']}, "
          f"losses {json.dumps(resumed['metrics'])}", flush=True)
    if not (resumed["log_dir"].endswith("version_1") and resumed["train_phases"] == PPO_RESUME_ITERS):
        raise AssertionError(f"PPO resume: {resumed['train_phases']} phases into {resumed['log_dir']}")
    if not all(math.isfinite(v) for v in resumed["metrics"].values()):
        raise AssertionError(f"PPO resume: non-finite losses {resumed['metrics']}")
    _zero_launches()
    reward = evaluation([f"checkpoint_path={resumed['checkpoint']}"])
    out["evaluation"] = {"reward": reward, "launches": {spec.name: spec.launches for spec in KERNELS}}
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
    launches = {spec.name: spec.launches for spec in KERNELS}
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
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as tmp:
        path = main_path(tmp)
        parity = serve_step_parity(path["ckpt"])
        train = train_path(tmp)
        train_parity = train_step_parity()
        train_timing, warm = time_train_steps()
        ppo = ppo_path(tmp)
        a2c = a2c_path(tmp)
        ppo["parity"] = ppo_train_phase_parity()
        a2c["rmsprop_parity"] = a2c_rmsprop_parity()
        ppo["timing"], ppo_warm = time_ppo()
        profile_gru(gru["rows"], device)
        profile = profile_ticks(path["ckpt"])
        train_timing["profile"] = profile_train_steps(warm)
        ppo["timing"]["profile"] = profile_ppo_train_phase(ppo_warm)
        del warm, ppo_warm

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
                **{f"ppo_{name}": ppo[name]["launches"][LN_GRU.name] for name in ("train", "resume", "evaluation")},
                "a2c": a2c["launches"][LN_GRU.name],
            },
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
                 "launches": path["launches"], "serve_parity": parity, "serve_profile": profile,
                 "train": train, "train_parity": train_parity, "train_timing": train_timing,
                 "ppo": ppo, "a2c": a2c, "kernels": kernels},
                f, indent=2,
            )
    print(json.dumps({"kernels": kernels}))
    print(card_line())
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

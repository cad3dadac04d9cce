"""Chip smoke of the PyTorch port (sheeprl_tpu_torch) on one CUDA card.

Run from the root of a checkout:  python3 chip_smoke.py [--out results.json]

Phases, in order; any failure exits non-zero and prints no result line.
Phases 6-7b and their profiles reach no kernel and share nothing with the
Dreamer phases: once phase 3's timings are done, a child of this script
(``--model-free-out``) runs them on the same card beside phases 4-7d, so
their times are measured beside that work. This process waits for the child
before phase 8's kernel profiles and fails when the child fails (its log's
tail printed) or outlives ``MODEL_FREE_TIMEOUT_S``.

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
5c. the rest of the Dreamer-V3 family at ``bf16-mixed``: Plan2Explore at the
   DOA++ exps' widths (dense 768, 4 layers, recurrent 1024, CNN x48, 8
   ensemble members, batch 4 x 64, 16 envs; ``env=dummy``) explores for 32
   gradient steps through ``run``, resumes, evaluates, and finetunes from its
   checkpoint: the exploration actor acts until learning starts, the task
   actor after; Offline Dreamer at its S preset trains, resumes and evaluates.
   Every LN-GRU launch of each run is accounted for, all bf16: 94 a P2E
   gradient step (the scan and two imaginations) or 79 (finetuning, ODV3),
   plus one a policy step of the loop and of its test episode. Then one P2E
   and one ODV3 gradient step card vs CPU in float32 (TF32 off, T=16, B=4;
   ``train_step_parity``'s float32 bars, the actors' metrics within 1e-2),
   and the seconds per P2E gradient step at 4 x 64;
5d. Dreamer-V2 and Dreamer-V1 in float32 at their exps' widths
   (``env=dummy``, 4 envs): ``exp=dreamer_v2`` (dense 400 x 4 layers,
   recurrent 600, CNN x48, 32 x 32 discrete latents, batch 16 x 50, horizon
   15) trains for at least 16 gradient steps through ``run``, resumes for at
   least 4, evaluates, and its checkpoint is served through ``serve_main``
   (4 slots, 4 sessions of 512 steps); every LN-GRU launch is accounted for,
   all float32: 65 a gradient step (50 scan steps, 15 imagined) plus one a
   policy step of the loop and of its test episode, one a serving tick.
   ``exp=dreamer_v1`` (dense 400, recurrent 200, CNN x32, batch 50 x 50) on
   ``env.id=continuous_dummy`` (the TruncatedNormal actor) the same, with no
   LN-GRU launch at all (its cell has no LayerNorm). Then one DV2 and one DV1
   gradient step card vs CPU in float32 (TF32 off, T=16, B=4) within
   ``train_step_parity``'s float32 bars, and the seconds per DV2 gradient
   step at 16 x 50 and per DV1 step at 50 x 50;
5e. Plan2Explore on Dreamer-V2 and V1, and SAC-AE, in float32 at their exps'
   widths (4 envs): ``exp=p2e_dv2_exploration`` (dense 400 x 4, recurrent
   400, CNN x48, 32 x 32 latents, 10 members, batch 16 x 50, horizon 15)
   explores for at least 8 gradient steps through ``run``, resumes for at
   least 2, evaluates, and finetunes from its checkpoint (the exploration
   actor acts until learning starts, the task actor after; the finetuning
   checkpoint holds Dreamer-V2's layout), which evaluates; every LN-GRU launch
   is accounted for, all float32: 80 an exploration step (the scan and two
   rollouts), 65 a finetuning step, plus one a policy step of the loop and of
   its test episode. ``exp=p2e_dv1_exploration`` (dense 400, recurrent 400,
   stochastic 60, batch 50 x 50) on ``env.id=continuous_dummy`` the same,
   with no LN-GRU launch. ``exp=sac_ae`` (512-channel convolutions on 3
   stacked 64 x 64 frames, features 64, hidden 1024, batch 128) trains for at
   least 16 gradient steps, resumes and evaluates; its metric log holds the
   reconstruction loss; no LN-GRU launch. Then one P2E-DV2 and one P2E-DV1
   gradient step card vs CPU (T=16, B=4) and one SAC-AE step (B=2) within
   ``train_step_parity``'s float32 bars, the new actors' included, and the
   seconds per gradient step of each at its exp's batch;
6. PPO (``exp=ppo``, CartPole-v1 at the exp's settings: 4 envs x 128 steps,
   minibatches of 64, 10 epochs, width 64) through the entry points on the
   card: 32768 policy steps with the metric log and the test episode (its
   reward must reach 100), a resume into version_1 for two more iterations,
   an evaluation; the event file must hold the losses, the episode reward
   and ``Time/sps_*``. A short ``exp=a2c`` run (finite losses, a
   checkpoint). Then one PPO train phase on the card vs the CPU (TF32 off)
   and three A2C RMSprop steps likewise, the seconds per PPO train phase and
   the ms of one host acting step. The PPO checkpoint is served through
   ``serve_main`` (4 slots, 4 sessions) and its greedy step held card vs CPU
   (logits within 1e-5, equal actions);
6b. recurrent PPO (``exp=ppo_recurrent``, CartPole-v1 at the exp's widths:
   encoder, heads and LSTM 64, LayerNorm on) through the entry points on the
   card, on the JAX package's learning test's schedule (4 envs x 128 steps,
   sequences of 16, 4 minibatches, 4 epochs, 24,576 policy steps) with its
   bar (a greedy test reward of 120), a resume into version_1 for one more
   iteration, an evaluation, and the checkpoint served through ``serve_main``
   (4 slots, 4 sessions). Then one train phase at the exp's own shape (16 envs
   x 512 steps, sequences of 16, 8 minibatches, 8 epochs) on the card vs the
   CPU (TF32 off, PPO's bars) and 4 greedy serve ticks likewise (the LSTM
   state within 1e-5, equal actions), the seconds per train phase and the ms
   of one host acting step for 16 envs;
6c. the on-policy Anakin topology (envs on the card): ``exp=ppo_anakin``
   (CartPole-v1, 64 envs x 128 steps, minibatches of 2048, 4 epochs, width
   64) through the entry points for the exp's 1,048,576 policy steps with the
   metric log and the test episode (its reward must reach 100), a resume into
   version_1 for two more iterations, an evaluation, and the checkpoint
   served through ``serve_main`` (4 slots, 4 sessions); ``exp=a2c_anakin``
   for 200 iterations, a resume and an evaluation; no LN-GRU launch in any of
   them. Then, card vs CPU with TF32 off: (a) 128 steps of 64 CartPole and
   64 Pendulum envs, each from the CPU's state (within 1e-5, flags equal);
   (b) one PPO and one A2C train phase from the same trajectory and round
   keys (PPO's bars); (c) one whole iteration at the exp's shape, reporting
   where the trajectories part (a finding). The host syncs of one iteration
   by part (none in the rollout's step loop); one step of each flavor with
   ``xla_deterministic_ops`` on; env steps/s at ``exp=ppo_anakin`` and at
   ``exp=ppo_anakin_benchmarks``' 8192 envs x 128 steps, with the
   rollout/train split;
7. SAC (``exp=sac env.id=Pendulum-v1``, the exp's widths, batch and replay
   ratio, 4 envs) through the entry points on the card: 6,000 policy steps
   with the metric log and the test episode (its reward must reach -400), a
   resume into version_1, an evaluation; the checkpoint served through
   ``serve_main`` (4 slots, 4 sessions) and the batched greedy step held
   against the CPU's. A short ``exp=droq`` run (finite losses, a checkpoint,
   an evaluation). Then one SAC and one DroQ train phase on the card vs the
   CPU (TF32 off), the seconds per SAC gradient step and per DroQ train
   phase (G = 20) and the ms of one host acting step;
7b. the off-policy Anakin topology (envs and replay ring on the card):
   ``exp=sac_anakin`` (Pendulum-v1, 64 envs x 64 steps, hidden 256, batch
   256, G = 256 gradient steps an iteration, a ring of 4096 rows x 64 envs)
   through the entry points for 98,304 policy steps with the metric log and
   the test episode (its reward must reach -400), the checkpoint's ring twin
   at the iterations' cursor, a resume into version_1 for two more
   iterations; no LN-GRU launch. The host syncs of one iteration by part (0
   in the rollout, the ring write, the ring sample and the G steps). Card vs
   CPU with TF32 off: (a) the ring's write and sample at the exp's shape
   (65,536 draws of 262,144 slots), bitwise; (b) one iteration at 16 envs x
   16 steps, G = 4 (SAC's train-phase bars); (c) one at the exp's shape (a
   finding). One iteration with ``xla_deterministic_ops`` on; seconds per
   iteration and env steps/s at ``exp=sac_anakin`` and at
   ``exp=sac_anakin_benchmarks`` (512 envs x 64 steps, G = 8), with the
   rollout/ring/train split;
7c. the decoupled topology in one process (the player loop in the main
   thread, the learner in its own, two depth-1 queues): ``exp=dreamer_v3_decoupled``
   at S (4 envs, batch 16 x 64, 80 prefill iterations, then 4 training
   iterations of 4 gradient steps) through ``run``, its checkpoint due during
   the prefill deferred to the first round; ``exp=dreamer_v3`` at the same
   config beside it (the LN-GRU launches of both, exactly 79 a gradient step
   plus one a policy step, and their parameters after the same rounds); a
   resume into version_1 and an evaluation. ``exp=ppo_decoupled`` (CartPole-v1,
   32,768 steps, the test reward over phase 6's 100) and ``exp=sac_decoupled``
   (Pendulum-v1, 6,000 steps, the test reward over phase 7's -400) at their
   exps' widths: train, resume, evaluate,
   no LN-GRU launch. One learner round
   of each, driven through its thread, card vs CPU with TF32 off at the
   coupled families' bars; the seconds a round takes at each exp's shape and
   the share of it spent in the handoff copy;
7d. the decoupled topology as two processes: each of ``exp=dreamer_v3_decoupled``
   (phase 7c's S config), ``exp=ppo_decoupled`` (CartPole-v1, 4 rounds) and
   ``exp=sac_decoupled`` (Pendulum-v1, 300 steps) launched through
   ``python -m sheeprl_tpu_torch`` as a player (rank 0, which opens the
   store on a free port) and a learner (rank 1) on the card, beside its
   thread mode at the same config in this process, both with
   ``xla_deterministic_ops`` on (the three two-process runs start together,
   and this process runs the thread modes beside them): every checkpoint bitwise
   equal; DV3's LN-GRU launches, player plus learner, equal to the thread
   run's and to 79 a gradient step plus one a policy step; the seconds a
   round takes as the player sees it, the learner's share and the handoff's
   (host copies, pickling and the store, both ways);
8. the profiles, under torch.profiler tracing the card only (host events
   would multiply the traces' processing and slow the profiled steps) and
   only now (once it has run, later eager launches cost more host time): each phase-3 shape's device time by
   kernel name, with its kernel launches per call counted in a captured CUDA
   graph; serving ticks (device time by kernel, the LN-GRU kernel's launches
   by name, busy share); a training step in float32 and one in bf16 (the
   same, and its kernel count); a P2E step at the DOA++ widths in bf16; a
   DV2 step at 16 x 50 and a DV1 step at 50 x 50 in float32; a P2E-DV2
   step at 16 x 50, a P2E-DV1 step at 50 x 50 and a SAC-AE train phase of 4
   steps at batch 128; a PPO, a recurrent PPO and a SAC train phase and an
   Anakin iteration at both timed widths (busy share, device operations); a
   SAC Anakin iteration at both timed widths, whole and by part (these last
   five at the end of the child's phases);
9. print the ``kernels`` JSON line, the card line, and the final result line.

The training phase launches with the config's defaults for video capture
(warned and skipped), the metric log (its event file must hold the losses,
``Params/replay_ratio`` and ``Time/sps_*``) and the replay buffer (memmap
files in the run's directory, carried by the checkpoints: the resumed run
must read them and add rows).

Phase 3 also covers the training shapes of the kernel: B = 16 (the posterior
scan) and B = 1024 (imagination's 16 x 64 rows), forward and gradient, and
the DOA++ cell (K = 1792, 3H = 3072) at B = 4 (P2E's scan), 16 (its player)
and 256 (its imagination's 4 x 64 rows), and the DV2 cell (K = 400 + 600 =
1000, 3H = 1800: the first that is not a whole number of the kernel's tiles,
19 column groups the last of 24 columns, a last K stage of 8 rows) at B = 4
(the player, serving), 16 (the posterior scan) and 800 (imagination's 16 x
50 rows), and the P2E-DV2 cell (K = 400 + 400 = 800, 3H = 1200: a 13th
column group of 16 columns, a finish launch's 4th block of 16 of 128
columns, 25 whole K stages) at the same three batches.
"""

from __future__ import annotations

import argparse
import copy
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
    # Plan2Explore at the DOA++ exps' widths (K = 768 + 1024): the posterior
    # scan's batch, the player's 16 envs, imagination's 4 x 64 rows
    ("DOA", 4, 1792, 1024),
    ("DOA", 16, 1792, 1024),
    ("DOA", 256, 1792, 1024),
    # Dreamer-V2 at its exp's widths (K = 400 + 600): the player's and serving's
    # 4 envs or slots, the posterior scan's batch, imagination's 16 x 50 rows
    ("DV2", 4, 1000, 600),
    ("DV2", 16, 1000, 600),
    ("DV2", 800, 1000, 600),
    # Plan2Explore on Dreamer-V2 at its exp's widths (K = 400 + 400): the
    # player's 4 envs, the posterior scan's batch, imagination's 16 x 50 rows
    ("P2E-DV2", 4, 800, 400),
    ("P2E-DV2", 16, 800, 400),
    ("P2E-DV2", 800, 800, 400),
]
MAIN_SHAPE = ("S", 4, 1024, 512)  # serving: 4 slots at the S preset
# training: the posterior scan's batch, then imagination's rows
TRAIN_SHAPES = [("S", 16, 1024, 512), ("S", 1024, 1024, 512)]
P2E_SHAPES = [("DOA", 4, 1792, 1024), ("DOA", 16, 1792, 1024), ("DOA", 256, 1792, 1024)]
DV2_SHAPES = [("DV2", 4, 1000, 600), ("DV2", 16, 1000, 600), ("DV2", 800, 1000, 600)]
P2E_DV2_SHAPES = [("P2E-DV2", 4, 800, 400), ("P2E-DV2", 16, 800, 400), ("P2E-DV2", 800, 800, 400)]
GRAD_SHAPES = [MAIN_SHAPE, *TRAIN_SHAPES, *P2E_SHAPES, *DV2_SHAPES, *P2E_DV2_SHAPES]

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

    with profile(activities=[ProfilerActivity.CUDA],
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
    return trainers, _random_batch(T, B, seed)


def _random_batch(T: int, B: int, seed: int, continuous: bool = False) -> dict:
    """A [T, B] replay batch of the dummy env's rgb and state keys on the CPU,
    a twentieth of the rows terminal; one-hot actions of 2 choices, or 2
    continuous ones in [-1, 1]."""
    rng = np.random.default_rng(seed)
    terminated = (rng.uniform(size=(T, B, 1)) < 0.05).astype(np.float32)
    actions = rng.uniform(-1, 1, (T, B, 2)) if continuous else np.eye(2)[rng.integers(0, 2, (T, B))]
    batch = {
        "rgb": rng.integers(0, 256, (T, B, 3, 64, 64)).astype(np.uint8),
        "state": rng.standard_normal((T, B, 10)).astype(np.float32),
        "actions": actions.astype(np.float32),
        "rewards": rng.standard_normal((T, B, 1)).astype(np.float32),
        "terminated": terminated,
        "truncated": np.zeros((T, B, 1), np.float32),
        "is_first": np.concatenate([np.zeros((1, B, 1), np.float32), terminated[:-1]]),
    }
    return {k: torch.from_numpy(v) for k, v in batch.items()}


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
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
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


# -- Plan2Explore and Offline Dreamer (the rest of the Dreamer-V3 family) -----------
# P2E at the DOA++ exps' model (p2e_dv3_expl_L_doapp_128px_gray_combo_discrete_
# 15Mexpl_20Mstps.yaml:33-48): every width as the exp sets it, its batch
# (4 x 64), envs (16), ensembles (8) and precision; the dummy env and the
# steps are cut. K = 768 + 1024 = 1792 and 3H = 3072 at the recurrent cell.
P2E_DOA = [
    "algo.dense_units=768",
    "algo.mlp_layers=4",
    "algo.world_model.encoder.cnn_channels_multiplier=48",
    "algo.world_model.recurrent_model.recurrent_state_size=1024",
    "algo.world_model.transition_model.hidden_size=768",
    "algo.world_model.representation_model.hidden_size=768",
    "algo.ensembles.n=8",
]
P2E_ENVS = 16
P2E_PRECISION = "bf16-mixed"
# every env holds 65 rows before learning starts (a 64-step sequence fits);
# then each iteration of 16 policy steps takes 16 gradient steps (replay
# ratio 1): the first run trains in 2 iterations (32 steps); a resumed run
# waits the 65 iterations again, its restored governor skips the first
# training iteration and the next takes 16 steps; finetuning acts with the
# exploration actor for 65 iterations, then with the task actor
P2E_LEARNING_STARTS_ITERS = 65
P2E_FIRST_ITERS = P2E_LEARNING_STARTS_ITERS + 1
P2E_RESUME_ITERS = P2E_FIRST_ITERS + P2E_LEARNING_STARTS_ITERS + 2
P2E_MIN_GRADIENT_STEPS = 20
# the posterior scan over 64 steps, then two 15-step imaginations (the
# exploration actor's and the task actor's)
P2E_GRU_CALLS_PER_GRAD_STEP = 64 + 15 + 15
P2E_TAGS = ("Loss/world_model_loss", "Loss/ensemble_loss", "Loss/policy_loss_exploration", "Loss/policy_loss_task",
            "Rewards/intrinsic_intrinsic", "Time/sps_train")
# Offline Dreamer at its walker exp's preset (offline_dreamer_S), bf16-mixed,
# with the DV3 bf16 phase's steps: 80 iterations of 4 envs before learning
# starts, then 4 training iterations of 4 gradient steps
# one float32 step card vs CPU (family_step_parity): the actors' losses and
# gradient norms take FAMILY_ACTOR_RTOL, every other metric TRAIN_STEP_RTOL.
# P2E's task actor's gradient norm at the DOA++ widths is ~1.5e-3, a sum of
# REINFORCE terms that largely cancel, and it moved 1.7e-3 relative between
# runs of the same step on one NVIDIA H100 80GB HBM3 at 700 W (of 6 runs from
# the same inputs: 3 at ~7e-5 from the CPU, 1 at 1.79e-3, both runs with
# deterministic algorithms at 1.80e-3), so no bar under 2e-3 holds it against
# the CPU; every other metric stayed within 2e-4
FAMILY_ACTOR_RTOL = 1e-2
FAMILY_ACTOR_METRICS = ("Loss/policy_loss", "Grads/actor")
ODV3_ENVS = 4
ODV3_LEARNING_STARTS_ITERS = 80
ODV3_FIRST_ITERS = ODV3_LEARNING_STARTS_ITERS + 4
ODV3_RESUME_ITERS = ODV3_FIRST_ITERS + ODV3_LEARNING_STARTS_ITERS + 4


def p2e_overrides(run_dir: str = "", exp: str = "p2e_dv3_exploration") -> list:
    return [
        f"exp={exp}",
        "env=dummy",
        "algo.cnn_keys.encoder=[rgb]",
        "algo.mlp_keys.encoder=[state]",
        *P2E_DOA,
        f"env.num_envs={P2E_ENVS}",
        "algo.per_rank_batch_size=4",
        "algo.per_rank_sequence_length=64",
        f"algo.learning_starts={P2E_ENVS * P2E_LEARNING_STARTS_ITERS}",
        f"fabric.precision={P2E_PRECISION}",
        *([f"hydra.run.dir={run_dir}"] if run_dir else []),
    ]


def odv3_overrides(run_dir: str = "") -> list:
    return [
        "exp=offline_dreamer",
        "env=dummy",
        "algo.cnn_keys.encoder=[rgb]",
        "algo.mlp_keys.encoder=[state]",
        f"env.num_envs={ODV3_ENVS}",
        f"algo.learning_starts={ODV3_ENVS * ODV3_LEARNING_STARTS_ITERS}",
        f"fabric.precision={BF16_PRECISION}",
        *([f"hydra.run.dir={run_dir}"] if run_dir else []),
    ]


def _check_family_run(name: str, summary: dict, calls_per_step: int) -> dict:
    """Every LN-GRU launch of a run accounted for, all with bf16 operands:
    ``calls_per_step`` a gradient step, one a batched policy step of the loop
    and one a step of its test episode."""
    need = calls_per_step * summary["gradient_steps"] + summary["player_calls"] + summary["test_player_calls"]
    by_dtype = _bf16_launches(name, need)
    print(f"[chip-smoke] {name}: {summary['gradient_steps']} gradient steps, {summary['player_calls']} player calls "
          f"(+{summary['test_player_calls']} in the test episode), {summary['policy_steps']} policy steps in "
          f"{summary['wall_seconds']:.2f}s (train {summary['train_seconds']:.2f}s); LN-GRU launches {LN_GRU.launches} "
          f"(need == {need}: {calls_per_step} a gradient step + one a policy step); metrics "
          f"{json.dumps(summary['metrics'])}", flush=True)
    if summary["gradient_steps"] < 1 or LN_GRU.launches != need:
        raise AssertionError(f"{name}: {summary['gradient_steps']} gradient steps, {LN_GRU.launches} LN-GRU "
                             f"launches != {need}")
    if not all(math.isfinite(v) for v in summary["metrics"].values()):
        raise AssertionError(f"{name}: non-finite metrics {summary['metrics']}")
    return {"summary": summary, "launches": _launches(), "by_dtype": by_dtype, "need": need}


def _evaluate_family(name: str, ckpt: str) -> dict:
    from sheeprl_tpu_torch.cli import evaluation

    _zero_launches()
    reward = evaluation([f"checkpoint_path={ckpt}"])
    by_dtype = _bf16_launches(f"{name} evaluation", 1)
    print(f"[chip-smoke] {name} evaluation: reward {reward}", flush=True)
    if not math.isfinite(reward):
        raise AssertionError(f"{name} evaluation: reward {reward}")
    return {"reward": reward, "launches": _launches(), "by_dtype": by_dtype}


def p2e_path(out_dir: str) -> dict:
    """Plan2Explore through the entry points at the DOA++ widths and bf16:
    exploration (>= 20 gradient steps), a resume from its checkpoint,
    finetuning from it (the exploration actor acts until learning starts,
    the task actor after), and an evaluation of each. The launch counts are
    zeroed just before each run and read just after."""
    from sheeprl_tpu_torch.cli import run

    out = {}
    expl = p2e_overrides(os.path.join(out_dir, "p2e"))
    _zero_launches()
    first = run(expl + [f"algo.total_steps={P2E_ENVS * P2E_FIRST_ITERS}"])
    out["train"] = _check_family_run("P2E exploration", first, P2E_GRU_CALLS_PER_GRAD_STEP)
    if first["gradient_steps"] < P2E_MIN_GRADIENT_STEPS:
        raise AssertionError(f"P2E exploration took {first['gradient_steps']} gradient steps")
    scalars = check_scalars("P2E exploration", first["log_dir"], P2E_TAGS)
    out["train"]["scalars"] = {t: scalars[t][-1] for t in P2E_TAGS}
    _zero_launches()
    resumed = run(expl + [f"algo.total_steps={P2E_ENVS * P2E_RESUME_ITERS}",
                          f"checkpoint.resume_from={first['checkpoint']}"])
    out["resume"] = _check_family_run("P2E exploration resumed", resumed, P2E_GRU_CALLS_PER_GRAD_STEP)
    if not resumed["log_dir"].endswith("version_1"):
        raise AssertionError(f"the resumed P2E run wrote {resumed['log_dir']}, not the run's version_1")
    out["evaluation"] = _evaluate_family("P2E exploration", resumed["checkpoint"])

    _zero_launches()
    ft = run(p2e_overrides(os.path.join(out_dir, "p2e_ft"), "p2e_dv3_finetuning") + [
        f"algo.total_steps={P2E_ENVS * P2E_FIRST_ITERS}", f"checkpoint.exploration_ckpt_path={first['checkpoint']}"])
    out["finetune"] = _check_family_run("P2E finetuning", ft, GRU_CALLS_PER_GRAD_STEP)
    switch = ft["actor_switch"]
    print(f"[chip-smoke] P2E finetuning: the player switched to the task actor at iteration {switch['iteration']} "
          f"after {switch['player_calls_before']} calls with the exploration actor; {ft['player_calls']} calls in "
          f"all", flush=True)
    if switch != {"iteration": P2E_LEARNING_STARTS_ITERS, "player_calls_before": P2E_LEARNING_STARTS_ITERS} \
            or ft["player_calls"] <= switch["player_calls_before"]:
        raise AssertionError(f"P2E finetuning did not act with the exploration actor until learning started and "
                             f"with the task actor after: {switch}, {ft['player_calls']} calls")
    out["finetune_evaluation"] = _evaluate_family("P2E finetuning", ft["checkpoint"])
    out["seconds_per_gradient_step"] = first["train_seconds"] / first["gradient_steps"]
    out["finetune_seconds_per_gradient_step"] = ft["train_seconds"] / ft["gradient_steps"]
    print(f"[chip-smoke] P2E: {out['seconds_per_gradient_step']:.4f} s per exploration gradient step in the loop, "
          f"{out['finetune_seconds_per_gradient_step']:.4f} s per finetuning step", flush=True)
    return out


def odv3_path(out_dir: str) -> dict:
    """Offline Dreamer at S and bf16 through the entry points: train, resume,
    evaluate, every LN-GRU launch accounted for."""
    from sheeprl_tpu_torch.cli import run

    overrides = odv3_overrides(os.path.join(out_dir, "odv3"))
    out = {}
    _zero_launches()
    first = run(overrides + [f"algo.total_steps={ODV3_ENVS * ODV3_FIRST_ITERS}"])
    out["train"] = _check_family_run("ODV3", first, GRU_CALLS_PER_GRAD_STEP)
    if "Loss/concept_loss" not in first["metrics"]:
        raise AssertionError(f"ODV3 logged no concept loss: {first['metrics']}")
    _zero_launches()
    resumed = run(overrides + [f"algo.total_steps={ODV3_ENVS * ODV3_RESUME_ITERS}",
                               f"checkpoint.resume_from={first['checkpoint']}"])
    out["resume"] = _check_family_run("ODV3 resumed", resumed, GRU_CALLS_PER_GRAD_STEP)
    if not resumed["log_dir"].endswith("version_1"):
        raise AssertionError(f"the resumed ODV3 run wrote {resumed['log_dir']}, not the run's version_1")
    out["evaluation"] = _evaluate_family("ODV3", resumed["checkpoint"])
    out["seconds_per_gradient_step"] = first["train_seconds"] / first["gradient_steps"]
    return out


# -- Dreamer-V2 and Dreamer-V1 (phase 5d) ------------------------------------------
DV_ENVS = 4
# each env holds one 50-step sequence before the first gradient step: 56
# iterations of random actions (the exps' learning_starts of 1000 and 5000
# policy steps cut); per_rank_pretrain_steps stays the DV2 exp's 100, which
# Ratio caps at the 4 policy steps counted at learning start (0 gradient steps)
DV_LEARNING_STARTS_ITERS = 56
# after learning starts, 24 iterations: 19 DV2 gradient steps at replay ratio
# 0.2, 9 DV1 steps at 0.1. The resumed runs wait learning_starts again, then
# the governor restored from the checkpoint takes 5 (DV2) and 4 (DV1) steps
DV_FIRST_ITERS = DV_LEARNING_STARTS_ITERS + 24
DV_RESUME_EXTRA_ITERS = {"dreamer_v2": 8, "dreamer_v1": 12}
DV_MIN_GRADIENT_STEPS = {"dreamer_v2": (16, 4), "dreamer_v1": (8, 4)}
# the posterior scan over 50 steps, imagination over 15: DV2's cell only; DV1's
# has no LayerNorm and launches nothing
DV_GRU_CALLS_PER_GRAD_STEP = {"dreamer_v2": 50 + 15, "dreamer_v1": 0,
                              # Plan2Explore: the scan and two 15-step imaginations (the
                              # exploration actor's and the task actor's); finetuning
                              # trains with the backbone's step
                              "p2e_dv2_exploration": 50 + 15 + 15, "p2e_dv2_finetuning": 50 + 15,
                              "p2e_dv1_exploration": 0, "p2e_dv1_finetuning": 0}
DV_TAGS = ("Loss/world_model_loss", "Loss/policy_loss", "Loss/value_loss", "State/kl", "Time/sps_train")


def dv_overrides(algo: str, run_dir: str = "") -> list:
    """``exp=dreamer_v2`` or ``exp=dreamer_v1`` at the exp's widths, batch,
    sequence, horizon, replay ratio and buffer, on the dummy env (DV1 on the
    continuous one, for its TruncatedNormal actor), 4 envs, learning_starts
    cut."""
    return [
        f"exp={algo}",
        "env=dummy",
        *(["env.id=continuous_dummy"] if algo == "dreamer_v1" else []),
        f"env.num_envs={DV_ENVS}",
        f"algo.learning_starts={DV_ENVS * DV_LEARNING_STARTS_ITERS}",
        *([f"hydra.run.dir={run_dir}"] if run_dir else []),
    ]


def _f32_launches(name: str, need: int) -> dict:
    """The LN-GRU kernel's launches of a float32 run: exactly ``need``, all
    with float32 operands."""
    by_dtype = dict(LN_GRU.launches_by_dtype)
    print(f"[chip-smoke] {name}: LN-GRU launches {LN_GRU.launches} by dtype {by_dtype} (need == {need}, all "
          f"float32)", flush=True)
    if LN_GRU.launches != need or by_dtype.get("float32", 0) != need:
        raise AssertionError(f"{name}: LN-GRU launches {LN_GRU.launches} by dtype {by_dtype} != {need} float32")
    return by_dtype


def _check_dv_run(algo: str, name: str, summary: dict, min_steps: int) -> dict:
    calls = DV_GRU_CALLS_PER_GRAD_STEP[algo]
    need = calls * summary["gradient_steps"] + (summary["player_calls"] + summary["test_player_calls"] if calls else 0)
    print(f"[chip-smoke] {name}: {summary['gradient_steps']} gradient steps, {summary['player_calls']} player calls "
          f"(+{summary['test_player_calls']} in the test episode), {summary['policy_steps']} policy steps in "
          f"{summary['wall_seconds']:.2f}s (train {summary['train_seconds']:.2f}s); metrics "
          f"{json.dumps(summary['metrics'])}", flush=True)
    by_dtype = _f32_launches(name, need)
    if summary["gradient_steps"] < min_steps:
        raise AssertionError(f"{name}: {summary['gradient_steps']} gradient steps, fewer than {min_steps}")
    if not all(math.isfinite(v) for v in summary["metrics"].values()):
        raise AssertionError(f"{name}: non-finite metrics {summary['metrics']}")
    return {"summary": summary, "launches": _launches(), "by_dtype": by_dtype, "need": need}


def _evaluate_dv(algo: str, name: str, ckpt: str) -> dict:
    """``evaluation`` of a Dreamer-V1/V2-family checkpoint: a finite reward,
    the LN-GRU kernel launched (once a test step) where the cell has one."""
    from sheeprl_tpu_torch.cli import evaluation

    _zero_launches()
    reward = evaluation([f"checkpoint_path={ckpt}"])
    out = {"reward": reward, "launches": _launches(), "by_dtype": dict(LN_GRU.launches_by_dtype)}
    print(f"[chip-smoke] {name} evaluation: reward {reward}, LN-GRU launches {LN_GRU.launches}", flush=True)
    if not math.isfinite(reward) or (LN_GRU.launches < 1 if DV_GRU_CALLS_PER_GRAD_STEP[algo] else LN_GRU.launches):
        raise AssertionError(f"{name} evaluation: reward {reward}, {LN_GRU.launches} LN-GRU launches")
    return out


def dv_path(algo: str, out_dir: str) -> dict:
    """Dreamer-V2 or V1 through the entry points in float32: train, resume,
    evaluate, serve (4 slots, 4 sessions of 512 steps). The launch counts are
    zeroed just before each and read just after: DV2 launches the LN-GRU
    kernel 65 times a gradient step, once a policy step and once a serving
    tick, DV1 never."""
    from sheeprl_tpu_torch.cli import run
    from sheeprl_tpu_torch.serve.main import serve_main

    overrides = dv_overrides(algo, os.path.join(out_dir, algo))
    short = {"dreamer_v2": "DV2", "dreamer_v1": "DV1"}[algo]
    min_first, min_resumed = DV_MIN_GRADIENT_STEPS[algo]
    out = {}
    _zero_launches()
    first = run(overrides + [f"algo.total_steps={DV_ENVS * DV_FIRST_ITERS}"])
    out["train"] = _check_dv_run(algo, f"{short} first run", first, min_first)
    scalars = check_scalars(f"{short} first run", first["log_dir"], DV_TAGS)
    out["train"]["scalars"] = {t: scalars[t][-1] for t in DV_TAGS}
    resume_iters = DV_FIRST_ITERS + DV_LEARNING_STARTS_ITERS + DV_RESUME_EXTRA_ITERS[algo]
    _zero_launches()
    resumed = run(overrides + [f"algo.total_steps={DV_ENVS * resume_iters}",
                               f"checkpoint.resume_from={first['checkpoint']}"])
    out["resume"] = _check_dv_run(algo, f"{short} resumed run", resumed, min_resumed)
    if not resumed["log_dir"].endswith("version_1"):
        raise AssertionError(f"the resumed {short} run wrote {resumed['log_dir']}, not the run's version_1")
    out["evaluation"] = _evaluate_dv(algo, short, resumed["checkpoint"])
    log_dir = os.path.join(out_dir, f"{algo}_serve")
    _zero_launches()
    rc = serve_main([f"checkpoint_path={resumed['checkpoint']}", f"serve.slots={SLOTS}", f"serve.sessions={SESSIONS}",
                     f"serve.max_session_steps={MAX_SESSION_STEPS}", f"env.wrapper.n_steps={MAX_SESSION_STEPS}",
                     f"serve.log_dir={log_dir}"])
    with open(os.path.join(log_dir, "summary.json")) as f:
        summary = json.load(f)
    print(f"[chip-smoke] {short} serve rc={rc} summary={json.dumps(summary)}", flush=True)
    if rc != 0 or summary["sessions_completed"] != SESSIONS or summary["steps"] != SESSIONS * MAX_SESSION_STEPS:
        raise AssertionError(f"{short} serving did not complete every session: rc {rc}, {summary}")
    need = summary["ticks"] if DV_GRU_CALLS_PER_GRAD_STEP[algo] else 0
    out["serve"] = {"summary": summary, "by_dtype": _f32_launches(f"{short} serve", need), "launches": _launches(),
                    "need": need}
    out["seconds_per_gradient_step"] = first["train_seconds"] / first["gradient_steps"]
    print(f"[chip-smoke] {short}: {out['seconds_per_gradient_step']:.4f} s per gradient step in the loop", flush=True)
    return out


def _family_trainers(kind: str, devices, T: int, B: int, seed: int = 0, precision: str = "32-true"):
    """P2E (DOA++ widths), ODV3 (S), DV2, DV1, P2E-DV2 or P2E-DV1 (their exps' widths) trainers
    with the same weights from a seed on each device at ``precision``, TF32
    off, and a random batch."""
    from sheeprl_tpu_torch.config import compose
    from sheeprl_tpu_torch.interop.flax_to_torch import agent_to_flax, dv2_to_flax, p2e_to_flax
    from sheeprl_tpu_torch.parallel.fabric import Fabric
    from sheeprl_tpu_torch.utils.env import make_env

    continuous = False
    if kind in ("dv2", "dv1"):
        import importlib

        algo = {"dv2": "dreamer_v2", "dv1": "dreamer_v1"}[kind]
        build_agent = importlib.import_module(f"sheeprl_tpu_torch.algos.{algo}.agent").build_agent
        make_trainer = importlib.import_module(f"sheeprl_tpu_torch.algos.{algo}.{algo}").make_trainer
        cfg, to_flax, continuous = compose(dv_overrides(algo)), dv2_to_flax, kind == "dv1"
    elif kind in ("p2e_dv2", "p2e_dv1"):
        import importlib

        from sheeprl_tpu_torch.interop.flax_to_torch import p2e_dv_to_flax

        v = int(kind[-1])
        build_agent = importlib.import_module(f"sheeprl_tpu_torch.algos.{kind}.agent").build_agent
        make_trainer = importlib.import_module(f"sheeprl_tpu_torch.algos.{kind}.{kind}_exploration").make_trainer
        cfg, to_flax, continuous = compose(p2e_dv_overrides(v)), p2e_dv_to_flax, v == 1
    elif kind == "p2e":
        from sheeprl_tpu_torch.algos.p2e_dv3.agent import build_agent
        from sheeprl_tpu_torch.algos.p2e_dv3.p2e_dv3_exploration import make_trainer

        cfg, to_flax = compose(p2e_overrides()), p2e_to_flax
    else:
        from sheeprl_tpu_torch.algos.offline_dreamer.agent import build_agent
        from sheeprl_tpu_torch.algos.offline_dreamer.offline_dreamer import make_trainer

        cfg, to_flax = compose(odv3_overrides()), agent_to_flax
    space = make_env(cfg, 0, 0)().observation_space
    trainers, weights = {}, None
    for accel in devices:
        fabric = Fabric(accelerator=accel, precision=precision, float32_matmul_precision="highest")
        agent = build_agent(fabric, (2,), continuous, cfg, space, seed, weights)
        weights = weights or to_flax(agent)
        trainers[accel] = make_trainer(agent, cfg)
    return trainers, _random_batch(T, B, seed, continuous)


def _noise_to(noise, device, dtype):
    if isinstance(noise, dict):
        return {k: _noise_to(v, device, dtype) for k, v in noise.items()}
    return noise.to(device, dtype)


def _flat_moments(moments, prefix: str = "") -> dict:
    if isinstance(moments, dict):
        out = {}
        for k, v in moments.items():
            out.update(_flat_moments(v, f"{prefix}/{k}" if prefix else k))
        return out
    return {prefix: float(moments)}


def family_step_parity(kind: str, actor_rtol: float = FAMILY_ACTOR_RTOL) -> dict:
    """One gradient step of P2E (DOA++ widths, T=16, B=4) or ODV3 (S, T=16,
    B=4) on the card vs on the CPU in float32 with TF32 off, from the same
    weights, batch and noise, held to ``train_step_parity``'s float32 bars:
    every metric within TRAIN_STEP_RTOL but the actors' losses and gradient
    norms (FAMILY_ACTOR_METRICS, within ``actor_rtol``: FAMILY_ACTOR_RTOL,
    see there; DV2 and DV1 take TRAIN_STEP_RTOL); every parameter (each
    exploration critic's and target's, the ensembles', the CEM's) within 2
    lr and a share >= TRAIN_PARAM_SHARE within TRAIN_PARAM_ATOL; every
    Moments (DV2 and DV1 have none) within TRAIN_STEP_RTOL."""
    T, B = 16, 4
    threads = torch.get_num_threads()
    torch.set_num_threads(os.cpu_count() or 1)  # the CLI runs left one
    try:
        trainers, batch = _family_trainers(kind, ("gpu", "cpu"), T, B)
        lr = max(group["lr"] for opt in trainers["cpu"].optimizers.values() for group in opt.param_groups)
        noise = trainers["cpu"].draw_noise(T, B, torch.Generator().manual_seed(1))
        metrics = {}
        for accel, trainer in trainers.items():
            dev = trainer.device
            out = trainer.train_step({k: v.to(dev) for k, v in batch.items()}, 0,
                                     _noise_to(noise, dev, trainer.agent.dtype))
            metrics[accel] = {k: float(v) for k, v in out.items()}
    finally:
        torch.set_num_threads(threads)
    if not all(math.isfinite(v) for v in metrics["gpu"].values()):
        raise AssertionError(f"{kind} train step on the card: non-finite metrics {metrics['gpu']}")
    rel = {k: abs(metrics["gpu"][k] - v) / max(abs(v), 1e-3) for k, v in metrics["cpu"].items()}
    actors = {k: v for k, v in rel.items() if k.startswith(FAMILY_ACTOR_METRICS)}
    worst = max(v for k, v in rel.items() if k not in actors)
    worst_actor = max(actors.values())
    card, cpu = trainers["gpu"], trainers["cpu"]
    ours = {k: v.detach().cpu() for k, v in card.agent.state_dict().items()}
    flat = torch.cat([(ours[k] - v).abs().reshape(-1) for k, v in cpu.agent.state_dict().items()])
    m_card, m_cpu = _flat_moments(getattr(card, "moments", {})), _flat_moments(getattr(cpu, "moments", {}))
    state = {
        "param_max_abs_gap": float(flat.max()),
        "param_share_within_atol": float((flat <= TRAIN_PARAM_ATOL).float().mean()),
        "moments_rel_gap": max((abs(m_card[k] - v) / max(abs(v), 1e-3) for k, v in m_cpu.items()), default=0.0),
        "parameters": int(flat.numel()),
    }
    print(f"[chip-smoke] {kind} train step card vs CPU (float32, TF32 off, T={T}, B={B}): worst relative err of the "
          f"metrics {worst} (bar {TRAIN_STEP_RTOL}), of the actors' {worst_actor} (bar {actor_rtol}); state "
          f"{json.dumps(state)} (bars: every parameter within {2 * lr:.1e}, a share >= {TRAIN_PARAM_SHARE} within "
          f"{TRAIN_PARAM_ATOL}); metrics {json.dumps(metrics)}", flush=True)
    if worst > TRAIN_STEP_RTOL or worst_actor > actor_rtol:
        raise AssertionError(f"the {kind} train step on the card disagrees with the CPU: {json.dumps(rel)}")
    if not (state["param_max_abs_gap"] <= 2 * lr and state["param_share_within_atol"] >= TRAIN_PARAM_SHARE
            and state["moments_rel_gap"] <= TRAIN_STEP_RTOL):
        raise AssertionError(f"the {kind} update on the card disagrees with the CPU's: {state}")
    return {"worst_rel_err": worst, "worst_actor_rel_err": worst_actor, "rel_err": rel, "state": state, "T": T,
            "B": B, **metrics}


# (T, B, precision) of each family's timed step: P2E at its DOA++ batch in
# bf16, DV2 and DV1 at their exps' batches in float32
FAMILY_TIMING = {"p2e": (64, 4, P2E_PRECISION), "dv2": (50, 16, "32-true"), "dv1": (50, 50, "32-true"),
                 "p2e_dv2": (50, 16, "32-true"), "p2e_dv1": (50, 50, "32-true")}


def time_family_steps(kind: str = "p2e", steps: int = 3) -> tuple:
    """Seconds per gradient step of P2E at the DOA++ widths and batch (4 x
    64, bf16-mixed), or of DV2 (16 x 50) or DV1 (50 x 50) in float32, eager,
    TF32 as the config sets it; returns the warm trainer for the profile."""
    from sheeprl_tpu_torch.parallel.fabric import apply_matmul_precision

    T, B, precision = FAMILY_TIMING[kind]
    trainers, batch = _family_trainers(kind, ("gpu",), T, B, seed=2, precision=precision)
    trainer = trainers["gpu"]
    apply_matmul_precision("high")
    batch = {k: v.to(trainer.device) for k, v in batch.items()}
    generator = torch.Generator(trainer.device).manual_seed(3)
    for cum in range(2):
        trainer.train_step(batch, cum, trainer.draw_noise(T, B, generator))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for cum in range(2, 2 + steps):
        trainer.train_step(batch, cum, trainer.draw_noise(T, B, generator))
    torch.cuda.synchronize()
    out = {"kind": kind, "precision": precision, "T": T, "B": B, "steps": steps,
           "seconds_per_gradient_step": (time.perf_counter() - t0) / steps}
    print(f"[chip-smoke] {kind} train step timing: {json.dumps(out)}", flush=True)
    return out, (trainer, batch, generator)


# -- Plan2Explore on Dreamer-V1 and V2, SAC-AE (phase 5e) --------------------------
P2E_DV_ENVS = DV_ENVS
# as phase 5d: each env holds one 50-step sequence after 56 iterations; then
# P2E-DV2 (ratio 0.2) takes 8 gradient steps in 10 iterations, P2E-DV1 (0.1)
# 8 in 20; the resumed runs wait the 56 again and take 2 (the restored
# governor skips the first training iteration); finetuning acts with the
# exploration actor for 56 iterations, then trains the task heads as long
P2E_DV_EXTRA_ITERS = {2: 10, 1: 20}
P2E_DV_RESUME_EXTRA_ITERS = {2: 4, 1: 8}
P2E_DV_MIN_GRADIENT_STEPS = (8, 2)
P2E_DV_TAGS = ("Loss/world_model_loss", "Loss/ensemble_loss", "Loss/policy_loss_exploration",
               "Loss/policy_loss_task", "Rewards/intrinsic", "Time/sps_train")
DV_LAYOUT = {2: ["actor", "critic", "target_critic", "world_model"], 1: ["actor", "critic", "world_model"]}
# SAC-AE at its exp's widths (x16 channels: 512 a conv, features 64, hidden
# 1024, batch 128, 3 stacked 64 x 64 frames) on the continuous dummy env, 4
# envs: 32 iterations before learning starts (one batch of rows), then 4
# gradient steps an iteration (replay ratio 1) for 5 iterations; the resumed
# run waits the 32 again and takes 4 more. The exp's buffer of 1,000,000 rows
# (73.7 kB of frames each) is cut to 16,384
SAC_AE_ENVS = 4
SAC_AE_LEARNING_STARTS_ITERS = 32
SAC_AE_FIRST_ITERS = SAC_AE_LEARNING_STARTS_ITERS + 4
SAC_AE_RESUME_ITERS = SAC_AE_FIRST_ITERS + SAC_AE_LEARNING_STARTS_ITERS + 2
SAC_AE_MIN_GRADIENT_STEPS = (16, 4)
SAC_AE_TAGS = ("Loss/value_loss", "Loss/policy_loss", "Loss/alpha_loss", "Loss/reconstruction_loss",
               "Time/sps_train")
# one SAC-AE train step card vs CPU in float32 with TF32 off: the CPU's
# convolutions at 512 channels take about a second a sample, so the batch is 2
SAC_AE_PARITY_B = 2
# the card's float32 step against the exact (float64) one: in three runs on one
# NVIDIA H100 80GB HBM3 at 700 W its weights beyond TRAIN_PARAM_ATOL of the
# exact step were 0.94-1.06x the CPU's float32 ones (314,860-356,988 against
# 336,557; the card's wgrad convolutions sum in a run-dependent order); a wrong
# or missing update of any group but the temperature moves more weights than
# twice the CPU's count
SAC_AE_ROUNDING_FACTOR = 2


def p2e_dv_overrides(v: int, run_dir: str = "", phase: str = "exploration") -> list:
    """``exp=p2e_dv{v}_{phase}`` at the exp's widths, batch, sequence, horizon,
    replay ratio, ensemble and buffer, on the dummy env (P2E-DV1 on the
    continuous one), 4 envs, learning_starts cut."""
    return [
        f"exp=p2e_dv{v}_{phase}",
        "env=dummy",
        *(["env.id=continuous_dummy"] if v == 1 else []),
        f"env.num_envs={P2E_DV_ENVS}",
        f"algo.learning_starts={P2E_DV_ENVS * DV_LEARNING_STARTS_ITERS}",
        *([f"hydra.run.dir={run_dir}"] if run_dir else []),
    ]


def p2e_dv_path(v: int, out_dir: str) -> dict:
    """Plan2Explore on Dreamer-V{v} through the entry points in float32:
    exploration (>= 8 gradient steps), a resume from its checkpoint (>= 2),
    an evaluation, finetuning from it (the exploration actor acts until
    learning starts, the task actor after; its checkpoint holds the
    backbone's layout) and its evaluation. The launch counts are zeroed just
    before each run and read just after: P2E-DV2 launches the LN-GRU kernel
    80 times an exploration step and 65 a finetuning step, once a policy step
    of the loop and of the test episode; P2E-DV1 never."""
    from sheeprl_tpu_torch.cli import run
    from sheeprl_tpu_torch.utils.checkpoint import load_checkpoint

    short, expl_algo, ft_algo = f"P2E-DV{v}", f"p2e_dv{v}_exploration", f"p2e_dv{v}_finetuning"
    expl = p2e_dv_overrides(v, os.path.join(out_dir, f"p2e_dv{v}"))
    first_iters = DV_LEARNING_STARTS_ITERS + P2E_DV_EXTRA_ITERS[v]
    out = {}
    _zero_launches()
    first = run(expl + [f"algo.total_steps={P2E_DV_ENVS * first_iters}"])
    out["train"] = _check_dv_run(expl_algo, f"{short} exploration", first, P2E_DV_MIN_GRADIENT_STEPS[0])
    scalars = check_scalars(f"{short} exploration", first["log_dir"], P2E_DV_TAGS)
    out["train"]["scalars"] = {t: scalars[t][-1] for t in P2E_DV_TAGS}
    resume_iters = first_iters + DV_LEARNING_STARTS_ITERS + P2E_DV_RESUME_EXTRA_ITERS[v]
    _zero_launches()
    resumed = run(expl + [f"algo.total_steps={P2E_DV_ENVS * resume_iters}",
                          f"checkpoint.resume_from={first['checkpoint']}"])
    out["resume"] = _check_dv_run(expl_algo, f"{short} exploration resumed", resumed, P2E_DV_MIN_GRADIENT_STEPS[1])
    if not resumed["log_dir"].endswith("version_1"):
        raise AssertionError(f"the resumed {short} run wrote {resumed['log_dir']}, not the run's version_1")
    out["evaluation"] = _evaluate_dv(expl_algo, f"{short} exploration", resumed["checkpoint"])

    _zero_launches()
    ft = run(p2e_dv_overrides(v, os.path.join(out_dir, f"p2e_dv{v}_ft"), "finetuning") + [
        f"algo.total_steps={P2E_DV_ENVS * first_iters}", f"checkpoint.exploration_ckpt_path={first['checkpoint']}"])
    out["finetune"] = _check_dv_run(ft_algo, f"{short} finetuning", ft, P2E_DV_MIN_GRADIENT_STEPS[0])
    switch = ft["actor_switch"]
    layout = sorted(load_checkpoint(ft["checkpoint"])["agent"])
    print(f"[chip-smoke] {short} finetuning: the player switched to the task actor at iteration "
          f"{switch['iteration']} after {switch['player_calls_before']} calls with the exploration actor; "
          f"{ft['player_calls']} calls in all; checkpoint layout {layout}", flush=True)
    if switch != {"iteration": DV_LEARNING_STARTS_ITERS, "player_calls_before": DV_LEARNING_STARTS_ITERS} \
            or ft["player_calls"] <= switch["player_calls_before"]:
        raise AssertionError(f"{short} finetuning did not act with the exploration actor until learning started "
                             f"and with the task actor after: {switch}, {ft['player_calls']} calls")
    if layout != DV_LAYOUT[v]:
        raise AssertionError(f"{short} finetuning checkpoint holds {layout}, not Dreamer-V{v}'s layout")
    out["finetune_evaluation"] = _evaluate_dv(ft_algo, f"{short} finetuning", ft["checkpoint"])
    out["seconds_per_gradient_step"] = first["train_seconds"] / first["gradient_steps"]
    out["finetune_seconds_per_gradient_step"] = ft["train_seconds"] / ft["gradient_steps"]
    print(f"[chip-smoke] {short}: {out['seconds_per_gradient_step']:.4f} s per exploration gradient step in the "
          f"loop, {out['finetune_seconds_per_gradient_step']:.4f} s per finetuning step", flush=True)
    return out


def sac_ae_overrides(run_dir: str = "") -> list:
    return [
        "exp=sac_ae",
        "env=dummy",
        "env.id=continuous_dummy",
        "algo.cnn_keys.encoder=[rgb]",
        "algo.mlp_keys.encoder=[state]",
        f"env.num_envs={SAC_AE_ENVS}",
        f"algo.learning_starts={SAC_AE_ENVS * SAC_AE_LEARNING_STARTS_ITERS}",
        "buffer.size=16384",
        *([f"hydra.run.dir={run_dir}"] if run_dir else []),
    ]


def _check_sac_ae_run(name: str, summary: dict, min_steps: int) -> dict:
    print(f"[chip-smoke] {name}: {summary['gradient_steps']} gradient steps in {summary['train_phases']} train phases, "
          f"{summary['policy_steps']} policy steps in {summary['wall_seconds']:.2f}s (train "
          f"{summary['train_seconds']:.2f}s, env {summary['env_seconds']:.2f}s); test reward {summary['test_reward']}; "
          f"losses {json.dumps(summary['metrics'])}; LN-GRU launches {LN_GRU.launches}", flush=True)
    if summary["gradient_steps"] < min_steps or not all(math.isfinite(x) for x in summary["metrics"].values()):
        raise AssertionError(f"{name}: {summary['gradient_steps']} gradient steps, losses {summary['metrics']}")
    if "Loss/reconstruction_loss" not in summary["metrics"] or LN_GRU.launches:
        raise AssertionError(f"{name}: losses {sorted(summary['metrics'])}, {LN_GRU.launches} LN-GRU launches")
    return {"summary": summary, "launches": _launches()}


def sac_ae_path(out_dir: str) -> dict:
    """``exp=sac_ae`` through the entry points on the card: train (>= 16
    gradient steps; the metric log holds the reconstruction loss), resume
    into version_1, evaluate. SAC-AE reaches no TPU kernel: the launch counts
    are read to show that."""
    from sheeprl_tpu_torch.cli import evaluation, run

    overrides = sac_ae_overrides(os.path.join(out_dir, "sac_ae"))
    out = {}
    _zero_launches()
    first = run(overrides + [f"algo.total_steps={SAC_AE_ENVS * SAC_AE_FIRST_ITERS}"])
    out["train"] = _check_sac_ae_run("SAC-AE first run", first, SAC_AE_MIN_GRADIENT_STEPS[0])
    scalars = check_scalars("SAC-AE first run", first["log_dir"], SAC_AE_TAGS)
    out["train"]["scalars"] = {t: scalars[t][-1] for t in SAC_AE_TAGS}
    _zero_launches()
    resumed = run(overrides + [f"algo.total_steps={SAC_AE_ENVS * SAC_AE_RESUME_ITERS}",
                               f"checkpoint.resume_from={first['checkpoint']}"])
    out["resume"] = _check_sac_ae_run("SAC-AE resumed run", resumed, SAC_AE_MIN_GRADIENT_STEPS[1])
    if not resumed["log_dir"].endswith("version_1"):
        raise AssertionError(f"the resumed SAC-AE run wrote {resumed['log_dir']}, not the run's version_1")
    _zero_launches()
    reward = evaluation([f"checkpoint_path={resumed['checkpoint']}"])
    out["evaluation"] = {"reward": reward, "launches": _launches()}
    print(f"[chip-smoke] SAC-AE evaluation: reward {reward}, LN-GRU launches {LN_GRU.launches}", flush=True)
    if not math.isfinite(reward) or LN_GRU.launches:
        raise AssertionError(f"SAC-AE evaluation: reward {reward}, {LN_GRU.launches} LN-GRU launches")
    out["seconds_per_gradient_step"] = first["train_seconds"] / first["gradient_steps"]
    return out


def _sac_ae_trainers(devices, precision: str = "highest", scale_heads: bool = True):
    """SAC-AE trainers at the exp's widths with the same weights (the first
    device's, from a seed) on each device; the actor's heads scaled by 0.1
    (the pre-squash samples stay off tanh's tail, as the SAC parity does)."""
    from sheeprl_tpu_torch.algos.sac_ae.agent import build_agent
    from sheeprl_tpu_torch.algos.sac_ae.sac_ae import SACAETrainer, build_optimizers
    from sheeprl_tpu_torch.config import compose
    from sheeprl_tpu_torch.interop.flax_to_torch import sac_ae_to_flax
    from sheeprl_tpu_torch.parallel.fabric import Fabric
    from sheeprl_tpu_torch.utils.env import make_env

    cfg = compose(sac_ae_overrides())
    env = make_env(cfg, 0, 0)()
    trainers, weights = {}, None
    for accel in devices:
        fabric = Fabric(accelerator=accel, float32_matmul_precision=precision)
        agent = build_agent(fabric, cfg, env.observation_space, env.action_space, 0, weights)
        if weights is None:
            if scale_heads:
                with torch.no_grad():
                    agent.actor.fc_mean.weight.mul_(0.1)
                    agent.actor.fc_logstd.weight.mul_(0.1)
            weights = sac_ae_to_flax(agent)
        trainers[accel] = SACAETrainer(agent, build_optimizers(cfg, agent), cfg, -float(env.action_space.shape[0]))
    env.close()
    return trainers, cfg


def _sac_ae_block(rng, G: int, B: int) -> dict:
    def obs(prefix=""):
        return {prefix + "rgb": rng.integers(0, 256, (G, B, 3, 3, 64, 64)).astype(np.uint8),
                prefix + "state": rng.standard_normal((G, B, 10)).astype(np.float32)}

    return {**obs(), **obs("next_"), "actions": rng.uniform(-1, 1, (G, B, 2)).astype(np.float32),
            "rewards": rng.standard_normal((G, B, 1)).astype(np.float32),
            "terminated": np.zeros((G, B, 1), np.float32)}


def sac_ae_step_parity() -> dict:
    """One SAC-AE gradient step (``cum`` 0: every gate open) at the exp's
    widths on the card vs on the CPU in float32 with TF32 off, batch
    SAC_AE_PARITY_B, from the same weights, block and draws: the four losses
    within TRAIN_STEP_RTOL and every parameter within 2 lr
    (``train_step_parity``'s bars). Its third bar, a share of the weights
    within TRAIN_PARAM_ATOL, stands here against the exact step (the CPU's,
    in float64, measured in the same run): the card's weights beyond
    TRAIN_PARAM_ATOL of it may be at most SAC_AE_ROUNDING_FACTOR (2) times the
    CPU float32 step's weights beyond TRAIN_PARAM_ATOL of it. Adam's first
    step, at the exp's eps of 1e-8, moves a weight by about lr whatever its
    gradient's size, so where a gradient lies within rounding of 0 (the
    512-channel convolutions and the 320,000-wide projections hold hundreds
    of thousands) rounding alone picks the step's sign: float32 rounding
    alone puts more than 0.1% of the weights beyond TRAIN_PARAM_ATOL of the
    exact step."""
    from sheeprl_tpu_torch.algos.sac_ae.sac_ae import SACAETrainer, build_optimizers

    threads = torch.get_num_threads()
    torch.set_num_threads(os.cpu_count() or 1)
    try:
        trainers, cfg = _sac_ae_trainers(("gpu", "cpu"))
        cpu = trainers["cpu"]
        exact = copy.deepcopy(cpu.agent).to(torch.float64)
        trainers["cpu_float64"] = SACAETrainer(exact, build_optimizers(cfg, exact), cfg, cpu.target_entropy)
        block = _sac_ae_block(np.random.default_rng(17), 1, SAC_AE_PARITY_B)
        noise = cpu.draw_noise(1, {k: torch.from_numpy(v) for k, v in block.items()}, torch.Generator().manual_seed(18))
        losses = {}
        for name, trainer in trainers.items():
            dev, dtype = trainer.device, trainer.dtype
            data = {k: torch.from_numpy(v).to(dev) for k, v in block.items()}
            data = {k: v if v.dtype == torch.uint8 else v.to(dtype) for k, v in data.items()}
            losses[name] = trainer.train_phase(data, 0, _noise_to(noise, dev, dtype)).cpu()
    finally:
        torch.set_num_threads(threads)
    lr = max(group["lr"] for opt in cpu.optimizers.values() for group in opt.param_groups)
    rel = (losses["gpu"] - losses["cpu"]).abs() / losses["cpu"].abs().clamp_min(1e-3)

    def gap(a, b):
        a, b = a.agent.state_dict(), b.agent.state_dict()
        return torch.cat([(a[k].detach().cpu().double() - v.double()).abs().reshape(-1) for k, v in b.items()])

    card, rounding = gap(trainers["gpu"], cpu), gap(cpu, trainers["cpu_float64"])
    card_exact = gap(trainers["gpu"], trainers["cpu_float64"])
    res = {"losses_rel_err": rel.tolist(), "worst_rel_err": float(rel.max()), "param_max_abs_gap": float(card.max()),
           "params_beyond_atol": int((card > TRAIN_PARAM_ATOL).sum()),
           "cpu_float32_params_beyond_atol_of_float64": int((rounding > TRAIN_PARAM_ATOL).sum()),
           "card_params_beyond_atol_of_float64": int((card_exact > TRAIN_PARAM_ATOL).sum()),
           "cpu_float32_param_max_abs_gap_to_float64": float(rounding.max()), "parameters": int(card.numel()),
           "card": losses["gpu"].tolist(), "cpu": losses["cpu"].tolist(), "cpu_float64": losses["cpu_float64"].tolist(),
           "batch": SAC_AE_PARITY_B}
    print(f"[chip-smoke] SAC-AE train step card vs CPU (float32, TF32 off, B={SAC_AE_PARITY_B}): {json.dumps(res)} "
          f"(bars: losses {TRAIN_STEP_RTOL} relative, every parameter within {2 * lr:.1e}, the card's parameters "
          f"beyond {TRAIN_PARAM_ATOL} of the float64 step at most {SAC_AE_ROUNDING_FACTOR}x the CPU float32 step's)",
          flush=True)
    if not (res["worst_rel_err"] <= TRAIN_STEP_RTOL and res["param_max_abs_gap"] <= 2 * lr
            and res["card_params_beyond_atol_of_float64"]
            <= SAC_AE_ROUNDING_FACTOR * res["cpu_float32_params_beyond_atol_of_float64"]
            and torch.isfinite(losses["gpu"]).all()):
        raise AssertionError(f"the SAC-AE train step on the card disagrees with the CPU: {res}")
    return res


def time_sac_ae(phases: int = 3) -> tuple:
    """Seconds per SAC-AE gradient step on the card at the exp's widths and
    batch (128), in train phases of the loop's 4 steps from ``cum`` 0 (every
    gate opens on the even steps), TF32 as the config sets it. Returns the
    timing and the warm trainer with its inputs, for the profile."""
    trainers, cfg = _sac_ae_trainers(("gpu",), precision="high", scale_heads=False)
    trainer = trainers["gpu"]
    G, B = SAC_AE_ENVS, int(cfg.algo.per_rank_batch_size)
    data = {k: torch.from_numpy(v).to(trainer.device) for k, v in _sac_ae_block(np.random.default_rng(19), G, B).items()}
    generator = torch.Generator(trainer.device).manual_seed(20)
    trainer.train_phase(data, 0, trainer.draw_noise(G, data, generator))  # warm-up: cuDNN plans, the allocator
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for i in range(phases):
        trainer.train_phase(data, G * (i + 1), trainer.draw_noise(G, data, generator))
    torch.cuda.synchronize()
    out = {"B": B, "G": G, "phases": phases, "seconds_per_gradient_step": (time.perf_counter() - t0) / (phases * G)}
    print(f"[chip-smoke] SAC-AE train step timing: {json.dumps(out)}", flush=True)
    return out, (trainer, data, generator)


def profile_sac_ae_phase(warm: tuple) -> dict:
    """Under torch.profiler (last), the card's busy share of one SAC-AE train
    phase of 4 gradient steps, its device operations and device time by
    kernel."""
    from torch.profiler import ProfilerActivity, profile

    trainer, data, generator = warm
    G = data["rewards"].shape[0]
    noise = trainer.draw_noise(G, data, generator)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        trainer.train_phase(data, 100, noise)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    by_kernel, count = {}, 0
    for ev in device_events(prof):
        by_kernel[ev.name] = by_kernel.get(ev.name, 0.0) + ev.time_range.elapsed_us() / 1e3
        count += 1
    device_ms = sum(by_kernel.values())
    out = {"gradient_steps": G, "phase_wall_ms": wall_ms, "phase_device_ms": device_ms if device_ms > 0 else None,
           "device_busy_share": device_ms / wall_ms if device_ms > 0 else None, "device_operations": count,
           "device_operations_per_gradient_step": count / G,
           "top_device_ms": sorted(by_kernel.items(), key=lambda kv: -kv[1])[:8]}
    print(f"[chip-smoke] SAC-AE train phase profile: {json.dumps(out)}", flush=True)
    return out


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
# of 64, 10 epochs, width 64, 32768 policy steps (64 train phases), cut from
# 65,536 to keep the whole smoke inside its time limit: on the CPU runs of
# 32,768 steps scored 500 with seeds 42, 7 and 123 (the bar is 100)
PPO_TOTAL_STEPS = 32768
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
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
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


# Recurrent PPO on CartPole-v1 at the exp's widths (encoder, heads and LSTM
# 64, LayerNorm on) on the JAX package's learning test's schedule
# (tests/test_learning/test_learning.py: 4 envs x 128 steps, sequences of 16,
# 4 minibatches, 4 epochs, 24,576 policy steps: 48 train phases) and its bar:
# a greedy test reward of 120 (random play scores ~20). Resume: one more
# iteration
RPPO_LEARN = ["env.num_envs=4", "algo.rollout_steps=128", "algo.per_rank_sequence_length=16",
              "algo.per_rank_num_batches=4", "algo.update_epochs=4", "metric.log_every=8192"]
RPPO_TOTAL_STEPS = 24576
RPPO_STEPS_PER_ITER = 4 * 128
RPPO_MIN_TEST_REWARD = 120.0
# one train phase at the exp's own shape (16 envs x 512 steps, sequences of
# 16, 8 minibatches, 8 epochs), card vs CPU with TF32 off, within PPO's bars
# (the exp's Adam also takes eps 1e-4); the serve step within PPO's serve bar
RPPO_ENVS, RPPO_STEPS = 16, 512
RPPO_SERVE_ATOL = 1e-5


def rppo_path(out_dir: str) -> dict:
    """``exp=ppo_recurrent`` through the entry points on the card: train on
    the learning test's schedule with the metric log and the test episode
    (its reward must reach RPPO_MIN_TEST_REWARD), resume into version_1 for
    one more iteration, evaluate the last checkpoint, and serve it through
    ``serve_main`` (4 slots, 4 greedy sessions). Recurrent PPO reaches no TPU
    kernel: its launch counts are read to show that."""
    from sheeprl_tpu_torch.cli import evaluation, run
    from sheeprl_tpu_torch.serve.main import serve_main

    overrides = ["exp=ppo_recurrent", *RPPO_LEARN, f"hydra.run.dir={os.path.join(out_dir, 'rppo')}"]
    out = {}
    _zero_launches()
    first = run(overrides + [f"algo.total_steps={RPPO_TOTAL_STEPS}"])
    out["train"] = {"summary": first, "launches": _launches()}
    scalars = check_scalars("rPPO first run", first["log_dir"], PPO_TAGS)
    out["train"]["scalars"] = {t: scalars[t][-1] for t in PPO_TAGS}
    out["seconds_per_train_phase_in_the_loop"] = first["train_seconds"] / first["train_phases"]
    out["seconds_per_vector_step_in_the_loop"] = first["env_seconds"] / (first["train_phases"] * 128)
    print(f"[chip-smoke] rPPO first run: {first['train_phases']} train phases, {first['policy_steps']} policy steps "
          f"in {first['wall_seconds']:.2f}s (train {first['train_seconds']:.2f}s, env {first['env_seconds']:.2f}s); "
          f"test reward {first['test_reward']} (bar >= {RPPO_MIN_TEST_REWARD}); losses {json.dumps(first['metrics'])}; "
          f"last Rewards/rew_avg {scalars['Rewards/rew_avg'][-1][1]:.1f}", flush=True)
    if first["train_phases"] != RPPO_TOTAL_STEPS // RPPO_STEPS_PER_ITER:
        raise AssertionError(f"rPPO took {first['train_phases']} train phases")
    if not all(math.isfinite(v) for v in first["metrics"].values()):
        raise AssertionError(f"rPPO: non-finite losses {first['metrics']}")
    if not (first["test_reward"] is not None and first["test_reward"] >= RPPO_MIN_TEST_REWARD):
        raise AssertionError(f"rPPO: test reward {first['test_reward']} < {RPPO_MIN_TEST_REWARD}")
    _zero_launches()
    resumed = run(overrides + [f"algo.total_steps={RPPO_TOTAL_STEPS + RPPO_STEPS_PER_ITER}",
                               f"checkpoint.resume_from={first['checkpoint']}"])
    out["resume"] = {"summary": resumed, "launches": _launches()}
    print(f"[chip-smoke] rPPO resumed run: {resumed['train_phases']} train phase into {resumed['log_dir']}, "
          f"losses {json.dumps(resumed['metrics'])}", flush=True)
    if not (resumed["log_dir"].endswith("version_1") and resumed["train_phases"] == 1
            and all(math.isfinite(v) for v in resumed["metrics"].values())):
        raise AssertionError(f"rPPO resume: {resumed}")
    _zero_launches()
    reward = evaluation([f"checkpoint_path={resumed['checkpoint']}"])
    out["evaluation"] = {"reward": reward, "launches": _launches()}
    print(f"[chip-smoke] rPPO evaluation: reward {reward}", flush=True)
    if not math.isfinite(reward):
        raise AssertionError(f"rPPO evaluation: reward {reward}")
    log_dir = os.path.join(out_dir, "rppo_serve")
    _zero_launches()
    rc = serve_main([f"checkpoint_path={resumed['checkpoint']}", f"serve.slots={SLOTS}",
                     f"serve.sessions={SESSIONS}", f"serve.log_dir={log_dir}"])
    launches = _launches()
    with open(os.path.join(log_dir, "summary.json")) as f:
        summary = json.load(f)
    print(f"[chip-smoke] rPPO serve rc={rc} summary={json.dumps(summary)} launches={launches}", flush=True)
    if rc != 0 or summary["sessions_completed"] != SESSIONS or summary["steps"] < SESSIONS:
        raise AssertionError(f"rPPO serving did not complete every session: rc {rc}, {summary}")
    check_telemetry("rPPO serve", log_dir)
    out["serve"] = {"summary": summary, "launches": launches}
    out["ckpt"] = resumed["checkpoint"]
    return out


def _rppo_trainers(devices, precision: str = "highest"):
    """The exp's recurrent PPO trainer on each device, the same weights from a
    seed; and the cfg."""
    from sheeprl_tpu_torch.algos.ppo_recurrent.agent import build_agent
    from sheeprl_tpu_torch.algos.ppo_recurrent.ppo_recurrent import RecurrentPPOTrainer, build_optimizer
    from sheeprl_tpu_torch.config import compose
    from sheeprl_tpu_torch.parallel.fabric import Fabric
    from sheeprl_tpu_torch.utils.env import make_env

    cfg = compose(["exp=ppo_recurrent"])
    space = make_env(cfg, 0, 0)().observation_space
    trainers = {}
    for accel in devices:
        agent = build_agent(Fabric(accelerator=accel, float32_matmul_precision=precision), (2,), False, cfg, space, 0)
        optimizer, schedule = build_optimizer(cfg, agent, cfg.algo.total_steps // (RPPO_ENVS * RPPO_STEPS))
        trainers[accel] = RecurrentPPOTrainer(agent, optimizer, cfg, schedule)
    return trainers, cfg


def _rppo_block(seed: int) -> dict:
    """The padded sequence block of a random [512, 16] CartPole rollout at the
    exp's shape (episodes end with probability 1/40 a step), as the loop
    builds it: GAE on the host, then ``chunk_sequences``."""
    from sheeprl_tpu_torch.algos.ppo_recurrent.ppo_recurrent import chunk_sequences
    from sheeprl_tpu_torch.utils.utils import gae

    rng = np.random.default_rng(seed)
    T, E, H = RPPO_STEPS, RPPO_ENVS, 64
    data = {
        "state": rng.standard_normal((T, E, 4)).astype(np.float32),
        "actions": np.eye(2, dtype=np.float32)[rng.integers(0, 2, (T, E))],
        "prev_actions": np.eye(2, dtype=np.float32)[rng.integers(0, 2, (T, E))],
        "logprobs": -rng.uniform(0.1, 1.5, (T, E, 1)).astype(np.float32),
        "values": rng.standard_normal((T, E, 1)).astype(np.float32),
        "rewards": np.ones((T, E, 1), np.float32),
        "dones": (rng.uniform(size=(T, E, 1)) < 1 / 40).astype(np.float32),
        "prev_hx": (0.3 * rng.standard_normal((T, E, H))).astype(np.float32),
        "prev_cx": (0.3 * rng.standard_normal((T, E, H))).astype(np.float32),
    }
    returns, advantages = gae(*(torch.from_numpy(data[k]) for k in ("rewards", "values", "dones")),
                              torch.from_numpy(rng.standard_normal((E, 1)).astype(np.float32)), T, 0.99, 0.95)
    return chunk_sequences({**data, "returns": returns.numpy(), "advantages": advantages.numpy()}, 16, 8)


def rppo_parity() -> dict:
    """One recurrent PPO train phase at the exp's shape on the card vs on the
    CPU (TF32 off): the same weights, block and permutations; then greedy
    serve steps from the CPU trainer's weights on both devices, from the same
    carries and observations, 4 ticks over 4 slots."""
    from sheeprl_tpu_torch.algos.ppo_recurrent.serve import get_serve_policy
    from sheeprl_tpu_torch.config import compose
    from sheeprl_tpu_torch.interop.flax_to_torch import ppo_recurrent_to_flax
    from sheeprl_tpu_torch.parallel.fabric import Fabric

    trainers, cfg = _rppo_trainers(("gpu", "cpu"))
    seqs = _rppo_block(21)
    n = seqs["mask"].shape[1]
    perms = trainers["cpu"].draw_permutations(n, torch.Generator().manual_seed(22))
    out = {}
    for accel, trainer in trainers.items():
        losses = trainer.train_phase(seqs, perms, 0.2, float(cfg.algo.ent_coef))
        out[accel] = (losses.cpu(), [p.detach().cpu() for p in trainer.agent.parameters()])
    loss_gap = float(((out["gpu"][0] - out["cpu"][0]).abs() / out["cpu"][0].abs().clamp_min(1e-3)).max())
    param_gap = max(float((a - b).abs().max()) for a, b in zip(out["gpu"][1], out["cpu"][1]))
    updates = int(trainers["cpu"].optimizer.state[trainers["cpu"].params[0]]["step"])
    res = {"losses_rel_gap": loss_gap, "param_max_abs_gap": param_gap, "card": out["gpu"][0].tolist(),
           "cpu": out["cpu"][0].tolist(), "updates": updates, "sequences": int((seqs["mask"].sum((0, 2)) > 0).sum()),
           "padded_sequences": n, "parameters": sum(p.numel() for p in trainers["cpu"].params)}
    print(f"[chip-smoke] rPPO train phase card vs CPU (TF32 off, {updates} updates): {json.dumps(res)} (bars: losses "
          f"{PPO_LOSS_RTOL} relative, every parameter {PPO_PARAM_ATOL})", flush=True)
    if not (loss_gap <= PPO_LOSS_RTOL and param_gap <= PPO_PARAM_ATOL):
        raise AssertionError(f"the rPPO train phase on the card disagrees with the CPU: {res}")

    state = {"agent": ppo_recurrent_to_flax(trainers["cpu"].agent)}
    serve_cfg = compose(["exp=ppo_recurrent"])
    policies = {accel: get_serve_policy(Fabric(accelerator=accel, float32_matmul_precision="highest"), serve_cfg,
                                        state) for accel in ("gpu", "cpu")}
    carries = {accel: p.init_slots(SLOTS) for accel, p in policies.items()}
    rng = np.random.default_rng(23)
    err, equal, ticks = 0.0, True, 4
    for _ in range(ticks):
        obs = rng.uniform(-2, 2, (SLOTS, 4)).astype(np.float32)
        step = {}
        for accel, p in policies.items():
            step[accel] = p.step_slots(carries[accel], {"state": torch.from_numpy(obs).to(p.device)}, {})
            carries[accel] = step[accel][1]
        equal = equal and bool(torch.equal(step["gpu"][0].cpu(), step["cpu"][0]))
        err = max(err, *(float((step["gpu"][1][k].cpu() - step["cpu"][1][k]).abs().max()) for k in ("hx", "cx")))
    res["serve_carry_max_abs_err"], res["serve_actions_equal"] = err, equal
    print(f"[chip-smoke] rPPO serve step card vs CPU ({ticks} ticks, {SLOTS} slots): hx/cx max abs err {err} (bar "
          f"{RPPO_SERVE_ATOL}), actions equal {equal}", flush=True)
    if not (err <= RPPO_SERVE_ATOL and equal):
        raise AssertionError(f"the rPPO serve step on the card disagrees with the CPU: {err}, {equal}")
    return res


def time_rppo(phases: int = 3) -> tuple:
    """Seconds per recurrent PPO train phase on the card at the exp's shape
    (TF32 as the config sets it), synchronized; and ms per acting step on the
    host (the host agent's one-step forward and sample for the exp's 16 envs,
    one torch thread as the loop runs it). Returns the timings and the warm
    trainer with its block."""
    from sheeprl_tpu_torch.algos.ppo.agent import draw_policy_noise, policy_output
    from sheeprl_tpu_torch.algos.ppo_recurrent.utils import sequence_obs

    trainers, cfg = _rppo_trainers(("gpu", "cpu"), precision="high")
    trainer = trainers["gpu"]
    seqs = _rppo_block(24)
    n = seqs["mask"].shape[1]
    generator = torch.Generator().manual_seed(25)
    ent = float(cfg.algo.ent_coef)
    trainer.train_phase(seqs, trainer.draw_permutations(n, generator), 0.2, ent)  # warm-up
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(phases):
        trainer.train_phase(seqs, trainer.draw_permutations(n, generator), 0.2, ent)
    torch.cuda.synchronize()
    out = {"phases": phases, "seconds_per_train_phase": (time.perf_counter() - t0) / phases,
           "updates_per_phase": int(cfg.algo.update_epochs) * int(cfg.algo.per_rank_num_batches),
           "padded_sequences": n}
    act = trainers["cpu"].agent
    obs = {"state": seqs["state"][0, :RPPO_ENVS]}
    prev = torch.zeros(1, RPPO_ENVS, 2)
    hx, cx = act.initial_states(RPPO_ENVS)
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    with torch.no_grad():
        def act_step():
            actor_outs, values, _ = act(sequence_obs(obs, ["state"], []), prev, hx, cx)
            noise = draw_policy_noise((2,), False, RPPO_ENVS, generator, "cpu")
            return policy_output([o[0] for o in actor_outs], values[0], (2,), False, noise=noise)

        for _ in range(50):
            act_step()
        steps = 1000
        t0 = time.perf_counter()
        for _ in range(steps):
            act_step()
        out["ms_per_acting_step"] = (time.perf_counter() - t0) * 1e3 / steps
    torch.set_num_threads(threads)
    print(f"[chip-smoke] rPPO timing: {json.dumps(out)}", flush=True)
    return out, (trainer, seqs, generator, ent)


def profile_rppo_train_phase(warm: tuple) -> dict:
    """Under torch.profiler (last), the card's busy share of one recurrent PPO
    train phase at the exp's shape and its device operations."""
    from torch.profiler import ProfilerActivity, profile

    trainer, seqs, generator, ent = warm
    perms = trainer.draw_permutations(seqs["mask"].shape[1], generator)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        trainer.train_phase(seqs, perms, 0.2, ent)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    by_kernel, count = {}, 0
    for ev in device_events(prof):
        by_kernel[ev.name] = by_kernel.get(ev.name, 0.0) + ev.time_range.elapsed_us() / 1e3
        count += 1
    device_ms = sum(by_kernel.values())
    updates = len(perms) * trainer.num_batches
    out = {
        "phase_wall_ms": wall_ms,
        "phase_device_ms": device_ms if device_ms > 0 else None,
        "device_busy_share": device_ms / wall_ms if device_ms > 0 else None,
        "device_operations": count,
        "device_operations_per_update": count / updates,
        "top_device_ms": sorted(by_kernel.items(), key=lambda kv: -kv[1])[:8],
    }
    print(f"[chip-smoke] rPPO train phase profile: {json.dumps(out)}", flush=True)
    return out


# -- the on-policy Anakin topology (phase 6c) -----------------------------------------------
# exp=ppo_anakin at the exp's settings: CartPole-v1, 64 envs x 128 steps,
# minibatches of 2048, 4 epochs (16 updates an iteration), width 64, the
# exp's 1,048,576 policy steps (128 iterations; ~40-55 s of the loop on the
# card); the bar is PPO's. The card's runs scored 500, 500 and 410 at
# 1,048,576 steps and 119 at 524,288, so the phase is not cut
ANAKIN_TOTAL_STEPS = 1048576
ANAKIN_STEPS_PER_ITER = 64 * 128
ANAKIN_RESUME_ITERS = 2
ANAKIN_TAGS = ("Loss/policy_loss", "Loss/value_loss", "Loss/entropy_loss", "Rewards/rew_avg",
               "Time/sps_env_interaction")
# exp=a2c_anakin: 64 envs x 5 steps, 200 iterations, then 2 more resumed
A2C_ANAKIN_STEPS_PER_ITER = 64 * 5
A2C_ANAKIN_TOTAL_STEPS = 200 * A2C_ANAKIN_STEPS_PER_ITER
# (a) the device env step on the card vs the CPU, each step from the CPU's
# state: the same float32 expressions, where the card's sin/cos may round a
# last ulp apart
ANAKIN_ENV_ATOL = 1e-5
ANAKIN_ENV_STEPS = 128
ANAKIN_ENV_ENVS = 64


def _anakin_programs(exp: str, devices, precision: str = "highest", overrides=()):
    """The exp's Anakin program (agent, optimizer and envs) on each device,
    the same weights from the exp's seed; and the cfg. ``precision`` None
    takes the config's ``float32_matmul_precision``."""
    from sheeprl_tpu_torch.algos.ppo.agent import build_agent
    from sheeprl_tpu_torch.algos.ppo.anakin import AnakinProgram, _minibatch_plan, build_optimizer
    from sheeprl_tpu_torch.config import compose
    from sheeprl_tpu_torch.envs import spaces
    from sheeprl_tpu_torch.envs.device import make_device_env
    from sheeprl_tpu_torch.parallel.fabric import Fabric

    cfg = compose([f"exp={exp}", *overrides])
    E, T = int(cfg.env.num_envs), int(cfg.algo.rollout_steps)
    programs = {}
    for accel in devices:
        fabric = Fabric(accelerator=accel, float32_matmul_precision=precision or cfg.float32_matmul_precision)
        env = make_device_env(cfg, E, fabric.device)
        spec = env.spec
        space = spaces.Dict({"state": spec.to_obs_space()})
        agent = build_agent(fabric, spec.action.actions_dim, spec.action.kind == "continuous", cfg, space, cfg.seed)
        _, minibatches, epochs = _minibatch_plan(cfg, E)
        optimizer, schedule = build_optimizer(cfg, agent, int(cfg.algo.total_steps) // (E * T), minibatches * epochs)
        programs[accel] = AnakinProgram(agent, env, cfg, optimizer, schedule, "state")
    return programs, cfg


def _on(tree, device):
    from sheeprl_tpu_torch.envs.device import AutoResetState

    if isinstance(tree, AutoResetState):
        return AutoResetState(*(x.to(device) for x in tree))
    if isinstance(tree, dict):
        return {k: _on(v, device) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_on(v, device) for v in tree]
    return tree.to(device)


def anakin_path(out_dir: str) -> dict:
    """``exp=ppo_anakin`` through the entry points on the card: ANAKIN_TOTAL_STEPS
    policy steps with the metric log and the test episode (its
    reward must reach PPO_MIN_TEST_REWARD), a resume into version_1 for two
    more iterations, an evaluation, and the checkpoint served through
    ``serve_main`` (4 slots, 4 greedy sessions). ``exp=a2c_anakin``: 200
    iterations (finite losses, a checkpoint), a resume, an evaluation. Anakin
    reaches no TPU kernel: the launch counts are read to show that."""
    from sheeprl_tpu_torch.cli import evaluation, run
    from sheeprl_tpu_torch.serve.main import serve_main

    out = {}
    overrides = ["exp=ppo_anakin", f"hydra.run.dir={os.path.join(out_dir, 'ppo_anakin')}"]
    _zero_launches()
    first = run(overrides + [f"algo.total_steps={ANAKIN_TOTAL_STEPS}"])
    out["train"] = {"summary": first, "launches": _launches()}
    scalars = check_scalars("ppo_anakin first run", first["log_dir"], ANAKIN_TAGS)
    out["train"]["scalars"] = {t: scalars[t][-1] for t in ANAKIN_TAGS}
    phase_s = first["rollout_seconds"] + first["train_seconds"]
    out["env_steps_per_s_in_the_loop"] = first["policy_steps"] / phase_s
    print(f"[chip-smoke] ppo_anakin first run: {first['iterations']} iterations, {first['policy_steps']} policy steps "
          f"in {first['wall_seconds']:.2f}s (rollout {first['rollout_seconds']:.2f}s, train "
          f"{first['train_seconds']:.2f}s on the card's clock: {out['env_steps_per_s_in_the_loop']:.0f} env steps/s); "
          f"test reward {first['test_reward']} (bar >= {PPO_MIN_TEST_REWARD}); losses {json.dumps(first['metrics'])}; "
          f"last Rewards/rew_avg {scalars['Rewards/rew_avg'][-1][1]:.1f}, Time/sps_env_interaction "
          f"{scalars['Time/sps_env_interaction'][-1][1]:.0f}", flush=True)
    if first["iterations"] != ANAKIN_TOTAL_STEPS // ANAKIN_STEPS_PER_ITER or first["updates_per_iter"] != 16:
        raise AssertionError(f"ppo_anakin took {first['iterations']} iterations of {first['updates_per_iter']} updates")
    if not all(math.isfinite(v) for v in first["metrics"].values()):
        raise AssertionError(f"ppo_anakin: non-finite losses {first['metrics']}")
    if not (first["test_reward"] is not None and first["test_reward"] >= PPO_MIN_TEST_REWARD):
        raise AssertionError(f"ppo_anakin: test reward {first['test_reward']} < {PPO_MIN_TEST_REWARD}")
    _zero_launches()
    resumed = run(overrides + [f"algo.total_steps={ANAKIN_TOTAL_STEPS + ANAKIN_RESUME_ITERS * ANAKIN_STEPS_PER_ITER}",
                               f"checkpoint.resume_from={first['checkpoint']}"])
    out["resume"] = {"summary": resumed, "launches": _launches()}
    print(f"[chip-smoke] ppo_anakin resumed run: {resumed['iterations']} iterations into {resumed['log_dir']}, "
          f"losses {json.dumps(resumed['metrics'])}", flush=True)
    if not (resumed["log_dir"].endswith("version_1") and resumed["iterations"] == ANAKIN_RESUME_ITERS
            and all(math.isfinite(v) for v in resumed["metrics"].values())):
        raise AssertionError(f"ppo_anakin resume: {resumed}")
    _zero_launches()
    reward = evaluation([f"checkpoint_path={resumed['checkpoint']}"])
    out["evaluation"] = {"reward": reward, "launches": _launches()}
    print(f"[chip-smoke] ppo_anakin evaluation: reward {reward}", flush=True)
    if not math.isfinite(reward):
        raise AssertionError(f"ppo_anakin evaluation: reward {reward}")
    log_dir = os.path.join(out_dir, "ppo_anakin_serve")
    _zero_launches()
    rc = serve_main([f"checkpoint_path={resumed['checkpoint']}", f"serve.slots={SLOTS}",
                     f"serve.sessions={SESSIONS}", f"serve.log_dir={log_dir}"])
    launches = _launches()
    with open(os.path.join(log_dir, "summary.json")) as f:
        summary = json.load(f)
    print(f"[chip-smoke] ppo_anakin serve rc={rc} summary={json.dumps(summary)} launches={launches}", flush=True)
    if rc != 0 or summary["sessions_completed"] != SESSIONS or summary["steps"] < SESSIONS:
        raise AssertionError(f"ppo_anakin serving did not complete every session: rc {rc}, {summary}")
    check_telemetry("ppo_anakin serve", log_dir)
    out["serve"] = {"summary": summary, "launches": launches}

    a2c_overrides = ["exp=a2c_anakin", f"hydra.run.dir={os.path.join(out_dir, 'a2c_anakin')}"]
    _zero_launches()
    a2c = run(a2c_overrides + [f"algo.total_steps={A2C_ANAKIN_TOTAL_STEPS}"])
    out["a2c_train"] = {"summary": a2c, "launches": _launches()}
    check_scalars("a2c_anakin run", a2c["log_dir"], ("Loss/policy_loss", "Loss/value_loss", "Rewards/rew_avg"))
    _zero_launches()
    a2c_resumed = run(a2c_overrides + [f"algo.total_steps={A2C_ANAKIN_TOTAL_STEPS + 2 * A2C_ANAKIN_STEPS_PER_ITER}",
                                       f"checkpoint.resume_from={a2c['checkpoint']}"])
    out["a2c_resume"] = {"summary": a2c_resumed, "launches": _launches()}
    _zero_launches()
    a2c_reward = evaluation([f"checkpoint_path={a2c_resumed['checkpoint']}"])
    out["a2c_evaluation"] = {"reward": a2c_reward, "launches": _launches()}
    print(f"[chip-smoke] a2c_anakin run: {a2c['iterations']} iterations in {a2c['wall_seconds']:.2f}s (rollout "
          f"{a2c['rollout_seconds']:.2f}s, train {a2c['train_seconds']:.2f}s), test reward {a2c['test_reward']}, "
          f"losses {json.dumps(a2c['metrics'])}; resumed {a2c_resumed['iterations']} iterations into "
          f"{a2c_resumed['log_dir']}; evaluation reward {a2c_reward}", flush=True)
    if not (a2c["checkpoint"] and os.path.isfile(a2c["checkpoint"])
            and all(math.isfinite(v) for v in {**a2c["metrics"], **a2c_resumed["metrics"]}.values())
            and a2c_resumed["log_dir"].endswith("version_1") and a2c_resumed["iterations"] == 2
            and math.isfinite(a2c_reward)):
        raise AssertionError(f"a2c_anakin: {a2c}, {a2c_resumed}, {a2c_reward}")
    stray = {name: r["launches"] for name, r in out.items() if isinstance(r, dict) and any(r["launches"].values())}
    if stray:
        raise AssertionError(f"an Anakin path launched a kernel it does not reach: {stray}")
    return out


def anakin_env_parity() -> dict:
    """(a) 128 steps of 64 CartPole envs and of 64 Pendulum envs on the card
    vs on the CPU, each step fed the CPU's state, action and reset state:
    observations and rewards within ANAKIN_ENV_ATOL, done and truncation
    flags equal. Pendulum truncates at 100 steps here, so that a truncation
    and its reset fall inside the 128 steps."""
    from sheeprl_tpu_torch.envs.device import AutoReset, CartPole, Pendulum

    res = {}
    for name, bare, limit in (("CartPole-v1", CartPole(), 500), ("Pendulum-v1", Pendulum(), 100)):
        envs = {dev: AutoReset(bare, ANAKIN_ENV_ENVS, dev, max_episode_steps=limit) for dev in ("cpu", "cuda")}
        g = torch.Generator().manual_seed(31)
        rng = np.random.default_rng(32)
        state, _ = envs["cpu"].reset(g)
        worst = {"obs": 0.0, "reward": 0.0, "terminal_observation": 0.0}
        flags_equal, dones = True, 0
        for _ in range(ANAKIN_ENV_STEPS):
            if bare.spec.action.kind == "discrete":
                action = torch.from_numpy(rng.integers(0, 2, ANAKIN_ENV_ENVS))
            else:
                action = torch.from_numpy(rng.uniform(-2.5, 2.5, (ANAKIN_ENV_ENVS, 1)).astype(np.float32))
            reset = envs["cpu"].draw_resets(1, g)[0]
            cpu = envs["cpu"].step(state, action, reset)
            card = envs["cuda"].step(_on(state, "cuda"), action.cuda(), reset.cuda())
            for key, a, b in (("obs", card[1], cpu[1]), ("reward", card[2], cpu[2]),
                              ("terminal_observation", card[4]["terminal_observation"],
                               cpu[4]["terminal_observation"])):
                worst[key] = max(worst[key], float((a.cpu() - b).abs().max()))
            flags_equal &= bool(torch.equal(card[3].cpu(), cpu[3]))
            for key in ("terminated", "truncated", "episode_length"):
                flags_equal &= bool(torch.equal(card[4][key].cpu(), cpu[4][key]))
            dones += int(cpu[3].sum())
            state = cpu[0]
        res[name] = {"max_abs_err": worst, "flags_equal": flags_equal, "dones": dones}
    print(f"[chip-smoke] device env step card vs CPU ({ANAKIN_ENV_STEPS} steps x {ANAKIN_ENV_ENVS} envs, each from "
          f"the CPU's state): {json.dumps(res)} (bar {ANAKIN_ENV_ATOL}, flags equal)", flush=True)
    for name, r in res.items():
        if not (max(r["max_abs_err"].values()) <= ANAKIN_ENV_ATOL and r["flags_equal"] and r["dones"] > 0):
            raise AssertionError(f"the {name} device env on the card disagrees with the CPU: {r}")
    return res


def anakin_train_parity() -> dict:
    """(b) one PPO and one A2C Anakin train phase at the exps' shapes on the
    card vs on the CPU (TF32 off), from the same weights, trajectory (a
    rollout of the CPU program, its episodes truncated at 16 or 3 steps),
    bootstrap observation and round keys: the truncation bootstrap, GAE and
    every update. PPO's bars: the mean losses
    within PPO_LOSS_RTOL relative, every parameter within PPO_PARAM_ATOL."""
    res = {}
    # step budgets shorter than the rollouts (128 and 5 steps), so that the
    # truncation bootstrap has truncated rows
    for exp, budget in (("ppo_anakin", 16), ("a2c_anakin", 3)):
        programs, cfg = _anakin_programs(exp, ("gpu", "cpu"), overrides=[f"env.max_episode_steps={budget}"])
        cpu = programs["cpu"]
        g = torch.Generator().manual_seed(41)
        inputs = cpu.draw_inputs(g)
        env_state, obs = cpu.env.reset(g)
        _, obs, traj, _ = cpu.rollout(env_state, obs, inputs["noise"], inputs["resets"])
        out = {}
        for accel, p in programs.items():
            t, o = _on(traj, p.device), obs.to(p.device)
            returns, advantages = p.returns(t, p.values(o))
            losses = p.train(t, returns, advantages, _on(inputs["orders"], p.device), 0.2,
                             float(cfg.algo.get("ent_coef", 0.0)))
            out[accel] = (losses.cpu(), [q.detach().cpu() for q in p.params])
        loss_gap = float(((out["gpu"][0] - out["cpu"][0]).abs() / out["cpu"][0].abs().clamp_min(1e-3)).max())
        param_gap = max(float((a - b).abs().max()) for a, b in zip(out["gpu"][1], out["cpu"][1]))
        res[exp] = {"losses_rel_gap": loss_gap, "param_max_abs_gap": param_gap, "card": out["gpu"][0].tolist(),
                    "cpu": out["cpu"][0].tolist(), "updates": cpu.updates_per_iter,
                    "truncated_rows": int(traj["truncated"].sum()), "rows": cpu.num_rows}
    print(f"[chip-smoke] Anakin train phases card vs CPU (TF32 off): {json.dumps(res)} (bars: losses {PPO_LOSS_RTOL} "
          f"relative, every parameter {PPO_PARAM_ATOL})", flush=True)
    for exp, r in res.items():
        if not (r["losses_rel_gap"] <= PPO_LOSS_RTOL and r["param_max_abs_gap"] <= PPO_PARAM_ATOL):
            raise AssertionError(f"the {exp} train phase on the card disagrees with the CPU: {r}")
    return res


def anakin_step_parity() -> dict:
    """(c) one whole ``exp=ppo_anakin`` iteration (64 envs x 128 steps, 16
    updates) on the card vs on the CPU (TF32 off) from the same weights,
    envs and draws. A finding, not a gate: CartPole's dynamics grow a one-ulp
    ``sin``/``cos`` gap until an action flips. Reports the first step where
    the trajectories part (``None`` when they do not), and the gaps after."""
    programs, cfg = _anakin_programs("ppo_anakin", ("gpu", "cpu"))
    cpu = programs["cpu"]
    g = torch.Generator().manual_seed(51)
    inputs = cpu.draw_inputs(g)
    env_state, obs = cpu.env.reset(g)
    outs = {accel: p.step(_on(env_state, p.device), obs.to(p.device), _on(inputs, p.device), 0.2, 0.0)
            for accel, p in programs.items()}
    card, host = outs["gpu"], outs["cpu"]
    parted = (card.traj["actions"].cpu() != host.traj["actions"]).flatten(1).any(dim=1)
    first = int(torch.nonzero(parted)[0]) if bool(parted.any()) else None
    obs_gap = (card.traj["state"].cpu() - host.traj["state"]).abs().flatten(1).max(dim=1).values
    res = {
        "first_parted_step": first,
        "steps": int(cfg.algo.rollout_steps),
        "parted_steps": int(parted.sum()),
        "obs_max_abs_gap_at_step": {str(t): float(obs_gap[t]) for t in (0, 15, 31, 63, 127)},
        "losses_rel_gap": float(((card.losses.cpu() - host.losses).abs() / host.losses.abs().clamp_min(1e-3)).max()),
        "param_max_abs_gap": max(float((a.detach().cpu() - b.detach()).abs().max())
                                 for a, b in zip(programs["gpu"].params, cpu.params)),
    }
    print(f"[chip-smoke] ppo_anakin iteration card vs CPU (TF32 off, a finding): {json.dumps(res)}", flush=True)
    return res


def anakin_syncs() -> dict:
    """Host syncs of one ``exp=ppo_anakin`` iteration on the card, counted
    under ``torch.cuda.set_sync_debug_mode('warn')`` after a warm iteration:
    the draws, the rollout's step loop (the bar is 0) and the train phase."""
    import warnings

    programs, _ = _anakin_programs("ppo_anakin", ("gpu",), precision=None)
    p = programs["gpu"]
    g = torch.Generator(device=p.device).manual_seed(61)
    env_state, obs = p.env.reset(g)
    out = p.step(env_state, obs, p.draw_inputs(g), 0.2, 0.0)
    env_state, obs = out.env_state, out.obs
    torch.cuda.synchronize()
    counts = {}
    torch.cuda.set_sync_debug_mode("warn")
    try:
        def count(name, fn):
            with warnings.catch_warnings(record=True) as caught:
                warnings.simplefilter("always")
                result = fn()
            counts[name] = sum("synchroniz" in str(w.message) for w in caught)
            return result

        inputs = count("draws", lambda: p.draw_inputs(g))
        env_state, obs, traj, _ = count("rollout", lambda: p.rollout(env_state, obs, inputs["noise"],
                                                                     inputs["resets"]))
        count("train", lambda: p.train(traj, *p.returns(traj, p.values(obs)), inputs["orders"], 0.2, 0.0))
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    print(f"[chip-smoke] ppo_anakin host syncs in one iteration: {json.dumps(counts)} (bar: 0 in the rollout)",
          flush=True)
    if counts["rollout"] != 0:
        raise AssertionError(f"the Anakin rollout's step loop synchronised with the host: {counts}")
    return counts


def deterministic_step(kind: str) -> dict:
    """One step of ``kind``'s family on the card with ``xla_deterministic_ops``
    on (``Fabric(deterministic_ops=True)``'s switches), from its parity
    builders; the switches are off again afterwards. Returns the step's
    outcome: ``ok``, or the error an op with no deterministic kernel raised."""
    from sheeprl_tpu_torch.parallel.fabric import apply_deterministic_ops

    def dreamer():
        T, B = 16, 4
        if kind == "dv3":
            trainers, batch = _s_trainers(("gpu",), T, B)
        else:
            trainers, batch = _family_trainers(kind, ("gpu",), T, B)
        trainer = trainers["gpu"]
        noise = trainer.draw_noise(T, B, torch.Generator(device=trainer.device).manual_seed(1))
        apply_deterministic_ops(True)
        return trainer.train_step({k: v.to(trainer.device) for k, v in batch.items()}, 0,
                                  _noise_to(noise, trainer.device, trainer.agent.dtype))

    def sac_family():
        trainers, cfg = _sac_trainers(kind, ("gpu",))
        trainer, B = trainers["gpu"], int(cfg.algo.per_rank_batch_size)
        rng = np.random.default_rng(12)
        block, actor_block = _replay_block(rng, (SAC_PARITY_G, B)), _replay_block(rng, (B,))
        noise = trainer.draw_noise(SAC_PARITY_G, B, torch.Generator(device=trainer.device).manual_seed(13))
        apply_deterministic_ops(True)
        return _run_phase(kind, trainer, block, actor_block, noise)

    def sac_ae():
        trainers, cfg = _sac_ae_trainers(("gpu",))
        trainer = trainers["gpu"]
        block = _sac_ae_block(np.random.default_rng(17), 1, SAC_AE_PARITY_B)
        data = _on({k: torch.from_numpy(v) for k, v in block.items()}, trainer.device)
        noise = trainer.draw_noise(1, data, torch.Generator(device=trainer.device).manual_seed(18))
        apply_deterministic_ops(True)
        return trainer.train_phase(data, 0, _noise_to(noise, trainer.device, trainer.dtype))

    def ppo():
        agents, cfg = _on_policy_agents("ppo", ("gpu",))
        trainer = _ppo_trainer(agents["gpu"], cfg)
        data, next_values = _ppo_rollout(1)
        perms = trainer.draw_permutations(torch.Generator().manual_seed(2))
        apply_deterministic_ops(True)
        return trainer.train_phase(_on({k: torch.from_numpy(v) for k, v in data.items()}, trainer.device),
                                   torch.from_numpy(next_values).to(trainer.device), perms, 0.2, 0.0)

    def a2c():
        from sheeprl_tpu_torch.algos.a2c.a2c import A2CTrainer
        from sheeprl_tpu_torch.config import instantiate

        agents, cfg = _on_policy_agents("a2c", ("gpu",))
        agent = agents["gpu"]
        trainer = A2CTrainer(agent, instantiate(cfg.algo.optimizer, agent.parameters()), cfg)
        data, next_values = _ppo_rollout(3, T=int(cfg.algo.rollout_steps))
        data.pop("logprobs")
        apply_deterministic_ops(True)
        dev = next(agent.parameters()).device
        return trainer.train_phase(_on({k: torch.from_numpy(v) for k, v in data.items()}, dev),
                                   torch.from_numpy(next_values).to(dev))

    def rppo():
        trainers, cfg = _rppo_trainers(("gpu",))
        trainer = trainers["gpu"]
        seqs = _rppo_block(21)
        perms = trainer.draw_permutations(seqs["mask"].shape[1], torch.Generator().manual_seed(22))
        apply_deterministic_ops(True)
        return trainer.train_phase(seqs, perms, 0.2, float(cfg.algo.ent_coef))

    def anakin():
        programs, cfg = _anakin_programs(kind, ("gpu",))
        p = programs["gpu"]
        g = torch.Generator(device=p.device).manual_seed(71)
        env_state, obs = p.env.reset(g)
        apply_deterministic_ops(True)
        return p.step(env_state, obs, p.draw_inputs(g), 0.2, 0.0).losses

    def sac_anakin():
        programs, _ = _sac_anakin_programs("sac_anakin", ("gpu",), overrides=SAC_ANAKIN_SMALL)
        p, ring = programs["gpu"]
        g = torch.Generator(device=p.device).manual_seed(131)
        env_state, obs = p.env.reset(g)
        apply_deterministic_ops(True)
        return p.step(env_state, obs, ring, p.draw_inputs(g), 1).losses

    steps = {"sac": sac_family, "droq": sac_family, "sac_ae": sac_ae, "ppo": ppo, "a2c": a2c, "ppo_recurrent": rppo,
             "ppo_anakin": anakin, "a2c_anakin": anakin, "sac_anakin": sac_anakin}
    try:
        out = steps.get(kind, dreamer)()
        enabled = torch.are_deterministic_algorithms_enabled()
        torch.cuda.synchronize()
        values = out.values() if isinstance(out, dict) else [out]
        finite = all(bool(torch.isfinite(torch.as_tensor(v)).all()) for v in values)
        res = {"ok": bool(enabled and finite), "deterministic": enabled, "finite": finite}
    except RuntimeError as exc:
        res = {"ok": False, "error": str(exc).splitlines()[0][:300]}
    finally:
        apply_deterministic_ops(False)
    print(f"[chip-smoke] {kind} step with xla_deterministic_ops on: {json.dumps(res)}", flush=True)
    return res


def time_anakin(iters: int = 2) -> tuple:
    """Env steps/s of the Anakin loop's iteration on the card, TF32 as the
    config sets it: at ``exp=ppo_anakin`` (64 envs x 128 steps, 16 updates)
    and at ``exp=ppo_anakin_benchmarks``' width (8192 envs x 128 steps =
    1,048,576 rows, 64 minibatches of 16,384, 1 epoch); ``iters`` iterations
    after a warm one, on the host's clock synchronised at both ends, with the
    rollout/train split from the loop's CUDA events. Returns the timings and
    the warm programs with their carries, for the profile."""
    from sheeprl_tpu_torch.algos.ppo.anakin import PhaseClock

    out, warm = {}, {}
    for exp in ("ppo_anakin", "ppo_anakin_benchmarks"):
        programs, cfg = _anakin_programs(exp, ("gpu",), precision=None)
        p = programs["gpu"]
        g = torch.Generator(device=p.device).manual_seed(81)
        env_state, obs = p.env.reset(g)
        clock = PhaseClock(p.device)
        o = p.step(env_state, obs, p.draw_inputs(g), 0.2, 0.0)  # warm-up
        env_state, obs = o.env_state, o.obs
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(iters):
            o = p.step(env_state, obs, p.draw_inputs(g), 0.2, 0.0, clock)
            env_state, obs = o.env_state, o.obs
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        rollout, train = clock.read()
        steps = iters * p.num_rows
        out[exp] = {"envs": p.num_envs, "steps_per_iter": p.num_rows, "updates_per_iter": p.updates_per_iter,
                    "iterations": iters, "env_steps_per_s": steps / wall, "wall_s_per_iter": wall / iters,
                    "rollout_s_per_iter": rollout / iters, "train_s_per_iter": train / iters,
                    "peak_device_bytes": torch.cuda.max_memory_allocated()}
        warm[exp] = (p, g, env_state, obs)
    print(f"[chip-smoke] Anakin timing: {json.dumps(out)}", flush=True)
    return out, warm


def profile_anakin(warm: dict) -> dict:
    """Under torch.profiler (last), one Anakin iteration at each timed width:
    its device operations, device time and the card's busy share."""
    from torch.profiler import ProfilerActivity, profile

    out = {}
    for exp, (p, g, env_state, obs) in warm.items():
        inputs = p.draw_inputs(g)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            p.step(env_state, obs, inputs, 0.2, 0.0)
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
        by_kernel, count = {}, 0
        for ev in device_events(prof):
            by_kernel[ev.name] = by_kernel.get(ev.name, 0.0) + ev.time_range.elapsed_us() / 1e3
            count += 1
        device_ms = sum(by_kernel.values())
        out[exp] = {
            "iteration_wall_ms": wall_ms,
            "iteration_device_ms": device_ms if device_ms > 0 else None,
            "device_busy_share": device_ms / wall_ms if device_ms > 0 else None,
            "device_operations": count,
            "top_device_ms": sorted(by_kernel.items(), key=lambda kv: -kv[1])[:8],
        }
    print(f"[chip-smoke] Anakin iteration profile: {json.dumps(out)}", flush=True)
    return out


# SAC on Pendulum-v1 at the exp's settings (hidden 256 for the actor and the
# 2 critics, batch 256, replay ratio 1, learning_starts 100, 4 envs): 6,000
# policy steps (1,500 iterations, ~6,000 gradient steps), cut from 12,000 to
# keep the whole smoke inside its time limit on a slow host. On the CPU
# three seeds' runs of 12,000 steps ended with test rewards of -3 to -122,
# and runs of 6,000 steps with -121, -3 and -120 (seeds 42, 1, 2); the card's
# 12,000-step run averaged -142 over its episodes from step 5,000 to 10,000.
# Random play scores about -1,200 and a solved policy about -150. The card's
# float32 rounding takes another trajectory, so the bar sits well below the
# CPU's results and well above random play
SAC_TOTAL_STEPS = 6000
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
    train SAC_TOTAL_STEPS policy steps with the config's defaults (video warned,
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
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
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


# -- the off-policy Anakin topology (phase 7b) ----------------------------------------------
# exp=sac_anakin at the exp's widths: Pendulum-v1, 64 envs x 64 steps, hidden
# 256, batch 256, G = 256 gradient steps an iteration, a ring of 4096 rows x 64
# envs (buffer.size 262,144). Cut from the exp's 262,144 policy steps (64
# iterations) to 98,304 (24 iterations, 6,144 gradient steps), to keep the
# smoke inside its time limit. On the CPU (sac_anakin_step_cut.py, seeds 42 and
# 1-5) every seed's greedy test reached -400 at every checkpoint from 90,112
# steps to 131,072 (the worst -347.6); before that, seed 2's fell back to -916
# at 81,920 after passing at 49,152 and 73,728 (PERF.md §4). The bar is phase 7's
SAC_ANAKIN_TOTAL_STEPS = 98304
SAC_ANAKIN_STEPS_PER_ITER = 64 * 64
SAC_ANAKIN_GRAD_STEPS = 256
SAC_ANAKIN_RING_ROWS = 4096
SAC_ANAKIN_RESUME_ITERS = 2
SAC_ANAKIN_TAGS = ("Loss/value_loss", "Loss/policy_loss", "Loss/alpha_loss", "Rewards/rew_avg",
                   "Time/sps_env_interaction")
# (b)'s small shape at the exp's widths: 16 envs x 16 steps, G = 4 (as
# sac_train_phase_parity's), a ring of 256 rows; episodes truncated at 10
# steps, so that the iteration ends some
SAC_ANAKIN_SMALL = ("env.num_envs=16", "algo.rollout_steps=16", "algo.replay_ratio=0.015625", "buffer.size=4096",
                    "env.max_episode_steps=10")


def _sac_anakin_programs(exp: str, devices, precision: str = "highest", overrides=(), scale_heads: bool = True):
    """The exp's SAC Anakin program and an empty ring on each device, the same
    weights from the exp's seed (the actor's heads scaled by 0.1 for the
    parity phases, as in ``_sac_trainers``); and the cfg. ``precision`` None
    takes the config's ``float32_matmul_precision``."""
    from sheeprl_tpu_torch.algos.sac.agent import build_agent
    from sheeprl_tpu_torch.algos.sac.anakin import SACAnakinProgram, ring_row_specs
    from sheeprl_tpu_torch.algos.sac.sac import SACTrainer, build_optimizers
    from sheeprl_tpu_torch.config import compose
    from sheeprl_tpu_torch.data.device_ring import ring_capacity, ring_init
    from sheeprl_tpu_torch.envs import spaces
    from sheeprl_tpu_torch.envs.device import make_device_env
    from sheeprl_tpu_torch.parallel.fabric import Fabric

    cfg = compose([f"exp={exp}", *overrides])
    E, T = int(cfg.env.num_envs), int(cfg.algo.rollout_steps)
    capacity = ring_capacity(int(cfg.buffer.size), E)
    programs = {}
    for accel in devices:
        fabric = Fabric(accelerator=accel, float32_matmul_precision=precision or cfg.float32_matmul_precision)
        env = make_device_env(cfg, E, fabric.device)
        spec = env.spec
        agent = build_agent(fabric, cfg, spaces.Dict({"state": spec.to_obs_space()}), spec.action.to_space(), cfg.seed)
        if scale_heads:
            with torch.no_grad():
                agent.actor.fc_mean.weight.mul_(0.1)
                agent.actor.fc_logstd.weight.mul_(0.1)
        trainer = SACTrainer(agent, build_optimizers(cfg, agent), cfg, -1.0, T * E)
        program = SACAnakinProgram(trainer, env, cfg, int(cfg.algo.per_rank_batch_size))
        programs[accel] = (program, ring_init(capacity, E, ring_row_specs(3, 1), fabric.device))
    return programs, cfg


def sac_anakin_path(out_dir: str) -> dict:
    """``exp=sac_anakin`` through the entry points on the card:
    SAC_ANAKIN_TOTAL_STEPS policy steps with the metric log and the test
    episode (its reward must reach SAC_MIN_TEST_REWARD), the checkpoint's ring
    twin at the cursor and fill of the iterations run, and a resume into
    version_1 for two more iterations with the ring. The JAX package
    registers no evaluation or serving for sac_anakin, so there is none. The
    path reaches no TPU kernel: the launch counts are read to show that."""
    from sheeprl_tpu_torch.cli import run
    from sheeprl_tpu_torch.utils.checkpoint import load_checkpoint

    out = {}
    overrides = ["exp=sac_anakin", f"hydra.run.dir={os.path.join(out_dir, 'sac_anakin')}"]
    _zero_launches()
    first = run(overrides + [f"algo.total_steps={SAC_ANAKIN_TOTAL_STEPS}"])
    out["train"] = {"summary": first, "launches": _launches()}
    scalars = check_scalars("sac_anakin first run", first["log_dir"], SAC_ANAKIN_TAGS)
    out["train"]["scalars"] = {t: scalars[t][-1] for t in SAC_ANAKIN_TAGS}
    out["train"]["rew_avg_curve"] = scalars["Rewards/rew_avg"]
    phase_s = first["rollout_seconds"] + first["ring_seconds"] + first["train_seconds"]
    out["env_steps_per_s_in_the_loop"] = first["policy_steps"] / phase_s
    out["seconds_per_gradient_step_in_the_loop"] = first["train_seconds"] / first["gradient_steps"]
    print(f"[chip-smoke] sac_anakin first run: {first['iterations']} iterations of {first['grad_steps_per_iter']} "
          f"gradient steps, {first['policy_steps']} policy steps in {first['wall_seconds']:.2f}s (rollout "
          f"{first['rollout_seconds']:.2f}s, ring {first['ring_seconds']:.2f}s, train {first['train_seconds']:.2f}s "
          f"on the card's clock: {out['env_steps_per_s_in_the_loop']:.0f} env steps/s); test reward "
          f"{first['test_reward']} (bar >= {SAC_MIN_TEST_REWARD}); losses {json.dumps(first['metrics'])}; "
          f"Rewards/rew_avg {[(s, round(v, 1)) for s, v in scalars['Rewards/rew_avg']]}", flush=True)
    iterations = SAC_ANAKIN_TOTAL_STEPS // SAC_ANAKIN_STEPS_PER_ITER
    if first["iterations"] != iterations or first["grad_steps_per_iter"] != SAC_ANAKIN_GRAD_STEPS:
        raise AssertionError(f"sac_anakin took {first['iterations']} iterations of {first['grad_steps_per_iter']} steps")
    if not all(math.isfinite(v) for v in first["metrics"].values()):
        raise AssertionError(f"sac_anakin: non-finite losses {first['metrics']}")
    if not (first["test_reward"] is not None and first["test_reward"] >= SAC_MIN_TEST_REWARD):
        raise AssertionError(f"sac_anakin: test reward {first['test_reward']} < {SAC_MIN_TEST_REWARD}")
    # the ring's twin in the last checkpoint: 64 rows an iteration
    rb = load_checkpoint(first["checkpoint"])["rb"]
    rows = iterations * 64
    twin = {"pos": rb._pos, "full": rb.full, "rows": rb.buffer_size, "envs": rb.n_envs}
    out["train"]["twin"] = twin
    expected = {"pos": rows % SAC_ANAKIN_RING_ROWS, "full": rows >= SAC_ANAKIN_RING_ROWS,
                "rows": SAC_ANAKIN_RING_ROWS, "envs": 64}
    if twin != expected or (first["ring_pos"], first["ring_fill"]) != (rows % SAC_ANAKIN_RING_ROWS,
                                                                       min(rows, SAC_ANAKIN_RING_ROWS)):
        raise AssertionError(f"sac_anakin: the checkpoint's ring twin {twin} != {expected}, ring {first['ring_pos']}, "
                             f"{first['ring_fill']}")
    _zero_launches()
    resumed = run(overrides + [
        f"algo.total_steps={SAC_ANAKIN_TOTAL_STEPS + SAC_ANAKIN_RESUME_ITERS * SAC_ANAKIN_STEPS_PER_ITER}",
        f"checkpoint.resume_from={first['checkpoint']}"])
    out["resume"] = {"summary": resumed, "launches": _launches()}
    rows += SAC_ANAKIN_RESUME_ITERS * 64
    print(f"[chip-smoke] sac_anakin resumed run: {resumed['iterations']} iterations into {resumed['log_dir']}, ring "
          f"at {resumed['ring_pos']} (fill {resumed['ring_fill']}), test reward {resumed['test_reward']}, losses "
          f"{json.dumps(resumed['metrics'])}", flush=True)
    if not (resumed["log_dir"].endswith("version_1") and resumed["iterations"] == SAC_ANAKIN_RESUME_ITERS
            and resumed["ring_pos"] == rows % SAC_ANAKIN_RING_ROWS
            and all(math.isfinite(v) for v in resumed["metrics"].values())):
        raise AssertionError(f"sac_anakin resume: {resumed}")
    stray = {name: out[name]["launches"] for name in ("train", "resume") if any(out[name]["launches"].values())}
    if stray:
        raise AssertionError(f"the sac_anakin path launched a kernel it does not reach: {stray}")
    return out


def sac_anakin_ring_parity() -> dict:
    """(a) the ring's write and sample at the exp's shape on the card vs on the
    CPU: 64-row blocks of 64 envs written into a ring of 4096 rows x 64 envs
    (262,144 slots), then 65,536 draws (G x batch) from the same round keys,
    on the fill ramp (3 blocks) and after a wrap (71 blocks). Every row
    carries its own slot number, so equal draws mean equal indices; the rings,
    cursors, fills and draws must be bitwise equal. Also the card's ms of one
    write and of one sample (CUDA events, 20 calls)."""
    from sheeprl_tpu_torch.algos.sac.anakin import ring_row_specs
    from sheeprl_tpu_torch.data.device_ring import ring_init, ring_sample, ring_write
    from sheeprl_tpu_torch.utils.prp import draw_round_keys

    T, E, B, G = 64, 64, 256, SAC_ANAKIN_GRAD_STEPS
    specs = {**ring_row_specs(3, 1), "slot": ((1,), torch.float32)}
    devices = {"card": "cuda", "cpu": "cpu"}
    rings = {side: ring_init(SAC_ANAKIN_RING_ROWS, E, specs, dev) for side, dev in devices.items()}
    rng = np.random.default_rng(91)
    g = torch.Generator().manual_seed(92)
    res, written = {}, 0
    for label, blocks in (("fill_ramp", 3), ("wrapped", 68)):
        for _ in range(blocks):
            rows = {k: torch.from_numpy(rng.standard_normal((T, E, *shape)).astype(np.float32))
                    for k, (shape, _) in ring_row_specs(3, 1).items()}
            # the slot numbers stay below 2^24, exact in float32
            rows["slot"] = torch.arange(written * E, (written + T) * E, dtype=torch.float32).reshape(T, E, 1)
            written += T
            for side, ring in rings.items():
                ring_write(ring, {k: v.to(devices[side]) for k, v in rows.items()})
        keys = draw_round_keys(1, g, "cpu")[0]
        draws = {side: ring_sample(ring, keys.to(devices[side]), B, G) for side, ring in rings.items()}
        slots = draws["cpu"]["slot"].reshape(-1)
        res[label] = {
            "rows_written": written, "pos": rings["card"]["pos"], "fill": rings["card"]["fill"],
            "ring_equal": all(torch.equal(rings["card"]["data"][k].cpu(), rings["cpu"]["data"][k]) for k in specs)
            and (rings["card"]["pos"], rings["card"]["fill"]) == (rings["cpu"]["pos"], rings["cpu"]["fill"]),
            "indices_equal": torch.equal(draws["card"]["slot"].cpu(), draws["cpu"]["slot"]),
            "draws_equal": all(torch.equal(draws["card"][k].cpu(), draws["cpu"][k]) for k in specs),
            "draws": int(slots.numel()), "distinct_slots": int(torch.unique(slots).numel()),
            "oldest_slot_drawn": float(slots.min()), "newest_slot_drawn": float(slots.max()),
        }
    ring = rings["card"]
    rows = {k: v.to(devices["card"]) for k, v in rows.items()}
    keys = keys.to(devices["card"])
    timing = {}
    for name, fn in (("write", lambda: ring_write(ring, rows)), ("sample", lambda: ring_sample(ring, keys, B, G))):
        fn()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(20):
            fn()
        end.record()
        end.synchronize()
        timing[f"{name}_ms"] = start.elapsed_time(end) / 20
    res["card_timing"] = timing
    print(f"[chip-smoke] device ring card vs CPU (4096 rows x 64 envs, {B * G} draws): {json.dumps(res)} "
          "(bar: bitwise equal)", flush=True)
    for label in ("fill_ramp", "wrapped"):
        r = res[label]
        if not (r["ring_equal"] and r["indices_equal"] and r["draws_equal"]):
            raise AssertionError(f"the device ring on the card disagrees with the CPU ({label}): {r}")
    return res


def sac_anakin_step_parity(overrides=SAC_ANAKIN_SMALL, gate: bool = True) -> dict:
    """One whole SAC Anakin iteration (rollout, ring write and sample, G
    gradient steps) on the card vs on the CPU (TF32 off), from the same
    weights (the actor's heads scaled by 0.1), env state, empty ring and
    draws. (b) at SAC_ANAKIN_SMALL's shape, within SAC's train-phase bars
    (the mean losses within SAC_LOSS_RTOL relative, every parameter within
    SAC_PARAM_ATOL); (c) with no overrides, at the exp's shape, a finding:
    where the rollouts part (the largest action gap by step) and the gaps
    after the G steps."""
    programs, cfg = _sac_anakin_programs("sac_anakin", ("gpu", "cpu"), overrides=overrides)
    cpu = programs["cpu"][0]
    g = torch.Generator().manual_seed(101)
    inputs = cpu.draw_inputs(g)
    env_state, obs = cpu.env.reset(g)
    outs = {accel: p.step(_on(env_state, p.device), obs.to(p.device), ring, _on(inputs, p.device), 1)
            for accel, (p, ring) in programs.items()}
    card, host = outs["gpu"], outs["cpu"]
    action_gap = (card.traj["actions"].cpu() - host.traj["actions"]).abs().flatten(1).max(dim=1).values
    T = int(cfg.algo.rollout_steps)
    res = {
        "envs": cpu.num_envs, "steps": T, "grad_steps": cpu.grad_steps, "batch": cpu.batch_size,
        "action_max_abs_gap_at_step": {str(t): float(action_gap[t]) for t in sorted({0, T // 4, T // 2, T - 1})},
        "ring_max_abs_gap": max(float((card.ring["data"][k].cpu() - host.ring["data"][k]).abs().max())
                                for k in host.ring["data"]),
        "flags_equal": all(torch.equal(card.traj[k].cpu(), host.traj[k]) for k in ("terminated", "truncated")),
        "batch_max_abs_gap": max(float((card.batch[k].cpu() - host.batch[k]).abs().max()) for k in host.batch),
        "ep_stats_card": card.ep_stats.tolist(), "ep_stats_cpu": host.ep_stats.tolist(),
        "losses_rel_gap": float(((card.losses.cpu() - host.losses).abs() / host.losses.abs().clamp_min(1e-3)).max()),
        "param_max_abs_gap": max(float((a.detach().cpu() - b.detach()).abs().max())
                                 for a, b in zip(programs["gpu"][0].trainer.agent.parameters(),
                                                 cpu.trainer.agent.parameters())),
        "card": card.losses.tolist(), "cpu": host.losses.tolist(),
    }
    what = "(b), bars: losses {} relative, every parameter {}".format(SAC_LOSS_RTOL, SAC_PARAM_ATOL) if gate \
        else "(c), a finding"
    print(f"[chip-smoke] sac_anakin iteration card vs CPU (TF32 off) {what}: {json.dumps(res)}", flush=True)
    if gate and not (res["losses_rel_gap"] <= SAC_LOSS_RTOL and res["param_max_abs_gap"] <= SAC_PARAM_ATOL
                     and res["flags_equal"]):
        raise AssertionError(f"the sac_anakin iteration on the card disagrees with the CPU: {res}")
    return res


def sac_anakin_syncs() -> dict:
    """Host syncs of one ``exp=sac_anakin`` iteration on the card by part,
    counted under ``torch.cuda.set_sync_debug_mode('warn')`` after a warm
    iteration: the draws, the rollout, the ring write, the ring sample and
    the G gradient steps (the bar is 0 in all but the draws)."""
    import warnings

    from sheeprl_tpu_torch.data.device_ring import ring_sample, ring_write

    programs, _ = _sac_anakin_programs("sac_anakin", ("gpu",), precision=None, scale_heads=False)
    p, ring = programs["gpu"]
    g = torch.Generator(device=p.device).manual_seed(111)
    env_state, obs = p.env.reset(g)
    out = p.step(env_state, obs, ring, p.draw_inputs(g), 1)
    env_state, obs = out.env_state, out.obs
    torch.cuda.synchronize()
    counts = {}
    torch.cuda.set_sync_debug_mode("warn")
    try:
        def count(name, fn):
            with warnings.catch_warnings(record=True) as caught:
                warnings.simplefilter("always")
                result = fn()
            counts[name] = sum("synchroniz" in str(w.message) for w in caught)
            return result

        inputs = count("draws", lambda: p.draw_inputs(g))
        env_state, obs, traj, _ = count("rollout", lambda: p.rollout(env_state, obs, inputs["noise"],
                                                                     inputs["resets"]))
        count("ring_write", lambda: ring_write(ring, traj))
        batch = count("ring_sample", lambda: ring_sample(ring, inputs["round_keys"], p.batch_size, p.grad_steps))
        count("train", lambda: p.trainer.train_phase(batch, 2, inputs["train"]))
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    print(f"[chip-smoke] sac_anakin host syncs in one iteration: {json.dumps(counts)} (bar: 0 in the rollout, the "
          "ring write, the ring sample and the train phase)", flush=True)
    if any(counts[k] for k in ("rollout", "ring_write", "ring_sample", "train")):
        raise AssertionError(f"the sac_anakin iteration synchronised with the host: {counts}")
    return counts


def time_sac_anakin(iters: int = 2) -> tuple:
    """Seconds per iteration and env steps/s of the SAC Anakin loop's
    iteration on the card, TF32 as the config sets it: at ``exp=sac_anakin``
    (64 envs x 64 steps, G = 256, batch 256) and at
    ``exp=sac_anakin_benchmarks`` (512 envs x 64 steps, G = 8, a ring of 512 x
    512); ``iters`` iterations after a warm one, on the host's clock
    synchronised at both ends, with the rollout/ring/train split from the
    loop's CUDA events. Returns the timings and the warm programs with their
    carries, for the profile."""
    from sheeprl_tpu_torch.algos.ppo.anakin import PhaseClock

    out, warm = {}, {}
    for exp in ("sac_anakin", "sac_anakin_benchmarks"):
        programs, cfg = _sac_anakin_programs(exp, ("gpu",), precision=None, scale_heads=False)
        p, ring = programs["gpu"]
        g = torch.Generator(device=p.device).manual_seed(121)
        env_state, obs = p.env.reset(g)
        clock = PhaseClock(p.device, parts=3)
        o = p.step(env_state, obs, ring, p.draw_inputs(g), 1)  # warm-up
        env_state, obs = o.env_state, o.obs
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for i in range(iters):
            o = p.step(env_state, obs, ring, p.draw_inputs(g), 2 + i, clock)
            env_state, obs = o.env_state, o.obs
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        rollout, ring_s, train = clock.read()
        out[exp] = {"envs": p.num_envs, "steps_per_iter": p.num_rows, "grad_steps_per_iter": p.grad_steps,
                    "batch": p.batch_size, "ring_rows": int(ring["data"]["rewards"].shape[0]), "iterations": iters,
                    "env_steps_per_s": iters * p.num_rows / wall, "wall_s_per_iter": wall / iters,
                    "rollout_s_per_iter": rollout / iters, "ring_s_per_iter": ring_s / iters,
                    "train_s_per_iter": train / iters, "s_per_gradient_step": train / (iters * p.grad_steps),
                    "peak_device_bytes": torch.cuda.max_memory_allocated()}
        warm[exp] = (p, ring, g, env_state, obs)
    print(f"[chip-smoke] sac_anakin timing: {json.dumps(out)}", flush=True)
    return out, warm


def _profile_call(fn) -> dict:
    """``fn()`` under torch.profiler, tracing the card only (an iteration of
    ``exp=sac_anakin`` launches ~60,000 device operations, and host events
    would multiply the trace): wall ms, device ms, device operations, the
    card's busy share and the top kernels by device ms."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    by_kernel, count = {}, 0
    for ev in device_events(prof):
        by_kernel[ev.name] = by_kernel.get(ev.name, 0.0) + ev.time_range.elapsed_us() / 1e3
        count += 1
    device_ms = sum(by_kernel.values())
    return {"wall_ms": wall_ms, "device_ms": device_ms, "device_busy_share": device_ms / wall_ms,
            "device_operations": count, "top_device_ms": sorted(by_kernel.items(), key=lambda kv: -kv[1])[:6]}


def profile_sac_anakin(warm: dict) -> dict:
    """Under torch.profiler (last), one SAC Anakin iteration at each timed
    width (busy share, device operations), then its rollout alone and its
    ring write and sample alone from the same carries; the G gradient steps
    are the rest of the iteration."""
    from sheeprl_tpu_torch.data.device_ring import ring_sample, ring_write

    out = {}
    for exp, (p, ring, g, env_state, obs) in warm.items():
        inputs = p.draw_inputs(g)
        res = {"iteration": _profile_call(lambda: p.step(env_state, obs, ring, inputs, 4))}
        parts = {}
        res["rollout"] = _profile_call(lambda: parts.update(
            traj=p.rollout(env_state, obs, inputs["noise"], inputs["resets"])[2]))
        res["ring"] = _profile_call(lambda: ring_sample(ring_write(ring, parts["traj"]), inputs["round_keys"],
                                                        p.batch_size, p.grad_steps))
        train_ops = res["iteration"]["device_operations"] - res["rollout"]["device_operations"] \
            - res["ring"]["device_operations"]
        res["train"] = {"device_operations": train_ops, "device_operations_per_gradient_step": train_ops / p.grad_steps,
                        "device_ms": res["iteration"]["device_ms"] - res["rollout"]["device_ms"]
                        - res["ring"]["device_ms"]}
        out[exp] = res
    print(f"[chip-smoke] sac_anakin iteration profile: {json.dumps(out)}", flush=True)
    return out


# -- the decoupled topology in one process (phase 7c) ---------------------------------------
# DV3 S decoupled through the entry points, the player loop and the learner
# thread on the card: learning_starts of 80 iterations of 4 envs (each env 80
# rows, more than a 64-step sequence), then 4 training iterations of 4
# gradient steps. checkpoint.every = 200 policy steps falls in the prefill
# (iteration 50), when the learner has shipped no state: the checkpoint waits
# for the first round (iteration 80, step 320); the last is at step 336. The
# coupled run of the same config writes at 200 and 336. A resumed run waits
# the 80 iterations again, its governor skips the first training iteration,
# and the next 3 take 4 gradient steps each.
DEC_LEARNING_STARTS_ITERS = 80
DEC_FIRST_ITERS = DEC_LEARNING_STARTS_ITERS + 4
DEC_RESUME_ITERS = DEC_FIRST_ITERS + DEC_LEARNING_STARTS_ITERS + 4
DEC_CKPT_EVERY = 200
# PPO and SAC decoupled at phase 6's and phase 7's cuts and bars: a decoupled
# run trains as the coupled one (the learner's generator is seeded as the
# coupled loop's train generator; on the CPU a SAC run is the coupled run bit
# for bit, tests/test_torch_sac_decoupled.py)
# one DV3 learner round card vs CPU: G = 2 gradient steps at train_step_parity's
# T = 16, B = 4 and bars; PPO's and SAC's rounds at their train-phase bars
DEC_DV3_G = 2


def _leaves(tree, prefix: str = "") -> dict:
    """path -> array of a nested dict (a checkpoint's agent)."""
    if isinstance(tree, dict):
        return {k: v for key, sub in tree.items() for k, v in _leaves(sub, f"{prefix}/{key}").items()}
    return {prefix: np.asarray(tree)}


def _dec_overrides(exp: str, run_dir: str) -> list:
    return [
        f"exp={exp}", "env=dummy", "algo.cnn_keys.encoder=[rgb]", "algo.mlp_keys.encoder=[state]",
        f"env.num_envs={TRAIN_ENVS}", "algo.per_rank_batch_size=16", "algo.per_rank_sequence_length=64",
        f"algo.learning_starts={TRAIN_ENVS * DEC_LEARNING_STARTS_ITERS}", f"checkpoint.every={DEC_CKPT_EVERY}",
        "buffer.memmap=False", "env.capture_video=False", f"hydra.run.dir={run_dir}",
    ]


def _dec_run(name: str, overrides: list) -> dict:
    """One DV3 run through ``run``, its LN-GRU launches counted exactly: 79 a
    gradient step, one a policy step of the loop and of its test episode."""
    from sheeprl_tpu_torch.cli import run

    _zero_launches()
    summary = run(overrides)
    need = GRU_CALLS_PER_GRAD_STEP * summary["gradient_steps"] + summary["player_calls"] + summary["test_player_calls"]
    by_dtype = _f32_launches(name, need)
    print(f"[chip-smoke] {name}: {summary['gradient_steps']} gradient steps, {summary['player_calls']} player calls, "
          f"{summary['policy_steps']} policy steps in {summary['wall_seconds']:.2f}s (train "
          f"{summary['train_seconds']:.2f}s); metrics {json.dumps(summary['metrics'])}", flush=True)
    if summary["gradient_steps"] < 1 or not all(math.isfinite(v) for v in summary["metrics"].values()):
        raise AssertionError(f"{name}: {summary['gradient_steps']} gradient steps, metrics {summary['metrics']}")
    ckpts = sorted(c for c in os.listdir(os.path.join(summary["log_dir"], "checkpoint")) if c.endswith(".ckpt"))
    return {"summary": summary, "launches": _launches(), "by_dtype": by_dtype, "need": need, "checkpoints": ckpts}


def dv3_decoupled_path(out_dir: str) -> dict:
    """``exp=dreamer_v3_decoupled`` at S through the entry points on the card:
    train with a checkpoint deferred past the prefill, the same config under
    ``exp=dreamer_v3`` beside it (the LN-GRU launches of both, and their
    parameters after the same rounds: a finding, not a gate), resume from the
    last checkpoint, evaluate it."""
    from sheeprl_tpu_torch.cli import evaluation
    from sheeprl_tpu_torch.utils.checkpoint import load_checkpoint

    dec = _dec_overrides("dreamer_v3_decoupled", os.path.join(out_dir, "dv3_dec"))
    cpl = _dec_overrides("dreamer_v3", os.path.join(out_dir, "dv3_cpl"))
    first = f"algo.total_steps={TRAIN_ENVS * DEC_FIRST_ITERS}"
    out = {"train": _dec_run("dreamer_v3_decoupled run", dec + [first])}
    out["coupled"] = _dec_run("dreamer_v3 run at the same config", cpl + [first])
    last = f"ckpt_{TRAIN_ENVS * DEC_FIRST_ITERS}_0.ckpt"
    deferred = f"ckpt_{TRAIN_ENVS * DEC_LEARNING_STARTS_ITERS}_0.ckpt"
    if out["train"]["checkpoints"] != sorted([deferred, last]) or \
            out["coupled"]["checkpoints"] != sorted([f"ckpt_{DEC_CKPT_EVERY}_0.ckpt", last]):
        raise AssertionError(f"checkpoints: decoupled {out['train']['checkpoints']} (want {deferred}, deferred from "
                             f"step {DEC_CKPT_EVERY}, and {last}), coupled {out['coupled']['checkpoints']}")
    ours, theirs = (_leaves(load_checkpoint(os.path.join(r["summary"]["log_dir"], "checkpoint", last))["agent"])
                    for r in (out["train"], out["coupled"]))
    out["vs_coupled"] = {
        "launches": {"decoupled": out["train"]["launches"][LN_GRU.name],
                     "coupled": out["coupled"]["launches"][LN_GRU.name]},
        "param_max_abs_gap": max(float(np.abs(ours[k] - theirs[k]).max()) for k in theirs),
        "metrics_equal": out["train"]["summary"]["metrics"] == out["coupled"]["summary"]["metrics"],
    }
    print(f"[chip-smoke] dreamer_v3_decoupled vs dreamer_v3 at the same config on the card: "
          f"{json.dumps(out['vs_coupled'])}", flush=True)
    ckpt = os.path.join(out["train"]["summary"]["log_dir"], "checkpoint", last)
    out["resume"] = _dec_run("dreamer_v3_decoupled resumed run",
                             dec + [f"algo.total_steps={TRAIN_ENVS * DEC_RESUME_ITERS}", f"checkpoint.resume_from={ckpt}"])
    if not out["resume"]["summary"]["log_dir"].endswith("version_1"):
        raise AssertionError(f"the resumed run wrote {out['resume']['summary']['log_dir']}, not version_1")
    _zero_launches()
    reward = evaluation([f"checkpoint_path={out['resume']['summary']['checkpoint']}", "env.capture_video=False"])
    out["evaluation"] = {"reward": reward, "launches": _launches()}
    print(f"[chip-smoke] dreamer_v3_decoupled evaluation: reward {reward}, LN-GRU launches {LN_GRU.launches}",
          flush=True)
    if not (math.isfinite(reward) and LN_GRU.launches >= 1):
        raise AssertionError(f"dreamer_v3_decoupled evaluation: reward {reward}, {LN_GRU.launches} launches")
    return out


def _model_free_decoupled(name: str, overrides: list, total: int, resume_total: int, min_reward=None) -> dict:
    """A model-free decoupled exp through the entry points on the card: train
    (its test reward over ``min_reward`` when given), resume from the last
    checkpoint into version_1, evaluate; no LN-GRU launch (the agents are
    MLPs)."""
    from sheeprl_tpu_torch.cli import evaluation, run

    out = {}
    _zero_launches()
    first = run(overrides + [f"algo.total_steps={total}"])
    out["train"] = {"summary": first, "launches": _launches()}
    _zero_launches()
    resumed = run(overrides + [f"algo.total_steps={resume_total}", f"checkpoint.resume_from={first['checkpoint']}"])
    out["resume"] = {"summary": resumed, "launches": _launches()}
    _zero_launches()
    reward = evaluation([f"checkpoint_path={resumed['checkpoint']}", "env.capture_video=False"])
    out["evaluation"] = {"reward": reward, "launches": _launches()}
    print(f"[chip-smoke] {name}: {first['train_phases']} rounds, {first['policy_steps']} policy steps in "
          f"{first['wall_seconds']:.2f}s (train {first['train_seconds']:.2f}s, env {first['env_seconds']:.2f}s), "
          f"test reward {first['test_reward']}, losses {json.dumps(first['metrics'])}; resumed "
          f"{resumed['train_phases']} rounds into {resumed['log_dir']}; evaluation reward {reward}; LN-GRU launches "
          f"{[out[k]['launches'][LN_GRU.name] for k in ('train', 'resume', 'evaluation')]}", flush=True)
    for part in ("train", "resume"):
        s = out[part]["summary"]
        if s["train_phases"] < 1 or not all(math.isfinite(v) for v in s["metrics"].values()):
            raise AssertionError(f"{name} {part}: {s['train_phases']} rounds, losses {s['metrics']}")
    if not (resumed["log_dir"].endswith("version_1") and math.isfinite(reward)):
        raise AssertionError(f"{name}: resumed into {resumed['log_dir']}, evaluation reward {reward}")
    if min_reward is not None and not (first["test_reward"] is not None and first["test_reward"] >= min_reward):
        raise AssertionError(f"{name}: test reward {first['test_reward']} < {min_reward}")
    if any(out[k]["launches"][LN_GRU.name] for k in out):
        raise AssertionError(f"{name} launched the LN-GRU kernel: its agent has no LN-GRU cell")
    return out


def decoupled_paths(out_dir: str) -> dict:
    """Phase 7c's runs: DV3 S, PPO on CartPole-v1 and SAC on Pendulum-v1."""
    return {
        "dv3": dv3_decoupled_path(out_dir),
        "ppo": _model_free_decoupled("ppo_decoupled", ["exp=ppo_decoupled", "env.capture_video=False",
                                                        f"hydra.run.dir={os.path.join(out_dir, 'ppo_dec')}"],
                                     PPO_TOTAL_STEPS, PPO_TOTAL_STEPS + PPO_RESUME_ITERS * PPO_STEPS_PER_ITER,
                                     min_reward=PPO_MIN_TEST_REWARD),
        "sac": _model_free_decoupled("sac_decoupled", ["exp=sac_decoupled", "env.id=Pendulum-v1",
                                                        "env.capture_video=False",
                                                        f"hydra.run.dir={os.path.join(out_dir, 'sac_dec')}"],
                                     SAC_TOTAL_STEPS, SAC_TOTAL_STEPS + SAC_RESUME_STEPS,
                                     min_reward=SAC_MIN_TEST_REWARD),
    }


def _dec_learners(kind: str, devices):
    """The exp's learner on each device (the same weights from a seed, TF32
    off), with the round's block and its draws, made once on the host."""
    from sheeprl_tpu_torch.algos.dreamer_v3.dreamer_v3_decoupled import DV3Learner
    from sheeprl_tpu_torch.algos.ppo.ppo_decoupled import PPOLearner
    from sheeprl_tpu_torch.algos.sac.sac_decoupled import SACLearner
    from sheeprl_tpu_torch.utils.utils import gae

    if kind == "ppo":
        agents, cfg = _on_policy_agents("ppo_decoupled", devices)
        data, next_values = _ppo_rollout(1)
        tensors = {k: torch.from_numpy(v) for k, v in data.items()}
        returns, advantages = gae(tensors["rewards"], tensors["values"], tensors["dones"],
                                  torch.from_numpy(next_values), 128, float(cfg.algo.gamma), float(cfg.algo.gae_lambda))
        block = {k: v.reshape(-1, *v.shape[2:]) for k, v in tensors.items()}
        block.update(returns=returns.reshape(-1, 1), advantages=advantages.reshape(-1, 1))
        learners = {a: PPOLearner(cfg, agent, PPO_TOTAL_STEPS // PPO_STEPS_PER_ITER) for a, agent in agents.items()}
        perms = next(iter(learners.values())).trainer.draw_permutations(torch.Generator().manual_seed(2))
        for learner in learners.values():
            learner.draw = lambda: perms
        return learners, (block, 0.2, 0.0, True)
    if kind == "sac":
        trainers, cfg = _sac_trainers("sac_decoupled", devices)
        B = int(cfg.algo.per_rank_batch_size)
        block = {k: torch.from_numpy(v) for k, v in _replay_block(np.random.default_rng(12), (SAC_PARITY_G, B)).items()}
        noise = trainers["cpu"].draw_noise(SAC_PARITY_G, B, torch.Generator().manual_seed(13))
        learners = {}
        for accel, trainer in trainers.items():
            learner = SACLearner(trainer, int(cfg.seed))
            learner.draw = lambda G, B_, dev=trainer.device: {k: v.to(dev) for k, v in noise.items()}
            learners[accel] = learner
        return learners, (block, 1, True)
    T, B = 16, 4
    trainers, batch = _s_trainers(devices, T, B)
    block = {k: torch.stack([v] * DEC_DV3_G) for k, v in batch.items()}
    noise = [trainers["cpu"].draw_noise(T, B, torch.Generator().manual_seed(1 + g)) for g in range(DEC_DV3_G)]
    learners = {}
    for accel, trainer in trainers.items():
        draws = iter(noise)
        trainer.draw_noise = lambda T_, B_, generator, dev=trainer.device, draws=draws: {
            k: v.to(dev) for k, v in next(draws).items()}
        learners[accel] = DV3Learner(trainer)
    # the generator state is each learner's own (its draws are the ones above)
    return learners, (block, 0, None, True)


def decoupled_round_parity(kind: str) -> dict:
    """One learner round of ``kind`` (``ppo``, ``sac`` or ``dv3``) on the card
    vs on the CPU (TF32 off), driven through the learner's own thread as the
    player drives it: the same weights, block and draws. The bars are the
    coupled families' (``ppo_train_phase_parity``, ``sac_train_phase_parity``,
    ``train_step_parity``)."""
    from sheeprl_tpu_torch.parallel.decoupled import LearnerThread

    learners, message = _dec_learners(kind, ("gpu", "cpu"))
    replies = {}
    for accel, learner in learners.items():
        dev = learner.trainer.device
        msg = ({k: v.to(dev) for k, v in message[0].items()}, *message[1:])
        if kind == "dv3":
            msg = (*msg[:2], learner.generator.get_state(), *msg[3:])
        with LearnerThread(learner, f"{kind}-learner-parity") as channel:
            replies[accel] = channel.exchange(*msg)
            channel.close()
    if kind == "dv3":
        card, cpu = (learners[a].trainer for a in ("gpu", "cpu"))
        metrics = {a: replies[a][2] for a in replies}
        worst = max(abs(metrics["gpu"][k] - v) / max(abs(v), 1e-3) for k, v in metrics["cpu"].items())
        state = _state_gap(card, cpu)
        lr = max(group["lr"] for opt in cpu.optimizers.values() for group in opt.param_groups)
        res = {"worst_rel_err": worst, "state": state, "G": DEC_DV3_G, "T": 16, "B": 4}
        ok = (worst <= TRAIN_STEP_RTOL and state["param_max_abs_gap"] <= DEC_DV3_G * 2 * lr
              and state["param_share_within_atol"] >= TRAIN_PARAM_SHARE and state["moments_rel_gap"] <= TRAIN_STEP_RTOL)
        bars = (f"metrics {TRAIN_STEP_RTOL} relative, every parameter {DEC_DV3_G * 2 * lr:.1e}, a share >= "
                f"{TRAIN_PARAM_SHARE} within {TRAIN_PARAM_ATOL}")
    else:
        losses = {a: replies[a][2] for a in replies}
        params = {a: replies[a][0] for a in replies}
        loss_gap = float(((losses["gpu"] - losses["cpu"]).abs() / losses["cpu"].abs().clamp_min(1e-3)).max())
        param_gap = max(float((params["gpu"][k] - v).abs().max()) for k, v in params["cpu"].items())
        loss_bar, param_bar = (PPO_LOSS_RTOL, PPO_PARAM_ATOL) if kind == "ppo" else (SAC_LOSS_RTOL, SAC_PARAM_ATOL)
        res = {"losses_rel_gap": loss_gap, "param_max_abs_gap": param_gap, "card": losses["gpu"].tolist(),
               "cpu": losses["cpu"].tolist()}
        ok = loss_gap <= loss_bar and param_gap <= param_bar
        bars = f"losses {loss_bar} relative, every parameter {param_bar}"
    res["opt_state_shipped"] = all(r[1] is not None for r in replies.values())
    print(f"[chip-smoke] {kind}_decoupled learner round card vs CPU (TF32 off): {json.dumps(res)} (bars: {bars})",
          flush=True)
    if not (ok and res["opt_state_shipped"]):
        raise AssertionError(f"the {kind}_decoupled learner round on the card disagrees with the CPU: {res}")
    return res


def time_decoupled_rounds(rounds: int = 3) -> dict:
    """Seconds a learner round takes on the card at each exp's shape (DV3 S:
    4 gradient steps of 16 x 64, the exp's replay ratio over 4 envs; PPO: 4
    envs x 128 steps, 10 epochs of 8 minibatches; SAC: 4 gradient steps of
    256), TF32 as the configs set it, synchronized. The handoff is the copy
    the learner ships (DV3's act view on the card; PPO's and SAC's agent
    state on the host) and the player's load of it; its share is of the round
    as the player waits for it (the round, which takes the copy, and the
    load)."""
    from sheeprl_tpu_torch.algos.dreamer_v3.dreamer_v3_decoupled import DV3Learner, act_view, load_act_view
    from sheeprl_tpu_torch.algos.ppo.ppo_decoupled import PPOLearner
    from sheeprl_tpu_torch.algos.sac.sac_decoupled import SACLearner
    from sheeprl_tpu_torch.parallel.decoupled import snapshot
    from sheeprl_tpu_torch.parallel.fabric import apply_matmul_precision

    trainers, batch = _s_trainers(("gpu",), 64, 16)
    dv3 = DV3Learner(trainers["gpu"])
    dv3_player = copy.deepcopy(dv3.trainer.agent)
    dv3_block = {k: torch.stack([v] * 4).to(dv3.trainer.device) for k, v in batch.items()}
    agents, cfg = _on_policy_agents("ppo_decoupled", ("gpu",))
    ppo = PPOLearner(cfg, agents["gpu"], PPO_TOTAL_STEPS // PPO_STEPS_PER_ITER)
    ppo_player = copy.deepcopy(agents["gpu"]).to("cpu")
    data, _ = _ppo_rollout(3)
    flat = {k: torch.from_numpy(v.reshape(-1, *v.shape[2:])) for k, v in data.items()}
    rng = np.random.default_rng(4)
    flat.update(returns=torch.from_numpy(rng.standard_normal((512, 1)).astype(np.float32)),
                advantages=torch.from_numpy(rng.standard_normal((512, 1)).astype(np.float32)))
    sac_trainers, sac_cfg = _sac_trainers("sac_decoupled", ("gpu",), scale_heads=False)
    sac = SACLearner(sac_trainers["gpu"], int(sac_cfg.seed))
    sac_player = copy.deepcopy(sac.trainer.agent).to("cpu")
    sac_block = {k: torch.from_numpy(v).to(sac.trainer.device) for k, v in
                 _replay_block(np.random.default_rng(5), (4, int(sac_cfg.algo.per_rank_batch_size))).items()}
    apply_matmul_precision("high")  # the configs' float32_matmul_precision
    cases = {  # round, the learner's copy, the player's load of it
        "dv3": (lambda r: dv3.round(dv3_block, 4 * r, dv3.generator.get_state(), False),
                lambda: act_view(dv3.trainer.agent), lambda view: load_act_view(dv3_player, view)),
        "ppo": (lambda r: ppo.round(flat, 0.2, 0.0, False),
                lambda: snapshot(ppo.trainer.agent.state_dict(), "cpu"), ppo_player.load_state_dict),
        "sac": (lambda r: sac.round(sac_block, r + 1, False),
                lambda: snapshot(sac.trainer.agent.state_dict(), "cpu"), sac_player.load_state_dict),
    }
    out = {}

    def timed(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = fn()
        torch.cuda.synchronize()
        return res, time.perf_counter() - t0

    for kind, (round_fn, copy_fn, load_fn) in cases.items():
        times = {"round_s": [], "copy_s": [], "load_s": []}
        for r in range(rounds):
            times["round_s"].append(timed(lambda: round_fn(r))[1])
            shipped, t_copy = timed(copy_fn)
            times["copy_s"].append(t_copy)
            times["load_s"].append(timed(lambda: load_fn(shipped))[1])
        warm = {k: min(v[1:]) for k, v in times.items()}  # the first round is cold
        out[kind] = {**times, "handoff_share": (warm["copy_s"] + warm["load_s"]) / (warm["round_s"] + warm["load_s"])}
    print(f"[chip-smoke] decoupled learner rounds on the card (s, synchronized): {json.dumps(out)}", flush=True)
    return out


# -- the decoupled topology as two processes (phase 7d) -----------------------------------
# Each entry through ``python -m sheeprl_tpu_torch`` as two processes on the card
# (the player, rank 0, opens the store; the learner, rank 1), beside its thread
# mode at the same config in this process, both with xla_deterministic_ops on,
# so the two write the same checkpoints bit for bit. DV3 takes phase 7c's S
# config (80 prefill iterations, 4 training iterations of 4 gradient steps, the
# checkpoint deferred to step 320 and the last at 336); PPO and SAC cut their
# exps' steps (no learning gate here: phases 6, 7 and 7c hold the rewards).
# A two-process run spends ~25-35 s starting its processes: the six runs one
# after the other took 257 s, and with PPO's and SAC's two processes beside
# the thread-mode runs and DV3's alone after them 114 s, which brought the
# smoke to 1187 s on a slow host (both NVIDIA H100 80GB HBM3, 700 W). So the
# three two-process runs start together, and this process runs the three
# thread-mode runs beside them: their round times are measured beside each
# other's work.
DEC2_PPO_STEPS = 4 * PPO_STEPS_PER_ITER  # 4 rounds of 80 updates, 2 checkpoints
DEC2_SAC_STEPS = 300  # 25 iterations before learning starts, then 50 rounds of 4 gradient steps
DEC2_TIMEOUT_S = 300.0


def _start_two_processes(name: str, overrides: list, log_path: str) -> dict:
    """``python -m sheeprl_tpu_torch *overrides`` as a player and a learner
    process from the checkout's root, the learner started on the port the
    player printed. Returns the handle :func:`_finish_two_processes` waits on."""
    import re

    root = os.path.dirname(os.path.abspath(__file__))
    env = {**os.environ, "PYTHONPATH": root, "SHEEPRL_GANG_PROCESSES": "2"}
    run = {"name": name, "root": root, "logs": [f"{log_path}.rank{rank}.log" for rank in range(2)], "procs": [],
           "t0": time.perf_counter()}

    def start(rank: int, coordinator: str) -> None:
        with open(run["logs"][rank], "w") as log:
            run["procs"].append(subprocess.Popen(
                [sys.executable, "-m", "sheeprl_tpu_torch", *overrides], cwd=root, stdout=log,
                stderr=subprocess.STDOUT, env={**env, "SHEEPRL_COORDINATOR": coordinator, "SHEEPRL_GANG_RANK": str(rank)},
            ))

    try:
        start(0, "127.0.0.1:0")
        port = None
        while port is None:
            found = re.search(r"coordinator listening on \S+:(\d+)", open(run["logs"][0]).read())
            port = found and found.group(1)
            if port is None and (run["procs"][0].poll() is not None or time.perf_counter() - run["t0"] > DEC2_TIMEOUT_S):
                raise AssertionError(f"{name}: the player opened no store")
            time.sleep(0.05)
        start(1, f"127.0.0.1:{port}")
    except BaseException as exc:
        _kill_two_processes(run)
        raise AssertionError(f"{name}: {exc!r}\n{_two_process_tails(run)}") from exc
    return run


def _two_process_tails(run: dict) -> str:
    return "\n".join(f"--- {run['name']} rank {i}:\n{open(p).read()[-4000:]}" for i, p in enumerate(run["logs"])
                     if os.path.exists(p))


def _kill_two_processes(run: dict) -> None:
    for p in run["procs"]:
        if p.poll() is None:
            p.kill()
        p.wait()


def _finish_two_processes(run: dict) -> dict:
    """Wait for both processes (both killed past ``DEC2_TIMEOUT_S``). Returns
    the player's ``learner process`` report, its log dir and the wall seconds."""
    import re

    try:
        rcs = [p.wait(timeout=max(1.0, DEC2_TIMEOUT_S - (time.perf_counter() - run["t0"]))) for p in run["procs"]]
    except BaseException as exc:
        _kill_two_processes(run)
        raise AssertionError(f"{run['name']}: {exc!r}\n{_two_process_tails(run)}") from exc
    seconds = time.perf_counter() - run["t0"]
    if rcs != [0, 0]:
        raise AssertionError(f"{run['name']}: exit codes {rcs}\n{_two_process_tails(run)}")
    player = open(run["logs"][0]).read()
    report = re.search(r"^\[sheeprl\] learner process: (\{.*\})$", player, re.MULTILINE)
    log_dir = re.search(r"^Log dir: (.*)$", player, re.MULTILINE)
    if not (report and log_dir):
        raise AssertionError(f"{run['name']}: the player printed no report or log dir\n{_two_process_tails(run)}")
    return {"report": json.loads(report.group(1)), "log_dir": os.path.join(run["root"], log_dir.group(1)),
            "seconds": seconds}


def _checkpoint_gaps(ours: str, theirs: str) -> list:
    """The leaves (all but the replay buffer) where two checkpoints differ in
    any bit."""
    from sheeprl_tpu_torch.utils.checkpoint import load_checkpoint

    def walk(node, prefix):
        if isinstance(node, dict):
            for k, v in node.items():
                yield from walk(v, f"{prefix}/{k}")
        elif isinstance(node, (list, tuple)):
            for i, v in enumerate(node):
                yield from walk(v, f"{prefix}/{i}")
        else:
            yield prefix, node

    a, b = ({k: v for k, v in walk({n: x for n, x in load_checkpoint(path).items() if n != "rb"}, "")}
            for path in (ours, theirs))
    gaps = sorted(set(a) ^ set(b))
    for key in set(a) & set(b):
        x, y = a[key], b[key]
        if isinstance(x, (torch.Tensor, np.ndarray)) or isinstance(y, (torch.Tensor, np.ndarray)):
            x, y = np.asarray(x), np.asarray(y)
            if x.dtype != y.dtype or x.shape != y.shape or x.tobytes() != y.tobytes():
                gaps.append(key)
        elif x != y:
            gaps.append(key)
    return sorted(gaps)


def _thread_mode_run(overrides: list, run_dir: str) -> dict:
    """The thread mode of an entry in this process, deterministic, with its
    LN-GRU launches."""
    from sheeprl_tpu_torch.cli import run
    from sheeprl_tpu_torch.parallel.fabric import apply_deterministic_ops

    _zero_launches()
    try:
        summary = run(overrides + [f"hydra.run.dir={run_dir}"])
    finally:
        apply_deterministic_ops(False)
    return {"summary": summary, "launches": _launches()[LN_GRU.name]}


def _compare_modes(name: str, thread: dict, procs: dict, dv3: bool = False) -> dict:
    """The two-process run against the thread mode: the same checkpoints bit
    for bit; DV3's LN-GRU launches, player plus learner, the thread run's and
    its count (79 a gradient step, one a policy step)."""
    summary = thread["summary"]
    names = {d: sorted(c for c in os.listdir(os.path.join(d, "checkpoint")) if c.endswith(".ckpt"))
             for d in (summary["log_dir"], procs["log_dir"])}
    if names[summary["log_dir"]] != names[procs["log_dir"]] or not names[summary["log_dir"]]:
        raise AssertionError(f"{name}: checkpoints {names}")
    gaps = {c: _checkpoint_gaps(os.path.join(procs["log_dir"], "checkpoint", c),
                                os.path.join(summary["log_dir"], "checkpoint", c)) for c in names[summary["log_dir"]]}
    report = procs["report"]
    by_role = {role: report["launches"][role][LN_GRU.name] for role in ("player", "learner")}
    out = {"checkpoints": names[summary["log_dir"]], "gaps": gaps,
           "launches": {**by_role, "thread": thread["launches"]}, "report": report, "seconds": procs["seconds"],
           "thread_seconds": summary["wall_seconds"]}
    if dv3:
        out["need"] = (GRU_CALLS_PER_GRAD_STEP * summary["gradient_steps"] + summary["player_calls"]
                       + summary["test_player_calls"])
    print(f"[chip-smoke] {name} as two processes on the card (beside the other runs of phase 7d): "
          f"{report['rounds']} rounds of {report['round_seconds']:.4f}s (learner {report['learner_round_seconds']:.4f}s, "
          f"handoff share {report['handoff_share']:.4f}; first round {report['first_round_seconds']:.2f}s), run "
          f"{procs['seconds']:.1f}s (thread mode {summary['wall_seconds']:.1f}s); checkpoints {out['checkpoints']} "
          f"bitwise equal to the thread mode's: {not any(gaps.values())}; LN-GRU launches {json.dumps(out['launches'])}"
          + (f", need {out['need']}" if dv3 else ""), flush=True)
    if any(gaps.values()):
        raise AssertionError(f"{name}: the two-process checkpoints differ from the thread mode's at {gaps}")
    total = by_role["player"] + by_role["learner"]
    if dv3 and not (total == thread["launches"] == out["need"] and by_role["learner"] > 0 and by_role["player"] > 0):
        raise AssertionError(f"{name}: LN-GRU launches {out['launches']}, need {out['need']}")
    if not dv3 and (total or thread["launches"]):
        raise AssertionError(f"{name} launched the LN-GRU kernel: its agent has no LN-GRU cell")
    return out


def two_process_paths(out_dir: str) -> dict:
    """Phase 7d: DV3 S, PPO on CartPole-v1 and SAC on Pendulum-v1, each as two
    processes, all started together, while this process runs the three
    entries' thread mode; each held to its thread mode."""
    os.makedirs(out_dir, exist_ok=True)
    dv3 = [o for o in _dec_overrides("dreamer_v3_decoupled", "") if not o.startswith("hydra.run.dir=")]
    entries = {
        "dv3": ("dreamer_v3_decoupled", dv3 + [f"algo.total_steps={TRAIN_ENVS * DEC_FIRST_ITERS}"]),
        "ppo": ("ppo_decoupled", ["exp=ppo_decoupled", f"algo.total_steps={DEC2_PPO_STEPS}",
                                  f"checkpoint.every={DEC2_PPO_STEPS // 2}"]),
        "sac": ("sac_decoupled", ["exp=sac_decoupled", "env.id=Pendulum-v1", f"algo.total_steps={DEC2_SAC_STEPS}",
                                  f"checkpoint.every={DEC2_SAC_STEPS // 2}"]),
    }
    args = {fam: overrides + ["xla_deterministic_ops=True", "env.capture_video=False"]
            for fam, (_, overrides) in entries.items()}

    def start(fam: str) -> dict:
        name = entries[fam][0]
        return _start_two_processes(name, args[fam] + [f"hydra.run.dir={os.path.join(out_dir, name, 'processes')}"],
                                    os.path.join(out_dir, name))

    running = {}
    try:
        for fam in entries:
            running[fam] = start(fam)
        threads = {fam: _thread_mode_run(args[fam], os.path.join(out_dir, entries[fam][0], "thread"))
                   for fam in entries}
        procs = {fam: _finish_two_processes(running.pop(fam)) for fam in entries}
    finally:
        for run in running.values():
            _kill_two_processes(run)
    return {fam: _compare_modes(entries[fam][0], threads[fam], procs[fam], dv3=fam == "dv3") for fam in entries}


# -- the gang (phase 7e) ---------------------------------------------------------------
# exp=dreamer_v3_decoupled at phase 7c's S config as a gang of two processes
# (resilience.distributed.gang.processes=2): this process runs `python -m
# sheeprl_tpu_torch` once, and that process supervises a player and a learner.
# The learner is SIGKILLed after its second round (its step axis counts
# gradient steps: 4 a round), after the checkpoint deferred to the first round
# (step 320); the player must exit 77 within the heartbeat timeout + 10 s, and
# the gang restart from that checkpoint, the newest manifest-complete one. The
# resumed attempt prefills again with the policy (80 iterations, as any resumed
# DV3 run) and trains 4 rounds. Expected: 90-150 s, four process starts.
GANG_HEARTBEAT_TIMEOUT_S = 5.0
GANG_ARGS = ("resilience.distributed.gang.processes=2", "resilience.distributed.heartbeat.interval=0.5",
             f"resilience.distributed.heartbeat.timeout={GANG_HEARTBEAT_TIMEOUT_S:g}",
             "resilience.distributed.heartbeat.startup_timeout=120", "resilience.distributed.channel.timeout=120",
             "resilience.distributed.gang.grace=15", "resilience.supervisor.backoff=0.05")
GANG_KILL_AT = 8  # the learner's gradient steps: after its second round
GANG_DV3_ITERS = 2 * DEC_LEARNING_STARTS_ITERS + 4 + 1  # resumed at iteration 81: prefill to 161, 4 rounds
GANG_TIMEOUT_S = 420.0
# the model-free child's gang: sac_decoupled on Pendulum-v1, SIGTERM to the learner
GANG_SAC_STEPS = 400
GANG_SAC_TERM_AT = 200


def _run_gang(name: str, overrides: list, run_dir: str) -> dict:
    """``python -m sheeprl_tpu_torch *overrides`` (the gang's supervisor) from
    the checkout's root with its run base at ``run_dir``; past
    ``GANG_TIMEOUT_S`` the supervisor and every child (their command lines hold
    ``run_dir``) are killed. Returns the exit code, the seconds and the run
    base's events (``telemetry.jsonl``, and the learner's ``telemetry.rank1.jsonl``)."""
    import signal

    root = os.path.dirname(os.path.abspath(__file__))
    os.makedirs(run_dir, exist_ok=True)
    env = {k: v for k, v in os.environ.items() if not k.startswith("SHEEPRL_")}
    env["PYTHONPATH"] = root
    log_path = os.path.join(run_dir, "supervisor.log")
    t0 = time.perf_counter()
    with open(log_path, "w") as log:
        proc = subprocess.Popen([sys.executable, "-m", "sheeprl_tpu_torch", *overrides, f"hydra.run.dir={run_dir}"],
                                cwd=root, stdout=log, stderr=subprocess.STDOUT, env=env)
    try:
        rc = proc.wait(timeout=GANG_TIMEOUT_S)
    except subprocess.TimeoutExpired:
        rc = None
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
        for pid in os.listdir("/proc"):  # the children run in sessions of their own
            try:
                if pid.isdigit() and int(pid) != os.getpid() and \
                        f"hydra.run.dir={run_dir}".encode() in open(f"/proc/{pid}/cmdline", "rb").read():
                    os.kill(int(pid), signal.SIGKILL)
            except OSError:
                continue
    seconds = time.perf_counter() - t0

    def events(path: str) -> list:
        return [json.loads(line) for line in open(path)] if os.path.exists(path) else []

    logs = sorted(os.path.join(run_dir, "gang", f) for f in os.listdir(os.path.join(run_dir, "gang"))) \
        if os.path.isdir(os.path.join(run_dir, "gang")) else []
    tails = "\n".join(f"--- {os.path.basename(p)}:\n{open(p).read()[-3000:]}" for p in [log_path] + logs)
    if rc != 0:
        raise AssertionError(f"{name}: the gang exited {rc} after {seconds:.1f}s\n{tails}")
    return {"seconds": seconds, "events": events(os.path.join(run_dir, "telemetry.jsonl")),
            "learner_events": events(os.path.join(run_dir, "telemetry.rank1.jsonl")), "logs": logs, "tails": tails}


def _ordered(name: str, events: list, wanted: list) -> list:
    """The events matching each predicate of ``wanted``, in that order."""
    found, it = [], iter(events)
    for want in wanted:
        for event in it:
            if want(event):
                found.append(event)
                break
        else:
            raise AssertionError(f"{name}: event #{len(found)} of the gate is missing from "
                                 f"{[(e['event'], e.get('status') or e.get('reason')) for e in events]}")
    return found


def _gang_attempts(spawn0: dict, exit0: dict, spawn1: dict, exit1: dict) -> dict:
    return {"attempt0_seconds": exit0["time"] - spawn0["time"], "attempt1_seconds": exit1["time"] - spawn1["time"]}


def _attempt_summary(log_path: str) -> dict:
    """The run summary an attempt's player printed."""
    import ast
    import re

    found = re.search(r"^\[sheeprl\] run summary: (\{.*\})$", open(log_path).read(), re.MULTILINE)
    if not found:
        raise AssertionError(f"{log_path}: no run summary\n{open(log_path).read()[-3000:]}")
    return ast.literal_eval(found.group(1))


def gang_path(out_dir: str) -> dict:
    """Phase 7e: ``exp=dreamer_v3_decoupled`` at S as a gang of two processes
    whose learner is SIGKILLed: the run base's ``telemetry.jsonl`` holds, in
    order, the spawn of attempt 0, the player's ``health rank_dead`` (rank 1),
    attempt 0's exit (a crash, rank 1 the dead one), the restart from the
    newest manifest-complete checkpoint, the spawn of attempt 1 and its
    completion; the player exited 77 within the heartbeat timeout + 10 s of
    the kill; the last checkpoint's manifest is complete; attempt 1's LN-GRU
    launches, player plus learner, are 79 a gradient step plus one a policy
    step, and it built no kernel."""
    from sheeprl_tpu_torch.resilience.discovery import find_latest_checkpoint, read_manifest

    run_dir = os.path.join(out_dir, "dv3_gang")
    dv3 = [o for o in _dec_overrides("dreamer_v3_decoupled", "") if not o.startswith("hydra.run.dir=")]
    run = _run_gang("the dreamer_v3_decoupled gang", dv3 + [
        f"algo.total_steps={TRAIN_ENVS * GANG_DV3_ITERS}", *GANG_ARGS, "resilience.fault.kind=kill_rank",
        "resilience.fault.rank=1", f"resilience.fault.at_policy_step={GANG_KILL_AT}"], run_dir)
    spawn0, dead, exit0, restart, spawn1, exit1 = _ordered("the dreamer_v3_decoupled gang", run["events"], [
        lambda e: e["event"] == "gang" and e.get("status") == "spawn" and e.get("attempt") == 0,
        lambda e: e["event"] == "health" and e.get("status") == "rank_dead" and e.get("rank") == 1,
        lambda e: e["event"] == "gang" and e.get("status") == "attempt_exit",
        lambda e: e["event"] == "restart",
        lambda e: e["event"] == "gang" and e.get("status") == "spawn" and e.get("attempt") == 1,
        lambda e: e["event"] == "gang" and e.get("status") == "attempt_exit" and e.get("attempt") == 1,
    ])
    kill = next(e for e in run["learner_events"] if e["event"] == "fault")
    first = os.path.join(run_dir, "version_0")
    newest = find_latest_checkpoint(first)
    last = _attempt_summary(os.path.join(run_dir, "gang", "attempt1.rank0.log"))
    report = last["learner_process"]
    launches = {role: report["launches"][role][LN_GRU.name] for role in ("player", "learner")}
    need = GRU_CALLS_PER_GRAD_STEP * last["gradient_steps"] + last["player_calls"] + last["test_player_calls"]
    last_manifest = read_manifest(last["checkpoint"] if os.path.isabs(last["checkpoint"])
                                  else os.path.join(os.path.dirname(os.path.abspath(__file__)), last["checkpoint"]))
    out = {
        "seconds": run["seconds"], "kill_to_teardown_seconds": exit0["time"] - kill["time"],
        **_gang_attempts(spawn0, exit0, spawn1, exit1), "exit_codes": exit0["exit_codes"],
        "dead_ranks": exit0.get("dead_ranks"), "resume_from": restart.get("resume_from"), "newest_complete": newest,
        "silent_seconds": dead.get("silent_seconds"), "last_checkpoint": last["checkpoint"],
        "last_manifest": last_manifest, "attempt1_launches": launches, "attempt1_need": need,
        "attempt1_builds": report.get("builds"), "attempt1_gradient_steps": last["gradient_steps"],
        "attempt1_round_seconds": report["round_seconds"], "attempt1_first_round_seconds": report["first_round_seconds"],
    }
    print(f"[chip-smoke] the dreamer_v3_decoupled gang (S, two processes an attempt): kill to teardown "
          f"{out['kill_to_teardown_seconds']:.1f}s (heartbeat timeout {GANG_HEARTBEAT_TIMEOUT_S:g}s), attempt 0 "
          f"{out['attempt0_seconds']:.1f}s, attempt 1 {out['attempt1_seconds']:.1f}s, the whole gang "
          f"{run['seconds']:.1f}s; exit codes {exit0['exit_codes']}, restart from {out['resume_from']}; attempt 1: "
          f"{last['gradient_steps']} gradient steps, LN-GRU launches {json.dumps(launches)} (need {need}), builds "
          f"{json.dumps(out['attempt1_builds'])}, rounds of {report['round_seconds']:.3f}s", flush=True)
    if exit0.get("outcome") != "crash" or exit0["exit_codes"] != {"0": 77, "1": -9} or \
            exit0.get("dead_ranks") != {"1": -9}:
        raise AssertionError(f"the gang's attempt 0 ended {exit0}\n{run['tails']}")
    if out["kill_to_teardown_seconds"] > GANG_HEARTBEAT_TIMEOUT_S + 10.0:
        raise AssertionError(f"the player exited {out['kill_to_teardown_seconds']:.1f}s after the kill")
    resume = restart.get("resume_from") or ""
    resume = resume if os.path.isabs(resume) else os.path.join(os.path.dirname(os.path.abspath(__file__)), resume)
    if not newest or os.path.abspath(resume) != os.path.abspath(newest) or not read_manifest(newest)["complete"]:
        raise AssertionError(f"the gang restarted from {restart.get('resume_from')}, the newest complete: {newest}")
    if exit1.get("outcome") != "completed" or not (last_manifest and last_manifest.get("complete")):
        raise AssertionError(f"the gang's attempt 1 ended {exit1}, last manifest {last_manifest}\n{run['tails']}")
    if not (launches["player"] + launches["learner"] == need and launches["learner"] > 0 and launches["player"] > 0):
        raise AssertionError(f"the gang's attempt 1: LN-GRU launches {launches}, need {need}")
    if out["attempt1_builds"] != {"player": 0, "learner": 0}:
        raise AssertionError(f"the gang's attempt 1 built kernels: {out['attempt1_builds']}")
    return out


def sac_gang_sigterm(out_dir: str) -> dict:
    """The model-free child's gang: ``exp=sac_decoupled`` on Pendulum-v1 as a
    gang whose learner alone gets SIGTERM. The player turns its request into
    the agreed stop step, both exit 75 there, and the gang restarts
    (``restart_on_preempt``) and completes."""
    run_dir = os.path.join(out_dir, "sac_gang")
    run = _run_gang("the sac_decoupled gang", [
        "exp=sac_decoupled", "env.id=Pendulum-v1", f"algo.total_steps={GANG_SAC_STEPS}",
        f"checkpoint.every={GANG_SAC_STEPS // 4}", "algo.run_test=False", "env.capture_video=False", *GANG_ARGS,
        "resilience.fault.kind=sigterm", "resilience.fault.rank=1", f"resilience.fault.at_policy_step={GANG_SAC_TERM_AT}",
    ], run_dir)
    spawn0, preempt, emergency, exit0, restart, spawn1, exit1 = _ordered("the sac_decoupled gang", run["events"], [
        lambda e: e["event"] == "gang" and e.get("status") == "spawn" and e.get("attempt") == 0,
        lambda e: e["event"] == "preempt" and e.get("requested_by") == [1],
        lambda e: e["event"] == "checkpoint" and e.get("reason") == "preempt",
        lambda e: e["event"] == "gang" and e.get("status") == "attempt_exit",
        lambda e: e["event"] == "restart",
        lambda e: e["event"] == "gang" and e.get("status") == "spawn" and e.get("attempt") == 1,
        lambda e: e["event"] == "gang" and e.get("status") == "attempt_exit" and e.get("attempt") == 1,
    ])
    out = {"seconds": run["seconds"], **_gang_attempts(spawn0, exit0, spawn1, exit1),
           "stop_step": preempt.get("stop_step"), "emergency_step": emergency.get("step"),
           "exit_codes": exit0["exit_codes"], "restart_reason": restart.get("reason")}
    print(f"[chip-smoke] the sac_decoupled gang, SIGTERM to the learner: stop step {out['stop_step']}, emergency "
          f"checkpoint at {out['emergency_step']}, exit codes {exit0['exit_codes']}; attempt 0 "
          f"{out['attempt0_seconds']:.1f}s, attempt 1 {out['attempt1_seconds']:.1f}s", flush=True)
    if exit0["exit_codes"] != {"0": 75, "1": 75} or exit0.get("outcome") != "preempt" or \
            restart.get("reason") != "preempt" or exit1.get("outcome") != "completed":
        raise AssertionError(f"the sac_decoupled gang: {out}\n{run['tails']}")
    if not emergency["step"] < preempt["stop_step"] <= emergency["step"] + 4:
        raise AssertionError(f"the sac_decoupled gang's emergency checkpoint is not at the agreed step: {out}")
    return out


def ppo_ckpt_kill(out_dir: str) -> dict:
    """``exp=ppo`` in this process under ``resilience.supervisor.enabled``
    with a ``ckpt_kill`` fault: the third iteration's checkpoint write dies
    between its temporary file and its rename; the supervisor restarts from
    the second iteration's checkpoint, which discovery still resolves, and
    the run completes."""
    from sheeprl_tpu_torch.cli import run
    from sheeprl_tpu_torch.resilience import faults

    run_dir = os.path.join(out_dir, "ppo_ckpt_kill")
    faults.reset_faults()
    summary = run(["exp=ppo", f"algo.total_steps={4 * PPO_STEPS_PER_ITER}", f"checkpoint.every={PPO_STEPS_PER_ITER}",
                   "algo.run_test=False", "env.capture_video=False", "resilience.supervisor.enabled=true",
                   "resilience.supervisor.backoff=0.05", "resilience.fault.kind=ckpt_kill",
                   f"resilience.fault.at_policy_step={2 * PPO_STEPS_PER_ITER + 1}", f"hydra.run.dir={run_dir}"])
    events = [json.loads(line) for line in open(os.path.join(run_dir, "telemetry.jsonl"))]
    fault, restart, done = _ordered("the ppo ckpt_kill run", events, [
        lambda e: e["event"] == "fault" and e.get("kind") == "ckpt_kill",
        lambda e: e["event"] == "restart" and e.get("reason") == "crash",
        lambda e: e["event"] == "supervisor" and e.get("status") == "completed",
    ])
    torn = os.path.join(run_dir, "version_0", "checkpoint", f"ckpt_{3 * PPO_STEPS_PER_ITER}_0.ckpt")
    out = {"resume_from": restart.get("resume_from"), "torn_left": os.path.exists(torn + ".tmp"),
           "policy_steps": summary["policy_steps"], "checkpoint": summary["checkpoint"]}
    print(f"[chip-smoke] ppo under the supervisor with ckpt_kill: restarted from {out['resume_from']}, the torn "
          f"write left {out['torn_left']}, completed at {summary['policy_steps']} steps", flush=True)
    if not (out["torn_left"] and os.path.basename(out["resume_from"] or "") == f"ckpt_{2 * PPO_STEPS_PER_ITER}_0.ckpt"
            and summary["policy_steps"] == 4 * PPO_STEPS_PER_ITER):
        raise AssertionError(f"the ppo ckpt_kill run: {out}")
    return out


def model_free_phases(tmp: str, stamp) -> dict:
    """Phases 6-7b and the model-free part of phase 8: PPO and A2C, recurrent
    PPO, the on-policy Anakin topology, SAC and DroQ, the off-policy Anakin
    topology, then their profiles (last: once the profiler has run, later eager
    launches cost more host time). None of them reaches the LN-GRU kernel;
    :func:`main` runs them in a child process beside the Dreamer phases."""
    ppo = ppo_path(tmp)
    ppo["serve"] = ppo_serve_path(ppo["train"]["summary"]["checkpoint"], tmp)
    a2c = a2c_path(tmp)
    ppo["parity"] = ppo_train_phase_parity()
    a2c["rmsprop_parity"] = a2c_rmsprop_parity()
    ppo["timing"], ppo_warm = time_ppo()
    stamp("phase 6")
    # recurrent PPO: train, resume, evaluate, serve; a phase and a serve step card vs CPU
    rppo = rppo_path(tmp)
    rppo["parity"] = rppo_parity()
    rppo["timing"], rppo_warm = time_rppo()
    stamp("phase 6b")
    # the on-policy Anakin topology: train, resume, evaluate, serve; the env
    # step, the train phases and an iteration card vs CPU; host syncs; timing
    anakin = anakin_path(tmp)
    anakin["env_parity"] = anakin_env_parity()
    anakin["train_parity"] = anakin_train_parity()
    anakin["step_parity"] = anakin_step_parity()
    anakin["syncs"] = anakin_syncs()
    anakin["deterministic"] = {kind: deterministic_step(kind) for kind in ("ppo_anakin", "a2c_anakin")}
    if not all(r["ok"] for r in anakin["deterministic"].values()):
        raise AssertionError(f"an Anakin step failed with xla_deterministic_ops on: {anakin['deterministic']}")
    anakin["timing"], anakin_warm = time_anakin()
    stamp("phase 6c")
    sac = sac_path(tmp)
    sac["serve"] = sac_serve_path(sac["ckpt"], tmp)
    droq = droq_path(tmp)
    sac["parity"] = sac_train_phase_parity("sac")
    droq["parity"] = sac_train_phase_parity("droq")
    sac["timing"], sac_warm = time_sac()
    stamp("phase 7")
    # the off-policy Anakin topology: train and resume with the ring; host
    # syncs; the ring and an iteration card vs CPU; deterministic mode; timing
    sac_anakin = sac_anakin_path(tmp)
    sac_anakin["syncs"] = sac_anakin_syncs()
    sac_anakin["ring_parity"] = sac_anakin_ring_parity()
    sac_anakin["step_parity"] = sac_anakin_step_parity()
    sac_anakin["exp_step_parity"] = sac_anakin_step_parity((), gate=False)
    sac_anakin["deterministic"] = deterministic_step("sac_anakin")
    if not sac_anakin["deterministic"]["ok"]:
        raise AssertionError(f"the sac_anakin step failed with xla_deterministic_ops on: {sac_anakin['deterministic']}")
    sac_anakin["timing"], sac_anakin_warm = time_sac_anakin()
    stamp("phase 7b")
    # the resilience plane without the kernel: a sac_decoupled gang whose
    # learner gets SIGTERM, and ppo under the supervisor with ckpt_kill
    resilience = {"sac_gang": sac_gang_sigterm(tmp), "ppo_ckpt_kill": ppo_ckpt_kill(tmp)}
    stamp("phase 7e, the model-free gang and supervisor")
    ppo["timing"]["profile"] = profile_ppo_train_phase(ppo_warm)
    rppo["timing"]["profile"] = profile_rppo_train_phase(rppo_warm)
    sac["timing"]["profile"] = profile_sac_train_phase(sac_warm)
    anakin["timing"]["profile"] = profile_anakin(anakin_warm)
    sac_anakin["timing"]["profile"] = profile_sac_anakin(sac_anakin_warm)
    stamp("phase 8, the model-free profiles")
    return {"ppo": ppo, "a2c": a2c, "rppo": rppo, "anakin": anakin, "sac": sac, "droq": droq,
            "sac_anakin": sac_anakin, "resilience": resilience}


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
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
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


MODEL_FREE_TIMEOUT_S = 900.0  # the child's phases took 400-460 s on the slowest host seen


def _start_model_free(tmp: str) -> dict:
    """This script as a child (``--model-free-out``) running
    :func:`model_free_phases` on the same card, its output in a log."""
    out, log_path = os.path.join(tmp, "model_free.json"), os.path.join(tmp, "model_free.log")
    with open(log_path, "w") as log:
        proc = subprocess.Popen([sys.executable, os.path.abspath(__file__), "--model-free-out", out],
                                cwd=os.path.dirname(os.path.abspath(__file__)), stdout=log, stderr=subprocess.STDOUT)
    return {"proc": proc, "out": out, "log": log_path, "t0": time.perf_counter()}


def _finish_model_free(child: dict) -> dict:
    """Wait for the child (killed past ``MODEL_FREE_TIMEOUT_S`` from its start),
    print its phase stamps, and return its results; raise with its log's tail
    when it failed."""
    proc = child["proc"]
    try:
        rc = proc.wait(timeout=max(1.0, MODEL_FREE_TIMEOUT_S - (time.perf_counter() - child["t0"])))
    except subprocess.TimeoutExpired:
        proc.kill()
        rc = proc.wait()
    log = open(child["log"]).read()
    for line in log.splitlines():
        if line.startswith("[chip-smoke]") and " done at " in line:
            print(line.replace("[chip-smoke]", "[chip-smoke] (model-free child)", 1), flush=True)
    if rc != 0 or not os.path.exists(child["out"]):
        raise AssertionError(f"the model-free phases' child exited {rc}:\n{log[-8000:]}")
    with open(child["out"]) as f:
        return json.load(f)


def model_free_main(out: str) -> int:
    """The child's side: phases 6-7b and their profiles, the results to ``out``."""
    if not torch.cuda.is_available():
        print("[chip-smoke] torch.cuda.is_available() is false: this smoke needs a CUDA card", file=sys.stderr)
        return 1
    torch.zeros(1, device="cuda")
    t_start = time.perf_counter()

    def stamp(name: str) -> None:
        print(f"[chip-smoke] {name} done at {time.perf_counter() - t_start:.1f}s (the child's clock)", flush=True)

    with tempfile.TemporaryDirectory(prefix="chip_smoke_model_free_") as tmp:
        results = model_free_phases(tmp, stamp)
    with open(out + ".tmp", "w") as f:
        json.dump(results, f)
    os.replace(out + ".tmp", out)
    return 0


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--out", default=None, help="also write every measurement to this JSON file")
    parser.add_argument("--model-free-out", default=None,
                        help="run phases 6-7b alone and write their results to this JSON file (the smoke's child)")
    args = parser.parse_args()
    if args.model_free_out:
        return model_free_main(args.model_free_out)

    if not torch.cuda.is_available():
        print("[chip-smoke] torch.cuda.is_available() is false: this smoke needs a CUDA card", file=sys.stderr)
        return 1
    card = card_line()
    print(f"[chip-smoke] card: {card}; torch {torch.__version__} (CUDA {torch.version.cuda})", flush=True)
    device = torch.device("cuda", 0)
    torch.zeros(1, device=device)  # create the CUDA context before any library call
    t_start = time.perf_counter()
    stamps = {}

    def stamp(name: str) -> None:
        """The seconds since the start at the end of a group of phases."""
        stamps[name] = time.perf_counter() - t_start
        print(f"[chip-smoke] {name} done at {stamps[name]:.1f}s", flush=True)

    paths = build(KERNELS)
    print(f"[chip-smoke] built {len(paths)} kernel(s) in {time.perf_counter() - t_start:.1f}s: "
          f"{', '.join(p.name for p in paths.values())}", flush=True)

    gru = check_gru(device)
    gru_bf16 = check_gru(device, BF16)
    stamp("phases 2-3")
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as tmp:
        # phases 6-7b reach no kernel and share nothing with the Dreamer
        # phases: a child runs them on the card beside this process, which
        # waits for it before phase 8's kernel profiles
        model_free_child = _start_model_free(tmp)
        try:
            path = main_path(tmp)
            parity = serve_step_parity(path["ckpt"])
            train = train_path(tmp)
            train_parity = train_step_parity()
            stamp("phases 4-5")
            # the serving planes: the first DV3 run's checkpoint (A) and the
            # resumed run's (B, the same run's version_1)
            ckpt_a, ckpt_b = (train[name]["summary"]["checkpoint"] for name in ("train", "resume"))
            planes = {"reload": reload_path(ckpt_a, ckpt_b, tmp), "torn_reload": torn_reload_path(ckpt_a, ckpt_b, tmp),
                      "swap": swap_parity(ckpt_a, ckpt_b, tmp), "supervisor": supervisor_path(path["ckpt"], tmp),
                      "telemetry_cost": telemetry_cost(path["ckpt"], tmp)}
            stamp("phase 5a")
            # seconds per gradient step in float32, then in bf16, one after the other
            train_timing, warm = time_train_steps()
            bf16 = {}
            bf16["timing"], warm_bf16 = time_train_steps(precision=BF16_PRECISION)
            bf16.update(train_path_bf16(tmp))
            bf16["serve"] = serve_path_bf16(bf16["ckpt"], tmp)
            bf16["serve_parity"] = serve_step_parity(bf16["ckpt"], BF16_PRECISION)
            bf16["train_parity"] = train_step_parity(precision=BF16_PRECISION)
            stamp("phase 5b")
            # the rest of the Dreamer-V3 family: Plan2Explore at the DOA++ widths
            # and Offline Dreamer at S, both bf16-mixed
            p2e = p2e_path(tmp)
            odv3 = odv3_path(tmp)
            p2e["parity"] = family_step_parity("p2e")
            odv3["parity"] = family_step_parity("odv3")
            p2e["timing"], p2e_warm = time_family_steps("p2e")
            stamp("phase 5c")
            # Dreamer-V2 and V1 in float32 at their exps' widths
            dv2, dv1 = dv_path("dreamer_v2", tmp), dv_path("dreamer_v1", tmp)
            dv2["parity"] = family_step_parity("dv2", actor_rtol=TRAIN_STEP_RTOL)
            dv1["parity"] = family_step_parity("dv1", actor_rtol=TRAIN_STEP_RTOL)
            dv2["timing"], dv2_warm = time_family_steps("dv2")
            dv1["timing"], dv1_warm = time_family_steps("dv1")
            stamp("phase 5d")
            # Plan2Explore on Dreamer-V2 and V1, and SAC-AE, float32 at their exps' widths
            p2e_dv2, p2e_dv1, sac_ae = p2e_dv_path(2, tmp), p2e_dv_path(1, tmp), sac_ae_path(tmp)
            p2e_dv2["parity"] = family_step_parity("p2e_dv2", actor_rtol=TRAIN_STEP_RTOL)
            p2e_dv1["parity"] = family_step_parity("p2e_dv1", actor_rtol=TRAIN_STEP_RTOL)
            sac_ae["parity"] = sac_ae_step_parity()
            p2e_dv2["timing"], p2e_dv2_warm = time_family_steps("p2e_dv2")
            p2e_dv1["timing"], p2e_dv1_warm = time_family_steps("p2e_dv1")
            sac_ae["timing"], sac_ae_warm = time_sac_ae()
            stamp("phase 5e")
            # the decoupled topology in one process: DV3 S, PPO and SAC through the
            # entry points; one learner round of each card vs CPU; round seconds
            decoupled = decoupled_paths(tmp)
            decoupled["round_parity"] = {kind: decoupled_round_parity(kind) for kind in ("ppo", "sac", "dv3")}
            decoupled["rounds"] = time_decoupled_rounds()
            stamp("phase 7c")
            # the decoupled topology as two processes (a player and a learner on the
            # card, joined by the store) beside the thread mode: DV3 S, PPO and SAC
            two_process = two_process_paths(os.path.join(tmp, "two_process"))
            stamp("phase 7d")
            # the training resilience plane: DV3 S as a gang of two processes whose
            # learner is SIGKILLed, restarted from its newest manifest-complete checkpoint
            gang = gang_path(tmp)
            stamp("phase 7e")
            mf = _finish_model_free(model_free_child)
            ppo, a2c, rppo, anakin, sac, droq, sac_anakin = (
                mf[k] for k in ("ppo", "a2c", "rppo", "anakin", "sac", "droq", "sac_anakin"))
            stamp("the model-free child's phases 6-7b and their profiles")
            profile_gru(gru["rows"] + gru_bf16["rows"], device)
            stamp("phase 8, the kernel's profiles")
            profile = profile_ticks(path["ckpt"])
            train_timing["profile"] = profile_train_steps(warm)
            bf16["timing"]["profile"] = profile_train_steps(warm_bf16)
            p2e["timing"]["profile"] = profile_train_steps(p2e_warm, steps=2)
            dv2["timing"]["profile"] = profile_train_steps(dv2_warm, steps=2)
            dv1["timing"]["profile"] = profile_train_steps(dv1_warm, steps=2)
            p2e_dv2["timing"]["profile"] = profile_train_steps(p2e_dv2_warm, steps=2)
            p2e_dv1["timing"]["profile"] = profile_train_steps(p2e_dv1_warm, steps=2)
            stamp("phase 8, the Dreamer steps' profiles")
            sac_ae["timing"]["profile"] = profile_sac_ae_phase(sac_ae_warm)
            stamp("phase 8")
            del warm, warm_bf16, p2e_warm, dv2_warm, dv1_warm, p2e_dv2_warm, p2e_dv1_warm, sac_ae_warm
        finally:
            if model_free_child["proc"].poll() is None:
                model_free_child["proc"].kill()
                model_free_child["proc"].wait()

    main_row = next(r for r in gru["rows"] if (r["preset"], r["B"], r["K"], r["H"]) == MAIN_SHAPE)
    train_rows = [r for r in gru["rows"] if (r["preset"], r["B"], r["K"], r["H"]) in TRAIN_SHAPES]
    p2e_rows = [r for r in gru["rows"] + gru_bf16["rows"] if (r["preset"], r["B"], r["K"], r["H"]) in P2E_SHAPES]
    dv2_rows = [r for r in gru["rows"] + gru_bf16["rows"] if (r["preset"], r["B"], r["K"], r["H"]) in DV2_SHAPES]
    p2e_dv2_rows = [r for r in gru["rows"] + gru_bf16["rows"]
                    if (r["preset"], r["B"], r["K"], r["H"]) in P2E_DV2_SHAPES]
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
                # recurrent PPO reaches no TPU kernel either (its cell is an LSTM)
                **{f"rppo_{name}": rppo[name]["launches"][LN_GRU.name]
                   for name in ("train", "resume", "evaluation", "serve")},
                # the Anakin topology reaches no TPU kernel either (its agent is an MLP)
                **{f"ppo_anakin_{name}": anakin[name]["launches"][LN_GRU.name]
                   for name in ("train", "resume", "evaluation", "serve")},
                **{f"a2c_anakin_{name}": anakin[f"a2c_{name}"]["launches"][LN_GRU.name]
                   for name in ("train", "resume", "evaluation")},
                # SAC and DroQ reach no TPU kernel either
                **{f"sac_{name}": sac[name]["launches"][LN_GRU.name]
                   for name in ("train", "resume", "evaluation", "serve")},
                "droq": droq["launches"][LN_GRU.name],
                # the off-policy Anakin topology reaches no TPU kernel either
                **{f"sac_anakin_{name}": sac_anakin[name]["launches"][LN_GRU.name] for name in ("train", "resume")},
                "droq_evaluation": droq["evaluation"]["launches"][LN_GRU.name],
                # DV3 S at fabric.precision=bf16-mixed: every launch with bf16 operands
                **{f"bf16_{name}": bf16[name]["launches"][LN_GRU.name]
                   for name in ("train", "resume", "evaluation", "serve")},
                # the serving planes: one launch a tick across the swap, under the
                # torn candidate, and in both attempts of the supervised run
                **{f"serve_{name}": planes[name]["launches"][LN_GRU.name]
                   for name in ("reload", "torn_reload", "supervisor")},
                # Plan2Explore at the DOA++ widths and Offline Dreamer at S, bf16:
                # 94 (P2E) or 79 launches a gradient step plus one a policy step
                **{f"p2e_{name}": p2e[name]["launches"][LN_GRU.name]
                   for name in ("train", "resume", "evaluation", "finetune", "finetune_evaluation")},
                **{f"odv3_{name}": odv3[name]["launches"][LN_GRU.name] for name in ("train", "resume", "evaluation")},
                # Dreamer-V2 and V1 in float32: 65 launches a DV2 gradient step plus one
                # a policy step and one a serving tick; DV1's cell launches none
                **{f"{fam}_{name}": res[name]["launches"][LN_GRU.name]
                   for fam, res in (("dv2", dv2), ("dv1", dv1)) for name in ("train", "resume", "evaluation", "serve")},
                # Plan2Explore on DV2 (80 launches an exploration step, 65 a finetuning
                # step, plus one a policy step) and on DV1 (none); SAC-AE none
                **{f"{fam}_{name}": res[name]["launches"][LN_GRU.name]
                   for fam, res in (("p2e_dv2", p2e_dv2), ("p2e_dv1", p2e_dv1))
                   for name in ("train", "resume", "evaluation", "finetune", "finetune_evaluation")},
                **{f"sac_ae_{name}": sac_ae[name]["launches"][LN_GRU.name] for name in ("train", "resume", "evaluation")},
                # the decoupled topology: DV3 S's player and learner threads (79 a
                # gradient step plus one a policy step, as the coupled run of the
                # same config beside it); PPO's and SAC's none
                **{f"dv3_decoupled_{name}": decoupled["dv3"][name]["launches"][LN_GRU.name]
                   for name in ("train", "resume", "evaluation")},
                "dv3_coupled_same_config": decoupled["dv3"]["coupled"]["launches"][LN_GRU.name],
                **{f"{fam}_decoupled_{name}": decoupled[fam][name]["launches"][LN_GRU.name]
                   for fam in ("ppo", "sac") for name in ("train", "resume", "evaluation")},
                # the decoupled topology as two processes, by role (DV3's player and
                # learner add up to the thread mode's run beside them); PPO's and SAC's none
                **{f"{fam}_two_process_{role}": two_process[fam]["launches"][role]
                   for fam in ("dv3", "ppo", "sac") for role in ("player", "learner", "thread")},
                # the gang's restarted attempt, by role (its killed attempt reports none)
                **{f"dv3_gang_attempt1_{role}": gang["attempt1_launches"][role] for role in ("player", "learner")},
            },
            "launches_needed_by_path": {
                **{f"p2e_{name}": p2e[name]["need"] for name in ("train", "resume", "finetune")},
                **{f"odv3_{name}": odv3[name]["need"] for name in ("train", "resume")},
                **{f"{fam}_{name}": res[name]["need"]
                   for fam, res in (("dv2", dv2), ("dv1", dv1)) for name in ("train", "resume", "serve")},
                **{f"{fam}_{name}": res[name]["need"]
                   for fam, res in (("p2e_dv2", p2e_dv2), ("p2e_dv1", p2e_dv1)) for name in ("train", "resume", "finetune")},
                **{f"dv3_decoupled_{name}": decoupled["dv3"][name]["need"] for name in ("train", "resume")},
                "dv3_coupled_same_config": decoupled["dv3"]["coupled"]["need"],
                "dv3_two_process": two_process["dv3"]["need"],
                "dv3_gang_attempt1": gang["attempt1_need"],
            },
            "launches_by_dtype": {
                **{name: bf16[name]["by_dtype"] for name in ("train", "resume", "evaluation", "serve")},
                **{f"p2e_{name}": p2e[name]["by_dtype"] for name in ("train", "resume", "finetune")},
                **{f"odv3_{name}": odv3[name]["by_dtype"] for name in ("train", "resume")},
            },
            "p2e_rows": [{"dtype": r["dtype"], **{k: r[k] for k in keep if k in r}} for r in p2e_rows],
            "dv2_rows": [{"dtype": r["dtype"], **{k: r[k] for k in keep if k in r}} for r in dv2_rows],
            "p2e_dv2_rows": [{"dtype": r["dtype"], **{k: r[k] for k in keep if k in r}} for r in p2e_dv2_rows],
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
                 "p2e": p2e, "odv3": odv3, "dv2": dv2, "dv1": dv1, "p2e_dv2": p2e_dv2, "p2e_dv1": p2e_dv1,
                 "sac_ae": sac_ae,
                 "ppo": ppo, "rppo": rppo, "a2c": a2c, "anakin": anakin, "sac": sac, "droq": droq,
                 "sac_anakin": sac_anakin, "decoupled": decoupled, "two_process": two_process, "gang": gang,
                 "resilience": mf["resilience"],
                 "kernels": kernels, "phase_done_at_seconds": stamps},
                f, indent=2,
            )
    print(json.dumps({"kernels": kernels}))
    print(card_line())
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

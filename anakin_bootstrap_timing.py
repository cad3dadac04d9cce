"""Times the Anakin loop's truncation bootstrap on one CUDA card, two ways.

- ``dense``: the port's ``truncation_bootstrap``: the critic on all T*E
  terminal observations of a rollout, masked to the truncated rows;
- ``sparse``: the JAX package's design, kept here only to be measured: the
  truncated rows gathered with ``torch.nonzero_static`` up to the static
  bound ``E * (1 + T // limit)``, the critic on those, and the bonus
  scattered back with ``index_put_(accumulate=True)``.

At ``exp=ppo_anakin`` (64 envs x 128 steps) and at
``exp=ppo_anakin_benchmarks``' width (8192 x 128), TF32 as the config sets it:
the wall time of whole iterations (``AnakinProgram.step``, host clock
synchronised at both ends) in the order dense, sparse, sparse, dense after a
warm iteration of each; the host time of one bootstrap call (synchronised at
both ends) and its device time (CUDA events); the largest gap between the two
variants' rewards on one rollout with one truncation an env. Run from the
repo root on a machine with a card:

    python3 anakin_bootstrap_timing.py [--iters N] [--out chiprun_out/anakin_bootstrap_timing.json]

It exits 1 without a card.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

import torch


def sparse_truncation_bootstrap(values_fn, rewards, truncated, terminal_obs, gamma: float, max_truncations: int):
    T, E = truncated.shape
    rows = T * E
    idx = torch.nonzero_static(truncated.reshape(rows), size=max_truncations, fill_value=rows)[:, 0]
    valid = idx < rows
    term_obs = terminal_obs.reshape(rows, -1)[torch.clamp(idx, max=rows - 1)]
    term_v = values_fn(term_obs).squeeze(-1) * valid
    bonus = torch.zeros(rows + 1, dtype=rewards.dtype, device=rewards.device)
    bonus.index_put_((idx,), gamma * term_v, accumulate=True)
    return rewards + bonus[:rows].reshape(T, E, 1)


def card_line() -> str:
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip()


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--iters", type=int, default=4)
    ap.add_argument("--out", default="chiprun_out/anakin_bootstrap_timing.json")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("anakin_bootstrap_timing.py needs a CUDA card", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import chip_smoke
    import sheeprl_tpu_torch.algos.ppo.anakin as anakin

    dense = anakin.truncation_bootstrap
    result = {"card": card_line(), "torch": torch.__version__, "iters": args.iters, "widths": {}}
    for exp in ("ppo_anakin", "ppo_anakin_benchmarks"):
        programs, cfg = chip_smoke._anakin_programs(exp, ("gpu",), precision=None)
        p = programs["gpu"]
        T, E = p.rollout_steps, p.num_envs
        bound = min(E * (1 + T // int(p.env.spec.max_episode_steps)), T * E)

        def sparse(values_fn, rewards, truncated, terminal_obs, gamma):
            return sparse_truncation_bootstrap(values_fn, rewards, truncated, terminal_obs, gamma, bound)

        variants = {"dense": dense, "sparse": sparse}
        g = torch.Generator(device=p.device).manual_seed(91)
        env_state, obs = p.env.reset(g)
        for name in ("dense", "sparse"):  # a warm iteration of each
            anakin.truncation_bootstrap = variants[name]
            o = p.step(env_state, obs, p.draw_inputs(g), 0.2, 0.0)
            env_state, obs = o.env_state, o.obs
        walls = {"dense": [], "sparse": []}
        for name in ("dense", "sparse", "sparse", "dense"):
            anakin.truncation_bootstrap = variants[name]
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(args.iters):
                o = p.step(env_state, obs, p.draw_inputs(g), 0.2, 0.0)
                env_state, obs = o.env_state, o.obs
            torch.cuda.synchronize()
            walls[name].append((time.perf_counter() - t0) / args.iters)
        anakin.truncation_bootstrap = dense

        # the last rollout's trajectory, one truncation an env at a random
        # step (within the sparse bound), both bootstraps on it
        traj = o.traj
        truncated = torch.zeros(T, E, dtype=torch.bool, device=p.device)
        truncated[torch.randint(0, T, (E,), generator=g, device=p.device), torch.arange(E, device=p.device)] = True
        bargs = (p.values, traj["rewards"], truncated, traj["terminal_observation"], p.gamma)
        gap = (dense(*bargs) - sparse(*bargs)).abs().max().item()
        calls = {}
        for name in ("dense", "sparse", "sparse", "dense"):
            fn = variants[name]
            torch.cuda.synchronize()
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            t0 = time.perf_counter()
            start.record()
            for _ in range(20):
                fn(*bargs)
            end.record()
            torch.cuda.synchronize()
            host_ms = (time.perf_counter() - t0) * 1e3 / 20
            calls.setdefault(name, []).append({"host_ms": host_ms, "device_ms": start.elapsed_time(end) / 20})
        result["widths"][exp] = {
            "envs": E, "steps": T, "limit": int(p.env.spec.max_episode_steps), "sparse_bound": bound,
            "loop_truncated_rows": int(traj["truncated"].sum().item()),
            "iteration_wall_s": walls, "bootstrap_call": calls, "max_abs_gap": gap,
        }
        print(f"[bootstrap-timing] {exp}: {json.dumps(result['widths'][exp])}", flush=True)
        del programs, p, o, traj, bargs
        torch.cuda.empty_cache()
    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    with open(args.out, "w") as fh:
        json.dump(result, fh, indent=1)
    print(result["card"])
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())

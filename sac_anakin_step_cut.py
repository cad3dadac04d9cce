"""The training length at which ``exp=sac_anakin``'s greedy test passes a bar, on the CPU.

Run from the root of a checkout:

    python3 sac_anakin_step_cut.py --seeds 42 1 2 --total-steps 131072 --every 8192

For each seed, trains ``exp=sac_anakin`` at the exp's widths through the
port's entry point (``fabric.accelerator=cpu``, one process a seed, all
started together), keeping a checkpoint every ``--every`` policy steps; then
plays each checkpoint's greedy test episode (``algos/sac/utils.py::test``,
the episode the training loop ends with, from the run's seed). The loop's
draws do not depend on ``algo.total_steps``, so a run of N steps is these
runs' first N steps, and each column is the test reward a run cut there
would end with. Prints one line a seed, then the least step count at which
every seed passes ``--bar`` and the least from which every later checkpoint
of every seed does.
"""

from __future__ import annotations

import argparse
import contextlib
import glob
import io
import os
import subprocess
import sys
import tempfile

REPO = os.path.dirname(os.path.abspath(__file__))


def greedy_rewards(run_dir: str) -> dict:
    """policy step -> the greedy test reward of that step's checkpoint."""
    import yaml

    from sheeprl_tpu_torch.algos.sac.agent import build_agent
    from sheeprl_tpu_torch.algos.sac.utils import test
    from sheeprl_tpu_torch.config import dotdict, repoint_targets
    from sheeprl_tpu_torch.envs import spaces
    from sheeprl_tpu_torch.envs.device import resolve_device_env
    from sheeprl_tpu_torch.parallel.fabric import Fabric
    from sheeprl_tpu_torch.utils.checkpoint import load_checkpoint

    with open(os.path.join(run_dir, "config.yaml")) as f:
        cfg = dotdict(repoint_targets(yaml.safe_load(f)))
    env, _ = resolve_device_env(cfg.env.id)
    observation_space = spaces.Dict({cfg.algo.mlp_keys.encoder[0]: env.spec.to_obs_space()})
    out = {}
    for ckpt in glob.glob(os.path.join(run_dir, "checkpoint", "*.ckpt")):
        step = int(os.path.basename(ckpt).split("_")[1])
        agent = build_agent(Fabric(accelerator="cpu"), cfg, observation_space, env.spec.action.to_space(), 0,
                            load_checkpoint(ckpt)["agent"])
        with contextlib.redirect_stdout(io.StringIO()):
            out[step] = test(agent.actor, cfg, os.path.join(run_dir, "test"))
    return dict(sorted(out.items()))


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--seeds", type=int, nargs="+", default=[42, 1, 2])
    parser.add_argument("--total-steps", type=int, default=131072)
    parser.add_argument("--every", type=int, default=8192)
    parser.add_argument("--bar", type=float, default=-400.0)
    parser.add_argument("--threads", type=int, default=1, help="torch threads of each training process")
    args = parser.parse_args()

    import torch

    torch.set_num_threads(1)
    with tempfile.TemporaryDirectory(prefix="sac_anakin_cut_") as tmp:
        env = {**os.environ, "PYTHONPATH": REPO, "OMP_NUM_THREADS": str(args.threads)}
        procs = {
            seed: subprocess.Popen(
                [sys.executable, "-m", "sheeprl_tpu_torch", "exp=sac_anakin", "fabric.accelerator=cpu",
                 f"num_threads={args.threads}", f"seed={seed}", f"algo.total_steps={args.total_steps}",
                 f"checkpoint.every={args.every}", "checkpoint.keep_last=0", "buffer.checkpoint=False",
                 "algo.run_test=False", "metric.log_level=0", "root_dir=cut", f"run_name=seed{seed}"],
                cwd=tmp, env=env, stdout=subprocess.DEVNULL, stderr=subprocess.PIPE, text=True)
            for seed in args.seeds
        }
        for seed, proc in procs.items():
            _, err = proc.communicate()
            if proc.returncode != 0:
                print(f"seed {seed}: training failed\n{err[-3000:]}", file=sys.stderr)
                return 1
        table = {seed: greedy_rewards(os.path.join(tmp, "logs", "runs", "cut", f"seed{seed}", "version_0"))
                 for seed in args.seeds}
    for seed, rewards in table.items():
        print(f"seed {seed}: " + ", ".join(f"{step}: {r:.1f}" for step, r in rewards.items()), flush=True)
    steps = sorted(set.intersection(*(set(r) for r in table.values())))
    passing = [s for s in steps if all(table[seed][s] >= args.bar for seed in table)]
    stable = [s for i, s in enumerate(steps) if all(t in passing for t in steps[i:])]
    print(f"least step count where every seed passes {args.bar}: {passing[0] if passing else None}; "
          f"least from which every later checkpoint does: {stable[0] if stable else None}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

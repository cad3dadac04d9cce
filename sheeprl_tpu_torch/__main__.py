"""``python -m sheeprl_tpu_torch [verb] [overrides]``.

- ``exp=<name> [overrides]`` (no verb): train;
- ``evaluation checkpoint_path=<ckpt or run dir> [overrides]``: one test episode;
- ``serve checkpoint_path=<ckpt or run dir> [serve.* overrides]``: serve a policy.
"""

from __future__ import annotations

import os
import sys
from typing import List, Optional

USAGE = """usage:
  python -m sheeprl_tpu_torch exp=dreamer_v3 env=dummy [overrides]      train
  python -m sheeprl_tpu_torch evaluation checkpoint_path=<ckpt or run dir>
  python -m sheeprl_tpu_torch serve checkpoint_path=<ckpt or run dir> [serve.* overrides]

Runs on a CUDA device; pass fabric.accelerator=cpu to run on the CPU.

A decoupled exp (ppo_decoupled, sac_decoupled, dreamer_v3_decoupled) runs as
two processes, each launched with the same arguments and with
SHEEPRL_COORDINATOR=host:port SHEEPRL_GANG_PROCESSES=2 SHEEPRL_GANG_RANK=0 (the
player, which opens the store on that port; port 0 picks a free one and prints
it) or SHEEPRL_GANG_RANK=1 (the learner). With
resilience.distributed.gang.processes=2 one launch does both: it supervises
the two as a gang and restarts them from the newest manifest-complete
checkpoint when one fails (logs under <run base>/gang/)."""


def _child_bringup() -> None:
    """Open the store of a multi-process run from ``SHEEPRL_COORDINATOR``,
    ``SHEEPRL_GANG_PROCESSES`` and ``SHEEPRL_GANG_RANK``, before the CLI
    (``SHEEPRL_GANG_ATTEMPT`` is the gang supervisor's attempt)."""
    coordinator = os.environ.get("SHEEPRL_COORDINATOR")
    if not coordinator:
        return
    from sheeprl_tpu_torch.parallel import distributed

    processes = int(os.environ.get("SHEEPRL_GANG_PROCESSES", "0") or 0)
    rank = int(os.environ.get("SHEEPRL_GANG_RANK", "0") or 0)
    # a gang's attempt scopes the channel's failure marker and the
    # coordinator's records, so that a restarted gang never reads the last one's
    attempt = int(os.environ.get("SHEEPRL_GANG_ATTEMPT", "0") or 0)
    print(f"[sheeprl] process {rank} of {processes}, attempt {attempt}", flush=True)
    distributed.initialize(coordinator, processes, rank)


def main(argv: Optional[List[str]] = None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    if not argv or argv[0] in ("-h", "--help", "help"):
        print(USAGE)
        return 0 if argv else 2
    verb, rest = argv[0], argv[1:]
    if "=" in verb:
        from sheeprl_tpu_torch.cli import run

        run(argv)
        return 0
    if verb == "evaluation":
        from sheeprl_tpu_torch.cli import evaluation

        evaluation(rest)
        return 0
    if verb == "serve":
        if any(a in ("-h", "--help") for a in rest):
            from sheeprl_tpu_torch.serve import main as serve_module

            print(USAGE + "\n" + (serve_module.__doc__ or ""))
            return 0
        from sheeprl_tpu_torch.serve.main import serve_main

        return serve_main(rest)
    print(f"unknown verb {verb!r}\n\n{USAGE}", file=sys.stderr)
    return 2


if __name__ == "__main__":
    _child_bringup()
    try:
        code = main()
    except BaseException as exc:
        from sheeprl_tpu_torch.parallel.decoupled import release_peer

        release_peer(exc)
        raise
    sys.exit(code)

"""``python -m sheeprl_tpu_torch <verb> [overrides]``. Verbs: ``serve``."""

from __future__ import annotations

import sys
from typing import List, Optional

USAGE = """usage: python -m sheeprl_tpu_torch serve checkpoint_path=<ckpt or run dir> [serve.* overrides]

Serves a Dreamer-V3 checkpoint (written by this package or by sheeprl_tpu) on a
CUDA device; pass fabric.accelerator=cpu to serve on the CPU."""


def main(argv: Optional[List[str]] = None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    if not argv or argv[0] in ("-h", "--help", "help"):
        print(USAGE)
        return 0 if argv else 2
    verb, rest = argv[0], argv[1:]
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
    sys.exit(main())

"""Latest-valid-checkpoint discovery (port of the file and run-dir part of
``sheeprl_tpu/resilience/discovery.py``).

A run's checkpoints live at ``<base>/<run_name>/version_N/checkpoint/ckpt_{step}_{rank}.ckpt``
as single pickle files, committed by rename (existence implies completeness) and
paired with a ``.sha256`` integrity sidecar. A per-step consistency manifest
(``ckpt_{step}.manifest.json``), when present, overrides the file heuristics: an
incomplete one vetoes the whole set. Sharded (orbax directory) checkpoints are
not ported.
"""

from __future__ import annotations

import glob
import json
import os
import re
from typing import Any, Dict, List, Optional

_STEP_RE = re.compile(r"ckpt_(\d+)(?:_\d+)?\.ckpt$")


def manifest_path(path: str) -> str:
    path = str(path)
    base = os.path.basename(path)
    m = _STEP_RE.search(base)
    name = f"ckpt_{m.group(1)}.manifest.json" if m else base + ".manifest.json"
    return os.path.join(os.path.dirname(path), name)


def read_manifest(path: str) -> Optional[Dict[str, Any]]:
    """The manifest governing ``path`` (None when there is none); an unreadable
    one reads as incomplete (``{}``)."""
    mpath = manifest_path(path)
    if not os.path.isfile(mpath):
        return None
    try:
        with open(mpath) as f:
            payload = json.load(f)
        return payload if isinstance(payload, dict) else {}
    except (OSError, ValueError):
        return {}


def _manifest_complete(manifest: Dict[str, Any]) -> bool:
    if not manifest.get("complete"):
        return False
    expected = manifest.get("ranks_expected")
    committed = manifest.get("ranks_committed")
    return not (expected and set(committed or []) != set(expected))


def checkpoint_step(path: str) -> int:
    m = _STEP_RE.search(os.path.basename(str(path)))
    return int(m.group(1)) if m else -1


def is_valid_checkpoint(path: str) -> bool:
    """A non-empty pickle file whose ``.sha256`` sidecar, when present, matches,
    and whose step manifest, when present, is complete."""
    path = str(path)
    manifest = read_manifest(path)
    if manifest is not None and not _manifest_complete(manifest):
        return False
    if not os.path.isfile(path):
        return False
    try:
        if os.path.getsize(path) <= 0:
            return False
    except OSError:
        return False
    from sheeprl_tpu_torch.utils.checkpoint import verify_sha_sidecar

    return verify_sha_sidecar(path) is not False


def iter_checkpoints(search_dir: str) -> List[str]:
    if not os.path.isdir(str(search_dir)):
        return []
    return sorted(glob.glob(os.path.join(str(search_dir), "**", "*.ckpt"), recursive=True))


def find_latest_checkpoint(search_dir: str) -> Optional[str]:
    """Newest valid checkpoint under ``search_dir`` by (mtime, parsed step)."""
    valid = [c for c in iter_checkpoints(search_dir) if is_valid_checkpoint(c)]
    if not valid:
        return None
    return max(valid, key=lambda c: (os.path.getmtime(c), checkpoint_step(c)))


def resolve_checkpoint_path(path: str) -> str:
    """An exact checkpoint file resolves to itself; a directory (a run dir, an
    experiment tree) resolves to its newest valid checkpoint. Raises
    ``FileNotFoundError`` when nothing valid is found."""
    path = str(path)
    if os.path.isfile(path):
        return path
    if os.path.isdir(path):
        found = find_latest_checkpoint(path)
        if found is not None:
            return found
        raise FileNotFoundError(
            f"checkpoint_path={path!r} is a directory with no valid checkpoint under it"
        )
    raise FileNotFoundError(f"checkpoint_path={path!r}: no such file or directory")

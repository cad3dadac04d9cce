"""Run fingerprinting: the comparability key of telemetry streams and bench JSONs.

Copy of ``sheeprl_tpu/obs/fingerprint.py`` kept by the port (which imports
nothing of the JAX package); its events keep the JAX package's names and
``SCHEMA_VERSION``, so either package's offline verbs read the other's streams.

Two event streams (or two BENCH workloads) are only worth diffing when they ran
the *same experiment* on the *same hardware shape*. The fingerprint makes that
check mechanical instead of tribal knowledge: every telemetry ``start`` event
(``obs/telemetry.py``) and every bench workload's ``conditions``
(``bench.py``) carries

- ``algo`` — the registered algorithm name;
- ``config_hash`` — a stable hash over the RESOLVED config with the volatile
  keys dropped (run/exp names carry timestamps, ``metric``/``checkpoint``/
  ``resilience``/``hydra`` are operational knobs that do not change what the
  run computes — the same exclusion set as resume-merge's non-resumable keys);
- ``code_version`` — the git sha of the working tree (plus ``-dirty`` when the
  tree has uncommitted changes), so a regression can be pinned to a commit;
- ``backend`` / ``device_kind`` / ``device_count`` / ``mesh_shape`` — the
  hardware the programs compiled for;
- ``env_backend`` — which environment plane stepped the run (``host``
  gymnasium vs the on-device ``jax`` plane, ``env.backend``);
- ``key_shapes`` — the config values that directly set compiled program shapes
  (num_envs, per-rank batch/sequence, rollout steps).

``fingerprint_compatible`` is what ``compare``/``bench-diff`` gate matching on:
``code_version`` deliberately does NOT count against compatibility (comparing
two commits is the whole point of a regression gate), everything else does.
Every field is best-effort ``None``-tolerant: a missing field never blocks a
comparison, it just cannot veto one.
"""

from __future__ import annotations

import hashlib
import json
import os
import subprocess
from typing import Any, Dict, List, Mapping, Optional, Tuple

from sheeprl_tpu_torch.obs.jsonl import _jsonable

__all__ = [
    "COMPARE_KEYS",
    "code_version",
    "config_hash",
    "fingerprint_compatible",
    "run_fingerprint",
]

# dropped from the config hash: run/exp names embed timestamps, and the
# operational groups (logging, checkpoint cadence, resilience, run-dir layout)
# do not change what the run computes — mirrors cli._NON_RESUMABLE_KEYS
_VOLATILE_TOP_KEYS = (
    "exp_name",
    "run_name",
    "root_dir",
    "checkpoint",
    "metric",
    "hydra",
    "resilience",
    "model_manager",
)

# fingerprint fields that veto comparability when BOTH sides carry a value and
# the values differ; code_version is deliberately absent (cross-commit diffs
# are the point of the regression gate). env_backend is its own top-level field
# (not a key_shapes entry) so pre-PR-7 recordings — whose key_shapes dict
# predates it — stay comparable under the None-tolerant rule while a host-env
# run can never silently diff against a jax-env run. axis_names (None-tolerant
# the same way for pre-2-D-mesh recordings) keeps a [2, 4] data x model run
# from ever silently diffing against a [2, 4]... data-only one.
COMPARE_KEYS = (
    "algo",
    "config_hash",
    "backend",
    "device_kind",
    "device_count",
    "mesh_shape",
    "axis_names",
    "env_backend",
    "buffer_backend",
    "key_shapes",
)


def canonical_mesh_shape(mesh_shape: Any) -> Optional[List[int]]:
    """One serialized form for a mesh shape no matter which container carried
    it — tuple, list, Hydra ListConfig, numpy shape, or a bare int — so two
    identical runs can never false-mismatch on ``(2, 4)`` vs ``[2, 4]``, while
    ``[8]`` vs ``[2, 4]`` stays a real veto. Returns None (fingerprint =
    unknown, never vetoes) for unresolvable values, INCLUDING shapes that still
    carry a ``-1`` wildcard: the wildcard's extent depends on the device count,
    and stamping it raw would false-mismatch against the resolved shape."""
    if mesh_shape is None:
        return None
    if isinstance(mesh_shape, (int,)) or (
        hasattr(mesh_shape, "__int__") and not hasattr(mesh_shape, "__iter__")
    ):
        mesh_shape = [mesh_shape]
    try:
        shape = [int(s) for s in mesh_shape]
    except (TypeError, ValueError):
        return None
    if any(s < 1 for s in shape):
        return None
    return shape

_CODE_VERSION_CACHE: Dict[str, Optional[str]] = {}


def config_hash(cfg: Mapping[str, Any]) -> Optional[str]:
    """Stable 12-hex-char hash over the resolved config minus the volatile keys.
    Canonical form: JSON with sorted keys over :func:`_jsonable` leaves, so dict
    ordering, numpy scalars and dotdict wrappers cannot perturb the digest."""
    try:
        pruned = {
            str(k): _jsonable(v)
            for k, v in dict(cfg).items()
            if str(k) not in _VOLATILE_TOP_KEYS
        }
        canonical = json.dumps(pruned, sort_keys=True, separators=(",", ":"))
        return hashlib.sha256(canonical.encode()).hexdigest()[:12]
    except Exception:
        return None


def code_version() -> Optional[str]:
    """Git sha of the source tree this process imported (``-dirty`` suffixed when
    the tree has uncommitted changes); ``SHEEPRL_CODE_VERSION`` overrides for
    deployments without a .git dir. Cached per process — the sha cannot change
    under a running process that already imported its code."""
    override = os.environ.get("SHEEPRL_CODE_VERSION")
    if override:
        return override
    repo = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    if repo in _CODE_VERSION_CACHE:
        return _CODE_VERSION_CACHE[repo]
    sha: Optional[str] = None
    try:
        out = subprocess.run(
            ["git", "-C", repo, "rev-parse", "--short=12", "HEAD"],
            capture_output=True,
            text=True,
            timeout=10,
        )
        if out.returncode == 0 and out.stdout.strip():
            sha = out.stdout.strip()
            dirty = subprocess.run(
                ["git", "-C", repo, "status", "--porcelain", "--untracked-files=no"],
                capture_output=True,
                text=True,
                timeout=10,
            )
            if dirty.returncode == 0 and dirty.stdout.strip():
                sha += "-dirty"
    except Exception:
        sha = None
    _CODE_VERSION_CACHE[repo] = sha
    return sha


def _key_shapes(cfg: Mapping[str, Any]) -> Dict[str, Any]:
    """The config values that directly determine compiled program shapes."""
    shapes: Dict[str, Any] = {}
    env = cfg.get("env") or {}
    algo = cfg.get("algo") or {}
    for source, key in (
        (env, "num_envs"),
        (algo, "per_rank_batch_size"),
        (algo, "per_rank_sequence_length"),
        (algo, "rollout_steps"),
    ):
        value = source.get(key) if hasattr(source, "get") else None
        if value is not None:
            try:
                shapes[key] = int(value)
            except (TypeError, ValueError):
                shapes[key] = value
    return shapes


def run_fingerprint(cfg: Mapping[str, Any], fabric: Any = None) -> Dict[str, Any]:
    """Build the run's fingerprint from its resolved config plus (optionally) the
    live fabric's device/mesh view. Every field is best-effort: unknowns are
    ``None``/absent rather than an exception — the fingerprint must never be the
    thing that takes a run down."""
    algo_cfg = cfg.get("algo") or {}
    env_cfg = cfg.get("env") or {}
    buffer_cfg = cfg.get("buffer") or {}
    fabric_cfg = cfg.get("fabric") or {}
    fp: Dict[str, Any] = {
        "algo": algo_cfg.get("name") if hasattr(algo_cfg, "get") else None,
        "config_hash": config_hash(cfg),
        "code_version": code_version(),
        "backend": None,
        "device_kind": None,
        "device_count": None,
        "mesh_shape": None,
        "axis_names": None,
        # which environment plane stepped the run (host gymnasium vs the
        # on-device jax plane): throughput across planes lives on different
        # scales, so compare/bench-diff must refuse to silently diff them
        "env_backend": str(env_cfg.get("backend") or "host")
        if hasattr(env_cfg, "get")
        else None,
        # which replay plane fed training (host local/service buffer vs the
        # on-mesh device ring): same refusal rationale as env_backend — a
        # device-ring run's throughput must never silently diff against a
        # host-replay one. None-tolerant for pre-ring recordings.
        "buffer_backend": str(buffer_cfg.get("backend") or "local")
        if hasattr(buffer_cfg, "get")
        else None,
        "key_shapes": _key_shapes(cfg),
    }
    if hasattr(fabric_cfg, "get"):
        # cfg-only route (no live fabric — bench wall-clock workloads): the
        # canonical form only sticks when fully explicit; a -1 wildcard stays
        # None so it cannot false-mismatch the resolved shape a live run stamps
        fp["mesh_shape"] = canonical_mesh_shape(fabric_cfg.get("mesh_shape"))
        axes = fabric_cfg.get("axis_names")
        if axes is not None:
            if isinstance(axes, str):
                # a scalar override (fabric.axis_names=data) arrives as a bare
                # string — wrap it like normalize_mesh_spec does, or iterating
                # would char-split it into a fingerprint that vetoes the live
                # run's ["data"]
                axes = [axes]
            try:
                fp["axis_names"] = [str(a) for a in axes]
            except TypeError:
                pass
    if fabric is not None:
        device = getattr(fabric, "device", None)
        fp["backend"] = getattr(device, "platform", None)
        fp["device_kind"] = getattr(device, "device_kind", None)
        try:
            # TOTAL mesh devices (= world_size on a 1-D mesh; on a 2-D mesh
            # world_size is only the data extent and mesh_shape carries the split)
            fp["device_count"] = int(fabric.mesh.devices.size)
        except Exception:
            try:
                fp["device_count"] = int(getattr(fabric, "world_size", None))
            except (TypeError, ValueError):
                pass
        try:
            fp["mesh_shape"] = canonical_mesh_shape(fabric.mesh.devices.shape)
        except Exception:
            pass
        try:
            fp["axis_names"] = [str(a) for a in fabric.mesh.axis_names]
        except Exception:
            pass
    return fp


def fingerprint_compatible(
    a: Optional[Mapping[str, Any]], b: Optional[Mapping[str, Any]]
) -> Tuple[bool, List[str]]:
    """Whether two fingerprints describe comparable runs: every
    :data:`COMPARE_KEYS` field where BOTH sides carry a value must match
    (missing/None fields never veto — old recordings stay comparable).
    Returns ``(compatible, mismatched_keys)``."""
    if not a or not b:
        return True, []
    mismatches: List[str] = []
    for key in COMPARE_KEYS:
        va, vb = a.get(key), b.get(key)
        if va is None or vb is None:
            continue
        if _jsonable(va) != _jsonable(vb):
            mismatches.append(key)
    return not mismatches, mismatches

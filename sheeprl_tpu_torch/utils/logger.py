"""The run's log directory (port of ``get_log_dir`` of ``sheeprl_tpu/utils/logger.py``).

A run writes into ``<hydra.run.dir>/version_N`` (``hydra.run.dir`` defaults to
``logs/runs/<root_dir>/<run_name>``), N one more than the highest version
already there. Metric loggers are not yet ported: ``metric.log_level`` must be 0.
"""

from __future__ import annotations

import os
from pathlib import Path


def run_base_dir(cfg) -> Path:
    hydra_dir = ((cfg.get("hydra") or {}).get("run") or {}).get("dir")
    return Path(hydra_dir) if hydra_dir else Path("logs") / "runs" / cfg.root_dir / cfg.run_name


def get_log_dir(cfg) -> str:
    base = run_base_dir(cfg)
    versions = []
    if base.is_dir():
        for d in base.iterdir():
            if d.name.startswith("version_") and d.name[len("version_") :].isdigit():
                versions.append(int(d.name[len("version_") :]))
    log_dir = str(base / f"version_{max(versions) + 1 if versions else 0}")
    os.makedirs(log_dir, exist_ok=True)
    return log_dir

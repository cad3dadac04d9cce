"""Training and evaluation entry points (port of ``run``,
``resume_from_checkpoint`` and ``evaluation`` of ``sheeprl_tpu/cli.py``).

``python -m sheeprl_tpu_torch exp=dreamer_v3 env=dummy ...`` composes the
config, merges a checkpoint's config over it when ``checkpoint.resume_from``
is set, refuses what is not ported, and runs the algorithm's loop on the card
(``fabric.accelerator=cpu`` for the CPU).

``python -m sheeprl_tpu_torch evaluation checkpoint_path=<ckpt or run dir>``
plays one test episode of a checkpoint (written by either package) with the
config saved beside it.

Config keys the port keeps but does not act on yet accept only their off
values: telemetry, the profiler, the supervisor, fault injection, the
watchdog, gangs, the replay prefetch thread and service backend, sharded and
asynchronous checkpoints.
"""

from __future__ import annotations

import sys
from pathlib import Path
from typing import Any, Callable, Dict, List, Optional, Sequence

# config groups a resumed run keeps from this launch, not from the checkpoint
_NON_RESUMABLE_KEYS = ("checkpoint", "exp_name", "run_name", "root_dir", "metric", "resilience")


def _config_beside(ckpt_path: Path) -> Path:
    for cfg_path in (ckpt_path.parent.parent / "config.yaml", ckpt_path.parent / "config.yaml"):
        if cfg_path.is_file():
            return cfg_path
    raise ValueError(f"no config.yaml found next to the checkpoint {ckpt_path}")


def resume_from_checkpoint(cfg, overrides: Optional[Sequence[str]] = None):
    """The checkpoint's config merged over ``cfg``, keeping this launch's
    non-resumable groups; the environment and the algorithm must match.
    ``checkpoint.resume_from=latest`` resolves to the newest valid checkpoint
    of the experiment first. Values typed on this launch's command line
    (``overrides``) are applied again after the merge."""
    import yaml

    from sheeprl_tpu_torch.config import deep_merge, dotdict, explicit_overrides, repoint_targets, set_by_path
    from sheeprl_tpu_torch.resilience.discovery import resolve_checkpoint_path
    from sheeprl_tpu_torch.utils.logger import run_base_dir

    if str(cfg.checkpoint.resume_from).strip().lower() == "latest":
        base = run_base_dir(cfg)
        cfg.checkpoint.resume_from = resolve_checkpoint_path(str(base if base.is_dir() else base.parent))
    ckpt_path = Path(cfg.checkpoint.resume_from)
    with open(_config_beside(ckpt_path)) as f:
        old_cfg = repoint_targets(yaml.safe_load(f))
    if old_cfg["env"]["id"] != cfg.env.id:
        raise ValueError(
            "This experiment is run with a different environment from the one of the experiment "
            f"you want to restart: got {cfg.env.id}, expected {old_cfg['env']['id']}"
        )
    if old_cfg["algo"]["name"] != cfg.algo.name:
        raise ValueError(
            "This experiment is run with a different algorithm from the one of the experiment "
            f"you want to restart: got {cfg.algo.name}, expected {old_cfg['algo']['name']}"
        )
    explicit = explicit_overrides(overrides) if overrides else {}
    non_resumable = _NON_RESUMABLE_KEYS
    # a launch that names its own run keeps its own run-dir layout
    if any(k in ("exp_name", "run_name", "root_dir") or k.startswith("hydra.") for k in explicit):
        non_resumable = non_resumable + ("hydra",)
    merged = dict(old_cfg)
    deep_merge(merged, {k: cfg[k] for k in non_resumable if k in cfg})
    merged["checkpoint"]["resume_from"] = str(ckpt_path)
    result = dotdict(merged)
    for key, value in explicit.items():
        if key == "checkpoint.resume_from":
            continue
        try:
            set_by_path(result, key, value, create=True)
        except (KeyError, TypeError):
            continue  # a group the old config lacks
    return result


def unported_settings(cfg) -> List[str]:
    """The settings of ``cfg`` that ask for something not yet ported."""
    metric = cfg.get("metric") or {}
    telemetry = metric.get("telemetry") or {}
    resilience = cfg.get("resilience") or {}
    buffer = cfg.get("buffer") or {}
    checkpoint = cfg.get("checkpoint") or {}
    checks = {
        "metric.telemetry.enabled": bool(telemetry.get("enabled")),
        "metric.telemetry.http_port": telemetry.get("http_port") is not None,
        "metric.profiler.mode": str((metric.get("profiler") or {}).get("mode", "off")) != "off",
        "resilience.supervisor.enabled": bool((resilience.get("supervisor") or {}).get("enabled")),
        "resilience.fault.kind": bool((resilience.get("fault") or {}).get("kind")),
        "resilience.watchdog.enabled": bool((resilience.get("watchdog") or {}).get("enabled")),
        "resilience.distributed.gang.processes >= 2": int(
            (((resilience.get("distributed") or {}).get("gang") or {}).get("processes") or 0)
        ) >= 2,
        # the thread samples ahead for Dreamer-V3; PPO and A2C do not read the key
        "buffer.prefetch.enabled (the prefetch thread)": bool((buffer.get("prefetch") or {}).get("enabled"))
        and str((cfg.get("algo") or {}).get("name", "")).startswith("dreamer"),
        "buffer.backend other than local": str(buffer.get("backend", "local")) != "local",
        "checkpoint.backend other than pickle": str(checkpoint.get("backend", "pickle")) != "pickle",
        "checkpoint.async_save": bool(checkpoint.get("async_save")),
    }
    return [name for name, on in checks.items() if on]


def check_configs(cfg) -> Callable:
    """The training loop of ``cfg.algo.name``; raises for an unknown algorithm
    or a setting that is not yet ported."""
    from sheeprl_tpu_torch.utils.registry import ALGORITHMS, load_entrypoint

    main = load_entrypoint(ALGORITHMS, cfg.algo.name, "training loop")
    unported = unported_settings(cfg)
    if unported:
        raise NotImplementedError(
            f"{', '.join(unported)}: not yet ported to sheeprl_tpu_torch (only the off values are accepted)"
        )
    return main


def _fabric(cfg):
    from sheeprl_tpu_torch.parallel.fabric import Fabric

    return Fabric(
        devices=cfg.fabric.get("devices", 1),
        num_nodes=cfg.fabric.get("num_nodes", 1),
        accelerator=cfg.fabric.get("accelerator", "auto"),
        precision=cfg.fabric.get("precision", "32-true"),
        float32_matmul_precision=cfg.get("float32_matmul_precision", "high"),
    )


def setup_metrics(cfg) -> None:
    """Keep only the algorithm's own aggregator metrics (its ``AGGREGATOR_KEYS``),
    and switch the aggregator and the timers by ``metric.log_level`` (the
    timers also by ``metric.disable_timer``); the timers start from zero."""
    import importlib

    from sheeprl_tpu_torch.utils.metric import MetricAggregator
    from sheeprl_tpu_torch.utils.registry import ALGORITHMS
    from sheeprl_tpu_torch.utils.timer import timer

    log_level = int(cfg.metric.log_level)
    utils_module = ALGORITHMS[cfg.algo.name][0].rsplit(".", 1)[0] + ".utils"
    keys = set(getattr(importlib.import_module(utils_module), "AGGREGATOR_KEYS", ()))
    if log_level > 0 and keys:
        metrics = cfg.metric.aggregator.metrics
        cfg.metric.aggregator.metrics = {
            k: v for k, v in metrics.items() if k in keys or any(k.startswith(p + "_") for p in keys)
        }
    timer.disabled = log_level == 0 or bool(cfg.metric.get("disable_timer", False))
    timer.to_dict(reset=True)
    MetricAggregator.disabled = log_level == 0


def run_algorithm(cfg) -> Any:
    """Registry lookup, metrics, fabric, then the algorithm's ``main(fabric, cfg)``."""
    import torch

    main = check_configs(cfg)
    setup_metrics(cfg)
    torch.set_num_threads(int(cfg.get("num_threads") or 1))
    return main(_fabric(cfg), cfg)


def run(args: Optional[Sequence[str]] = None) -> Any:
    """``python -m sheeprl_tpu_torch exp=... [overrides]``. Returns the loop's
    summary; a run stopped by SIGTERM/SIGINT (after its emergency checkpoint)
    exits with code 75."""
    from sheeprl_tpu_torch.config import compose
    from sheeprl_tpu_torch.resilience import signals

    overrides = list(args if args is not None else sys.argv[1:])
    cfg = compose(overrides)
    if cfg.checkpoint.resume_from:
        cfg = resume_from_checkpoint(cfg, overrides=overrides)
    installed = bool((cfg.get("resilience") or {}).get("handler", True)) and signals.install_preemption_handler()
    try:
        summary = run_algorithm(cfg)
        preempted = signals.preemption_requested()
    finally:
        if installed:
            signals.uninstall_preemption_handler()
    if isinstance(summary, dict):
        shown = {k: v for k, v in summary.items() if k != "metrics"}
        print(f"[sheeprl] run summary: {shown}", flush=True)
    if preempted:
        raise SystemExit(signals.PREEMPTED_EXIT_CODE)
    return summary


def evaluation(args: Optional[Sequence[str]] = None) -> Any:
    """``python -m sheeprl_tpu_torch evaluation checkpoint_path=... [overrides]``:
    ``seed``, ``fabric.accelerator`` and ``env.capture_video`` are taken from
    the command line, everything else from the checkpoint's config.yaml.
    Returns the test episode's reward."""
    import yaml

    from sheeprl_tpu_torch.config import dotdict, repoint_targets
    from sheeprl_tpu_torch.resilience.discovery import resolve_checkpoint_path
    from sheeprl_tpu_torch.utils.checkpoint import load_checkpoint
    from sheeprl_tpu_torch.utils.registry import EVALUATIONS, load_entrypoint

    overrides = list(args if args is not None else sys.argv[1:])
    kv = dict(o.split("=", 1) for o in overrides if "=" in o)
    if kv.get("checkpoint_path") is None:
        raise ValueError("you must specify checkpoint_path=...")
    ckpt_path = Path(resolve_checkpoint_path(kv["checkpoint_path"]))
    with open(_config_beside(ckpt_path)) as f:
        base = repoint_targets(yaml.safe_load(f))
    base["env"]["num_envs"] = 1
    base["env"]["capture_video"] = yaml.safe_load(kv.get("env.capture_video", "true"))
    base.setdefault("fabric", {})
    base["fabric"]["devices"] = 1
    base["checkpoint_path"] = str(ckpt_path)
    base["seed"] = int(kv.get("seed", base.get("seed", 42)))
    if "fabric.accelerator" in kv:
        base["fabric"]["accelerator"] = kv["fabric.accelerator"]
    cfg = dotdict(base)
    if cfg.get("float32_matmul_precision", "high") not in ("default", "high", "highest", "medium"):
        raise ValueError(f"float32_matmul_precision={cfg.float32_matmul_precision!r} is not a torch setting")
    evaluate_fn = load_entrypoint(EVALUATIONS, cfg.algo.name, "evaluation")
    fabric = _fabric(cfg)
    return evaluate_fn(fabric, cfg, load_checkpoint(cfg.checkpoint_path))

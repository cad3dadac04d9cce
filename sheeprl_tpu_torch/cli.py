"""Training and evaluation entry points (port of ``run``,
``resume_from_checkpoint`` and ``evaluation`` of ``sheeprl_tpu/cli.py``).

``python -m sheeprl_tpu_torch exp=dreamer_v3 env=dummy ...`` composes the
config, merges a checkpoint's config over it when ``checkpoint.resume_from``
is set, refuses what is not ported, and runs the algorithm's loop on the card
(``fabric.accelerator=cpu`` for the CPU).

``python -m sheeprl_tpu_torch evaluation checkpoint_path=<ckpt or run dir>``
plays one test episode of a checkpoint (written by either package) with the
config saved beside it.

``fabric.precision=bf16-mixed|bf16-true`` runs Dreamer-V3, Plan2Explore and
Offline Dreamer in bf16 (float32 parameters); the other algorithms refuse it
as not yet ported, in training, evaluation and serving alike.

``exp=p2e_dv{1,2,3}_finetuning checkpoint.exploration_ckpt_path=<ckpt>``
finetunes from an exploration checkpoint of either package, taking the
exploration run's environment settings from the config.yaml beside it.

Config keys the port keeps but does not act on yet accept only their off
values: telemetry, the profiler, the supervisor, fault injection, the
watchdog, gangs, the replay prefetch thread and service backend, sharded and
asynchronous checkpoints. ``buffer.backend=device`` (the replay ring on the
card) is for ``sac_anakin`` only, as in the JAX CLI.

The port runs in one process: a launch of more than one is refused. The
decoupled algorithms (a player loop and a learner thread) take the JAX CLI's
checks of their topology (``check_topology``).
"""

from __future__ import annotations

import os
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


def check_buffer_backend(cfg) -> None:
    """The JAX CLI's checks of ``buffer.backend``: a known backend, and the
    device ring for ``sac_anakin`` only."""
    backend = str((cfg.get("buffer") or {}).get("backend", "local"))
    if backend not in ("local", "service", "device"):
        raise ValueError(
            f"unknown buffer.backend {backend!r}; available: local (in-process replay, "
            "the default), service (standalone experience data plane for the "
            "decoupled topologies — see howto/fleet.md) and device (on-mesh replay "
            "ring for the fused off-policy topology — see howto/device_replay.md)"
        )
    if backend == "device" and cfg.algo.name != "sac_anakin":
        raise ValueError(
            f"buffer.backend=device is wired for the fused off-policy topology "
            f"(sac_anakin), not {cfg.algo.name!r} — host loops would round-trip the "
            "ring every step, losing exactly what it buys (howto/device_replay.md)"
        )


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
        # the thread samples ahead for the replay loops; the on-policy loops do not read the key
        "buffer.prefetch.enabled (the prefetch thread)": bool((buffer.get("prefetch") or {}).get("enabled"))
        and str((cfg.get("algo") or {}).get("name", "")) not in ("ppo", "a2c", "ppo_recurrent", "ppo_anakin",
                                                                  "a2c_anakin", "sac_anakin", "ppo_decoupled"),
        "buffer.backend=service": str(buffer.get("backend", "local")) == "service",
        "checkpoint.backend other than pickle": str(checkpoint.get("backend", "pickle")) != "pickle",
        "checkpoint.async_save": bool(checkpoint.get("async_save")),
    }
    return [name for name, on in checks.items() if on]


# the algorithms ported at the bf16 policies (fabric.precision=bf16-mixed|bf16-true)
BF16_ALGORITHMS = ("dreamer_v3", "p2e_dv3_exploration", "p2e_dv3_finetuning", "offline_dreamer")


def unported_precision(cfg) -> None:
    """Raise for a bf16 ``fabric.precision`` of an algorithm the port runs
    only in float32 (the JAX package runs PPO, A2C, SAC and DroQ at bf16 too)."""
    precision = str((cfg.get("fabric") or {}).get("precision", "32-true"))
    algo = str((cfg.get("algo") or {}).get("name", ""))
    if precision.startswith("bf16") and algo not in BF16_ALGORITHMS:
        raise NotImplementedError(
            f"fabric.precision={precision} for {algo}: bf16 is not yet ported to sheeprl_tpu_torch "
            f"for this algorithm (ported at bf16: {', '.join(BF16_ALGORITHMS)})"
        )


def launch_processes() -> int:
    """The processes this launch says it has: ``torchrun``'s ``WORLD_SIZE`` or
    the JAX package's gang (``SHEEPRL_GANG_PROCESSES``)."""
    return max(int(os.environ.get(var) or 1) for var in ("WORLD_SIZE", "SHEEPRL_GANG_PROCESSES"))


def check_topology(cfg) -> None:
    """The JAX CLI's checks of a decoupled algorithm's topology (at least one
    actor, no ``single_device`` strategy, ``devices >= 1``, a 1-D mesh), and
    the port's own: one process."""
    from sheeprl_tpu_torch.utils.registry import DECOUPLED

    processes = launch_processes()
    if processes > 1:
        raise NotImplementedError(
            f"a launch with {processes} processes: the port runs in one process (it has no counterpart of "
            "jax.distributed yet); launch one process, where the decoupled algorithms run their learner in a thread"
        )
    if cfg.algo.name not in DECOUPLED:
        return
    if int(os.environ.get("SHEEPRL_NUM_ACTORS", "1")) < 1:
        raise ValueError("decoupled algorithms need at least one actor process")
    fabric = cfg.get("fabric") or {}
    if str(fabric.get("strategy", "auto")) == "single_device":
        raise ValueError(
            f"{cfg.algo.name} is decoupled and is not supported by the single_device "
            "strategy; launch with 'fabric.strategy=dp' or 'fabric.strategy=auto'"
        )
    devices = int(fabric.get("devices", 1))
    if devices < 1:
        raise ValueError(f"decoupled algorithms need fabric.devices >= 1, got {devices}")
    mesh_shape = fabric.get("mesh_shape")
    if mesh_shape is not None and not isinstance(mesh_shape, int) and len(mesh_shape) > 1:
        raise ValueError(
            f"{cfg.algo.name} is decoupled: its player and learner run 1-D data meshes (a multi-axis "
            f"fabric.mesh_shape={list(mesh_shape)} is only supported by the coupled topologies)"
        )


def check_configs(cfg) -> Callable:
    """The training loop of ``cfg.algo.name``; raises for an unknown algorithm,
    a topology the algorithm does not take, or a setting that is not yet
    ported."""
    from sheeprl_tpu_torch.utils.registry import ALGORITHMS, load_entrypoint

    main = load_entrypoint(ALGORITHMS, cfg.algo.name, "training loop")
    check_topology(cfg)
    check_buffer_backend(cfg)
    unported_precision(cfg)
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
        deterministic_ops=bool(cfg.get("xla_deterministic_ops", False)),
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


# the environment settings a finetuning run takes from its exploration run
_EXPLORATION_ENV_KEYS = ("frame_stack", "screen_size", "action_repeat", "grayscale", "clip_rewards",
                         "frame_stack_dilation", "max_episode_steps", "reward_as_observation")


def exploration_config(cfg):
    """The config of the exploration run a P2E finetuning run starts from (the
    config.yaml beside ``checkpoint.exploration_ckpt_path``, written by either
    package): the environment must be the same, and its settings carry over
    into ``cfg``, as do the devices with ``buffer.load_from_exploration``."""
    import yaml

    from sheeprl_tpu_torch.config import dotdict, repoint_targets

    ckpt_path = Path(cfg.checkpoint.exploration_ckpt_path)
    try:
        cfg_path = _config_beside(ckpt_path)
    except ValueError:
        raise ValueError(
            f"cannot finetune from {ckpt_path}: no config.yaml found next to the exploration checkpoint"
        ) from None
    with open(cfg_path) as f:
        exploration_cfg = dotdict(repoint_targets(yaml.safe_load(f)))
    if exploration_cfg.env.id != cfg.env.id:
        raise ValueError(
            "This experiment is run with a different environment from the one of the exploration you want "
            f"to finetune. Got '{cfg.env.id}', but the environment used during exploration was "
            f"{exploration_cfg.env.id}."
        )
    for k in _EXPLORATION_ENV_KEYS:
        if k in exploration_cfg.env:
            cfg.env[k] = exploration_cfg.env[k]
    if cfg.buffer.get("load_from_exploration", False):
        cfg.fabric.devices = exploration_cfg.fabric.devices
    return exploration_cfg


def run_algorithm(cfg) -> Any:
    """Registry lookup, metrics, fabric, then the algorithm's ``main(fabric,
    cfg)``; a P2E finetuning run also gets its exploration run's config."""
    import torch

    main = check_configs(cfg)
    setup_metrics(cfg)
    torch.set_num_threads(int(cfg.get("num_threads") or 1))
    kwargs = {}
    if cfg.algo.name.startswith("p2e") and "finetuning" in cfg.algo.name:
        kwargs["exploration_cfg"] = exploration_config(cfg)
    return main(_fabric(cfg), cfg, **kwargs)


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
    ``seed``, ``fabric.accelerator``, ``env.capture_video`` and
    ``xla_deterministic_ops`` are taken from the command line, everything else
    from the checkpoint's config.yaml.
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
    if "xla_deterministic_ops" in kv:
        base["xla_deterministic_ops"] = bool(yaml.safe_load(kv["xla_deterministic_ops"]))
    cfg = dotdict(base)
    if cfg.get("float32_matmul_precision", "high") not in ("default", "high", "highest", "medium"):
        raise ValueError(f"float32_matmul_precision={cfg.float32_matmul_precision!r} is not a torch setting")
    evaluate_fn = load_entrypoint(EVALUATIONS, cfg.algo.name, "evaluation")
    unported_precision(cfg)
    fabric = _fabric(cfg)
    return evaluate_fn(fabric, cfg, load_checkpoint(cfg.checkpoint_path))

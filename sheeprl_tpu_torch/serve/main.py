"""``python -m sheeprl_tpu_torch serve checkpoint_path=<ckpt> [serve.* overrides]``
(port of ``sheeprl_tpu/serve/main.py``).

The config is read from the checkpoint's own ``config.yaml`` (written by either
package; ``_target_``/``cls`` paths of the JAX package are re-pointed at the
port), a ``serve`` block of serving knobs is merged over it (defaults below,
then dotted ``serve.*`` CLI overrides), the checkpoint is resolved by
``resolve_checkpoint_path`` (a run dir resolves to its newest valid checkpoint),
and the family's extractor builds the policy the server batches: Dreamer-V3,
PPO and A2C, SAC and DroQ.

Serving knobs (``serve.*``), as in the JAX package:

- ``slots``, ``max_batch_wait_ms``, ``greedy``, ``sessions``,
  ``max_session_steps``, ``request_timeout``, ``log_dir``, ``max_queue``,
  ``deadline_ms``, ``degraded_wait_factor``, ``drain_grace_s``;
- ``explore.{fraction,noise}``: the lowest ``round(fraction * slots)`` slots
  add session-seeded Gaussian noise to their delivered actions;
- ``reload.{enabled,poll_s,watch_dir}``: hot weight reload, following the
  watched directory's newest valid checkpoint (``serve/reload.py``);
- ``supervisor.{enabled,max_restarts,backoff,backoff_cap}``: bounded in-process
  restarts of the serve loop, with the sessions each crash lost counted;
- ``telemetry.{enabled,every}`` (on by default): ``telemetry.jsonl`` in the log
  dir, read by the JAX package's ``watch``, ``diagnose`` and ``compare``; with
  ``metric.telemetry.http_port`` set, ``/metrics`` and ``/healthz`` ride it;
- ``prime=true``: build or load the kernel libraries and run the slot step and
  attach once at ``[slots]``, then exit without serving (the port has no XLA
  compile cache to fill; what it warms is the kernels' build and first launch);
- ``resilience.fault.{kind,at_policy_step,factor}``: the serve fault kinds
  (``resilience/faults.py``); the training-only and multi-rank kinds raise.
- ``fabric.precision`` — the checkpoint's policy, or a dotted override:
  ``bf16-mixed``/``bf16-true`` serve a Dreamer-V3 checkpoint in bf16; other
  families refuse bf16.

Not ported: trajectory capture (the ``live`` verb's experience plane) and the
fleet weight plane's reload source (``serve.reload.source=subscriber``).

A restart is in-process, as in the JAX package. An injected ``crash`` is a
Python exception and restarts cleanly; a sticky CUDA error (an illegal address,
a device-side assert) cannot be cleared in-process, so every later attempt
fails too, the restarts run out, and the verb exits through the give-up path.

Each run writes ``summary.json`` into its log dir: sessions, ticks (by weight
version), served steps, wall time and the step-time percentiles.

Exit codes: ``0`` every session completed, ``1`` a session failed or the server
crashed (restarts exhausted when supervised), ``2`` nothing to drive, ``75``
SIGTERM -> drained cleanly.
"""

from __future__ import annotations

import copy
import json
import os
import sys
import threading
import time
from pathlib import Path
from typing import Any, Dict, Optional, Sequence

__all__ = ["SERVE_DEFAULTS", "build_serve_cfg", "serve_main"]

SERVE_DEFAULTS: Dict[str, Any] = {
    "slots": 4,
    "max_batch_wait_ms": 2.0,
    "greedy": True,
    "sessions": 2,
    "max_session_steps": 1000,
    "request_timeout": 120.0,
    "log_dir": None,  # default: logs/serve/<algo>_<timestamp>
    "prime": False,
    "max_queue": None,
    "deadline_ms": None,
    "explore": {"fraction": 0.0, "noise": 0.3},
    "degraded_wait_factor": 4.0,
    "drain_grace_s": 10.0,
    "reload": {"enabled": False, "poll_s": 2.0, "watch_dir": None},
    "supervisor": {"enabled": False, "max_restarts": 3, "backoff": 1.0, "backoff_cap": 60.0},
    "telemetry": {"enabled": True, "every": 256},
}


def _check_unported(cfg) -> None:
    from sheeprl_tpu_torch.resilience.faults import normalize_fault_cfg

    source = ((cfg.serve.get("reload") or {}).get("source")) or "checkpoint"
    if str(source) != "checkpoint":
        raise NotImplementedError(
            f"serve.reload.source={source}: not yet ported to sheeprl_tpu_torch (the fleet weight plane); "
            "serve.reload follows a checkpoint directory"
        )
    normalize_fault_cfg(cfg.get("resilience"))  # raises for the kinds serve does not drive


def build_serve_cfg(overrides: Sequence[str]):
    """Checkpoint's config.yaml + serve defaults + dotted CLI overrides. Returns
    the dotdict cfg with ``checkpoint_path`` resolved and ``serve`` populated."""
    import yaml

    from sheeprl_tpu_torch.config import dotdict, repoint_targets, set_by_path, yaml_load
    from sheeprl_tpu_torch.resilience.discovery import resolve_checkpoint_path

    kv = dict(o.split("=", 1) for o in overrides if "=" in o)
    ckpt_arg = kv.get("checkpoint_path")
    if ckpt_arg is None:
        raise ValueError("you must specify checkpoint_path=... (a checkpoint file or a run dir)")
    ckpt_path = Path(resolve_checkpoint_path(ckpt_arg))
    cfg_path = ckpt_path.parent.parent / "config.yaml"
    if not cfg_path.is_file():
        cfg_path = ckpt_path.parent / "config.yaml"
    if not cfg_path.is_file():
        raise ValueError(f"cannot serve {ckpt_path}: no config.yaml found next to the checkpoint")
    with open(cfg_path) as f:
        base = repoint_targets(yaml.safe_load(f))
    # serving is single-controller, one env worth of obs per session
    base["env"]["num_envs"] = 1
    base["env"]["capture_video"] = False
    base.setdefault("fabric", {})
    base["fabric"]["devices"] = 1
    base["checkpoint_path"] = str(ckpt_path)
    base["serve"] = copy.deepcopy(SERVE_DEFAULTS)
    cfg = dotdict(base)
    for key, raw in kv.items():
        if key == "checkpoint_path":
            continue
        try:
            value = yaml_load(raw)
        except yaml.YAMLError:
            value = raw
        set_by_path(cfg, key, value, create=True)
    cfg.seed = int(kv.get("seed", base.get("seed", 42)))
    # hot reload follows what the operator pointed at: a run dir keeps
    # producing newer checkpoints under it, an exact file's parent is the
    # closest thing to one
    if cfg.serve.reload.get("watch_dir") is None:
        cfg.serve.reload.watch_dir = str(ckpt_arg) if os.path.isdir(str(ckpt_arg)) else str(ckpt_path.parent)
    return cfg


def _default_log_dir(cfg) -> str:
    stamp = time.strftime("%Y-%m-%d_%H-%M-%S")
    return os.path.join("logs", "serve", f"{cfg.algo.name}_{stamp}")


def _prime(server) -> Dict[str, Any]:
    """Warm the serving path without serving a request: build or load the
    kernel libraries and run the slot step (every row masked, so no carry
    moves) and the attach of every slot once at ``[slots]``."""
    import numpy as np

    from sheeprl_tpu_torch.ops import KERNELS
    from sheeprl_tpu_torch.ops._build import build_snapshot

    table = server.table
    before = build_snapshot()
    launches = {spec.name: spec.launches for spec in KERNELS}
    obs = {k: spec.zeros(table.num_slots) for k, spec in server.policy.obs_spec.items()}
    table.step(obs, np.zeros((table.num_slots,), np.bool_))
    table.attach({slot: slot for slot in range(table.num_slots)})
    after = build_snapshot()
    return {
        "slots": table.num_slots,
        "kernel_builds": after["builds"] - before["builds"],
        "kernel_loads": after["loads"] - before["loads"],
        "kernel_launches": {spec.name: spec.launches - launches[spec.name] for spec in KERNELS},
    }


class _ServeAttempt:
    """One serving attempt: server, telemetry, reloader and the drain watcher.
    The supervised path runs several against one telemetry file, the plain
    path exactly one."""

    def __init__(self, cfg: Any, fabric: Any, log_dir: str, attempt: int = 0) -> None:
        from sheeprl_tpu_torch.resilience.faults import build_fault_plan
        from sheeprl_tpu_torch.serve.policy import resolve_serve_policy
        from sheeprl_tpu_torch.serve.server import PolicyServer
        from sheeprl_tpu_torch.serve.telemetry import ServingTelemetry
        from sheeprl_tpu_torch.utils.checkpoint import load_checkpoint

        self.cfg = cfg
        self.fabric = fabric
        self.log_dir = log_dir
        serve_cfg = cfg.serve

        self.policy = resolve_serve_policy(fabric, cfg, load_checkpoint(cfg.checkpoint_path))
        tcfg = serve_cfg.get("telemetry") or {}
        metric_tcfg = ((cfg.get("metric") or {}).get("telemetry")) or {}
        self.telemetry = ServingTelemetry(
            fabric,
            cfg,
            log_dir,
            enabled=bool(tcfg.get("enabled", True)),
            every=int(tcfg.get("every", 256)),
            http_port=metric_tcfg.get("http_port"),
            http_host=str(metric_tcfg.get("http_host") or "127.0.0.1"),
            attempt=attempt,
            serve_info={
                "slots": int(serve_cfg.slots),
                "max_batch_wait_ms": float(serve_cfg.max_batch_wait_ms),
                "greedy": bool(serve_cfg.greedy),
                "checkpoint_path": str(cfg.checkpoint_path),
                "device": fabric.device_name,
                **self.policy.meta,
            },
        )
        explore = serve_cfg.get("explore") or {}
        self.server = PolicyServer(
            self.policy,
            slots=int(serve_cfg.slots),
            max_batch_wait_ms=float(serve_cfg.max_batch_wait_ms),
            base_seed=int(cfg.seed),
            request_timeout=float(serve_cfg.request_timeout),
            max_queue=serve_cfg.get("max_queue"),
            deadline_ms=serve_cfg.get("deadline_ms"),
            degraded_wait_factor=float(serve_cfg.get("degraded_wait_factor") or 4.0),
            telemetry=self.telemetry,
            fault_plan=build_fault_plan(cfg.get("resilience")),
            explore_fraction=float(explore.get("fraction") or 0.0),
            explore_noise=float(explore.get("noise") or 0.3),
        )
        self.reloader = None
        reload_cfg = serve_cfg.get("reload") or {}
        if bool(reload_cfg.get("enabled")):
            from sheeprl_tpu_torch.serve.reload import CheckpointReloadSource, WeightReloader

            source = CheckpointReloadSource(
                str(reload_cfg.get("watch_dir") or os.path.dirname(cfg.checkpoint_path)),
                current_path=str(cfg.checkpoint_path),
            )
            self.reloader = WeightReloader(
                self.server, source, telemetry=self.telemetry, poll_s=float(reload_cfg.get("poll_s") or 2.0)
            )
        self.drained = False
        self._stop_watch = threading.Event()
        self._watcher: Optional[threading.Thread] = None

    def _set_health(self, ready: bool, status: str) -> None:
        endpoint = getattr(self.telemetry, "metrics_endpoint", None)
        if endpoint is not None:
            endpoint.set_health(
                {
                    "ready": ready,
                    "status": status,
                    "draining": self.server.draining,
                    "degraded": self.server.degraded,
                    "weight_version": self.server.weight_version,
                    "sessions_active": self.server.active_sessions,
                    "queue_depth": self.server.queue_depth,
                }
            )

    def _watch(self) -> None:
        from sheeprl_tpu_torch.resilience import signals

        grace = float(self.cfg.serve.get("drain_grace_s") or 10.0)
        while not self._stop_watch.wait(0.2):
            if signals.preemption_requested() and not self.drained:
                # SIGTERM -> graceful drain: a wind-down, not a crash
                self.drained = True
                self._set_health(False, "draining")
                print(
                    f"[sheeprl-serve] preemption requested: draining (grace {grace:.0f}s)",
                    file=sys.stderr,
                    flush=True,
                )
                self.server.drain(grace, clean_exit=True)
                return
            self._set_health(True, "ok")

    def run(self) -> Dict[str, Any]:
        """Serve the configured env sessions to completion (or drain). Returns
        ``{results, preempted, error, sessions_lost, wall_s, stats}``."""
        from sheeprl_tpu_torch.resilience import signals
        from sheeprl_tpu_torch.serve.drivers import run_env_sessions

        serve_cfg = self.cfg.serve
        t0 = time.perf_counter()
        self.server.start()
        if self.reloader is not None:
            self.reloader.start()
        self._set_health(True, "ok")
        self._watcher = threading.Thread(target=self._watch, name="sheeprl-serve-watch", daemon=True)
        self._watcher.start()
        try:
            results = run_env_sessions(
                self.server,
                self.cfg,
                sessions=int(serve_cfg.sessions),
                max_session_steps=int(serve_cfg.max_session_steps),
                log_dir=self.log_dir,
            )
        finally:
            if self.reloader is not None:
                self.reloader.stop()
            self._stop_watch.set()
            preempted = signals.preemption_requested()
            if preempted and self._watcher is not None:
                # let the watcher finish the drain it owns (grace-bounded)
                self._watcher.join(timeout=float(serve_cfg.get("drain_grace_s") or 10.0) + 30.0)
            self._set_health(False, "stopped")
            self.server.close(clean_exit=self.server._error is None)
        return {
            "results": results,
            "preempted": preempted,
            "error": self.server._error,
            # sessions a crash ended; the supervisor's restart event counts them
            "sessions_lost": sum(1 for r in results if r.get("error")),
            "wall_s": time.perf_counter() - t0,
            "stats": {
                **self.server.stats.as_dict(),
                "weight_version": self.server.weight_version,
                "reloads": self.server.reloads,
                "reload_failures": self.reloader.failures if self.reloader is not None else 0,
                "last_swap": self.server.last_swap,
            },
        }


def _write_summary(cfg, fabric, log_dir: str, info: Dict[str, Any], restarts: int) -> Dict[str, Any]:
    serve_cfg = cfg.serve
    results = info["results"]
    summary = {
        "algo": str(cfg.algo.name),
        "device": fabric.device_name,
        "slots": int(serve_cfg.slots),
        "sessions": int(serve_cfg.sessions),
        "sessions_completed": sum(1 for r in results if not r.get("error")),
        "restarts": restarts,
        "wall_s": info["wall_s"],
        **info["stats"],
    }
    summary["steps_per_s"] = summary["steps"] / info["wall_s"] if info["wall_s"] > 0 else None
    with open(os.path.join(log_dir, "summary.json"), "w") as f:
        json.dump(summary, f, indent=2)
    return summary


def serve_main(args: Optional[Sequence[str]] = None) -> int:
    """The ``serve`` verb. Returns the process exit code."""
    from sheeprl_tpu_torch.cli import unported_precision
    from sheeprl_tpu_torch.parallel.fabric import Fabric
    from sheeprl_tpu_torch.resilience import signals

    overrides = list(args if args is not None else sys.argv[1:])
    cfg = build_serve_cfg(overrides)
    _check_unported(cfg)
    unported_precision(cfg)
    serve_cfg = cfg.serve

    fabric = Fabric(
        devices=1,
        accelerator=cfg.fabric.get("accelerator", "auto"),
        precision=cfg.fabric.get("precision", "32-true"),
        float32_matmul_precision=cfg.get("float32_matmul_precision", "high"),
    )
    fabric.seed_everything(int(cfg.seed))

    if bool(serve_cfg.get("prime")):
        from sheeprl_tpu_torch.serve.policy import resolve_serve_policy
        from sheeprl_tpu_torch.serve.server import PolicyServer
        from sheeprl_tpu_torch.utils.checkpoint import load_checkpoint

        t0 = time.perf_counter()
        policy = resolve_serve_policy(fabric, cfg, load_checkpoint(cfg.checkpoint_path))
        stats = _prime(PolicyServer(policy, slots=int(serve_cfg.slots), base_seed=int(cfg.seed)))
        print(
            f"[sheeprl-serve] primed {cfg.algo.name} on {fabric.device_name} in {time.perf_counter() - t0:.1f}s: "
            f"the slot step and attach ran once at {stats['slots']} slots; kernel libraries built "
            f"{stats['kernel_builds']}, loaded {stats['kernel_loads']}; kernel launches "
            f"{json.dumps(stats['kernel_launches'])}",
            flush=True,
        )
        return 0

    sessions = int(serve_cfg.sessions)
    if sessions < 1:
        print(
            "[sheeprl-serve] serve.sessions=0: nothing to drive; set serve.sessions=N to run "
            "N concurrent env sessions to completion.",
            file=sys.stderr,
        )
        return 2
    log_dir = serve_cfg.get("log_dir") or _default_log_dir(cfg)
    os.makedirs(log_dir, exist_ok=True)
    handler_installed = signals.install_preemption_handler()
    reload_cfg = serve_cfg.get("reload") or {}
    print(
        f"[sheeprl-serve] serving {cfg.algo.name} from {cfg.checkpoint_path} on {fabric.device_name} — "
        f"{serve_cfg.slots} slots, {sessions} env session(s), log dir {log_dir}"
        + (f", hot reload following {reload_cfg.get('watch_dir')}" if bool(reload_cfg.get("enabled")) else ""),
        flush=True,
    )
    sup_cfg = serve_cfg.get("supervisor") or {}
    try:
        if not bool(sup_cfg.get("enabled")):
            info = _ServeAttempt(cfg, fabric, log_dir).run()
            _write_summary(cfg, fabric, log_dir, info, restarts=0)
            return _verdict(info)
        return _supervised(cfg, fabric, log_dir, sup_cfg)
    finally:
        if handler_installed:
            signals.uninstall_preemption_handler()


def _supervised(cfg, fabric, log_dir: str, sup_cfg) -> int:
    """Bounded in-process restarts of the serve loop (the training
    supervisor's policy loop), with the sessions each crash lost counted."""
    from sheeprl_tpu_torch.obs.jsonl import JsonlEventSink
    from sheeprl_tpu_torch.resilience.restart_policy import RestartPolicy, run_restart_policy

    policy_obj = RestartPolicy.from_cfg(sup_cfg)
    # a SIGTERM-drained serve exits 75 for the external supervisor:
    # restarting it in-process would undo the drain
    policy_obj.restart_on_preempt = False
    sink = JsonlEventSink(os.path.join(log_dir, "telemetry.jsonl"))
    state: Dict[str, Any] = {"info": None, "lost_total": 0}

    def emit(event: str, **fields: Any) -> None:
        fields.setdefault("attempt", policy_obj.attempt)
        sink.emit(event, **fields)

    def run_attempt(attempt: int):
        try:
            info = _ServeAttempt(cfg, fabric, log_dir, attempt=attempt).run()
        except Exception as err:  # a boot-time crash: no sessions existed
            info = {"results": [], "preempted": False, "error": err, "sessions_lost": 0, "wall_s": 0.0,
                    "stats": {"ticks": 0, "steps": 0}}
        state["info"] = info
        if info["preempted"]:
            return "preempt", info
        if info["error"] is not None:
            state["lost_total"] += int(info["sessions_lost"])
            return "crash", info
        return "completed", info

    def restart_fields(attempt, outcome, info):
        return {
            "error": repr(info.get("error"))[:500] if info.get("error") else None,
            "sessions_lost": int(info.get("sessions_lost") or 0),
            "sessions_lost_total": int(state["lost_total"]),
        }

    def giveup_fields(info):
        return {
            "error": repr(info.get("error")) if info.get("error") else None,
            "sessions_lost_total": int(state["lost_total"]),
        }

    def on_giveup(outcome, info):
        if info.get("error") is not None:
            raise info["error"]
        return "preempted"

    try:
        run_restart_policy(
            policy_obj, run_attempt, emit,
            restart_fields=restart_fields, giveup_fields=giveup_fields, on_giveup=on_giveup,
        )
    finally:
        sink.close()
        if state["info"] is not None:
            _write_summary(cfg, fabric, log_dir, state["info"], restarts=policy_obj.attempt)
    return _verdict(state["info"])


def _verdict(info: Optional[Dict[str, Any]]) -> int:
    """Map one attempt's outcome onto the serve exit codes."""
    from sheeprl_tpu_torch.resilience.signals import PREEMPTED_EXIT_CODE

    if info is None:
        return 1
    for r in info["results"]:
        print(
            f"[sheeprl-serve] session seed={r.get('seed')}: {r.get('steps', 0)} steps, "
            f"reward {r.get('reward', 0.0):.2f}" + (f" — ERROR {r['error']}" if r.get("error") else "")
        )
    stats = info.get("stats") or {}
    if stats.get("ticks"):
        print(
            f"[sheeprl-serve] {stats['ticks']} ticks, {stats['steps']} steps in {info['wall_s']:.2f}s "
            f"(tick p50 {stats.get('tick_ms_p50')} ms, p99 {stats.get('tick_ms_p99')} ms; weight version "
            f"{stats.get('weight_version')}, reloads {stats.get('reloads')})",
            flush=True,
        )
    if info["preempted"]:
        print(f"[sheeprl-serve] drained after preemption request (code {PREEMPTED_EXIT_CODE})")
        return PREEMPTED_EXIT_CODE
    if info["error"] is not None:
        print(f"[sheeprl-serve] server crashed: {info['error']!r}", file=sys.stderr)
        return 1
    return 1 if any(r.get("error") for r in info["results"]) else 0

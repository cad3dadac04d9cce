"""Distributed resilience: coordinated preemption, rank-failure detection,
checkpoint-set consistency and gang supervision for multi-process runs (port
of ``sheeprl_tpu/resilience/distributed.py``).

The JAX package rides the ``jax.distributed`` coordination service's key-value
store; the port rides the run's ``torch.distributed.TCPStore``
(``parallel/distributed.py``), through a connection of its own
(``control_kv``), so the heartbeats never queue behind a channel's ``wait``. A
store cannot list a prefix, so every record is read by its name, all of them
known in advance: ``hb/r{k}``, ``ctl/req/r{k}`` and the acks ``{token}/r{k}``
for each rank k, ``ctl/decision`` and ``ctl/abort``. The namespace is the JAX
one, ``sheeprl_res/i{n}/a{attempt}``, so a later run in one interpreter never
reads an earlier run's records.

Four pillars, as in the JAX package:

- **Coordinated preemption** (:class:`DistributedCoordinator`): a rank that
  sees its own SIGTERM publishes a *request*; rank 0 turns the first request
  into a *decision*, "every rank stops at policy step >= S", with S far enough
  ahead that every rank has read it first. In the decoupled topology the
  player (rank 0) drives the loop: a learner's SIGTERM becomes a request the
  player turns into the stop step, and the channel's shutdown carries the
  teardown.
- **Rank-failure detection**: every rank runs a heartbeat writer thread and a
  monitor thread that watches each peer's heartbeat *counter*. A peer silent
  for ``heartbeat.timeout`` seconds (or never heard from within
  ``startup_timeout``; a store that cannot be read is silence too) is
  declared dead: a ``health`` event (``status=rank_dead``) names it, and an
  *abort* record is published that every rank's facade, and every bounded
  channel wait, turns into :class:`RankFailureError`.
- **Checkpoint consistency** (:func:`checkpoint_manifest`): a multi-process
  checkpoint gets ``ckpt_{step}.manifest.json``, written incomplete before the
  save and committed after every rank that shares the save acked; discovery
  (``discovery.py``) resolves only committed sets.
- **Gang supervision** (:func:`supervise_gang`): one parent owns the N child
  processes, launched with a fresh coordinator port per attempt. On any
  child's crash or preemption it tears the survivors down, resolves the newest
  manifest-complete checkpoint and restarts the whole gang, under the restart
  policy the in-process supervisor shares (``restart_policy.py``).
"""

from __future__ import annotations

import json
import os
import threading
import time
from contextlib import contextmanager
from typing import Any, Callable, Dict, List, Optional, Sequence

from sheeprl_tpu_torch.parallel import distributed as par_dist


class RankFailureError(RuntimeError):
    """A peer process of this run was declared dead (heartbeat timeout, or
    the store's master gone). Raised from the resilience facade's
    per-iteration hook and from bounded channel waits, so that no process
    blocks forever on a dead peer; the CLI exits 77 and the gang supervisor
    restarts the whole gang."""


# ---------------------------------------------------------------------------------
# the control plane: named records on the run's store
# ---------------------------------------------------------------------------------


def _kv() -> Any:
    """The coordinator's connection to the run's store (a ``StoreKV``), or None."""
    try:
        return par_dist.control_kv()
    except Exception:
        return None


def _kv_get_many(client: Any, keys: Sequence[str]) -> Dict[str, str]:
    try:
        return client.get_many(list(keys))
    except Exception:
        return {}  # a store that cannot be read (a dying master) is silence


# coordinators built in this process: namespaces the records, so a later run in
# one interpreter never reads an earlier run's (every process builds one per run
# at the same point of the protocol, so the counts agree across processes)
_coordinator_builds = 0

# the live coordinator, for the bounded channel waits (channel_options)
_active_coordinator: Optional["DistributedCoordinator"] = None


def active_coordinator() -> Optional["DistributedCoordinator"]:
    return _active_coordinator


def channel_abort_check() -> None:
    """The ``abort_check`` bounded channel waits run between slices: raises
    :class:`RankFailureError` once a peer has been declared dead."""
    coord = _active_coordinator
    if coord is not None:
        coord.check_abort()


def channel_abort_poll() -> Optional[float]:
    """The longest slice a bounded channel wait may take while a coordinator
    runs (its heartbeat interval), or None: a verdict is read within it."""
    coord = _active_coordinator
    if coord is None or not coord.heartbeat_enabled:
        return None
    return coord.heartbeat_interval


def channel_options(cfg: Any) -> Dict[str, Any]:
    """Keyword arguments of :class:`~sheeprl_tpu_torch.parallel.distributed.BroadcastChannel`
    from ``resilience.distributed.channel`` (``timeout`` and ``poll``, in
    seconds), with the abort hooks."""
    ccfg = (((cfg.get("resilience") or {}).get("distributed") or {}).get("channel")) or {}
    return {
        "timeout_s": float(ccfg.get("timeout") or 1800.0),
        "poll_s": float(ccfg.get("poll") or 30.0),
        "abort_check": channel_abort_check,
        "abort_poll": channel_abort_poll,
    }


# ---------------------------------------------------------------------------------
# preempt agreement and heartbeat-based rank-failure detection
# ---------------------------------------------------------------------------------


class DistributedCoordinator:
    """One process's presence on the control plane of a multi-process run.
    Construct with :func:`build_coordinator`; drive with :meth:`step` from the
    resilience facade's per-iteration hook. Threads: a heartbeat writer and a
    peer monitor, both daemons, both stopped by :meth:`close`. ``kv`` is the
    control plane (a ``StoreKV``; the process's own by default)."""

    def __init__(
        self,
        rank: int,
        nprocs: int,
        *,
        agree_within_iters: int = 2,
        poll_interval: float = 0.25,
        heartbeat_interval: float = 2.0,
        heartbeat_timeout: float = 60.0,
        startup_timeout: float = 300.0,
        heartbeat_enabled: bool = True,
        emit: Optional[Callable[..., None]] = None,
        namespace: Optional[str] = None,
        kv: Any = None,
    ) -> None:
        global _coordinator_builds, _active_coordinator
        self.rank = int(rank)
        self.nprocs = int(nprocs)
        self.agree_within_iters = max(int(agree_within_iters), 1)
        self.poll_interval = max(float(poll_interval), 0.01)
        self.heartbeat_interval = max(float(heartbeat_interval), 0.05)
        self.heartbeat_timeout = float(heartbeat_timeout)
        self.startup_timeout = max(float(startup_timeout), self.heartbeat_timeout)
        self.heartbeat_enabled = bool(heartbeat_enabled)
        self._emit = emit or (lambda *a, **k: None)
        self._kv_override = kv
        nonce = _coordinator_builds
        _coordinator_builds += 1
        attempt = os.environ.get("SHEEPRL_GANG_ATTEMPT", "0")
        self.ns = namespace or f"sheeprl_res/i{nonce}/a{attempt}"

        self._lock = threading.Lock()
        self._stop = threading.Event()
        self._last_step: Optional[int] = None
        self._per_iter = 1
        self._rate: Optional[float] = None  # policy steps a second (EMA)
        self._last_step_time: Optional[float] = None
        self._last_poll = 0.0
        self._requests: Dict[int, int] = {}  # rank -> step at request time
        self._published_request = False
        self._published_decision = False
        self._decision: Optional[Dict[str, Any]] = None
        self._abort: Optional[Dict[str, Any]] = None
        self._abort_announced = False
        self._hb_counter = 0
        self._hb_seen: Dict[int, tuple] = {}  # rank -> (counter, when it last changed)
        self._dead: Dict[int, float] = {}  # rank -> silent seconds at declaration
        self._left: set = set()  # ranks that closed their coordinator
        self._threads: List[threading.Thread] = []
        _active_coordinator = self

    def _client(self) -> Any:
        return self._kv_override if self._kv_override is not None else _kv()

    # -- lifecycle ---------------------------------------------------------------

    def start(self) -> "DistributedCoordinator":
        if self.heartbeat_enabled and not self._threads:
            for target, name in (
                (self._heartbeat_loop, "sheeprl-heartbeat"),
                (self._monitor_loop, "sheeprl-rank-monitor"),
            ):
                t = threading.Thread(target=target, name=name, daemon=True)
                t.start()
                self._threads.append(t)
        return self

    def close(self) -> None:
        """Stop the threads. A process that ran them leaves with a last
        heartbeat marked ``left``, so that a peer still winding down (a
        learner waiting for the player's sentinel, a player running its final
        test) does not declare it dead. The JAX coordinator has no such
        record: its peers stop looking when they end."""
        global _active_coordinator
        ran = bool(self._threads)
        self._stop.set()
        for t in self._threads:
            t.join(timeout=5.0)
        self._threads = []
        if ran:
            from sheeprl_tpu_torch.resilience import faults

            client = self._client()
            if client is not None and not faults.heartbeat_stalled():
                try:
                    client.set(f"{self.ns}/hb/r{self.rank}",
                               json.dumps({"n": self._hb_counter + 1, "left": True, "pid": os.getpid()}))
                except Exception:
                    pass
        if _active_coordinator is self:
            _active_coordinator = None

    # -- the per-iteration hook --------------------------------------------------

    def step(self, policy_step: int, local_preempt: bool = False) -> None:
        """Host integers only: no device value is read here."""
        now = time.monotonic()
        with self._lock:
            if self._last_step is not None and policy_step > self._last_step:
                delta = policy_step - self._last_step
                self._per_iter = max(delta, 1)
                if self._last_step_time is not None and now > self._last_step_time:
                    inst = delta / (now - self._last_step_time)
                    self._rate = inst if self._rate is None else 0.5 * self._rate + 0.5 * inst
            self._last_step = int(policy_step)
            self._last_step_time = now
        client = self._client()
        if client is None:
            return
        if local_preempt and not self._published_request:
            self._publish_request(client, policy_step)
        # a throttled poll; forced while a preempt is pending, so that the
        # leader's decision reaches every rank promptly
        pending = local_preempt or self._requests or self._published_request
        if pending or now - self._last_poll >= self.poll_interval:
            self._last_poll = now
            self._poll_control(client)
        if self.rank == 0 and not self._published_decision and (local_preempt or self._requests):
            self._publish_decision(client, policy_step)

    def preempt_requested(self) -> bool:
        """The agreed verdict every rank folds into its checkpoint condition:
        True once the published stop step is reached by the step sequence all
        ranks share (never on the local flag alone)."""
        with self._lock:
            decision = self._decision
            if decision is None:
                return False
            if self._last_step is None:
                return True  # preempted before the loop made a step
            return self._last_step + self._per_iter >= int(decision["stop_step"])

    def decision(self) -> Optional[Dict[str, Any]]:
        with self._lock:
            return dict(self._decision) if self._decision else None

    def check_abort(self) -> None:
        """Raise :class:`RankFailureError` if any peer has been declared dead."""
        with self._lock:
            abort = self._abort
        if abort is not None:
            raise RankFailureError(
                f"rank {abort.get('rank')} of this {self.nprocs}-process run was declared "
                f"dead ({abort.get('reason', 'heartbeat timeout')}); tearing down instead of "
                "hanging — the supervisor restarts the gang from the last consistent checkpoint"
            )

    def abort_info(self) -> Optional[Dict[str, Any]]:
        with self._lock:
            return dict(self._abort) if self._abort else None

    # -- control-plane internals -------------------------------------------------

    def _publish_request(self, client: Any, policy_step: Optional[int]) -> None:
        try:
            client.set(f"{self.ns}/ctl/req/r{self.rank}", json.dumps({"rank": self.rank, "step": int(policy_step or 0)}))
            self._published_request = True
        except Exception:
            pass  # retried from the next step()

    def _publish_decision(self, client: Any, policy_step: int) -> None:
        with self._lock:
            per_iter = self._per_iter
            rate = self._rate
            requests = dict(self._requests)
        # the agreement window in iterations, or the steps the gang covers in
        # ~3 control-poll periods at the observed rate, whichever is larger
        margin = self.agree_within_iters * per_iter
        if rate is not None:
            margin = max(margin, int(rate * 3.0 * self.poll_interval) + per_iter)
        stop_step = int(policy_step) + margin
        decision = {
            "stop_step": stop_step,
            "decided_at_step": int(policy_step),
            "requested_by": sorted(requests) if requests else [self.rank],
        }
        try:
            client.set(f"{self.ns}/ctl/decision", json.dumps(decision))
        except Exception:
            return  # retried from the next step()
        self._published_decision = True
        with self._lock:
            self._decision = decision
        from sheeprl_tpu_torch.resilience import signals

        signals.mark_preempted()  # this rank's exit now reports "preempted"

    def _poll_control(self, client: Any) -> None:
        names = {f"{self.ns}/ctl/decision": "decision", f"{self.ns}/ctl/abort": "abort"}
        names.update({f"{self.ns}/ctl/req/r{k}": k for k in range(self.nprocs)})
        decision = None
        abort = None
        requests: Dict[int, int] = {}
        for key, value in sorted(_kv_get_many(client, list(names)).items()):
            try:
                payload = json.loads(value)
            except (TypeError, ValueError):
                continue
            name = names[key]
            if name == "decision":
                decision = payload
            elif name == "abort":
                abort = payload
            else:
                try:
                    requests[int(name)] = int(payload.get("step") or 0)
                except (TypeError, ValueError):
                    continue
        decision_is_new = False
        with self._lock:
            if requests:
                self._requests.update(requests)
            if decision is not None and self._decision is None:
                self._decision = decision
                decision_is_new = True
            if abort is not None and self._abort is None:
                self._abort = abort
            abort_now = self._abort
        if decision_is_new:
            from sheeprl_tpu_torch.resilience import signals

            # the gang agreed: this rank exits preempted even if the signal
            # only ever reached a peer
            signals.mark_preempted()

        if abort_now is not None and not self._abort_announced:
            self._abort_announced = True
            self._emit(
                "health",
                status="rank_dead",
                rank=abort_now.get("rank"),
                reason=abort_now.get("reason"),
                observed_by=abort_now.get("observed_by"),
                critical=True,
            )

    # -- heartbeat threads ---------------------------------------------------------

    def _heartbeat_loop(self) -> None:
        from sheeprl_tpu_torch.resilience import faults

        while not self._stop.wait(self.heartbeat_interval):
            client = self._client()
            if client is None:
                continue
            if faults.heartbeat_stalled():
                continue  # an injected zombie: alive, silent on the control plane
            self._hb_counter += 1
            with self._lock:
                step = self._last_step
            try:
                client.set(
                    f"{self.ns}/hb/r{self.rank}",
                    json.dumps({"n": self._hb_counter, "step": step, "pid": os.getpid()}),
                )
            except Exception:
                continue  # a dying store: the peers time out anyway

    def _monitor_loop(self) -> None:
        started = time.monotonic()
        poll = max(min(self.heartbeat_interval, self.heartbeat_timeout / 4.0), 0.05)
        while not self._stop.wait(poll):
            client = self._client()
            if client is None:
                continue
            self._monitor_once(client, started)

    def _monitor_once(self, client: Any, started: float) -> None:
        """One look at every peer's heartbeat counter."""
        now = time.monotonic()
        keys = {f"{self.ns}/hb/r{k}": k for k in range(self.nprocs)}
        seen: Dict[int, int] = {}
        for key, value in _kv_get_many(client, list(keys)).items():
            try:
                record = json.loads(value)
                seen[keys[key]] = int(record.get("n") or 0)
                if record.get("left"):
                    self._left.add(keys[key])
            except (TypeError, ValueError, AttributeError):
                continue
        for peer in range(self.nprocs):
            if peer == self.rank or peer in self._dead or peer in self._left:
                continue
            counter = seen.get(peer)
            prev = self._hb_seen.get(peer)
            if counter is None and prev is None:
                # never heartbeated: allow for the process's start and imports
                if now - started > self.startup_timeout:
                    self._declare_dead(client, peer, now - started)
                continue
            if counter is not None and (prev is None or counter != prev[0]):
                self._hb_seen[peer] = (counter, now)
            elif now - prev[1] > self.heartbeat_timeout:
                # a stale counter, or a key that vanished after the peer had
                # beat (or a store that cannot be read): the heartbeat window
                self._declare_dead(client, peer, now - prev[1])

    def _declare_dead(self, client: Any, peer: int, silent_seconds: float) -> None:
        self._dead[peer] = silent_seconds
        abort = {
            "reason": "heartbeat timeout",
            "rank": peer,
            "silent_seconds": round(silent_seconds, 1),
            "observed_by": self.rank,
        }
        with self._lock:
            if self._abort is None:
                self._abort = abort
        try:
            client.set(f"{self.ns}/ctl/abort", json.dumps(abort))
        except Exception:
            pass
        if not self._abort_announced:
            self._abort_announced = True
            self._emit(
                "health",
                status="rank_dead",
                rank=peer,
                reason="heartbeat timeout",
                silent_seconds=round(silent_seconds, 1),
                observed_by=self.rank,
                critical=True,
            )


def build_coordinator(cfg: Any, *, rank: int, emit: Optional[Callable[..., None]] = None
                      ) -> Optional[DistributedCoordinator]:
    """Build (and start) this process's coordinator for a multi-process run;
    None for one process or with no store: every caller then falls back to
    the process-local semantics."""
    global _manifest_timeout
    nprocs = par_dist.process_count()
    if nprocs <= 1 or _kv() is None:
        return None
    dcfg = ((cfg.get("resilience") or {}).get("distributed")) or {}
    hcfg = dcfg.get("heartbeat") or {}
    _manifest_timeout = float(dcfg.get("manifest_timeout") or 120.0)
    return DistributedCoordinator(
        rank,
        nprocs,
        agree_within_iters=int(dcfg.get("agree_within_iters") or 2),
        poll_interval=float(dcfg.get("poll_interval") or 0.25),
        heartbeat_interval=float(hcfg.get("interval") or 2.0),
        heartbeat_timeout=float(hcfg.get("timeout") or 60.0),
        startup_timeout=float(hcfg.get("startup_timeout") or 300.0),
        heartbeat_enabled=bool(hcfg.get("enabled", True)),
        emit=emit,
    ).start()


# ---------------------------------------------------------------------------------
# checkpoint-set consistency manifests
# ---------------------------------------------------------------------------------


def _write_manifest(path: str, payload: Dict[str, Any]) -> None:
    parent = os.path.dirname(path)
    if parent:
        os.makedirs(parent, exist_ok=True)  # the begun-marker precedes the save
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        json.dump(payload, f)
    os.replace(tmp, path)


# the ack deadline, resilience.distributed.manifest_timeout, latched by
# build_coordinator (the loops' checkpoint writes have no config at hand)
_manifest_timeout = 120.0


@contextmanager
def checkpoint_manifest(ckpt_path: str, ranks: Sequence[int] = (0,), timeout_s: Optional[float] = None):
    """Bracket a multi-process checkpoint write with the consistency manifest:
    ``complete: false`` lands before the save, every rank of ``ranks`` (the
    ranks that share the save; the player alone in the decoupled topology)
    acks through the store after it, and the lowest of them rewrites the
    manifest with ``complete: true`` only once every ack arrived. So
    discovery never resolves a checkpoint some rank did not finish. A no-op
    in one process. The JAX package reads the ranks from the fabric's mesh;
    the port has no mesh, so they are given."""
    from sheeprl_tpu_torch.resilience.discovery import checkpoint_step, manifest_path

    if par_dist.process_count() <= 1:
        yield
        return
    timeout_s = float(_manifest_timeout if timeout_s is None else timeout_s)
    expected = sorted({int(r) for r in ranks}) or [int(par_dist.process_index())]
    me = int(par_dist.process_index())
    writer = me == min(expected)
    mpath = manifest_path(ckpt_path)
    step = checkpoint_step(ckpt_path)
    # keyed by the shared manifest's name, never the per-rank file name
    token = f"sheeprl_res/ckptack/{os.path.basename(mpath)}/s{step}"
    ack_keys = {r: f"{token}/r{r}" for r in expected}
    if writer:
        if len(expected) > 1:
            # clear the acks of an earlier save of this step: a stale ack must
            # never satisfy this save's rendezvous (peers ack only after the
            # save, which cannot finish before the writer passes here)
            client = _kv()
            if client is not None:
                for key in ack_keys.values():
                    try:
                        client.delete(key)
                    except Exception:
                        pass
        _write_manifest(
            mpath,
            {
                "schema": 1,
                "step": step,
                "path": os.path.basename(str(ckpt_path)),
                "ranks_expected": expected,
                "complete": False,
                "begun_at": round(time.time(), 3),
            },
        )
    yield  # the save itself; an exception here leaves the manifest incomplete

    if me not in expected:
        return
    client = _kv()
    if len(expected) > 1 and client is None:
        # no store to meet on: leave the manifest incomplete rather than
        # commit a consistency nobody verified
        return
    if len(expected) > 1:
        if not writer:
            try:
                client.set(ack_keys[me], "1")
            except Exception:
                pass
            return
        need = {r for r in expected if r != me}
        deadline = time.monotonic() + float(timeout_s)
        while need and time.monotonic() < deadline:
            acked = _kv_get_many(client, [ack_keys[r] for r in need])
            need -= {r for r in need if ack_keys[r] in acked}
            if need:
                time.sleep(0.2)
        if need:
            # a rank vanished mid-checkpoint: this set is never resolved, and
            # discovery falls back to the previous complete one
            return
    _write_manifest(
        mpath,
        {
            "schema": 1,
            "step": step,
            "path": os.path.basename(str(ckpt_path)),
            "ranks_expected": expected,
            "ranks_committed": expected,
            "complete": True,
            "committed_at": round(time.time(), 3),
        },
    )
    if len(expected) > 1:
        for r in expected:
            if r != me:
                try:
                    client.delete(ack_keys[r])  # consumed: no stale acks
                except Exception:
                    pass


# ---------------------------------------------------------------------------------
# gang supervision: N child processes under one supervisor
# ---------------------------------------------------------------------------------


class GangFailureError(RuntimeError):
    """The gang supervisor exhausted its restart budget on crashes."""


def _free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _classify(exit_codes: Dict[int, int]) -> str:
    from sheeprl_tpu_torch.resilience import signals

    if all(rc == 0 for rc in exit_codes.values()):
        return "completed"
    if all(rc in (0, signals.PREEMPTED_EXIT_CODE) for rc in exit_codes.values()):
        return "preempt"
    return "crash"


def supervise_gang(cfg: Any, overrides: Sequence[str]) -> str:
    """Launch ``resilience.distributed.gang.processes`` child processes
    (``python -m sheeprl_tpu_torch`` with this launch's arguments and
    ``SHEEPRL_COORDINATOR``, ``SHEEPRL_GANG_PROCESSES``, ``SHEEPRL_GANG_RANK``
    and ``SHEEPRL_GANG_ATTEMPT``) and supervise them as one unit: any child's
    crash or preemption tears the survivors down and, per the shared
    ``resilience.supervisor`` policy, restarts the whole gang from the newest
    manifest-complete checkpoint, the attempt stamped on every rank's stream.
    Each child runs in its own session and logs to
    ``<run base>/gang/attempt{K}.rank{R}.log``. This process opens no store.
    Returns ``"completed"`` or ``"preempted"``; raises
    :class:`GangFailureError` when the crash budget is exhausted."""
    import signal as _signal
    import subprocess
    import sys

    from sheeprl_tpu_torch.obs.jsonl import JsonlEventSink
    from sheeprl_tpu_torch.resilience import signals
    from sheeprl_tpu_torch.resilience.discovery import find_latest_checkpoint
    from sheeprl_tpu_torch.resilience.restart_policy import RestartPolicy, run_restart_policy
    from sheeprl_tpu_torch.utils.logger import run_base_dir

    scfg = (cfg.get("resilience") or {}).get("supervisor") or {}
    gcfg = (((cfg.get("resilience") or {}).get("distributed")) or {}).get("gang") or {}
    n = int(gcfg.get("processes") or 0)
    if n < 2:
        raise ValueError("supervise_gang needs resilience.distributed.gang.processes >= 2")
    policy = RestartPolicy.from_cfg(scfg)
    grace = float(gcfg.get("grace") or 20.0)

    run_base = run_base_dir(cfg)
    log_dir = run_base / "gang"
    os.makedirs(log_dir, exist_ok=True)
    jsonl_enabled = bool(((cfg.get("metric") or {}).get("telemetry") or {}).get("jsonl", True))
    jsonl_path = str(run_base / "telemetry.jsonl")

    sink: Optional[JsonlEventSink] = None

    def emit(event: str, **fields: Any) -> None:
        nonlocal sink
        if not jsonl_enabled:
            return
        if sink is None:
            try:
                sink = JsonlEventSink(jsonl_path)
            except OSError:
                return
        fields.setdefault("attempt", policy.attempt)
        sink.emit(event, **fields)

    # what every attempt shares: the resolved run identity (a timestamped
    # run_name must not resolve anew in each child), one run-base stream, and
    # the in-process supervisor off (the gang owns the restart policy)
    base_args = [str(o) for o in overrides] + [
        f"root_dir={cfg.root_dir}",
        f"run_name={cfg.run_name}",
        "resilience.supervisor.enabled=false",
    ]
    if jsonl_enabled:
        base_args.append(f"metric.telemetry.jsonl_path={jsonl_path}")
    fallback_resume = cfg.checkpoint.get("resume_from") or None

    live_procs: List[subprocess.Popen] = []

    def spawn(attempt_args: List[str], attempt: int) -> List[subprocess.Popen]:
        port = _free_port()
        procs: List[subprocess.Popen] = []
        for rank in range(n):
            env = dict(os.environ)
            env["SHEEPRL_COORDINATOR"] = f"127.0.0.1:{port}"
            env["SHEEPRL_GANG_PROCESSES"] = str(n)
            env["SHEEPRL_GANG_RANK"] = str(rank)
            env["SHEEPRL_GANG_ATTEMPT"] = str(attempt)
            log_fh = open(log_dir / f"attempt{attempt}.rank{rank}.log", "ab")
            procs.append(
                subprocess.Popen(
                    [sys.executable, "-m", "sheeprl_tpu_torch"] + attempt_args,
                    env=env,
                    stdout=log_fh,
                    stderr=subprocess.STDOUT,
                    # own session: a process-group SIGTERM (Ctrl-C, a reclaim)
                    # reaches only the supervisor, whose forward is then each
                    # child's first signal, not its second (a force-exit)
                    start_new_session=True,
                )
            )
            log_fh.close()  # the child holds the descriptor
        live_procs[:] = procs
        return procs

    def wait_gang(procs: List[subprocess.Popen]) -> tuple:
        """Wait for every child; after the first exit the survivors get
        ``grace`` seconds to end on their own, then SIGTERM, then SIGKILL.
        Returns ({rank: exit code}, the ranks that exited before any
        escalation, whether a preemption was forwarded)."""
        forwarded = False
        first_exit: Optional[float] = None
        terminated = killed = False
        self_exited: set = set()
        while True:
            if signals.preemption_requested() and not forwarded:
                forwarded = True
                emit("gang", status="preempt_forward", processes=n)
                for p in procs:
                    if p.poll() is None:
                        try:
                            p.send_signal(_signal.SIGTERM)
                        except OSError:
                            pass
                # the teardown clock starts at the first exit, not here: the
                # children need the agreed stop step and the emergency save
            rcs = [p.poll() for p in procs]
            if not terminated and not killed:
                self_exited.update(i for i, rc in enumerate(rcs) if rc is not None)
            if all(rc is not None for rc in rcs):
                return {i: int(rc) for i, rc in enumerate(rcs)}, self_exited, forwarded
            if first_exit is None and any(rc is not None for rc in rcs):
                first_exit = time.monotonic()
            if first_exit is not None:
                waited = time.monotonic() - first_exit
                # after a forwarded preempt each child already holds its first
                # signal: a second SIGTERM would force-exit an emergency save,
                # so stragglers go straight to SIGKILL
                if waited > grace and not terminated and not forwarded:
                    terminated = True
                    for p in procs:
                        if p.poll() is None:
                            try:
                                p.send_signal(_signal.SIGTERM)
                            except OSError:
                                pass
                elif waited > grace + max(10.0, grace) and not killed:
                    killed = True
                    for p in procs:
                        if p.poll() is None:
                            try:
                                p.kill()
                            except OSError:
                                pass
            time.sleep(0.2)

    def run_attempt(attempt: int):
        attempt_args = list(base_args)
        if attempt > 0:
            resume_from = find_latest_checkpoint(str(run_base)) or fallback_resume
            # the fault (presumably) fired: it must not ride into the retry
            attempt_args = [a for a in attempt_args if not a.startswith("checkpoint.resume_from=")]
            attempt_args += ["resilience.fault.kind=null"]
            if resume_from is not None:
                attempt_args.append(f"checkpoint.resume_from={resume_from}")
        attempt_args.append(f"metric.telemetry.attempt={attempt}")

        emit("gang", status="spawn", processes=n, args_tail=attempt_args[-3:])
        exit_codes, self_exited, forwarded = wait_gang(spawn(attempt_args, attempt))
        outcome = _classify(exit_codes)
        if (
            outcome == "crash"
            and forwarded
            and all(exit_codes[r] in (0, signals.PREEMPTED_EXIT_CODE) for r in self_exited)
        ):
            # stragglers the teardown killed during a forwarded preempt are
            # collateral: every rank that exited on its own cooperated
            outcome = "preempt"
        # the ranks that failed on their own: not the survivors the teardown
        # killed, not a cooperative 75, not a healthy rank reporting a peer's
        # death (77)
        dead_ranks = {
            str(r): rc
            for r, rc in exit_codes.items()
            if rc not in (0, signals.PREEMPTED_EXIT_CODE, signals.RANK_FAILED_EXIT_CODE) and r in self_exited
        }
        emit(
            "gang",
            status="attempt_exit",
            exit_codes={str(r): rc for r, rc in exit_codes.items()},
            outcome=outcome,
            dead_ranks=dead_ranks,
        )
        return outcome, {"dead_ranks": dead_ranks, "exit_codes": exit_codes}

    def restart_fields(attempt, outcome, info):
        resume_preview = find_latest_checkpoint(str(run_base)) or fallback_resume
        return {"dead_ranks": info["dead_ranks"], "resume_from": str(resume_preview) if resume_preview else None}

    def giveup_fields(info):
        return {"dead_ranks": info["dead_ranks"]}

    def on_giveup(outcome, info):
        if outcome == "crash":
            raise GangFailureError(
                f"gang of {n} crashed {policy.attempt - 1} time(s) past the restart budget "
                f"(last exit codes: {info['exit_codes']}); see {log_dir}"
            )
        return "preempted"

    try:
        return run_restart_policy(
            policy, run_attempt, emit, restart_fields=restart_fields, giveup_fields=giveup_fields, on_giveup=on_giveup
        )
    finally:
        # never orphan the gang: the children run in their own sessions
        for p in live_procs:
            if p.poll() is None:
                try:
                    p.terminate()
                except OSError:
                    pass
        deadline = time.monotonic() + 5.0
        while any(p.poll() is None for p in live_procs) and time.monotonic() < deadline:
            time.sleep(0.1)
        for p in live_procs:
            if p.poll() is None:
                try:
                    p.kill()
                except OSError:
                    pass
        if sink is not None:
            sink.close()


def gang_processes(cfg: Any) -> int:
    """The configured gang size (0 when gang mode is off)."""
    gcfg = (((cfg.get("resilience") or {}).get("distributed") or {}).get("gang")) or {}
    return int(gcfg.get("processes") or 0)

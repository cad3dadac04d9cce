"""The decoupled topology: a player loop and a learner, in one process (the
learner in a thread) or in two (port of ``sheeprl_tpu/algos/{ppo,sac,dreamer_v3}/*_decoupled.py``).

The player loop is the algorithm's coupled loop, given a channel trainer in
place of its trainer (:func:`run_player`). The two roles alternate, blocking,
as in the JAX package:

- the player puts one round's message on the data channel and blocks on the
  reply channel;
- the learner trains on it and replies;
- a ``None`` on the data channel ends the run, and the learner answers it with
  its final state (``None`` where the player needs none).

**One process** (:class:`LearnerThread`): the learner runs in a daemon thread,
and two depth-1 queues join the roles. A learner that raises stores the
exception, then replies ``None``; the player raises that exception. The player
polls the reply queue and looks at the thread between polls (a learner that
ended without a reply is an error too), and every join has a timeout, so a
learner that dies never hangs the player. Both roles stay on the default CUDA
stream: the alternation is synchronous, so their launches never overlap. The
learner writes no timer (``utils/timer.py``'s registry has one writer, the
player, which times the whole exchange) and draws only from its own
``torch.Generator``.

**Two processes** (:class:`LearnerProcess` on the player, process 0;
:func:`serve_learner` on the learner, process 1): two
``parallel/distributed.py`` channels over the run's store, data from process 0
and replies from process 1. The learner rebuilds the agent from the shared
seed, so no initial weights cross; the player's first message is the geometry
handshake ``{"player_world_size": 1}``, and a ``None`` in its place or in a
round's releases a learner whose player failed. Messages cross as host
tensors (:func:`host_copy` before pickling), and each role places what it
receives on its own device. A learner that fails publishes the failure marker
first, then replies ``None`` (unless the failure was the channel's), so the
player raises :class:`~sheeprl_tpu_torch.parallel.distributed.ChannelPeerError`
with the learner's reason at once; no put follows a channel error. The final
reply carries the learner's kernel launches and seconds, which the player's
run summary reports beside its own (:meth:`LearnerProcess.report`).

Replies are copies (:func:`snapshot`, :func:`optimizer_snapshot`): a torch
optimizer steps the learner's parameters in place, so the view handed to the
player and the state kept for a deferred checkpoint must be taken at the round
that made them.
"""

from __future__ import annotations

import copy
import json
import queue
import threading
import time
from typing import Any, Callable, Dict, List, Mapping, Optional

import torch

# the player looks at the learner's thread between polls of the reply queue
POLL_S = 0.1
# how long a join waits for the learner's thread to end
JOIN_TIMEOUT_S = 60.0
# how long a player that failed before its handshake waits for the learner's answer
RELEASE_TIMEOUT_S = 60.0


def snapshot(tensors: Mapping[str, torch.Tensor], device=None) -> Dict[str, torch.Tensor]:
    """A detached copy of each tensor, on ``device`` (its own when None)."""
    return {k: v.detach().to(v.device if device is None else device, copy=True) for k, v in tensors.items()}


def optimizer_snapshot(optimizer: torch.optim.Optimizer) -> Dict[str, Any]:
    """A copy of ``optimizer.state_dict()`` with its tensors on the host (the
    state dict itself holds the live moment tensors)."""
    sd = optimizer.state_dict()
    return {
        "state": {
            i: {k: v.detach().to("cpu", copy=True) if torch.is_tensor(v) else copy.deepcopy(v) for k, v in s.items()}
            for i, s in sd["state"].items()
        },
        "param_groups": copy.deepcopy(sd["param_groups"]),
    }


def host_copy(obj: Any) -> Any:
    """``obj`` with every tensor in it detached and on the host (through
    dicts, lists and tuples): what a message holds when it is pickled."""
    if torch.is_tensor(obj):
        return obj.detach().cpu()
    if isinstance(obj, dict):
        return {k: host_copy(v) for k, v in obj.items()}
    if type(obj) in (list, tuple):
        return type(obj)(host_copy(v) for v in obj)
    return obj


def kernel_launches() -> Dict[str, int]:
    """This process's launches of each hand-written kernel."""
    from sheeprl_tpu_torch.ops import KERNELS

    return {spec.name: spec.launches for spec in KERNELS}


def learner_loop(learner, data_q: "queue.Queue", reply_q: "queue.Queue", error: Dict[str, Any]) -> None:
    """The learner thread's body: ``learner.round(*message)`` for each message
    until the ``None`` sentinel, which ``learner.final_state()`` answers."""
    try:
        while True:
            msg = data_q.get()
            if msg is None:
                reply_q.put(learner.final_state())
                return
            reply_q.put(learner.round(*msg))
    except Exception as exc:  # surface the crash to the player
        error["exc"] = exc
        reply_q.put(None)


class LearnerThread:
    """The player's end of the channel: starts ``learner``'s thread at the
    first exchange and trades messages for replies with it."""

    def __init__(self, learner, name: str):
        self.learner = learner
        self.data_q: "queue.Queue" = queue.Queue(maxsize=1)
        self.reply_q: "queue.Queue" = queue.Queue(maxsize=1)
        self.error: Dict[str, Any] = {}
        self.thread = threading.Thread(
            target=learner_loop, args=(learner, self.data_q, self.reply_q, self.error), daemon=True, name=name
        )
        self.closed = False
        self.final: Any = None

    def _raise(self, message: str):
        if "exc" in self.error:
            raise self.error["exc"]
        raise RuntimeError(message)

    def _reply(self) -> Any:
        while True:
            try:
                return self.reply_q.get(timeout=POLL_S)
            except queue.Empty:
                if not self.thread.is_alive():
                    try:  # the reply may have landed as the thread ended
                        return self.reply_q.get_nowait()
                    except queue.Empty:
                        self._raise("the learner thread ended without replying")

    def exchange(self, *message: Any) -> Any:
        """One round: put ``message``, block until the learner replies."""
        if self.closed:
            raise RuntimeError("the learner's channel is closed")
        if self.thread.ident is None:
            self.thread.start()
        self.data_q.put(message)
        reply = self._reply()
        if reply is None:
            self._raise("the learner ended mid-run (it replied with the sentinel before the player finished)")
        return reply

    def close(self) -> Any:
        """The sentinel: returns the learner's final state once its thread
        ended (the state it started from when no round ran; the same state
        again on a later call)."""
        if self.closed:
            return self.final
        self.closed = True
        if self.thread.ident is None:
            self.final = self.learner.final_state()
            return self.final
        self.data_q.put(None)
        final = self._reply()
        self.thread.join(timeout=JOIN_TIMEOUT_S)
        if self.thread.is_alive():
            raise RuntimeError(f"the learner thread did not end within {JOIN_TIMEOUT_S} s")
        if "exc" in self.error:
            raise self.error["exc"]
        self.final = final
        return final

    def abort(self) -> None:
        """The player's crash path: send the sentinel without waiting for a
        round, drop any reply, and join the thread (within the timeout)."""
        self.closed = True
        if self.thread.ident is None:
            return
        deadline = time.monotonic() + JOIN_TIMEOUT_S
        sent = False
        while self.thread.is_alive() and time.monotonic() < deadline:
            if not sent:
                try:
                    self.data_q.put_nowait(None)
                    sent = True
                except queue.Full:
                    pass
            try:
                self.reply_q.get(timeout=POLL_S)
            except queue.Empty:
                pass
        self.thread.join(timeout=max(0.0, deadline - time.monotonic()))

    def __enter__(self) -> "LearnerThread":
        return self

    def __exit__(self, exc_type, exc, tb) -> None:
        # a raising player releases the learner; a clean exit has called close()
        if exc_type is not None:
            self.abort()


class LearnerProcess:
    """The player's end of the two-process channel (process 0): the
    counterpart of :class:`LearnerThread`, with its ``exchange``, ``close``
    and ``abort``, over the store's data (src 0) and reply (src 1) channels.
    Opening it puts the geometry handshake. :attr:`seconds` holds each
    exchange's wall time; :attr:`learner` is what the learner's final reply
    reports (its seconds in each ``round``, and its kernel launches)."""

    def __init__(self, cfg):
        from sheeprl_tpu_torch.parallel.distributed import BroadcastChannel
        from sheeprl_tpu_torch.resilience.distributed import channel_options

        opts = channel_options(cfg)
        self.data = BroadcastChannel(src=0, **opts)
        self.replies = BroadcastChannel(src=1, **opts)
        self.closed = False
        # a channel op failed, or the learner ended: nothing more is put
        self.broken = False
        self.final: Any = None
        self.learner: Optional[Dict[str, Any]] = None
        self.seconds: List[float] = []
        self._put({"player_world_size": 1})

    def _put(self, message: Any) -> None:
        from sheeprl_tpu_torch.parallel.distributed import ChannelError

        try:
            self.data.put(host_copy(message))
        except ChannelError:
            self.broken = True
            raise

    def _reply(self) -> Any:
        from sheeprl_tpu_torch.parallel.distributed import ChannelError, ChannelPeerError, poll_channel_error

        try:
            reply = self.replies.get()
        except ChannelError:
            self.broken = True
            raise
        if reply is None:
            self.broken = True
            marker = poll_channel_error(self.replies.kv)
            if marker is not None:
                raise ChannelPeerError(f"the learner process failed: {marker}")
            raise RuntimeError("the learner process ended mid-run (it replied with the sentinel before the player "
                               "finished)")
        return reply

    def exchange(self, *message: Any) -> Any:
        """One round: put ``message``, block until the learner replies."""
        if self.closed:
            raise RuntimeError("the learner's channel is closed")
        t0 = time.perf_counter()
        self._put(message)
        reply = self._reply()
        self.seconds.append(time.perf_counter() - t0)
        return reply

    def close(self) -> Any:
        """The sentinel: returns the learner's final state (the same state
        again on a later call)."""
        if self.closed:
            return self.final
        self.closed = True
        self._put(None)
        self.final, self.learner = self._reply()
        return self.final

    def abort(self) -> None:
        """The player's crash path: the sentinel, and the learner's answer
        dropped; nothing after a channel error or a learner that ended."""
        if self.closed:
            return
        self.closed = True
        if self.broken:
            return
        try:
            self.data.put(None)
            self.replies.get()
        except Exception:
            pass

    def report(self) -> Dict[str, Any]:
        """Each role's kernel launches, and the exchanges' seconds after the
        first (which waits for the learner process to start): a round's mean,
        the learner's mean in ``round``, and the rest's share (the handoff:
        host copies, pickling and the store, both ways)."""
        learner = self.learner or {"seconds": [], "launches": {}}
        ours, theirs = sum(self.seconds[1:]), sum(learner["seconds"][1:])
        steady = max(len(self.seconds) - 1, 1)
        return {
            "rounds": len(self.seconds),
            "first_round_seconds": self.seconds[0] if self.seconds else 0.0,
            "round_seconds": ours / steady,
            "learner_round_seconds": theirs / steady,
            "handoff_share": (ours - theirs) / ours if ours > 0 else 0.0,
            "launches": {"player": kernel_launches(), "learner": dict(learner["launches"])},
        }


def serve_learner(cfg, build_learner: Callable[[Optional[Dict[str, Any]]], Any]) -> None:
    """The learner process's body (process 1), the counterpart of
    :func:`learner_loop` over the store. It waits for the handshake (a
    ``None`` there: the player failed first, so it answers ``None`` and
    returns), loads ``checkpoint.resume_from`` itself when set (the optimizer
    states and Moments are the learner's to restore), builds the learner with
    ``build_learner(state)``, and answers each round with
    ``learner.round(*message)`` until the sentinel, which it answers with
    ``(learner.final_state(), {"seconds", "launches"})``. A failure publishes
    the marker first, then replies ``None`` unless the channel failed."""
    from sheeprl_tpu_torch.parallel.distributed import BroadcastChannel, ChannelError, publish_channel_error
    from sheeprl_tpu_torch.resilience.distributed import channel_options
    from sheeprl_tpu_torch.utils.checkpoint import load_checkpoint

    opts = channel_options(cfg)
    data, replies = BroadcastChannel(src=0, **opts), BroadcastChannel(src=1, **opts)
    if data.get() is None:
        replies.put(None)
        return
    stage = "checkpoint resume load failed"
    try:
        state = load_checkpoint(cfg.checkpoint.resume_from) if cfg.checkpoint.resume_from else None
        if state is not None:
            state.pop("rb", None)  # the player's replay buffer
        stage = "learner set-up failed"
        learner = build_learner(state)
        del state
        stage = "learner train loop failed"
        seconds: List[float] = []
        while True:
            message = data.get()
            if message is None:
                final = learner.final_state()
                replies.put(host_copy((final, {"seconds": seconds, "launches": kernel_launches()})))
                return
            t0 = time.perf_counter()
            reply = learner.round(*message)
            if torch.cuda.is_initialized():
                torch.cuda.synchronize()
            seconds.append(time.perf_counter() - t0)
            replies.put(host_copy(reply))
    except BaseException as exc:
        publish_channel_error(f"{stage}: {exc!r:.300}", kv=replies.kv)
        if not isinstance(exc, ChannelError):
            try:
                replies.put(None)
            except ChannelError:
                pass
        raise


def release_peer(exc: BaseException) -> None:
    """The crash path of a process of a two-process run that failed before
    its role opened its channels (in the CLI, or building its loop): the
    learner publishes the failure marker and replies ``None``, so the player's
    next wait raises with its reason; the player puts ``None`` in place of the
    handshake and waits, bounded, for the learner's answer, so both exit. A
    no-op in one process, or once the role's channels exist (their own crash
    paths ran). Never raises: the failure itself surfaces either way."""
    from sheeprl_tpu_torch.parallel import distributed

    if distributed.store() is None:
        return
    rank = distributed.process_index()
    try:
        if rank == 0 and not distributed.channels_made(0):
            distributed.BroadcastChannel(src=0).put(None)
            distributed.BroadcastChannel(src=1, timeout_s=RELEASE_TIMEOUT_S, poll_s=1.0).get()
        elif rank >= 1 and not distributed.channels_made(1):
            distributed.publish_channel_error(f"process {rank} failed: {exc!r:.300}")
            distributed.BroadcastChannel(src=1).put(None)
    except Exception:
        pass


def run_player(loop: Callable[[Callable[..., Any]], Dict[str, Any]], trainer_cls, cfg) -> Dict[str, Any]:
    """``loop(make_trainer)``: a coupled training loop (``run_on_policy``,
    ``run_off_policy``, ``run_dreamer``) as the player, with
    ``make_trainer(*args)`` building ``trainer_cls(*args, channel=...)``, a
    trainer whose learner runs in its own thread (``channel`` None) or in the
    learner process, behind ``channel``, a :class:`LearnerProcess` opened
    here when the run has two processes. Each learner is closed when the loop
    returns and released when it raises, so a crash of either role ends both.
    A two-process run's summary carries the channel's :meth:`LearnerProcess.report`
    (``learner_process``), which is also printed as a JSON line."""
    from sheeprl_tpu_torch.parallel import distributed

    channel = LearnerProcess(cfg) if distributed.process_count() >= 2 else None
    trainers: List[Any] = []

    def make_trainer(*args: Any) -> Any:
        trainers.append(trainer_cls(*args, channel=channel))
        return trainers[-1]

    try:
        summary = loop(make_trainer)
    except BaseException:
        for trainer in trainers:
            trainer.abort()
        if channel is not None:
            channel.abort()
        raise
    for trainer in trainers:
        trainer.close()
    if channel is not None:
        channel.close()
        summary["learner_process"] = channel.report()
        print(f"[sheeprl] learner process: {json.dumps(summary['learner_process'])}", flush=True)
    return summary

"""The decoupled topology in one process: a player loop and a learner thread
(the thread mode of ``sheeprl_tpu/algos/{ppo,sac,dreamer_v3}/*_decoupled.py``).

The player loop runs in the main thread and the learner in a daemon thread.
The player loop is the algorithm's coupled loop, given a channel trainer in
place of its trainer (:func:`run_player`). Two depth-1 queues join the roles,
with the JAX package's blocking alternation:

- the player puts one round's message on the data queue and blocks on the
  reply queue;
- the learner trains on it and replies;
- a ``None`` on the data queue ends the run, and the learner answers it with
  its final state (``None`` where the player needs none).

A learner that raises stores the exception, then replies ``None``; the player
raises that exception. The thread is a daemon, the player polls the reply
queue and looks at the thread between polls (a learner that ended without a
reply is an error too), and every join has a timeout, so a learner that dies
never hangs the player.

Replies are copies (:func:`snapshot`, :func:`optimizer_snapshot`): a torch
optimizer steps the learner's parameters in place, so the view handed to the
player and the state kept for a deferred checkpoint must be taken at the round
that made them.

Both roles stay on the default CUDA stream. The alternation is synchronous, so
their launches never overlap, and one stream's order is all the handoff needs.
The learner writes no timer (``utils/timer.py``'s registry has one writer, the
player, which times the whole exchange) and draws only from its own
``torch.Generator``.
"""

from __future__ import annotations

import copy
import queue
import threading
import time
from typing import Any, Callable, Dict, List, Mapping

import torch

# the player looks at the learner's thread between polls of the reply queue
POLL_S = 0.1
# how long a join waits for the learner's thread to end
JOIN_TIMEOUT_S = 60.0


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


def run_player(loop: Callable[[Callable[..., Any]], Dict[str, Any]], trainer_cls) -> Dict[str, Any]:
    """``loop(make_trainer)``: a coupled training loop (``run_on_policy``,
    ``run_off_policy``, ``run_dreamer``) as the player, with
    ``make_trainer(*args)`` building ``trainer_cls``, a trainer whose learner
    runs in its own thread behind a :class:`LearnerThread` (its ``close`` and
    ``abort``). Each learner's thread is closed when the loop returns and
    released when it raises, so a crash of either role ends both."""
    trainers: List[Any] = []

    def make_trainer(*args: Any) -> Any:
        trainers.append(trainer_cls(*args))
        return trainers[-1]

    try:
        summary = loop(make_trainer)
    except BaseException:
        for trainer in trainers:
            trainer.abort()
        raise
    for trainer in trainers:
        trainer.close()
    return summary

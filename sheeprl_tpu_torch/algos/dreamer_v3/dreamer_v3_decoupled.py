"""Dreamer-V3, decoupled: ``run_dreamer``'s player loop and a learner thread in
one process (port of the thread mode of
``sheeprl_tpu/algos/dreamer_v3/dreamer_v3_decoupled.py``).

The player runs ``run_dreamer``'s own loop with :class:`ChannelTrainer` in
place of the coupled trainer, and acts with its own copy of the agent on the
fabric's device. The learner (:class:`DV3Learner`, in its thread) owns the
agent, its optimizers and the Moments, and takes the coupled trainer's
gradient steps over each ``[G, T, B, ...]`` block. Its reply is the act view
(the world model with its initial recurrent state, and the actor: what the
player's RSSM and policy read), the whole training state only when the player
is about to checkpoint and once more at the end (so a checkpoint due between
rounds is deferred, not dropped), and the metrics.

Random draws: the player hands its generator's state over with each block, as
the JAX player hands over the train key it split from its own, and takes the
advanced state back with the reply. The learner draws from its own generator
set to that state, so a decoupled run draws, and trains, as the coupled run of
the same config does.

The LN-GRU kernel runs in both threads (the player's RSSM step at B = envs,
the learner's scans); the alternation is synchronous, so the two never launch
at once, and both stay on the default stream.
"""

from __future__ import annotations

import copy
from typing import Any, Dict, Optional

import torch

from sheeprl_tpu_torch.algos.dreamer_v3.dreamer_v3 import DV3Trainer, build_optimizers, run_dreamer
from sheeprl_tpu_torch.parallel.decoupled import LearnerThread, optimizer_snapshot, run_player, snapshot


def act_view(agent) -> Dict[str, Any]:
    """A copy, on the agent's device, of what the player acts with (the JAX
    ``_act_select``): the world model, its initial recurrent state and the actor."""
    return {
        "world_model": snapshot(agent.world_model.state_dict()),
        "initial_recurrent_state": agent.initial_recurrent_state.detach().clone(),
        "actor": snapshot(agent.actor.state_dict()),
    }


def load_act_view(agent, view: Dict[str, Any]) -> None:
    agent.world_model.load_state_dict(view["world_model"])
    agent.actor.load_state_dict(view["actor"])
    with torch.no_grad():
        agent.initial_recurrent_state.copy_(view["initial_recurrent_state"])


class DV3Learner:
    """The learner role: a :class:`DV3Trainer` and its own generator.
    :meth:`round` is one message of the protocol."""

    def __init__(self, trainer: DV3Trainer):
        self.trainer = trainer
        self.generator = torch.Generator(trainer.device)

    def full_state(self) -> Dict[str, Any]:
        """The checkpoint's agent, optimizer states and Moments, copied to the
        host (the JAX ``_full_state_host``)."""
        trainer = self.trainer
        return {
            "agent": trainer.agent_state(),
            "opt_state": {name: optimizer_snapshot(opt) for name, opt in trainer.optimizers.items()},
            "moments": snapshot(trainer.moments, "cpu"),
        }

    def round(self, data: Dict[str, torch.Tensor], cum_steps: int, generator_state: torch.Tensor,
              want_full_state: bool):
        """``G`` gradient steps; reply ``(act view, full state or None,
        metrics, the generator's state after the round's draws)``."""
        self.generator.set_state(generator_state)
        metrics = self.trainer.train(data, int(cum_steps), self.generator)
        full = self.full_state() if want_full_state else None
        return act_view(self.trainer.agent), full, metrics, self.generator.get_state()

    def final_state(self) -> Dict[str, Any]:
        return self.full_state()


class ChannelTrainer:
    """``run_dreamer``'s trainer backed by the learner thread (the JAX
    ``_ChannelTrainer``). The whole training state exists on the player's
    side only at the rounds that ship it, so it defers checkpoints."""

    defers_checkpoints = True

    def __init__(self, agent, cfg):
        self.learner = DV3Learner(DV3Trainer(agent, cfg, build_optimizers(cfg, agent)))
        # the player's own copy, on the same device: it acts on the card
        self.act_agent = copy.deepcopy(agent)
        self.channel = LearnerThread(self.learner, "dv3-learner")
        self._last_full: Optional[Dict[str, Any]] = None

    # a resumed run's optimizer states and Moments reach the learner before
    # its thread starts (at the first round)
    def load_opt_state(self, opt_state: Any) -> None:
        self.learner.trainer.load_opt_state(opt_state)

    def load_moments(self, tree: Any) -> None:
        self.learner.trainer.load_moments(tree)

    def train(self, data, cum_steps: int, generator: torch.Generator, want_full_state: bool = False):
        view, full, metrics, generator_state = self.channel.exchange(
            data, int(cum_steps), generator.get_state(), bool(want_full_state)
        )
        load_act_view(self.act_agent, view)
        generator.set_state(generator_state)
        if full is not None:
            self._last_full = full
        return metrics

    def checkpoint_state(self) -> Dict[str, Any]:
        if self._last_full is None:
            raise RuntimeError("checkpoint_state before any round that shipped the whole state")
        return self._last_full

    def close(self) -> Dict[str, Any]:
        """The sentinel; the learner's final state."""
        return self.channel.close()

    def abort(self) -> None:
        self.channel.abort()


def main(fabric, cfg: Dict[str, Any]) -> Dict[str, Any]:
    return run_player(lambda make_trainer: run_dreamer(fabric, cfg, make_trainer=make_trainer), ChannelTrainer)

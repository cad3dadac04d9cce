"""Dreamer-V3, decoupled: ``run_dreamer``'s player loop and a learner, in one
process (the learner in a thread) or in two (port of
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

In a two-process run (``parallel/distributed.py``'s store) process 0 is the
player and process 1 the learner (:func:`build_learner`): it builds its own
agent from ``cfg.seed`` as the player does (no initial weights cross), loads
a resumed run's agent, optimizer states and Moments itself, and serves the
rounds over the store (``parallel/decoupled.py::serve_learner``). The player
samples its blocks on the host and acts with the agent it built, on the card;
the generator's state crosses as a host byte tensor (also for a CUDA
generator). Each process launches the kernel in its own CUDA context, and
counts its own launches: the learner's reach the player in its final reply.
"""

from __future__ import annotations

import copy
from typing import Any, Dict, Optional

import torch

from sheeprl_tpu_torch.algos.dreamer_v3.dreamer_v3 import DV3Trainer, build_optimizers, run_dreamer
from sheeprl_tpu_torch.parallel import distributed
from sheeprl_tpu_torch.parallel.decoupled import LearnerThread, optimizer_snapshot, run_player, serve_learner, snapshot


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
        """``G`` gradient steps on the block, placed on the trainer's device;
        reply ``(act view, full state or None, metrics, the generator's state
        after the round's draws)``."""
        self.generator.set_state(generator_state)
        data = {k: v.to(self.trainer.device) for k, v in data.items()}
        metrics = self.trainer.train(data, int(cum_steps), self.generator)
        full = self.full_state() if want_full_state else None
        return act_view(self.trainer.agent), full, metrics, self.generator.get_state()

    def final_state(self) -> Dict[str, Any]:
        return self.full_state()


def build_learner(fabric, cfg, state: Optional[Dict[str, Any]] = None) -> DV3Learner:
    """The learner role as the learner process builds it: the agent from
    ``cfg.seed`` as ``run_dreamer`` builds the player's (the resumed agent,
    optimizer states and Moments of ``state`` when given), its optimizers and
    the Moments."""
    from sheeprl_tpu_torch.algos.dreamer_v3.agent import build_agent
    from sheeprl_tpu_torch.envs.spaces import action_space_dims
    from sheeprl_tpu_torch.utils.env import make_env

    cfg.env.frame_stack = -1  # as run_dreamer sets it
    env = make_env(cfg, cfg.seed, 0, None, "learner")()
    observation_space, action_space = env.observation_space, env.action_space
    env.close()
    actions_dim, is_continuous = action_space_dims(action_space)
    fabric.seed_everything(cfg.seed)
    agent = build_agent(
        fabric, actions_dim, is_continuous, cfg, observation_space, cfg.seed, state["agent"] if state else None
    )
    trainer = DV3Trainer(agent, cfg, build_optimizers(cfg, agent))
    if state is not None and "opt_state" in state:
        trainer.load_opt_state(state["opt_state"])
    if state is not None and "moments" in state:
        trainer.load_moments(state["moments"])
    return DV3Learner(trainer)


class ChannelTrainer:
    """``run_dreamer``'s trainer backed by the learner thread, or by the
    learner process behind ``channel`` (a ``LearnerProcess``; the JAX
    ``_ChannelTrainer``). The whole training state exists on the player's
    side only at the rounds that ship it, so it defers checkpoints."""

    defers_checkpoints = True

    def __init__(self, agent, cfg, channel=None):
        self.learner = None
        # a learner process takes host blocks and places them itself
        self.data_device = "cpu" if channel is not None else None
        if channel is None:
            self.learner = DV3Learner(DV3Trainer(agent, cfg, build_optimizers(cfg, agent)))
            # the player's own copy, on the same device: it acts on the card
            self.act_agent = copy.deepcopy(agent)
            channel = LearnerThread(self.learner, "dv3-learner")
        else:
            self.act_agent = agent
        self.channel = channel
        self._last_full: Optional[Dict[str, Any]] = None

    # a resumed run's optimizer states and Moments reach the learner thread
    # before it starts (at the first round); a learner process loads its own
    def load_opt_state(self, opt_state: Any) -> None:
        if self.learner is not None:
            self.learner.trainer.load_opt_state(opt_state)

    def load_moments(self, tree: Any) -> None:
        if self.learner is not None:
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
    if distributed.process_index() >= 1:  # the learner process of a two-process run
        return serve_learner(cfg, lambda state: build_learner(fabric, cfg, state))
    return run_player(lambda make_trainer: run_dreamer(fabric, cfg, make_trainer=make_trainer), ChannelTrainer, cfg)

"""SAC, decoupled: a player loop and a learner, in one process (the learner in
a thread) or in two (port of ``sheeprl_tpu/algos/sac/sac_decoupled.py``).

The player is the coupled loop, ``run_off_policy``, with
:class:`ChannelTrainer` in place of ``SACTrainer``: it owns the envs, the
replay buffer, the replay-ratio governor and a host copy of the agent, which
it acts with, checkpoints and tests. Each iteration that trains, it samples a
``[G, B, ...]`` block and ships it with the iteration's number (the target
EMA's gate). The learner (:class:`SACLearner`, in its thread, on the fabric's
device) owns the agent and its three optimizers: a round is the coupled
loop's train phase (``SACTrainer.train_phase``), and its reply a copy of the
agent's state, the optimizers' states when asked for, and the mean losses.
``parallel/decoupled.py`` joins the two, and the player blocks on each reply.

The message is the JAX loop's ``(block, iter_num, want_opt_state)``. A
checkpoint asks the learner for the optimizers' states with a message that
carries no block, so they are always those of the parameters beside them. The
JAX loop ships them only with a round, and pairs the newest parameters with
an older round's states when a checkpoint falls in an iteration that takes no
gradient step.

The learner draws its normal noise from its own generator, seeded from
``seed + 1`` (the JAX learner keys from ``PRNGKey(seed + 1)``), on its device,
as the coupled loop's train generator is seeded; the player's draws come from
its own generators, seeded from ``seed``. So a decoupled run trains as the
coupled run of the same config does.

In a two-process run (``parallel/distributed.py``'s store) process 0 is the
player and process 1 the learner (:func:`build_learner`): it builds its own
agent from ``cfg.seed`` as the player does (no initial weights cross), loads
a resumed run's agent and optimizer states itself (not the replay buffer), and
serves the rounds over the store (``parallel/decoupled.py::serve_learner``).
The player then samples its blocks on the host: they cross the store as host
tensors, and the learner places them on its device.
"""

from __future__ import annotations

import copy
from typing import Any, Dict, Optional

import torch

from sheeprl_tpu_torch.algos.sac.agent import build_agent
from sheeprl_tpu_torch.algos.sac.sac import SACTrainer, run_off_policy
from sheeprl_tpu_torch.data.prefetch import sample_to_device
from sheeprl_tpu_torch.parallel import distributed
from sheeprl_tpu_torch.parallel.decoupled import LearnerThread, optimizer_snapshot, run_player, serve_learner, snapshot


class SACLearner:
    """The learner role: a :class:`SACTrainer` (the agent on its device and
    its optimizers) and the noise's generator. :meth:`round` is one message
    of the protocol."""

    def __init__(self, trainer: SACTrainer, seed: int):
        self.trainer = trainer
        self.generator = torch.Generator(trainer.device).manual_seed(int(seed) + 1)

    def draw(self, G: int, batch_size: int) -> Dict[str, torch.Tensor]:
        """This round's normal noise (``SACTrainer.draw_noise``)."""
        return self.trainer.draw_noise(G, batch_size, self.generator)

    def round(self, data: Optional[Dict[str, torch.Tensor]], iter_num: int, want_opt_state: bool):
        """Train on one ``[G, B, ...]`` block (none: no gradient step); reply
        ``(agent state, optimizers' states or None, mean losses or None)``,
        all copies on the host."""
        trainer = self.trainer
        losses = None
        if data is not None:
            block = {k: v.to(trainer.device) for k, v in data.items()}
            G, B = block["rewards"].shape[:2]
            losses = trainer.train_phase(block, int(iter_num), self.draw(G, B)).cpu()
        opt_state = None
        if want_opt_state:
            opt_state = {name: optimizer_snapshot(opt) for name, opt in trainer.optimizers.items()}
        return snapshot(trainer.agent.state_dict(), "cpu"), opt_state, losses

    def final_state(self) -> None:
        return None


def build_learner(fabric, cfg, state: Optional[Dict[str, Any]] = None) -> SACLearner:
    """The learner role as the learner process builds it: the agent from
    ``cfg.seed`` as ``run_off_policy`` builds the player's (the resumed agent
    and optimizer states of ``state`` when given), and its optimizers."""
    import numpy as np

    from sheeprl_tpu_torch.utils.env import make_env

    env = make_env(cfg, cfg.seed, 0, None, "learner")()
    observation_space, action_space = env.observation_space, env.action_space
    env.close()
    SACTrainer.check_spaces(cfg, observation_space, "SAC")
    fabric.seed_everything(cfg.seed)
    agent = build_agent(fabric, cfg, observation_space, action_space, int(cfg.seed), state["agent"] if state else None)
    act_dim = int(np.prod(action_space.shape))
    trainer = SACTrainer(agent, SACTrainer.build_optimizers(cfg, agent), cfg, -float(act_dim), int(cfg.env.num_envs))
    # a JAX checkpoint written before learning started holds no optimizer state
    if state is not None and state.get("opt_state") is not None:
        trainer.load_opt_state(state["opt_state"])
    return SACLearner(trainer, int(cfg.seed))


class ChannelTrainer(SACTrainer):
    """``run_off_policy``'s trainer with the learner in its own thread, or in
    the learner process behind ``channel`` (a ``LearnerProcess``). As a
    ``SACTrainer`` it holds the player's copy of the agent, on the host: the
    loop acts with it (so ``sync_acting`` has nothing to copy), checkpoints it
    and tests it. The optimizers, and the train phase, are the learner's."""

    def __init__(self, agent, optimizers, cfg, target_entropy: float, policy_steps_per_iter: int = 1, channel=None):
        super().__init__(copy.deepcopy(agent).to("cpu"), {}, cfg, target_entropy, policy_steps_per_iter)
        self.learner_trainer = None
        if channel is None:
            learner = SACLearner(SACTrainer(agent, optimizers, cfg, target_entropy, policy_steps_per_iter),
                                 int(cfg.seed))
            self.learner_trainer = learner.trainer
            channel = LearnerThread(learner, "sac-learner")
        self.channel = channel

    def load_opt_state(self, opt_state: Optional[Dict[str, Any]]) -> None:
        """Before the learner's thread starts (a learner process loads its
        own). A JAX checkpoint written before learning started holds none."""
        if opt_state is not None and self.learner_trainer is not None:
            self.learner_trainer.load_opt_state(opt_state)

    def run_phase(self, rb, G: int, sample: Dict[str, Any], generator: torch.Generator, iter_num: int) -> torch.Tensor:
        """Sample a ``[G, B, ...]`` block (to the learner thread's device, or
        on the host for a learner process) and trade it for the learner's
        reply (``generator`` is the player's: the learner draws from its
        own)."""
        if self.learner_trainer is None:  # a learner process takes host blocks and places them itself
            sample = {**sample, "device": "cpu"}
        data = sample_to_device(rb, G, **sample)
        params, _, losses = self.channel.exchange(data, int(iter_num), False)
        self.agent.load_state_dict(params)
        return losses

    def opt_state(self) -> Dict[str, Any]:
        """The learner's optimizers' states, asked for with a message that
        carries no block."""
        return self.channel.exchange(None, 0, True)[1]

    def close(self) -> None:
        return self.channel.close()

    def abort(self) -> None:
        self.channel.abort()


def main(fabric, cfg: Dict[str, Any]) -> Dict[str, Any]:
    if distributed.process_index() >= 1:  # the learner process of a two-process run
        return serve_learner(cfg, lambda state: build_learner(fabric, cfg, state))
    return run_player(
        lambda make_trainer: run_off_policy(fabric, cfg, "SAC", build_agent, ChannelTrainer, make_trainer),
        ChannelTrainer,
        cfg,
    )

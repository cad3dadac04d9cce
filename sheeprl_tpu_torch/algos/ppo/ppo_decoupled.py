"""PPO, decoupled: a player loop and a learner, in one process (the learner in
a thread) or in two (port of ``sheeprl_tpu/algos/ppo/ppo_decoupled.py``).

The player is the coupled loop, ``run_on_policy``, with :class:`ChannelTrainer`
in place of ``PPOTrainer``: it owns the envs and a host copy of the agent,
which it acts with, checkpoints and tests. Its train phase computes GAE over
the rollout with that copy's bootstrap values, flattens the rollout
time-major (as the JAX player flattens it) and ships the block. The learner
(:class:`PPOLearner`, in its thread, on the fabric's device) owns the agent
and its optimizer: each round takes ``update_epochs`` passes over the block's
minibatches and replies with a copy of the agent's state, the optimizer's
state when asked for, and the mean losses. The two join through
``parallel/decoupled.py``'s depth-1 queues, and the player blocks on each
reply, so acting and training alternate as in the coupled loop.

In a two-process run (``parallel/distributed.py``'s store) process 0 is the
player and process 1 the learner (:func:`build_learner`): it builds its own
agent from ``cfg.seed`` as the player does (no initial weights cross), loads
a resumed run's agent and optimizer state itself, and serves the rounds over
the store (``parallel/decoupled.py::serve_learner``).

The message is the JAX loop's ``(block, clip_coef, ent_coef,
want_opt_state)``; a checkpoint asks for the optimizer's state with a message
that carries no block. The learner draws its epochs' permutations from its
own generator, seeded from ``seed + 1`` (the JAX learner keys from
``PRNGKey(seed + 1)``); the player's action noise comes from another, seeded
from ``seed``.
"""

from __future__ import annotations

import copy
from typing import Any, Dict, List, Optional

import torch

from sheeprl_tpu_torch.algos.ppo.ppo import PPOTrainer, build_optimizer, run_on_policy
from sheeprl_tpu_torch.parallel import distributed
from sheeprl_tpu_torch.parallel.decoupled import LearnerThread, optimizer_snapshot, run_player, serve_learner, snapshot
from sheeprl_tpu_torch.utils.utils import gae


class PPOLearner:
    """The learner role: the agent (on its device), its optimizer and the
    permutations' generator. :meth:`round` is one message of the protocol."""

    def __init__(self, cfg, agent, total_iters: int):
        optimizer, schedule = build_optimizer(cfg, agent, total_iters)
        self.trainer = PPOTrainer(agent, optimizer, cfg, schedule)
        self.generator = torch.Generator().manual_seed(int(cfg.seed) + 1)
        self.policy_steps_per_iter = int(cfg.env.num_envs) * int(cfg.algo.rollout_steps)
        self.rounds = 0

    def draw(self) -> List[torch.Tensor]:
        """This round's permutations, one per epoch."""
        return self.trainer.draw_permutations(self.generator)

    def round(self, flat: Optional[Dict[str, torch.Tensor]], clip_coef: float, ent_coef: float,
              want_opt_state: bool):
        """Train on one flat block (none: no update); reply ``(agent state,
        optimizer state or None, mean losses or None)``, all copies on the
        host."""
        trainer = self.trainer
        losses = None
        if flat is not None:
            block = {k: v.to(trainer.device) for k, v in flat.items()}
            losses = trainer.train_rows(block, self.draw(), clip_coef, ent_coef).cpu()
            self.rounds += 1
        return (
            snapshot(trainer.agent.state_dict(), "cpu"),
            optimizer_snapshot(trainer.optimizer) if want_opt_state else None,
            losses,
        )

    def final_state(self) -> None:
        return None

    def progress(self, *_: Any) -> int:
        """The learner process's step axis after a round: the policy steps of
        the rounds it trained (the JAX learner's ``rounds * policy_steps_per_iter``)."""
        return self.rounds * self.policy_steps_per_iter


def build_learner(fabric, cfg, state: Optional[Dict[str, Any]] = None) -> PPOLearner:
    """The learner role as the learner process builds it: the agent from
    ``cfg.seed`` as ``run_on_policy`` builds the player's (the resumed agent
    and optimizer state of ``state`` when given), and its optimizer."""
    from sheeprl_tpu_torch.algos.ppo.agent import build_agent
    from sheeprl_tpu_torch.envs.spaces import action_space_dims
    from sheeprl_tpu_torch.interop.flax_to_torch import ppo_to_torch
    from sheeprl_tpu_torch.interop.optax_to_torch import load_optimizer_state
    from sheeprl_tpu_torch.utils.env import make_env

    env = make_env(cfg, cfg.seed, 0, None, "learner")()
    observation_space, action_space = env.observation_space, env.action_space
    env.close()
    actions_dim, is_continuous = action_space_dims(action_space)
    fabric.seed_everything(cfg.seed)
    agent = build_agent(
        fabric, actions_dim, is_continuous, cfg, observation_space, cfg.seed, state["agent"] if state else None
    )
    policy_steps_per_iter = int(cfg.env.num_envs) * int(cfg.algo.rollout_steps)
    total_iters = cfg.algo.total_steps // policy_steps_per_iter if not cfg.dry_run else 1
    if state is not None:
        cfg.algo.per_rank_batch_size = state["batch_size"]
    learner = PPOLearner(cfg, agent, total_iters)
    if state is not None and "optimizer" in state:
        load_optimizer_state(learner.trainer.optimizer, state["optimizer"], ppo_to_torch(agent))
    return learner


class ChannelTrainer:
    """``run_on_policy``'s trainer with the learner in its own thread, or in
    the learner process behind ``channel`` (a ``LearnerProcess``). ``agent``
    is the player's copy, on the host; ``optimizer`` is the learner thread's,
    which a resumed run loads before the thread starts (None with a learner
    process, which loads its own)."""

    def __init__(self, agent, cfg, total_iters: int, channel=None):
        self.optimizer = None
        if channel is None:
            learner = PPOLearner(cfg, agent, total_iters)
            self.optimizer = learner.trainer.optimizer
            channel = LearnerThread(learner, "ppo-learner")
        self.agent = copy.deepcopy(agent).to("cpu")
        self.channel = channel
        self.rollout_steps = int(cfg.algo.rollout_steps)
        self.gamma = float(cfg.algo.gamma)
        self.gae_lambda = float(cfg.algo.gae_lambda)

    def draw_permutations(self, generator: Optional[torch.Generator]) -> None:
        """None: the learner draws its own, from its generator."""
        return None

    def train_phase(self, data: Dict[str, torch.Tensor], next_values: torch.Tensor, perms: None,
                    clip_coef: float, ent_coef: float) -> torch.Tensor:
        """GAE over a [T, E, ...] rollout, flattened time-major, traded for
        the learner's reply; the reply's state goes into :attr:`agent`."""
        returns, advantages = gae(data["rewards"], data["values"], data["dones"], next_values,
                                  self.rollout_steps, self.gamma, self.gae_lambda)
        flat = {k: v.reshape(-1, *v.shape[2:]) for k, v in data.items()}
        flat["returns"] = returns.reshape(-1, 1)
        flat["advantages"] = advantages.reshape(-1, 1)
        params, _, losses = self.channel.exchange(flat, clip_coef, ent_coef, False)
        self.agent.load_state_dict(params)
        return losses

    def optimizer_state(self) -> Dict[str, Any]:
        """The learner's optimizer state, asked for with a message that
        carries no block."""
        return self.channel.exchange(None, 0.0, 0.0, True)[1]

    def close(self) -> None:
        return self.channel.close()

    def abort(self) -> None:
        self.channel.abort()


def main(fabric, cfg: Dict[str, Any]) -> Dict[str, Any]:
    if distributed.process_index() >= 1:  # the learner process of a two-process run
        return serve_learner(cfg, lambda state: build_learner(fabric, cfg, state))
    return run_player(lambda make_trainer: run_on_policy(fabric, cfg, "ppo", make_trainer), ChannelTrainer, cfg)

"""PPO, coupled training (port of ``sheeprl_tpu/algos/ppo/ppo.py``).

:class:`PPOTrainer` is ``make_train_phase``: GAE over the rollout, the
rollout flattened env-major, then ``update_epochs`` passes over minibatches in
the order of one permutation per epoch (the last minibatch wraps into the
permutation, so every row is visited), each a clipped-gradient optimizer
step. The permutations are an argument, as the JAX program's are a key's.

:func:`main` is the training loop. The train phase runs on the fabric's
device. Acting runs on the host, as the JAX package's ``ActPlacement`` places
it by design: a host copy of the agent steps the envs one vector step at a
time, and the train phase's weights are copied into it once per phase (on a
CPU fabric it is the agent itself). This is the act path, not a fallback:
per-step launches on the card would cost more than the forward itself.
"""

from __future__ import annotations

import copy
import os
import time
import warnings
from typing import Any, Dict, List, Optional, Sequence

import numpy as np
import torch

from sheeprl_tpu_torch.algos.ppo.agent import PPOAgent, build_agent, draw_policy_noise, policy_output
from sheeprl_tpu_torch.algos.ppo.loss import entropy_loss, policy_loss, value_loss
from sheeprl_tpu_torch.algos.ppo.utils import normalize_obs, prepare_obs, test
from sheeprl_tpu_torch.config import instantiate
from sheeprl_tpu_torch.optim import clip_grad_global_norm_, linear_schedule, set_scheduled_lr
from sheeprl_tpu_torch.utils.timer import timer
from sheeprl_tpu_torch.utils.utils import gae, normalize_tensor, polynomial_decay, save_configs, sync_actor

Batch = Dict[str, torch.Tensor]


def build_optimizer(cfg, agent: PPOAgent, total_iters: int, updates_per_iter: Optional[int] = None):
    """The optimizer of ``algo.optimizer`` over the agent's parameters, and the
    learning-rate schedule ``anneal_lr`` asks for (None otherwise): linear to 0
    over every update of the run, ``total_iters * updates_per_iter`` (PPO's
    ``update_epochs`` x floor(rows / batch) updates an iteration by default,
    as the JAX loop counts them)."""
    if updates_per_iter is None:
        num_minibatches = max(1, (cfg.algo.rollout_steps * cfg.env.num_envs) // cfg.algo.per_rank_batch_size)
        updates_per_iter = cfg.algo.update_epochs * num_minibatches
    optimizer = instantiate(cfg.algo.optimizer, agent.parameters())
    schedule = None
    if cfg.algo.get("anneal_lr", False):
        schedule = linear_schedule(float(cfg.algo.optimizer.lr), 0.0, total_iters * updates_per_iter)
    return optimizer, schedule


def apply_update(optimizer: torch.optim.Optimizer, params: Sequence[torch.nn.Parameter], grads: Sequence[torch.Tensor],
                 max_grad_norm: float, schedule=None) -> None:
    """One optimizer update from ``grads`` (in parameter order): the global
    norm clip (when ``max_grad_norm`` > 0), the scheduled learning rate, the
    step."""
    for p, g in zip(params, grads):
        p.grad = g
    if max_grad_norm > 0:
        clip_grad_global_norm_(params, max_grad_norm)
    if schedule is not None:
        set_scheduled_lr(optimizer, schedule)
    optimizer.step()
    for p in params:
        p.grad = None


class PPOTrainer:
    """Owns the agent's optimizer and takes train phases."""

    def __init__(self, agent: PPOAgent, optimizer: torch.optim.Optimizer, cfg, schedule=None):
        self.agent = agent
        self.optimizer = optimizer
        self.schedule = schedule
        self.params = list(agent.parameters())
        self.device = self.params[0].device
        self.cnn_keys = tuple(cfg.algo.cnn_keys.encoder)
        self.obs_keys = tuple(cfg.algo.cnn_keys.encoder) + tuple(cfg.algo.mlp_keys.encoder)
        self.rollout_steps = int(cfg.algo.rollout_steps)
        self.num_rows = int(cfg.algo.rollout_steps * cfg.env.num_envs)
        self.batch_size = min(int(cfg.algo.per_rank_batch_size), self.num_rows)
        self.num_minibatches = -(-self.num_rows // self.batch_size)
        self.update_epochs = int(cfg.algo.update_epochs)
        self.gamma = float(cfg.algo.gamma)
        self.gae_lambda = float(cfg.algo.gae_lambda)
        self.vf_coef = float(cfg.algo.vf_coef)
        self.clip_vloss = bool(cfg.algo.clip_vloss)
        self.normalize_advantages = bool(cfg.algo.normalize_advantages)
        self.loss_reduction = str(cfg.algo.loss_reduction)
        self.max_grad_norm = float(cfg.algo.max_grad_norm or 0.0)

    def draw_permutations(self, generator: Optional[torch.Generator]) -> List[torch.Tensor]:
        """One row order per epoch."""
        return [torch.randperm(self.num_rows, generator=generator) for _ in range(self.update_epochs)]

    def loss(self, batch: Batch, clip_coef: float, ent_coef: float):
        agent = self.agent
        actor_outs, new_values = agent(normalize_obs(batch, self.cnn_keys, self.obs_keys))
        out = policy_output(actor_outs, new_values, agent.actions_dim, agent.is_continuous, actions=batch["actions"])
        advantages = batch["advantages"]
        if self.normalize_advantages:
            advantages = normalize_tensor(advantages)
        pg = policy_loss(out["logprob"], batch["logprobs"], advantages, clip_coef, self.loss_reduction)
        vl = value_loss(out["values"], batch["values"], batch["returns"], clip_coef, self.clip_vloss, self.loss_reduction)
        ent = entropy_loss(out["entropy"], self.loss_reduction)
        return pg + self.vf_coef * vl + ent_coef * ent, (pg, vl, ent)

    def step(self, loss: torch.Tensor) -> None:
        self.apply(torch.autograd.grad(loss, self.params))

    def optimizer_state(self) -> Dict[str, Any]:
        return self.optimizer.state_dict()

    def apply(self, grads: Sequence[torch.Tensor]) -> None:
        apply_update(self.optimizer, self.params, grads, self.max_grad_norm, self.schedule)

    def train_phase(
        self, data: Batch, next_values: torch.Tensor, perms: Sequence[torch.Tensor], clip_coef: float, ent_coef: float
    ) -> torch.Tensor:
        """One train phase over a [T, E, ...] rollout on the trainer's device:
        GAE, then ``update_epochs`` x minibatches. Returns the mean policy,
        value and entropy losses, [3], on the device."""
        returns, advantages = gae(
            data["rewards"], data["values"], data["dones"], next_values,
            self.rollout_steps, self.gamma, self.gae_lambda,
        )
        # env-major, as the JAX program flattens its env-sharded rollout
        flat = {k: v.transpose(0, 1).reshape(-1, *v.shape[2:]) for k, v in data.items()}
        flat["returns"] = returns.transpose(0, 1).reshape(-1, 1)
        flat["advantages"] = advantages.transpose(0, 1).reshape(-1, 1)
        return self.train_rows(flat, perms, clip_coef, ent_coef)

    def train_rows(self, flat: Batch, perms: Sequence[torch.Tensor], clip_coef: float, ent_coef: float) -> torch.Tensor:
        """The epochs over ``num_rows`` flat rows (the returns and advantages
        among them): one permutation per epoch, each cut into minibatches.
        Returns the mean policy, value and entropy losses, [3], on the device."""
        pad = self.num_minibatches * self.batch_size - self.num_rows
        losses = []
        for perm in perms:
            perm = perm.to(self.device)
            if pad > 0:
                perm = torch.cat([perm, perm[:pad]])
            for idx in perm.reshape(self.num_minibatches, self.batch_size):
                batch = {k: v[idx] for k, v in flat.items()}
                loss, parts = self.loss(batch, clip_coef, ent_coef)
                self.step(loss)
                losses.append(torch.stack([p.detach() for p in parts]))
        return torch.stack(losses).mean(dim=0)


def to_device(arrays: Dict[str, np.ndarray], device) -> Batch:
    """Host arrays as float32 tensors on ``device``, copied in their stored
    dtype (uint8 frames stay a quarter of the bytes) and cast there."""
    return {k: torch.as_tensor(np.asarray(v)).to(device).float() for k, v in arrays.items()}


def run_on_policy(fabric, cfg: Dict[str, Any], algo: str, make_trainer=None) -> Dict[str, Any]:
    """The PPO (``algo="ppo"``) and A2C (``"a2c"``) training loop: rollouts of
    ``rollout_steps`` vector steps acted on the host, then one train phase on
    the device. ``make_trainer(agent, cfg, total_iters)`` builds PPO's trainer
    in place of :class:`PPOTrainer`, as the decoupled topology's
    ``run_player`` does: its ``agent`` is the one the loop acts with,
    checkpoints and tests. Returns a summary of the run."""
    from sheeprl_tpu_torch.envs import spaces
    from sheeprl_tpu_torch.envs.spaces import action_space_dims, env_actions
    from sheeprl_tpu_torch.envs.vector import SyncVectorEnv, episode_stats
    from sheeprl_tpu_torch.data.buffers import ReplayBuffer
    from sheeprl_tpu_torch.interop.flax_to_torch import ppo_to_flax, ppo_to_torch
    from sheeprl_tpu_torch.interop.optax_to_torch import load_optimizer_state
    from sheeprl_tpu_torch.resilience import signals
    from sheeprl_tpu_torch.utils.checkpoint import load_checkpoint, save_run_checkpoint
    from sheeprl_tpu_torch.utils.env import make_env
    from sheeprl_tpu_torch.utils.logger import get_log_dir, get_logger
    from sheeprl_tpu_torch.utils.metric import MetricAggregator

    t_start = time.perf_counter()
    is_ppo = algo == "ppo"
    initial_ent_coef = float(cfg.algo.get("ent_coef", 0.0))
    initial_clip_coef = float(cfg.algo.get("clip_coef", 0.0))
    device = fabric.device
    state = load_checkpoint(cfg.checkpoint.resume_from) if cfg.checkpoint.resume_from else None

    log_dir = get_log_dir(cfg)
    logger = get_logger(cfg, log_dir)
    print(f"Log dir: {log_dir}", flush=True)

    num_envs = int(cfg.env.num_envs)
    envs = SyncVectorEnv(
        [make_env(cfg, cfg.seed + i, 0, log_dir, "train", vector_env_idx=i) for i in range(num_envs)]
    )
    observation_space = envs.single_observation_space
    if not isinstance(observation_space, spaces.Dict):
        raise RuntimeError(f"Unexpected observation type, should be of type Dict, got: {observation_space}")
    if is_ppo and cfg.algo.cnn_keys.encoder + cfg.algo.mlp_keys.encoder == []:
        raise RuntimeError(
            "You should specify at least one CNN or MLP key for the encoder: "
            "`algo.cnn_keys.encoder=[rgb]` or `algo.mlp_keys.encoder=[state]`"
        )
    if not is_ppo:
        if len(cfg.algo.mlp_keys.encoder) == 0:
            raise RuntimeError("You should specify at least one MLP key for the encoder: `algo.mlp_keys.encoder=[state]`")
        for k in cfg.algo.mlp_keys.encoder:
            if len(observation_space[k].shape) > 1:
                raise ValueError(
                    "Only environments with vector-only observations are supported by the A2C agent. "
                    f"The observation with key '{k}' has shape {observation_space[k].shape}"
                )
        cfg.algo.cnn_keys.encoder = []
    cnn_keys = list(cfg.algo.cnn_keys.encoder)
    obs_keys = cnn_keys + list(cfg.algo.mlp_keys.encoder)
    actions_dim, is_continuous = action_space_dims(envs.single_action_space)
    action_shape = envs.action_space.shape if is_continuous else (num_envs, -1) if len(actions_dim) > 1 else (num_envs,)

    fabric.seed_everything(cfg.seed)
    agent = build_agent(
        fabric, actions_dim, is_continuous, cfg, observation_space, cfg.seed, state["agent"] if state else None
    )

    start_iter = state["iter_num"] + 1 if state is not None else 1
    policy_step = state["iter_num"] * num_envs * cfg.algo.rollout_steps if state is not None else 0
    last_log = state["last_log"] if state is not None else 0
    last_checkpoint = state["last_checkpoint"] if state is not None else 0
    policy_steps_per_iter = int(num_envs * cfg.algo.rollout_steps)
    total_iters = cfg.algo.total_steps // policy_steps_per_iter if not cfg.dry_run else 1
    if state is not None:
        cfg.algo.per_rank_batch_size = state["batch_size"]

    if make_trainer is not None:
        trainer = make_trainer(agent, cfg, total_iters)
    elif is_ppo:
        optimizer, schedule = build_optimizer(cfg, agent, total_iters)
        trainer = PPOTrainer(agent, optimizer, cfg, schedule)
    else:
        from sheeprl_tpu_torch.algos.a2c.a2c import A2CTrainer

        trainer = A2CTrainer(agent, instantiate(cfg.algo.optimizer, agent.parameters()), cfg)
    # a decoupled run's learner process loads its own (its player's trainer has no optimizer)
    if state is not None and "optimizer" in state and trainer.optimizer is not None:
        load_optimizer_state(trainer.optimizer, state["optimizer"], ppo_to_torch(agent))
    save_configs(cfg, log_dir)

    aggregator = None if MetricAggregator.disabled else instantiate(cfg.metric.aggregator)

    if cfg.buffer.size < cfg.algo.rollout_steps:
        raise ValueError(
            f"The size of the buffer ({cfg.buffer.size}) cannot be lower than the rollout steps ({cfg.algo.rollout_steps})"
        )
    rb = ReplayBuffer(
        cfg.buffer.size,
        num_envs,
        memmap=cfg.buffer.memmap,
        memmap_dir=os.path.join(log_dir, "memmap_buffer", "rank_0"),
        obs_keys=obs_keys,
    )
    if cfg.metric.log_level > 0 and cfg.metric.log_every % policy_steps_per_iter != 0:
        warnings.warn(
            f"The metric.log_every parameter ({cfg.metric.log_every}) is not a multiple of the "
            f"policy_steps_per_iter value ({policy_steps_per_iter})."
        )
    if cfg.checkpoint.every % policy_steps_per_iter != 0:
        warnings.warn(
            f"The checkpoint.every parameter ({cfg.checkpoint.every}) is not a multiple of the "
            f"policy_steps_per_iter value ({policy_steps_per_iter})."
        )

    # from here on the agent is the trainer's (the decoupled player's own copy,
    # on the host); the acting agent a host copy of it (see the module docstring)
    agent = trainer.agent
    act_agent = agent if next(agent.parameters()).device.type == "cpu" else copy.deepcopy(agent).to("cpu")
    act_generator = torch.Generator().manual_seed(int(cfg.seed))
    train_generator = torch.Generator().manual_seed(int(cfg.seed) + 1)

    ent_coef, clip_coef = initial_ent_coef, initial_clip_coef
    step_data: Dict[str, np.ndarray] = {}
    next_obs = envs.reset(seed=cfg.seed)[0]
    for k in obs_keys:
        step_data[k] = next_obs[k][np.newaxis]

    env_seconds = train_seconds = 0.0
    train_phases = 0
    losses = None
    ckpt_path = None
    iter_num = start_iter - 1
    preempted = False
    for iter_num in range(start_iter, total_iters + 1):
        t0 = time.perf_counter()
        with timer("Time/env_interaction_time"), torch.no_grad():
            for _ in range(cfg.algo.rollout_steps):
                policy_step += num_envs
                obs_in = {k: next_obs[k] for k in obs_keys}
                actor_outs, values = act_agent(prepare_obs(obs_in, cnn_keys=cnn_keys, num_envs=num_envs))
                noise = draw_policy_noise(actions_dim, is_continuous, num_envs, act_generator, "cpu")
                out = policy_output(actor_outs, values, actions_dim, is_continuous, noise=noise)
                actions = out["actions"].numpy()
                obs, rewards, terminated, truncated, info = envs.step(
                    env_actions(actions, actions_dim, is_continuous).reshape(action_shape)
                )
                dones = np.logical_or(terminated, truncated).reshape(num_envs, 1).astype(np.float32)
                rewards = np.asarray(rewards, dtype=np.float32).reshape(num_envs, 1)

                # truncation bootstrap: a truncated episode's reward gains
                # gamma * V(its last observation)
                truncated_envs = np.nonzero(truncated)[0]
                if len(truncated_envs) > 0 and info.get("final_obs") is not None:
                    final_obs = {
                        k: np.stack([np.asarray(info["final_obs"][i][k]) for i in truncated_envs]) for k in obs_keys
                    }
                    vals = act_agent.get_values(
                        prepare_obs(final_obs, cnn_keys=cnn_keys, num_envs=len(truncated_envs))
                    )
                    rewards[truncated_envs] += cfg.algo.gamma * vals.numpy().reshape(-1, 1)

                step_data["dones"] = dones[np.newaxis]
                step_data["values"] = out["values"].numpy()[np.newaxis]
                step_data["actions"] = actions.astype(np.float32)[np.newaxis]
                if is_ppo:
                    step_data["logprobs"] = out["logprob"].numpy()[np.newaxis]
                step_data["rewards"] = rewards[np.newaxis]
                if cfg.buffer.memmap:
                    step_data["returns"] = np.zeros_like(rewards)[np.newaxis]
                    step_data["advantages"] = np.zeros_like(rewards)[np.newaxis]
                rb.add(step_data, validate_args=cfg.buffer.validate_args)

                next_obs = obs
                for k in obs_keys:
                    step_data[k] = obs[k][np.newaxis]

                rews, lens = episode_stats(info, num_envs)
                if len(rews) > 0 and aggregator is not None:
                    aggregator.update("Rewards/rew_avg", float(np.mean(rews)))
                    aggregator.update("Game/ep_len_avg", float(np.mean(lens)))

            # bootstrap value for the last step
            obs_in = {k: next_obs[k] for k in obs_keys}
            next_values = act_agent.get_values(prepare_obs(obs_in, cnn_keys=cnn_keys, num_envs=num_envs)).numpy()
        env_seconds += time.perf_counter() - t0

        t0 = time.perf_counter()
        with timer("Time/train_time"):
            data = to_device({k: rb[k] for k in rb.buffer.keys() if k not in ("returns", "advantages")}, device)
            next_values_t = torch.as_tensor(next_values).to(device)
            if is_ppo:
                perms = trainer.draw_permutations(train_generator)
                losses = trainer.train_phase(data, next_values_t, perms, clip_coef, ent_coef)
            else:
                losses = trainer.train_phase(data, next_values_t)
            # the copy to the host waits for the phase: the timer ends there
            sync_actor(act_agent, agent)
            train_phases += 1
            if aggregator is not None:
                aggregator.update("Loss/policy_loss", losses[0])
                aggregator.update("Loss/value_loss", losses[1])
                if is_ppo:
                    aggregator.update("Loss/entropy_loss", losses[2])
        train_seconds += time.perf_counter() - t0

        if cfg.metric.log_level > 0 and (
            policy_step - last_log >= cfg.metric.log_every or iter_num == total_iters or cfg.dry_run
        ):
            with timer("Time/logging_time"):
                metrics_dict = aggregator.compute() if aggregator else {}
                if logger is not None:
                    logger.log_metrics(metrics_dict, policy_step)
                    timers = timer.to_dict(reset=False)
                    if timers.get("Time/train_time", 0) > 0:
                        logger.log_metrics(
                            {"Time/sps_train": (policy_step - last_log) / max(timers["Time/train_time"], 1e-9)},
                            policy_step,
                        )
                    if timers.get("Time/env_interaction_time", 0) > 0:
                        logger.log_metrics(
                            {
                                "Time/sps_env_interaction": (policy_step - last_log)
                                / max(timers["Time/env_interaction_time"], 1e-9)
                            },
                            policy_step,
                        )
                timer.to_dict(reset=True)
                if aggregator:
                    aggregator.reset()
            last_log = policy_step

        if is_ppo and cfg.algo.anneal_clip_coef:
            clip_coef = polynomial_decay(
                iter_num, initial=initial_clip_coef, final=0.0, max_decay_steps=total_iters, power=1.0
            )
        if is_ppo and cfg.algo.anneal_ent_coef:
            ent_coef = polynomial_decay(
                iter_num, initial=initial_ent_coef, final=0.0, max_decay_steps=total_iters, power=1.0
            )

        preempted = signals.preemption_requested()
        if (
            (cfg.checkpoint.every > 0 and policy_step - last_checkpoint >= cfg.checkpoint.every)
            or cfg.dry_run
            or (iter_num == total_iters and cfg.checkpoint.save_last)
            or preempted
        ):
            last_checkpoint = policy_step
            ckpt_state = {
                "agent": ppo_to_flax(agent),
                "optimizer": trainer.optimizer_state(),
                "iter_num": iter_num,
                "batch_size": cfg.algo.per_rank_batch_size,
                "last_log": last_log,
                "last_checkpoint": last_checkpoint,
            }
            ckpt_path = os.path.join(log_dir, "checkpoint", f"ckpt_{policy_step}_0.ckpt")
            with timer("Time/checkpoint_time"):
                save_run_checkpoint(ckpt_path, ckpt_state, keep_last=int(cfg.checkpoint.get("keep_last") or 0))
        if preempted:
            break

    envs.close()
    test_reward = None
    if not preempted and cfg.algo.run_test:
        with timer("Time/test_time"):
            test_reward = test(agent, cfg, log_dir, logger)
    if logger is not None:
        logger.finalize()
    names = ["Loss/policy_loss", "Loss/value_loss", "Loss/entropy_loss"][: 3 if is_ppo else 2]
    return {
        "log_dir": log_dir,
        "policy_steps": policy_step,
        "iterations": iter_num - start_iter + 1,
        "train_phases": train_phases,
        "env_seconds": env_seconds,
        "train_seconds": train_seconds,
        "wall_seconds": time.perf_counter() - t_start,
        "metrics": dict(zip(names, losses.cpu().tolist())) if losses is not None else {},
        "test_reward": test_reward,
        "checkpoint": ckpt_path,
        "preempted": preempted,
    }


def main(fabric, cfg: Dict[str, Any]) -> Dict[str, Any]:
    return run_on_policy(fabric, cfg, "ppo")

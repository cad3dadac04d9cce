"""Recurrent PPO, coupled training (port of
``sheeprl_tpu/algos/ppo_recurrent/ppo_recurrent.py``).

:func:`main` is the JAX loop. Acting runs on the host, as the JAX package's
``ActPlacement`` places it (and as ``algos/ppo/ppo.py`` does): a host copy of
the agent steps the envs one vector step at a time, feeding each env its
previous action and its ``(hx, cx)``; the weights of the train phase are
copied into it once per phase. After a rollout, GAE runs on the host, and
:func:`chunk_sequences` cuts every env's rollout into episodes at its dones,
then into pieces of ``per_rank_sequence_length``, and pads them into one
``[sl, N, ...]`` block with a mask, N rounded up to a power of two.

:class:`RecurrentPPOTrainer` is the JAX ``train_phase`` program: for each
epoch one permutation of the padded N (an argument, as the JAX program's are
a key's), minibatches of ``N // per_rank_num_batches`` sequences (the
remainder dropped), each a masked unroll of the LSTM from the sequence's
first recurrent state and one clipped Adam update. Every loss term is a mean
over the mask, whatever ``loss_reduction`` says. A minibatch drawn entirely
from padding makes no update: Adam's moments and count and the learning-rate
schedule stay, as the JAX program keeps its old optimizer state there. The
trainer tells such a minibatch from the host's copy of the mask, without
reading the device.
"""

from __future__ import annotations

import copy
import os
import time
from typing import Any, Dict, List, Optional, Sequence

import numpy as np
import torch

from sheeprl_tpu_torch.algos.ppo.agent import draw_policy_noise, policy_output
from sheeprl_tpu_torch.algos.ppo.ppo import PPOTrainer
from sheeprl_tpu_torch.algos.ppo_recurrent.agent import RecurrentPPOAgent, build_agent
from sheeprl_tpu_torch.algos.ppo_recurrent.utils import normalize_obs, sequence_obs, test
from sheeprl_tpu_torch.config import instantiate
from sheeprl_tpu_torch.optim import linear_schedule
from sheeprl_tpu_torch.resilience.faults import apply_armed_learn_fault
from sheeprl_tpu_torch.utils.timer import timer
from sheeprl_tpu_torch.utils.utils import gae, normalize_tensor, polynomial_decay, save_configs, sync_actor

Batch = Dict[str, torch.Tensor]


def next_pow2(n: int) -> int:
    p = 1
    while p < n:
        p *= 2
    return p


def masked_mean(x: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    return torch.sum(x * mask) / torch.clamp(torch.sum(mask), min=1.0)


def chunk_sequences(data: Dict[str, np.ndarray], sl: int, num_batches: int) -> Dict[str, np.ndarray]:
    """The padded ``[sl, N, ...]`` block of a ``[T, E, ...]`` rollout (with its
    ``returns`` and ``advantages``): each env's steps split into episodes after
    every done, each episode into pieces of ``sl`` steps, in env order; N is
    ``next_pow2(max(pieces, num_batches))``, padding zero. ``dones`` and
    ``rewards`` are left out, ``prev_hx`` and ``prev_cx`` keep only their first
    step ``[1, N, H]``, and ``mask [sl, N, 1]`` is 1 on the real steps."""
    T, E = data["dones"].shape[:2]
    # dones and rewards are folded into the returns and advantages already
    pieces: Dict[str, List[np.ndarray]] = {k: [] for k in data if k not in ("dones", "rewards")}
    lengths: List[int] = []
    for env_id in range(E):
        ends = data["dones"][:, env_id, 0].nonzero()[0].tolist() + [T - 1]
        start = 0
        for stop in ends:
            if stop + 1 <= start:
                continue
            for k in pieces:
                episode = data[k][start : stop + 1, env_id]
                pieces[k].extend(episode[s0 : s0 + sl] for s0 in range(0, episode.shape[0], sl))
            length = stop + 1 - start
            lengths.extend(min(sl, length - s0) for s0 in range(0, length, sl))
            start = stop + 1
    n_pad = next_pow2(max(len(lengths), num_batches))
    seqs: Dict[str, np.ndarray] = {}
    for k, chunks in pieces.items():
        arr = np.zeros((sl, n_pad, *chunks[0].shape[1:]), np.float32)
        for j, c in enumerate(chunks):
            arr[: c.shape[0], j] = c
        seqs[k] = arr[:1] if k in ("prev_hx", "prev_cx") else arr
    mask = np.zeros((sl, n_pad, 1), np.float32)
    for j, length in enumerate(lengths):
        mask[:length, j] = 1.0
    seqs["mask"] = mask
    return seqs


def build_optimizer(cfg, agent: RecurrentPPOAgent, total_iters: int):
    """The optimizer of ``algo.optimizer`` over the agent's parameters, and the
    schedule ``anneal_lr`` asks for (None otherwise): linear to 0 over
    ``total_iters * update_epochs * per_rank_num_batches`` updates, the JAX
    loop's span."""
    optimizer = instantiate(cfg.algo.optimizer, agent.parameters())
    schedule = None
    if cfg.algo.anneal_lr:
        steps = total_iters * cfg.algo.update_epochs * max(1, cfg.algo.per_rank_num_batches)
        schedule = linear_schedule(float(cfg.algo.optimizer.lr), 0.0, steps)
    return optimizer, schedule


class RecurrentPPOTrainer:
    """Owns the agent's optimizer and takes train phases."""

    def __init__(self, agent: RecurrentPPOAgent, optimizer: torch.optim.Optimizer, cfg, schedule=None):
        self.agent = agent
        self.optimizer = optimizer
        self.schedule = schedule
        self.params = list(agent.parameters())
        self.device = self.params[0].device
        self.cnn_keys = tuple(cfg.algo.cnn_keys.encoder)
        self.obs_keys = tuple(cfg.algo.cnn_keys.encoder) + tuple(cfg.algo.mlp_keys.encoder)
        self.num_batches = max(1, int(cfg.algo.per_rank_num_batches))
        self.update_epochs = int(cfg.algo.update_epochs)
        self.vf_coef = float(cfg.algo.vf_coef)
        self.clip_vloss = bool(cfg.algo.clip_vloss)
        self.normalize_advantages = bool(cfg.algo.normalize_advantages)
        self.max_grad_norm = float(cfg.algo.max_grad_norm or 0.0)

    def draw_permutations(self, n: int, generator: Optional[torch.Generator]) -> List[torch.Tensor]:
        """One order of the ``n`` padded sequences per epoch."""
        return [torch.randperm(n, generator=generator) for _ in range(self.update_epochs)]

    def loss(self, batch: Batch, clip_coef: float, ent_coef: float):
        agent, mask = self.agent, batch["mask"]
        actor_outs, values, _ = agent(
            normalize_obs(batch, self.cnn_keys, self.obs_keys), batch["prev_actions"],
            batch["prev_hx"][0], batch["prev_cx"][0], mask=mask,
        )
        out = policy_output(actor_outs, values, agent.actions_dim, agent.is_continuous, actions=batch["actions"])
        advantages = batch["advantages"]
        if self.normalize_advantages:
            advantages = normalize_tensor(advantages, mask=mask)
        ratio = torch.exp(out["logprob"] - batch["logprobs"])
        pg1 = -advantages * ratio
        pg2 = -advantages * torch.clamp(ratio, 1 - clip_coef, 1 + clip_coef)
        pg = masked_mean(torch.maximum(pg1, pg2), mask)
        if self.clip_vloss:
            v_pred = batch["values"] + torch.clamp(out["values"] - batch["values"], -clip_coef, clip_coef)
        else:
            v_pred = out["values"]
        vl = masked_mean(torch.square(v_pred - batch["returns"]), mask)
        ent = -masked_mean(out["entropy"], mask)
        return pg + self.vf_coef * vl + ent_coef * ent, (pg, vl, ent)

    # one update from gradients in parameter order: the global norm clip, the
    # scheduled learning rate, the step (the optax chain of both JAX loops)
    apply = PPOTrainer.apply

    def train_phase(
        self, seqs: Dict[str, np.ndarray], perms: Sequence[torch.Tensor], clip_coef: float, ent_coef: float
    ) -> torch.Tensor:
        """One train phase over the host block of :func:`chunk_sequences` on
        the trainer's device. Returns the mean policy, value and entropy
        losses, [3], on the device (a skipped minibatch's are 0, as the JAX
        program's masked means give)."""
        apply_armed_learn_fault(self.agent)  # resilience.fault=lr_spike: identity unless armed
        n = seqs["mask"].shape[1]
        bs = max(1, n // self.num_batches)
        nmb = n // bs
        real = seqs["mask"].sum(axis=(0, 2)) > 0
        data = {k: torch.from_numpy(v).to(self.device) for k, v in seqs.items()}
        zeros = torch.zeros(3, device=self.device)
        epochs = []
        for perm in perms:
            order = perm[: nmb * bs].reshape(nmb, bs)
            order_dev = order.to(self.device)
            losses = []
            for j in range(nmb):
                if not real[order[j].numpy()].any():
                    losses.append(zeros)
                    continue
                batch = {k: v[:, order_dev[j]] for k, v in data.items()}
                loss, parts = self.loss(batch, clip_coef, ent_coef)
                self.apply(torch.autograd.grad(loss, self.params))
                losses.append(torch.stack([p.detach() for p in parts]))
            epochs.append(torch.stack(losses).mean(dim=0))
        return torch.stack(epochs).mean(dim=0)


def main(fabric, cfg: Dict[str, Any]) -> Dict[str, Any]:
    """The training loop: rollouts of ``rollout_steps`` vector steps acted on
    the host, GAE and the chunking on the host, then one train phase on the
    device. Returns a summary of the run."""
    from sheeprl_tpu_torch.data.buffers import ReplayBuffer
    from sheeprl_tpu_torch.envs import spaces
    from sheeprl_tpu_torch.envs.spaces import action_space_dims, env_actions
    from sheeprl_tpu_torch.envs.vector import SyncVectorEnv, episode_stats
    from sheeprl_tpu_torch.interop.flax_to_torch import ppo_recurrent_to_flax, ppo_recurrent_to_torch
    from sheeprl_tpu_torch.interop.optax_to_torch import load_optimizer_state
    from sheeprl_tpu_torch.resilience.monitor import build_resilience
    from sheeprl_tpu_torch.utils.checkpoint import load_checkpoint, write_run_checkpoint
    from sheeprl_tpu_torch.utils.env import make_env
    from sheeprl_tpu_torch.utils.logger import get_log_dir, get_logger
    from sheeprl_tpu_torch.utils.metric import MetricAggregator

    t_start = time.perf_counter()
    initial_ent_coef = float(cfg.algo.ent_coef)
    initial_clip_coef = float(cfg.algo.clip_coef)
    device = fabric.device
    state = load_checkpoint(cfg.checkpoint.resume_from) if cfg.checkpoint.resume_from else None

    if cfg.algo.rollout_steps % cfg.algo.per_rank_sequence_length != 0:
        raise ValueError(
            f"rollout_steps ({cfg.algo.rollout_steps}) must be a multiple of "
            f"per_rank_sequence_length ({cfg.algo.per_rank_sequence_length})"
        )

    log_dir = get_log_dir(cfg)
    logger = get_logger(cfg, log_dir)
    print(f"Log dir: {log_dir}", flush=True)
    resilience = build_resilience(cfg, log_dir)

    num_envs = int(cfg.env.num_envs)
    envs = SyncVectorEnv(
        [make_env(cfg, cfg.seed + i, 0, log_dir, "train", vector_env_idx=i) for i in range(num_envs)]
    )
    observation_space = envs.single_observation_space
    if not isinstance(observation_space, spaces.Dict):
        raise RuntimeError(f"Unexpected observation type, should be of type Dict, got: {observation_space}")
    if cfg.algo.cnn_keys.encoder + cfg.algo.mlp_keys.encoder == []:
        raise RuntimeError(
            "You should specify at least one CNN or MLP key for the encoder: "
            "`algo.cnn_keys.encoder=[rgb]` or `algo.mlp_keys.encoder=[state]`"
        )
    cnn_keys = list(cfg.algo.cnn_keys.encoder)
    obs_keys = cnn_keys + list(cfg.algo.mlp_keys.encoder)
    actions_dim, is_continuous = action_space_dims(envs.single_action_space)
    act_dim = int(np.sum(actions_dim))
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

    optimizer, schedule = build_optimizer(cfg, agent, total_iters)
    trainer = RecurrentPPOTrainer(agent, optimizer, cfg, schedule)
    if state is not None and "optimizer" in state:
        load_optimizer_state(optimizer, state["optimizer"], ppo_recurrent_to_torch(agent))
    save_configs(cfg, log_dir)

    aggregator = None if MetricAggregator.disabled else instantiate(cfg.metric.aggregator)
    rb = ReplayBuffer(
        cfg.algo.rollout_steps,
        num_envs,
        memmap=cfg.buffer.memmap,
        memmap_dir=os.path.join(log_dir, "memmap_buffer", "rank_0"),
        obs_keys=obs_keys,
    )
    sl = int(cfg.algo.per_rank_sequence_length)
    num_batches = max(1, int(cfg.algo.per_rank_num_batches))

    # the acting agent: a host copy (see the module docstring)
    act_agent = agent if device.type == "cpu" else copy.deepcopy(agent).to("cpu")
    act_generator = torch.Generator().manual_seed(int(cfg.seed))
    train_generator = torch.Generator().manual_seed(int(cfg.seed) + 1)

    ent_coef, clip_coef = initial_ent_coef, initial_clip_coef
    step_data: Dict[str, np.ndarray] = {}
    next_obs = envs.reset(seed=cfg.seed)[0]
    for k in obs_keys:
        step_data[k] = next_obs[k][np.newaxis]
    prev_actions = torch.zeros(num_envs, act_dim)
    hx, cx = act_agent.initial_states(num_envs)

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
                prev_hx, prev_cx = hx, cx
                actor_outs, values, (hx, cx) = act_agent(
                    sequence_obs(next_obs, obs_keys, cnn_keys), prev_actions[None], prev_hx, prev_cx
                )
                noise = draw_policy_noise(actions_dim, is_continuous, num_envs, act_generator, "cpu")
                out = policy_output([o[0] for o in actor_outs], values[0], actions_dim, is_continuous, noise=noise)
                actions = out["actions"]
                obs, rewards, terminated, truncated, info = envs.step(
                    env_actions(actions.numpy(), actions_dim, is_continuous).reshape(action_shape)
                )
                dones = np.logical_or(terminated, truncated).reshape(num_envs, 1).astype(np.float32)
                rewards = np.asarray(rewards, dtype=np.float32).reshape(num_envs, 1)

                # truncation bootstrap with the post-step recurrent state: a
                # truncated episode's reward gains gamma * V(its last observation)
                truncated_envs = np.nonzero(truncated)[0]
                if len(truncated_envs) > 0 and info.get("final_obs") is not None:
                    final_obs = {
                        k: np.stack([np.asarray(info["final_obs"][i][k]) for i in truncated_envs]) for k in obs_keys
                    }
                    rows = torch.from_numpy(truncated_envs)
                    _, vals, _ = act_agent(
                        sequence_obs(final_obs, obs_keys, cnn_keys), actions[rows][None], hx[rows], cx[rows]
                    )
                    rewards[truncated_envs] += cfg.algo.gamma * vals[0].numpy().reshape(-1, 1)

                step_data["dones"] = dones[np.newaxis]
                step_data["values"] = values[0].numpy()[np.newaxis]
                step_data["actions"] = actions.numpy()[np.newaxis]
                step_data["logprobs"] = out["logprob"].numpy()[np.newaxis]
                step_data["rewards"] = rewards[np.newaxis]
                step_data["prev_actions"] = prev_actions.numpy()[np.newaxis]
                step_data["prev_hx"] = prev_hx.numpy()[np.newaxis]
                step_data["prev_cx"] = prev_cx.numpy()[np.newaxis]
                rb.add(step_data, validate_args=cfg.buffer.validate_args)

                not_done = torch.from_numpy(1.0 - dones)
                prev_actions = not_done * actions
                next_obs = obs
                for k in obs_keys:
                    step_data[k] = obs[k][np.newaxis]
                if cfg.algo.reset_recurrent_state_on_done:
                    hx, cx = not_done * hx, not_done * cx

                rews, lens = episode_stats(info, num_envs)
                if len(rews) > 0 and aggregator is not None:
                    aggregator.update("Rewards/rew_avg", float(np.mean(rews)))
                    aggregator.update("Game/ep_len_avg", float(np.mean(lens)))

            # bootstrap value for the last step, then GAE and the chunks on the host
            _, next_values, _ = act_agent(sequence_obs(next_obs, obs_keys, cnn_keys), prev_actions[None], hx, cx)
            local = {k: np.asarray(rb[k], dtype=np.float32) for k in rb.buffer.keys()}
            returns, advantages = gae(
                *(torch.from_numpy(local[k]) for k in ("rewards", "values", "dones")), next_values[0],
                cfg.algo.rollout_steps, cfg.algo.gamma, cfg.algo.gae_lambda,
            )
            local["returns"], local["advantages"] = returns.numpy(), advantages.numpy()
            seqs = chunk_sequences(local, sl, num_batches)
        env_seconds += time.perf_counter() - t0

        t0 = time.perf_counter()
        with timer("Time/train_time"):
            perms = trainer.draw_permutations(seqs["mask"].shape[1], train_generator)
            losses = trainer.train_phase(seqs, perms, clip_coef, ent_coef)
            # the copy to the host waits for the phase: the timer ends there
            sync_actor(act_agent, agent)
            train_phases += 1
            if aggregator is not None:
                aggregator.update("Loss/policy_loss", losses[0])
                aggregator.update("Loss/value_loss", losses[1])
                aggregator.update("Loss/entropy_loss", losses[2])
        train_seconds += time.perf_counter() - t0

        resilience.step(policy_step)
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

        if cfg.algo.anneal_clip_coef:
            clip_coef = polynomial_decay(
                iter_num, initial=initial_clip_coef, final=0.0, max_decay_steps=total_iters, power=1.0
            )
        if cfg.algo.anneal_ent_coef:
            ent_coef = polynomial_decay(
                iter_num, initial=initial_ent_coef, final=0.0, max_decay_steps=total_iters, power=1.0
            )

        preempted = resilience.preempt_requested()
        if (
            (cfg.checkpoint.every > 0 and policy_step - last_checkpoint >= cfg.checkpoint.every)
            or cfg.dry_run
            or (iter_num == total_iters and cfg.checkpoint.save_last)
            or preempted
        ):
            last_checkpoint = policy_step
            ckpt_state = {
                "agent": ppo_recurrent_to_flax(agent),
                "optimizer": optimizer.state_dict(),
                "iter_num": iter_num,
                "batch_size": cfg.algo.per_rank_batch_size if cfg.algo.get("per_rank_batch_size") else 0,
                "last_log": last_log,
                "last_checkpoint": last_checkpoint,
            }
            ckpt_path = os.path.join(log_dir, "checkpoint", f"ckpt_{policy_step}_0.ckpt")
            with timer("Time/checkpoint_time"):
                write_run_checkpoint(ckpt_path, ckpt_state, keep_last=int(cfg.checkpoint.get("keep_last") or 0))
            resilience.observe_checkpoint(ckpt_path, policy_step, preempted=preempted)
        if preempted:
            break

    envs.close()
    test_reward = None
    preempted = resilience.finalize(policy_step)
    if not preempted and cfg.algo.run_test:
        with timer("Time/test_time"):
            test_reward = test(agent, cfg, log_dir, logger)
    if logger is not None:
        logger.finalize()
    names = ["Loss/policy_loss", "Loss/value_loss", "Loss/entropy_loss"]
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

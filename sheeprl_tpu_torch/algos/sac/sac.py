"""SAC, coupled training (port of ``sheeprl_tpu/algos/sac/sac.py``).

:class:`SACTrainer` is ``make_train_body``: over a ``[G, B, ...]`` replay
block, each gradient step runs the critic update, the target EMA, the actor
update and the temperature update, with three Adams (the exp's ``eps`` of
1e-4). The EMA is gated on the iteration, not on the gradient step:
``iter_num % target_period == 0`` with ``target_period =
target_network_frequency // policy_steps_per_iter + 1``. The temperature loss
takes the actor step's log-probs, detached. The standard normal noise of the
two samples a step takes is an argument (:meth:`SACTrainer.draw_noise`), as
the JAX program's is a key's.

:func:`run_off_policy` is the training loop of SAC and DroQ, given the
algorithm's ``build_agent`` and trainer class: ``learning_starts`` prefill
iterations of random actions, then the replay-ratio governor decides how many
gradient steps each iteration takes, and the trainer's ``run_phase`` samples
its replay block on the host (``sample_next_obs=False``: the buffer stores the
real next observations), copies it to the device once and trains on it.
Acting runs on a host copy of the actor, as the JAX package's
``ActPlacement`` places it; the trained weights are copied into it once per
train phase (on a CPU fabric it is the actor itself). Sampling is
synchronous: the prefetch thread is not ported.
"""

from __future__ import annotations

import copy
import os
import time
import warnings
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from sheeprl_tpu_torch.algos.sac.agent import SACAgent, build_agent, squash_and_logprob
from sheeprl_tpu_torch.algos.sac.loss import critic_loss, entropy_loss, policy_loss
from sheeprl_tpu_torch.algos.sac.utils import flat_obs, prepare_obs, test
from sheeprl_tpu_torch.config import instantiate
from sheeprl_tpu_torch.data.prefetch import sample_to_device
from sheeprl_tpu_torch.resilience.faults import apply_armed_learn_fault
from sheeprl_tpu_torch.utils.utils import sync_actor

Batch = Dict[str, torch.Tensor]


def build_optimizers(cfg, agent: SACAgent) -> Dict[str, torch.optim.Optimizer]:
    """The three optimizers: the actor's, the critic's and the temperature's."""
    return {
        "actor": instantiate(cfg.algo.actor.optimizer, agent.actor.parameters()),
        "critic": instantiate(cfg.algo.critic.optimizer, agent.critic.parameters()),
        "alpha": instantiate(cfg.algo.alpha.optimizer, [agent.log_alpha]),
    }


def _step(optimizer: torch.optim.Optimizer, params: List[torch.Tensor], loss: torch.Tensor) -> None:
    for p, g in zip(params, torch.autograd.grad(loss, params)):
        p.grad = g
    optimizer.step()
    for p in params:
        p.grad = None


class SACTrainer:
    """Owns the agent's three optimizers and takes train phases on the agent's
    device. Besides the train phase it holds what ``run_off_policy`` asks of
    an algorithm: the observation checks, the optimizers, the replay rows,
    the acting, the losses' names, the checkpoint's agent and the test."""

    loss_names = ("Loss/value_loss", "Loss/policy_loss", "Loss/alpha_loss")
    build_optimizers = staticmethod(build_optimizers)

    def __init__(self, agent: SACAgent, optimizers: Dict[str, torch.optim.Optimizer], cfg, target_entropy: float,
                 policy_steps_per_iter: int = 1):
        self.agent = agent
        self.optimizers = optimizers
        self.device = agent.log_alpha.device
        self.gamma = float(cfg.algo.gamma)
        self.tau = float(cfg.algo.tau)
        self.num_critics = int(cfg.algo.critic.n)
        self.target_entropy = float(target_entropy)
        self.target_period = int(cfg.algo.critic.target_network_frequency) // int(policy_steps_per_iter) + 1
        self.act_dim = int(agent.actor.fc_mean.out_features)
        self.actor_params = list(agent.actor.parameters())
        self.critic_params = list(agent.critic.parameters())
        self.target_params = list(agent.target_critic.parameters())

    def draw_noise(self, G: int, batch_size: int, generator: Optional[torch.Generator]) -> Batch:
        """Standard normal noise for G steps: the next actions' sample in the
        critic update (``critic``) and the actions' in the actor update
        (``actor``), each ``[G, B, act_dim]``."""
        size = (G, batch_size, self.act_dim)
        return {
            "critic": torch.randn(size, generator=generator, device=self.device),
            "actor": torch.randn(size, generator=generator, device=self.device),
        }

    def critic_step(self, batch: Batch, eps: torch.Tensor, keep_target=None, keep_online=None) -> torch.Tensor:
        """One critic update against the soft target; ``keep_*`` are DroQ's
        dropout masks for the target and the online ensemble."""
        agent = self.agent
        actor = agent.actor
        with torch.no_grad():
            mean, std = actor(batch["next_observations"])
            next_actions, next_logprobs = squash_and_logprob(mean, std, eps, actor.action_scale, actor.action_bias)
            target_q = agent.target_critic(batch["next_observations"], next_actions, keep_target)
            alpha = torch.exp(agent.log_alpha)
            min_target = torch.min(target_q, dim=-1, keepdim=True).values - alpha * next_logprobs
            next_qf_value = batch["rewards"] + (1 - batch["terminated"]) * self.gamma * min_target
        qf_values = agent.critic(batch["observations"], batch["actions"], keep_online)
        loss = critic_loss(qf_values, next_qf_value, self.num_critics)
        _step(self.optimizers["critic"], self.critic_params, loss)
        return loss.detach()

    @torch.no_grad()
    def update_target(self) -> None:
        """target = target (1 - tau) + critic tau."""
        torch._foreach_mul_(self.target_params, 1 - self.tau)
        torch._foreach_add_(self.target_params, torch._foreach_mul(self.critic_params, self.tau))

    def actor_step(self, batch: Batch, eps: torch.Tensor, keep=None, ensemble_mean: bool = False):
        """One actor update; its loss and the log-probs of its sample. SAC
        takes the ensemble's min Q, DroQ its mean (``ensemble_mean``)."""
        agent = self.agent
        actor = agent.actor
        mean, std = actor(batch["observations"])
        actions, logprobs = squash_and_logprob(mean, std, eps, actor.action_scale, actor.action_bias)
        qf_values = agent.critic(batch["observations"], actions, keep)
        if ensemble_mean:
            q = torch.mean(qf_values, dim=-1, keepdim=True)
        else:
            q = torch.min(qf_values, dim=-1, keepdim=True).values
        loss = policy_loss(torch.exp(agent.log_alpha.detach()), logprobs, q)
        _step(self.optimizers["actor"], self.actor_params, loss)
        return loss.detach(), logprobs.detach()

    def alpha_step(self, logprobs: torch.Tensor) -> torch.Tensor:
        loss = entropy_loss(self.agent.log_alpha, logprobs, self.target_entropy)
        _step(self.optimizers["alpha"], [self.agent.log_alpha], loss)
        return loss.detach()

    def train_phase(self, data: Batch, iter_num: int, noise: Batch) -> torch.Tensor:
        """``G = data["rewards"].shape[0]`` gradient steps over a ``[G, B, ...]``
        block: critic -> EMA (when the iteration's gate is open) -> actor ->
        alpha. Returns the mean value, policy and alpha losses, [3], on the
        device."""
        apply_armed_learn_fault(self.agent)  # resilience.fault=lr_spike: identity unless armed
        do_ema = iter_num % self.target_period == 0
        losses = []
        for g in range(data["rewards"].shape[0]):
            batch = {k: v[g] for k, v in data.items()}
            qf_loss = self.critic_step(batch, noise["critic"][g])
            if do_ema:
                self.update_target()
            a_loss, logprobs = self.actor_step(batch, noise["actor"][g])
            losses.append(torch.stack([qf_loss, a_loss, self.alpha_step(logprobs)]))
        return torch.stack(losses).mean(dim=0)

    def run_phase(self, rb, G: int, sample: Dict[str, Any], generator: torch.Generator, iter_num: int) -> torch.Tensor:
        """Sample a ``[G, B, ...]`` block of ``rb`` to the device (``sample``:
        ``sample_to_device``'s arguments), draw its noise and take a train phase."""
        data = sample_to_device(rb, G, **sample)
        return self.train_phase(data, iter_num, self.draw_noise(G, sample["batch_size"], generator))

    # -- what the loop asks of the algorithm ------------------------------------------
    @staticmethod
    def check_spaces(cfg, observation_space, name: str) -> None:
        """Vector observations only: the CNN keys are dropped with a warning."""
        if len(cfg.algo.cnn_keys.encoder) > 0:
            warnings.warn(f"{name} algorithm cannot allow to use images as observations, the CNN keys will be ignored")
            cfg.algo.cnn_keys.encoder = []
        if len(cfg.algo.mlp_keys.encoder) == 0:
            raise RuntimeError("You should specify at least one MLP key for the encoder: `mlp_keys.encoder=[state]`")
        for k in cfg.algo.mlp_keys.encoder:
            if len(observation_space[k].shape) > 1:
                raise ValueError(
                    f"Only environments with vector-only observations are supported by the {name} agent. "
                    f"The observation with key '{k}' has shape {observation_space[k].shape}. "
                    f"Provided environment: {cfg.env.id}"
                )

    @staticmethod
    def ratio_steps(policy_step: int, prefill_steps: int, policy_steps_per_iter: int) -> int:
        """The policy steps the replay-ratio governor counts (the JAX loop's)."""
        return policy_step - prefill_steps + policy_steps_per_iter

    buffer_obs_keys = ("observations",)
    uint8_keys = ()

    def replay_rows(self, obs, real_next_obs, mlp_keys, num_envs: int, sample_next_obs: bool) -> Dict[str, np.ndarray]:
        """The observation entries of one step's replay row: the flattened
        vector keys (and the real next ones unless the buffer derives them)."""
        rows = {"observations": flat_obs(obs, mlp_keys, num_envs)[np.newaxis]}
        if not sample_next_obs:
            rows["next_observations"] = flat_obs(real_next_obs, mlp_keys, num_envs)[np.newaxis]
        return rows

    def start_acting(self, seed: int) -> None:
        """Acting runs on a host copy of the actor (see the module docstring)."""
        actor = self.agent.actor
        self.act_actor = actor if self.device.type == "cpu" else copy.deepcopy(actor).to("cpu")
        self.act_generator = torch.Generator().manual_seed(int(seed))

    @torch.no_grad()
    def act(self, obs, mlp_keys, num_envs: int) -> np.ndarray:
        """Sampled actions of the host actor for the envs' observations."""
        actor = self.act_actor
        mean, std = actor(prepare_obs(obs, mlp_keys=mlp_keys, num_envs=num_envs))
        eps = torch.randn(mean.shape, generator=self.act_generator)
        return squash_and_logprob(mean, std, eps, actor.action_scale, actor.action_bias)[0].numpy()

    def sync_acting(self) -> None:
        """After a train phase: the trained weights into the host actor."""
        sync_actor(self.act_actor, self.agent.actor)

    def agent_state(self) -> Dict[str, Any]:
        from sheeprl_tpu_torch.interop.flax_to_torch import sac_to_flax

        return sac_to_flax(self.agent)

    def test(self, cfg, log_dir: str, logger) -> float:
        return test(self.agent.actor, cfg, log_dir, logger)

    def opt_state(self) -> Dict[str, Any]:
        return {name: opt.state_dict() for name, opt in self.optimizers.items()}

    def load_opt_state(self, opt_state: Dict[str, Any]) -> None:
        """A checkpoint's optimizer states: the port's state dicts, or the JAX
        package's optax states."""
        from sheeprl_tpu_torch.interop.flax_to_torch import sac_group_to_torch
        from sheeprl_tpu_torch.interop.optax_to_torch import load_optimizer_state

        if sorted(opt_state) != sorted(self.optimizers):
            raise ValueError(f"the checkpoint's optimizer state should hold the groups {sorted(self.optimizers)}")
        for name, opt in self.optimizers.items():
            load_optimizer_state(opt, opt_state[name], sac_group_to_torch(self.agent, name))


def run_off_policy(fabric, cfg: Dict[str, Any], name: str, build_agent, trainer_cls,
                   make_trainer=None) -> Dict[str, Any]:
    """The training loop of SAC, DroQ and SAC-AE (``name`` in messages), with
    the algorithm's ``build_agent`` and trainer class (its checks, optimizers,
    replay rows, acting, checkpoint agent and test); ``make_trainer`` (the
    class's signature) builds the trainer in its place, as the decoupled
    topology's ``run_player`` does. Returns a summary of the
    run: policy and gradient steps, train phases, seconds spent stepping envs
    and training, the steady-state window (from the first iteration after
    learning starts to the loop's end, without checkpoint writes), the last
    losses, the test reward and the last checkpoint."""
    from sheeprl_tpu_torch.data.buffers import ReplayBuffer
    from sheeprl_tpu_torch.envs import spaces
    from sheeprl_tpu_torch.envs.vector import SyncVectorEnv, episode_stats
    from sheeprl_tpu_torch.resilience.monitor import build_resilience
    from sheeprl_tpu_torch.utils.checkpoint import InertObject, load_checkpoint, load_run_buffer, write_run_checkpoint
    from sheeprl_tpu_torch.utils.env import make_env
    from sheeprl_tpu_torch.utils.logger import get_log_dir, get_logger
    from sheeprl_tpu_torch.utils.metric import MetricAggregator
    from sheeprl_tpu_torch.utils.timer import timer
    from sheeprl_tpu_torch.utils.utils import Ratio, save_configs

    t_start = time.perf_counter()
    device = fabric.device
    state = load_checkpoint(cfg.checkpoint.resume_from) if cfg.checkpoint.resume_from else None

    log_dir = get_log_dir(cfg)
    logger = get_logger(cfg, log_dir)
    print(f"Log dir: {log_dir}", flush=True)
    resilience = build_resilience(cfg, log_dir)

    num_envs = int(cfg.env.num_envs)
    envs = SyncVectorEnv([make_env(cfg, cfg.seed + i, 0, log_dir, "train", vector_env_idx=i) for i in range(num_envs)])
    action_space = envs.single_action_space
    observation_space = envs.single_observation_space
    if not isinstance(action_space, spaces.Box):
        raise ValueError(f"Only continuous action space is supported for the {name} agent")
    if not isinstance(observation_space, spaces.Dict):
        raise RuntimeError(f"Unexpected observation type, should be of type Dict, got: {observation_space}")
    trainer_cls.check_spaces(cfg, observation_space, name)
    cnn_keys, mlp_keys = list(cfg.algo.cnn_keys.encoder), list(cfg.algo.mlp_keys.encoder)
    if cfg.metric.log_level > 0:
        if cnn_keys:
            print("Encoder CNN keys:", cnn_keys, flush=True)
        print("Encoder MLP keys:", mlp_keys, flush=True)
    obs_keys = cnn_keys + mlp_keys

    fabric.seed_everything(cfg.seed)
    agent = build_agent(fabric, cfg, observation_space, action_space, int(cfg.seed), state["agent"] if state else None)
    act_dim = int(np.prod(action_space.shape))
    policy_steps_per_iter = num_envs
    trainer = (make_trainer or trainer_cls)(
        agent, trainer_cls.build_optimizers(cfg, agent), cfg, -float(act_dim), policy_steps_per_iter
    )
    if state is not None:
        trainer.load_opt_state(state["opt_state"])
    save_configs(cfg, log_dir)
    aggregator = None if MetricAggregator.disabled else instantiate(cfg.metric.aggregator)

    buffer_size = cfg.buffer.size // num_envs if not cfg.dry_run else 1
    rb = ReplayBuffer(
        buffer_size,
        num_envs,
        memmap=cfg.buffer.memmap,
        memmap_dir=os.path.join(log_dir, "memmap_buffer", "rank_0"),
        obs_keys=trainer.buffer_obs_keys,
    )
    if state is not None and "rb" in state:
        if isinstance(state["rb"], InertObject):
            raise NotImplementedError(
                "the checkpoint holds a replay buffer of the JAX package: loading it is not yet ported "
                "to sheeprl_tpu_torch (resume from a checkpoint written with buffer.checkpoint=False)"
            )
        rb = load_run_buffer(state)
    else:
        rb.seed(int(cfg.seed))

    # counters (the JAX loop's, one process)
    start_iter = state["iter_num"] + 1 if state is not None else 1
    policy_step = state["iter_num"] * num_envs if state is not None else 0
    last_log = state["last_log"] if state is not None else 0
    last_checkpoint = state["last_checkpoint"] if state is not None else 0
    total_iters = int(cfg.algo.total_steps // policy_steps_per_iter) if not cfg.dry_run else 1
    learning_starts = cfg.algo.learning_starts // policy_steps_per_iter if not cfg.dry_run else 0
    prefill_steps = learning_starts - int(learning_starts > 0)
    if state is not None:
        cfg.algo.per_rank_batch_size = state["batch_size"]
        learning_starts += start_iter
        prefill_steps += start_iter
    batch_size = int(cfg.algo.per_rank_batch_size)

    ratio = Ratio(cfg.algo.replay_ratio, pretrain_steps=cfg.algo.per_rank_pretrain_steps)
    if state is not None:
        ratio.load_state_dict(state["ratio"])

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
    sample_next_obs = bool(cfg.buffer.sample_next_obs)

    trainer.start_acting(int(cfg.seed))
    train_generator = torch.Generator(device).manual_seed(int(cfg.seed) + 1)
    action_rng = np.random.default_rng(int(cfg.seed))

    step_data: Dict[str, np.ndarray] = {}
    obs = envs.reset(seed=cfg.seed)[0]
    cumulative_per_rank_gradient_steps = 0
    env_seconds = train_seconds = 0.0
    train_phases = 0
    losses = None
    ckpt_path = None
    iter_num = start_iter - 1
    preempted = False
    window_t0 = None
    window_policy_step = window_gradient_step = 0
    window_ckpt_seconds = 0.0
    for iter_num in range(start_iter, total_iters + 1):
        if window_t0 is None and iter_num > learning_starts:
            window_t0 = time.perf_counter()
            window_policy_step, window_gradient_step = policy_step, cumulative_per_rank_gradient_steps
        policy_step += policy_steps_per_iter

        t0 = time.perf_counter()
        with timer("Time/env_interaction_time"):
            if iter_num <= learning_starts:
                actions = np.stack([action_space.sample(action_rng) for _ in range(num_envs)])
            else:
                actions = trainer.act(obs, obs_keys, num_envs)
            next_obs, rewards, terminated, truncated, infos = envs.step(actions.reshape(envs.action_space.shape))

            rews, lens = episode_stats(infos, num_envs)
            if len(rews) > 0 and aggregator is not None:
                aggregator.update("Rewards/rew_avg", float(np.mean(rews)))
                aggregator.update("Game/ep_len_avg", float(np.mean(lens)))

            # the real next observations of finished episodes
            real_next_obs = {k: np.asarray(next_obs[k]).copy() for k in obs_keys}
            final_obs = infos.get("final_obs")
            if final_obs is not None:
                for idx in range(num_envs):
                    if final_obs[idx] is not None:
                        for k in obs_keys:
                            real_next_obs[k][idx] = np.asarray(final_obs[idx][k])

            step_data["terminated"] = np.asarray(terminated).reshape(1, num_envs, -1).astype(np.float32)
            step_data["truncated"] = np.asarray(truncated).reshape(1, num_envs, -1).astype(np.float32)
            step_data["actions"] = actions.reshape(1, num_envs, -1).astype(np.float32)
            step_data.update(trainer.replay_rows(obs, real_next_obs, obs_keys, num_envs, sample_next_obs))
            step_data["rewards"] = np.asarray(rewards, dtype=np.float32).reshape(1, num_envs, -1)
            rb.add(step_data, validate_args=cfg.buffer.validate_args)
        env_seconds += time.perf_counter() - t0
        obs = next_obs

        if iter_num >= learning_starts:
            per_rank_gradient_steps = ratio(trainer.ratio_steps(policy_step, prefill_steps, policy_steps_per_iter))
            if per_rank_gradient_steps > 0:
                t0 = time.perf_counter()
                with timer("Time/train_time"):
                    sample = dict(batch_size=batch_size, sample_next_obs=sample_next_obs,
                                  uint8_keys=trainer.uint8_keys, device=device)
                    # the losses' copy to the host waits for the phase: the timer ends there
                    losses = trainer.run_phase(rb, per_rank_gradient_steps, sample, train_generator, iter_num).cpu()
                    trainer.sync_acting()
                    cumulative_per_rank_gradient_steps += per_rank_gradient_steps
                    train_phases += 1
                    if aggregator is not None:
                        for loss_name, value in zip(trainer.loss_names, losses):
                            aggregator.update(loss_name, value)
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

        preempted = resilience.preempt_requested()
        if (
            (cfg.checkpoint.every > 0 and policy_step - last_checkpoint >= cfg.checkpoint.every)
            or cfg.dry_run
            or (iter_num == total_iters and cfg.checkpoint.save_last)
            or preempted
        ):
            last_checkpoint = policy_step
            ckpt_state = {
                "agent": trainer.agent_state(),
                "opt_state": trainer.opt_state(),
                "ratio": ratio.state_dict(),
                "iter_num": iter_num,
                "batch_size": batch_size,
                "last_log": last_log,
                "last_checkpoint": last_checkpoint,
            }
            ckpt_path = os.path.join(log_dir, "checkpoint", f"ckpt_{policy_step}_0.ckpt")
            t0 = time.perf_counter()
            with timer("Time/checkpoint_time"):
                write_run_checkpoint(
                    ckpt_path,
                    ckpt_state,
                    replay_buffer=rb if cfg.buffer.checkpoint else None,
                    keep_last=int(cfg.checkpoint.get("keep_last") or 0),
                )
            resilience.observe_checkpoint(ckpt_path, policy_step, preempted=preempted)
            if window_t0 is not None:
                window_ckpt_seconds += time.perf_counter() - t0
        if preempted:
            break

    window_seconds = time.perf_counter() - window_t0 - window_ckpt_seconds if window_t0 is not None else 0.0
    envs.close()
    test_reward = None
    preempted = resilience.finalize(policy_step)
    if not preempted and cfg.algo.run_test:
        with timer("Time/test_time"):
            test_reward = trainer.test(cfg, log_dir, logger)
    if logger is not None:
        logger.finalize()
    return {
        "log_dir": log_dir,
        "policy_steps": policy_step,
        "iterations": iter_num - start_iter + 1,
        "gradient_steps": cumulative_per_rank_gradient_steps,
        "train_phases": train_phases,
        "env_seconds": env_seconds,
        "train_seconds": train_seconds,
        "wall_seconds": time.perf_counter() - t_start,
        "steady_policy_steps": policy_step - window_policy_step if window_t0 is not None else 0,
        "steady_gradient_steps": cumulative_per_rank_gradient_steps - window_gradient_step,
        "steady_seconds": window_seconds,
        "metrics": dict(zip(trainer.loss_names, losses.tolist())) if losses is not None else {},
        "test_reward": test_reward,
        "checkpoint": ckpt_path,
        "preempted": preempted,
    }


def main(fabric, cfg: Dict[str, Any]) -> Dict[str, Any]:
    return run_off_policy(fabric, cfg, "SAC", build_agent, SACTrainer)

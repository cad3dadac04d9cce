"""The on-policy Anakin topology (port of ``sheeprl_tpu/algos/ppo/anakin.py``).

The envs live on the card (``envs/device``), so a training iteration is a
rollout of ``rollout_steps`` batched env steps acted by the agent on the card,
GAE, and ``update_epochs`` x minibatch updates, with no host round trip in
between (Podracer, arxiv 2104.06272). The JAX package compiles an iteration
into one donated XLA program; the port runs it as an eager loop over batched
tensors on the card. Nothing of it reads a value back to the host: the
episode statistics and losses stay on the card and are read at the logging
cadence, and ``Time/rollout_time`` and ``Time/train_time`` are timed with CUDA
events read there too (the JAX loop measures a rollout-only program once to
split its fused call's wall time instead).

Two flavors share the loop:

- ``ppo``: the clipped surrogate over ``update_epochs`` x shuffled minibatches
  (the last one pad-wraps into the epoch's permutation). A power-of-two row
  count is shuffled by the Feistel permutation (``utils/prp.py``) from 8
  round keys an epoch; any other by a random permutation, as the JAX
  package's ``epoch_permutation`` gives on one device;
- ``a2c``: one gradient step on the whole rollout, A2C's losses.

The random draws of an iteration are arguments of :meth:`AnakinProgram.step`
(:meth:`AnakinProgram.draw_inputs` makes them from a ``torch.Generator`` on the
card): the action noise of every step, the reset state of every step (the
state an env restarts from when its episode ends) and the epochs' round keys
or permutations. The tests pass the draws the JAX keys give.

Not ported: the XLA AOT contract (``register_fused_program`` and
``_aot_anakin_program``), and the layout for more than one device (the
port's Fabric runs on one).
"""

from __future__ import annotations

import os
import time
import warnings
from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import torch

from sheeprl_tpu_torch.algos.a2c.loss import policy_loss as a2c_policy_loss
from sheeprl_tpu_torch.algos.a2c.loss import value_loss as a2c_value_loss
from sheeprl_tpu_torch.algos.ppo.agent import PPOAgent, build_agent, draw_policy_noise, make_dists, policy_output
from sheeprl_tpu_torch.algos.ppo.loss import entropy_loss, policy_loss, value_loss
from sheeprl_tpu_torch.algos.ppo.ppo import apply_update, build_optimizer
from sheeprl_tpu_torch.config import instantiate
from sheeprl_tpu_torch.envs.device.wrappers import AutoReset, AutoResetState
from sheeprl_tpu_torch.resilience.faults import apply_armed_learn_fault
from sheeprl_tpu_torch.utils.prp import draw_round_keys, prp_permutation
from sheeprl_tpu_torch.utils.timer import timer
from sheeprl_tpu_torch.utils.utils import gae, normalize_tensor, polynomial_decay, save_configs

Batch = Dict[str, torch.Tensor]

# the episode accumulators carried on the card across iterations, read and
# zeroed at the logging cadence
_STATS_ACC = ("ep_return_sum", "ep_length_sum", "ep_count")


def truncation_bootstrap(values_fn, rewards, truncated, terminal_obs, gamma: float) -> torch.Tensor:
    """``r += gamma * V(terminal_obs)`` on the truncated rows of a ``[T, E, 1]``
    reward block: the critic runs on every row and the mask keeps the
    truncated ones. The JAX package gathers those rows up to a static bound
    and scatters the bonus back; in this eager loop, bound by the host's
    launches, that design was no faster end to end at 64 x 128 or 8192 x 128
    on an H100 (``anakin_bootstrap_timing.py``)."""
    T, E = truncated.shape
    term_v = values_fn(terminal_obs.reshape(T * E, -1)).reshape(T, E, 1)
    return rewards + gamma * term_v * truncated[..., None].to(rewards.dtype)


def _flavor(cfg) -> str:
    name = str(cfg.algo.name)
    if name.startswith("a2c"):
        return "a2c"
    if name.startswith("ppo"):
        return "ppo"
    raise ValueError(f"the anakin loop supports the ppo and a2c flavors, got algo.name={name!r}")


def _minibatch_plan(cfg, num_envs: int) -> Tuple[int, int, int]:
    """(batch size, minibatches, epochs) of one iteration, shared by the
    program and the learning-rate schedule. a2c: one full-rollout step."""
    num_rows = int(cfg.algo.rollout_steps) * num_envs
    if _flavor(cfg) == "ppo":
        batch_size = min(int(cfg.algo.per_rank_batch_size), num_rows)
        num_minibatches = -(-num_rows // batch_size)  # ceil: the last minibatch pad-wraps
        return batch_size, num_minibatches, int(cfg.algo.get("update_epochs", 1))
    return num_rows, 1, 1


@dataclass
class StepOutput:
    env_state: AutoResetState
    obs: torch.Tensor
    ep_stats: torch.Tensor  # [3]: the summed return, length and count of the episodes that ended
    losses: torch.Tensor  # [3]: mean policy, value and entropy losses
    traj: Batch  # [T, E, ...]
    returns: torch.Tensor  # [T, E, 1]
    advantages: torch.Tensor  # [T, E, 1]


class PhaseClock:
    """The seconds of an iteration's ``parts`` phases (the rollout and the
    train phase by default), from the ``parts + 1`` marks between them: CUDA
    events on a card, read (and waited for) only in :meth:`read`; the host
    clock on the CPU, where every op has finished when it returns."""

    def __init__(self, device: torch.device, parts: int = 2):
        self.cuda = device.type == "cuda"
        self.parts = int(parts)
        self._marks: List[tuple] = []

    def mark(self) -> Any:
        if self.cuda:
            event = torch.cuda.Event(enable_timing=True)
            event.record()
            return event
        return time.perf_counter()

    def add(self, *marks) -> None:
        if len(marks) != self.parts + 1:
            raise ValueError(f"a clock of {self.parts} phases takes {self.parts + 1} marks, got {len(marks)}")
        self._marks.append(marks)

    def read(self) -> Tuple[float, ...]:
        """Each phase's seconds since the last read."""
        seconds = [0.0] * self.parts
        if self.cuda and self._marks:
            self._marks[-1][-1].synchronize()
        for marks in self._marks:
            for i, (a, b) in enumerate(zip(marks, marks[1:])):
                seconds[i] += a.elapsed_time(b) / 1e3 if self.cuda else b - a
        self._marks = []
        return tuple(seconds)


class AnakinProgram:
    """One Anakin iteration of the PPO or A2C flavor over ``env`` (its envs
    on the agent's device)."""

    def __init__(self, agent: PPOAgent, env: AutoReset, cfg, optimizer, schedule=None, mlp_key: str = "state"):
        self.agent = agent
        self.env = env
        self.optimizer = optimizer
        self.schedule = schedule
        self.mlp_key = mlp_key
        self.params = list(agent.parameters())
        self.device = env.device
        self.flavor = _flavor(cfg)
        self.rollout_steps = T = int(cfg.algo.rollout_steps)
        self.num_envs = E = env.num_envs
        self.num_rows = T * E
        self.gamma = float(cfg.algo.gamma)
        self.gae_lambda = float(cfg.algo.gae_lambda)
        self.loss_reduction = str(cfg.algo.loss_reduction)
        self.vf_coef = float(cfg.algo.get("vf_coef", 1.0))
        self.clip_vloss = bool(cfg.algo.get("clip_vloss", False))
        self.normalize_advantages = bool(cfg.algo.get("normalize_advantages", False))
        self.max_grad_norm = float(cfg.algo.get("max_grad_norm", 0.0) or 0.0)
        self.actions_dim = env.spec.action.actions_dim
        self.is_continuous = env.spec.action.kind == "continuous"
        self.batch_size, self.num_minibatches, self.update_epochs = _minibatch_plan(cfg, E)
        self.updates_per_iter = self.update_epochs * self.num_minibatches
        # episodes truncate only under a step budget; without one the
        # bootstrap pass is skipped
        limit = env.spec.max_episode_steps
        self.truncates = limit is not None
        # one epoch over one minibatch: any order is the identity up to the
        # reduction order, so there is no shuffle
        self.single_full_batch = self.update_epochs == 1 and self.num_minibatches == 1
        self.use_prp = self.num_rows >= 2 and (self.num_rows & (self.num_rows - 1)) == 0

    # -- the iteration's random draws ----------------------------------------------
    def draw_inputs(self, generator: Optional[torch.Generator]) -> Dict[str, Any]:
        """The draws of one iteration: ``noise`` [T, E, sum(actions_dim)]
        (standard normal, or standard Gumbel per logit), ``resets`` [T, E, ...]
        (the state an env restarts from at each step) and ``orders``, one per
        epoch: 8 round keys (power-of-two row counts) or a permutation."""
        T, E = self.rollout_steps, self.num_envs
        noise = draw_policy_noise(self.actions_dim, self.is_continuous, T * E, generator, self.device)
        if self.single_full_batch:
            orders = []
        elif self.use_prp:
            orders = list(draw_round_keys(self.update_epochs, generator, self.device))
        else:
            orders = [torch.randperm(self.num_rows, generator=generator, device=self.device)
                      for _ in range(self.update_epochs)]
        return {"noise": noise.reshape(T, E, -1), "resets": self.env.draw_resets(T, generator), "orders": orders}

    # -- acting ----------------------------------------------------------------------
    @torch.no_grad()
    def values(self, obs: torch.Tensor) -> torch.Tensor:
        """The critic alone: the bootstrap passes need no actor forward."""
        return self.agent.get_values({self.mlp_key: obs})

    def _sample(self, actor_outs: List[torch.Tensor], noise: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """Actions and their log-probs (no entropy: only the loss needs it)."""
        dists = make_dists(actor_outs, self.is_continuous)
        if self.is_continuous:
            act = dists[0].sample(noise)
            return act, dists[0].log_prob(act)[..., None]
        sampled = [d.sample(n) for d, n in zip(dists, torch.split(noise, list(self.actions_dim), dim=-1))]
        logprob = torch.stack([d.log_prob(a) for d, a in zip(dists, sampled)], dim=-1).sum(dim=-1, keepdim=True)
        return torch.cat(sampled, dim=-1), logprob

    @torch.no_grad()
    def rollout(self, env_state: AutoResetState, obs: torch.Tensor, noise: torch.Tensor, resets: torch.Tensor):
        """``rollout_steps`` env steps acted by the agent: the new env state
        and observation, the [T, E, ...] trajectory and the summed stats [3] of
        the episodes that ended. No value is read back to the host."""
        steps: Dict[str, list] = {k: [] for k in (self.mlp_key, "actions", "logprobs", "values", "rewards", "dones")}
        if self.truncates:
            steps["terminal_observation"], steps["truncated"] = [], []
        ends = {"return": [], "length": [], "done": []}
        for t in range(self.rollout_steps):
            actor_outs, values = self.agent({self.mlp_key: obs})
            actions, logprob = self._sample(actor_outs, noise[t])
            env_actions = actions if self.is_continuous else torch.argmax(actions, dim=-1)
            env_state, next_obs, reward, done, info = self.env.step(env_state, env_actions, resets[t])
            done_f = done.to(torch.float32)
            for k, v in ((self.mlp_key, obs), ("actions", actions), ("logprobs", logprob), ("values", values),
                         ("rewards", reward[:, None]), ("dones", done_f[:, None])):
                steps[k].append(v)
            if self.truncates:
                steps["terminal_observation"].append(info["terminal_observation"])
                steps["truncated"].append(info["truncated"])
            ends["return"].append(info["episode_return"])
            ends["length"].append(info["episode_length"])
            ends["done"].append(done_f)
            obs = next_obs
        traj = {k: torch.stack(v) for k, v in steps.items()}
        done_f = torch.stack(ends["done"])
        ep_stats = torch.stack([
            (torch.stack(ends["return"]) * done_f).sum(dim=1).sum(dim=0),
            (torch.stack(ends["length"]).to(torch.float32) * done_f).sum(dim=1).sum(dim=0),
            done_f.sum(dim=1).sum(dim=0),
        ])
        return env_state, obs, traj, ep_stats

    # -- training --------------------------------------------------------------------
    @torch.no_grad()
    def returns(self, traj: Batch, next_values: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """(returns, advantages) [T, E, 1]: the truncation bootstrap, then GAE."""
        rewards = traj["rewards"]
        if self.truncates:
            rewards = truncation_bootstrap(
                self.values, rewards, traj["truncated"], traj["terminal_observation"], self.gamma
            )
        return gae(rewards, traj["values"], traj["dones"], next_values, self.rollout_steps, self.gamma, self.gae_lambda)

    def loss(self, batch: Batch, clip_coef: float, ent_coef: float) -> Tuple[torch.Tensor, torch.Tensor]:
        actor_outs, new_values = self.agent({self.mlp_key: batch[self.mlp_key]})
        out = policy_output(actor_outs, new_values, self.actions_dim, self.is_continuous, actions=batch["actions"])
        ent = entropy_loss(out["entropy"], self.loss_reduction)
        if self.flavor == "ppo":
            advantages = batch["advantages"]
            if self.normalize_advantages:
                advantages = normalize_tensor(advantages)
            pg = policy_loss(out["logprob"], batch["logprobs"], advantages, clip_coef, self.loss_reduction)
            vl = value_loss(out["values"], batch["values"], batch["returns"], clip_coef, self.clip_vloss,
                            self.loss_reduction)
            loss = pg + self.vf_coef * vl + ent_coef * ent
        else:
            pg = a2c_policy_loss(out["logprob"], batch["advantages"], self.loss_reduction)
            vl = a2c_value_loss(out["values"], batch["returns"], self.loss_reduction)
            loss = pg + vl + ent_coef * ent
        return loss, torch.stack([pg.detach(), vl.detach(), ent.detach()])

    def _update(self, batch: Batch, clip_coef: float, ent_coef: float) -> torch.Tensor:
        loss, parts = self.loss(batch, clip_coef, ent_coef)
        apply_update(self.optimizer, self.params, torch.autograd.grad(loss, self.params), self.max_grad_norm,
                     self.schedule)
        return parts

    def train(self, traj: Batch, returns: torch.Tensor, advantages: torch.Tensor, orders: Sequence[torch.Tensor],
              clip_coef: float, ent_coef: float) -> torch.Tensor:
        """The iteration's updates on the T-major flattened rollout; returns
        the mean policy, value and entropy losses [3] (over each epoch's
        minibatches, then over the epochs)."""
        apply_armed_learn_fault(self.agent)  # resilience.fault=lr_spike: identity unless armed
        keys = (self.mlp_key, "actions", "logprobs", "values")
        flat = {k: traj[k].reshape(self.num_rows, *traj[k].shape[2:]) for k in keys if k in traj}
        flat["returns"] = returns.reshape(self.num_rows, 1)
        flat["advantages"] = advantages.reshape(self.num_rows, 1)
        if self.single_full_batch:
            return self._update(flat, clip_coef, ent_coef)
        pad = self.num_minibatches * self.batch_size - self.num_rows
        epochs = []
        for order in orders:
            perm = prp_permutation(self.num_rows, order) if self.use_prp else order
            if pad > 0:
                perm = torch.cat([perm, perm[:pad]])
            mb_idx = perm.reshape(self.num_minibatches, self.batch_size)
            parts = [self._update({k: v[mb_idx[i]] for k, v in flat.items()}, clip_coef, ent_coef)
                     for i in range(self.num_minibatches)]
            epochs.append(torch.stack(parts).mean(dim=0))
        return torch.stack(epochs).mean(dim=0)

    def step(self, env_state: AutoResetState, obs: torch.Tensor, inputs: Dict[str, Any], clip_coef: float,
             ent_coef: float, clock: Optional[PhaseClock] = None) -> StepOutput:
        """One iteration: the rollout, the bootstrap value of its last
        observation, GAE and the updates."""
        start = clock.mark() if clock else None
        env_state, obs, traj, ep_stats = self.rollout(env_state, obs, inputs["noise"], inputs["resets"])
        mid = clock.mark() if clock else None
        returns, advantages = self.returns(traj, self.values(obs))
        losses = self.train(traj, returns, advantages, inputs["orders"], clip_coef, ent_coef)
        if clock:
            clock.add(start, mid, clock.mark())
        return StepOutput(env_state, obs, ep_stats, losses, traj, returns, advantages)


def anakin_mlp_key(cfg) -> str:
    """The JAX loops' refusals of what cannot live in an Anakin iteration
    (host envs, cnn keys, several mlp keys); returns the one mlp key."""
    backend = str(cfg.env.get("backend", "host") or "host").lower()
    if backend != "jax":
        raise ValueError(
            f"{cfg.algo.name} requires the on-device env plane: set env.backend=jax "
            f"(got {backend!r}); host envs cannot live inside the fused program"
        )
    if len(cfg.algo.cnn_keys.encoder) > 0:
        raise ValueError("the anakin topology supports mlp observations only (cnn_keys must be empty)")
    if len(cfg.algo.mlp_keys.encoder) != 1:
        raise ValueError(f"the anakin topology expects exactly one mlp key, got {cfg.algo.mlp_keys.encoder!r}")
    return str(cfg.algo.mlp_keys.encoder[0])


def run_anakin(fabric, cfg: Dict[str, Any]) -> Dict[str, Any]:
    """The ppo_anakin / a2c_anakin training loop; returns a summary of the run."""
    from sheeprl_tpu_torch.algos.ppo.utils import test
    from sheeprl_tpu_torch.envs import spaces
    from sheeprl_tpu_torch.envs.device import make_device_env
    from sheeprl_tpu_torch.interop.flax_to_torch import ppo_to_flax, ppo_to_torch
    from sheeprl_tpu_torch.interop.optax_to_torch import load_optimizer_state
    from sheeprl_tpu_torch.resilience.monitor import build_resilience
    from sheeprl_tpu_torch.utils.checkpoint import load_checkpoint, write_run_checkpoint
    from sheeprl_tpu_torch.utils.logger import get_log_dir, get_logger
    from sheeprl_tpu_torch.utils.metric import MetricAggregator

    t_start = time.perf_counter()
    _flavor(cfg)
    mlp_key = anakin_mlp_key(cfg)
    initial_ent_coef = float(cfg.algo.get("ent_coef", 0.0))
    initial_clip_coef = float(cfg.algo.get("clip_coef", 0.2))
    device = fabric.device
    state = load_checkpoint(cfg.checkpoint.resume_from) if cfg.checkpoint.resume_from else None

    log_dir = get_log_dir(cfg)
    logger = get_logger(cfg, log_dir)
    print(f"Log dir: {log_dir}", flush=True)
    resilience = build_resilience(cfg, log_dir)

    num_envs = int(cfg.env.num_envs)
    env = make_device_env(cfg, num_envs, device)
    spec = env.spec
    is_continuous = spec.action.kind == "continuous"
    actions_dim = spec.action.actions_dim
    observation_space = spaces.Dict({mlp_key: spec.to_obs_space()})

    fabric.seed_everything(cfg.seed)
    agent = build_agent(
        fabric, actions_dim, is_continuous, cfg, observation_space, cfg.seed, state["agent"] if state else None
    )

    policy_steps_per_iter = int(num_envs * cfg.algo.rollout_steps)
    total_iters = cfg.algo.total_steps // policy_steps_per_iter if not cfg.dry_run else 1
    start_iter = state["iter_num"] + 1 if state is not None else 1
    policy_step = state["iter_num"] * policy_steps_per_iter if state is not None else 0
    last_log = state["last_log"] if state is not None else 0
    last_checkpoint = state["last_checkpoint"] if state is not None else 0
    if cfg.metric.log_level > 0 and cfg.metric.log_every % policy_steps_per_iter != 0:
        warnings.warn(
            f"The metric.log_every parameter ({cfg.metric.log_every}) is not a multiple of the "
            f"policy_steps_per_iter value ({policy_steps_per_iter})."
        )

    # the schedule spans total_iters x the updates of an iteration, the same
    # plan the program runs
    _, plan_minibatches, plan_epochs = _minibatch_plan(cfg, num_envs)
    optimizer, schedule = build_optimizer(cfg, agent, total_iters, plan_epochs * plan_minibatches)
    if state is not None and "optimizer" in state:
        load_optimizer_state(optimizer, state["optimizer"], ppo_to_torch(agent))
    save_configs(cfg, log_dir)
    aggregator = None if MetricAggregator.disabled else instantiate(cfg.metric.aggregator)

    program = AnakinProgram(agent, env, cfg, optimizer, schedule, mlp_key)
    generator = torch.Generator(device=device).manual_seed(int(cfg.seed))
    env_state, obs = env.reset(generator)
    stats = torch.zeros(len(_STATS_ACC), dtype=torch.float32, device=device)
    clock = PhaseClock(device)
    rollout_seconds = train_seconds = 0.0

    ent_coef, clip_coef = initial_ent_coef, initial_clip_coef
    losses = None
    ckpt_path = None
    iter_num = start_iter - 1
    preempted = False
    for iter_num in range(start_iter, total_iters + 1):
        policy_step += policy_steps_per_iter
        out = program.step(env_state, obs, program.draw_inputs(generator), clip_coef, ent_coef, clock)
        env_state, obs, losses = out.env_state, out.obs, out.losses
        stats += out.ep_stats

        resilience.step(policy_step)
        if cfg.metric.log_level > 0 and (
            policy_step - last_log >= cfg.metric.log_every or iter_num == total_iters or cfg.dry_run
        ):
            with timer("Time/logging_time"):
                # the only device-to-host reads of the loop: a handful of scalars
                rollout_s, train_s = clock.read()
                rollout_seconds += rollout_s
                train_seconds += train_s
                timer("Time/rollout_time").add(rollout_s)
                timer("Time/train_time").add(train_s)
                ep_return, ep_length, ep_count = stats.tolist()
                if aggregator is not None:
                    if ep_count > 0:
                        aggregator.update("Rewards/rew_avg", ep_return / ep_count)
                        aggregator.update("Game/ep_len_avg", ep_length / ep_count)
                    for name, value in zip(("Loss/policy_loss", "Loss/value_loss", "Loss/entropy_loss"),
                                           losses.tolist()):
                        aggregator.update(name, value)
                stats.zero_()
                metrics_dict = aggregator.compute() if aggregator else {}
                if logger is not None:
                    logger.log_metrics(metrics_dict, policy_step)
                    timers = timer.to_dict(reset=False)
                    phase_seconds = timers.get("Time/rollout_time", 0.0) + timers.get("Time/train_time", 0.0)
                    if phase_seconds > 0:
                        logger.log_metrics(
                            {"Time/sps_env_interaction": (policy_step - last_log) / phase_seconds}, policy_step
                        )
                timer.to_dict(reset=True)
                if aggregator:
                    aggregator.reset()
            last_log = policy_step

        if cfg.algo.get("anneal_clip_coef", False):
            clip_coef = polynomial_decay(
                iter_num, initial=initial_clip_coef, final=0.0, max_decay_steps=total_iters, power=1.0
            )
        if cfg.algo.get("anneal_ent_coef", False):
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
                "agent": ppo_to_flax(agent),
                "optimizer": optimizer.state_dict(),
                "iter_num": iter_num,
                "batch_size": int(cfg.algo.per_rank_batch_size),
                "last_log": last_log,
                "last_checkpoint": last_checkpoint,
            }
            ckpt_path = os.path.join(log_dir, "checkpoint", f"ckpt_{policy_step}_0.ckpt")
            with timer("Time/checkpoint_time"):
                write_run_checkpoint(ckpt_path, ckpt_state, keep_last=int(cfg.checkpoint.get("keep_last") or 0))
            resilience.observe_checkpoint(ckpt_path, policy_step, preempted=preempted)
        if preempted:
            break

    rollout_s, train_s = clock.read()
    rollout_seconds += rollout_s
    train_seconds += train_s
    test_reward = None
    preempted = resilience.finalize(policy_step)
    if not preempted and cfg.algo.run_test:
        with timer("Time/test_time"):
            test_reward = test(agent, cfg, log_dir, logger)
    if logger is not None:
        logger.finalize()
    names = ("Loss/policy_loss", "Loss/value_loss", "Loss/entropy_loss")
    return {
        "log_dir": log_dir,
        "policy_steps": policy_step,
        "iterations": iter_num - start_iter + 1,
        "updates_per_iter": program.updates_per_iter,
        "rollout_seconds": rollout_seconds,
        "train_seconds": train_seconds,
        "wall_seconds": time.perf_counter() - t_start,
        "metrics": dict(zip(names, losses.cpu().tolist())) if losses is not None else {},
        "test_reward": test_reward,
        "checkpoint": ckpt_path,
        "preempted": preempted,
    }

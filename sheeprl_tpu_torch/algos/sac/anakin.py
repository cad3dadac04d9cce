"""The off-policy Anakin topology (port of ``sheeprl_tpu/algos/sac/anakin.py``).

The envs (``envs/device``) and the replay ring (``data/device_ring.py``) live
on the card, so a training iteration is ``rollout_steps`` batched env steps
acted by the SAC actor, the write of their ``[T, E, ...]`` transitions into
the ring, one uniform ring sample of ``[G, B, ...]`` and G gradient steps,
with no host round trip in between (Podracer, arxiv 2104.06272). The JAX
package compiles an iteration into one donated XLA program; the port runs
it as an eager loop over batched tensors on the card. The G steps are
:meth:`SACTrainer.train_phase <sheeprl_tpu_torch.algos.sac.sac.SACTrainer.train_phase>`,
the update every SAC topology shares (the JAX program inlines
``make_train_body``).

The differences from the host loop are the JAX package's:

- ``buffer.backend=device`` is required: the ring is the replay storage; a
  host ``ReplayBuffer`` is only its durability twin, snapshotted into the
  checkpoint and landed back on the card on resume;
- the replay ratio is static: ``G = round(replay_ratio * rollout_steps *
  num_envs)`` gradient steps an iteration;
- ``algo.learning_starts`` is ignored (with a warning): the first iteration
  writes its rollout into the ring before it samples.

The next observation stored for a transition is the step's pre-reset
observation (``AutoReset``'s ``terminal_observation``); ``terminated`` and
``truncated`` are both stored, and only ``terminated`` enters the target.
The target EMA's gate, ``iter_num % target_period``, is a host integer.

The random draws of an iteration are arguments of
:meth:`SACAnakinProgram.step` (:meth:`SACAnakinProgram.draw_inputs` makes
them from a ``torch.Generator`` on the card), in the JAX program's order:
the action noise of every step, the reset state of every step, the ring
sample's 8 round keys and the critic's and actor's noise of every gradient
step. The tests pass the draws the JAX keys give. Episode statistics and
losses stay on the card until the logging cadence; the rollout, the ring
and the train phase are timed with CUDA events.

Not ported, by design: the XLA AOT contracts (``_aot_sac_anakin_program``,
``_aot_ring_write_program``, ``_aot_ring_sample_program``; a CUDA graph of
the iteration is their counterpart to come); the layout for more than one
device (the port's Fabric runs on one); ``_measure_rollout_seconds`` (CUDA
events time the phases); the ``Learn/*`` statistics and
``apply_armed_learn_fault`` (telemetry and ``resilience.fault`` are refused
in training); evaluation and serving of a ``sac_anakin`` checkpoint, which
the JAX package does not register either.
"""

from __future__ import annotations

import os
import time
import warnings
from dataclasses import dataclass
from typing import Any, Dict, Optional

import numpy as np
import torch

from sheeprl_tpu_torch.algos.ppo.anakin import PhaseClock, anakin_mlp_key
from sheeprl_tpu_torch.algos.sac.agent import squash_and_logprob
from sheeprl_tpu_torch.algos.sac.sac import SACTrainer
from sheeprl_tpu_torch.data.device_ring import Ring, ring_sample, ring_write
from sheeprl_tpu_torch.envs.device.wrappers import AutoReset, AutoResetState
from sheeprl_tpu_torch.utils.prp import draw_round_keys

Batch = Dict[str, torch.Tensor]

# the transition one rollout step appends to the ring; terminated AND
# truncated are both stored, so that the checkpoint's twin is a host buffer
# like any other
RING_ROW_KEYS = ("observations", "next_observations", "actions", "rewards", "terminated", "truncated")


def ring_row_specs(obs_dim: int, act_dim: int) -> Dict[str, tuple]:
    """The per-env trailing (shape, dtype) of each ring key."""
    widths = {"observations": obs_dim, "next_observations": obs_dim, "actions": act_dim}
    return {k: ((int(widths.get(k, 1)),), torch.float32) for k in RING_ROW_KEYS}


def grad_steps_per_iteration(cfg, num_envs: int) -> int:
    """The gradient steps of one iteration: ``algo.replay_ratio`` gradient
    steps a policy step over the iteration's ``rollout_steps * num_envs``."""
    T = int(cfg.algo.rollout_steps)
    return max(1, int(round(float(cfg.algo.replay_ratio) * T * int(num_envs))))


@dataclass
class SACStepOutput:
    env_state: AutoResetState
    obs: torch.Tensor
    ring: Ring
    ep_stats: torch.Tensor  # [3]: the summed return, length and count of the episodes that ended
    losses: torch.Tensor  # [3]: mean value, policy and alpha losses
    traj: Batch  # [T, E, ...] the rows written into the ring
    batch: Batch  # [G, B, ...] the rows sampled from it


class SACAnakinProgram:
    """One SAC Anakin iteration over ``env`` (its envs on the trainer's
    device), training through ``trainer`` on ``batch_size`` samples a
    gradient step."""

    def __init__(self, trainer: SACTrainer, env: AutoReset, cfg, batch_size: int):
        self.trainer = trainer
        self.actor = trainer.agent.actor
        self.env = env
        self.device = env.device
        self.rollout_steps = int(cfg.algo.rollout_steps)
        self.num_envs = env.num_envs
        self.num_rows = self.rollout_steps * self.num_envs
        self.batch_size = int(batch_size)
        self.grad_steps = grad_steps_per_iteration(cfg, self.num_envs)
        self.act_dim = trainer.act_dim

    def draw_inputs(self, generator: Optional[torch.Generator]) -> Dict[str, Any]:
        """The draws of one iteration: ``noise`` [T, E, act_dim] (standard
        normal), ``resets`` [T, E, ...], ``round_keys`` [8] and ``train``
        (the critic's and actor's noise, [G, B, act_dim] each)."""
        T, E = self.rollout_steps, self.num_envs
        noise = torch.randn((T, E, self.act_dim), generator=generator, device=self.device)
        resets = self.env.draw_resets(T, generator)
        round_keys = draw_round_keys(1, generator, self.device)[0]
        train = self.trainer.draw_noise(self.grad_steps, self.batch_size, generator)
        return {"noise": noise, "resets": resets, "round_keys": round_keys, "train": train}

    @torch.no_grad()
    def rollout(self, env_state: AutoResetState, obs: torch.Tensor, noise: torch.Tensor, resets: torch.Tensor):
        """``rollout_steps`` env steps acted by the actor's sample: the new env
        state and observation, the [T, E, ...] transitions and the summed
        stats [3] of the episodes that ended. No value is read back to the
        host."""
        actor = self.actor
        steps: Dict[str, list] = {k: [] for k in RING_ROW_KEYS}
        ends: Dict[str, list] = {"return": [], "length": [], "done": []}
        for t in range(self.rollout_steps):
            fobs = obs.to(torch.float32)
            mean, std = actor(fobs)
            actions, _ = squash_and_logprob(mean, std, noise[t], actor.action_scale, actor.action_bias)
            env_state, next_obs, reward, done, info = self.env.step(env_state, actions, resets[t])
            done_f = done.to(torch.float32)
            for k, v in (("observations", fobs), ("next_observations", info["terminal_observation"]),
                         ("actions", actions), ("rewards", reward[:, None]),
                         ("terminated", info["terminated"][:, None]), ("truncated", info["truncated"][:, None])):
                steps[k].append(v.to(torch.float32))
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

    def step(self, env_state: AutoResetState, obs: torch.Tensor, ring: Ring, inputs: Dict[str, Any], iter_num: int,
             clock: Optional[PhaseClock] = None) -> SACStepOutput:
        """One iteration: the rollout, the ring write and sample (``ring`` is
        written in place), then the G gradient steps. ``clock`` (of three
        phases) times the rollout, the ring and the train phase."""
        marks = [clock.mark()] if clock else []
        env_state, obs, traj, ep_stats = self.rollout(env_state, obs, inputs["noise"], inputs["resets"])
        if clock:
            marks.append(clock.mark())
        ring_write(ring, traj)
        batch = ring_sample(ring, inputs["round_keys"], self.batch_size, self.grad_steps)
        if clock:
            marks.append(clock.mark())
        losses = self.trainer.train_phase(batch, iter_num, inputs["train"])
        if clock:
            clock.add(*marks, clock.mark())
        return SACStepOutput(env_state, obs, ring, ep_stats, losses, traj, batch)


def check_sac_anakin_config(cfg) -> str:
    """The JAX loop's refusals; returns the one mlp key."""
    mlp_key = anakin_mlp_key(cfg)
    buffer_backend = str(cfg.buffer.get("backend", "local") or "local").lower()
    if buffer_backend != "device":
        raise ValueError(
            f"{cfg.algo.name} requires the device-resident replay ring: set "
            f"buffer.backend=device (got {buffer_backend!r}); a host replay buffer "
            "cannot live inside the fused program"
        )
    if int(cfg.algo.learning_starts) > 0:
        warnings.warn(
            f"{cfg.algo.name} ignores algo.learning_starts={cfg.algo.learning_starts}: the first "
            "fused iteration writes its whole rollout into the ring before sampling"
        )
    return mlp_key


def _replay_twin(state: Optional[Dict[str, Any]], capacity: int, num_envs: int):
    """The ring's host twin: the checkpoint's buffer (of either package) or
    an empty one of the ring's geometry."""
    from sheeprl_tpu_torch.data.buffers import ReplayBuffer
    from sheeprl_tpu_torch.data.device_ring import buffer_from_jax_state
    from sheeprl_tpu_torch.utils.checkpoint import InertObject

    if state is None or "rb" not in state:
        return ReplayBuffer(capacity, num_envs, memmap=False, obs_keys=("observations",))
    rb = state["rb"]
    if isinstance(rb, InertObject):
        rb = buffer_from_jax_state(rb.state)
    if (rb.buffer_size, rb.n_envs) != (capacity, num_envs):
        raise ValueError(
            f"the checkpoint's replay ring is {rb.buffer_size} rows x {rb.n_envs} envs, this run's "
            f"{capacity} x {num_envs}: resume with the same env.num_envs and buffer.size"
        )
    return rb


def run_sac_anakin(fabric, cfg: Dict[str, Any]) -> Dict[str, Any]:
    """The sac_anakin training loop; returns a summary of the run."""
    from sheeprl_tpu_torch.algos.sac.agent import build_agent
    from sheeprl_tpu_torch.algos.sac.sac import build_optimizers
    from sheeprl_tpu_torch.algos.sac.utils import test
    from sheeprl_tpu_torch.config import instantiate
    from sheeprl_tpu_torch.data.device_ring import ring_capacity, ring_init
    from sheeprl_tpu_torch.data.prefetch import make_replay_sampler
    from sheeprl_tpu_torch.envs import spaces
    from sheeprl_tpu_torch.envs.device import make_device_env
    from sheeprl_tpu_torch.resilience.monitor import build_resilience
    from sheeprl_tpu_torch.utils.checkpoint import load_checkpoint, write_run_checkpoint
    from sheeprl_tpu_torch.utils.logger import get_log_dir, get_logger
    from sheeprl_tpu_torch.utils.metric import MetricAggregator
    from sheeprl_tpu_torch.utils.timer import timer
    from sheeprl_tpu_torch.utils.utils import save_configs

    t_start = time.perf_counter()
    mlp_key = check_sac_anakin_config(cfg)
    device = fabric.device
    state = load_checkpoint(cfg.checkpoint.resume_from) if cfg.checkpoint.resume_from else None

    log_dir = get_log_dir(cfg)
    logger = get_logger(cfg, log_dir)
    print(f"Log dir: {log_dir}", flush=True)
    resilience = build_resilience(cfg, log_dir)

    num_envs = int(cfg.env.num_envs)
    capacity = ring_capacity(int(cfg.buffer.size) if not cfg.dry_run else num_envs, num_envs)
    env = make_device_env(cfg, num_envs, device)
    spec = env.spec
    if spec.action.kind != "continuous":
        raise ValueError(
            f"Only continuous action space is supported for the SAC agent (env {cfg.env.id!r} is "
            f"{spec.action.kind})"
        )
    observation_space = spaces.Dict({mlp_key: spec.to_obs_space()})
    action_space = spec.action.to_space()
    obs_dim = int(np.prod(spec.obs_shape))
    act_dim = int(np.prod(spec.action.shape))

    # counters (the JAX loop's, one process)
    policy_steps_per_iter = int(num_envs * cfg.algo.rollout_steps)
    total_iters = cfg.algo.total_steps // policy_steps_per_iter if not cfg.dry_run else 1
    start_iter = state["iter_num"] + 1 if state is not None else 1
    policy_step = state["iter_num"] * policy_steps_per_iter if state is not None else 0
    last_log = state["last_log"] if state is not None else 0
    last_checkpoint = state["last_checkpoint"] if state is not None else 0
    if state is not None:
        cfg.algo.per_rank_batch_size = state["batch_size"]
    batch_size = int(cfg.algo.per_rank_batch_size)
    if cfg.metric.log_level > 0 and cfg.metric.log_every % policy_steps_per_iter != 0:
        warnings.warn(
            f"The metric.log_every parameter ({cfg.metric.log_every}) is not a multiple of the "
            f"policy_steps_per_iter value ({policy_steps_per_iter})."
        )

    fabric.seed_everything(cfg.seed)
    agent = build_agent(fabric, cfg, observation_space, action_space, int(cfg.seed), state["agent"] if state else None)
    trainer = SACTrainer(agent, build_optimizers(cfg, agent), cfg, -float(act_dim), policy_steps_per_iter)
    if state is not None:
        trainer.load_opt_state(state["opt_state"])
    save_configs(cfg, log_dir)
    aggregator = None if MetricAggregator.disabled else instantiate(cfg.metric.aggregator)

    # the ring's host twin, snapshotted at checkpoint cadence; a resumed
    # twin lands on the card at once, cursor and fill intact
    rb = _replay_twin(state, capacity, num_envs)
    sampler = make_replay_sampler(
        rb,
        cfg.buffer.get("prefetch"),
        backend="device",
        sample_kwargs=dict(batch_size=batch_size, sample_next_obs=bool(cfg.buffer.sample_next_obs)),
        seed=int(cfg.seed),
        device=device,
    )
    if sampler.ring is None:
        sampler.ring = ring_init(capacity, num_envs, ring_row_specs(obs_dim, act_dim), device)

    program = SACAnakinProgram(trainer, env, cfg, batch_size)
    generator = torch.Generator(device=device).manual_seed(int(cfg.seed))
    env_state, obs = env.reset(generator)
    stats = torch.zeros(3, dtype=torch.float32, device=device)
    clock = PhaseClock(device, parts=3)
    seconds = [0.0, 0.0, 0.0]  # rollout, ring, train

    losses = None
    ckpt_path = None
    iter_num = start_iter - 1
    preempted = False
    for iter_num in range(start_iter, total_iters + 1):
        policy_step += policy_steps_per_iter
        out = program.step(env_state, obs, sampler.ring, program.draw_inputs(generator), iter_num, clock)
        env_state, obs, losses = out.env_state, out.obs, out.losses
        sampler.note_writes(program.rollout_steps)
        stats += out.ep_stats

        resilience.step(policy_step)
        if cfg.metric.log_level > 0 and (
            policy_step - last_log >= cfg.metric.log_every or iter_num == total_iters or cfg.dry_run
        ):
            with timer("Time/logging_time"):
                # the only device-to-host reads of the loop: a handful of scalars
                phase_s = clock.read()
                for i, (name, s) in enumerate(zip(("rollout", "ring", "train"), phase_s)):
                    seconds[i] += s
                    timer(f"Time/{name}_time").add(s)
                ep_return, ep_length, ep_count = stats.tolist()
                if aggregator is not None:
                    if ep_count > 0:
                        aggregator.update("Rewards/rew_avg", ep_return / ep_count)
                        aggregator.update("Game/ep_len_avg", ep_length / ep_count)
                    for name, value in zip(trainer.loss_names, losses.tolist()):
                        aggregator.update(name, value)
                stats.zero_()
                metrics_dict = aggregator.compute() if aggregator else {}
                if logger is not None:
                    logger.log_metrics(metrics_dict, policy_step)
                    if sum(phase_s) > 0:
                        logger.log_metrics(
                            {"Time/sps_env_interaction": (policy_step - last_log) / sum(phase_s)}, policy_step
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
                "iter_num": iter_num,
                "batch_size": batch_size,
                "last_log": last_log,
                "last_checkpoint": last_checkpoint,
            }
            ckpt_path = os.path.join(log_dir, "checkpoint", f"ckpt_{policy_step}_0.ckpt")
            with timer("Time/checkpoint_time"):
                write_run_checkpoint(
                    ckpt_path,
                    ckpt_state,
                    # the ring's snapshot (cursor and fill included), its newest
                    # row marked terminated and truncated in the file
                    replay_buffer=sampler.sync_to_host() if cfg.buffer.checkpoint else None,
                    keep_last=int(cfg.checkpoint.get("keep_last") or 0),
                )
            resilience.observe_checkpoint(ckpt_path, policy_step, preempted=preempted)
        if preempted:
            break

    for i, s in enumerate(clock.read()):
        seconds[i] += s
    sampler.close()
    test_reward = None
    preempted = resilience.finalize(policy_step)
    if not preempted and cfg.algo.run_test:
        with timer("Time/test_time"):
            test_reward = test(agent.actor, cfg, log_dir, logger)
    if logger is not None:
        logger.finalize()
    iterations = iter_num - start_iter + 1
    return {
        "log_dir": log_dir,
        "policy_steps": policy_step,
        "iterations": iterations,
        "grad_steps_per_iter": program.grad_steps,
        "gradient_steps": iterations * program.grad_steps,
        "rollout_seconds": seconds[0],
        "ring_seconds": seconds[1],
        "train_seconds": seconds[2],
        "wall_seconds": time.perf_counter() - t_start,
        "ring_pos": int(sampler.ring["pos"]),
        "ring_fill": int(sampler.ring["fill"]),
        "metrics": dict(zip(trainer.loss_names, losses.cpu().tolist())) if losses is not None else {},
        "test_reward": test_reward,
        "checkpoint": ckpt_path,
        "preempted": preempted,
    }

"""Dreamer-V3 training (port of ``sheeprl_tpu/algos/dreamer_v3/dreamer_v3.py``).

:class:`DV3Trainer` is the gradient step of ``make_train_phase``, eager: the
world-model loss over the posterior scan, then the actor loss over the
imagination rollout, then the critic loss, each followed by its own clipped
optimizer step, with the target critic's EMA before the step. Every random
draw is an argument (Gumbel noise for the categorical samples, normal noise
for continuous actions); :meth:`DV3Trainer.draw_noise` draws them from a
``torch.Generator``.

:func:`run_dreamer` is the training loop: a vector of envs stepped by
``PlayerDV3`` (random actions while the buffer prefills), one replay row per
env step plus a reset row for each finished episode, gradient steps paced by
``Ratio``, the metric log every ``metric.log_every`` policy steps,
checkpoints every ``checkpoint.every`` policy steps and at the end, and a
test episode. It runs on the card unless ``fabric.accelerator=cpu``.
"""

from __future__ import annotations

import os
import time
from typing import Any, Callable, Dict, List, Optional, Sequence

import numpy as np
import torch

from sheeprl_tpu_torch.algos.dreamer_v3.agent import (
    DV3Agent,
    PlayerDV3,
    actor_logprob_entropy,
    build_agent,
    draw_actor_noise,
    draw_gumbel,
)
from sheeprl_tpu_torch.algos.dreamer_v3.loss import reconstruction_loss
from sheeprl_tpu_torch.algos.dreamer_v3.utils import (
    init_moments,
    prepare_obs,
    test,
    update_moments,
)
from sheeprl_tpu_torch.config import instantiate
from sheeprl_tpu_torch.envs.spaces import env_actions
from sheeprl_tpu_torch.optim import clip_grad_global_norm_
from sheeprl_tpu_torch.resilience.faults import apply_armed_learn_fault
from sheeprl_tpu_torch.utils.distribution import (
    BernoulliSafeMode,
    Independent,
    MSEDistribution,
    SymlogDistribution,
    TwoHotEncodingDistribution,
    log_softmax,
)
from sheeprl_tpu_torch.utils.timer import timer
from sheeprl_tpu_torch.utils.utils import Ratio, compute_lambda_values, save_configs, weak_scalar

Batch = Dict[str, torch.Tensor]


def param_groups(agent: DV3Agent) -> Dict[str, List[torch.nn.Parameter]]:
    """The three parameter groups, each in the order its optimizer holds them:
    the world model (with the learnable initial recurrent state), the actor
    and the critic."""
    return {
        "world_model": [*agent.world_model.parameters(), agent.initial_recurrent_state],
        "actor": list(agent.actor.parameters()),
        "critic": list(agent.critic.parameters()),
    }


def build_optimizers(cfg, agent: DV3Agent) -> Dict[str, torch.optim.Optimizer]:
    """One optimizer per group from ``algo.<group>.optimizer``."""
    groups = param_groups(agent)
    return {
        name: instantiate(cfg.algo[name].optimizer, groups[name])
        for name in ("world_model", "actor", "critic")
    }


def _cat_entropy(logits: torch.Tensor, discrete: int) -> torch.Tensor:
    """Mean entropy of the [..., S, D] categorical stack of flat logits (the
    JAX metric's ``-sum(exp(lp) * lp)`` over both axes)."""
    lp = log_softmax(logits.reshape(*logits.shape[:-1], -1, discrete), dim=-1)
    return -torch.sum(torch.exp(lp) * lp, dim=(-2, -1)).mean()


class DreamerTrainer:
    """What the Dreamer trainers share: one optimizer per parameter group
    (``self.groups``, ``self.optimizers``, ``self.clips``), a group's clipped
    update from its gradients, ``G`` steps over a replay block, and the
    optimizer states in and out of checkpoints. A subclass defines
    ``draw_noise``, ``train_step``, ``agent_state`` and ``group_to_torch``."""

    # a trainer that holds the whole training state only at its train rounds
    # (the decoupled topology's channel) has run_dreamer postpone a checkpoint
    # due between rounds to the next round, or to close()
    defers_checkpoints = False

    def extra_state(self) -> Dict[str, Any]:
        """What the trainer adds to a checkpoint besides the agent and the
        optimizer states."""
        return {}

    def checkpoint_state(self) -> Dict[str, Any]:
        """The checkpoint's agent, optimizer states and extras."""
        return {"agent": self.agent_state(), "opt_state": self.opt_state(), **self.extra_state()}

    def close(self) -> Optional[Dict[str, Any]]:
        """The end of the run: a trainer that defers checkpoints returns its
        final :meth:`checkpoint_state` for a checkpoint still due; this one
        has nothing deferred."""
        return None

    def _apply(self, name: str, loss: torch.Tensor) -> torch.Tensor:
        """Gradients of ``loss`` for one group only, then :meth:`apply_grads`."""
        return self.apply_grads(name, torch.autograd.grad(loss, self.groups[name], allow_unused=True))

    def apply_grads(self, name: str, grads) -> torch.Tensor:
        """One group's update from its gradients (in group order): clipped,
        then its optimizer step. Returns the global norm before clipping."""
        params = self.groups[name]
        for p, g in zip(params, grads):
            p.grad = g
        norm = clip_grad_global_norm_(params, self.clips[name])
        self.optimizers[name].step()
        for p in params:
            p.grad = None
        return norm

    def train(self, data: Batch, cum_steps: int, generator: Optional[torch.Generator],
              want_full_state: bool = False) -> Dict[str, float]:
        """``G`` gradient steps over a [G, T, B, ...] block; returns the mean of
        each metric over them. ``want_full_state`` (a checkpoint is due) is
        for a trainer that defers checkpoints: this one always holds its
        whole state."""
        apply_armed_learn_fault(self.agent)  # resilience.fault=lr_spike: identity unless armed
        G, T, B = data["rewards"].shape[:3]
        all_metrics = []
        for g in range(G):
            batch = {k: v[g] for k, v in data.items()}
            all_metrics.append(self.train_step(batch, cum_steps + g, self.draw_noise(T, B, generator)))
        keys = sorted(all_metrics[0])
        means = torch.stack([torch.stack([m[k] for m in all_metrics]).float().mean() for k in keys]).cpu()
        return dict(zip(keys, means.tolist()))

    def opt_state(self) -> Dict[str, Any]:
        return {name: opt.state_dict() for name, opt in self.optimizers.items()}

    def load_opt_state(self, opt_state: Any) -> None:
        """Load the optimizer states of a checkpoint of either package: the
        port's torch state dicts, or the JAX package's optax states, converted
        (``interop/optax_to_torch.py``)."""
        from sheeprl_tpu_torch.interop.optax_to_torch import load_optimizer_state

        if not (isinstance(opt_state, dict) and set(opt_state) >= set(self.optimizers)):
            raise ValueError(
                f"the checkpoint's optimizer state should hold the groups {sorted(self.optimizers)}"
            )
        for name, opt in self.optimizers.items():
            load_optimizer_state(opt, opt_state[name], self.group_to_torch(name))


class DV3Trainer(DreamerTrainer):
    """Owns the optimizers and the Moments state, and takes gradient steps.

    At a bf16 compute dtype the losses are computed as the JAX step computes
    them (bf16 blocks, float32 where JAX promotes), the gradients land on the
    float32 parameters, and the optimizers, the global-norm clip and the
    target critic's EMA are the float32 ones.

    ``world_latent_hook(latents, noise) -> (head latents, extra loss, extra
    metrics)`` lets a fork map the latent the world model's heads read and add
    loss terms, as ``make_train_phase``'s hook of the same name does (Offline
    Dreamer's concept bottleneck); ``noise`` is the step's ``noise["hook"]``."""

    # Plan2Explore trains the continue head on detached latents
    continue_on_detached_latents = False

    def __init__(
        self,
        agent: DV3Agent,
        cfg,
        optimizers: Dict[str, torch.optim.Optimizer],
        world_latent_hook: Optional[Callable] = None,
    ):
        self.agent = agent
        self.world_latent_hook = world_latent_hook
        self.optimizers = optimizers
        self.groups = param_groups(agent)
        self.device = agent.initial_recurrent_state.device
        self.moments = init_moments(self.device)
        self.cnn_keys = tuple(cfg.algo.cnn_keys.encoder)
        self.mlp_keys = tuple(cfg.algo.mlp_keys.encoder)
        self.cnn_dec_keys = tuple(cfg.algo.cnn_keys.decoder)
        self.mlp_dec_keys = tuple(cfg.algo.mlp_keys.decoder)
        self.wm_cfg = cfg.algo.world_model
        self.gamma = float(cfg.algo.gamma)
        self.lmbda = float(cfg.algo.lmbda)
        self.horizon = int(cfg.algo.horizon)
        self.ent_coef = float(cfg.algo.actor.ent_coef)
        self.tau = float(cfg.algo.critic.tau)
        self.target_freq = int(cfg.algo.critic.per_rank_target_network_update_freq)
        self.moments_kw = dict(
            decay=float(cfg.algo.actor.moments.decay),
            maximum=float(cfg.algo.actor.moments.max),
            percentile_low=float(cfg.algo.actor.moments.percentile.low),
            percentile_high=float(cfg.algo.actor.moments.percentile.high),
        )
        self.clips = {
            "world_model": float(cfg.algo.world_model.clip_gradients or 0),
            "actor": float(cfg.algo.actor.clip_gradients or 0),
            "critic": float(cfg.algo.critic.clip_gradients or 0),
        }

    # -- noise ---------------------------------------------------------------------
    def draw_noise(self, T: int, B: int, generator: Optional[torch.Generator]) -> Dict[str, torch.Tensor]:
        """Every random draw of one gradient step: the posterior samples'
        Gumbel noise [T, B, S*D], the imagined prior samples' [horizon, T*B,
        S*D] and the imagined actions' [horizon + 1, T*B, A]."""
        agent, N = self.agent, T * B
        dtype = agent.dtype
        return {
            "posterior": draw_gumbel((T, B, agent.stoch_state_size), generator, self.device, dtype),
            "transition": draw_gumbel((self.horizon, N, agent.stoch_state_size), generator, self.device, dtype),
            "action": draw_actor_noise(agent, (self.horizon + 1, N), generator, self.device),
        }

    # -- losses --------------------------------------------------------------------
    def world_loss(self, batch: Batch, gumbel: torch.Tensor, hook_noise: Any = None):
        """Returns (loss, (posteriors, recurrent states, metrics))."""
        agent, wm = self.agent, self.agent.world_model
        batch_obs = {k: batch[k] / 255.0 - 0.5 for k in self.cnn_keys}
        batch_obs.update({k: batch[k] for k in self.mlp_keys})
        is_first = batch["is_first"].clone()
        is_first[0] = 1.0
        # a_t stored with o_t is the action leaving o_t; the dynamics take the
        # action that led to o_t
        actions = torch.cat([torch.zeros_like(batch["actions"][:1]), batch["actions"][:-1]], dim=0)
        embedded = agent.encoder(batch_obs)
        hs, zs, post_logits, prior_logits = agent.dynamic_scan(embedded, actions, is_first, gumbel)
        latents = torch.cat([zs, hs], dim=-1)
        extra_loss, extra_metrics = None, {}
        if self.world_latent_hook is not None:
            latents, extra_loss, extra_metrics = self.world_latent_hook(latents, hook_noise)
        recon = wm["observation_model"](latents)
        obs_lps = {
            k: MSEDistribution(recon[k], dims=len(recon[k].shape[2:])).log_prob(batch_obs[k])
            for k in self.cnn_dec_keys
        }
        obs_lps.update(
            {
                k: SymlogDistribution(recon[k], dims=len(recon[k].shape[2:])).log_prob(batch_obs[k])
                for k in self.mlp_dec_keys
            }
        )
        reward_lp = TwoHotEncodingDistribution(wm["reward_model"](latents), dims=1).log_prob(batch["rewards"])
        cont_in = latents.detach() if self.continue_on_detached_latents else latents
        cont_lp = Independent(BernoulliSafeMode(logits=wm["continue_model"](cont_in)), 1).log_prob(
            1.0 - batch["terminated"]
        )
        wm_cfg = self.wm_cfg
        loss, kl, state_loss, reward_loss, observation_loss, continue_loss = reconstruction_loss(
            obs_lps,
            reward_lp,
            prior_logits,
            post_logits,
            agent.discrete_size,
            kl_dynamic=wm_cfg.kl_dynamic,
            kl_representation=wm_cfg.kl_representation,
            kl_free_nats=wm_cfg.kl_free_nats,
            kl_regularizer=wm_cfg.kl_regularizer,
            continue_log_prob=cont_lp,
            continue_scale_factor=wm_cfg.continue_scale_factor,
        )
        if extra_loss is not None:
            loss = loss + extra_loss
        metrics = {
            "Loss/world_model_loss": loss,
            "Loss/observation_loss": observation_loss,
            "Loss/reward_loss": reward_loss,
            "Loss/state_loss": state_loss,
            "Loss/continue_loss": continue_loss,
            "State/kl": kl,
            "State/post_entropy": _cat_entropy(post_logits.detach(), agent.discrete_size),
            "State/prior_entropy": _cat_entropy(prior_logits.detach(), agent.discrete_size),
            **extra_metrics,
        }
        return loss, (zs, hs, metrics)

    def actor_loss(
        self,
        zs: torch.Tensor,
        hs: torch.Tensor,
        true_continue: torch.Tensor,
        transition_noise: torch.Tensor,
        action_noise: torch.Tensor,
        moments: Optional[Dict[str, torch.Tensor]] = None,
    ):
        """Returns (policy loss, (latents, λ-values, discount, new Moments)),
        normalizing with ``moments`` (``self.moments`` by default)."""
        agent, wm = self.agent, self.agent.world_model
        z0 = zs.detach().reshape(-1, agent.stoch_state_size)
        h0 = hs.detach().reshape(-1, agent.recurrent_state_size)
        # discrete actions learn by REINFORCE on a detached advantage: nothing of
        # the rollout is differentiated, so it runs without a graph; continuous
        # ones learn through the dynamics (pathwise) and keep it
        with torch.set_grad_enabled(torch.is_grad_enabled() and agent.is_continuous):
            latents, actions = agent.imagination_scan(z0, h0, self.horizon, transition_noise, action_noise)
        predicted_values = TwoHotEncodingDistribution(agent.critic(latents), dims=1).mean
        predicted_rewards = TwoHotEncodingDistribution(wm["reward_model"](latents), dims=1).mean
        continues = Independent(BernoulliSafeMode(logits=wm["continue_model"](latents)), 1).mode
        continues = torch.cat([true_continue[None], continues[1:]], dim=0)
        lambda_values = compute_lambda_values(
            predicted_rewards[1:], predicted_values[1:], continues[1:] * self.gamma, self.lmbda
        )
        discount = (torch.cumprod(continues * self.gamma, dim=0) / self.gamma).detach()

        moments = self.moments if moments is None else moments
        offset, invscale, new_moments = update_moments(moments, lambda_values, **self.moments_kw)
        # the 0-d float32 Moments promote a bf16 baseline to float32 in JAX;
        # torch would keep bf16 for a 0-d operand, so the cast is written out
        baseline = predicted_values[:-1].float()
        advantage = (lambda_values - offset) / invscale - (baseline - offset) / invscale
        pre = agent.actor(latents.detach())
        lp, ent = actor_logprob_entropy(agent, pre, actions.detach())
        objective = advantage if agent.is_continuous else lp[:-1] * advantage.detach()
        entropy = weak_scalar(self.ent_coef, ent.dtype) * ent[..., None]
        policy_loss = -torch.mean(discount[:-1] * (objective + entropy[:-1]))
        return policy_loss, (latents, lambda_values, discount, new_moments)

    def critic_loss(
        self,
        latents: torch.Tensor,
        lambda_values: torch.Tensor,
        discount: torch.Tensor,
        critic: Optional[torch.nn.Module] = None,
        target: Optional[torch.nn.Module] = None,
    ):
        """The two-hot critic loss of ``critic`` against the λ-values and its
        ``target``'s values (the agent's critic and target critic by default)."""
        critic = self.agent.critic if critic is None else critic
        target = self.agent.target_critic if target is None else target
        qv = TwoHotEncodingDistribution(critic(latents[:-1]), dims=1)
        with torch.no_grad():
            target_values = TwoHotEncodingDistribution(target(latents[:-1]), dims=1).mean
        value_loss = -qv.log_prob(lambda_values.detach())
        value_loss = value_loss - qv.log_prob(target_values)
        return torch.mean(value_loss * discount[:-1].squeeze(-1))

    # -- the step ------------------------------------------------------------------
    def target_pairs(self) -> List[tuple]:
        """(target, critic) module pairs that :meth:`update_target_critic` moves."""
        return [(self.agent.target_critic, self.agent.critic)]

    @torch.no_grad()
    def update_target_critic(self, cum: int) -> None:
        """EMA of each critic into its target, before the step, every
        ``per_rank_target_network_update_freq`` steps; a plain copy at step 0."""
        if cum % self.target_freq != 0:
            return
        tau = 1.0 if cum == 0 else self.tau
        for target, critic in self.target_pairs():
            for t, c in zip(target.parameters(), critic.parameters()):
                t.copy_(tau * c + (1 - tau) * t)

    def train_step(self, batch: Batch, cum: int, noise: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        """One gradient step on a [T, B, ...] batch: world model, then actor,
        then critic. Returns the step's metrics as 0-d tensors."""
        self.update_target_critic(cum)
        w_loss, (zs, hs, metrics) = self.world_loss(batch, noise["posterior"], noise.get("hook"))
        metrics["Grads/world_model"] = self._apply("world_model", w_loss)

        true_continue = (1 - batch["terminated"]).reshape(-1, 1)
        a_loss, (latents, lambda_values, discount, new_moments) = self.actor_loss(
            zs, hs, true_continue, noise["transition"], noise["action"]
        )
        metrics["Grads/actor"] = self._apply("actor", a_loss)
        self.moments = new_moments

        c_loss = self.critic_loss(latents.detach(), lambda_values.detach(), discount)
        metrics["Grads/critic"] = self._apply("critic", c_loss)
        metrics["Loss/policy_loss"] = a_loss.detach()
        metrics["Loss/value_loss"] = c_loss.detach()
        return {k: v.detach() for k, v in metrics.items()}

    # -- checkpoint state ----------------------------------------------------------
    def agent_state(self) -> Dict[str, Any]:
        """The agent's parameters in the JAX package's layout (a checkpoint's ``agent``)."""
        from sheeprl_tpu_torch.interop.flax_to_torch import agent_to_flax

        return agent_to_flax(self.agent)

    def load_moments(self, tree: Any) -> None:
        """A checkpoint's Moments (numpy or tensor leaves, nested dicts) onto the device."""

        def walk(node):
            if isinstance(node, dict):
                return {k: walk(v) for k, v in node.items()}
            return torch.as_tensor(np.array(node), device=self.device)

        self.moments = walk(tree)

    def extra_state(self) -> Dict[str, Any]:
        return {"moments": self.moments}

    def group_to_torch(self, name: str):
        from sheeprl_tpu_torch.interop.flax_to_torch import dv3_group_to_torch

        return dv3_group_to_torch(self.agent, name)


def _one_hot_actions(actions: np.ndarray, actions_dim: Sequence[int], num_envs: int) -> np.ndarray:
    """[num_envs] or [num_envs, dims] indices -> one one-hot block per dim."""
    per_dim = actions.reshape(num_envs, len(actions_dim)).T
    return np.concatenate(
        [np.eye(dim, dtype=np.float32)[act] for act, dim in zip(per_dim, actions_dim)], axis=-1
    )


def run_dreamer(
    fabric,
    cfg: Dict[str, Any],
    *,
    build_agent_fn: Optional[Callable] = None,
    player_cls: Optional[Callable] = None,
    make_trainer: Optional[Callable] = None,
    finetuning: bool = False,
    exploration_state: Optional[Dict[str, Any]] = None,
    dv3_loop: bool = True,
    make_buffer: Optional[Callable] = None,
    expl_amount: Optional[Callable[[int], float]] = None,
    prefill_actor: Optional[Any] = None,
) -> Dict[str, Any]:
    """The Dreamer-V3 training loop. Returns a summary of the run: policy and
    gradient steps, the player's batched calls, seconds spent stepping envs
    and training, the steady-state window (the policy steps, gradient steps
    and seconds from the first iteration after learning starts to the loop's
    end, without checkpoint writes), the last metrics, the test reward and the
    last checkpoint's path.

    The forks with this loop's shape inject their pieces, as they do into the
    JAX package's ``run_dreamer``: ``build_agent_fn`` (``build_agent``'s
    signature), ``player_cls(agent, num_envs, cnn_keys, mlp_keys)`` and
    ``make_trainer(agent, cfg)`` (a :class:`DV3Trainer` or a subclass; the
    trainer also writes the checkpoint's agent and Moments; a trainer that
    ``defers_checkpoints``, as the decoupled topology's does, holds the whole
    training state only at its train rounds, so a checkpoint due between
    rounds waits for the next one, or for the final state ``close()``
    returns). ``finetuning``
    (Plan2Explore's second phase) has the player act from the first iteration,
    with no random prefill, and switch to ``agent.actor`` (the task actor) once
    learning starts; ``exploration_state`` is the exploration checkpoint the
    agent comes from when the run is not resumed, and the replay buffer too
    with ``buffer.load_from_exploration``.

    The Dreamer-V1/V2 loops are this one with ``dv3_loop=False`` (frame_stack
    1 and none of the Dreamer-V3 loop's screen-size and key checks, as the
    JAX loops): ``make_buffer(cfg, buffer_size, num_envs, obs_keys,
    memmap_dir)`` builds their replay buffer (sequential or episodes),
    ``expl_amount(policy_step)`` is the exploration noise's amount the player
    adds, and ``prefill_actor`` the actor the player acts with while
    learning has not started (``exploration_actor_params`` of the JAX
    Dreamer-V2 loop): a module, or a function of the built agent that
    returns one."""
    from sheeprl_tpu_torch.data.buffers import EnvIndependentReplayBuffer, SequentialReplayBuffer
    from sheeprl_tpu_torch.data.prefetch import sample_to_device
    from sheeprl_tpu_torch.envs.spaces import action_space_dims
    from sheeprl_tpu_torch.envs.vector import SyncVectorEnv, episode_stats
    from sheeprl_tpu_torch.resilience.monitor import build_resilience
    from sheeprl_tpu_torch.utils.checkpoint import InertObject, load_checkpoint, load_run_buffer, write_run_checkpoint
    from sheeprl_tpu_torch.utils.env import make_env
    from sheeprl_tpu_torch.utils.logger import get_log_dir, get_logger
    from sheeprl_tpu_torch.utils.metric import MetricAggregator

    t_start = time.perf_counter()
    device = fabric.device
    state = load_checkpoint(cfg.checkpoint.resume_from) if cfg.checkpoint.resume_from else None

    # these cannot be changed
    cfg.env.frame_stack = -1 if dv3_loop else 1
    if dv3_loop and 2 ** int(np.log2(cfg.env.screen_size)) != cfg.env.screen_size:
        raise ValueError(f"The screen size must be a power of 2, got: {cfg.env.screen_size}")

    log_dir = get_log_dir(cfg)
    logger = get_logger(cfg, log_dir)
    print(f"Log dir: {log_dir}", flush=True)
    resilience = build_resilience(cfg, log_dir)

    num_envs = int(cfg.env.num_envs)
    envs = SyncVectorEnv(
        [
            make_env(cfg, cfg.seed + i, 0, log_dir, "train", vector_env_idx=i)
            for i in range(num_envs)
        ]
    )
    actions_dim, is_continuous = action_space_dims(envs.single_action_space)
    observation_space = envs.single_observation_space
    clip_rewards_fn = (lambda r: np.tanh(r)) if cfg.env.clip_rewards else (lambda r: r)
    cnn_keys = list(cfg.algo.cnn_keys.encoder)
    mlp_keys = list(cfg.algo.mlp_keys.encoder)
    if dv3_loop and (
        len(set(cnn_keys).intersection(set(cfg.algo.cnn_keys.decoder))) == 0
        and len(set(mlp_keys).intersection(set(cfg.algo.mlp_keys.decoder))) == 0
    ):
        raise RuntimeError("The CNN keys or the MLP keys of the encoder and decoder must not be disjointed")
    if dv3_loop and len(set(cfg.algo.cnn_keys.decoder) - set(cnn_keys)) > 0:
        raise RuntimeError(
            "The CNN keys of the decoder must be contained in the encoder ones. "
            f"Those keys are decoded without being encoded: {list(set(cfg.algo.cnn_keys.decoder))}"
        )
    if dv3_loop and len(set(cfg.algo.mlp_keys.decoder) - set(mlp_keys)) > 0:
        raise RuntimeError(
            "The MLP keys of the decoder must be contained in the encoder ones. "
            f"Those keys are decoded without being encoded: {list(set(cfg.algo.mlp_keys.decoder))}"
        )
    obs_keys = cnn_keys + mlp_keys

    fabric.seed_everything(cfg.seed)
    source = state if state is not None else exploration_state
    agent = (build_agent_fn or build_agent)(
        fabric, actions_dim, is_continuous, cfg, observation_space, cfg.seed, source["agent"] if source else None
    )
    if make_trainer is None:
        trainer = DV3Trainer(agent, cfg, build_optimizers(cfg, agent))
    else:
        trainer = make_trainer(agent, cfg)
    # a decoupled trainer hands the player its own copy of the agent
    player = (player_cls or PlayerDV3)(getattr(trainer, "act_agent", agent), num_envs, cnn_keys, mlp_keys)
    if prefill_actor is not None and not isinstance(prefill_actor, torch.nn.Module):
        prefill_actor = prefill_actor(agent)
    if state is not None and "opt_state" in state:
        trainer.load_opt_state(state["opt_state"])
    if state is not None and "moments" in state:
        trainer.load_moments(state["moments"])
    save_configs(cfg, log_dir)
    aggregator = None if MetricAggregator.disabled else instantiate(cfg.metric.aggregator)

    buffer_size = cfg.buffer.size // num_envs if not cfg.dry_run else 8
    if cfg.dry_run:
        # a dry run's one iteration writes one row per env, so its gradient
        # steps sample sequences of that one row (the JAX loop would ask for
        # the configured length and fail)
        cfg.algo.per_rank_sequence_length = 1
    memmap_dir = os.path.join(log_dir, "memmap_buffer", "rank_0")
    if make_buffer is not None:
        rb = make_buffer(cfg, buffer_size, num_envs, tuple(obs_keys), memmap_dir)
    else:
        rb = EnvIndependentReplayBuffer(
            buffer_size,
            n_envs=num_envs,
            obs_keys=tuple(obs_keys),
            memmap=cfg.buffer.memmap,
            memmap_dir=memmap_dir,
            buffer_cls=SequentialReplayBuffer,
        )
    rb_source = state
    if finetuning and state is None and cfg.buffer.get("load_from_exploration", False):
        rb_source = exploration_state
    if rb_source is not None and "rb" in rb_source:
        if isinstance(rb_source["rb"], InertObject):
            raise NotImplementedError(
                "the checkpoint holds a replay buffer of the JAX package: loading it is not yet ported "
                "to sheeprl_tpu_torch (resume from a checkpoint written with buffer.checkpoint=False)"
            )
        rb = load_run_buffer(rb_source)
    else:
        rb.seed(int(cfg.seed))

    # counters
    start_iter = state["iter_num"] + 1 if state is not None else 1
    policy_step = state["iter_num"] * num_envs if state is not None else 0
    last_checkpoint = state["last_checkpoint"] if state is not None else 0
    last_log = state["last_log"] if state is not None else 0
    policy_steps_per_iter = num_envs
    total_iters = cfg.algo.total_steps // policy_steps_per_iter if not cfg.dry_run else 1
    learning_starts = cfg.algo.learning_starts // policy_steps_per_iter if not cfg.dry_run else 0
    prefill_steps = learning_starts - int(learning_starts > 0)
    if state is not None:
        cfg.algo.per_rank_batch_size = state["batch_size"]
        learning_starts += start_iter
        prefill_steps += start_iter

    ratio = Ratio(cfg.algo.replay_ratio, pretrain_steps=cfg.algo.per_rank_pretrain_steps)
    if state is not None and "ratio" in state:
        ratio.load_state_dict(state["ratio"])

    # first observation
    step_data: Dict[str, np.ndarray] = {}
    obs = envs.reset(seed=cfg.seed)[0]
    for k in obs_keys:
        step_data[k] = np.asarray(obs[k])[np.newaxis]
    step_data["rewards"] = np.zeros((1, num_envs, 1), np.float32)
    step_data["truncated"] = np.zeros((1, num_envs, 1), np.float32)
    step_data["terminated"] = np.zeros((1, num_envs, 1), np.float32)
    step_data["is_first"] = np.ones_like(step_data["terminated"])
    player.init_states()

    generator = torch.Generator(device).manual_seed(int(cfg.seed))
    action_rng = np.random.default_rng(int(cfg.seed))
    cumulative_per_rank_gradient_steps = 0
    train_step = last_train = 0
    player_calls = 0
    act_dim = int(np.sum(actions_dim))
    pending_ckpt = False
    ckpt_path = None
    metrics: Dict[str, float] = {}
    env_seconds = train_seconds = 0.0
    iter_num = start_iter - 1
    # the steady-state window: from the first iteration after learning starts
    # to the loop's end, with checkpoint writes left out
    window_t0 = None
    window_policy_step = window_gradient_step = 0
    window_ckpt_seconds = 0.0
    actor_switch = None
    preempted = False

    for iter_num in range(start_iter, total_iters + 1):
        if window_t0 is None and iter_num > learning_starts:
            window_t0 = time.perf_counter()
            window_policy_step, window_gradient_step = policy_step, cumulative_per_rank_gradient_steps
        policy_step += policy_steps_per_iter
        t0 = time.perf_counter()
        with timer("Time/env_interaction_time"):
            if iter_num <= learning_starts and state is None and not finetuning:
                actions = np.stack([envs.single_action_space.sample(action_rng) for _ in range(num_envs)])
                real_actions = actions
                if not is_continuous:
                    actions = _one_hot_actions(actions, actions_dim, num_envs)
            else:
                jobs = prepare_obs(obs, cnn_keys=cnn_keys, mlp_keys=mlp_keys, num_envs=num_envs, device=device)
                if prefill_actor is not None:
                    player.actor = prefill_actor if iter_num <= learning_starts else player.agent.actor
                kwargs = {} if expl_amount is None else {"expl_amount": expl_amount(policy_step)}
                actions = player.get_actions(jobs, generator=generator, **kwargs).cpu().numpy()
                player_calls += 1
                real_actions = env_actions(actions, actions_dim, is_continuous)

            step_data["actions"] = actions.reshape((1, num_envs, -1)).astype(np.float32)
            rb.add(step_data, validate_args=cfg.buffer.validate_args)

            next_obs, rewards, terminated, truncated, infos = envs.step(real_actions.reshape(envs.action_space.shape))
            dones = np.logical_or(terminated, truncated).astype(np.uint8)
            step_data["is_first"] = np.zeros_like(step_data["terminated"])

            # the real next observations of finished episodes
            real_next_obs = {k: np.asarray(next_obs[k]).copy() for k in obs_keys}
            final_obs = infos.get("final_obs")
            if final_obs is not None:
                for idx in range(num_envs):
                    if final_obs[idx] is not None:
                        for k in obs_keys:
                            real_next_obs[k][idx] = np.asarray(final_obs[idx][k])

            for k in obs_keys:
                step_data[k] = np.asarray(next_obs[k])[np.newaxis]
            obs = next_obs

            rewards = np.asarray(rewards, dtype=np.float32).reshape((1, num_envs, -1))
            step_data["terminated"] = np.asarray(terminated, np.float32).reshape((1, num_envs, -1))
            step_data["truncated"] = np.asarray(truncated, np.float32).reshape((1, num_envs, -1))
            step_data["rewards"] = clip_rewards_fn(rewards)

            dones_idxes = dones.nonzero()[0].tolist()
            reset_envs = len(dones_idxes)
            if reset_envs > 0:
                reset_data = {k: (real_next_obs[k][dones_idxes])[np.newaxis] for k in obs_keys}
                reset_data["terminated"] = step_data["terminated"][:, dones_idxes]
                reset_data["truncated"] = step_data["truncated"][:, dones_idxes]
                reset_data["actions"] = np.zeros((1, reset_envs, act_dim), np.float32)
                reset_data["rewards"] = step_data["rewards"][:, dones_idxes]
                reset_data["is_first"] = np.zeros_like(reset_data["terminated"])
                rb.add(reset_data, dones_idxes, validate_args=cfg.buffer.validate_args)
                # the reset rows restart the episode in the live step_data
                step_data["rewards"][:, dones_idxes] = 0.0
                step_data["terminated"][:, dones_idxes] = 0.0
                step_data["truncated"][:, dones_idxes] = 0.0
                step_data["is_first"][:, dones_idxes] = 1.0
                player.init_states(dones_idxes)
            rews, lens = episode_stats(infos, num_envs)
            if len(rews) > 0 and aggregator is not None:
                aggregator.update("Rewards/rew_avg", float(np.mean(rews)))
                aggregator.update("Game/ep_len_avg", float(np.mean(lens)))
        env_seconds += time.perf_counter() - t0

        preempted = resilience.preempt_requested()
        # computed before the train round, so that a trainer that defers
        # checkpoints ships its whole state with the round
        pending_ckpt = pending_ckpt or preempted or (
            (cfg.checkpoint.every > 0 and policy_step - last_checkpoint >= cfg.checkpoint.every)
            or cfg.dry_run
            or (iter_num == total_iters and cfg.checkpoint.save_last)
        )
        trained_this_iter = False

        if iter_num >= learning_starts:
            if finetuning and player.actor is not player.agent.actor:
                # the prefill over, the player acts with the task actor
                player.actor = player.agent.actor
                actor_switch = {"iteration": iter_num, "player_calls_before": player_calls}
            per_rank_gradient_steps = ratio(policy_step - prefill_steps * policy_steps_per_iter)
            if per_rank_gradient_steps > 0:
                t0 = time.perf_counter()
                # DV3Trainer.train ends with the host copy of the metrics,
                # which waits for the card: the timer ends there
                with timer("Time/train_time"):
                    data = sample_to_device(
                        rb,
                        per_rank_gradient_steps,
                        batch_size=cfg.algo.per_rank_batch_size,
                        sequence_length=cfg.algo.per_rank_sequence_length,
                        uint8_keys=cnn_keys,
                        # a decoupled learner process takes host blocks
                        device=getattr(trainer, "data_device", None) or device,
                    )
                    metrics = trainer.train(data, cumulative_per_rank_gradient_steps, generator,
                                            want_full_state=pending_ckpt)
                    trained_this_iter = True
                    cumulative_per_rank_gradient_steps += per_rank_gradient_steps
                    train_step += per_rank_gradient_steps
                    if aggregator is not None:
                        for name, value in metrics.items():
                            aggregator.update(name, value)
                train_seconds += time.perf_counter() - t0

        resilience.step(policy_step)
        if cfg.metric.log_level > 0 and (
            policy_step - last_log >= cfg.metric.log_every or iter_num == total_iters or cfg.dry_run
        ):
            with timer("Time/logging_time"):
                metrics_dict = aggregator.compute() if aggregator else {}
                if logger is not None:
                    logger.log_metrics(metrics_dict, policy_step)
                    if policy_step > 0:
                        logger.log_metrics(
                            {"Params/replay_ratio": cumulative_per_rank_gradient_steps / max(policy_step, 1)},
                            policy_step,
                        )
                    timers = timer.to_dict(reset=False)
                    if timers.get("Time/train_time", 0) > 0:
                        logger.log_metrics(
                            {"Time/sps_train": (train_step - last_train) / max(timers["Time/train_time"], 1e-9)},
                            policy_step,
                        )
                    if timers.get("Time/env_interaction_time", 0) > 0:
                        logger.log_metrics(
                            {
                                "Time/sps_env_interaction": ((policy_step - last_log) * cfg.env.action_repeat)
                                / max(timers["Time/env_interaction_time"], 1e-9)
                            },
                            policy_step,
                        )
                timer.to_dict(reset=True)
                if aggregator:
                    aggregator.reset()
            last_log = policy_step
            last_train = train_step

        if pending_ckpt and (not trainer.defers_checkpoints or trained_this_iter):
            last_checkpoint = policy_step
            pending_ckpt = False
            ckpt_state = {
                **trainer.checkpoint_state(),
                "ratio": ratio.state_dict(),
                "iter_num": iter_num,
                "batch_size": cfg.algo.per_rank_batch_size,
                "last_log": last_log,
                "last_checkpoint": last_checkpoint,
            }
            ckpt_path = os.path.join(log_dir, "checkpoint", f"ckpt_{policy_step}_0.ckpt")
            t0 = time.perf_counter()
            write_run_checkpoint(
                ckpt_path,
                ckpt_state,
                replay_buffer=rb if cfg.buffer.checkpoint else None,
                keep_last=int(cfg.checkpoint.get("keep_last") or 0),
            )
            if window_t0 is not None:
                window_ckpt_seconds += time.perf_counter() - t0
            resilience.observe_checkpoint(ckpt_path, policy_step, preempted=preempted)
        if preempted:
            break

    window_seconds = time.perf_counter() - window_t0 - window_ckpt_seconds if window_t0 is not None else 0.0
    final_state = trainer.close()
    if pending_ckpt and final_state is not None:
        # the deferred last checkpoint, from the state the trainer ended with
        ckpt_state = {
            **final_state,
            "ratio": ratio.state_dict(),
            # iter_num, not total_iters: a preempted run flushes here before its end
            "iter_num": iter_num,
            "batch_size": cfg.algo.per_rank_batch_size,
            "last_log": last_log,
            "last_checkpoint": policy_step,
        }
        ckpt_path = os.path.join(log_dir, "checkpoint", f"ckpt_{policy_step}_0.ckpt")
        write_run_checkpoint(
            ckpt_path,
            ckpt_state,
            replay_buffer=rb if cfg.buffer.checkpoint else None,
            keep_last=int(cfg.checkpoint.get("keep_last") or 0),
        )
        resilience.observe_checkpoint(ckpt_path, policy_step, preempted=preempted)
    envs.close()
    test_reward = None
    calls_before_test = player.calls
    preempted = resilience.finalize(policy_step)
    if not preempted and cfg.algo.run_test:
        test_reward = test(player, cfg, log_dir, greedy=False, logger=logger)
    if logger is not None:
        logger.finalize()
    return {
        "log_dir": log_dir,
        "policy_steps": policy_step,
        "iterations": iter_num - start_iter + 1,
        "gradient_steps": cumulative_per_rank_gradient_steps,
        "player_calls": player_calls,
        "test_player_calls": player.calls - calls_before_test,
        "env_seconds": env_seconds,
        "train_seconds": train_seconds,
        "wall_seconds": time.perf_counter() - t_start,
        "steady_policy_steps": policy_step - window_policy_step if window_t0 is not None else 0,
        "steady_gradient_steps": cumulative_per_rank_gradient_steps - window_gradient_step,
        "steady_seconds": window_seconds,
        "metrics": metrics,
        "test_reward": test_reward,
        "checkpoint": ckpt_path,
        "preempted": preempted,
        **({"actor_switch": actor_switch} if finetuning else {}),
    }


def main(fabric, cfg: Dict[str, Any]) -> Dict[str, Any]:
    return run_dreamer(fabric, cfg)

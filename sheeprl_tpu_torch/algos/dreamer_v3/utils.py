"""Dreamer-V3 support (port of ``sheeprl_tpu/algos/dreamer_v3/utils.py``): the
metric keys, the Moments return normalizer, observation preparation and the
test rollout."""

from __future__ import annotations

from typing import Any, Dict, Sequence, Tuple

import numpy as np
import torch

from sheeprl_tpu_torch.envs.spaces import env_actions

AGGREGATOR_KEYS = {
    "Rewards/rew_avg",
    "Game/ep_len_avg",
    "Loss/world_model_loss",
    "Loss/value_loss",
    "Loss/policy_loss",
    "Loss/observation_loss",
    "Loss/reward_loss",
    "Loss/state_loss",
    "Loss/continue_loss",
    "State/kl",
    "State/post_entropy",
    "State/prior_entropy",
    "Grads/world_model",
    "Grads/actor",
    "Grads/critic",
}


def init_moments(device: Any = "cpu") -> Dict[str, torch.Tensor]:
    return {"low": torch.zeros((), device=device), "high": torch.zeros((), device=device)}


def update_moments(
    state: Dict[str, torch.Tensor],
    x: torch.Tensor,
    decay: float = 0.99,
    maximum: float = 1.0,
    percentile_low: float = 0.05,
    percentile_high: float = 0.95,
) -> Tuple[torch.Tensor, torch.Tensor, Dict[str, torch.Tensor]]:
    """Percentile-EMA return normalizer; the quantiles interpolate linearly, as
    ``jnp.quantile`` does. Returns (offset, invscale, new_state)."""
    x = x.detach().float().reshape(-1)
    low = torch.quantile(x, percentile_low)
    high = torch.quantile(x, percentile_high)
    new_low = decay * state["low"] + (1 - decay) * low
    new_high = decay * state["high"] + (1 - decay) * high
    invscale = torch.clamp(new_high - new_low, min=1.0 / maximum)
    return new_low, invscale, {"low": new_low, "high": new_high}


def prepare_obs(
    obs: Dict[str, np.ndarray],
    *,
    cnn_keys: Sequence[str] = (),
    mlp_keys: Sequence[str] = (),
    num_envs: int = 1,
    device: Any = "cpu",
) -> Dict[str, torch.Tensor]:
    """Env observations as float32 tensors on ``device``: frame stacks fold into
    channels and pixels map to [-0.5, 0.5]; vectors flatten per env."""
    out: Dict[str, torch.Tensor] = {}
    for k in cnn_keys:
        v = torch.from_numpy(np.asarray(obs[k])).to(device).float()
        out[k] = v.reshape(num_envs, -1, *v.shape[-2:]) / 255.0 - 0.5
    for k in mlp_keys:
        v = torch.from_numpy(np.asarray(obs[k], dtype=np.float32)).to(device)
        out[k] = v.reshape(num_envs, -1)
    return out


def test(
    player,
    cfg: Dict[str, Any],
    log_dir: str,
    test_name: str = "",
    greedy: bool = True,
    logger: Any = None,
) -> float:
    """Play one episode with the player's current weights; returns its reward
    and logs it as ``Test/cumulative_reward`` when a logger is given. The
    noise comes from a generator seeded with ``cfg.seed`` on the player's
    device."""
    from sheeprl_tpu_torch.utils.env import make_env

    env = make_env(cfg, cfg.seed, 0, log_dir, "test" + (f"_{test_name}" if test_name else ""))()
    done = False
    cumulative_rew = 0.0
    obs = env.reset(seed=cfg.seed)[0]
    player.num_envs = 1
    player.init_states()
    generator = torch.Generator(player.device).manual_seed(int(cfg.seed))
    agent = player.agent
    while not done:
        jobs = prepare_obs(
            obs,
            cnn_keys=cfg.algo.cnn_keys.encoder,
            mlp_keys=cfg.algo.mlp_keys.encoder,
            num_envs=1,
            device=player.device,
        )
        actions = player.get_actions(jobs, greedy=greedy, generator=generator).cpu().numpy()
        real_actions = env_actions(actions[0], agent.actions_dim, agent.is_continuous)
        obs, reward, terminated, truncated, _ = env.step(real_actions.reshape(env.action_space.shape))
        done = bool(terminated or truncated or cfg.dry_run)
        cumulative_rew += float(np.asarray(reward))
    print("Test - Reward:", cumulative_rew, flush=True)
    if logger is not None:
        logger.log_metrics({"Test/cumulative_reward": cumulative_rew}, 0)
    env.close()
    return cumulative_rew

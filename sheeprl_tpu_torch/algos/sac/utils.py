"""SAC helpers (port of ``sheeprl_tpu/algos/sac/utils.py``): the metric
whitelist, observation preparation and the greedy test episode."""

from __future__ import annotations

from typing import Any, Dict, Optional, Sequence

import numpy as np
import torch

AGGREGATOR_KEYS = {
    "Rewards/rew_avg",
    "Game/ep_len_avg",
    "Loss/value_loss",
    "Loss/policy_loss",
    "Loss/alpha_loss",
}
MODELS_TO_REGISTER = {"agent"}


def flat_obs(obs: Dict[str, np.ndarray], mlp_keys: Sequence[str], num_envs: int = 1) -> np.ndarray:
    """The mlp-key observations concatenated into one float32 array ``[num_envs, obs_dim]``."""
    return np.concatenate([np.asarray(obs[k], dtype=np.float32).reshape(num_envs, -1) for k in mlp_keys], axis=-1)


def prepare_obs(
    obs: Dict[str, np.ndarray], *, mlp_keys: Sequence[str], num_envs: int = 1, device: Any = "cpu"
) -> torch.Tensor:
    """:func:`flat_obs` as a tensor on ``device``."""
    return torch.from_numpy(flat_obs(obs, mlp_keys, num_envs)).to(device)


@torch.no_grad()
def test(actor, cfg, log_dir: str, logger: Optional[Any] = None) -> float:
    """One greedy (mean-action) episode on a single env; returns its reward,
    and logs it as ``Test/cumulative_reward`` when a logger is given."""
    from sheeprl_tpu_torch.algos.sac.agent import greedy_action
    from sheeprl_tpu_torch.utils.env import make_env

    env = make_env(cfg, None, 0, log_dir, "test", vector_env_idx=0)()
    device = actor.action_scale.device
    done = False
    cumulative_rew = 0.0
    obs = env.reset(seed=cfg.seed)[0]
    while not done:
        mean, _ = actor(prepare_obs(obs, mlp_keys=cfg.algo.mlp_keys.encoder, device=device))
        actions = greedy_action(mean, actor.action_scale, actor.action_bias).cpu().numpy()
        obs, reward, terminated, truncated, _ = env.step(actions.reshape(env.action_space.shape))
        done = bool(terminated) or bool(truncated) or bool(cfg.dry_run)
        cumulative_rew += float(reward)
    print("Test - Reward:", cumulative_rew, flush=True)
    if logger is not None:
        logger.log_metrics({"Test/cumulative_reward": cumulative_rew}, 0)
    env.close()
    return cumulative_rew

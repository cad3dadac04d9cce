"""PPO helpers (port of ``sheeprl_tpu/algos/ppo/utils.py``): the metric
whitelist, observation preparation and the greedy test episode."""

from __future__ import annotations

from typing import Any, Dict, Optional, Sequence

import numpy as np
import torch

from sheeprl_tpu_torch.envs.spaces import action_space_dims, env_actions

AGGREGATOR_KEYS = {"Rewards/rew_avg", "Game/ep_len_avg", "Loss/value_loss", "Loss/policy_loss", "Loss/entropy_loss"}
MODELS_TO_REGISTER = {"agent"}


def normalize_obs(obs: Dict[str, Any], cnn_keys: Sequence[str], obs_keys: Sequence[str]) -> Dict[str, Any]:
    """Pixels to [-0.5, 0.5]; vectors pass through."""
    return {k: obs[k] / 255.0 - 0.5 if k in cnn_keys else obs[k] for k in obs_keys}


def prepare_obs(
    obs: Dict[str, np.ndarray], *, cnn_keys: Sequence[str] = (), num_envs: int = 1, device: Any = "cpu"
) -> Dict[str, torch.Tensor]:
    """Host observations as normalised float32 tensors [num_envs, ...] on ``device``."""
    out = {}
    for k in obs.keys():
        v = torch.from_numpy(np.asarray(obs[k], dtype=np.float32)).to(device)
        out[k] = v.reshape(num_envs, -1, *v.shape[-2:]) if k in cnn_keys else v.reshape(num_envs, -1)
    return normalize_obs(out, cnn_keys, list(obs.keys()))


@torch.no_grad()
def test(agent, cfg, log_dir: str, logger: Optional[Any] = None) -> float:
    """One greedy episode on a single env; returns its reward, and logs it as
    ``Test/cumulative_reward`` when a logger is given."""
    from sheeprl_tpu_torch.algos.ppo.agent import policy_output
    from sheeprl_tpu_torch.utils.env import make_env

    env = make_env(cfg, None, 0, log_dir, "test", vector_env_idx=0)()
    actions_dim, is_continuous = action_space_dims(env.action_space)
    device = next(agent.parameters()).device
    done = False
    cumulative_rew = 0.0
    obs = env.reset(seed=cfg.seed)[0]
    while not done:
        actor_outs, values = agent(prepare_obs(obs, cnn_keys=cfg.algo.cnn_keys.encoder, device=device))
        out = policy_output(actor_outs, values, actions_dim, is_continuous, greedy=True)
        actions = env_actions(out["actions"].cpu().numpy(), actions_dim, is_continuous)
        obs, reward, terminated, truncated, _ = env.step(actions.reshape(env.action_space.shape))
        done = bool(terminated) or bool(truncated) or bool(cfg.dry_run)
        cumulative_rew += float(reward)
    print("Test - Reward:", cumulative_rew, flush=True)
    if logger is not None:
        logger.log_metrics({"Test/cumulative_reward": cumulative_rew}, 0)
    env.close()
    return cumulative_rew

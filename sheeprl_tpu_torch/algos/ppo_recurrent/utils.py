"""Recurrent PPO helpers (port of ``sheeprl_tpu/algos/ppo_recurrent/utils.py``):
the metric whitelist, the observation normalisation and the greedy test
episode."""

from __future__ import annotations

from typing import Any, Dict, Optional, Sequence

import numpy as np
import torch

from sheeprl_tpu_torch.algos.ppo.utils import AGGREGATOR_KEYS, normalize_obs  # noqa: F401
from sheeprl_tpu_torch.envs.spaces import action_space_dims, env_actions

MODELS_TO_REGISTER = {"agent"}


def sequence_obs(
    obs: Dict[str, np.ndarray], obs_keys: Sequence[str], cnn_keys: Sequence[str], device: Any = "cpu"
) -> Dict[str, torch.Tensor]:
    """Host observations of one vector step, ``[E, ...]``, as a normalised
    float32 sequence of one step, ``[1, E, ...]``, on ``device``."""
    out = {k: torch.from_numpy(np.asarray(obs[k], dtype=np.float32)).to(device)[None] for k in obs_keys}
    return normalize_obs(out, cnn_keys, obs_keys)


@torch.no_grad()
def test(agent, cfg, log_dir: str, logger: Optional[Any] = None) -> float:
    """One greedy episode on a single env, carrying ``(hx, cx)`` and the
    previous one-hot action across steps; returns its reward, and logs it as
    ``Test/cumulative_reward`` when a logger is given."""
    from sheeprl_tpu_torch.algos.ppo.agent import policy_output
    from sheeprl_tpu_torch.utils.env import make_env

    env = make_env(cfg, None, 0, log_dir, "test", vector_env_idx=0)()
    actions_dim, is_continuous = action_space_dims(env.action_space)
    device = next(agent.parameters()).device
    cnn_keys = list(cfg.algo.cnn_keys.encoder)
    obs_keys = cnn_keys + list(cfg.algo.mlp_keys.encoder)
    prev_actions = torch.zeros(1, int(np.sum(actions_dim)), device=device)
    hx, cx = agent.initial_states(1, device)
    done = False
    cumulative_rew = 0.0
    obs = env.reset(seed=cfg.seed)[0]
    while not done:
        host = {}
        for k in obs_keys:
            v = np.asarray(obs[k], dtype=np.float32)
            host[k] = v.reshape(1, -1, *v.shape[-2:]) if k in cnn_keys else v.reshape(1, -1)
        actor_outs, values, (hx, cx) = agent(sequence_obs(host, obs_keys, cnn_keys, device), prev_actions[None], hx, cx)
        out = policy_output([o[0] for o in actor_outs], values[0], actions_dim, is_continuous, greedy=True)
        prev_actions = out["actions"]
        actions = env_actions(prev_actions.cpu().numpy(), actions_dim, is_continuous)
        obs, reward, terminated, truncated, _ = env.step(actions.reshape(env.action_space.shape))
        done = bool(terminated) or bool(truncated) or bool(cfg.dry_run)
        cumulative_rew += float(reward)
    print("Test - Reward:", cumulative_rew, flush=True)
    if logger is not None:
        logger.log_metrics({"Test/cumulative_reward": cumulative_rew}, 0)
    env.close()
    return cumulative_rew

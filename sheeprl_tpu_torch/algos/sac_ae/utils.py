"""SAC-AE helpers (port of ``sheeprl_tpu/algos/sac_ae/utils.py``): the metric
whitelist, the reconstruction target, observation preparation and the greedy
test episode."""

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
    "Loss/reconstruction_loss",
}
MODELS_TO_REGISTER = {"agent", "encoder", "decoder"}


def preprocess_obs(obs: torch.Tensor, noise: torch.Tensor, bits: int = 8) -> torch.Tensor:
    """Bit-depth reduction of [0, 255] frames plus the dequantization noise
    ``noise`` (uniform in [0, 1), the frames' shape), centred
    (arXiv:1807.03039)."""
    bins = 2**bits
    if bits < 8:
        obs = torch.floor(obs / 2 ** (8 - bits))
    return obs / bins + noise / bins - 0.5


def prepare_obs(
    obs: Dict[str, np.ndarray], *, cnn_keys: Sequence[str] = (), mlp_keys: Sequence[str] = (), num_envs: int = 1,
    device: Any = "cpu",
) -> Dict[str, torch.Tensor]:
    """Frames -> [N, C, H, W] in [0, 1] (frame stacks folded into the
    channels), vectors -> [N, D] float32, on ``device``."""
    out = {}
    for k in cnn_keys:
        v = torch.from_numpy(np.asarray(obs[k])).to(device)
        out[k] = v.reshape(num_envs, -1, *v.shape[-2:]).float() / 255.0
    for k in mlp_keys:
        out[k] = torch.from_numpy(np.asarray(obs[k], dtype=np.float32)).to(device).reshape(num_envs, -1)
    return out


@torch.no_grad()
def test(agent, cfg, log_dir: str, logger: Optional[Any] = None) -> float:
    """One greedy (tanh of the mean) episode on a single env; returns its
    reward, and logs it as ``Test/cumulative_reward`` when a logger is given."""
    from sheeprl_tpu_torch.algos.sac.agent import greedy_action
    from sheeprl_tpu_torch.utils.env import make_env

    env = make_env(cfg, cfg.seed, 0, log_dir, "test")()
    actor = agent.actor
    done = False
    cumulative_rew = 0.0
    obs = env.reset(seed=cfg.seed)[0]
    while not done:
        jobs = prepare_obs(obs, cnn_keys=cfg.algo.cnn_keys.encoder, mlp_keys=cfg.algo.mlp_keys.encoder,
                           device=agent.device)
        mean, _ = actor(agent.features(jobs, side="actor"))
        actions = greedy_action(mean, actor.action_scale, actor.action_bias).cpu().numpy()
        obs, reward, terminated, truncated, _ = env.step(actions.reshape(env.action_space.shape))
        done = bool(terminated) or bool(truncated) or bool(cfg.dry_run)
        cumulative_rew += float(reward)
    print("Test - Reward:", cumulative_rew, flush=True)
    if logger is not None:
        logger.log_metrics({"Test/cumulative_reward": cumulative_rew}, 0)
    env.close()
    return cumulative_rew

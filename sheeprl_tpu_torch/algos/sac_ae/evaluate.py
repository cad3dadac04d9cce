"""SAC-AE evaluation (port of ``sheeprl_tpu/algos/sac_ae/evaluate.py``): one
greedy test episode of a checkpoint's agent."""

from __future__ import annotations

from typing import Any, Dict

from sheeprl_tpu_torch.algos.sac_ae.agent import build_agent
from sheeprl_tpu_torch.algos.sac_ae.utils import test
from sheeprl_tpu_torch.envs import spaces
from sheeprl_tpu_torch.utils.env import make_env


def evaluate(fabric, cfg: Dict[str, Any], state: Dict[str, Any]) -> float:
    log_dir = cfg.get("log_dir", "logs/evaluation")
    env = make_env(cfg, cfg.seed, 0, log_dir, "test")()
    observation_space, action_space = env.observation_space, env.action_space
    env.close()
    if not isinstance(observation_space, spaces.Dict):
        raise RuntimeError(f"Unexpected observation type, should be of type Dict, got: {observation_space}")
    agent = build_agent(fabric, cfg, observation_space, action_space, int(cfg.seed), state["agent"] if state else None)
    return test(agent, cfg, log_dir)

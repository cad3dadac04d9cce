"""PPO and A2C evaluation (port of ``sheeprl_tpu/algos/ppo/evaluate.py`` and
``sheeprl_tpu/algos/a2c/evaluate.py``): one greedy test episode of a
checkpoint's agent."""

from __future__ import annotations

from typing import Any, Dict

from sheeprl_tpu_torch.algos.ppo.agent import build_agent
from sheeprl_tpu_torch.algos.ppo.utils import test
from sheeprl_tpu_torch.envs import spaces
from sheeprl_tpu_torch.envs.spaces import action_space_dims
from sheeprl_tpu_torch.utils.env import make_env


def evaluate(fabric, cfg: Dict[str, Any], state: Dict[str, Any]) -> float:
    logdir = cfg.get("log_dir", "logs/evaluation")
    env = make_env(cfg, cfg.seed, 0, logdir, "test")()
    observation_space = env.observation_space
    if not isinstance(observation_space, spaces.Dict):
        raise RuntimeError(f"Unexpected observation type, should be of type Dict, got: {observation_space}")
    actions_dim, is_continuous = action_space_dims(env.action_space)
    env.close()
    agent = build_agent(fabric, actions_dim, is_continuous, cfg, observation_space, cfg.seed, state["agent"])
    return test(agent, cfg, logdir)

"""Dreamer-V3 evaluation (port of ``sheeprl_tpu/algos/dreamer_v3/evaluate.py``):
one test episode of a checkpoint's agent; the other Dreamer families evaluate
through it."""

from __future__ import annotations

from typing import Any, Callable, Dict

from sheeprl_tpu_torch.algos.dreamer_v3.agent import PlayerDV3, build_agent
from sheeprl_tpu_torch.algos.dreamer_v3.utils import test
from sheeprl_tpu_torch.envs import spaces
from sheeprl_tpu_torch.envs.spaces import action_space_dims
from sheeprl_tpu_torch.utils.env import make_env


def evaluate(
    fabric,
    cfg: Dict[str, Any],
    state: Dict[str, Any],
    build_agent_fn: Callable = build_agent,
    player_cls: Callable = PlayerDV3,
) -> float:
    """One test episode of the checkpoint's agent, acting with ``agent.actor``;
    the Dreamer-V3 forks pass their own ``build_agent_fn``, Dreamer-V1 and V2
    their agent and player."""
    log_dir = cfg.get("log_dir", "logs/evaluation")
    env = make_env(cfg, cfg.seed, 0, log_dir, "test")()
    observation_space = env.observation_space
    action_space = env.action_space
    env.close()
    if not isinstance(observation_space, spaces.Dict):
        raise RuntimeError(f"Unexpected observation type, should be of type Dict, got: {observation_space}")
    actions_dim, is_continuous = action_space_dims(action_space)
    agent = build_agent_fn(
        fabric,
        actions_dim,
        is_continuous,
        cfg,
        observation_space,
        int(cfg.seed),
        state["agent"] if state else None,
    )
    player = player_cls(agent, 1, cfg.algo.cnn_keys.encoder, cfg.algo.mlp_keys.encoder)
    return test(player, cfg, log_dir, greedy=False)

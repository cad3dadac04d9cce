"""SAC-family serving policies (port of ``sheeprl_tpu/algos/sac/serve.py``):
SAC and DroQ, continuous-control MLP actors.

A session's carry is empty: the actor has no state. With ``serve.greedy``
(the default) the served action is the squashed mean, the computation of the
test episode (``sac.utils.test``); otherwise a sample from one ``normal``
noise row of ``act_dim`` per slot and step, drawn from the session's own
generator by the slot table.
"""

from __future__ import annotations

from typing import Any, Callable, Dict

import numpy as np
import torch

from sheeprl_tpu_torch.algos.sac.agent import greedy_action, squash_and_logprob
from sheeprl_tpu_torch.envs import spaces
from sheeprl_tpu_torch.interop.flax_to_torch import load_sac_params, sac_to_flax
from sheeprl_tpu_torch.serve.policy import NoiseSpec, ServePolicy, space_obs_spec
from sheeprl_tpu_torch.utils.env import make_env


def _sac_like_serve_policy(fabric, cfg, state, build_agent: Callable) -> ServePolicy:
    env = make_env(cfg, cfg.seed, 0, None, "serve-probe")()
    observation_space, action_space = env.observation_space, env.action_space
    env.close()
    if not isinstance(observation_space, spaces.Dict):
        raise RuntimeError(f"Unexpected observation type, should be a Dict space, got: {observation_space}")
    if not isinstance(action_space, spaces.Box):
        raise ValueError("SAC-family serving requires a continuous (Box) action space")
    action_shape = tuple(int(s) for s in action_space.shape)

    agent = build_agent(fabric, cfg, observation_space, action_space, int(cfg.seed), state["agent"] if state else None)
    agent.eval()
    actor = agent.actor
    mlp_keys = tuple(cfg.algo.mlp_keys.encoder)
    greedy = bool((cfg.get("serve") or {}).get("greedy", True))
    noise_spec = {} if greedy else {"act": NoiseSpec("normal", int(np.prod(action_shape)))}

    def step_slots(carry, obs, noise):
        S = next(iter(obs.values())).shape[0]
        flat = torch.cat([obs[k].to(torch.float32).reshape(S, -1) for k in mlp_keys], dim=-1)
        with torch.no_grad():
            mean, std = actor(flat)
            if greedy:
                action = greedy_action(mean, actor.action_scale, actor.action_bias)
            else:
                action, _ = squash_and_logprob(mean, std, noise["act"], actor.action_scale, actor.action_bias)
        return action.reshape(S, *action_shape), carry

    return ServePolicy(
        algo=str(cfg.algo.name),
        device=fabric.device,
        init_slots=lambda n: {},
        step_slots=step_slots,
        noise_spec=noise_spec,
        obs_spec=space_obs_spec(observation_space, mlp_keys),
        action_shape=action_shape,
        action_dtype=np.float32,
        module=agent,
        meta={"family": "sac", "greedy": greedy, "recurrent": False},
        params_tree=sac_to_flax,
        load_params=load_sac_params,
    )


def get_serve_policy(fabric, cfg: Dict[str, Any], state: Dict[str, Any]) -> ServePolicy:
    from sheeprl_tpu_torch.algos.sac.agent import build_agent

    return _sac_like_serve_policy(fabric, cfg, state, build_agent)


def get_serve_policy_droq(fabric, cfg: Dict[str, Any], state: Dict[str, Any]) -> ServePolicy:
    from sheeprl_tpu_torch.algos.droq.agent import build_agent

    return _sac_like_serve_policy(fabric, cfg, state, build_agent)

"""PPO-family serving policy (port of ``sheeprl_tpu/algos/ppo/serve.py``): a
checkpoint of PPO or A2C (the A2C agent is the PPO agent), written by either
package, served from ``state["agent"]``.

A session's carry is empty: the policy is feedforward. With ``serve.greedy``
(the default) the served action is the distribution's mode, the computation of
the test episode (``ppo.utils.test``); otherwise a sample from one noise row
per slot and step (standard normal for a continuous action, standard Gumbel
for each logit of a discrete one), drawn from the session's own generator by
the slot table. The step reaches no hand-written kernel.
"""

from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from sheeprl_tpu_torch.algos.ppo.agent import build_agent, policy_output
from sheeprl_tpu_torch.envs import spaces
from sheeprl_tpu_torch.envs.spaces import action_space_dims
from sheeprl_tpu_torch.interop.flax_to_torch import load_ppo_params, ppo_to_flax
from sheeprl_tpu_torch.serve.policy import NoiseSpec, ServePolicy, space_obs_spec
from sheeprl_tpu_torch.utils.env import make_env


def get_serve_policy(fabric, cfg: Dict[str, Any], state: Dict[str, Any]) -> ServePolicy:
    env = make_env(cfg, cfg.seed, 0, None, "serve-probe")()
    observation_space, action_space = env.observation_space, env.action_space
    env.close()
    if not isinstance(observation_space, spaces.Dict):
        raise RuntimeError(f"Unexpected observation type, should be of type Dict, got: {observation_space}")
    actions_dim, is_continuous = action_space_dims(action_space)
    action_shape = tuple(int(s) for s in action_space.shape)
    agent = build_agent(
        fabric, actions_dim, is_continuous, cfg, observation_space, int(cfg.seed), state["agent"] if state else None
    )
    agent.eval()

    cnn_keys = tuple(cfg.algo.cnn_keys.encoder)
    mlp_keys = tuple(cfg.algo.mlp_keys.encoder)
    greedy = bool((cfg.get("serve") or {}).get("greedy", True))
    noise_spec = {} if greedy else {"act": NoiseSpec("normal" if is_continuous else "gumbel", int(sum(actions_dim)))}

    def step_slots(carry, obs, noise):
        S = next(iter(obs.values())).shape[0]
        norm = {}
        for k in cnn_keys + mlp_keys:
            v = obs[k].to(torch.float32)
            # frame-stack dims fold into channels, pixels -> [-0.5, 0.5]
            norm[k] = v.reshape(S, -1, *v.shape[-2:]) / 255.0 - 0.5 if k in cnn_keys else v.reshape(S, -1)
        with torch.no_grad():
            actor_outs, values = agent(norm)
            out = policy_output(actor_outs, values, actions_dim, is_continuous, greedy=greedy, noise=noise.get("act"))
        if is_continuous:
            return out["actions"].reshape(S, *action_shape).to(torch.float32), carry
        blocks = torch.split(out["actions"], list(actions_dim), dim=-1)
        env_action = torch.stack([b.argmax(dim=-1) for b in blocks], dim=-1).reshape(S, *action_shape)
        return env_action.to(torch.int32), carry

    return ServePolicy(
        algo=str(cfg.algo.name),
        device=fabric.device,
        init_slots=lambda n: {},
        step_slots=step_slots,
        noise_spec=noise_spec,
        obs_spec=space_obs_spec(observation_space, cnn_keys + mlp_keys),
        action_shape=action_shape,
        action_dtype=np.float32 if is_continuous else np.int32,
        module=agent,
        meta={"family": "ppo", "greedy": greedy, "recurrent": False},
        params_tree=ppo_to_flax,
        load_params=load_ppo_params,
    )

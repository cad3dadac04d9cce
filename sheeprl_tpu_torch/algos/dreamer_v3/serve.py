"""Dreamer-family serving policies (port of ``sheeprl_tpu/algos/dreamer_v3/serve.py``).

The per-session carry is the player's per-env state: previous action,
recurrent state ``h`` and stochastic state ``z``, plus the session's own
``torch.Generator`` (held by the slot table, seeded from the session seed).
:func:`dv3_step_slots` is the JAX ``step_slot`` written batched over slots —
encoder, recurrent model, posterior, actor — so the LayerNorm-GRU step runs
once per tick at ``[slots, K]`` through the hand-written kernel.
:func:`dreamer_serve_policy` is the shape every Dreamer family serves
through (Dreamer-V1 and V2 with their own carries, steps and noise).

At a bf16 compute dtype the carry is the JAX table's: ``action`` float32,
``h`` float32 holding the bf16 step's values (the fresh carry's ``tanh(w)``
is float32, and the masked update keeps the table's dtype), ``z`` bf16; the
noise is drawn in bf16.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Sequence, Tuple

import numpy as np
import torch

from sheeprl_tpu_torch.algos.dreamer_v3.agent import DV3Agent, build_agent, player_step
from sheeprl_tpu_torch.envs import spaces
from sheeprl_tpu_torch.envs.spaces import action_space_dims
from sheeprl_tpu_torch.interop.flax_to_torch import agent_to_flax, load_flax_params
from sheeprl_tpu_torch.serve.policy import NoiseSpec, ServePolicy, space_obs_spec
from sheeprl_tpu_torch.utils.env import make_env


def dv3_init_slots(agent: DV3Agent, n: int) -> Dict[str, torch.Tensor]:
    """``n`` fresh carries: zero previous action, tanh(w) recurrent state and the
    transition-mode posterior (the state the player resets to)."""
    with torch.no_grad():
        h0, z0 = agent.initial_state((n,))
        act_dim = int(np.sum(agent.actions_dim))
        return {
            "action": torch.zeros((n, act_dim), dtype=torch.float32, device=h0.device),
            "h": h0.contiguous(),
            "z": z0.contiguous(),
        }


def dv3_step_slots(
    agent: DV3Agent,
    carry: Dict[str, torch.Tensor],
    obs: Dict[str, torch.Tensor],
    noise: Dict[str, torch.Tensor],
    *,
    cnn_keys: Sequence[str],
    mlp_keys: Sequence[str],
    greedy: bool,
    action_shape: Tuple[int, ...],
    step_fn: Callable = player_step,
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """One serving step for every slot: ``obs`` are raw ``[S, ...]`` env
    observations, ``noise["repr"]`` the posterior sample's noise and
    ``noise["act"]`` the actor's (absent when greedy). ``step_fn`` is the
    family's acting step (``player_step``'s signature)."""
    S = carry["h"].shape[0]
    norm: Dict[str, torch.Tensor] = {}
    for k in (*cnn_keys, *mlp_keys):
        v = obs[k].to(torch.float32)
        if k in cnn_keys:
            # frame-stack folds into channels; pixels -> [-0.5, 0.5]
            norm[k] = v.reshape(S, -1, *v.shape[-2:]) / 255.0 - 0.5
        else:
            norm[k] = v.reshape(S, -1)
    with torch.no_grad():
        actions, h, z = step_fn(
            agent, norm, carry["action"], carry["h"], carry["z"], noise["repr"], noise.get("act"), greedy
        )
    actions = actions.float()
    if agent.is_continuous:
        env_action = actions.reshape(S, *action_shape)
    else:
        blocks = torch.split(actions, list(agent.actions_dim), dim=-1)
        env_action = (
            torch.stack([b.argmax(dim=-1) for b in blocks], dim=-1)
            .reshape(S, *action_shape)
            .to(torch.int32)
        )
    return env_action, {"action": actions, "h": h, "z": z}


def dv3_noise_spec(agent: DV3Agent, greedy: bool) -> Dict[str, NoiseSpec]:
    """Gumbel noise for the posterior; the actor's, unless greedy: normal
    (continuous) or Gumbel (discrete), in the compute dtype."""
    spec = {"repr": NoiseSpec("gumbel", agent.stoch_state_size, agent.dtype)}
    if not greedy:
        act_size = int(np.sum(agent.actions_dim))
        spec["act"] = NoiseSpec("normal" if agent.is_continuous else "gumbel", act_size, agent.dtype)
    return spec


def get_serve_policy(fabric, cfg: Dict[str, Any], state: Dict[str, Any]) -> ServePolicy:
    return dreamer_serve_policy(
        fabric,
        cfg,
        state,
        family="dreamer_v3",
        build_agent_fn=build_agent,
        init_slots=dv3_init_slots,
        step_fn=player_step,
        noise_spec=dv3_noise_spec,
        params_tree=agent_to_flax,
        load_params=load_flax_params,
    )


def dreamer_serve_policy(
    fabric,
    cfg: Dict[str, Any],
    state: Dict[str, Any],
    *,
    family: str,
    build_agent_fn: Callable,
    init_slots: Callable,
    step_fn: Callable,
    noise_spec: Callable,
    params_tree: Callable,
    load_params: Callable,
) -> ServePolicy:
    """The Dreamer family's serving policy (the JAX ``dreamer_serve_policy``):
    the family's agent, its fresh carries ``init_slots(agent, n)``, its acting
    step ``step_fn`` batched over slots by :func:`dv3_step_slots`, its noise
    ``noise_spec(agent, greedy)`` and its checkpoint layout."""
    env = make_env(cfg, cfg.seed, 0, None, "serve-probe")()
    observation_space = env.observation_space
    action_space = env.action_space
    env.close()
    if not isinstance(observation_space, spaces.Dict):
        raise RuntimeError(f"Unexpected observation type, should be a Dict space, got: {observation_space}")
    actions_dim, is_continuous = action_space_dims(action_space)
    action_shape = tuple(int(s) for s in action_space.shape)

    agent = build_agent_fn(
        fabric,
        actions_dim,
        is_continuous,
        cfg,
        observation_space,
        int(cfg.seed),
        state["agent"] if state else None,
    )
    agent.eval()

    cnn_keys = tuple(cfg.algo.cnn_keys.encoder)
    mlp_keys = tuple(cfg.algo.mlp_keys.encoder)
    greedy = bool((cfg.get("serve") or {}).get("greedy", True))

    def step_slots(carry, obs, noise):
        return dv3_step_slots(
            agent,
            carry,
            obs,
            noise,
            cnn_keys=cnn_keys,
            mlp_keys=mlp_keys,
            greedy=greedy,
            action_shape=action_shape,
            step_fn=step_fn,
        )

    return ServePolicy(
        algo=str(cfg.algo.name),
        device=fabric.device,
        init_slots=lambda n: init_slots(agent, n),
        step_slots=step_slots,
        noise_spec=noise_spec(agent, greedy),
        obs_spec=space_obs_spec(observation_space, cnn_keys + mlp_keys),
        action_shape=action_shape,
        action_dtype=np.float32 if is_continuous else np.int32,
        module=agent,
        meta={"family": family, "greedy": greedy, "recurrent": True},
        params_tree=params_tree,
        load_params=load_params,
    )

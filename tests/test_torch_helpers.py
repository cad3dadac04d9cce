"""Shared builders for the parity tests of the PyTorch port (no tests here).

Both packages run on the CPU in float32. Inputs are made with numpy from a
seed and handed to both; parameters are made by the JAX package and carried
into the port through ``sheeprl_tpu_torch.interop.flax_to_torch``.
"""

from __future__ import annotations

import functools
from typing import Sequence, Tuple

import jax
import numpy as np
import torch

# the suite runs several pytest workers on one machine, and every worker
# imports this module while collecting: one intra-op thread per worker keeps
# the port's CPU tests from crowding the timing-sensitive tests beside them
torch.set_num_threads(1)

# the same for the subprocesses the port's tests start
SUBPROCESS_ENV = {"OMP_NUM_THREADS": "1"}

# the small Dreamer-V3 widths of tests/test_serve/test_policies.py
DV3_SMALL = [
    "exp=dreamer_v3",
    "env=dummy",
    "env.id=discrete_dummy",
    "env.capture_video=False",
    "fabric.accelerator=cpu",
    "metric.log_level=0",
    "algo.dense_units=8",
    "algo.mlp_layers=1",
    "algo.world_model.discrete_size=4",
    "algo.world_model.stochastic_size=4",
    "algo.world_model.encoder.cnn_channels_multiplier=2",
    "algo.world_model.recurrent_model.recurrent_state_size=8",
    "algo.world_model.representation_model.hidden_size=8",
    "algo.world_model.transition_model.hidden_size=8",
    "algo.cnn_keys.encoder=[rgb]",
    "algo.cnn_keys.decoder=[rgb]",
    "algo.mlp_keys.encoder=[state]",
    "algo.mlp_keys.decoder=[state]",
]

ENV_IDS = {
    "discrete": "discrete_dummy",
    "multidiscrete": "multidiscrete_dummy",
    "continuous": "continuous_dummy",
}
ACTIONS = {
    "discrete": ((2,), False),
    "multidiscrete": ((2, 2), False),
    "continuous": ((2,), True),
}


def overrides(kind: str = "discrete", extra: Sequence[str] = ()) -> list:
    return [o for o in DV3_SMALL if not o.startswith("env.id=")] + [f"env.id={ENV_IDS[kind]}", *extra]


def numpy_tree(tree):
    return jax.tree_util.tree_map(lambda x: np.asarray(x), tree)


@functools.lru_cache(maxsize=None)
def _jax_agent(kind: str, extra: Tuple[str, ...], seed: int):
    """The JAX side of ``paired_agents``, built once per worker process (its
    jitted init is the expensive part); callers must not mutate it."""
    from sheeprl_tpu.algos.dreamer_v3.agent import build_agent as jax_build
    from sheeprl_tpu.config import compose as jax_compose
    from sheeprl_tpu.parallel.fabric import Fabric as JaxFabric
    from sheeprl_tpu.utils.env import make_env as jax_make_env

    cfg_jax = jax_compose(overrides(kind, extra))
    env = jax_make_env(cfg_jax, 0, 0)()
    obs_space = env.observation_space
    env.close()
    actions_dim, is_continuous = ACTIONS[kind]
    fabric = JaxFabric(devices=1, accelerator="cpu")
    fabric._setup()
    jax_agent, params = jax_build(
        fabric, actions_dim, is_continuous, cfg_jax, obs_space, jax.random.PRNGKey(seed)
    )
    return jax_agent, numpy_tree(params), cfg_jax, obs_space


def paired_agents(kind: str = "discrete", extra: Sequence[str] = (), seed: int = 3) -> Tuple:
    """(jax_agent, jax_params, torch_agent, cfg_jax, cfg_torch) at the small
    widths, a fresh torch agent loaded from the JAX parameters."""
    from sheeprl_tpu_torch.algos.dreamer_v3.agent import build_agent
    from sheeprl_tpu_torch.config import compose
    from sheeprl_tpu_torch.parallel.fabric import Fabric

    jax_agent, params, cfg_jax, obs_space = _jax_agent(kind, tuple(extra), seed)
    actions_dim, is_continuous = ACTIONS[kind]
    cfg_torch = compose(overrides(kind, extra))
    torch_agent = build_agent(
        Fabric(accelerator="cpu"), actions_dim, is_continuous, cfg_torch, obs_space, seed, params
    )
    return jax_agent, params, torch_agent, cfg_jax, cfg_torch


def random_obs(rng: np.random.Generator, batch: Tuple[int, ...], image=(3, 64, 64), state=(10,)):
    """Normalized encoder inputs: rgb in [-0.5, 0.5], a standard-normal state."""
    return {
        "rgb": (rng.integers(0, 256, (*batch, *image)) / 255.0 - 0.5).astype(np.float32),
        "state": rng.standard_normal((*batch, *state)).astype(np.float32),
    }

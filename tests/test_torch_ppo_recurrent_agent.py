"""The recurrent PPO agent of the port against the JAX package's, on the CPU.

- the LSTM cell against Flax's ``nn.OptimizedLSTMCell`` on the JAX agent's
  cell parameters, one step; and the masked scan against the jitted JAX
  ``RecurrentPPOAgent.rnn_scan``: a sequence whose mask pads steps in the
  middle and at the end (the carry held across them, the outputs still the
  cell's), without and with the pre- and post-RNN MLPs;
- the whole forward (encoders, scan, actor heads, critic) from converted
  parameters, for discrete, multi-discrete and continuous heads and a small
  cnn key, and the converter both ways: the port's tree of a JAX agent is the
  JAX tree leaf for leaf, and a port agent's own tree drives the JAX forward
  to the port's outputs.

Tolerance 1e-5 (``test_torch_ppo.py::PARAM_ATOL``): float32 products in
another order over a few sequential steps. The cnn case runs one row: the
JAX encoder folds the B of a ``[T, B, C, H, W]`` batch into the channels
when B > 1 and fails (ROADMAP C item 8), and the port's shares the layout.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_helpers import numpy_tree

ATOL = 1e-5
SMALL = ["fabric.accelerator=cpu", "env.capture_video=False", "algo.rnn.lstm.hidden_size=8", "algo.dense_units=16",
         "algo.encoder.dense_units=16", "algo.encoder.mlp_features_dim=16", "algo.encoder.cnn_features_dim=16"]
MLPS = ["algo.rnn.pre_rnn_mlp.apply=True", "algo.rnn.post_rnn_mlp.apply=True"]
CASES = {
    "discrete": (["exp=ppo_recurrent"], (2,), False),
    "multidiscrete": (["exp=ppo_recurrent", "env=dummy", "env.id=multidiscrete_dummy", "algo.mlp_keys.encoder=[state]",
                       *MLPS], (2, 2), False),
    "continuous": (["exp=ppo_recurrent", "env=dummy", "env.id=continuous_dummy", "algo.mlp_keys.encoder=[state]"],
                   (2,), True),
    "cnn": (["exp=ppo_recurrent", "env=dummy", "env.id=discrete_dummy", "algo.cnn_keys.encoder=[rgb]",
             "algo.mlp_keys.encoder=[state]", *MLPS], (2,), False),
}


@functools.lru_cache(maxsize=None)
def _jax(case: str, extra=()):
    """The JAX agent, its params (numpy), its jitted forward and the space."""
    from sheeprl_tpu.algos.ppo_recurrent.agent import build_agent as jax_build_agent
    from sheeprl_tpu.config import compose as jax_compose
    from sheeprl_tpu.parallel.fabric import Fabric as JaxFabric
    from sheeprl_tpu.utils.env import make_env as jax_make_env

    ov, actions_dim, is_continuous = CASES[case]
    cfg = jax_compose([*ov, *SMALL, *extra])
    space = jax_make_env(cfg, 0, 0)().observation_space
    fabric = JaxFabric(devices=1, accelerator="cpu")
    fabric._setup()
    agent, params = jax_build_agent(fabric, actions_dim, is_continuous, cfg, space, jax.random.PRNGKey(1))
    forward = jax.jit(lambda p, obs, prev, hx, cx, mask: agent.forward(p, obs, prev, hx, cx, mask=mask))
    return agent, numpy_tree(params), forward, cfg, space


def _port(case: str, params, extra=(), seed: int = 0):
    from sheeprl_tpu_torch.algos.ppo_recurrent.agent import build_agent
    from sheeprl_tpu_torch.config import compose
    from sheeprl_tpu_torch.parallel.fabric import Fabric

    ov, actions_dim, is_continuous = CASES[case]
    cfg = compose([*ov, *SMALL, *extra])
    return build_agent(Fabric(accelerator="cpu"), actions_dim, is_continuous, cfg, _jax(case, tuple(extra))[4], seed,
                       params)


def _mask(T: int, B: int) -> np.ndarray:
    """Row 0 real throughout; row 1 padded at steps 2-3, then real again;
    row 2 padded from step 4 (a short last chunk)."""
    mask = np.ones((T, B, 1), np.float32)
    mask[2:4, 1] = 0.0
    mask[4:, 2] = 0.0
    return mask


def _close(ours, theirs):
    np.testing.assert_allclose(ours.detach().numpy(), np.asarray(theirs), rtol=0, atol=ATOL)


@pytest.mark.parametrize("extra", [(), tuple(MLPS)], ids=["lstm", "pre-post-mlps"])
def test_lstm_cell_and_masked_scan_match_flax(extra):
    import flax.linen as nn

    jagent, params, _, _, _ = _jax("discrete", extra)
    agent = _port("discrete", params, extra)
    rng = np.random.default_rng(0)
    T, B, H = 6, 3, 8
    cell_params = params["rnn"]["OptimizedLSTMCell_0"]
    x = rng.standard_normal((B, cell_params["ii"]["kernel"].shape[0])).astype(np.float32)
    c, h = (rng.standard_normal((B, H)).astype(np.float32) for _ in range(2))
    (jc, jh), jout = nn.OptimizedLSTMCell(H).apply({"params": cell_params}, (jnp.asarray(c), jnp.asarray(h)),
                                                    jnp.asarray(x))
    tc, th = agent.rnn.cell((torch.from_numpy(c), torch.from_numpy(h)), torch.from_numpy(x))
    _close(tc, jc)
    _close(th, jh)
    _close(th, jout)

    first = agent.rnn.pre_mlp.linears[0].weight if extra else agent.rnn.cell.input_kernel.T
    embedded = rng.standard_normal((T, B, first.shape[1])).astype(np.float32)  # features ++ prev actions
    hx, cx = (rng.standard_normal((B, H)).astype(np.float32) for _ in range(2))
    mask = _mask(T, B)
    scan = jax.jit(lambda p, e, hx, cx, m: jagent.rnn_scan(p, e, hx, cx, m))
    jouts, (jhx, jcx) = scan(params, embedded, hx, cx, mask.astype(bool))
    outs, (thx, tcx) = agent.rnn_scan(*(torch.from_numpy(a) for a in (embedded, hx, cx, mask)))
    _close(outs, jouts)
    _close(thx, jhx)
    _close(tcx, jcx)
    # the carry held: row 2, padded from step 4, ends with its step-3 state
    _, (h4, c4) = agent.rnn_scan(*(torch.from_numpy(a) for a in (embedded[:4], hx, cx, mask[:4])))
    assert torch.equal(thx[2], h4[2]) and torch.equal(tcx[2], c4[2])
    assert not torch.equal(thx[0], h4[0])


@pytest.mark.parametrize("case", list(CASES))
def test_agent_forward_matches_through_the_converter(case):
    from sheeprl_tpu_torch.algos.ppo_recurrent.utils import normalize_obs
    from sheeprl_tpu_torch.interop.flax_to_torch import ppo_recurrent_to_flax

    _, params, forward, cfg, space = _jax(case)
    _, actions_dim, _ = CASES[case]
    rng = np.random.default_rng(1)
    T, B, H = 5, 1 if case == "cnn" else 3, 8
    cnn_keys = list(cfg.algo.cnn_keys.encoder)
    keys = cnn_keys + list(cfg.algo.mlp_keys.encoder)
    obs = {k: (rng.integers(0, 256, (T, B, *space[k].shape)) if k in cnn_keys
               else rng.standard_normal((T, B, *space[k].shape))).astype(np.float32) for k in keys}
    prev = rng.standard_normal((T, B, int(np.sum(actions_dim)))).astype(np.float32)
    hx, cx = (rng.standard_normal((B, H)).astype(np.float32) for _ in range(2))
    mask = np.ones((T, B, 1), np.float32)
    mask[3:, 0] = 0.0
    norm = normalize_obs({k: torch.from_numpy(v) for k, v in obs.items()}, cnn_keys, keys)
    jnorm = {k: v.numpy() for k, v in norm.items()}

    def both(port_agent, jax_params):
        outs, values, (thx, tcx) = port_agent(norm, *(torch.from_numpy(a) for a in (prev, hx, cx, mask)))
        jouts, jvalues, (jhx, jcx) = forward(jax_params, jnorm, prev, hx, cx, mask.astype(bool))
        assert len(outs) == len(jouts) == (1 if CASES[case][2] else len(actions_dim))
        for a, b in zip([*outs, values, thx, tcx], [*jouts, jvalues, jhx, jcx]):
            _close(a, b)

    # JAX -> port
    agent = _port(case, params)
    both(agent, params)
    ours = ppo_recurrent_to_flax(agent)
    assert jax.tree_util.tree_structure(ours) == jax.tree_util.tree_structure(params)
    for a, b in zip(jax.tree_util.tree_leaves(ours), jax.tree_util.tree_leaves(params)):
        np.testing.assert_array_equal(a, b)
    # port -> JAX: a port agent's own weights drive the JAX forward
    own = _port(case, None, seed=5)
    both(own, ppo_recurrent_to_flax(own))

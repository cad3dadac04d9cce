"""Weights across (sheeprl_tpu_torch/interop/flax_to_torch.py): each mapping holds a
Flax module's ``.apply`` against the port module loaded from its converted
parameters, on the same numpy input, and the torch -> Flax direction gives the
tree back unchanged.

Both sides are float32 on the CPU. Convolution and matmul sums are taken in
another order by XLA and by PyTorch, so outputs agree to float32 rounding of
sums over at most a few hundred terms: 1e-5. Flax's LayerNorm takes the
variance as E[x^2] - E[x]^2 (``use_fast_variance``), PyTorch as E[(x - E[x])^2];
on unit-scale inputs the two differ by float32 rounding, so 1e-5 holds there too.
"""

from __future__ import annotations

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch import nn

from sheeprl_tpu.models.models import LayerNormGRUCell as FlaxGRUCell
from sheeprl_tpu.ops.conv import FastConv2x
from sheeprl_tpu.ops.deconv import FusedConvTranspose4x4S2
from sheeprl_tpu_torch.interop import flax_to_torch as ft
from sheeprl_tpu_torch.models.models import LayerNormGRUCell
from test_torch_helpers import numpy_tree, paired_agents

ATOL = 1e-5


def _init(module, x, seed=0):
    params = module.init(jax.random.PRNGKey(seed), x)["params"]
    # non-trivial biases/scales so a swapped or dropped leaf shows
    params = jax.tree_util.tree_map(
        lambda p: p + 0.1 * jax.random.normal(jax.random.PRNGKey(seed + 1), p.shape), params
    )
    return numpy_tree(params)


def _assert_round_trip(module, tree):
    back = ft.module_to_flax(module)
    assert jax.tree_util.tree_structure(back) == jax.tree_util.tree_structure(tree)
    for a, b in zip(jax.tree_util.tree_leaves(back), jax.tree_util.tree_leaves(tree)):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("bias", [True, False])
def test_dense_to_linear(bias):
    x = np.random.default_rng(0).standard_normal((3, 7)).astype(np.float32)
    fm = fnn.Dense(5, use_bias=bias)
    tree = _init(fm, x)
    tm = nn.Linear(7, 5, bias=bias)
    ft.module_from_flax(tm, tree)
    np.testing.assert_allclose(
        tm(torch.from_numpy(x)).detach().numpy(), np.asarray(fm.apply({"params": tree}, x)), atol=ATOL, rtol=ATOL
    )
    _assert_round_trip(tm, tree)


@pytest.mark.parametrize("flax_cls", ["Conv", "FastConv2x"])
def test_conv_hwio_to_oihw(flax_cls):
    """Stride-2 k4 pad-1 convs: the encoder's FastConv2x and a plain nn.Conv."""
    x = np.random.default_rng(1).standard_normal((2, 16, 16, 3)).astype(np.float32)  # NHWC
    if flax_cls == "Conv":
        fm = fnn.Conv(6, (4, 4), strides=(2, 2), padding=[(1, 1), (1, 1)], use_bias=True)
    else:
        fm = FastConv2x(features=6, kernel_size=4, padding=1, use_bias=True)
    tree = _init(fm, x)
    tm = nn.Conv2d(3, 6, 4, stride=2, padding=1, bias=True)
    ft.module_from_flax(tm, tree)
    out = tm(torch.from_numpy(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1).detach().numpy()
    np.testing.assert_allclose(out, np.asarray(fm.apply({"params": tree}, x)), atol=ATOL, rtol=ATOL)
    _assert_round_trip(tm, tree)


def test_layer_norm_scale_bias():
    x = np.random.default_rng(2).standard_normal((4, 9)).astype(np.float32)
    fm = fnn.LayerNorm(epsilon=1e-3)
    tree = _init(fm, x)
    tm = nn.LayerNorm(9, eps=1e-3)
    ft.module_from_flax(tm, tree)
    np.testing.assert_allclose(
        tm(torch.from_numpy(x)).detach().numpy(), np.asarray(fm.apply({"params": tree}, x)), atol=ATOL, rtol=ATOL
    )
    _assert_round_trip(tm, tree)


@pytest.mark.parametrize("flax_cls", ["ConvTranspose", "FusedConvTranspose4x4S2"])
def test_conv_transpose_is_flipped(flax_cls):
    """k4 s2 SAME transposed convs map onto ConvTranspose2d(padding=1) only with
    the kernel flipped spatially; unflipped they differ by O(1)."""
    x = np.random.default_rng(3).standard_normal((2, 4, 4, 8)).astype(np.float32)
    if flax_cls == "ConvTranspose":
        fm = fnn.ConvTranspose(5, (4, 4), strides=(2, 2), padding="SAME")
    else:
        fm = FusedConvTranspose4x4S2(5)
    tree = _init(fm, x)
    ref = np.asarray(fm.apply({"params": tree}, x))
    tm = nn.ConvTranspose2d(8, 5, 4, stride=2, padding=1)
    ft.module_from_flax(tm, tree)
    out = tm(torch.from_numpy(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1).detach().numpy()
    np.testing.assert_allclose(out, ref, atol=ATOL, rtol=ATOL)
    _assert_round_trip(tm, tree)
    # the flip is what makes them agree
    with torch.no_grad():
        tm.weight.copy_(tm.weight.flip(2, 3))
    out_unflipped = tm(torch.from_numpy(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1).detach().numpy()
    assert np.abs(out_unflipped - ref).max() > 1e-2


@pytest.mark.parametrize("bias", [True, False])
def test_gru_cell_kernel_kept(bias):
    rng = np.random.default_rng(4)
    x = rng.standard_normal((3, 6)).astype(np.float32)
    h = rng.standard_normal((3, 8)).astype(np.float32)
    fm = FlaxGRUCell(hidden_size=8, bias=bias, layer_norm_eps=1e-3)
    params = fm.init(jax.random.PRNGKey(0), jnp.asarray(h), jnp.asarray(x))["params"]
    params = numpy_tree(
        jax.tree_util.tree_map(lambda p: p + 0.1 * jax.random.normal(jax.random.PRNGKey(1), p.shape), params)
    )
    tm = LayerNormGRUCell(6, 8, bias=bias, layer_norm_eps=1e-3)
    ft.module_from_flax(tm, params)
    out = tm(torch.from_numpy(h), torch.from_numpy(x)).detach().numpy()
    np.testing.assert_allclose(out, np.asarray(fm.apply({"params": params}, h, x)), atol=ATOL, rtol=ATOL)
    _assert_round_trip(tm, params)


@pytest.mark.parametrize("kind", ["discrete", "continuous"])
def test_whole_agent_tree_round_trips(kind):
    """Every module of the DV3 agent (decoder, heads and critics included): JAX
    params -> port agent -> Flax tree gives the JAX tree back, leaf for leaf."""
    _, params, agent, _, _ = paired_agents(kind)
    back = ft.agent_to_flax(agent)
    assert jax.tree_util.tree_structure(back) == jax.tree_util.tree_structure(params)
    for (path, a), b in zip(
        jax.tree_util.tree_leaves_with_path(back), jax.tree_util.tree_leaves(params)
    ):
        np.testing.assert_array_equal(a, b, err_msg=jax.tree_util.keystr(path))


def test_load_refuses_a_mismatched_tree():
    _, params, agent, _, _ = paired_agents("discrete")
    bad = jax.tree_util.tree_map(lambda x: x, params)
    del bad["actor"]["Dense_0"]
    with pytest.raises(ValueError, match="missing"):
        ft.load_flax_params(agent, bad)
    bad = jax.tree_util.tree_map(lambda x: x, params)
    bad["world_model"]["initial_recurrent_state"] = np.zeros(3, np.float32)
    with pytest.raises(ValueError, match="shape"):
        ft.load_flax_params(agent, bad)

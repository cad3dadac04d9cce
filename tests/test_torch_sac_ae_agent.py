"""The port's SAC-AE blocks against the JAX package's Flax modules, on the CPU.

- the conv trunk (its H, W, C flatten), both sides' features, the target's,
  and where ``detach_encoder_features`` stops the gradients (at the shared
  trunks, not at a side's fc);
- the decoders: the CNN decoder's three stride-1 and one stride-2 VALID
  transposed convolutions, and the MLP decoder;
- the converter on a lone transposed convolution, stride 1 (k3) and stride 2
  (k4, Flax's ``ConvTranspose`` and the JAX package's phase-decomposed
  ``FusedConvTransposeS2Valid``): Flax does not flip the kernel, torch does;
- the actor's tanh-bounded log-std, at both ends of [-10, 2];
- the params layout (loaded and written back bit for bit) and the refused odd
  screen size.

The same parameters (the JAX agent's, every zero leaf filled so that each
shows) and inputs go to both sides. Tolerances: 1e-5 absolute and relative
(float32 sums over a few hundred products in other orders); a layout, bit for
bit.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_dv2_train import close_trees
from test_torch_helpers import filled, numpy_tree

ATOL = 1e-5
SCREEN = 24  # trunk 24 -> 11 -> 9 -> 7 -> 5; decoder 5 -> 7 -> 9 -> 11 -> 24
SAC_AE_SMALL = [
    "exp=sac_ae", "env=dummy", "env.id=continuous_dummy", "fabric.accelerator=cpu", "env.capture_video=False",
    "algo.cnn_keys.encoder=[rgb]", "algo.mlp_keys.encoder=[state]", "algo.cnn_channels_multiplier=1",
    "algo.encoder.features_dim=8", "algo.hidden_size=16", "algo.dense_units=8", f"env.screen_size={SCREEN}",
    "algo.per_rank_batch_size=4", "buffer.memmap=False",
]


def sac_ae_spaces(screen: int = SCREEN, state: int = 5):
    """Frame stacks of 3 RGB frames and a vector; 2 actions in [-1, 1]
    (gymnasium's classes, which both packages read)."""
    import gymnasium as gym

    obs = gym.spaces.Dict({"rgb": gym.spaces.Box(0, 255, (3, 3, screen, screen), np.uint8),
                           "state": gym.spaces.Box(-np.inf, np.inf, (state,), np.float32)})
    return obs, gym.spaces.Box(-1.0, 1.0, (2,), np.float32)


@functools.lru_cache(maxsize=None)
def jax_sac_ae(extra=()):
    """The JAX SAC-AE agent, its params (numpy, zero leaves filled) and
    config, built once per worker."""
    from sheeprl_tpu.algos.sac_ae.agent import build_agent
    from sheeprl_tpu.config import compose as jax_compose
    from sheeprl_tpu.parallel.fabric import Fabric as JaxFabric

    cfg = jax_compose([*SAC_AE_SMALL, *extra])
    fabric = JaxFabric(devices=1, accelerator="cpu")
    fabric._setup()
    agent, params = build_agent(fabric, cfg, *sac_ae_spaces(), jax.random.PRNGKey(3))
    params = filled(numpy_tree(params), seed=5)
    # the targets start as copies: fill them as their online modules
    params["target"] = {k: params[k] for k in params["target"]}
    return agent, params, cfg


def port_sac_ae(extra=(), params=None):
    from sheeprl_tpu_torch.algos.sac_ae.agent import build_agent
    from sheeprl_tpu_torch.config import compose
    from sheeprl_tpu_torch.parallel.fabric import Fabric

    cfg = compose([*SAC_AE_SMALL, *extra])
    params = jax_sac_ae(tuple(extra))[1] if params is None else params
    return build_agent(Fabric(accelerator="cpu"), cfg, *sac_ae_spaces(), 0, params), cfg


def sac_ae_obs(rng, n: int) -> dict:
    return {"rgb": (rng.integers(0, 256, (n, 9, SCREEN, SCREEN)) / 255.0).astype(np.float32),
            "state": rng.standard_normal((n, 5)).astype(np.float32)}


def _t(obs):
    return {k: torch.from_numpy(v) for k, v in obs.items()}


def _close(ours, theirs, atol=ATOL):
    ours = ours.detach().numpy() if isinstance(ours, torch.Tensor) else np.asarray(ours)
    np.testing.assert_allclose(ours, np.asarray(theirs), atol=atol, rtol=atol)


def test_trunk_and_features_match_and_detach_stops_at_the_trunks():
    jagent, params, _ = jax_sac_ae()
    tagent, _ = port_sac_ae()
    obs = sac_ae_obs(np.random.default_rng(0), 3)
    _close(tagent.conv(_t(obs)), jagent.conv.apply({"params": params["conv"]}, obs))
    for kw in ({}, {"side": "actor"}, {"target": True}, {"side": "actor", "detach_encoder_features": True}):
        _close(tagent.features(_t(obs), **kw), jagent.features(params, obs, **kw))

    # gradients of the summed actor features: with the detach, none reach the
    # trunk and the vector encoder; the actor's fc takes the same as in JAX
    jparams = jax.tree_util.tree_map(jnp.asarray, params)
    for detach in (True, False):
        grads = jax.grad(lambda p: jnp.sum(jagent.features(p, obs, side="actor", detach_encoder_features=detach)))(
            jparams)
        tagent.zero_grad()
        tagent.features(_t(obs), side="actor", detach_encoder_features=detach).sum().backward()
        for name in ("conv", "mlp_enc"):
            theirs = np.concatenate([np.ravel(x) for x in jax.tree_util.tree_leaves(grads[name])])
            mine = [p.grad for p in getattr(tagent, name).parameters()]
            if detach:
                assert not np.any(theirs) and all(g is None for g in mine)
            else:
                assert np.any(theirs) and all(g is not None for g in mine)
        _close(tagent.actor_cnn_fc.linear.weight.grad.T, grads["actor_cnn_fc"]["Dense_0"]["kernel"], 1e-4)
        assert tagent.critic_cnn_fc.linear.weight.grad is None


def test_decoders_match_flax():
    jagent, params, _ = jax_sac_ae()
    tagent, _ = port_sac_ae()
    feat = np.random.default_rng(1).standard_normal((3, 8 + 8)).astype(np.float32)
    theirs = {**jagent.cnn_decoder.apply({"params": params["decoder"]["cnn"]}, feat),
              **jagent.mlp_decoder.apply({"params": params["decoder"]["mlp"]}, feat)}
    ours = tagent.reconstruct(torch.from_numpy(feat))
    assert sorted(ours) == sorted(theirs) and ours["rgb"].shape == (3, 9, SCREEN, SCREEN)
    for k in theirs:
        _close(ours[k], theirs[k])


@pytest.mark.parametrize("stride,k", [(1, 3), (2, 4)], ids=["stride1-k3", "stride2-k4"])
def test_transposed_convolution_through_the_converter(stride, k):
    """A Flax VALID transposed convolution (NHWC) and the port's
    ``ConvTranspose2d`` loaded through ``deconv_from_flax`` (NCHW): the same
    map; at stride 2 also the phase-decomposed drop-in SAC-AE's decoder uses."""
    import flax.linen as fnn

    from sheeprl_tpu.ops.deconv import FusedConvTransposeS2Valid
    from sheeprl_tpu_torch.interop.flax_to_torch import deconv_from_flax, deconv_to_flax

    rng = np.random.default_rng(stride)
    x = rng.standard_normal((2, 5, 6, 4)).astype(np.float32)
    modules = [fnn.ConvTranspose(3, (k, k), strides=(stride, stride), padding="VALID")]
    if stride == 2:
        modules.append(FusedConvTransposeS2Valid(3, kernel_size=k))
    for module in modules:
        tree = filled(numpy_tree(module.init(jax.random.PRNGKey(0), x)["params"]))
        theirs = np.asarray(module.apply({"params": tree}, x))
        deconv = torch.nn.ConvTranspose2d(4, 3, k, stride=stride)
        deconv_from_flax(deconv, tree)
        ours = deconv(torch.from_numpy(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
        assert ours.shape == theirs.shape
        _close(ours, theirs)
        close_trees(deconv_to_flax(deconv), tree, 0.0)


def test_actor_log_std_is_tanh_bounded():
    """The actor's mean and std, with the log-std head scaled up so that its
    tanh reaches both ends of [-10, 2]."""
    jagent, params, _ = jax_sac_ae()
    params = jax.tree_util.tree_map(np.copy, params)
    params["actor"]["Dense_1"]["kernel"] *= 300.0
    tagent, _ = port_sac_ae(params=params)
    feat = np.random.default_rng(2).standard_normal((64, 16)).astype(np.float32)
    mean, std = jagent.actor.apply({"params": params["actor"]}, feat)
    tmean, tstd = tagent.actor(torch.from_numpy(feat))
    _close(tmean, mean)
    _close(tstd, std)
    log_std = np.log(np.asarray(std))
    assert log_std.min() < -9.9 and log_std.max() > 1.9 and np.all((log_std >= -10 - 1e-5) & (log_std <= 2 + 1e-5))


def test_params_layout_and_odd_screen():
    from sheeprl_tpu_torch.algos.sac_ae.agent import build_agent
    from sheeprl_tpu_torch.config import compose
    from sheeprl_tpu_torch.interop.flax_to_torch import sac_ae_to_flax
    from sheeprl_tpu_torch.parallel.fabric import Fabric

    _, params, _ = jax_sac_ae()
    tagent, _ = port_sac_ae()
    mine = sac_ae_to_flax(tagent)
    assert sorted(mine) == sorted(params) == sorted(
        ["conv", "mlp_enc", "critic_cnn_fc", "actor_cnn_fc", "qfs", "actor", "log_alpha", "decoder", "target"])
    close_trees(mine, params, 0.0)
    # a fresh build: the targets are copies of their modules
    fresh = sac_ae_to_flax(build_agent(Fabric(accelerator="cpu"), compose(SAC_AE_SMALL), *sac_ae_spaces(), 7))
    for k in fresh["target"]:
        close_trees(fresh["target"][k], fresh[k], 0.0)
    with pytest.raises(ValueError, match="even env.screen_size"):
        build_agent(Fabric(accelerator="cpu"), compose([*SAC_AE_SMALL, "env.screen_size=23"]), *sac_ae_spaces(23), 0)

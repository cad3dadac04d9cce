"""The port's Dreamer-V3 player half against the JAX agent, from converted params.

Encoder (cnn + mlp), the recurrent step, posterior and prior with injected
Gumbel noise, the initial state, and the actor's greedy and sampled actions
for discrete, multi-discrete and continuous control; the decoder and the
reward, continue and critic heads too. The noise comes from the
JAX key: ``jax.random.categorical(k, l) == argmax(l + jax.random.gumbel(k,
l.shape))``, so the same Gumbel (or normal) noise fed to the port gives the
same draw.

Both sides are float32 on the CPU at the small widths of the serving tests.
The stacks chain convs, matmuls and LayerNorms (Flax takes the variance as
E[x^2] - E[x]^2, PyTorch as E[(x - E[x])^2]); each adds float32 rounding, so
features agree to 1e-5 and sampled one-hots exactly.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sheeprl_tpu.algos.dreamer_v3 import agent as jdv3
from sheeprl_tpu_torch.algos.dreamer_v3 import agent as tdv3
from test_torch_helpers import paired_agents, random_obs

ATOL = 1e-5


def _t(x):
    return torch.from_numpy(np.asarray(x, dtype=np.float32).copy())


def _close(torch_out, jax_out, atol=ATOL):
    np.testing.assert_allclose(torch_out.detach().numpy(), np.asarray(jax_out), atol=atol, rtol=atol)


@pytest.fixture(scope="module")
def discrete():
    return paired_agents("discrete")


def test_encoder_cnn_and_mlp(discrete):
    jagent, params, tagent, _, _ = discrete
    obs = random_obs(np.random.default_rng(0), (5,))
    ref = jagent.encoder.apply({"params": params["world_model"]["encoder"]}, obs)
    out = tagent.encoder({k: _t(v) for k, v in obs.items()})
    assert out.shape == ref.shape
    _close(out, ref)


def test_encoder_keeps_leading_dims(discrete):
    jagent, params, tagent, _, _ = discrete
    obs = random_obs(np.random.default_rng(1), (2, 3))
    ref = jagent.encoder.apply({"params": params["world_model"]["encoder"]}, obs)
    _close(tagent.encoder({k: _t(v) for k, v in obs.items()}), ref)


def test_recurrent_step(discrete):
    jagent, params, tagent, _, _ = discrete
    rng = np.random.default_rng(2)
    z = rng.standard_normal((4, jagent.stoch_state_size)).astype(np.float32)
    a = rng.standard_normal((4, 2)).astype(np.float32)
    h = rng.standard_normal((4, jagent.recurrent_state_size)).astype(np.float32)
    ref = jagent._recurrent(params["world_model"], z, a, h)
    _close(tagent._recurrent(_t(z), _t(a), _t(h)), ref)


def test_initial_state(discrete):
    jagent, params, tagent, _, _ = discrete
    h0, z0 = jagent.initial_state(params["world_model"], (3,))
    th0, tz0 = tagent.initial_state((3,))
    _close(th0, h0)
    np.testing.assert_array_equal(tz0.numpy(), np.asarray(z0))


def test_posterior_and_prior_with_injected_gumbel(discrete):
    jagent, params, tagent, _, _ = discrete
    rng = np.random.default_rng(3)
    wm = params["world_model"]
    h = rng.standard_normal((6, jagent.recurrent_state_size)).astype(np.float32)
    embedded = rng.standard_normal((6, tagent.encoder.out_dim)).astype(np.float32)
    shape = (6, jagent.stochastic_size, jagent.discrete_size)
    for seed in range(3):
        key = jax.random.PRNGKey(seed)
        gumbel = jax.random.gumbel(key, shape).reshape(6, -1)
        logits, z = jagent._representation(wm, h, embedded, key)
        tlogits, tz = tagent._representation(_t(h), _t(embedded), _t(gumbel))
        _close(tlogits, logits)
        np.testing.assert_array_equal(tz.detach().numpy() > 0.5, np.asarray(z) > 0.5)
        _close(tz, z)
        plogits, pz = jagent._transition(wm, h, key)
        tplogits, tpz = tagent._transition(_t(h), _t(gumbel))
        _close(tplogits, plogits)
        np.testing.assert_array_equal(tpz.detach().numpy() > 0.5, np.asarray(pz) > 0.5)


@pytest.mark.parametrize("kind", ["discrete", "multidiscrete", "continuous"])
@pytest.mark.parametrize("greedy", [True, False])
def test_actor_sample(kind, greedy):
    jagent, params, tagent, _, _ = paired_agents(kind)
    rng = np.random.default_rng(4)
    latent = rng.standard_normal((5, jagent.latent_state_size)).astype(np.float32)
    pre = jagent.actor.apply({"params": params["actor"]}, latent)
    tpre = tagent.actor(_t(latent))
    for p, tp in zip(pre, tpre):
        _close(tp, p)
    for seed in range(3):
        key = jax.random.PRNGKey(10 + seed)
        ref = jdv3.actor_sample(jagent, pre, key, greedy=greedy)
        if greedy:
            noise = None
        elif kind == "continuous":
            noise = _t(jax.random.normal(key, (5, 2)))
        else:
            keys = jax.random.split(key, len(pre))
            noise = _t(jnp.concatenate([jax.random.gumbel(k, p.shape) for k, p in zip(keys, pre)], -1))
        out = tdv3.actor_sample(tagent, tpre, noise, greedy=greedy)
        _close(out, ref)


def test_decoder_and_heads(discrete):
    """The rest of the tree that build_agent makes: the decoder (transposed convs
    loaded with the spatial flip), reward, continue and critic heads."""
    jagent, params, tagent, _, _ = discrete
    wm = params["world_model"]
    latent = np.random.default_rng(5).standard_normal((3, jagent.latent_state_size)).astype(np.float32)
    ref = jagent.observation_model.apply({"params": wm["observation_model"]}, latent)
    out = tagent.world_model["observation_model"](_t(latent))
    assert sorted(out) == sorted(ref)
    for k in ref:
        assert out[k].shape == ref[k].shape
        _close(out[k], ref[k])
    for name in ("reward_model", "continue_model"):
        ref = getattr(jagent, name).apply({"params": wm[name]}, latent)
        _close(tagent.world_model[name](_t(latent)), ref)
    for name in ("critic", "target_critic"):
        _close(getattr(tagent, name)(_t(latent)), jagent.critic.apply({"params": params[name]}, latent))


def test_sampling_without_noise_raises(discrete):
    _, _, tagent, _, _ = discrete
    logits = torch.zeros(2, tagent.stoch_state_size)
    with pytest.raises(ValueError, match="Gumbel"):
        tdv3.stochastic_state(logits, tagent.discrete_size)
    with pytest.raises(ValueError, match="Gumbel"):
        tdv3.actor_sample(tagent, [torch.zeros(2, 2)], None, greedy=False)


@pytest.mark.parametrize(
    "kind,shape",
    [("linear", (384, 256)), ("conv", (64, 32, 4, 4)), ("deconv", (64, 32, 4, 4)), ("kernel", (512, 768))],
)
def test_hafner_initializer_statistics(kind, shape):
    """Truncated normal with variance 1/fan_avg, cut at 2 sigma of the
    pre-truncation scale — the statistics of Flax's variance_scaling(1.0,
    "fan_avg", "truncated_normal") on the matching kernel shape."""
    w = torch.empty(shape)
    tdv3.hafner_init_(w, kind, torch.Generator().manual_seed(0))
    fan_in, fan_out = tdv3._fans(w, kind)
    if kind == "linear":
        flax_shape = (shape[1], shape[0])
    elif kind == "conv":
        flax_shape = (shape[2], shape[3], shape[1], shape[0])
    elif kind == "deconv":
        flax_shape = (shape[2], shape[3], shape[0], shape[1])
    else:
        flax_shape = shape
    ref = np.asarray(jdv3.hafner_init(jax.random.PRNGKey(0), flax_shape))
    target = np.sqrt(2.0 / (fan_in + fan_out))
    # ~1e5 samples: the sample std is within 2% of its expectation
    assert abs(w.std().item() / target - 1) < 0.02
    assert abs(ref.std() / target - 1) < 0.02
    limit = 2 * target / tdv3._TRUNC_NORMAL_STD
    assert w.abs().max().item() <= limit * (1 + 1e-6)
    assert abs(w.abs().max().item() / np.abs(ref).max() - 1) < 0.05
    assert abs(w.mean().item()) < 3 * target / np.sqrt(w.numel())


def test_uniform_head_initializer_statistics():
    w = torch.empty(255, 512)
    tdv3.uniform_init_(w, "linear", 1.0, torch.Generator().manual_seed(0))
    ref = np.asarray(jdv3.uniform_init(1.0)(jax.random.PRNGKey(0), (512, 255)))
    limit = np.sqrt(3.0 / ((512 + 255) / 2))
    assert w.abs().max().item() <= limit
    assert abs(w.std().item() / (limit / np.sqrt(3)) - 1) < 0.02
    assert abs(ref.std() / (limit / np.sqrt(3)) - 1) < 0.02
    zeros = torch.ones(3, 3)
    tdv3.uniform_init_(zeros, "linear", 0.0, torch.Generator())
    assert not zeros.any()


def test_build_agent_from_seed_is_deterministic(discrete):
    """Fresh init (no checkpoint): the same seed gives the same weights, and the
    target critic starts as a copy of the critic."""
    from sheeprl_tpu_torch.parallel.fabric import Fabric
    from sheeprl_tpu_torch.utils.env import make_env

    _, _, _, _, cfg = discrete
    env = make_env(cfg, 0, 0)()
    fabric = Fabric(accelerator="cpu")
    a = tdv3.build_agent(fabric, (2,), False, cfg, env.observation_space, 7)
    b = tdv3.build_agent(fabric, (2,), False, cfg, env.observation_space, 7)
    for (name, pa), pb in zip(a.state_dict().items(), b.state_dict().values()):
        assert torch.equal(pa, pb), name
    for pa, pb in zip(a.critic.parameters(), a.target_critic.parameters()):
        assert torch.equal(pa, pb)
    assert not a.world_model["reward_model"].head.weight.any()  # Hafner zero head

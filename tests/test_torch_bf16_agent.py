"""The port's Dreamer-V3 blocks at the bf16 policy against the JAX agent at bf16.

Three runs of each block on the same inputs and parameters: the JAX agent
built under ``fabric.precision=bf16-true`` (its modules' ``dtype`` bf16), the
same agent in float32, and the port built under ``bf16-mixed`` (every block's
``dtype`` bf16) from the same float32 parameters, carried over by
``interop/flax_to_torch.py``. The noise of the samplers is JAX's own bf16
draw from the JAX key, fed to the port.

The bar of every block: the port's bf16 output lies closer to JAX's bf16
output than JAX's bf16 output lies to JAX's float32 output (mean absolute
distance over the output). A port that computed in float32, or rounded to
bf16 at other places than Flax does, would sit at about JAX's own bf16
distance from JAX's bf16; one that rounds where JAX rounds differs from it
only where the two libraries' float32 sums, taken in another order, round to
neighbouring bf16 values. The LN-GRU cell runs through ``ln_gru_step_reference``
on the JAX side, as the JAX package runs it on the CPU, and through the plain
math on the port's.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sheeprl_tpu.algos.dreamer_v3 import agent as jdv3
from sheeprl_tpu_torch.algos.dreamer_v3 import agent as tdv3
from test_torch_helpers import ACTIONS, _jax_agent, overrides, random_obs


@functools.lru_cache(maxsize=None)
def _jax_bf16(kind: str):
    """The JAX agent of ``kind`` at bf16 (its parameters are the float32
    agent's: the init does not depend on the compute dtype)."""
    from sheeprl_tpu.algos.dreamer_v3.agent import build_agent as jax_build
    from sheeprl_tpu.parallel.fabric import Fabric as JaxFabric

    _, params, cfg_jax, obs_space = _jax_agent(kind, (), 3)
    fabric = JaxFabric(devices=1, accelerator="cpu", precision="bf16-true")
    fabric._setup()
    jagent, _ = jax_build(fabric, *ACTIONS[kind], cfg_jax, obs_space, jax.random.PRNGKey(3), params)
    return jagent


@functools.lru_cache(maxsize=None)
def _params(kind: str):
    """The float32 agent's parameters with every all-zero leaf (the biases,
    LayerNorm shifts, the zero-initialised reward and critic heads, the
    initial state) drawn from N(0, 0.1^2), so each of them shows."""
    _, params, _, _ = _jax_agent(kind, (), 3)
    rng = np.random.default_rng(11)

    def fill(x):
        x = np.asarray(x)
        return (0.1 * rng.standard_normal(x.shape)).astype(x.dtype) if not np.any(x) else x

    return jax.tree_util.tree_map(fill, params)


def _triple(kind: str = "discrete"):
    """(JAX bf16 agent, JAX float32 agent, params, the port's bf16 agent)."""
    from sheeprl_tpu_torch.algos.dreamer_v3.agent import build_agent
    from sheeprl_tpu_torch.config import compose
    from sheeprl_tpu_torch.parallel.fabric import Fabric

    jf32, _, _, obs_space = _jax_agent(kind, (), 3)
    params = _params(kind)
    cfg = compose(overrides(kind))
    fabric = Fabric(accelerator="cpu", precision="bf16-mixed")
    tagent = build_agent(fabric, *ACTIONS[kind], cfg, obs_space, 3, params)
    assert tagent.dtype == torch.bfloat16
    return _jax_bf16(kind), jf32, params, tagent


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def _bf16(x) -> torch.Tensor:
    return torch.from_numpy(np.asarray(x, np.float32)).to(torch.bfloat16)


def _assert_closer(ours, jax_bf16, jax_f32, name: str) -> None:
    """The port's bf16 output is bf16, and its mean distance to JAX's bf16 is
    below JAX's bf16-to-float32 distance."""
    assert ours.dtype == torch.bfloat16, f"{name}: {ours.dtype}"
    assert _np(ours).shape == _np(jax_bf16).shape, name
    d_port = float(np.mean(np.abs(_np(ours) - _np(jax_bf16))))
    d_ref = float(np.mean(np.abs(_np(jax_bf16) - _np(jax_f32))))
    assert d_port < d_ref, f"{name}: port-to-JAX-bf16 {d_port:.3e} >= JAX bf16-to-f32 {d_ref:.3e}"


def test_ln_gru_cell():
    """The recurrent model (its dense stack, then the LN-GRU cell: bf16
    concat(x, h), h, kernel and bias, float32 LayerNorm parameters), and the
    cell's output dtype."""
    jbf, jf32, params, tagent = _triple()
    rng = np.random.default_rng(0)
    z = rng.standard_normal((6, jbf.stoch_state_size)).astype(np.float32)
    a = rng.standard_normal((6, 2)).astype(np.float32)
    h = rng.standard_normal((6, jbf.recurrent_state_size)).astype(np.float32)
    wm = params["world_model"]
    ref = jbf._recurrent(wm, z, a, h)
    assert ref.dtype == jnp.bfloat16
    out = tagent._recurrent(_bf16(z), torch.from_numpy(a), torch.from_numpy(h))
    _assert_closer(out, ref, jf32._recurrent(wm, z, a, h), "recurrent model")


def test_encoder_and_decoder():
    """CNN and MLP encoders (convs and dense layers without bias, float32
    LayerNorm statistics rounded once), and the decoders and heads (dense and
    transposed-conv outputs rounded, then the bias added and rounded)."""
    jbf, jf32, params, tagent = _triple()
    wm = params["world_model"]
    obs = random_obs(np.random.default_rng(1), (5,))
    ref = jbf.encoder.apply({"params": wm["encoder"]}, obs)
    out = tagent.encoder({k: torch.from_numpy(v) for k, v in obs.items()})
    _assert_closer(out, ref, jf32.encoder.apply({"params": wm["encoder"]}, obs), "encoder")

    latent = np.random.default_rng(2).standard_normal((3, jbf.latent_state_size)).astype(np.float32)
    ref = jbf.observation_model.apply({"params": wm["observation_model"]}, latent)
    ref32 = jf32.observation_model.apply({"params": wm["observation_model"]}, latent)
    out = tagent.world_model["observation_model"](_bf16(latent))
    for k in ref:
        _assert_closer(out[k], ref[k], ref32[k], f"decoder {k}")
    for name in ("reward_model", "continue_model"):
        args = ({"params": wm[name]}, latent)
        _assert_closer(
            tagent.world_model[name](_bf16(latent)), getattr(jbf, name).apply(*args), getattr(jf32, name).apply(*args), name
        )


def test_rssm_step_with_bf16_gumbel():
    """One RSSM step: the recurrent update, the unimixed prior and the
    posterior sample, whose Gumbel noise JAX draws in bf16 from the key
    (``jax.random.categorical`` over bf16 logits); the sample is the same
    one-hot where both sides' logits agree."""
    jbf, jf32, params, tagent = _triple()
    wm = params["world_model"]
    rng = np.random.default_rng(3)
    n = 6
    h = np.tanh(rng.standard_normal((n, jbf.recurrent_state_size))).astype(np.float32)
    z = np.eye(jbf.discrete_size, dtype=np.float32)[rng.integers(0, jbf.discrete_size, (n, jbf.stochastic_size))]
    z = z.reshape(n, -1)
    a = np.eye(2, dtype=np.float32)[rng.integers(0, 2, n)]
    embedded = rng.standard_normal((n, tagent.encoder.out_dim)).astype(np.float32)
    key = jax.random.PRNGKey(4)
    shape = (n, jbf.stochastic_size, jbf.discrete_size)
    gumbel = jax.random.gumbel(key, shape, jnp.bfloat16).reshape(n, -1)

    def jax_step(agent):
        hx = agent._recurrent(wm, z, a, h)
        prior = agent._transition(wm, hx, key)[0]
        post, zz = agent._representation(wm, hx, jnp.asarray(embedded, hx.dtype), key)
        return hx, prior, post, zz

    ref, ref32 = jax_step(jbf), jax_step(jf32)
    th = tagent._recurrent(_bf16(z), torch.from_numpy(a), torch.from_numpy(h))
    tprior = tagent._prior_logits(th)
    tpost, tz = tagent._representation(th, _bf16(embedded), torch.from_numpy(np.asarray(gumbel, np.float32)).to(torch.bfloat16))
    for name, ours, theirs, theirs32 in zip(("h", "prior logits", "posterior logits"), (th, tprior, tpost), ref, ref32):
        _assert_closer(ours, theirs, theirs32, name)
    assert tz.dtype == torch.bfloat16
    assert np.mean(_np(tz).argmax(-1) == _np(ref[3]).argmax(-1)) > 0.9


def test_posterior_scan():
    """The whole posterior/prior scan over T = 5 with episode starts: the
    carry stays bf16 through it, as JAX's does, and the samples are JAX's
    draws wherever the two sides' logits cannot decide them otherwise."""
    jbf, jf32, params, tagent = _triple()
    wm = params["world_model"]
    rng = np.random.default_rng(5)
    T, B = 5, 3
    embedded = rng.standard_normal((T, B, tagent.encoder.out_dim)).astype(np.float32)
    actions = np.eye(2, dtype=np.float32)[rng.integers(0, 2, (T, B))]
    is_first = np.zeros((T, B, 1), np.float32)
    is_first[0] = 1.0
    is_first[3, 1] = 1.0
    key = jax.random.PRNGKey(6)
    shape = (B, jbf.stochastic_size, jbf.discrete_size)
    gumbel = np.stack(
        [np.asarray(jax.random.gumbel(k, shape, jnp.bfloat16).astype(jnp.float32)).reshape(B, -1)
         for k in jax.random.split(key, T)]
    )
    ref = jbf.dynamic_scan(wm, jnp.asarray(embedded, jnp.bfloat16), actions, is_first, key)
    ref32 = jf32.dynamic_scan(wm, embedded, actions, is_first, key)
    out = tagent.dynamic_scan(_bf16(embedded), torch.from_numpy(actions), torch.from_numpy(is_first), _bf16(gumbel))
    for name, ours, theirs, theirs32 in zip(("hs", "zs", "posterior logits", "prior logits"), out, ref, ref32):
        if name != "zs":
            _assert_closer(ours, theirs, theirs32, name)
    assert out[1].dtype == torch.bfloat16
    _assert_same_draws(out[1], ref[1], out[2], ref[2], gumbel, jbf.discrete_size)


def _assert_same_draws(z, z_ref, logits, logits_ref, gumbel, discrete: int) -> None:
    """The scan's one-hot samples are JAX's draws. A variable whose top two
    ``logits + gumbel`` lie further apart on JAX's side than twice the two
    sides' largest logit gap at that step and row, plus 2^-5 for the bf16
    rounding of the sums near |x| < 4, is drawn alike; nearer a tie the two
    programs' sums may round apart, and once a row draws another sample the
    rest of that row follows other states, so a row is compared up to its
    first difference. At least half of the draws must be compared."""
    T, B = z.shape[:2]
    ours, theirs = (_np(x).reshape(T, B, -1, discrete).argmax(-1) for x in (z, z_ref))
    lg, lg_ref = (_np(x).reshape(T, B, -1, discrete) for x in (logits, logits_ref))
    top2 = np.sort(lg_ref + np.asarray(gumbel, np.float32).reshape(lg_ref.shape), -1)[..., -2:]
    margin = top2[..., 1] - top2[..., 0]
    gap = np.abs(lg - lg_ref).max(axis=(-2, -1))
    compared = 0
    for b in range(B):
        for t in range(T):
            differs = ours[t, b] != theirs[t, b]
            assert not np.any(differs & (margin[t, b] > 2 * gap[t, b] + 2**-5)), (t, b, margin[t, b], gap[t, b])
            compared += ours.shape[2]
            if np.any(differs):
                break
    assert compared >= ours.size / 2, (compared, ours.size)


@pytest.mark.parametrize("kind", ["discrete", "continuous"])
def test_actor_sample_with_bf16_noise(kind):
    """The actor's heads and its sample: Gumbel noise (discrete) or normal
    noise (continuous) drawn by JAX in bf16, as ``actor_sample`` draws it for
    bf16 heads."""
    jbf, jf32, params, tagent = _triple(kind)
    rng = np.random.default_rng(7)
    latent = rng.standard_normal((8, jbf.latent_state_size)).astype(np.float32)
    pre = jbf.actor.apply({"params": params["actor"]}, latent)
    pre32 = jf32.actor.apply({"params": params["actor"]}, latent)
    tpre = tagent.actor(_bf16(latent))
    for p, p32, tp in zip(pre, pre32, tpre):
        _assert_closer(tp, p, p32, "actor head")
    key = jax.random.PRNGKey(8)
    if kind == "continuous":
        noise = jax.random.normal(key, (8, 2), jnp.bfloat16)
    else:
        keys = jax.random.split(key, len(pre))
        noise = jnp.concatenate([jax.random.gumbel(k, p.shape, jnp.bfloat16) for k, p in zip(keys, pre)], -1)
    ref = jdv3.actor_sample(jbf, pre, key)
    ref32 = jdv3.actor_sample(jf32, pre32, key)
    out = tdv3.actor_sample(tagent, tpre, _bf16(np.asarray(noise.astype(jnp.float32))))
    if kind == "continuous":
        _assert_closer(out, ref, ref32, "continuous actions")
    else:
        assert out.dtype == torch.bfloat16
        np.testing.assert_array_equal(_np(out).argmax(-1), _np(ref).argmax(-1))

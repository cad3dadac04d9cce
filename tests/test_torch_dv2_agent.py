"""The port's Dreamer-V2 agent against the JAX package's, on the CPU.

- every block (the encoders and decoders, the heads, the recurrent model, the
  actor), with and without LayerNorm, from the same Flax parameters, and the
  converter's round trip; the transposed convolutions in their VALID form;
- ``TruncatedNormal``: ``rsample`` from the JAX draw's uniform noise, the
  log-prob, the mode and the mean, and the gap in the float32 ``erfinv``
  tail;
- the GRU cell without LayerNorm (Dreamer-V1's);
- both RSSM scans with the noise derived from the JAX key in JAX's split
  order, discrete and continuous actions;
- ``PlayerDV2`` over steps with masked resets and exploration noise.

Tolerances. Forward values chain convs, matmuls and LayerNorms whose sums run
in another order on each side: 1e-5, absolute and relative. The scans run 4
steps and the player 6 through the same math: 1e-5 too.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_helpers import jax_dreamer, numpy_tree, port_dreamer, random_obs, trees_close

ATOL = 1e-5
# |u - 1/2| below this keeps 2p - 1 off erfinv's float32 tail in the parity checks
U_BODY = 0.49


def _t(x):
    return torch.from_numpy(np.array(x, dtype=np.float32))


def _close(ours, theirs, atol=ATOL):
    ours = ours.detach().numpy() if isinstance(ours, torch.Tensor) else np.asarray(ours)
    np.testing.assert_allclose(ours, np.asarray(theirs), atol=atol, rtol=atol)


@pytest.mark.parametrize("layer_norm", [False, True], ids=["plain", "layer-norm"])
def test_blocks_match_flax(layer_norm):
    extra = ("algo.layer_norm=True",) if layer_norm else ()
    jagent, params, _, _ = jax_dreamer("dreamer_v2", "discrete", extra)
    tagent, _ = port_dreamer("dreamer_v2", "discrete", extra)
    from sheeprl_tpu_torch.interop.flax_to_torch import dv2_to_flax

    trees_close(dv2_to_flax(tagent), params, 0.0)
    rng = np.random.default_rng(0)
    wm = params["world_model"]
    obs = random_obs(rng, (3, 2))
    _close(tagent.encoder({k: _t(v) for k, v in obs.items()}), jagent.encoder.apply({"params": wm["encoder"]}, obs))
    latent = rng.standard_normal((3, 2, tagent.latent_state_size)).astype(np.float32)
    recon = jagent.observation_model.apply({"params": wm["observation_model"]}, latent)
    ours = tagent.world_model["observation_model"](_t(latent))
    assert sorted(ours) == sorted(recon) and ours["rgb"].shape == (3, 2, 3, 64, 64)
    for k in recon:
        _close(ours[k], recon[k])
    for name in ("reward_model", "transition_model"):
        x = latent if name == "reward_model" else latent[..., -tagent.recurrent_state_size:]
        _close(tagent.world_model[name](_t(x)), getattr(jagent, name).apply({"params": wm[name]}, x))
    rep_in = rng.standard_normal((6, tagent.recurrent_state_size + tagent.encoder.out_dim)).astype(np.float32)
    _close(tagent.world_model["representation_model"](_t(rep_in)),
           jagent.representation_model.apply({"params": wm["representation_model"]}, rep_in))
    _close(tagent.critic(_t(latent)), jagent.critic.apply({"params": params["critic"]}, latent))
    for ours_head, theirs in zip(tagent.actor(_t(latent)), jagent.actor.apply({"params": params["actor"]}, latent)):
        _close(ours_head, theirs)
    x = rng.standard_normal((6, tagent.stoch_state_size + 2)).astype(np.float32)
    h = rng.standard_normal((6, tagent.recurrent_state_size)).astype(np.float32)
    _close(tagent.world_model["recurrent_model"](_t(x), _t(h)),
           jagent.recurrent_model.apply({"params": wm["recurrent_model"]}, x, h))

    # the VALID transposed convolution alone, at both kernel sizes
    from sheeprl_tpu.ops.deconv import FusedConvTransposeS2Valid
    from sheeprl_tpu_torch.interop.flax_to_torch import deconv_from_flax

    for k in (5, 6):
        x = rng.standard_normal((2, 3, 3, 4)).astype(np.float32)
        mod = FusedConvTransposeS2Valid(5, kernel_size=k)
        var = mod.init(jax.random.PRNGKey(k), x)
        var = {"params": {"kernel": var["params"]["kernel"], "bias": jnp.linspace(-1, 1, 5)}}
        deconv = torch.nn.ConvTranspose2d(4, 5, k, stride=2)
        deconv_from_flax(deconv, numpy_tree(var["params"]))
        _close(deconv(_t(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1), mod.apply(var, x))


def test_truncated_normal_rsample_log_prob_and_erfinv_tail():
    """The port's ``rsample`` from the uniform noise JAX draws. In float32,
    ``erfinv`` near +-1 is another function on each side (XLA's polynomial
    against torch's): the parity draws keep |u - 1/2| < 0.49 with a scale of
    at least 0.4, and the tail's gap is bounded on its own."""
    from sheeprl_tpu.utils.distribution import TruncatedNormal as JaxTruncatedNormal
    from sheeprl_tpu_torch.utils.distribution import TruncatedNormal

    rng = np.random.default_rng(1)
    loc = np.tanh(rng.standard_normal((256, 3))).astype(np.float32)
    scale = (2 / (1 + np.exp(-rng.standard_normal((256, 3)))) + 0.4).astype(np.float32)
    key = jax.random.PRNGKey(5)
    theirs = JaxTruncatedNormal(jnp.asarray(loc), jnp.asarray(scale))
    u = np.asarray(jax.random.uniform(key, loc.shape, minval=1e-6, maxval=1 - 1e-6))
    ours = TruncatedNormal(_t(loc), _t(scale))
    body = np.abs(u - 0.5) < U_BODY
    _close(ours.rsample(_t(u))[body], np.asarray(theirs.rsample(key))[body])
    value = np.clip(loc + 0.3 * rng.standard_normal(loc.shape), -0.999, 0.999).astype(np.float32)
    _close(ours.log_prob(_t(value)), theirs.log_prob(value))
    _close(ours.mode, theirs.mode, 0.0)
    _close(ours.mean, theirs.mean)
    # the tail: noise at the ends of its range, where a scale of 0.1 (the
    # actor's min_std) pushes 2p - 1 to within 2e-6 of +-1
    tail = np.array([1e-6, 1e-5, 1e-4, 1 - 1e-4, 1 - 1e-5, 1 - 1e-6], np.float32)
    t_loc, t_scale = np.zeros_like(tail), np.full_like(tail, 0.1)
    p = JaxTruncatedNormal(jnp.asarray(t_loc), jnp.asarray(t_scale))
    raw_theirs = np.sqrt(2.0) * np.asarray(jax.scipy.special.erfinv(2 * (p._big_phi_alpha + tail * (p._big_phi_beta - p._big_phi_alpha)) - 1))
    raw_ours = TruncatedNormal(_t(t_loc), _t(t_scale)).rsample(_t(tail)) / 0.1
    gap = np.abs(raw_ours.numpy() - np.clip(raw_theirs, -10, 10))
    assert np.all(np.isfinite(raw_ours.numpy())) and gap.max() < 0.05, gap


def test_gru_cell_without_layer_norm():
    from sheeprl_tpu.models.models import LayerNormGRUCell as JaxCell
    from sheeprl_tpu_torch.interop.flax_to_torch import gru_from_flax, gru_to_flax
    from sheeprl_tpu_torch.models.models import LayerNormGRUCell

    rng = np.random.default_rng(2)
    x = rng.standard_normal((5, 6)).astype(np.float32)
    h = rng.standard_normal((5, 8)).astype(np.float32)
    cell = JaxCell(hidden_size=8, bias=True, layer_norm=False)
    variables = cell.init(jax.random.PRNGKey(0), h, x)
    variables = {"params": {**variables["params"], "bias": jnp.linspace(-1, 1, 24)}}
    ours = LayerNormGRUCell(6, 8, bias=True, layer_norm=False)
    gru_from_flax(ours, numpy_tree(variables["params"]))
    assert sorted(gru_to_flax(ours)) == ["bias", "kernel"] and not hasattr(ours, "ln_scale")
    _close(ours(_t(h), _t(x)), cell.apply(variables, h, x))
    with pytest.raises(ValueError, match="ln_scale"):
        gru_from_flax(LayerNormGRUCell(6, 8, bias=True), numpy_tree(variables["params"]))


def _actor_noise(key, jagent, rows: int) -> np.ndarray:
    """What DV2's ``actor_sample(agent, pre, key)`` draws for ``rows`` rows:
    uniform noise (continuous) or a Gumbel draw per head from ``split(key)``."""
    if jagent.is_continuous:
        return np.asarray(jax.random.uniform(key, (rows, sum(jagent.actions_dim)), minval=1e-6, maxval=1 - 1e-6))
    keys = jax.random.split(key, len(jagent.actions_dim))
    return np.concatenate([np.asarray(jax.random.gumbel(k, (rows, d))) for k, d in zip(keys, jagent.actions_dim)], -1)


def dv2_imagination_noise(key, jagent, rows: int, horizon: int):
    """A JAX DV2 ``imagination_scan``'s draws: per step key ``k`` of
    ``split(key, horizon)`` the action from ``fold_in(k, 1)``, then the prior
    sample from ``k``. Returns (transition, action) noise."""
    shape = (rows, jagent.stochastic_size, jagent.discrete_size)
    steps = jax.random.split(key, horizon)
    trans = np.stack([np.asarray(jax.random.gumbel(k, shape)).reshape(rows, -1) for k in steps])
    act = np.stack([_actor_noise(jax.random.fold_in(k, 1), jagent, rows) for k in steps])
    return trans, act


def _scale_actor_heads(params, factor: float):
    """The actor's heads scaled by ``factor``: a continuous actor's mean stays
    near 0 and its std near 1.1, so ``p`` of its inverse-CDF draws stays in
    [0.18, 0.82], off erfinv's float32 tail whatever the uniform noise."""
    params = jax.tree_util.tree_map(np.copy, params)
    for head in params["actor"]:
        if head.startswith("Dense_"):
            params["actor"][head]["kernel"] *= factor
    return params


def test_scans_match():
    for kind in ("discrete", "continuous"):
        jagent, params, _, _ = jax_dreamer("dreamer_v2", kind)
        params = _scale_actor_heads(params, 0.1)
        tagent, _ = port_dreamer("dreamer_v2", kind, params=params)
        T, B, H = 4, 3, 3
        rng = np.random.default_rng(3)
        wm = params["world_model"]
        embedded = rng.standard_normal((T, B, tagent.encoder.out_dim)).astype(np.float32)
        actions = rng.uniform(-1, 1, (T, B, 2)).astype(np.float32)
        is_first = np.zeros((T, B, 1), np.float32)
        is_first[2, 1] = 1.0
        key = jax.random.PRNGKey(7)
        theirs = jagent.dynamic_scan(wm, embedded, actions, is_first, key)
        noise = np.stack([np.asarray(jax.random.gumbel(k, (B, 4, 4))).reshape(B, -1) for k in jax.random.split(key, T)])
        ours = tagent.dynamic_scan(_t(embedded), _t(actions), _t(is_first), _t(noise))
        for a, b in zip(ours, theirs):
            _close(a, b)

        z0, h0 = np.asarray(theirs[1]).reshape(-1, 16), np.asarray(theirs[0]).reshape(-1, 8)
        key = jax.random.PRNGKey(8)
        latents, acts = jagent.imagination_scan(wm, params["actor"], z0, h0, key, H, 2)
        trans, act = dv2_imagination_noise(key, jagent, T * B, H)
        ours_l, ours_a = tagent.imagination_scan(_t(z0), _t(h0), H, _t(trans), _t(act))
        assert ours_l.shape == (H + 1, T * B, 24) and not ours_a[0].any()
        _close(ours_l, latents)
        _close(ours_a, acts)


def test_player_with_resets_and_exploration_noise():
    """``PlayerDV2`` against the JAX player's jitted step: the chain key split
    ``key, k_repr, k_act, k_expl``, the exploration noise of each head from
    ``fold_in(k_expl, i)`` (a uniform one-hot where a uniform draw is below
    the amount; Gaussian noise clipped for continuous actions)."""
    from sheeprl_tpu.algos.dreamer_v2.agent import PlayerDV2 as JaxPlayer
    from sheeprl_tpu_torch.algos.dreamer_v2.agent import PlayerDV2

    for kind in ("discrete", "continuous"):
        jagent, params, _, _ = jax_dreamer("dreamer_v2", kind)
        params = _scale_actor_heads(params, 0.1)
        tagent, _ = port_dreamer("dreamer_v2", kind, params=params)
        n, expl = 3, 0.5
        jp, tp = JaxPlayer(jagent, n, ("rgb",), ("state",)), PlayerDV2(tagent, n, ("rgb",), ("state",))
        jp.init_states(params)
        tp.init_states()
        rng = np.random.default_rng(4)
        key = jax.random.PRNGKey(11)
        for step in range(6):
            if step == 3:
                jp.init_states(params, [1])
                tp.init_states([1])
            obs = random_obs(rng, (n,))
            _, k_repr, k_act, k_expl = jax.random.split(key, 4)
            noise = {"repr": _t(np.asarray(jax.random.gumbel(k_repr, (n, 4, 4))).reshape(n, -1)),
                     "act": _t(_actor_noise(k_act, jagent, n))}
            if kind == "continuous":
                noise["expl"] = {"normal": _t(np.asarray(jax.random.normal(k_expl, (n, 2))))}
            else:
                draws = [jax.random.split(jax.random.fold_in(k_expl, i)) for i in range(len(jagent.actions_dim))]
                noise["expl"] = {
                    "index": torch.stack([torch.from_numpy(np.asarray(jax.random.randint(ks, (n,), 0, d)).astype(np.int64))
                                          for (ks, _), d in zip(draws, jagent.actions_dim)], -1),
                    "mask": torch.stack([_t(jax.random.uniform(km, (n,))) for _, km in draws], -1),
                }
            theirs, key = jp.get_actions(params, obs, key, expl_amount=expl)
            ours = tp.get_actions({k: _t(v) for k, v in obs.items()}, noise, expl_amount=expl)
            _close(ours, theirs)
            _close(tp.recurrent_state, jp.recurrent_state)
            _close(tp.stochastic_state, jp.stochastic_state)
        assert tp.calls == 6

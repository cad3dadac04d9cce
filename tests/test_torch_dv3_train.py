"""The port's Dreamer-V3 training slice against the JAX package, on the CPU.

- the distributions, ``categorical_kl``, ``actor_logprob_entropy``,
  ``reconstruction_loss``, ``compute_lambda_values`` and ``update_moments``;
- the posterior scan (both RSSM forms) and the imagination rollout;
- the three losses of one gradient step and their gradients, against the
  functions ``make_train_phase`` closes over, from the same parameters and
  batch; then whole steps (Adam, clipping, target EMA, Moments) against the
  jitted ``train_step``;
- the optimizers on identical gradients;
- ``PlayerDV3`` over an episode with masked resets.

The noise of every random draw is derived from the JAX key the way the JAX
code splits it (``categorical(k, l) == argmax(l + gumbel(k, l.shape))``), so
both sides take the same samples. Both sides are float32 on the CPU at the
small widths of ``tests/test_torch_helpers.py``; the JAX side takes the plain
LN-GRU reference by itself there.

Tolerances. Forward values chain convs, matmuls and LayerNorms whose sums
run in another order on each side (and Flax takes the variance as E[x^2] -
E[x]^2): 1e-5, absolute and relative. Gradients add the backward's own sums
over thousands of terms (the decoder's over every pixel): 1e-4, relative to
each tensor's largest entry when that is above 1. Parameters after Adam steps: Adam's first step
moves each weight by about its learning rate whatever the gradient's size, so
a gradient within rounding of 0 may step either way; parameters agree to 2 lr
(2e-4), and all but a few to 1e-5.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from sheeprl_tpu.algos.dreamer_v3 import agent as jdv3
from sheeprl_tpu_torch.algos.dreamer_v3 import agent as tdv3
from test_torch_helpers import ACTIONS, numpy_tree, paired_agents

ATOL = 1e-5
GRAD_ATOL = 1e-4
T, B, HORIZON = 4, 2, 3
# 16x16 frames (two conv stages) keep the JAX programs quick to compile
SCREEN = 16
TRAIN = [
    "algo.horizon=3",
    "algo.world_model.clip_gradients=1.0",
    "algo.actor.clip_gradients=1.0",
    f"env.screen_size={SCREEN}",
]


def _t(x):
    return torch.from_numpy(np.array(x, dtype=np.float32))


def _close(ours, theirs, atol=ATOL):
    ours = ours.detach().numpy() if isinstance(ours, torch.Tensor) else np.asarray(ours)
    np.testing.assert_allclose(ours, np.asarray(theirs), atol=atol, rtol=atol)


def _close_trees(ours, theirs, atol, path="", scaled=False):
    """Leaf by leaf; ``scaled`` takes ``atol`` relative to the leaf's largest
    magnitude (gradients whose sums run over many terms)."""
    if isinstance(theirs, dict):
        assert sorted(ours) == sorted(theirs), path
        for k in theirs:
            _close_trees(ours[k], theirs[k], atol, f"{path}/{k}", scaled)
        return
    theirs = np.asarray(theirs)
    tol = atol * max(1.0, float(np.abs(theirs).max(initial=0.0))) if scaled else atol
    np.testing.assert_allclose(np.asarray(ours), theirs, atol=tol, rtol=atol, err_msg=path)


# ---------------------------------------------------------------------------------
# noise from JAX keys, split as the JAX code splits them
# ---------------------------------------------------------------------------------
def _actor_noise(key, pre, continuous: bool) -> np.ndarray:
    """The noise ``actor_sample(agent, pre, key)`` draws."""
    if continuous:
        return np.asarray(jax.random.normal(key, (*pre[0].shape[:-1], pre[0].shape[-1] // 2)))
    keys = jax.random.split(key, len(pre))
    return np.concatenate([np.asarray(jax.random.gumbel(k, p.shape)) for k, p in zip(keys, pre)], -1)


def _scan_gumbel(key, n_steps: int, rows: int, jagent) -> np.ndarray:
    """``split(key, n)``, then one [rows, S, D] Gumbel draw per step key."""
    shape = (rows, jagent.stochastic_size, jagent.discrete_size)
    return np.stack(
        [np.asarray(jax.random.gumbel(k, shape)).reshape(rows, -1) for k in jax.random.split(key, n_steps)]
    )


def _imagination_noise(key, jagent, params, z0, h0, horizon: int):
    """The noise ``imagination_scan`` draws from ``key``: the first action from
    ``k0``; per step the prior sample from ``k`` and the action from
    ``fold_in(k, 1)``. The actions' noise shapes only depend on the heads."""
    k0, kscan = jax.random.split(key)
    pre = jagent.actor.apply({"params": params["actor"]}, jnp.concatenate([z0, h0], -1))
    trans, act = [], [_actor_noise(k0, pre, jagent.is_continuous)]
    shape = (z0.shape[0], jagent.stochastic_size, jagent.discrete_size)
    for k in jax.random.split(kscan, horizon):
        trans.append(np.asarray(jax.random.gumbel(k, shape)).reshape(z0.shape[0], -1))
        act.append(_actor_noise(jax.random.fold_in(k, 1), pre, jagent.is_continuous))
    return _t(np.stack(trans)), _t(np.stack(act))


def _step_noise(key, jagent, params):
    """All of one JAX ``train_step``'s draws: ``k_world, k_img = split(k)``; the
    world loss splits ``k_world`` once more before the scan. The imagined
    actions' noise shapes follow the actor heads, whatever the start states."""
    k_world, k_img = jax.random.split(jnp.asarray(key))
    k_scan, _ = jax.random.split(k_world)
    z0 = jnp.zeros((T * B, jagent.stoch_state_size))
    h0 = jnp.zeros((T * B, jagent.recurrent_state_size))
    trans, act = _imagination_noise(k_img, jagent, params, z0, h0, HORIZON)
    return {"posterior": _t(_scan_gumbel(k_scan, T, B, jagent)), "transition": trans, "action": act}


# ---------------------------------------------------------------------------------
# fixtures: one JAX build per agent kind for the whole module
# ---------------------------------------------------------------------------------
@functools.lru_cache(maxsize=None)
def _jax_variant(kind: str, decoupled: bool):
    """The JAX agent and params of a variant of the discrete agent: continuous
    actions differ only in the actor's head (both kinds have 2 action dims),
    the decoupled RSSM only in the posterior head's input (the embedding
    alone). The JAX package initializes the head that differs."""
    import dataclasses

    jagent, params, tagent, _, _ = paired_agents("discrete", TRAIN)
    params = {**params, "world_model": dict(params["world_model"])}
    if kind == "continuous":
        jagent = dataclasses.replace(jagent, is_continuous=True, actor=jagent.actor.clone(is_continuous=True))
        latent = jnp.zeros((1, jagent.latent_state_size))
        params["actor"] = numpy_tree(jagent.actor.init(jax.random.PRNGKey(1), latent)["params"])
    if decoupled:
        jagent = dataclasses.replace(jagent, decoupled_rssm=True)
        embedded = jnp.zeros((1, tagent.encoder.out_dim))
        params["world_model"]["representation_model"] = numpy_tree(
            jagent.representation_model.init(jax.random.PRNGKey(2), embedded)["params"]
        )
    return jagent, params


def _pair(kind: str, decoupled: bool = False):
    """(jax_agent, jax_params, torch_agent, cfg_jax, cfg_torch). The JAX side
    is built once; the torch agent is fresh on every call, loaded from the
    JAX parameters."""
    from sheeprl_tpu.config import compose as jax_compose
    from sheeprl_tpu_torch.algos.dreamer_v3.agent import build_agent
    from sheeprl_tpu_torch.config import compose
    from sheeprl_tpu_torch.parallel.fabric import Fabric
    from sheeprl_tpu_torch.utils.env import make_env
    from test_torch_helpers import overrides

    if kind == "discrete" and not decoupled:
        return paired_agents(kind, TRAIN)
    jagent, params = _jax_variant(kind, decoupled)
    extra = TRAIN + (["algo.world_model.decoupled_rssm=True"] if decoupled else [])
    cfg = compose(overrides(kind, extra))
    env = make_env(cfg, 0, 0)()
    tagent = build_agent(Fabric(accelerator="cpu"), *ACTIONS[kind], cfg, env.observation_space, 0, params)
    return jagent, params, tagent, jax_compose(overrides(kind, extra)), cfg


def _batch(kind: str, seed: int = 0) -> dict:
    rng = np.random.default_rng(seed)
    actions_dim, continuous = ACTIONS[kind]
    if continuous:
        actions = rng.uniform(-1, 1, (T, B, sum(actions_dim)))
    else:
        actions = np.concatenate(
            [np.eye(d)[rng.integers(0, d, (T, B))] for d in actions_dim], axis=-1
        )
    is_first = np.zeros((T, B, 1))
    is_first[2, 1] = 1.0
    terminated = np.zeros((T, B, 1))
    terminated[1, 1] = 1.0
    return {
        "rgb": rng.integers(0, 256, (T, B, 3, SCREEN, SCREEN)).astype(np.uint8),
        "state": rng.standard_normal((T, B, 10)).astype(np.float32),
        "actions": actions.astype(np.float32),
        "rewards": rng.standard_normal((T, B, 1)).astype(np.float32),
        "terminated": terminated.astype(np.float32),
        "truncated": np.zeros((T, B, 1), np.float32),
        "is_first": is_first.astype(np.float32),
    }


def _torch_batch(batch):
    return {k: torch.from_numpy(v.copy()) for k, v in batch.items()}


@functools.lru_cache(maxsize=None)
def _jax_phase(kind: str):
    """The JAX train program's pieces: the jitted ``train_step`` and the loss
    functions it closes over."""
    from sheeprl_tpu.algos.dreamer_v3.dreamer_v3 import build_optimizers, make_train_phase

    jagent, params, _, cfg_jax, _ = _pair(kind)
    world_tx, actor_tx, critic_tx, opt_state = build_optimizers(cfg_jax, params)
    phase = make_train_phase(jagent, cfg_jax, world_tx, actor_tx, critic_tx)
    fn = phase.train_step.__wrapped__
    closure = dict(zip(fn.__code__.co_freevars, (c.cell_contents for c in fn.__closure__)))
    return phase.train_step, opt_state, closure


def _trainer(kind: str):
    from sheeprl_tpu_torch.algos.dreamer_v3.dreamer_v3 import DV3Trainer, build_optimizers

    _, _, tagent, _, cfg = _pair(kind)
    return DV3Trainer(tagent, cfg, build_optimizers(cfg, tagent))


def _grad_tree(agent, params, grads, to_tree):
    """Gradients laid out as the Flax tree: swap each parameter's data for its
    gradient, convert, swap back."""
    saved = [p.data for p in params]
    try:
        for p, g in zip(params, grads):
            p.data = g if g is not None else torch.zeros_like(p)
        return to_tree(agent)
    finally:
        for p, d in zip(params, saved):
            p.data = d


# ---------------------------------------------------------------------------------
# pure math
# ---------------------------------------------------------------------------------
def test_distributions_match():
    from sheeprl_tpu.utils import distribution as jd
    from sheeprl_tpu_torch.utils import distribution as td

    rng = np.random.default_rng(0)
    x = rng.standard_normal((3, 5, 7)).astype(np.float32)
    y = rng.standard_normal((3, 5, 7)).astype(np.float32)
    s = np.abs(rng.standard_normal((3, 5, 7))).astype(np.float32) + 0.1
    inputs = {
        "x": x,
        "y": y,
        "s": s,
        "onehot": np.eye(7, dtype=np.float32)[rng.integers(0, 7, (3, 5))],
        "bins": rng.standard_normal((3, 5, 255)).astype(np.float32),
        "target": (5 * rng.standard_normal((3, 5, 1))).astype(np.float32),
        "binary": (rng.uniform(size=(3, 5, 7)) > 0.5).astype(np.float32),
        "wide": 3 * y,
    }
    # (name, constructor over a module and the inputs, value key, what to compare)
    cases = [
        ("Normal", lambda m, a: m.Normal(a["x"], a["s"]), "y", ("log_prob", "entropy", "mode", "mean")),
        ("Independent", lambda m, a: m.Independent(m.Normal(a["x"], a["s"]), 2), "y", ("log_prob", "entropy", "mode")),
        ("OneHotCategorical", lambda m, a: m.OneHotCategorical(logits=a["x"]), "onehot",
         ("log_prob", "entropy", "mode", "mean")),
        ("OneHotCategoricalStraightThrough", lambda m, a: m.OneHotCategoricalStraightThrough(logits=a["x"]), "onehot",
         ("log_prob", "entropy", "mode")),
        ("SymlogDistribution", lambda m, a: m.SymlogDistribution(a["x"], dims=1), "wide", ("log_prob", "mode")),
        ("MSEDistribution", lambda m, a: m.MSEDistribution(a["x"], dims=2), "y", ("log_prob", "mode")),
        ("TwoHotEncodingDistribution", lambda m, a: m.TwoHotEncodingDistribution(a["bins"], dims=1), "target",
         ("log_prob", "mean", "mode")),
        ("Bernoulli", lambda m, a: m.Bernoulli(logits=a["x"]), "binary", ("log_prob", "entropy", "mode", "mean")),
        ("BernoulliSafeMode", lambda m, a: m.BernoulliSafeMode(logits=a["x"]), "binary", ("log_prob", "mode")),
    ]

    def evaluate(module, arrays):
        out = {}
        for name, make, value, what in cases:
            dist = make(module, arrays)
            for attr in what:
                if attr == "log_prob":
                    out[f"{name}.{attr}"] = dist.log_prob(arrays[value])
                elif attr == "entropy":
                    out[f"{name}.{attr}"] = dist.entropy()
                else:
                    out[f"{name}.{attr}"] = getattr(dist, attr)
        return out

    theirs = jax.jit(lambda a: evaluate(jd, a))({k: jnp.asarray(v) for k, v in inputs.items()})
    ours = evaluate(td, {k: _t(v) for k, v in inputs.items()})
    assert sorted(ours) == sorted(theirs)
    for key, value in theirs.items():
        assert tuple(ours[key].shape) == value.shape, key
        np.testing.assert_allclose(ours[key].numpy(), np.asarray(value), atol=ATOL, rtol=ATOL, err_msg=key)


def test_distribution_samples_have_their_support():
    """The samplers take their noise: Gumbel-max one-hots with straight-through
    gradients, and reparameterised normals."""
    from sheeprl_tpu_torch.algos.dreamer_v3.agent import draw_gumbel
    from sheeprl_tpu_torch.utils import distribution as td

    g = torch.Generator().manual_seed(0)
    logits = torch.randn(64, 5, generator=g).requires_grad_(True)
    onehot = td.OneHotCategoricalStraightThrough(logits=logits).rsample(draw_gumbel((64, 5), g, "cpu"))
    assert torch.equal((onehot.detach() > 0.5).sum(-1), torch.ones(64, dtype=torch.long))
    onehot.sum().backward()  # the straight-through path reaches the logits
    assert logits.grad is not None
    loc, scale = torch.zeros(8, requires_grad=True), torch.full((8,), 2.0)
    noise = torch.randn(8, generator=g)
    sample = td.Independent(td.Normal(loc, scale), 1).rsample(noise)
    assert torch.equal(sample.detach(), 2.0 * noise)
    sample.sum().backward()  # reparameterised: the gradient reaches the mean
    assert torch.equal(loc.grad, torch.ones(8))


def test_two_hot_helpers_and_symexp():
    from sheeprl_tpu.utils import utils as ju
    from sheeprl_tpu_torch.utils import utils as tu

    x = np.linspace(-40, 40, 17, dtype=np.float32)[:, None]
    _close(tu.two_hot_encoder(_t(x), 20), ju.two_hot_encoder(jnp.asarray(x), 20))
    enc = np.asarray(ju.two_hot_encoder(jnp.asarray(x), 20))
    _close(tu.two_hot_decoder(_t(enc), 20), ju.two_hot_decoder(jnp.asarray(enc), 20))
    _close(tu.symexp(_t(x)), ju.symexp(jnp.asarray(x)), atol=1e-6)


@pytest.mark.parametrize("kind", ["discrete", "multidiscrete", "continuous"])
def test_categorical_kl_and_actor_logprob_entropy(kind):
    """Both functions read only the agent's action layout and actor settings:
    a stand-in agent carries them to both sides."""
    from types import SimpleNamespace

    actions_dim, continuous = ACTIONS[kind]
    agent = SimpleNamespace(
        actions_dim=actions_dim,
        is_continuous=continuous,
        actor_cfg={"init_std": 2.0, "min_std": 0.1, "max_std": 1.0, "unimix": 0.01},
    )
    rng = np.random.default_rng(1)
    post, prior = rng.standard_normal((2, 3, 2, 16)).astype(np.float32)
    _close(tdv3.categorical_kl(_t(post), _t(prior), 4), jdv3.categorical_kl(post, prior, 4))
    widths = [2 * sum(actions_dim)] if continuous else list(actions_dim)
    pre = [rng.standard_normal((3, 2, w)).astype(np.float32) for w in widths]
    actions = np.asarray(jdv3.actor_sample(agent, [jnp.asarray(p) for p in pre], jax.random.PRNGKey(2)))
    lp, ent = jdv3.actor_logprob_entropy(agent, [jnp.asarray(p) for p in pre], actions)
    tlp, tent = tdv3.actor_logprob_entropy(agent, [_t(p) for p in pre], _t(actions))
    _close(tlp, lp)
    _close(tent, ent)


def test_reconstruction_lambda_values_and_moments():
    from sheeprl_tpu.algos.dreamer_v3.loss import reconstruction_loss as jloss
    from sheeprl_tpu.algos.dreamer_v3.utils import update_moments as jmoments
    from sheeprl_tpu.utils.utils import compute_lambda_values as jlambda
    from sheeprl_tpu_torch.algos.dreamer_v3.loss import reconstruction_loss as tloss
    from sheeprl_tpu_torch.algos.dreamer_v3.utils import init_moments, update_moments as tmoments
    from sheeprl_tpu_torch.utils.utils import compute_lambda_values as tlambda

    rng = np.random.default_rng(2)
    obs = {k: rng.standard_normal((4, 3)).astype(np.float32) for k in ("rgb", "state")}
    reward = rng.standard_normal((4, 3)).astype(np.float32)
    cont = rng.standard_normal((4, 3)).astype(np.float32)
    prior = rng.standard_normal((4, 3, 16)).astype(np.float32)
    post = rng.standard_normal((4, 3, 16)).astype(np.float32)
    # free nats of 1.5: some KLs fall below and some above the clip
    kw = dict(kl_free_nats=1.5, continue_scale_factor=0.7)
    ref = jloss(obs, reward, prior, post, 4, continue_log_prob=cont, **kw)
    out = tloss({k: _t(v) for k, v in obs.items()}, _t(reward), _t(prior), _t(post), 4, continue_log_prob=_t(cont), **kw)
    for o, r in zip(out, ref):
        _close(o, r)

    r, v = rng.standard_normal((2, 5, 6, 1)).astype(np.float32)
    c = (rng.uniform(size=(5, 6, 1)) > 0.2).astype(np.float32) * 0.99
    _close(tlambda(_t(r), _t(v), _t(c), 0.95), jlambda(r, v, c, 0.95))

    state = {"low": jnp.zeros(()), "high": jnp.zeros(())}
    tstate = init_moments()
    for seed in range(3):
        x = np.random.default_rng(seed).standard_normal((15, 8, 1)).astype(np.float32) * (seed + 1)
        off, inv, state = jmoments(state, x, decay=0.9)
        toff, tinv, tstate = tmoments(tstate, _t(x), decay=0.9)
        _close(toff, off)
        _close(tinv, inv)


@pytest.mark.parametrize("weight_decay", [0.0, 0.01])
def test_optimizers_on_identical_gradients(weight_decay):
    """``adam`` (``weight_decay`` 0: Adam, > 0: AdamW) and the global-norm clip
    against ``optax.chain(clip_by_global_norm, adam/adamw)``; the gradients'
    norms straddle the clip of 1.0."""
    from sheeprl_tpu.optim import adam as jadam
    from sheeprl_tpu_torch.optim import adam as tadam, clip_grad_global_norm_

    rng = np.random.default_rng(3)
    p0 = {"a": rng.standard_normal((5, 4)).astype(np.float32), "b": rng.standard_normal(4).astype(np.float32)}
    tx = optax.chain(optax.clip_by_global_norm(1.0), jadam(lr=1e-2, eps=1e-5, weight_decay=weight_decay))
    jp, state = dict(p0), tx.init(p0)
    tp = [torch.nn.Parameter(_t(p0["a"])), torch.nn.Parameter(_t(p0["b"]))]
    opt = tadam(tp, lr=1e-2, eps=1e-5, weight_decay=weight_decay)
    assert type(opt) is (torch.optim.AdamW if weight_decay else torch.optim.Adam)
    update = jax.jit(tx.update)
    for step in range(4):
        scale = 0.1 if step % 2 else 3.0
        g = {k: (scale * rng.standard_normal(v.shape)).astype(np.float32) for k, v in p0.items()}
        updates, state = update(g, state, jp)
        jp = optax.apply_updates(jp, updates)
        tp[0].grad, tp[1].grad = _t(g["a"]), _t(g["b"])
        norm = clip_grad_global_norm_(tp, 1.0)
        _close(norm, optax.global_norm(g))
        opt.step()
        _close(tp[0], jp["a"], atol=1e-6)
        _close(tp[1], jp["b"], atol=1e-6)


# ---------------------------------------------------------------------------------
# the scans
# ---------------------------------------------------------------------------------
@pytest.mark.parametrize("decoupled", [False, True], ids=["rssm", "decoupled-rssm"])
def test_dynamic_scan(decoupled):
    jagent, params, tagent, _, _ = _pair("discrete", decoupled)
    rng = np.random.default_rng(4)
    embedded = rng.standard_normal((T, B, tagent.encoder.out_dim)).astype(np.float32)
    actions = np.eye(2, dtype=np.float32)[rng.integers(0, 2, (T, B))]
    is_first = np.zeros((T, B, 1), np.float32)
    is_first[0] = 1.0
    is_first[2, 0] = 1.0
    key = jax.random.PRNGKey(5)
    ref = jagent.dynamic_scan(params["world_model"], embedded, actions, is_first, key)
    gumbel = _t(_scan_gumbel(key, T, B, jagent))
    out = tagent.dynamic_scan(_t(embedded), _t(actions), _t(is_first), gumbel)
    for o, r, name in zip(out, ref, ("h", "z", "posterior logits", "prior logits")):
        assert tuple(o.shape) == r.shape, name
        _close(o, r)


@pytest.mark.parametrize("kind", ["discrete", "continuous"])
def test_imagination_scan(kind):
    jagent, params, tagent, _, _ = _pair(kind)
    rng = np.random.default_rng(6)
    N = T * B
    z0 = np.eye(jagent.discrete_size, dtype=np.float32)[rng.integers(0, jagent.discrete_size, (N, jagent.stochastic_size))]
    z0 = z0.reshape(N, -1)
    h0 = np.tanh(rng.standard_normal((N, jagent.recurrent_state_size))).astype(np.float32)
    key = jax.random.PRNGKey(7)
    latents, actions = jagent.imagination_scan(params["world_model"], params["actor"], z0, h0, key, HORIZON)
    trans, act = _imagination_noise(key, jagent, params, z0, h0, HORIZON)
    tlatents, tactions = tagent.imagination_scan(_t(z0), _t(h0), HORIZON, trans, act)
    assert tuple(tlatents.shape) == latents.shape and tuple(tactions.shape) == actions.shape
    _close(tlatents, latents)
    _close(tactions, actions)


# ---------------------------------------------------------------------------------
# one gradient step: losses and gradients, then whole steps
# ---------------------------------------------------------------------------------
@pytest.mark.parametrize("kind", ["discrete", "continuous"])
def test_losses_and_gradients_of_one_step(kind):
    """World, actor and critic losses and their gradients on the same
    parameters, batch and noise as ``make_train_phase``'s loss functions. The
    world loss reads the actions only as inputs, so it is held on the discrete
    agent; the actor loss takes each kind's own objective (REINFORCE for
    discrete actions, pathwise for continuous ones), from the world loss's
    states (discrete) or from random ones (continuous)."""
    from sheeprl_tpu.algos.dreamer_v3.utils import init_moments as jinit_moments
    from sheeprl_tpu_torch.interop.flax_to_torch import agent_to_flax, module_to_flax

    jagent, params, _, _, _ = _pair(kind)
    _, _, fns = _jax_phase(kind)
    trainer = _trainer(kind)
    tagent = trainer.agent
    batch = _batch(kind)
    key = jax.random.PRNGKey(8)
    k_world, k_img = jax.random.split(key)
    noise = _step_noise(key, jagent, params)

    if kind == "discrete":
        jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
        (w_loss, (zs, hs, w_metrics)), w_grads = jax.jit(jax.value_and_grad(fns["world_loss_fn"], has_aux=True))(
            params["world_model"], jbatch, k_world
        )
        tw_loss, (tzs, ths, tw_metrics) = trainer.world_loss(_torch_batch(batch), noise["posterior"])
        _close(tw_loss, w_loss)
        for name, value in w_metrics.items():
            _close(tw_metrics[name], value)
        wm_params = trainer.groups["world_model"]
        tw_grads = torch.autograd.grad(tw_loss, wm_params, allow_unused=True)
        ours = _grad_tree(tagent, wm_params, tw_grads, lambda a: agent_to_flax(a)["world_model"])
        _close_trees(ours, numpy_tree(w_grads), GRAD_ATOL, scaled=True)
    else:
        rng = np.random.default_rng(8)
        idx = rng.integers(0, jagent.discrete_size, (T, B, jagent.stochastic_size))
        zs = np.eye(jagent.discrete_size, dtype=np.float32)[idx].reshape(T, B, -1)
        hs = np.tanh(rng.standard_normal((T, B, jagent.recurrent_state_size))).astype(np.float32)
        tzs, ths = _t(zs), _t(hs)

    true_continue = (1 - batch["terminated"]).reshape(-1, 1)
    (a_loss, (latents, lambda_values, discount, _, _)), a_grads = jax.jit(
        jax.value_and_grad(fns["actor_loss_fn"], has_aux=True)
    )(params["actor"], params, zs, hs, true_continue, jinit_moments(), k_img)
    ta_loss, (tlatents, tlambda, tdiscount, _) = trainer.actor_loss(
        tzs, ths, _t(true_continue), noise["transition"], noise["action"]
    )
    _close(ta_loss, a_loss)
    _close(tlatents, latents)
    _close(tlambda, lambda_values)
    actor_params = trainer.groups["actor"]
    ta_grads = torch.autograd.grad(ta_loss, actor_params)
    ours = _grad_tree(tagent, actor_params, ta_grads, lambda a: module_to_flax(a.actor))
    _close_trees(ours, numpy_tree(a_grads), GRAD_ATOL, scaled=True)

    c_loss, c_grads = jax.jit(jax.value_and_grad(fns["critic_loss_fn"]))(
        params["critic"], params["target_critic"], latents, lambda_values, discount
    )
    tc_loss = trainer.critic_loss(tlatents.detach(), tlambda.detach(), tdiscount)
    _close(tc_loss, c_loss)
    critic_params = trainer.groups["critic"]
    tc_grads = torch.autograd.grad(tc_loss, critic_params)
    ours = _grad_tree(tagent, critic_params, tc_grads, lambda a: module_to_flax(a.critic))
    _close_trees(ours, numpy_tree(c_grads), GRAD_ATOL, scaled=True)


def test_straight_through_gradients_equal_stop_gradient_form():
    """``onehot + probs - probs.detach()`` passes the gradient of ``probs``:
    the same gradient as the JAX form with ``stop_gradient`` on both terms."""
    logits = np.random.default_rng(9).standard_normal((3, 8)).astype(np.float32)
    gumbel = np.random.default_rng(10).gumbel(size=(3, 8)).astype(np.float32)
    weights = np.random.default_rng(11).standard_normal((3, 8)).astype(np.float32)

    def jax_form(lg):
        shaped = lg.reshape(3, 2, 4)
        idx = jnp.argmax(shaped + gumbel.reshape(3, 2, 4), -1)
        onehot = jax.nn.one_hot(idx, 4)
        probs = jax.nn.softmax(shaped, -1)
        out = jax.lax.stop_gradient(onehot) + probs - jax.lax.stop_gradient(probs)
        return jnp.sum(out.reshape(3, 8) * weights)

    tl = _t(logits).requires_grad_(True)
    (tdv3.stochastic_state(tl, 4, _t(gumbel)) * _t(weights)).sum().backward()
    _close(tl.grad, jax.grad(jax_form)(jnp.asarray(logits)))


def test_train_steps_match_the_jitted_step():
    """Whole steps (target EMA, three clipped Adam updates, Moments) against
    the jitted ``train_step``: metrics at each of 3 steps, parameters after
    the 1st and the 3rd."""
    from sheeprl_tpu.algos.dreamer_v3.utils import init_moments as jinit_moments
    from sheeprl_tpu_torch.interop.flax_to_torch import agent_to_flax

    kind = "discrete"
    jagent, params0, _, _, _ = _pair(kind)
    train_step, opt_state, _ = _jax_phase(kind)
    trainer = _trainer(kind)
    params = jax.tree_util.tree_map(jnp.array, params0)
    opt_state = jax.tree_util.tree_map(jnp.array, opt_state)
    moments = jinit_moments()
    lr = 2 * max(1e-4, 8e-5)
    for step in range(3):
        batch = _batch(kind, seed=step)
        key = jax.random.PRNGKey(20 + step)
        noise = _step_noise(key, jagent, params)
        params, opt_state, moments, metrics = train_step(
            params, opt_state, moments, batch, jnp.asarray(step), np.asarray(key)
        )
        ours = trainer.train_step(_torch_batch(batch), step, noise)
        assert sorted(ours) == sorted(metrics)
        for name, value in metrics.items():
            _close(ours[name], value, atol=GRAD_ATOL)
        _close(trainer.moments["low"], moments["low"])
        _close(trainer.moments["high"], moments["high"])
        if step in (0, 2):
            theirs = numpy_tree(params)
            mine = agent_to_flax(trainer.agent)
            _close_trees(mine, theirs, lr)
            flat_mine = np.concatenate([np.ravel(x) for x in jax.tree_util.tree_leaves(mine)])
            flat_theirs = np.concatenate([np.ravel(x) for x in jax.tree_util.tree_leaves(theirs)])
            assert np.mean(np.abs(flat_mine - flat_theirs) <= 1e-5) > 0.999


# ---------------------------------------------------------------------------------
# the player
# ---------------------------------------------------------------------------------
@pytest.mark.parametrize("kind", ["discrete", "continuous"])
def test_player_over_an_episode_with_masked_resets(kind):
    from test_torch_helpers import random_obs

    jagent, params, tagent, _, _ = _pair(kind)
    n = 3
    jplayer = jdv3.PlayerDV3(jagent, n, ["rgb"], ["state"])
    tplayer = tdv3.PlayerDV3(tagent, n, ["rgb"], ["state"])
    jplayer.init_states(params)
    tplayer.init_states()
    key = jax.random.PRNGKey(11)
    rng = np.random.default_rng(12)
    resets = {2: [1], 4: [0, 2], 5: [1]}
    for step in range(7):
        if step in resets:
            jplayer.init_states(params, resets[step])
            tplayer.init_states(resets[step])
        obs = random_obs(rng, (n,), image=(3, SCREEN, SCREEN))
        _, k_repr, k_act = jax.random.split(key, 3)
        # the actor's noise shapes follow its heads, whatever the latent
        pre = jagent.actor.apply({"params": params["actor"]}, jnp.zeros((n, jagent.latent_state_size)))
        shape = (n, jagent.stochastic_size, jagent.discrete_size)
        noise = {
            "repr": _t(np.asarray(jax.random.gumbel(k_repr, shape)).reshape(n, -1)),
            "act": _t(_actor_noise(k_act, pre, jagent.is_continuous)),
        }
        actions, key = jplayer.get_actions(params, obs, key)
        tactions = tplayer.get_actions({k: _t(v) for k, v in obs.items()}, noise)
        _close(tactions, actions)
        _close(tplayer.recurrent_state, jplayer.recurrent_state)
        # one-hots plus probs - probs: 1 within a rounding either side
        _close(tplayer.stochastic_state, jplayer.stochastic_state)
    obs = random_obs(rng, (n,), image=(3, SCREEN, SCREEN))
    greedy = tplayer.get_actions({k: _t(v) for k, v in obs.items()}, greedy=True)
    assert greedy.shape == (n, sum(ACTIONS[kind][0]))


# ---------------------------------------------------------------------------------
# the entry points, end to end on the CPU
# ---------------------------------------------------------------------------------
CLI_TINY = [
    "exp=dreamer_v3",
    "env=dummy",
    "fabric.accelerator=cpu",
    "env.capture_video=False",
    "env.num_envs=2",
    f"env.screen_size={SCREEN}",
    "algo.per_rank_batch_size=2",
    "algo.per_rank_sequence_length=2",
    "algo.learning_starts=4",
    "algo.replay_ratio=0.5",
    "algo.horizon=3",
    "algo.dense_units=8",
    "algo.mlp_layers=1",
    "algo.world_model.discrete_size=4",
    "algo.world_model.stochastic_size=4",
    "algo.world_model.encoder.cnn_channels_multiplier=2",
    "algo.world_model.recurrent_model.recurrent_state_size=8",
    "algo.world_model.representation_model.hidden_size=8",
    "algo.world_model.transition_model.hidden_size=8",
    "algo.cnn_keys.encoder=[rgb]",
    "algo.mlp_keys.encoder=[state]",
    "buffer.size=64",
    "buffer.memmap=False",
    "checkpoint.every=4",
    "root_dir=tiny",
    "run_name=run",
]


def _cli(args, cwd):
    import os
    import subprocess
    import sys
    from pathlib import Path

    from test_torch_helpers import SUBPROCESS_ENV

    repo = Path(__file__).resolve().parent.parent
    env = {**os.environ, **SUBPROCESS_ENV, "PYTHONPATH": str(repo)}
    proc = subprocess.run(
        [sys.executable, "-m", "sheeprl_tpu_torch", *args], cwd=cwd, env=env, capture_output=True, text=True,
        timeout=240,
    )
    assert proc.returncode == 0, proc.stdout[-2000:] + proc.stderr[-3000:]
    return proc.stdout


def _summary(stdout: str) -> dict:
    import ast

    line = next(line for line in stdout.splitlines() if line.startswith("[sheeprl] run summary: "))
    return ast.literal_eval(line[len("[sheeprl] run summary: "):])


# the tiny Dreamer-V3 overrides and standard arguments of the JAX package's
# tests/test_algos/test_algos.py (a dry run: one iteration, its gradient steps,
# a checkpoint and a test episode)
DV3_TINY = [
    "exp=dreamer_v3",
    "env=dummy",
    "algo.per_rank_batch_size=1",
    "algo.per_rank_sequence_length=1",
    "algo.learning_starts=0",
    "algo.replay_ratio=1",
    "algo.horizon=8",
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
STANDARD_ARGS = [
    "dry_run=True",
    "env.sync_env=True",
    "env.capture_video=False",
    "fabric.accelerator=cpu",
    "metric.log_level=0",
    "checkpoint.save_last=False",
    "buffer.memmap=False",
    "env.num_envs=2",
]


@pytest.mark.parametrize("kind", ["discrete", "multidiscrete", "continuous"])
def test_cli_trains_on_the_dummy_envs(kind, tmp_path):
    """The training entry point in this process (one torch thread, as the
    subprocess below runs) with the JAX package's tiny DV3 test arguments."""
    from sheeprl_tpu_torch.cli import run
    from test_torch_helpers import ENV_IDS

    summary = run(STANDARD_ARGS + DV3_TINY + [f"env.id={ENV_IDS[kind]}"])
    assert summary["policy_steps"] == 2 and summary["gradient_steps"] == 2
    assert summary["test_reward"] is not None and (tmp_path / summary["checkpoint"]).is_file()
    assert all(np.isfinite(v) for v in summary["metrics"].values())


def test_cli_trains_resumes_and_evaluates(tmp_path, capsys):
    """Train, resume from the last checkpoint through ``python -m
    sheeprl_tpu_torch`` (the buffer, optimizers, Moments and counters come
    back), then evaluate it with the port's ``evaluation`` verb and with the
    JAX package's, which reads ``state["agent"]`` only."""
    import shutil

    import yaml

    from sheeprl_tpu_torch.__main__ import main
    from sheeprl_tpu_torch.cli import run

    first = run(CLI_TINY + ["env.id=discrete_dummy", "algo.total_steps=12"])
    ckpt = tmp_path / first["checkpoint"]
    assert first["gradient_steps"] >= 2 and ckpt.name == "ckpt_12_0.ckpt"
    assert (ckpt.parent / "ckpt_8_0.ckpt").is_file()

    resumed = _summary(
        _cli(CLI_TINY + ["env.id=discrete_dummy", "algo.total_steps=24", f"checkpoint.resume_from={ckpt}"], tmp_path)
    )
    assert resumed["log_dir"].endswith("version_1") and resumed["policy_steps"] == 24
    assert resumed["iterations"] == 6 and resumed["gradient_steps"] >= 1

    capsys.readouterr()
    assert main(["evaluation", f"checkpoint_path={ckpt}", "fabric.accelerator=cpu", "env.capture_video=False"]) == 0
    assert "Test - Reward:" in capsys.readouterr().out

    # the JAX package evaluates the port's checkpoint from a config that names its own modules
    from sheeprl_tpu.cli import evaluation as jax_evaluation

    jax_run = tmp_path / "jax_eval" / "version_0"
    (jax_run / "checkpoint").mkdir(parents=True)
    shutil.copy(ckpt, jax_run / "checkpoint" / ckpt.name)
    config = (ckpt.parent.parent / "config.yaml").read_text().replace("sheeprl_tpu_torch.", "sheeprl_tpu.")
    (jax_run / "config.yaml").write_text(config)
    assert yaml.safe_load(config)["algo"]["name"] == "dreamer_v3"
    jax_evaluation([f"checkpoint_path={jax_run / 'checkpoint' / ckpt.name}", "fabric.accelerator=cpu",
                    "env.capture_video=False"])


def test_cli_refuses_what_is_not_ported(tmp_path):
    from sheeprl_tpu_torch.cli import run

    base = CLI_TINY + ["env.id=discrete_dummy", "algo.total_steps=4"]
    for override, match in (
        ("metric.profiler.mode=run", "profiler"),
        ("buffer.prefetch.enabled=True", "prefetch"),
        ("metric.telemetry.enabled=True", "telemetry"),
    ):
        with pytest.raises(NotImplementedError, match=match):
            run(base + [override])
    with pytest.raises(RuntimeError, match="needs a CUDA device"):
        run([a for a in base if a != "fabric.accelerator=cpu"])


def test_resume_refuses_an_optax_optimizer_state(tmp_path):
    """A checkpoint of the JAX package holds optax states, which the port
    converts (tests/test_torch_optim_state.py); one that does not fit the
    trainer's optimizers (another agent's shapes, a missing group) is refused,
    never silently re-initialised."""
    from sheeprl_tpu.algos.dreamer_v3.dreamer_v3 import build_optimizers as jax_build_optimizers

    _, _, _, cfg_jax, _ = _pair("discrete")
    _, other_params, _, _, _ = _pair("continuous")
    from sheeprl_tpu.utils.checkpoint import save_checkpoint as jax_save_checkpoint
    from sheeprl_tpu_torch.utils.checkpoint import load_checkpoint, save_checkpoint

    _, _, _, opt_state = jax_build_optimizers(cfg_jax, other_params)
    jax_save_checkpoint(str(tmp_path / "jax.ckpt"), {"opt_state": opt_state})
    opt_state = load_checkpoint(str(tmp_path / "jax.ckpt"))["opt_state"]
    trainer = _trainer("discrete")
    with pytest.raises(ValueError, match="shape"):
        trainer.load_opt_state(opt_state)
    with pytest.raises(ValueError, match="groups"):
        trainer.load_opt_state({"actor": opt_state["actor"]})
    # the port's own state goes through a checkpoint and back

    save_checkpoint(str(tmp_path / "opt.ckpt"), {"opt_state": trainer.opt_state()})
    trainer.load_opt_state(load_checkpoint(str(tmp_path / "opt.ckpt"))["opt_state"])

"""The port's Dreamer-V2 gradient step against the JAX package's, on the CPU.

- ``reconstruction_loss`` (KL balancing, free nats on the averaged and on the
  per-step KL), the bootstrapped λ-returns and the log-probs;
- one gradient step against the jitted JAX ``train_step`` from the same
  parameters (every zero leaf filled, the target critic apart from the
  critic), batch and noise: on the target-critic copy's step (``cum`` 0) and
  off it (``cum`` 1) with discrete actions, on it with continuous ones;
- AdamW (the exps' ``weight_decay``) against ``optax.adamw`` step for step,
  and an ``optax.adamw`` chain state loaded into the torch optimizer.

The noise is derived from the JAX key in the JAX code's split order
(``k_world, k_img = split(k)``; the scan splits ``k_world`` per step; the
imagination as ``test_torch_dv2_agent.dv2_imagination_noise`` says).

Tolerances, as ``tests/test_torch_dv3_train.py`` states them for the
Dreamer-V3 step: metrics 1e-4 absolute and relative (gradient norms sum over
thousands of terms); parameters within 2 learning rates (Adam's first step
moves each weight by about its learning rate whatever the gradient's size, so
a gradient within rounding of 0 may step either way) and all but 0.1% within
1e-5; Adam(W) moments 1e-4 relative to each tensor's largest entry. Pure
math: 1e-5. The optimizers on identical gradients: 1e-6.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_dv2_agent import _scale_actor_heads, dv2_imagination_noise
from test_torch_helpers import ACTIONS, jax_dreamer, numpy_tree, port_dreamer

ATOL = 1e-5
GRAD_ATOL = 1e-4
T, B, HORIZON = 4, 2, 3
TRAIN = ("algo.horizon=3", "algo.world_model.clip_gradients=1.0", "algo.actor.clip_gradients=1.0")


def _close(ours, theirs, atol=ATOL):
    ours = ours.detach().numpy() if isinstance(ours, torch.Tensor) else np.asarray(ours)
    np.testing.assert_allclose(ours, np.asarray(theirs), atol=atol, rtol=atol)


def close_trees(ours, theirs, atol, path=""):
    if isinstance(theirs, dict):
        assert sorted(ours) == sorted(theirs), path
        for k in theirs:
            close_trees(ours[k], theirs[k], atol, f"{path}/{k}")
        return
    np.testing.assert_allclose(np.asarray(ours), np.asarray(theirs), atol=atol, rtol=0, err_msg=path)


def dreamer_batch(kind: str, seed: int = 0, T: int = T, B: int = B) -> dict:
    """A [T, B] replay batch of the dummy env's keys at 64 x 64, one episode
    start and one termination."""
    rng = np.random.default_rng(seed)
    actions_dim, continuous = ACTIONS[kind]
    if continuous:
        actions = rng.uniform(-1, 1, (T, B, sum(actions_dim)))
    else:
        actions = np.concatenate([np.eye(d)[rng.integers(0, d, (T, B))] for d in actions_dim], axis=-1)
    is_first = np.zeros((T, B, 1))
    is_first[2, 1] = 1.0
    terminated = np.zeros((T, B, 1))
    terminated[1, 1] = 1.0
    return {
        "rgb": rng.integers(0, 256, (T, B, 3, 64, 64)).astype(np.uint8),
        "state": rng.standard_normal((T, B, 10)).astype(np.float32),
        "actions": actions.astype(np.float32),
        "rewards": rng.standard_normal((T, B, 1)).astype(np.float32),
        "terminated": terminated.astype(np.float32),
        "truncated": np.zeros((T, B, 1), np.float32),
        "is_first": is_first.astype(np.float32),
    }


def adam_mu(state):
    """The first moment of the Adam link of an optax chain state."""
    for node in jax.tree_util.tree_leaves(state, is_leaf=lambda n: hasattr(n, "mu")):
        if hasattr(node, "mu"):
            return node.mu
    raise AssertionError("no Adam state")


def test_losses_and_lambda_values():
    from sheeprl_tpu.algos.dreamer_v2 import loss as jloss
    from sheeprl_tpu.algos.dreamer_v2 import utils as jutils
    from sheeprl_tpu_torch.algos.dreamer_v2 import loss as tloss
    from sheeprl_tpu_torch.algos.dreamer_v2 import utils as tutils

    rng = np.random.default_rng(0)
    post, prior = (rng.standard_normal((4, 3, 16)).astype(np.float32) for _ in range(2))
    obs_lp = {"rgb": rng.standard_normal((4, 3)).astype(np.float32)}
    reward_lp, cont_lp = (rng.standard_normal((4, 3)).astype(np.float32) for _ in range(2))
    for free_avg in (True, False):
        kw = dict(kl_balancing_alpha=0.8, kl_free_nats=0.5, kl_free_avg=free_avg, kl_regularizer=0.7,
                  discount_scale_factor=0.5)
        theirs = jloss.reconstruction_loss(obs_lp, reward_lp, prior, post, 4, continue_log_prob=cont_lp, **kw)
        ours = tloss.reconstruction_loss({k: torch.from_numpy(v) for k, v in obs_lp.items()}, torch.from_numpy(reward_lp),
                                         torch.from_numpy(prior), torch.from_numpy(post), 4,
                                         continue_log_prob=torch.from_numpy(cont_lp), **kw)
        for a, b in zip(ours, theirs):
            _close(a, b)
    r, v, c = (rng.standard_normal((5, 3, 1)).astype(np.float32) for _ in range(3))
    boot = rng.standard_normal((1, 3, 1)).astype(np.float32)
    _close(tutils.compute_lambda_values(*(torch.from_numpy(x) for x in (r, v, c, boot)), lmbda=0.9),
           jutils.compute_lambda_values(r, v, c, boot, lmbda=0.9))
    pred, target = rng.standard_normal((2, 4, 3, 5)).astype(np.float32)
    _close(tutils.normal1_logprob(torch.from_numpy(pred), torch.from_numpy(target), 2),
           jutils.normal1_logprob(pred, target, 2))
    soft = rng.uniform(0, 1, (4, 3, 1)).astype(np.float32)
    _close(tutils.bernoulli_logprob(torch.from_numpy(pred[..., :1]), torch.from_numpy(soft), 1),
           jutils.bernoulli_logprob(pred[..., :1], soft, 1))


@functools.lru_cache(maxsize=None)
def jax_step(kind: str):
    """The jitted JAX ``train_step`` and its initial optax states."""
    from sheeprl_tpu.algos.dreamer_v2.dreamer_v2 import make_train_phase
    from sheeprl_tpu.algos.dreamer_v3.dreamer_v3 import build_optimizers

    agent, params, cfg, _ = jax_dreamer("dreamer_v2", kind, TRAIN)
    world_tx, actor_tx, critic_tx, opt_state = build_optimizers(cfg, params)
    return make_train_phase(agent, cfg, world_tx, actor_tx, critic_tx).train_step, opt_state


def step_params(kind: str):
    """The test's parameters: the JAX agent's (zero leaves filled), the
    actor's heads scaled (continuous draws stay off erfinv's tail) and the
    target critic's kernels moved off the critic's."""
    _, params, _, _ = jax_dreamer("dreamer_v2", kind, TRAIN)
    params = _scale_actor_heads(params, 0.1)
    rng = np.random.default_rng(9)
    params["target_critic"] = jax.tree_util.tree_map(
        lambda x: (x + 0.05 * rng.standard_normal(x.shape)).astype(np.float32), params["target_critic"]
    )
    return params


def step_noise(key, jagent) -> dict:
    """One JAX DV2 ``train_step``'s draws from ``key``."""
    k_world, k_img = jax.random.split(jnp.asarray(key))
    shape = (B, jagent.stochastic_size, jagent.discrete_size)
    posterior = np.stack([np.asarray(jax.random.gumbel(k, shape)).reshape(B, -1) for k in jax.random.split(k_world, T)])
    trans, act = dv2_imagination_noise(k_img, jagent, T * B, HORIZON)
    return {k: torch.from_numpy(np.asarray(v, np.float32)) for k, v in
            (("posterior", posterior), ("transition", trans), ("action", act))}


@pytest.mark.parametrize("kind,cum", [("discrete", 0), ("discrete", 1), ("continuous", 0)],
                         ids=["copy-step", "off-copy-step", "continuous"])
def test_train_step_matches_the_jitted_step(kind, cum):
    from sheeprl_tpu_torch.algos.dreamer_v2.dreamer_v2 import make_trainer
    from sheeprl_tpu_torch.interop.flax_to_torch import dv2_group_to_torch, dv2_to_flax

    jagent, _, _, _ = jax_dreamer("dreamer_v2", kind, TRAIN)
    train_step, opt_state = jax_step(kind)
    params = step_params(kind)
    tagent, cfg = port_dreamer("dreamer_v2", kind, TRAIN, params=params)
    trainer = make_trainer(tagent, cfg)
    assert all(isinstance(opt, torch.optim.AdamW) for opt in trainer.optimizers.values())
    batch = dreamer_batch(kind, seed=cum)
    key = jax.random.PRNGKey(30 + cum)
    copy = jax.tree_util.tree_map(jnp.array, (params, opt_state))
    new_params, new_opt, metrics = train_step(*copy, batch, jnp.asarray(cum), np.asarray(key))
    ours = trainer.train_step({k: torch.from_numpy(v.copy()) for k, v in batch.items()}, cum, step_noise(key, jagent))
    assert sorted(ours) == sorted(metrics)
    for name, value in metrics.items():
        _close(ours[name], value, atol=GRAD_ATOL)

    mine, theirs = dv2_to_flax(tagent), numpy_tree(new_params)
    # the target critic: the critic's weights before the step (copied) or untouched
    close_trees(mine["target_critic"], params["critic"] if cum == 0 else params["target_critic"], 0.0)
    close_trees(mine["target_critic"], theirs["target_critic"], 0.0)
    close_trees(mine, theirs, 2 * 1e-4)
    flat_mine = np.concatenate([np.ravel(x) for x in jax.tree_util.tree_leaves(mine)])
    flat_theirs = np.concatenate([np.ravel(x) for x in jax.tree_util.tree_leaves(theirs)])
    assert np.mean(np.abs(flat_mine - flat_theirs) <= 1e-5) > 0.999
    for name, opt in trainer.optimizers.items():
        theirs_mu = dv2_group_to_torch(tagent, name)(numpy_tree(adam_mu(new_opt[name])))
        for p, mu in zip([p for g in opt.param_groups for p in g["params"]], theirs_mu):
            ref = mu.numpy()
            tol = GRAD_ATOL * max(1.0, float(np.abs(ref).max(initial=0.0)))
            np.testing.assert_allclose(opt.state[p]["exp_avg"].numpy(), ref, atol=tol, rtol=GRAD_ATOL, err_msg=name)


def test_adamw_matches_optax_and_loads_its_state(tmp_path):
    """The exps' AdamW (weight decay 1e-6, here 0.1 so that it shows) after a
    global-norm clip, three steps on identical gradients against
    ``optax.chain(clip_by_global_norm, optax.adamw)``; then the optax state,
    written by the JAX package's checkpoint, loaded into a fresh torch AdamW,
    which takes a fourth step as optax does."""
    import optax

    from sheeprl_tpu.optim import adam as jax_adam
    from sheeprl_tpu.utils.checkpoint import save_checkpoint as jax_save_checkpoint
    from sheeprl_tpu_torch.interop.optax_to_torch import load_optimizer_state
    from sheeprl_tpu_torch.optim import adam, clip_grad_global_norm_
    from sheeprl_tpu_torch.utils.checkpoint import load_checkpoint

    rng = np.random.default_rng(3)
    shapes = {"w": (5, 4), "b": (4,)}
    params = {k: rng.standard_normal(s).astype(np.float32) for k, s in shapes.items()}
    kw = dict(lr=3e-3, eps=1e-5, weight_decay=0.1)
    tx = optax.chain(optax.clip_by_global_norm(1.0), jax_adam(**kw))
    state = tx.init(params)
    ours = {k: torch.nn.Parameter(torch.from_numpy(v.copy())) for k, v in params.items()}
    opt = adam(list(ours.values()), **kw)
    assert isinstance(opt, torch.optim.AdamW)
    grads = [{k: (3 * rng.standard_normal(s)).astype(np.float32) for k, s in shapes.items()} for _ in range(4)]
    theirs = params
    for g in grads[:3]:
        updates, state = tx.update(g, state, theirs)
        theirs = optax.apply_updates(theirs, updates)
        for k, p in ours.items():
            p.grad = torch.from_numpy(g[k].copy())
        clip_grad_global_norm_(list(ours.values()), 1.0)
        opt.step()
        for k, p in ours.items():
            _close(p, theirs[k], atol=1e-6)

    jax_save_checkpoint(str(tmp_path / "opt.ckpt"), {"opt_state": state})
    fresh = {k: torch.nn.Parameter(p.detach().clone()) for k, p in ours.items()}
    loaded = adam(list(fresh.values()), **kw)
    order = list(shapes)
    load_optimizer_state(loaded, load_checkpoint(str(tmp_path / "opt.ckpt"))["opt_state"],
                         lambda tree: [torch.from_numpy(np.array(tree[k], np.float32)) for k in order])
    assert all(float(loaded.state[p]["step"]) == 3 for p in fresh.values())
    updates, state = tx.update(grads[3], state, theirs)
    theirs = optax.apply_updates(theirs, updates)
    for k, p in fresh.items():
        p.grad = torch.from_numpy(grads[3][k].copy())
    clip_grad_global_norm_(list(fresh.values()), 1.0)
    loaded.step()
    for k, p in fresh.items():
        _close(p, theirs[k], atol=1e-6)

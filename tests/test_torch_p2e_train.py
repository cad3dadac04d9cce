"""Plan2Explore (Dreamer-V3) gradient steps of the port against the JAX package's, on the CPU.

- one exploration step (target EMAs, world model, ensembles, the exploration
  actor over the intrinsic and task critics, the critics, the task actor and
  critic: seven clipped Adam updates) against the jitted JAX ``train_step``:
  every loss and metric, every parameter group, the Adam moments and the
  Moments of the task actor and of each exploration critic;
- one finetuning step (the Dreamer-V3 step on the P2E agent's world model and
  task heads) against the jitted Dreamer-V3 ``train_step`` the JAX finetuning
  loop runs on the same view of the params;
- the exploration step at bf16 against the jitted JAX step at bf16.

Both sides take the same parameters (the JAX agent's, every zero leaf
filled so that each shows), batch and noise; the noise is derived from the
JAX key in the JAX code's split order (``k_world, k_expl, k_task = split(k,
3)``; the scan splits ``k_world`` per step; each imagination rollout splits
its key as ``tests/test_torch_helpers.jax_imagination_noise`` says).

Tolerances, as ``tests/test_torch_dv3_train.py`` states them for the
Dreamer-V3 step: metrics 1e-4 absolute and relative (gradient norms sum over
thousands of terms); parameters within 2 learning rates (Adam's first step
moves each weight by about its learning rate whatever the gradient's size, so
a gradient within rounding of 0 may step either way) and all but 0.1% within
1e-5; Moments 1e-5. The bf16 step: every loss and gradient norm within 5% of
JAX's bf16 value, and the port's losses closer to JAX's bf16 losses than
JAX's bf16 losses are to its float32 ones (``tests/test_torch_bf16_train.py``
gives the reasons).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
import torch

from test_torch_dv3_train import B, HORIZON, T, TRAIN, _batch, _close, _close_trees, _torch_batch
from test_torch_helpers import (
    jax_imagination_noise,
    jax_p2e,
    jax_scan_noise,
    numpy_tree,
    port_p2e,
)

GRAD_ATOL = 1e-4
MOMENTS_ATOL = 1e-5
STEP_RTOL = 0.05
EXTRA = tuple(TRAIN)


@functools.lru_cache(maxsize=None)
def _jax_step(precision: str = "32-true"):
    """The jitted JAX P2E ``train_step`` and its initial optax states."""
    from sheeprl_tpu.algos.p2e_dv3.p2e_dv3_exploration import build_txs, make_train_phase

    agent, ensembles, params, cfg, _ = jax_p2e(EXTRA, precision)
    txs = build_txs(cfg)
    opt_state = {name: tx.init(_group(params, name)) for name, tx in txs.items()}
    return make_train_phase(agent, ensembles, cfg, txs).train_step, opt_state


def _group(params, name):
    if name.startswith("critic_exploration_"):
        return params["critics_exploration"][name[len("critic_exploration_"):]]["module"]
    return params[name]


def _jax_moments(critics):
    from sheeprl_tpu.algos.dreamer_v3.utils import init_moments

    return {"task": init_moments(), "exploration": {k: init_moments() for k in critics}}


def _noise(key, agent, dtype=None) -> dict:
    """One JAX P2E ``train_step``'s draws from ``key``."""
    k_world, k_expl, k_task = jax.random.split(jnp.asarray(key), 3)
    noise = {"posterior": jax_scan_noise(k_world, T, B, agent, dtype)}
    for role, k in (("exploration", k_expl), ("task", k_task)):
        noise[f"transition_{role}"], noise[f"action_{role}"] = jax_imagination_noise(k, agent, T * B, HORIZON, dtype)
    out = {k: torch.from_numpy(v) for k, v in noise.items()}
    return {k: v.to(torch.bfloat16) for k, v in out.items()} if dtype is not None else out


def _adam_mu(state):
    """The first moment of the Adam link of an optax chain state."""
    for node in jax.tree_util.tree_leaves(state, is_leaf=lambda n: hasattr(n, "mu")):
        if hasattr(node, "mu"):
            return node.mu
    raise AssertionError("no Adam state")


def test_exploration_step_matches_the_jitted_step():
    from sheeprl_tpu_torch.algos.p2e_dv3.p2e_dv3_exploration import make_trainer
    from sheeprl_tpu_torch.interop.flax_to_torch import p2e_group_to_torch, p2e_to_flax

    jagent, _, params, cfg_jax, _ = jax_p2e(EXTRA)
    train_step, opt_state = _jax_step()
    tagent, cfg = port_p2e(EXTRA)
    trainer = make_trainer(tagent, cfg)
    assert sorted(trainer.optimizers) == sorted(opt_state) and len(opt_state) == 7
    batch = _batch("discrete")
    key = jax.random.PRNGKey(20)
    copy = jax.tree_util.tree_map(jnp.array, (params, opt_state))
    new_params, new_opt, moments, metrics = train_step(
        *copy, _jax_moments(cfg_jax.algo.critics_exploration), batch, jnp.asarray(0), np.asarray(key)
    )
    ours = trainer.train_step(_torch_batch(batch), 0, _noise(key, jagent))
    assert sorted(ours) == sorted(metrics)
    for name, value in metrics.items():
        _close(ours[name], value, atol=GRAD_ATOL)

    mine, theirs = p2e_to_flax(tagent), numpy_tree(new_params)
    _close_trees(mine, theirs, 2 * 1e-4)
    flat_mine = np.concatenate([np.ravel(x) for x in jax.tree_util.tree_leaves(mine)])
    flat_theirs = np.concatenate([np.ravel(x) for x in jax.tree_util.tree_leaves(theirs)])
    assert np.mean(np.abs(flat_mine - flat_theirs) <= 1e-5) > 0.999
    _close_trees({k: {m: v.numpy() for m, v in d.items()} for k, d in [("task", trainer.moments["task"])]},
                 {"task": numpy_tree(moments["task"])}, MOMENTS_ATOL)
    for k, m in trainer.moments["exploration"].items():
        _close_trees({n: v.numpy() for n, v in m.items()}, numpy_tree(moments["exploration"][k]), MOMENTS_ATOL)
    # the Adam first moments, group by group (0.1 of the clipped gradient)
    for name, opt in trainer.optimizers.items():
        theirs_mu = p2e_group_to_torch(tagent, name)(numpy_tree(_adam_mu(new_opt[name])))
        params_of = [p for g in opt.param_groups for p in g["params"]]
        for p, mu in zip(params_of, theirs_mu):
            ref = mu.numpy()
            tol = GRAD_ATOL * max(1.0, float(np.abs(ref).max(initial=0.0)))
            np.testing.assert_allclose(opt.state[p]["exp_avg"].numpy(), ref, atol=tol, rtol=GRAD_ATOL, err_msg=name)


def test_finetuning_step_matches_the_dreamer_step():
    """The JAX finetuning loop trains the DV3 view of the P2E params
    (``world_model``, the task heads) with Dreamer-V3's ``make_train_phase``;
    the port's ``FinetuneTrainer`` steps the P2E agent's same modules, and
    leaves the exploration actor, critics and ensembles as they were."""
    from sheeprl_tpu.algos.dreamer_v3.dreamer_v3 import build_optimizers as jax_build_optimizers
    from sheeprl_tpu.algos.dreamer_v3.dreamer_v3 import make_train_phase
    from sheeprl_tpu.algos.dreamer_v3.utils import init_moments
    from sheeprl_tpu_torch.algos.p2e_dv3.p2e_dv3_finetuning import make_trainer
    from sheeprl_tpu_torch.interop.flax_to_torch import p2e_to_flax

    jagent, _, params, cfg_jax, _ = jax_p2e(EXTRA)
    view = {"world_model": params["world_model"], "actor": params["actor_task"], "critic": params["critic_task"],
            "target_critic": params["target_critic_task"]}
    world_tx, actor_tx, critic_tx, opt_state = jax_build_optimizers(cfg_jax, view)
    train_step = make_train_phase(jagent, cfg_jax, world_tx, actor_tx, critic_tx).train_step
    tagent, cfg = port_p2e(EXTRA)
    trainer = make_trainer(tagent, cfg)
    batch = _batch("discrete", seed=1)
    key = jax.random.PRNGKey(22)
    copy = jax.tree_util.tree_map(jnp.array, (view, opt_state))
    new_view, _, moments, metrics = train_step(*copy, init_moments(), batch, jnp.asarray(0), np.asarray(key))
    # the Dreamer-V3 step: k_world, k_img = split(k); the world loss splits k_world again
    k_world, k_img = jax.random.split(jnp.asarray(key))
    trans, act = jax_imagination_noise(k_img, jagent, T * B, HORIZON)
    noise = {"posterior": torch.from_numpy(jax_scan_noise(jax.random.split(k_world)[0], T, B, jagent)),
             "transition": torch.from_numpy(trans), "action": torch.from_numpy(act)}
    ours = trainer.train_step(_torch_batch(batch), 0, noise)
    assert sorted(ours) == sorted(metrics)
    for name, value in metrics.items():
        _close(ours[name], value, atol=GRAD_ATOL)
    _close(trainer.moments["low"], moments["low"], atol=MOMENTS_ATOL)
    mine = p2e_to_flax(tagent)
    _close_trees({"world_model": mine["world_model"], "actor": mine["actor_task"], "critic": mine["critic_task"]},
                 numpy_tree({k: new_view[k] for k in ("world_model", "actor", "critic")}), 2 * 1e-4)
    for k in ("actor_exploration", "critics_exploration", "ensembles"):
        _close_trees(mine[k], params[k], 0.0)


def test_exploration_step_at_bf16():
    from sheeprl_tpu_torch.algos.p2e_dv3.p2e_dv3_exploration import make_trainer

    jbf, _, params, cfg_jax, _ = jax_p2e(EXTRA, "bf16-true")
    metrics = {}
    key = jax.random.PRNGKey(23)
    batch = _batch("discrete", seed=2)
    for precision in ("bf16-true", "32-true"):
        train_step, opt_state = _jax_step(precision)
        copy = jax.tree_util.tree_map(jnp.array, (params, opt_state))
        metrics[precision] = train_step(
            *copy, _jax_moments(cfg_jax.algo.critics_exploration), batch, jnp.asarray(0), np.asarray(key)
        )[3]
    tagent, cfg = port_p2e(EXTRA, "bf16-mixed")
    assert tagent.dtype == torch.bfloat16
    trainer = make_trainer(tagent, cfg)
    ours = trainer.train_step(_torch_batch(batch), 0, _noise(key, jbf, jnp.bfloat16))
    assert all(p.dtype == torch.float32 for p in tagent.parameters())
    assert sorted(ours) == sorted(metrics["bf16-true"])
    jbf16 = {k: float(np.asarray(v, np.float32)) for k, v in metrics["bf16-true"].items()}
    j32 = {k: float(np.asarray(v, np.float32)) for k, v in metrics["32-true"].items()}
    mine = {k: float(v.float()) for k, v in ours.items()}
    for name in jbf16:
        assert np.isfinite(mine[name]), name
        assert abs(mine[name] - jbf16[name]) <= STEP_RTOL * max(abs(jbf16[name]), 1e-3), (name, mine[name], jbf16[name])
    losses = [k for k in jbf16 if k.startswith("Loss/")]
    d_port = sum(abs(mine[k] - jbf16[k]) / max(abs(jbf16[k]), 1e-3) for k in losses)
    d_ref = sum(abs(jbf16[k] - j32[k]) / max(abs(jbf16[k]), 1e-3) for k in losses)
    assert d_port < d_ref, (d_port, d_ref)

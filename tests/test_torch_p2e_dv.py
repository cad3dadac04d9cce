"""Plan2Explore on Dreamer-V1 and V2: the port's agents and exploration steps
against the JAX package's, on the CPU.

- the agents: the same params tree layout as the JAX build (the DV1
  ensemble predicts the observation embedding, the DV2 one the stochastic
  state), every module loaded from JAX parameters and written back unchanged;
- one P2E-DV1 exploration step (world model, ensemble, the exploration actor
  on the intrinsic reward by dynamics backpropagation, its critic, the task
  actor and critic: six clipped Adam updates) against the jitted JAX
  ``train_step``: every metric, every parameter, the Adam moments;
- one P2E-DV2 exploration step likewise, on the step that hard-copies both
  critics into their targets (``cum`` 0) and on one that does not (``cum`` 1).

Both sides take the same parameters (the JAX agent's, every zero leaf filled
so that each shows, the actors' heads scaled by 0.1 so that the continuous
actor's inverse-CDF draws stay off erfinv's float32 tail, DV2's target
critics moved off their critics so that a copy shows), batch and noise; the
noise is derived from the JAX key in the JAX code's split order (``k_world,
k_expl, k_task = split(k, 3)``; the scan splits ``k_world`` per step; each
imagination rollout splits its key per step and draws the action from
``fold_in(k, 1)``).

Tolerances, as ``tests/test_torch_dv2_train.py`` states them for the
Dreamer-V2 step: metrics 1e-4 absolute and relative (gradient norms sum over
thousands of terms, and DV1's intrinsic reward is the members' variance
times 10,000); parameters within 2 learning rates (Adam's first step moves
each weight by about its learning rate whatever the gradient's size, so a
gradient within rounding of 0 may step either way) and all but 0.1% within
1e-5; Adam(W) moments 1e-4 relative to each tensor's largest entry; a module
loaded and written back bit for bit.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_dv2_agent import _actor_noise, dv2_imagination_noise
from test_torch_dv2_train import adam_mu, close_trees, dreamer_batch
from test_torch_helpers import ACTIONS, dreamer_overrides, filled, numpy_tree

GRAD_ATOL = 1e-4
T, B, HORIZON = 4, 2, 3
TRAIN = ("algo.horizon=3", "algo.world_model.clip_gradients=1.0", "algo.actor.clip_gradients=1.0",
         "algo.ensembles.n=3")
# P2E-DV1 on the continuous dummy (its TruncatedNormal actor), P2E-DV2 on the discrete one
KIND = {1: "continuous", 2: "discrete"}


def p2e_dv_overrides(v: int, extra=()) -> list:
    base = dreamer_overrides(f"dreamer_v{v}", KIND[v], (*TRAIN, *extra))
    return [f"exp=p2e_dv{v}_exploration", *[o for o in base if not o.startswith("exp=")]]


@functools.lru_cache(maxsize=None)
def jax_p2e_dv(v: int):
    """The JAX P2E-DV agent, ensembles, params (numpy, zero leaves filled,
    the actors' heads scaled, the targets moved), config and observation
    space, built once per worker."""
    import importlib

    from sheeprl_tpu.config import compose as jax_compose
    from sheeprl_tpu.parallel.fabric import Fabric as JaxFabric
    from sheeprl_tpu.utils.env import make_env as jax_make_env

    build = importlib.import_module(f"sheeprl_tpu.algos.p2e_dv{v}.agent").build_agent
    cfg = jax_compose(p2e_dv_overrides(v))
    env = jax_make_env(cfg, 0, 0)()
    obs_space = env.observation_space
    env.close()
    fabric = JaxFabric(devices=1, accelerator="cpu")
    fabric._setup()
    agent, ensembles, params = build(fabric, *ACTIONS[KIND[v]], cfg, obs_space, jax.random.PRNGKey(3))
    params = filled(numpy_tree(params))
    for actor in ("actor_task", "actor_exploration"):
        for head in params[actor]:
            if head.startswith("Dense_"):
                params[actor][head]["kernel"] = params[actor][head]["kernel"] * 0.1
    rng = np.random.default_rng(9)
    for target in ("target_critic_task", "target_critic_exploration"):
        if target in params:
            params[target] = jax.tree_util.tree_map(
                lambda x: (x + 0.05 * rng.standard_normal(x.shape)).astype(np.float32), params[target]
            )
    return agent, ensembles, params, cfg, obs_space


def port_p2e_dv(v: int, params=None):
    import importlib

    from sheeprl_tpu_torch.config import compose
    from sheeprl_tpu_torch.parallel.fabric import Fabric

    build = importlib.import_module(f"sheeprl_tpu_torch.algos.p2e_dv{v}.agent").build_agent
    _, _, jparams, _, obs_space = jax_p2e_dv(v)
    cfg = compose(p2e_dv_overrides(v))
    agent = build(Fabric(accelerator="cpu"), *ACTIONS[KIND[v]], cfg, obs_space, 3, jparams if params is None else params)
    return agent, cfg


@functools.lru_cache(maxsize=None)
def jax_step(v: int):
    """The jitted JAX P2E-DV ``train_step`` and its initial optax states."""
    import importlib

    from sheeprl_tpu.algos.p2e_dv1.p2e_dv1_exploration import build_txs

    agent, ensembles, params, cfg, _ = jax_p2e_dv(v)
    make_train_phase = importlib.import_module(f"sheeprl_tpu.algos.p2e_dv{v}.p2e_dv{v}_exploration").make_train_phase
    txs = build_txs(cfg)
    opt_state = {name: tx.init(params[name]) for name, tx in txs.items()}
    return make_train_phase(agent, ensembles, cfg, txs).train_step, opt_state


def step_noise(v: int, key, jagent) -> dict:
    """One JAX P2E-DV ``train_step``'s draws from ``key``."""
    k_world, k_expl, k_task = jax.random.split(jnp.asarray(key), 3)
    if v == 1:
        S = jagent.stochastic_size
        noise = {"posterior": np.stack([np.asarray(jax.random.normal(k, (B, S))) for k in jax.random.split(k_world, T)])}
        for role, k in (("exploration", k_expl), ("task", k_task)):
            steps = jax.random.split(k, HORIZON)
            noise[f"transition_{role}"] = np.stack([np.asarray(jax.random.normal(s, (T * B, S))) for s in steps])
            noise[f"action_{role}"] = np.stack([_actor_noise(jax.random.fold_in(s, 1), jagent, T * B) for s in steps])
    else:
        shape = (B, jagent.stochastic_size, jagent.discrete_size)
        noise = {"posterior": np.stack([np.asarray(jax.random.gumbel(k, shape)).reshape(B, -1)
                                        for k in jax.random.split(k_world, T)])}
        for role, k in (("exploration", k_expl), ("task", k_task)):
            noise[f"transition_{role}"], noise[f"action_{role}"] = dv2_imagination_noise(k, jagent, T * B, HORIZON)
    return {k: torch.from_numpy(np.asarray(x, np.float32)) for k, x in noise.items()}


@pytest.mark.parametrize("v", [1, 2], ids=["p2e_dv1", "p2e_dv2"])
def test_agent_matches_the_jax_layout(v):
    """The port's P2E agent holds the JAX params tree whole (the same keys
    and leaf shapes), writes back what it loaded bit for bit, and its
    ensemble's members give the JAX ensemble's outputs."""
    from sheeprl_tpu_torch.interop.flax_to_torch import p2e_dv_to_flax

    _, jensembles, params, _, _ = jax_p2e_dv(v)
    tagent, _ = port_p2e_dv(v)
    close_trees(p2e_dv_to_flax(tagent), params, 0.0)
    assert tagent.ensembles.head_kernel.shape[-1] == (tagent.encoder.out_dim if v == 1 else tagent.stoch_state_size)
    rng = np.random.default_rng(v)
    x = rng.standard_normal((5, 3, tagent.ensembles.kernels[0].shape[1])).astype(np.float32)
    theirs = jensembles.apply({"params": params["ensembles"]}, x)
    np.testing.assert_allclose(tagent.ensembles(torch.from_numpy(x)).detach().numpy(), np.asarray(theirs),
                               atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("v,cum", [(1, 0), (2, 0), (2, 1)], ids=["p2e_dv1", "p2e_dv2-copy-step", "p2e_dv2-off-copy"])
def test_exploration_step_matches_the_jitted_step(v, cum):
    import importlib

    from sheeprl_tpu_torch.interop.flax_to_torch import p2e_dv_group_to_torch, p2e_dv_to_flax

    jagent, _, params, _, _ = jax_p2e_dv(v)
    train_step, opt_state = jax_step(v)
    tagent, cfg = port_p2e_dv(v)
    trainer = importlib.import_module(f"sheeprl_tpu_torch.algos.p2e_dv{v}.p2e_dv{v}_exploration").make_trainer(tagent,
                                                                                                               cfg)
    assert sorted(trainer.optimizers) == sorted(opt_state) and len(opt_state) == 6
    batch = dreamer_batch(KIND[v], seed=cum)
    key = jax.random.PRNGKey(40 + 2 * v + cum)
    copy = jax.tree_util.tree_map(jnp.array, (params, opt_state))
    args = (batch, jnp.asarray(cum), np.asarray(key)) if v == 2 else (batch, np.asarray(key))
    new_params, new_opt, metrics = train_step(*copy, *args)
    ours = trainer.train_step({k: torch.from_numpy(x.copy()) for k, x in batch.items()}, cum,
                              step_noise(v, key, jagent))
    assert sorted(ours) == sorted(metrics)
    for name, value in metrics.items():
        np.testing.assert_allclose(ours[name].numpy(), np.asarray(value), atol=GRAD_ATOL, rtol=GRAD_ATOL, err_msg=name)

    mine, theirs = p2e_dv_to_flax(tagent), numpy_tree(new_params)
    if v == 2:
        # both targets: the critics' weights before the step (copied) or untouched
        for role in ("task", "exploration"):
            before = params[f"critic_{role}"] if cum == 0 else params[f"target_critic_{role}"]
            close_trees(mine[f"target_critic_{role}"], before, 0.0)
    close_trees(mine, theirs, 2 * 1e-4)
    flat_mine = np.concatenate([np.ravel(x) for x in jax.tree_util.tree_leaves(mine)])
    flat_theirs = np.concatenate([np.ravel(x) for x in jax.tree_util.tree_leaves(theirs)])
    assert np.mean(np.abs(flat_mine - flat_theirs) <= 1e-5) > 0.999
    for name, opt in trainer.optimizers.items():
        theirs_mu = p2e_dv_group_to_torch(tagent, name)(numpy_tree(adam_mu(new_opt[name])))
        for p, mu in zip([p for g in opt.param_groups for p in g["params"]], theirs_mu):
            ref = mu.numpy()
            tol = GRAD_ATOL * max(1.0, float(np.abs(ref).max(initial=0.0)))
            np.testing.assert_allclose(opt.state[p]["exp_avg"].numpy(), ref, atol=tol, rtol=GRAD_ATOL, err_msg=name)

"""The SAC agent of the port against the JAX package's, on the CPU: the
actor, ``squash_and_logprob``, the greedy action and the critic ensemble from
converted parameters, the losses and the converter, on the same numpy inputs
and the same normal draws (taken from the JAX keys).

Tolerances: 1e-6 where both sides compute the same float32 expression; the
log-prob's bar adds what the two libraries' float32 tanh do to its
``log(scale (1 - y^2) + 1e-6)`` term (``_logprob_tol``).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_helpers import close, f32, jax_sac, port_sac, trees_close


def _logprob_tol(x_t: np.ndarray, scale, ulps: int = 3) -> np.ndarray:
    """The log-prob's bar: 1e-6, plus how far ``log(scale (1 - y^2) + 1e-6)``
    moves when ``y = tanh(x_t)`` moves by ``ulps`` float32 ulps (2^-24 near
    1), the disagreement seen between XLA's and torch's float32 tanh: steep
    where tanh saturates, and past |x| ~ 7.9 XLA's tanh is exactly +-1 where
    torch's stays three ulps inside."""
    y = np.abs(np.tanh(x_t.astype(np.float64)))
    lo, hi = np.maximum(y - ulps * 2.0**-24, 0.0), np.minimum(y + ulps * 2.0**-24, 1.0)
    spread = np.log(scale * (1 - lo**2) + 1e-6) - np.log(scale * (1 - hi**2) + 1e-6)
    return 1e-6 + spread.sum(-1, keepdims=True)


def test_actor_squash_and_greedy_match_flax():
    """Same parameters, observations and normal draws: the same mean, std,
    squashed action and greedy action (1e-6), and log-prob (1e-6 plus the
    tanh term of ``_logprob_tol``)."""
    from sheeprl_tpu.algos.sac.agent import greedy_action as jax_greedy
    from sheeprl_tpu.algos.sac.agent import squash_and_logprob as jax_squash
    from sheeprl_tpu_torch.algos.sac.agent import greedy_action, squash_and_logprob

    actor, _, params, _ = jax_sac()
    agent, _ = port_sac()
    obs = np.random.default_rng(0).standard_normal((64, 3)).astype(np.float32)
    mean, std = actor.apply({"params": params["actor"]}, obs)
    ours_mean, ours_std = agent.actor(f32(obs))
    close(ours_mean, mean)
    close(ours_std, std)
    scale, bias = jnp.asarray(actor.action_scale, jnp.float32), jnp.asarray(actor.action_bias, jnp.float32)
    np.testing.assert_array_equal(agent.actor.action_scale.numpy(), scale)
    np.testing.assert_array_equal(agent.actor.action_bias.numpy(), bias)
    key = jax.random.PRNGKey(5)
    action, logprob = jax_squash(mean, std, key, scale, bias)
    eps = jax.random.normal(key, mean.shape)
    ours_action, ours_logprob = squash_and_logprob(ours_mean, ours_std, f32(eps), agent.actor.action_scale,
                                                   agent.actor.action_bias)
    close(ours_action, action)
    gap = np.abs(ours_logprob.detach().numpy() - np.asarray(logprob))
    assert np.all(gap <= _logprob_tol(np.asarray(mean + std * eps), 2.0)), gap.max()
    close(greedy_action(ours_mean, agent.actor.action_scale, agent.actor.action_bias),
           jax_greedy(mean, scale, bias))


def test_squash_logprob_where_tanh_saturates():
    """Pre-squash values from 3 to 12: the actions agree to 1e-6 and the
    log-probs within ``_logprob_tol`` (0.54 apart at |x| = 8.2, where XLA's
    tanh rounds to +-1); up to |x| = 5 within 1e-3."""
    from sheeprl_tpu.algos.sac.agent import squash_and_logprob as jax_squash
    from sheeprl_tpu_torch.algos.sac.agent import squash_and_logprob

    x = np.array([[3.0], [5.0], [7.0], [8.2], [-8.2], [12.0]], np.float32)
    key = jax.random.PRNGKey(0)
    eps = np.asarray(jax.random.normal(key, x.shape))
    mean, std, scale, bias = x - eps, np.ones_like(x), np.float32(2.0), np.float32(0.0)
    action, logprob = jax_squash(jnp.asarray(mean), jnp.asarray(std), key, scale, bias)
    ours_action, ours_logprob = squash_and_logprob(f32(mean), f32(std), f32(eps), f32(scale), f32(bias))
    close(ours_action, action)
    gap = np.abs(ours_logprob.numpy() - np.asarray(logprob))
    assert np.all(gap <= _logprob_tol(x, 2.0)) and gap[:2].max() <= 1e-3, gap.ravel()


def test_critic_ensemble_matches_flax_member_by_member():
    """The ensemble's output column i is member i of the Flax ensemble: equal
    outputs, then a perturbation of member 1's first kernel alone moves
    column 1 alone, on both sides alike."""
    _, critic, params, _ = jax_sac()
    agent, _ = port_sac()
    rng = np.random.default_rng(1)
    obs, act = rng.standard_normal((8, 3)).astype(np.float32), rng.uniform(-2, 2, (8, 1)).astype(np.float32)
    q = critic.apply({"params": params["critic"]}, obs, act)
    assert q.shape == (8, 2)
    close(agent.critic(f32(obs), f32(act)), q)
    bumped = jax.tree_util.tree_map(np.copy, params)
    kernel = bumped["critic"]["VmapSACCritic_0"]["MLP_0"]["Dense_0"]["kernel"]
    kernel[1] += 0.5 * rng.standard_normal(kernel.shape[1:]).astype(np.float32)
    q2 = critic.apply({"params": bumped["critic"]}, obs, act)
    ours, _ = port_sac(params=bumped)
    q2_ours = ours.critic(f32(obs), f32(act))
    close(q2_ours, q2)
    np.testing.assert_array_equal(q2[:, 0], q[:, 0])
    assert np.abs(np.asarray(q2[:, 1] - q[:, 1])).min() > 0
    # the target critic started as the critic and loaded as it
    close(ours.target_critic(f32(obs), f32(act)), critic.apply({"params": bumped["target_critic"]}, obs, act))


def test_losses_match_the_jax_ones():
    from sheeprl_tpu.algos.sac import loss as jax_loss
    from sheeprl_tpu_torch.algos.sac import loss

    rng = np.random.default_rng(2)
    qf, target = rng.standard_normal((8, 3)).astype(np.float32), rng.standard_normal((8, 1)).astype(np.float32)
    logprobs, log_alpha = rng.standard_normal((8, 1)).astype(np.float32), np.array([0.3], np.float32)
    close(loss.critic_loss(f32(qf), f32(target), 3), jax_loss.critic_loss(qf, target, 3))
    close(loss.policy_loss(f32(np.exp(log_alpha)), f32(logprobs), f32(qf[:, :1])),
           jax_loss.policy_loss(np.exp(log_alpha), logprobs, qf[:, :1]))
    close(loss.entropy_loss(f32(log_alpha), f32(logprobs), -1.0), jax_loss.entropy_loss(log_alpha, logprobs, -1.0))


def test_converter_round_trips_and_matches_the_jax_tree():
    from sheeprl_tpu_torch.interop.flax_to_torch import load_sac_params, sac_group_to_torch, sac_to_flax

    _, _, params, _ = jax_sac()
    agent, _ = port_sac()
    trees_close(sac_to_flax(agent), params, atol=0.0)
    # a fresh agent (the port's own init) has the JAX tree's structure and shapes
    fresh, _ = port_sac(params=None)
    fresh.init_weights(torch.Generator().manual_seed(9))
    shapes = jax.tree_util.tree_map(np.shape, sac_to_flax(fresh))
    assert shapes == jax.tree_util.tree_map(np.shape, params)
    load_sac_params(fresh, params)
    trees_close(sac_to_flax(fresh), params, atol=0.0)
    with pytest.raises(ValueError, match="do not match"):
        load_sac_params(fresh, {**params, "critic": params["actor"]})
    # optimizer-group trees come back in the group's parameter order
    for group, module in (("actor", agent.actor), ("critic", agent.critic)):
        for ours, theirs in zip(sac_group_to_torch(agent, group)(params[group]), module.parameters()):
            assert torch.equal(ours, theirs.detach())
    assert torch.equal(sac_group_to_torch(agent, "alpha")(params["log_alpha"])[0], agent.log_alpha.detach())

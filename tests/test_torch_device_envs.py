"""The port's device env plane (``sheeprl_tpu_torch/envs/device``) against the
JAX package's ``sheeprl_tpu/envs/jax``, on the CPU.

- CartPole, Pendulum and both gridworlds, 8 envs each, stepped from the JAX
  reset's state against the jitted JAX ``VmapEnv(AutoReset(env))`` over a
  JAX-made action sequence that crosses the auto-reset boundary (short step
  budgets, so that episodes both terminate and truncate), with the reset
  states the JAX keys give passed in: observations, rewards, every ``info``
  field, the done flags and the carried episode accumulators, step by step;
- the same-step contract and the accumulators on the port alone;
- Pendulum against the port's host ``envs/classic.py::Pendulum`` (gymnasium's
  float64 formulas) over its 200-step episode.

Tolerances: float observations and rewards within 1e-6, relative above 1
(both sides compute the same float32 expressions, but XLA's and torch's
``sin``/``cos`` may round a last ulp apart and XLA may contract a multiply and
an add into one FMA; the dynamics carry such a gap through an episode: a few
ulps of Pendulum's rewards of up to ~16); the running returns within 1e-5
relative (sums of up to 20 such rewards); integer observations, flags and
lengths equal.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

E = 8
T = 40

# (id, step budget): budgets short enough that some episodes truncate
CASES = {
    "cartpole": ("CartPole-v1", 12),
    "pendulum": ("Pendulum-v1", 10),
    "gridworld_empty": ("gridworld_empty-5", 9),
    "gridworld_four_rooms": ("gridworld_four_rooms", 20),
}


def _np(x):
    return x.detach().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _jax_inner_to_torch(inner) -> torch.Tensor:
    """A JAX env state as the port's one tensor (a gridworld's (agent, goal)
    pair concatenated)."""
    if isinstance(inner, tuple):
        return torch.from_numpy(np.concatenate([np.asarray(p) for p in inner], -1).astype(np.int64))
    return torch.from_numpy(np.array(inner))


def _jax_actions(spec, key, steps: int):
    if spec.action.kind == "discrete":
        return jax.random.randint(key, (steps, E), 0, spec.action.num_actions)
    return jax.random.uniform(key, (steps, E, 1), jnp.float32, -2.5, 2.5)  # beyond the clip too


@pytest.mark.parametrize("case", list(CASES))
def test_device_env_steps_like_the_jitted_jax_env(case):
    from sheeprl_tpu.envs.jax import AutoReset as JaxAutoReset
    from sheeprl_tpu.envs.jax import VmapEnv, resolve_jax_env
    from sheeprl_tpu_torch.envs.device import AutoReset, resolve_device_env

    env_id, limit = CASES[case]
    jbare, _ = resolve_jax_env(env_id)
    jenv = VmapEnv(JaxAutoReset(jbare, max_episode_steps=limit), E)
    bare, _ = resolve_device_env(env_id)
    env = AutoReset(bare, E, "cpu", max_episode_steps=limit)
    assert env.spec.obs_shape == jenv.spec.obs_shape and env.spec.max_episode_steps == limit
    assert env.spec.action.actions_dim == jenv.spec.action.actions_dim

    jstate, jobs = jax.jit(jenv.reset)(jax.random.PRNGKey(3))
    state, obs = env.reset(inner=_jax_inner_to_torch(jstate.inner))
    np.testing.assert_allclose(_np(obs), np.asarray(jobs), rtol=0, atol=1e-6)
    actions = _jax_actions(jenv.spec, jax.random.PRNGKey(4), T)
    jstep = jax.jit(jenv.step)
    # the reset state the JAX step draws: from the second half of its key split
    reset_of = jax.jit(jax.vmap(lambda k: jbare.reset(jax.random.split(k)[1])[0]))
    dones = truncations = 0
    for t in range(T):
        reset_inner = _jax_inner_to_torch(reset_of(jstate.key))
        jstate, jobs, jrew, jdone, jinfo = jstep(jstate, actions[t])
        state, obs, rew, done, info = env.step(state, torch.from_numpy(np.array(actions[t])), reset_inner)
        np.testing.assert_allclose(_np(obs), np.asarray(jobs), rtol=1e-6, atol=1e-6, err_msg=f"obs at step {t}")
        np.testing.assert_allclose(_np(rew), np.asarray(jrew), rtol=1e-6, atol=1e-6, err_msg=f"reward at step {t}")
        np.testing.assert_array_equal(_np(done), np.asarray(jdone), err_msg=f"done at step {t}")
        for k in ("terminated", "truncated", "episode_length"):
            np.testing.assert_array_equal(_np(info[k]), np.asarray(jinfo[k]), err_msg=f"{k} at step {t}")
        np.testing.assert_allclose(_np(info["terminal_observation"]), np.asarray(jinfo["terminal_observation"]),
                                   rtol=1e-6, atol=1e-6, err_msg=f"terminal_observation at step {t}")
        np.testing.assert_allclose(_np(info["episode_return"]), np.asarray(jinfo["episode_return"]), rtol=1e-5,
                                   atol=1e-5, err_msg=f"episode_return at step {t}")
        np.testing.assert_allclose(_np(state.episode_return), np.asarray(jstate.episode_return), rtol=1e-5,
                                   atol=1e-5)
        np.testing.assert_array_equal(_np(state.episode_length), np.asarray(jstate.episode_length))
        dones += int(np.asarray(jdone).sum())
        truncations += int(np.asarray(jinfo["truncated"]).sum())
    # the sequence crossed the auto-reset boundary, by truncation too
    assert dones > 0 and truncations > 0


def test_same_step_contract_and_accumulators():
    """On the done step: the fresh reset observation comes back, the terminal
    observation rides in ``info``, the episode's return and length surface in
    ``info`` and restart from 0; truncation comes exactly at the budget and is
    apart from termination; the done envs restart from the reset draws."""
    from sheeprl_tpu_torch.envs.device import AutoReset, CartPole, Pendulum

    env = AutoReset(Pendulum(), 4, "cpu", max_episode_steps=5)
    g = torch.Generator().manual_seed(0)
    state, obs = env.reset(g)
    assert obs.shape == (4, 3) and state.episode_length.dtype == torch.int32
    total = torch.zeros(4)
    for t in range(1, 6):
        resets = env.draw_resets(1, g)[0]
        state, obs, rew, done, info = env.step(state, torch.zeros(4, 1), resets)
        total += rew
        if t < 5:
            assert not done.any() and torch.equal(state.episode_length, torch.full((4,), t, dtype=torch.int32))
            torch.testing.assert_close(state.episode_return, total)
    assert done.all() and info["truncated"].all() and not info["terminated"].any()
    torch.testing.assert_close(info["episode_return"], total)
    assert torch.equal(info["episode_length"], torch.full((4,), 5, dtype=torch.int32))
    torch.testing.assert_close(obs, Pendulum().observe(resets))  # the fresh episode's observation
    assert not torch.equal(info["terminal_observation"], obs)
    assert not state.episode_return.any() and not state.episode_length.any()
    # termination: CartPole pushed one way falls over before its budget; the
    # envs that end restart from the reset draws
    env = AutoReset(CartPole(), 3, "cpu", max_episode_steps=500)
    state, obs = env.reset(g)
    for _ in range(60):
        state, obs, rew, done, info = env.step(state, torch.ones(3, dtype=torch.int64), env.draw_resets(1, g)[0])
        if done.any():
            break
    assert done.any() and info["terminated"][done].all() and not info["truncated"].any()
    assert (info["terminal_observation"][done][:, 2].abs() > CartPole.THETA_THRESHOLD).all()
    assert (obs[done].abs() <= 0.05).all() and not state.episode_length[done].any()
    assert (info["episode_length"][done] > 0).all()


def test_pendulum_against_the_host_formulas():
    """The device Pendulum (float32) against the port's host Pendulum
    (gymnasium's float64 formulas, ``envs/classic.py``) over a 200-step
    episode from the same state and actions, and against the JAX Pendulum.

    float32 against float64 drifts as the JAX Pendulum does against gymnasium
    (1.0e-4 at step 190, ROADMAP C item 1, where the JAX package's own test
    holds it to 1e-4 and fails): here the device Pendulum drifted 3.2e-5 at
    most (8.0e-6 at step 190), held to the JAX test's 1e-4. Against the JAX
    Pendulum (both float32) the rounding gaps also grow along the episode:
    1.2e-5 at most here (about 12 ulps of a speed near its bound of 8), held
    to 5e-5."""
    from sheeprl_tpu.envs.jax import Pendulum as JaxPendulum
    from sheeprl_tpu_torch.envs.classic import Pendulum as HostPendulum
    from sheeprl_tpu_torch.envs.device import Pendulum

    dev, host, jpend = Pendulum(), HostPendulum(), JaxPendulum()
    g = torch.Generator().manual_seed(5)
    state = dev.draw((1,), g, "cpu")
    host.reset(seed=0)
    host.state = state[0].numpy().astype(np.float64)
    jstate = jnp.asarray(state[0].numpy())
    jstep = jax.jit(jpend.step)
    actions = np.random.default_rng(6).uniform(-2.0, 2.0, (200, 1)).astype(np.float32)
    drift, jax_gap = [], []
    for t in range(200):
        state, obs, rew, _ = dev.step(state, torch.from_numpy(actions[t][None]))
        hobs, hrew, _, _, _ = host.step(actions[t])
        jstate, jobs, jrew, _, _ = jstep(jstate, jnp.asarray(actions[t]))
        drift.append(float(np.abs(obs[0].numpy() - hobs).max()))
        jax_gap.append(float(np.abs(obs[0].numpy() - np.asarray(jobs)).max()))
        assert abs(float(rew[0]) - hrew) <= 1e-3 * max(1.0, abs(hrew))
    print(f"device Pendulum vs float64 formulas: max obs drift {max(drift):.3e} (step 190: {drift[190]:.3e}); "
          f"vs the JAX Pendulum {max(jax_gap):.3e}")
    assert max(drift) <= 1e-4
    assert max(jax_gap) <= 5e-5

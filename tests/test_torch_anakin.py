"""The port's Anakin program (``sheeprl_tpu_torch/algos/ppo/anakin.py``) and
Feistel shuffle (``utils/prp.py``) against the JAX package's, on the CPU.

- ``prp_permutation``: equal, index for index, to the JAX function for
  n = 2, 2^13 and 2^19, with the round keys the JAX key draws;
- ``truncation_bootstrap`` (the critic on every row, masked): equal to the
  JAX package's sparse gather and to a numpy reference;
- one whole ``anakin_step`` of each flavor (PPO on CartPole with a
  pad-wrapped last minibatch, the Feistel shuffle, the norm clip and the
  annealed learning rate; A2C on CartPole; PPO on Pendulum with a row count
  that is no power of two, so a plain permutation an epoch; PPO on a 7x7
  four-rooms gridworld, its 4 actions and integer state) against the
  jitted JAX ``anakin_step`` of ``make_anakin_program`` at a small size, from
  the same parameters, reset state, action noise, per-step reset states and
  epoch orders, all derived from the JAX keys in the order the JAX program
  splits them. The trajectory comes from the JAX rollout-only program on the
  same inputs; its returns from the JAX bootstrap and ``gae``.

Tolerances: discrete actions, dones and truncation flags equal; continuous
actions, the trajectory,
returns, losses and parameters within 1e-5 (float32 math through different
matmul kernels; losses relative); Adam's count and the schedule's count
equal.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_helpers import numpy_tree, optax_links, trees_close

ATOL = 1e-5

# (exp, overrides, envs, steps): small sizes that still truncate episodes
# (budget 10 within 16 steps) and pad-wrap or shuffle as the flavor does
CASES = {
    "ppo": ("ppo_anakin", ["algo.dense_units=16", "algo.per_rank_batch_size=48", "algo.update_epochs=2",
                           "algo.anneal_lr=True", "algo.max_grad_norm=0.5", "algo.normalize_advantages=True",
                           "algo.ent_coef=0.01", "algo.clip_vloss=True"], 8, 16),
    "a2c": ("a2c_anakin", ["algo.encoder.dense_units=16", "algo.actor.dense_units=16", "algo.critic.dense_units=16",
                           "+algo.ent_coef=0.01"], 8, 16),
    "ppo-pendulum": ("ppo_anakin", ["env.id=Pendulum-v1", "algo.dense_units=16", "algo.per_rank_batch_size=32",
                                    "algo.update_epochs=2"], 6, 16),
    "ppo-gridworld": ("ppo_anakin", ["env.id=gridworld_four_rooms-7", "algo.dense_units=16",
                                     "algo.per_rank_batch_size=64", "algo.update_epochs=1"], 8, 16),
}
TOTAL_ITERS = 4


def _overrides(case: str) -> list:
    exp, extra, envs, steps = CASES[case]
    return [f"exp={exp}", "fabric.accelerator=cpu", f"env.num_envs={envs}", f"algo.rollout_steps={steps}",
            "env.max_episode_steps=10", f"algo.total_steps={TOTAL_ITERS * envs * steps}",
            *extra]


def test_prp_permutation_equals_the_jax_one():
    from sheeprl_tpu.utils.prp import prp_permutation as jax_prp
    from sheeprl_tpu_torch.utils.prp import prp_permutation

    for n in (2, 2**13, 2**19):
        key = jax.random.PRNGKey(n + 1)
        round_keys = np.asarray(jax.random.randint(key, (8,), 0, np.iinfo(np.int32).max)).astype(np.int64)
        ours = prp_permutation(n, torch.from_numpy(round_keys)).numpy()
        np.testing.assert_array_equal(ours, np.asarray(jax_prp(key, n)))
        assert np.array_equal(np.sort(ours), np.arange(n))
    with pytest.raises(ValueError, match="power-of-two"):
        prp_permutation(96, torch.zeros(8, dtype=torch.int64))


def test_truncation_bootstrap_equals_the_jax_gather():
    from sheeprl_tpu.algos.ppo.anakin import sparse_truncation_bootstrap as jax_bootstrap
    from sheeprl_tpu_torch.algos.ppo.anakin import truncation_bootstrap

    rng = np.random.default_rng(0)
    T, E, D = 12, 5, 3
    w = rng.standard_normal((D, 1)).astype(np.float32)
    rewards = rng.standard_normal((T, E, 1)).astype(np.float32)
    terminal = rng.standard_normal((T, E, D)).astype(np.float32)
    truncated = rng.uniform(size=(T, E)) < 0.1
    truncated[-1, -1] = True  # the last row, where the JAX gather parks its fill entries
    bound = int(truncated.sum()) + 3

    def values(o):
        return o @ torch.from_numpy(w)

    args = (torch.from_numpy(rewards), torch.from_numpy(truncated), torch.from_numpy(terminal), 0.99)
    ours = truncation_bootstrap(values, *args)
    expected = rewards + np.float32(0.99) * (terminal @ w) * truncated[..., None]
    np.testing.assert_allclose(ours.numpy(), expected, rtol=0, atol=1e-6)
    theirs = jax_bootstrap(lambda o: o @ jnp.asarray(w), {"rewards": jnp.asarray(rewards),
                                                          "truncated": jnp.asarray(truncated),
                                                          "terminal_observation": jnp.asarray(terminal)},
                           0.99, T, E, bound)
    np.testing.assert_allclose(ours.numpy(), np.asarray(theirs), rtol=0, atol=1e-6)
    assert not torch.equal(ours, args[0])


def _jax_program(case: str):
    """The JAX agent, params, optimizer, fused step, rollout-only program and
    env of a case."""
    import gymnasium as gym

    from sheeprl_tpu.algos.ppo.agent import build_agent
    from sheeprl_tpu.algos.ppo.anakin import _build_optimizer, _minibatch_plan, make_anakin_program
    from sheeprl_tpu.config import compose
    from sheeprl_tpu.envs.jax import make_jax_env
    from sheeprl_tpu.parallel.fabric import Fabric

    cfg = compose(_overrides(case))
    envs = int(cfg.env.num_envs)
    fabric = Fabric(devices=1, accelerator="cpu")
    fabric._setup()
    env = make_jax_env(cfg, envs)
    spec = env.spec
    space = gym.spaces.Dict({"state": spec.to_gym_obs_space()})
    is_continuous = spec.action.kind == "continuous"
    agent, params = build_agent(fabric, spec.action.actions_dim, is_continuous, cfg, space, jax.random.PRNGKey(0))
    _, minibatches, epochs = _minibatch_plan(cfg, 1, envs)
    tx = _build_optimizer(cfg, TOTAL_ITERS, minibatches * epochs)
    fused, rollout_only, updates = make_anakin_program(agent, env, cfg, fabric, tx, spec.action.actions_dim,
                                                       is_continuous, "state", envs)
    return cfg, env, agent, params, tx, fused, rollout_only, updates


def _inner(state) -> np.ndarray:
    """A JAX env state as the port's one array (a gridworld's (agent, goal)
    pair concatenated)."""
    if isinstance(state, tuple):
        return np.concatenate([np.asarray(p) for p in state], -1).astype(np.int64)
    return np.array(state)


def _jax_draws(env, key, T: int, E: int, actions_dim, is_continuous: bool, epochs: int, rows: int, use_prp: bool,
               env_key):
    """The draws of one JAX ``anakin_step`` from its key: the action noise of
    each step, the reset state each step's auto-reset draws from the env
    state's per-env keys, and the epochs' round keys or permutations."""
    bare = env.env.env
    key, train_key = jax.random.split(key)
    noise = []
    for _ in range(T):
        key, step_key = jax.random.split(key)
        if is_continuous:
            noise.append(np.asarray(jax.random.normal(step_key, (E, sum(actions_dim)))))
        else:
            noise.append(np.asarray(jax.random.gumbel(jax.random.split(step_key, 1)[0], (E, actions_dim[0]))))
    resets, k = [], env_key
    split_env = jax.jit(jax.vmap(jax.random.split))
    reset_of = jax.jit(jax.vmap(lambda kk: bare.reset(kk)[0]))
    for _ in range(T):
        pair = split_env(k)
        resets.append(_inner(reset_of(pair[:, 1])))
        k = pair[:, 0]
    orders = []
    for epoch_key in jax.random.split(train_key, epochs):
        if use_prp:
            orders.append(np.asarray(jax.random.randint(epoch_key, (8,), 0, np.iinfo(np.int32).max)).astype(np.int64))
        else:
            orders.append(np.asarray(jax.random.permutation(epoch_key, rows)).astype(np.int64))
    return np.stack(noise), np.stack(resets), orders


@pytest.mark.parametrize("case", list(CASES))
def test_anakin_step_matches_the_jitted_jax_step(case):
    from sheeprl_tpu.algos.ppo.anakin import sparse_truncation_bootstrap as jax_bootstrap
    from sheeprl_tpu.utils.utils import gae as jax_gae
    from sheeprl_tpu_torch.algos.ppo.agent import build_agent
    from sheeprl_tpu_torch.algos.ppo.anakin import AnakinProgram, build_optimizer
    from sheeprl_tpu_torch.config import compose
    from sheeprl_tpu_torch.envs import spaces
    from sheeprl_tpu_torch.envs.device import make_device_env
    from sheeprl_tpu_torch.interop.flax_to_torch import ppo_to_flax
    from sheeprl_tpu_torch.parallel.fabric import Fabric

    cfg_jax, jenv, jagent, params, tx, fused, rollout_only, updates = _jax_program(case)
    params = numpy_tree(params)
    E, T = int(cfg_jax.env.num_envs), int(cfg_jax.algo.rollout_steps)
    spec = jenv.spec
    is_continuous = spec.action.kind == "continuous"
    actions_dim = spec.action.actions_dim

    # the port, from the same parameters and config
    cfg = compose(_overrides(case))
    env = make_device_env(cfg, E, "cpu")
    space = spaces.Dict({"state": env.spec.to_obs_space()})
    agent = build_agent(Fabric(accelerator="cpu"), actions_dim, is_continuous, cfg, space, 0, params)
    optimizer, schedule = build_optimizer(cfg, agent, TOTAL_ITERS, updates)
    program = AnakinProgram(agent, env, cfg, optimizer, schedule, "state")
    assert program.updates_per_iter == updates

    # the JAX side: the rollout alone (for its trajectory), then the fused step
    env_state, obs = jax.jit(jenv.reset)(jax.random.PRNGKey(1))
    key = jax.random.PRNGKey(2)
    noise, resets, orders = _jax_draws(jenv, key, T, E, actions_dim, is_continuous, program.update_epochs,
                                       program.num_rows, program.use_prp, env_state.key)
    assert len(orders) == program.update_epochs and (case == "a2c") == program.single_full_batch
    _, _, _, jtraj, jstats = rollout_only(params, env_state, obs, jax.random.split(key)[0])
    jtraj = numpy_tree(jtraj)

    def critic(o):
        return jagent.apply({"params": params}, {"state": o}, method=lambda m, x: m.critic(m.feature_extractor(x)))

    # the port's step, then the JAX one (which donates its inputs)
    state, pobs = env.reset(inner=torch.from_numpy(_inner(env_state.inner)))
    inputs = {"noise": torch.from_numpy(noise), "resets": torch.from_numpy(resets),
              "orders": [] if program.single_full_batch else [torch.from_numpy(o) for o in orders]}
    out = program.step(state, pobs, inputs, 0.2, float(cfg.algo.get("ent_coef", 0.0)))
    stats = {k: jnp.float32(0.0) for k in ("ep_return_sum", "ep_length_sum", "ep_count")}
    stats["losses"] = jnp.zeros((3,), jnp.float32)
    opt_state = tx.init(params)
    new_params, new_opt_state, _, jobs_after, _, new_stats, _ = fused(
        params, opt_state, env_state, obs, key, stats, np.float32(0.2), np.float32(cfg_jax.algo.get("ent_coef", 0.0))
    )

    traj = {k: v.numpy() for k, v in out.traj.items()}
    if is_continuous:  # a sample loc + scale * noise, rounded as each side's matmuls give loc and scale
        np.testing.assert_allclose(traj["actions"], jtraj["actions"], rtol=ATOL, atol=ATOL)
    else:
        np.testing.assert_array_equal(traj["actions"], jtraj["actions"])
    np.testing.assert_array_equal(traj["dones"], jtraj["dones"])
    np.testing.assert_array_equal(traj["truncated"], jtraj["truncated"])
    # episodes truncated; CartPole's also terminated (Pendulum never does)
    assert traj["truncated"].any() and (is_continuous or traj["dones"].sum() > traj["truncated"].sum())
    for k in ("state", "logprobs", "values", "rewards", "terminal_observation"):
        np.testing.assert_allclose(traj[k], jtraj[k], rtol=ATOL, atol=ATOL, err_msg=k)
    np.testing.assert_allclose(out.ep_stats.numpy(), np.asarray(jstats), rtol=ATOL, atol=ATOL)
    np.testing.assert_allclose(out.obs.numpy(), np.asarray(jobs_after), rtol=ATOL, atol=ATOL)

    # returns: the JAX bootstrap and GAE on the JAX trajectory
    jrewards = jax_bootstrap(critic, {k: jnp.asarray(v) for k, v in jtraj.items()}, cfg_jax.algo.gamma, T, E,
                             min(E * (1 + T // 10), T * E))  # the JAX program's bound
    jreturns, jadv = jax_gae(jrewards, jnp.asarray(jtraj["values"]), jnp.asarray(jtraj["dones"]),
                             critic(jnp.asarray(jobs_after)), T, cfg_jax.algo.gamma, cfg_jax.algo.gae_lambda)
    np.testing.assert_allclose(out.returns.numpy(), np.asarray(jreturns), rtol=ATOL, atol=ATOL)
    np.testing.assert_allclose(out.advantages.numpy(), np.asarray(jadv), rtol=ATOL, atol=ATOL)

    # the update: losses, parameters, Adam's and the schedule's counts
    np.testing.assert_allclose(out.losses.numpy(), np.asarray(new_stats["losses"]), rtol=ATOL, atol=1e-6)
    trees_close(ppo_to_flax(agent), new_params, ATOL)
    links = optax_links(new_opt_state)
    if "ScaleByAdamState" in links:
        counts = {int(optimizer.state[p]["step"]) for p in agent.parameters()}
        assert counts == {int(links["ScaleByAdamState"].count)} == {updates}
    if "ScaleByScheduleState" in links:
        assert {g["schedule_count"] for g in optimizer.param_groups} == {int(links["ScaleByScheduleState"].count)}

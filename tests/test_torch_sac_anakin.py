"""One iteration of the port's off-policy Anakin program
(``sheeprl_tpu_torch/algos/sac/anakin.py``) against the jitted JAX
``make_sac_anakin_program`` step, on the CPU.

At the JAX smoke test's size (4 Pendulum envs x 16 steps, batch 32, replay
ratio 0.05: G = 3 gradient steps; hidden 32, episodes truncated at 10 steps
so that the iteration ends some), from the same parameters (the actor's
heads scaled by 0.1, C item 3 of ROADMAP: float32 tanh near saturation),
env state, ring and draws. The draws derive from the JAX key in the order
the JAX program splits it: each rollout step's action noise, each step's
reset state from the env state's per-env keys, the ring sample's round keys,
then each gradient step's critic and actor noise. Two cases:

- ``fill-ramp``: iteration 1 on an empty ring, the EMA gate shut
  (``target_network_frequency`` 64 over 64 env steps an iteration: the
  target moves on even iterations);
- ``wrapped``: iteration 2 on a full ring whose cursor sits 7 rows from its
  end, so the write wraps; the EMA gate open.

Tolerances: the sampled slots, the done and truncation flags, the ring's
cursor and fill and Adam's count equal; the ring's contents, the env state,
the observation, the episode stats, the losses (1e-5 relative), every
parameter and Adam's moments within 1e-5 (float32 math through different
matmul kernels, three Adam updates of about lr = 3e-4 each).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_helpers import f32, numpy_tree, optax_states_close, sac_spaces, trees_close, unsaturated

ATOL = 1e-5
E, T, B = 4, 16, 32
OVERRIDES = ["exp=sac_anakin", "fabric.accelerator=cpu", "env.capture_video=False", f"env.num_envs={E}",
             f"algo.rollout_steps={T}", f"algo.per_rank_batch_size={B}", "algo.replay_ratio=0.05",
             "algo.hidden_size=32", "algo.critic.target_network_frequency=64", "env.max_episode_steps=10"]
# (buffer.size, rows written before the iteration, iter_num, EMA gate open)
CASES = {"fill-ramp": (1024, 0, 1, False), "wrapped": (64, 25, 2, True)}


def _jax_program(buffer_size: int):
    from sheeprl_tpu.algos.sac.agent import build_agent
    from sheeprl_tpu.algos.sac.anakin import make_sac_anakin_program
    from sheeprl_tpu.algos.sac.sac import build_optimizers, init_opt_state
    from sheeprl_tpu.config import compose
    from sheeprl_tpu.envs.jax import make_jax_env
    from sheeprl_tpu.parallel.fabric import Fabric

    cfg = compose(OVERRIDES + [f"buffer.size={buffer_size}"])
    fabric = Fabric(devices=1, accelerator="cpu")
    fabric._setup()
    env = make_jax_env(cfg, E)
    actor, critic, params = build_agent(fabric, cfg, *sac_spaces(), jax.random.PRNGKey(3))
    params = unsaturated(numpy_tree(params))
    txs = build_optimizers(cfg)
    opt_state = init_opt_state(txs, params)
    fused, _, G = make_sac_anakin_program(actor, critic, env, cfg, fabric, txs, E, params, opt_state)
    return cfg, env, params, opt_state, fused, G


def _jax_draws(env, key, env_key, G: int):
    """The draws of one JAX iteration from its key and the env state's keys."""
    bare = env.env.env
    noise = []
    for _ in range(T):
        key, step_key = jax.random.split(key)
        noise.append(np.asarray(jax.random.normal(step_key, (E, 1))))
    resets, k = [], env_key
    split_env = jax.jit(jax.vmap(jax.random.split))
    reset_of = jax.jit(jax.vmap(lambda kk: bare.reset(kk)[0]))
    for _ in range(T):
        pair = split_env(k)
        resets.append(np.asarray(reset_of(pair[:, 1])))
        k = pair[:, 0]
    _, sample_key, train_key = jax.random.split(key, 3)
    round_keys = np.asarray(jax.random.randint(sample_key, (8,), 0, np.iinfo(np.int32).max)).astype(np.int64)
    eps = [jax.random.split(kk) for kk in jax.random.split(train_key, G)]
    train = {"critic": torch.stack([f32(jax.random.normal(kc, (B, 1))) for kc, _ in eps]),
             "actor": torch.stack([f32(jax.random.normal(ka, (B, 1))) for _, ka in eps])}
    inputs = {"noise": torch.from_numpy(np.stack(noise)), "resets": torch.from_numpy(np.stack(resets)),
              "round_keys": torch.from_numpy(round_keys), "train": train}
    return inputs, sample_key


def _prefill(rows: int) -> dict:
    """``rows`` random transitions ``[rows, E, ...]``, a fifth of them terminal."""
    rng = np.random.default_rng(rows)
    block = {
        "observations": rng.standard_normal((rows, E, 3)), "next_observations": rng.standard_normal((rows, E, 3)),
        "actions": rng.uniform(-2, 2, (rows, E, 1)), "rewards": -rng.uniform(0, 16, (rows, E, 1)),
        "terminated": rng.uniform(size=(rows, E, 1)) < 0.2, "truncated": rng.uniform(size=(rows, E, 1)) < 0.1,
    }
    return {k: v.astype(np.float32) for k, v in block.items()}


@pytest.mark.timeout(300)
@pytest.mark.parametrize("case", list(CASES))
def test_sac_anakin_iteration_matches_the_jitted_jax_step(case):
    from sheeprl_tpu.algos.sac.anakin import ring_row_specs as jax_ring_row_specs
    from sheeprl_tpu.data.device_ring import ring_init as jax_ring_init
    from sheeprl_tpu.data.device_ring import ring_write as jax_ring_write
    from sheeprl_tpu.utils.prp import prp_permutation as jax_prp
    from sheeprl_tpu_torch.algos.sac.agent import build_agent
    from sheeprl_tpu_torch.algos.sac.anakin import SACAnakinProgram, ring_row_specs
    from sheeprl_tpu_torch.algos.sac.sac import SACTrainer, build_optimizers
    from sheeprl_tpu_torch.config import compose
    from sheeprl_tpu_torch.data.device_ring import ring_capacity, ring_init, ring_write
    from sheeprl_tpu_torch.envs.device import make_device_env
    from sheeprl_tpu_torch.interop.flax_to_torch import sac_to_flax
    from sheeprl_tpu_torch.parallel.fabric import Fabric

    buffer_size, prefill, iter_num, ema = CASES[case]
    cfg_jax, jenv, params, opt_state, fused, G = _jax_program(buffer_size)
    capacity = ring_capacity(buffer_size, E)

    # the port, from the same parameters, config, env state and ring
    cfg = compose(OVERRIDES + [f"buffer.size={buffer_size}"])
    agent = build_agent(Fabric(accelerator="cpu"), cfg, *sac_spaces(), 0, params)
    trainer = SACTrainer(agent, build_optimizers(cfg, agent), cfg, -1.0, T * E)
    program = SACAnakinProgram(trainer, make_device_env(cfg, E, "cpu"), cfg, B)
    assert program.grad_steps == G == 3 and trainer.target_period == 2
    env_state, obs = jax.jit(jenv.reset)(jax.random.PRNGKey(1))
    state, pobs = program.env.reset(inner=torch.from_numpy(np.array(env_state.inner)))
    jring = jax_ring_init(capacity, E, jax_ring_row_specs(3, 1))
    ring = ring_init(capacity, E, ring_row_specs(3, 1), "cpu")
    if prefill:
        rows = _prefill(prefill)
        for start in range(0, prefill, capacity):  # blocks of at most the ring's rows
            block = {k: v[start:start + capacity] for k, v in rows.items()}
            jring = jax_ring_write(jring, {k: jnp.asarray(v) for k, v in block.items()})
            ring_write(ring, {k: torch.from_numpy(v) for k, v in block.items()})
        assert ring["fill"] == capacity and ring["pos"] == prefill - capacity == capacity - 7
    key = jax.random.PRNGKey(2)
    inputs, sample_key = _jax_draws(jenv, key, env_state.key, G)

    # the port's iteration, then the JAX one (which donates its inputs)
    out = program.step(state, pobs, ring, inputs, iter_num)
    stats = {k: jnp.float32(0.0) for k in ("ep_return_sum", "ep_length_sum", "ep_count")}
    stats["losses"] = jnp.zeros((3,), jnp.float32)
    jparams = jax.tree_util.tree_map(jnp.array, params)
    new_params, new_opt, jenv_state, jobs, jring, _, new_stats, _ = fused(
        jparams, jax.tree_util.tree_map(jnp.array, opt_state), env_state, obs, jring, key, stats, jnp.asarray(iter_num)
    )

    # the ring: the same rows written where the JAX write put them
    assert (ring["pos"], ring["fill"]) == (int(jring["pos"]), int(jring["fill"]))
    assert ring["fill"] == (T if not prefill else capacity)
    for k, v in ring["data"].items():
        if k in ("terminated", "truncated"):
            np.testing.assert_array_equal(v.numpy(), np.asarray(jring["data"][k]), err_msg=k)
        else:
            np.testing.assert_allclose(v.numpy(), np.asarray(jring["data"][k]), rtol=ATOL, atol=ATOL, err_msg=k)
    assert out.traj["truncated"].any(), "the iteration should end episodes"
    # the sample took the JAX program's slots: perm[i % slots] % valid
    slots, n = capacity * E, G * B
    perm = np.asarray(jax_prp(sample_key, slots))
    idx = perm[np.arange(n) % slots] % (max(int(jring["fill"]), 1) * E)
    for k, v in ring["data"].items():
        flat = v.reshape(slots, -1).numpy()
        np.testing.assert_array_equal(out.batch[k].reshape(n, -1).numpy(), flat[idx], err_msg=k)

    # the env and the episode stats
    np.testing.assert_allclose(out.env_state.inner.numpy(), np.asarray(jenv_state.inner), rtol=ATOL, atol=ATOL)
    np.testing.assert_allclose(out.env_state.episode_return.numpy(), np.asarray(jenv_state.episode_return),
                               rtol=ATOL, atol=ATOL)
    np.testing.assert_array_equal(out.env_state.episode_length.numpy(), np.asarray(jenv_state.episode_length))
    np.testing.assert_allclose(out.obs.numpy(), np.asarray(jobs), rtol=ATOL, atol=ATOL)
    np.testing.assert_allclose(out.ep_stats.numpy(), [float(new_stats[k]) for k in ("ep_return_sum", "ep_length_sum",
                                                                                     "ep_count")],
                               rtol=ATOL, atol=ATOL)
    assert float(out.ep_stats[2]) > 0

    # the update: losses, parameters (the target critic moved by the EMA or
    # not at all) and Adam's state
    np.testing.assert_allclose(out.losses.numpy(), np.asarray(new_stats["losses"]), rtol=ATOL, atol=1e-6)
    trees_close(sac_to_flax(agent), new_params, atol=ATOL)
    moved = not np.array_equal(sac_to_flax(agent)["target_critic"]["VmapSACCritic_0"]["MLP_0"]["Dense_0"]["kernel"],
                               params["target_critic"]["VmapSACCritic_0"]["MLP_0"]["Dense_0"]["kernel"])
    assert moved == ema
    optax_states_close(trainer, new_opt, atol=ATOL)

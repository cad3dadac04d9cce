"""The off-policy Anakin topology through the port's entry points, on the CPU.

- ``exp=sac_anakin`` at the JAX smoke test's size trains two iterations
  (logging every scalar, the ring's twin in the checkpoint at ``_pos`` 32 and
  not full, as ``tests/test_algos/test_sac_anakin.py`` asserts for JAX, its
  newest row marked terminated and truncated) and resumes into version_1
  with its ring, its Adam states and its counters;
- a checkpoint written by the JAX package's code for ``exp=sac_anakin`` (its
  config.yaml, Flax params, the three optax Adam states after one update
  and the ring's twin, marked by the JAX checkpoint callback) resumes in the
  port: the ring lands on the device with the JAX rows, cursor and fill,
  the agent plays the JAX parameters' test episode, and Adam's count goes on
  from the JAX one;
- the JAX loop's refusals (a host env backend, a host replay buffer, cnn
  keys, more than one mlp key, a discrete action space, an env count that is
  no power of two), the ``learning_starts`` warning, and no run on the CPU
  without a card;
- the CLI's checks of ``buffer.backend`` (the ring for ``sac_anakin`` only,
  an unknown backend, ``service`` not yet ported), the ``evaluation`` and
  ``serve`` verbs refusing a ``sac_anakin`` checkpoint as the JAX package's
  do, and ``exp=sac_anakin_benchmarks`` composing with no CPU pin.
"""

from __future__ import annotations

import jax
import numpy as np
import pytest
import torch
import yaml

from test_torch_helpers import numpy_tree, sac_spaces

COMMON = ["fabric.accelerator=cpu", "env.capture_video=False", "root_dir=tiny", "run_name=run"]
# the JAX smoke test's size: 4 envs x 16 steps (64 policy steps an
# iteration), batch 32, G = round(0.05 x 64) = 3, a ring of 256 rows
TINY = ["exp=sac_anakin", *COMMON, "env.num_envs=4", "algo.rollout_steps=16", "algo.per_rank_batch_size=32",
        "algo.replay_ratio=0.05", "buffer.size=1024", "algo.hidden_size=32", "env.max_episode_steps=24",
        "checkpoint.every=64", "metric.log_every=64"]
TAGS = {"Loss/value_loss", "Loss/policy_loss", "Loss/alpha_loss", "Rewards/rew_avg", "Time/sps_env_interaction",
        "Test/cumulative_reward"}


@pytest.mark.timeout(300)
def test_cli_trains_and_resumes_with_the_ring(tmp_path):
    from tensorboard.backend.event_processing.event_accumulator import EventAccumulator

    from sheeprl_tpu_torch.cli import run
    from sheeprl_tpu_torch.utils.checkpoint import load_checkpoint

    first = run(TINY + ["algo.total_steps=128"])
    assert first["iterations"] == 2 and first["gradient_steps"] == 2 * 3 and first["grad_steps_per_iter"] == 3
    assert (first["ring_pos"], first["ring_fill"]) == (32, 32) and np.isfinite(first["test_reward"])
    assert all(np.isfinite(v) for v in first["metrics"].values()) and first["rollout_seconds"] > 0
    ea = EventAccumulator(str(tmp_path / first["log_dir"]))
    ea.Reload()
    assert TAGS <= set(ea.Tags()["scalars"])
    state = load_checkpoint(str(tmp_path / first["checkpoint"]))
    assert set(state) == {"agent", "opt_state", "iter_num", "batch_size", "last_log", "last_checkpoint", "rb"}
    rb = state["rb"]
    assert (rb.buffer_size, rb.n_envs, rb._pos, rb.full) == (256, 4, 32, False)
    assert set(rb.buffer) == {"observations", "next_observations", "actions", "rewards", "terminated", "truncated"}
    assert np.abs(rb["observations"][:32]).sum() > 0
    # the newest row is an episode end in the file, on both flags
    assert rb["terminated"][31].min() == 1.0 and rb["truncated"][31].min() == 1.0

    resumed = run(TINY + ["algo.total_steps=256", f"checkpoint.resume_from={tmp_path / first['checkpoint']}"])
    assert resumed["log_dir"].endswith("version_1") and resumed["iterations"] == 2
    assert resumed["policy_steps"] == 256 and (resumed["ring_pos"], resumed["ring_fill"]) == (64, 64)
    saved = load_checkpoint(str(tmp_path / resumed["checkpoint"]))
    assert saved["iter_num"] == 4 and saved["rb"]._pos == 64
    # the first run's rows came back on the device as they were in the file
    for k, v in rb.buffer.items():
        np.testing.assert_array_equal(saved["rb"][k][:32], v[:32], err_msg=k)
    assert {int(s["step"]) for s in saved["opt_state"]["critic"]["state"].values()} == {4 * 3}


@pytest.mark.timeout(300)
def test_a_jax_sac_anakin_checkpoint_resumes_with_its_ring(tmp_path):
    import optax

    from sheeprl_tpu.algos.sac.agent import build_agent as jax_build_agent
    from sheeprl_tpu.algos.sac.anakin import ring_row_specs as jax_ring_row_specs
    from sheeprl_tpu.algos.sac.sac import build_optimizers as jax_optimizers
    from sheeprl_tpu.algos.sac.sac import init_opt_state
    from sheeprl_tpu.config import compose as jax_compose
    from sheeprl_tpu.data.device_ring import ring_init, ring_to_buffer, ring_write
    from sheeprl_tpu.parallel.fabric import Fabric as JaxFabric
    from sheeprl_tpu.utils.callback import CheckpointCallback
    from sheeprl_tpu.utils.checkpoint import save_checkpoint as jax_save_checkpoint
    from sheeprl_tpu_torch.algos.sac.agent import build_agent
    from sheeprl_tpu_torch.algos.sac.utils import test
    from sheeprl_tpu_torch.cli import run
    from sheeprl_tpu_torch.config import compose
    from sheeprl_tpu_torch.parallel.fabric import Fabric
    from sheeprl_tpu_torch.utils.checkpoint import load_checkpoint

    cfg_jax = jax_compose(TINY + ["algo.total_steps=192"])
    fabric = JaxFabric(devices=1, accelerator="cpu")
    fabric._setup()
    _, _, params = jax_build_agent(fabric, cfg_jax, *sac_spaces(), jax.random.PRNGKey(5))
    params = numpy_tree(params)
    txs = jax_optimizers(cfg_jax)
    opt_state = init_opt_state(txs, params)
    for group, tree in (("actor", "actor"), ("critic", "critic"), ("alpha", "log_alpha")):
        grads = jax.tree_util.tree_map(lambda x: np.full_like(x, 0.1), params[tree])
        updates, opt_state[group] = jax.jit(txs[group].update)(grads, opt_state[group], params[tree])
        params = {**params, tree: numpy_tree(optax.apply_updates(params[tree], updates))}
    # the JAX ring after one iteration of 16 rows, snapshotted into its twin
    rng = np.random.default_rng(6)
    rows = {k: rng.standard_normal((16, 4, *shape)).astype(np.float32)
            for k, (shape, _) in jax_ring_row_specs(3, 1).items()}
    ring = ring_write(ring_init(256, 4, jax_ring_row_specs(3, 1)), {k: jax.numpy.asarray(v) for k, v in rows.items()})
    rb = ring_to_buffer(ring)
    CheckpointCallback()._ckpt_rb(rb)
    run_dir = tmp_path / "jax_run" / "version_0"
    ckpt = run_dir / "checkpoint" / "ckpt_64_0.ckpt"
    jax_save_checkpoint(str(ckpt), {"agent": params, "opt_state": opt_state, "iter_num": 1, "batch_size": 32,
                                    "last_log": 64, "last_checkpoint": 64, "rb": rb})
    (run_dir / "config.yaml").write_text(yaml.safe_dump(cfg_jax.as_dict()))

    # no iteration left to run: the ring as restored, and the test episode of
    # the JAX parameters (the port's greedy test of an agent built from them)
    restored = run(TINY + ["algo.total_steps=64", f"checkpoint.resume_from={ckpt}"])
    assert restored["iterations"] == 0 and (restored["ring_pos"], restored["ring_fill"]) == (16, 16)
    agent = build_agent(Fabric(accelerator="cpu"), compose(TINY), *sac_spaces(), 0, params)
    assert restored["test_reward"] == test(agent.actor, compose(TINY), str(tmp_path / "test"))

    resumed = run(TINY + ["algo.total_steps=192", f"checkpoint.resume_from={ckpt}"])
    assert resumed["iterations"] == 2 and resumed["policy_steps"] == 192
    assert (resumed["ring_pos"], resumed["ring_fill"]) == (48, 48)
    assert all(np.isfinite(v) for v in resumed["metrics"].values())
    saved = load_checkpoint(str(tmp_path / resumed["checkpoint"]))
    # the JAX rows as they were in its file (the newest marked by its callback)
    for k, v in rows.items():
        expected = v.copy()
        if k in ("terminated", "truncated"):
            expected[15] = 1.0
        np.testing.assert_array_equal(saved["rb"][k][:16], expected, err_msg=k)
    # Adam went on from the JAX state's one update: 1 + 2 iterations x 3 steps
    for group in ("actor", "critic", "alpha"):
        assert {int(s["step"]) for s in saved["opt_state"][group]["state"].values()} == {1 + 2 * 3}


def test_the_jax_loops_refusals_and_no_cpu_fallback():
    from sheeprl_tpu_torch.cli import run

    base = TINY + ["algo.total_steps=64", "algo.run_test=False"]
    with pytest.raises(ValueError, match="requires the on-device env plane"):
        run(base + ["env.backend=host"])
    with pytest.raises(ValueError, match="requires the device-resident replay ring"):
        run(base + ["buffer.backend=local"])
    with pytest.raises(ValueError, match="mlp observations only"):
        run(base + ["algo.cnn_keys.encoder=[rgb]"])
    with pytest.raises(ValueError, match="exactly one mlp key"):
        run(base + ["algo.mlp_keys.encoder=[state,other]"])
    with pytest.raises(ValueError, match="Only continuous action space"):
        run(base + ["env.id=CartPole-v1"])
    with pytest.raises(ValueError, match="power-of-two env count"):
        run(base + ["env.num_envs=3"])
    with pytest.warns(UserWarning, match="ignores algo.learning_starts=100"):
        assert run(base + ["algo.learning_starts=100"])["iterations"] == 1
    if not torch.cuda.is_available():  # without a card the entry point raises, it does not run on the CPU
        with pytest.raises(RuntimeError, match="needs a CUDA device"):
            run([o for o in base if o != "fabric.accelerator=cpu"])


def test_the_clis_buffer_backend_checks_and_the_refusing_verbs(tmp_path):
    from sheeprl_tpu_torch.__main__ import main
    from sheeprl_tpu_torch.cli import run
    from sheeprl_tpu_torch.config import compose

    with pytest.raises(ValueError, match="wired for the fused off-policy topology"):
        run(["exp=sac", *COMMON, "env.id=Pendulum-v1", "buffer.backend=device"])
    with pytest.raises(ValueError, match="unknown buffer.backend 'other'"):
        run(TINY + ["buffer.backend=other"])
    with pytest.raises(NotImplementedError, match="buffer.backend=service: not yet ported"):
        run(["exp=sac", *COMMON, "env.id=Pendulum-v1", "buffer.backend=service"])
    # the prefetch group is the device route's to ignore
    summary = run(TINY + ["algo.total_steps=64", "buffer.prefetch.enabled=True", "algo.run_test=False"])
    # the JAX package registers no evaluation and no serving for sac_anakin
    with pytest.raises(ValueError, match="no evaluation for algorithm 'sac_anakin'"):
        main(["evaluation", f"checkpoint_path={summary['checkpoint']}", "fabric.accelerator=cpu"])
    with pytest.raises(ValueError, match="no serving policy for algorithm 'sac_anakin'"):
        main(["serve", f"checkpoint_path={summary['checkpoint']}", "fabric.accelerator=cpu",
              f"serve.log_dir={tmp_path / 'serve'}"])
    bench = compose(["exp=sac_anakin_benchmarks"])
    assert bench.fabric.accelerator == "auto" and bench.buffer.backend == "device"
    assert (bench.env.num_envs, bench.algo.rollout_steps, bench.buffer.size) == (512, 64, 262144)

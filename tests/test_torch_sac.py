"""SAC of the port against the JAX package's, on the CPU.

- one SAC train phase against the jitted ``make_train_phase``, with the
  target EMA's gate open and shut, from the same parameters, block and
  normal draws (derived from the JAX key in the order the JAX phase splits
  it);
- the CLI: ``exp=sac`` trains, resumes into version_1, evaluates and serves
  (its sessions batch-independent), and a checkpoint written by the JAX
  package's code resumes and serves in the port with its optax states.

The agent's modules are held in ``test_torch_sac_agent.py``, Pendulum in
``test_torch_pendulum.py``. Tolerances: 1e-5 for parameters and mean losses
after a train phase (three gradient steps, each three Adam updates of size
~lr = 3e-4, through different matmul kernels); 1e-6 for Adam's moments.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_helpers import (
    SAC_TINY,
    f32,
    jax_sac,
    losses_close,
    numpy_tree,
    optax_states_close,
    port_sac,
    replay_block,
    trees_close,
    unsaturated,
)

ATOL = 1e-6
PARAM_ATOL = 1e-5


# target_network_frequency 8 over 4 envs: the EMA runs on every third iteration
EMA_GATE = ("env.num_envs=4", "algo.critic.target_network_frequency=8")


@pytest.mark.parametrize("iter_num,ema", [(3, True), (4, False)], ids=["ema-on", "ema-off"])
def test_sac_train_phase_matches_make_train_phase(iter_num, ema):
    """Three gradient steps from the same parameters, block and normal draws
    (``split(key, G)``, then ``split(k)`` into the critic's and the actor's
    draw): the mean losses, every parameter (the target critic moved by the
    EMA or not at all) and the Adam moments agree."""
    from sheeprl_tpu.algos.sac.sac import build_optimizers as jax_optimizers
    from sheeprl_tpu.algos.sac.sac import init_opt_state, make_train_phase
    from sheeprl_tpu_torch.algos.sac.sac import SACTrainer, build_optimizers
    from sheeprl_tpu_torch.interop.flax_to_torch import sac_to_flax

    actor, critic, params, cfg_jax = jax_sac("sac", EMA_GATE)
    params = unsaturated(params)
    txs = jax_optimizers(cfg_jax)
    train_phase = make_train_phase(cfg_jax, actor, critic, -1.0, 4, txs=txs)
    G, B = 3, 8
    data = replay_block(np.random.default_rng(4), (G, B))
    key = jax.random.PRNGKey(6)
    jparams = jax.tree_util.tree_map(jnp.array, params)
    new_params, opt_state, losses, _ = train_phase(jparams, init_opt_state(txs, jparams),
                                                   {k: jnp.asarray(v) for k, v in data.items()},
                                                   jnp.asarray(iter_num), key)
    eps = [jax.random.split(k) for k in jax.random.split(key, G)]
    noise = {
        "critic": torch.stack([f32(jax.random.normal(kc, (B, 1))) for kc, _ in eps]),
        "actor": torch.stack([f32(jax.random.normal(ka, (B, 1))) for _, ka in eps]),
    }
    agent, cfg = port_sac("sac", EMA_GATE, params=params)
    trainer = SACTrainer(agent, build_optimizers(cfg, agent), cfg, -1.0, 4)
    assert trainer.target_period == 3
    losses_close(trainer.train_phase({k: f32(v) for k, v in data.items()}, iter_num, noise), losses)
    trees_close(sac_to_flax(agent), new_params, atol=PARAM_ATOL)
    moved = not np.array_equal(sac_to_flax(agent)["target_critic"]["VmapSACCritic_0"]["MLP_0"]["Dense_0"]["kernel"],
                               params["target_critic"]["VmapSACCritic_0"]["MLP_0"]["Dense_0"]["kernel"])
    assert moved == ema
    optax_states_close(trainer, opt_state, atol=ATOL)


# ---------------------------------------------------------------------------------
# the entry points
# ---------------------------------------------------------------------------------
def _scalar_tags(log_dir) -> set:
    from tensorboard.backend.event_processing.event_accumulator import EventAccumulator

    ea = EventAccumulator(str(log_dir))
    ea.Reload()
    return set(ea.Tags()["scalars"])


def test_cli_trains_resumes_evaluates_and_serves(tmp_path, capsys):
    """Train 64 steps (the memmap buffer in the checkpoints), resume from the
    last checkpoint into version_1 with its buffer, optimizer states and
    replay-ratio governor, evaluate it, then serve it: every session
    completes, and the greedy sessions replay the test episode's reward."""
    import json

    from sheeprl_tpu_torch.__main__ import main
    from sheeprl_tpu_torch.cli import run
    from sheeprl_tpu_torch.utils.checkpoint import load_checkpoint

    tiny = [o for o in SAC_TINY if not o.startswith("buffer.memmap")] + ["buffer.memmap=True"]
    first = run(tiny + ["algo.total_steps=64"])
    ckpt = tmp_path / first["checkpoint"]
    # learning starts at iteration 8 (16 steps over 2 envs): Ratio's first call
    # gets the JAX loop's policy_step - prefill + 2 = 16 - 7 + 2 and takes 11
    # gradient steps, then 2 per iteration for the 24 iterations after it
    assert first["iterations"] == 32 and first["gradient_steps"] == 11 + 2 * 24 and ckpt.is_file()
    assert all(np.isfinite(v) for v in first["metrics"].values()) and first["test_reward"] is not None
    assert {"Loss/value_loss", "Loss/policy_loss", "Loss/alpha_loss", "Rewards/rew_avg", "Time/sps_train",
            "Time/sps_env_interaction", "Test/cumulative_reward"} <= _scalar_tags(tmp_path / first["log_dir"])
    state = load_checkpoint(str(ckpt))
    assert state["rb"]._pos == 32 and sorted(state["opt_state"]) == ["actor", "alpha", "critic"]
    resumed = run(tiny + ["algo.total_steps=96", f"checkpoint.resume_from={ckpt}"])
    assert resumed["log_dir"].endswith("version_1") and resumed["policy_steps"] == 96
    assert resumed["gradient_steps"] > 0 and all(np.isfinite(v) for v in resumed["metrics"].values())
    capsys.readouterr()
    assert main(["evaluation", f"checkpoint_path={ckpt}", "fabric.accelerator=cpu", "env.capture_video=False"]) == 0
    out = capsys.readouterr().out
    reward = float(out.split("Test - Reward:")[1].split()[0])
    log_dir = tmp_path / "serve"
    assert main(["serve", f"checkpoint_path={ckpt}", "fabric.accelerator=cpu", "serve.sessions=3", "serve.slots=2",
                 f"serve.log_dir={log_dir}", "seed=42"]) == 0
    summary = json.loads((log_dir / "summary.json").read_text())
    assert summary["sessions_completed"] == 3 and summary["steps"] == 3 * 24
    served = capsys.readouterr().out
    assert f"session seed=42: 24 steps, reward {reward:.2f}" in served


def test_serving_sessions_are_batch_independent():
    """Sampled (not greedy) actions: a session served alone and the same
    session beside others in the slot table draw the same noise rows and
    emit the same actions."""
    from sheeprl_tpu_torch.algos.sac.serve import get_serve_policy
    from sheeprl_tpu_torch.parallel.fabric import Fabric
    from sheeprl_tpu_torch.serve.slots import SlotTable

    _, _, params, _ = jax_sac()
    _, cfg = port_sac()
    cfg.serve = {"greedy": False}
    policy = get_serve_policy(Fabric(accelerator="cpu"), cfg, {"agent": params})
    assert policy.init_slots(3) == {} and policy.noise_spec["act"].size == 1
    rng = np.random.default_rng(8)
    obs = rng.standard_normal((6, 3, 3)).astype(np.float32)
    alone, crowd = SlotTable(policy, 3), SlotTable(policy, 3)
    alone.attach({1: 11})
    crowd.attach({0: 5, 1: 11, 2: 6})
    for t in range(6):
        a = alone.step({"state": obs[t] * np.array([[0], [1], [0]], np.float32)}, np.array([False, True, False]))
        b = crowd.step({"state": obs[t, [2, 1, 0]]}, np.array([True, True, t % 2 == 0]))
        np.testing.assert_array_equal(a[1], b[1])
        assert np.all(np.abs(b) <= 2.0)


def test_a_jax_sac_checkpoint_resumes_in_the_port(tmp_path):
    """A run dir written by the JAX package's code (its config.yaml, and a
    checkpoint holding Flax params and the three optax Adam states after one
    update, without a replay buffer) resumes in the port: the agent and every
    Adam's moments and count come back, then it trains; and it serves. With
    a JAX replay buffer in it the resume is refused."""
    import json

    import optax
    import yaml

    from sheeprl_tpu.algos.sac.sac import build_optimizers as jax_optimizers
    from sheeprl_tpu.algos.sac.sac import init_opt_state
    from sheeprl_tpu.config import compose as jax_compose
    from sheeprl_tpu.utils.checkpoint import save_checkpoint as jax_save_checkpoint
    from sheeprl_tpu_torch.__main__ import main
    from sheeprl_tpu_torch.algos.sac.sac import SACTrainer, build_optimizers
    from sheeprl_tpu_torch.cli import run
    from sheeprl_tpu_torch.utils.checkpoint import load_checkpoint

    cfg_jax = jax_compose(SAC_TINY + ["algo.total_steps=48", "buffer.checkpoint=False"])
    _, _, params, _ = jax_sac()
    txs = jax_optimizers(cfg_jax)
    opt_state = init_opt_state(txs, params)
    for group, tree in (("actor", "actor"), ("critic", "critic"), ("alpha", "log_alpha")):
        grads = jax.tree_util.tree_map(lambda x: np.full_like(x, 0.1), params[tree])
        updates, opt_state[group] = jax.jit(txs[group].update)(grads, opt_state[group], params[tree])
        params = {**params, tree: numpy_tree(optax.apply_updates(params[tree], updates))}
    run_dir = tmp_path / "jax_run" / "version_0"
    ckpt = run_dir / "checkpoint" / "ckpt_32_0.ckpt"
    state = {"agent": params, "opt_state": opt_state, "ratio": {"_ratio": 1.0, "_prev": 24, "_pretrain_steps": 0},
             "iter_num": 16, "batch_size": 8, "last_log": 32, "last_checkpoint": 32}
    jax_save_checkpoint(str(ckpt), state)
    (run_dir / "config.yaml").write_text(yaml.safe_dump(cfg_jax.as_dict()))
    agent, cfg = port_sac(params=params)
    trainer = SACTrainer(agent, build_optimizers(cfg, agent), cfg, -1.0)
    trainer.load_opt_state(load_checkpoint(str(ckpt))["opt_state"])
    optax_states_close(trainer, opt_state, atol=0.0)
    # the JAX package's config turns its prefetch thread on; the port refuses it
    resumed = run(SAC_TINY + ["algo.total_steps=80", "buffer.checkpoint=False", "buffer.prefetch.enabled=False",
                          f"checkpoint.resume_from={ckpt}"])
    assert resumed["policy_steps"] == 80 and resumed["gradient_steps"] > 0
    assert all(np.isfinite(v) for v in resumed["metrics"].values())
    # and it serves: every greedy session of the JAX checkpoint completes
    log_dir = tmp_path / "serve"
    assert main(["serve", f"checkpoint_path={ckpt}", "fabric.accelerator=cpu", "serve.sessions=2",
                 f"serve.log_dir={log_dir}"]) == 0
    assert json.loads((log_dir / "summary.json").read_text())["steps"] == 2 * 24
    # a replay buffer of the JAX package in the checkpoint is refused by name
    from sheeprl_tpu.data.buffers import ReplayBuffer as JaxReplayBuffer

    with_rb = run_dir / "checkpoint" / "ckpt_32_0_rb.ckpt"
    jax_save_checkpoint(str(with_rb), {**state, "rb": JaxReplayBuffer(8, 2, memmap=False)})
    with pytest.raises(NotImplementedError, match="replay buffer of the JAX package"):
        run(SAC_TINY + ["algo.total_steps=80", "buffer.prefetch.enabled=False", f"checkpoint.resume_from={with_rb}"])

"""The Anakin topology through the port's entry points, on the CPU.

- ``exp=ppo_anakin`` and ``exp=a2c_anakin`` at a cut size train (logging
  every scalar), resume into version_1 with their optimizer state, evaluate
  and serve (``python -m sheeprl_tpu_torch serve``);
- a run dir written by the JAX package's code for ``exp=ppo_anakin`` (its
  config.yaml, Flax params and the optax clip + Adam + schedule state after
  one update) resumes in the port with the state's moments and counts,
  evaluates and is served;
- ``exp=ppo env.backend=jax``: the host PPO loop over the device env plane's
  gym-style adapter, the test episode included;
- the JAX loop's refusals (a host env backend, a cnn key, more than one mlp
  key), an unknown backend, and no run on the CPU without a card;
- ``xla_deterministic_ops=True`` turns PyTorch's deterministic mode on in the
  train, evaluation and serve paths (in a subprocess, which owns the
  process-wide switches).
"""

from __future__ import annotations

import os
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch
import yaml

from test_torch_helpers import SUBPROCESS_ENV, numpy_tree, optax_links

REPO = Path(__file__).resolve().parent.parent
COMMON = ["fabric.accelerator=cpu", "env.capture_video=False", "root_dir=tiny", "run_name=run"]
TINY = {
    "ppo_anakin": ["exp=ppo_anakin", *COMMON, "env.num_envs=4", "algo.rollout_steps=8", "algo.per_rank_batch_size=16",
                   "algo.update_epochs=2", "algo.dense_units=16", "checkpoint.every=64", "metric.log_every=64"],
    "a2c_anakin": ["exp=a2c_anakin", *COMMON, "env.num_envs=4", "algo.encoder.dense_units=16",
                   "algo.actor.dense_units=16", "algo.critic.dense_units=16", "checkpoint.every=40",
                   "metric.log_every=40"],
}


def _serve_cli(run: Path, log_dir: Path, *extra: str) -> subprocess.CompletedProcess:
    env = {**os.environ, **SUBPROCESS_ENV, "PYTHONPATH": str(REPO)}
    return subprocess.run(
        [sys.executable, "-m", "sheeprl_tpu_torch", "serve", f"checkpoint_path={run}", "fabric.accelerator=cpu",
         "serve.sessions=3", "serve.slots=2", f"serve.log_dir={log_dir}", *extra],
        env=env, capture_output=True, text=True, timeout=240,
    )


@pytest.mark.timeout(600)
@pytest.mark.parametrize("exp", list(TINY))
def test_cli_trains_resumes_evaluates_and_serves(exp, tmp_path, capsys):
    from tensorboard.backend.event_processing.event_accumulator import EventAccumulator

    from sheeprl_tpu_torch.__main__ import main
    from sheeprl_tpu_torch.cli import run
    from sheeprl_tpu_torch.utils.checkpoint import load_checkpoint

    tiny = TINY[exp]
    per_iter = 32 if exp == "ppo_anakin" else 20  # 4 envs x 8 or 5 steps
    first = run(tiny + [f"algo.total_steps={4 * per_iter}"])
    ckpt = tmp_path / first["checkpoint"]
    assert first["iterations"] == 4 and ckpt.is_file() and first["test_reward"] is not None
    assert first["updates_per_iter"] == (2 * 2 if exp == "ppo_anakin" else 1)
    assert all(np.isfinite(v) for v in first["metrics"].values()) and first["rollout_seconds"] > 0
    ea = EventAccumulator(str(tmp_path / first["log_dir"]))
    ea.Reload()
    tags = set(ea.Tags()["scalars"])
    assert {"Loss/policy_loss", "Loss/value_loss", "Rewards/rew_avg", "Time/sps_env_interaction",
            "Test/cumulative_reward"} <= tags
    assert ("Loss/entropy_loss" in tags) == (exp == "ppo_anakin")
    resumed = run(tiny + [f"algo.total_steps={6 * per_iter}", f"checkpoint.resume_from={ckpt}"])
    assert resumed["log_dir"].endswith("version_1") and resumed["iterations"] == 2
    assert resumed["policy_steps"] == 6 * per_iter
    saved = load_checkpoint(str(tmp_path / resumed["checkpoint"]))
    assert saved["iter_num"] == 6 and set(saved) >= {"agent", "optimizer", "batch_size", "last_log",
                                                      "last_checkpoint"}
    if exp == "ppo_anakin":  # Adam's step count went on from the first run's
        assert {int(s["step"]) for s in saved["optimizer"]["state"].values()} == {6 * 4}
    capsys.readouterr()
    assert main(["evaluation", f"checkpoint_path={ckpt}", "fabric.accelerator=cpu"]) == 0
    assert "Test - Reward:" in capsys.readouterr().out
    proc = _serve_cli(tmp_path / "logs" / "runs" / "tiny" / "run", tmp_path / "serve_log")
    assert proc.returncode == 0, proc.stdout[-2000:] + proc.stderr[-3000:]
    summary = yaml.safe_load((tmp_path / "serve_log" / "summary.json").read_text())
    assert summary["algo"] == exp and summary["sessions_completed"] == 3


@pytest.mark.timeout(600)
def test_a_jax_ppo_anakin_checkpoint_resumes_evaluates_and_serves(tmp_path):
    import gymnasium as gym
    import optax

    from sheeprl_tpu.algos.ppo.agent import build_agent as jax_build_agent
    from sheeprl_tpu.algos.ppo.anakin import _build_optimizer
    from sheeprl_tpu.config import compose as jax_compose
    from sheeprl_tpu.parallel.fabric import Fabric as JaxFabric
    from sheeprl_tpu.utils.checkpoint import save_checkpoint as jax_save_checkpoint
    from sheeprl_tpu_torch.algos.ppo.agent import build_agent
    from sheeprl_tpu_torch.algos.ppo.anakin import build_optimizer
    from sheeprl_tpu_torch.cli import evaluation, run
    from sheeprl_tpu_torch.config import compose
    from sheeprl_tpu_torch.envs import spaces
    from sheeprl_tpu_torch.interop.flax_to_torch import ppo_to_torch
    from sheeprl_tpu_torch.interop.optax_to_torch import load_optimizer_state
    from sheeprl_tpu_torch.parallel.fabric import Fabric
    from sheeprl_tpu_torch.utils.checkpoint import load_checkpoint

    extra = ["algo.anneal_lr=True", "algo.max_grad_norm=0.5", "algo.total_steps=128"]
    cfg_jax = jax_compose(TINY["ppo_anakin"] + extra)
    fabric = JaxFabric(devices=1, accelerator="cpu")
    fabric._setup()
    space = gym.spaces.Dict({"state": gym.spaces.Box(-np.inf, np.inf, (4,), np.float32)})
    _, params = jax_build_agent(fabric, (2,), False, cfg_jax, space, jax.random.PRNGKey(4))
    tx = _build_optimizer(cfg_jax, 4, 2 * 2)  # the JAX loop's: 4 iterations of 2 epochs x 2 minibatches
    grads = jax.tree_util.tree_map(lambda x: np.full_like(x, 0.3), params)
    updates, opt_state = jax.jit(tx.update)(grads, tx.init(params), params)
    params = numpy_tree(optax.apply_updates(params, updates))
    run_dir = tmp_path / "jax_run" / "version_0"
    ckpt = run_dir / "checkpoint" / "ckpt_32_0.ckpt"
    jax_save_checkpoint(str(ckpt), {"agent": params, "optimizer": opt_state, "iter_num": 1, "batch_size": 16,
                                    "last_log": 32, "last_checkpoint": 32})
    (run_dir / "config.yaml").write_text(yaml.safe_dump(cfg_jax.as_dict()))

    # the optax state as the resumed run loads it
    cfg = compose(TINY["ppo_anakin"] + extra)
    agent = build_agent(Fabric(accelerator="cpu"), (2,), False, cfg, spaces.Dict({"state": spaces.Box(
        -np.inf, np.inf, (4,))}), 0, params)
    optimizer, schedule = build_optimizer(cfg, agent, 4, 2 * 2)
    assert schedule(16) == 0.0 and schedule(0) == pytest.approx(float(cfg.algo.optimizer.lr))
    load_optimizer_state(optimizer, load_checkpoint(str(ckpt))["optimizer"], ppo_to_torch(agent))
    links = optax_links(opt_state)
    adam = links["ScaleByAdamState"]
    for key, moments in (("exp_avg", adam.mu), ("exp_avg_sq", adam.nu)):
        for p, theirs in zip(agent.parameters(), ppo_to_torch(agent)(numpy_tree(moments))):
            np.testing.assert_array_equal(optimizer.state[p][key].numpy(), theirs)
    assert all(float(optimizer.state[p]["step"]) == 1 for p in agent.parameters())
    assert optimizer.param_groups[0]["schedule_count"] == int(links["ScaleByScheduleState"].count) == 1

    resumed = run(TINY["ppo_anakin"] + extra + [f"checkpoint.resume_from={ckpt}"])
    assert resumed["iterations"] == 3 and resumed["policy_steps"] == 128
    assert all(np.isfinite(v) for v in resumed["metrics"].values())
    saved = load_checkpoint(str(tmp_path / resumed["checkpoint"]))
    assert {int(s["step"]) for s in saved["optimizer"]["state"].values()} == {1 + 3 * 4}
    assert {g["schedule_count"] for g in saved["optimizer"]["param_groups"]} == {1 + 3 * 4}
    assert np.isfinite(evaluation([f"checkpoint_path={ckpt}", "fabric.accelerator=cpu"]))
    proc = _serve_cli(ckpt, tmp_path / "serve_log")  # served from the JAX run's own config.yaml
    assert proc.returncode == 0, proc.stdout[-2000:] + proc.stderr[-3000:]
    summary = yaml.safe_load((tmp_path / "serve_log" / "summary.json").read_text())
    assert summary["algo"] == "ppo_anakin" and summary["sessions_completed"] == 3


@pytest.mark.timeout(300)
def test_host_ppo_over_the_device_env_adapter(tmp_path):
    """``exp=ppo env.backend=jax``: the host loop steps the device envs through
    ``DeviceToGymEnv`` (CartPole's 500-step budget applied by the adapter),
    and the test episode does too; the adapter is the same env as the device
    plane's."""
    from sheeprl_tpu_torch.cli import run
    from sheeprl_tpu_torch.config import compose
    from sheeprl_tpu_torch.envs.device import CartPole, DeviceToGymEnv
    from sheeprl_tpu_torch.utils.env import make_env

    overrides = ["exp=ppo", *COMMON, "env.backend=jax", "env.num_envs=2", "algo.rollout_steps=16",
                 "algo.per_rank_batch_size=16", "algo.update_epochs=1", "algo.total_steps=64"]
    env = make_env(compose(overrides), 3, 0)()
    assert list(env.observation_space.keys()) == ["state"] and env.action_space.n == 2
    adapter = DeviceToGymEnv("CartPole-v1", seed=3)
    obs, _ = adapter.reset()
    state = torch.from_numpy(obs)[None]
    for _ in range(5):
        state, expected, reward, terminated = CartPole().step(state, torch.tensor([1]))
        obs, r, term, trunc, _ = adapter.step(1)
        np.testing.assert_array_equal(obs, expected[0].numpy())
        assert (r, term, trunc) == (1.0, bool(terminated[0]), False)
    summary = run(overrides)
    assert summary["train_phases"] == 2 and np.isfinite(summary["test_reward"])
    assert all(np.isfinite(v) for v in summary["metrics"].values())


def test_the_jax_loops_refusals_and_no_cpu_fallback(tmp_path):
    from sheeprl_tpu_torch.cli import run

    base = TINY["ppo_anakin"] + ["algo.total_steps=64"]
    with pytest.raises(ValueError, match="requires the on-device env plane"):
        run(base + ["env.backend=host"])
    with pytest.raises(ValueError, match="mlp observations only"):
        run(base + ["algo.cnn_keys.encoder=[rgb]"])
    with pytest.raises(ValueError, match="exactly one mlp key"):
        run(base + ["algo.mlp_keys.encoder=[state,other]"])
    with pytest.raises(ValueError, match="unknown env.backend"):
        run(["exp=ppo", *COMMON, "env.backend=other", "algo.total_steps=64"])
    with pytest.raises(ValueError, match="unknown device env id"):
        run(base + ["env.id=Acrobot-v1"])
    if not torch.cuda.is_available():  # without a card the entry point raises, it does not run on the CPU
        with pytest.raises(RuntimeError, match="needs a CUDA device"):
            run([o for o in base if o != "fabric.accelerator=cpu"])


DETERMINISM_SCRIPT = """
import os, sys, torch
from sheeprl_tpu_torch.cli import evaluation, run
from sheeprl_tpu_torch.serve.main import serve_main

def reset():
    torch.use_deterministic_algorithms(False)
    torch.backends.cudnn.deterministic = False

seen = {}
summary = run(sys.argv[1:])
seen["train"] = torch.are_deterministic_algorithms_enabled() and torch.backends.cudnn.deterministic
seen["cublas_workspace"] = os.environ.get("CUBLAS_WORKSPACE_CONFIG") == ":4096:8"
reset()
evaluation([f"checkpoint_path={summary['checkpoint']}", "fabric.accelerator=cpu"])
seen["evaluation"] = torch.are_deterministic_algorithms_enabled()
reset()
serve_main([f"checkpoint_path={summary['checkpoint']}", "fabric.accelerator=cpu", "serve.sessions=1",
            "serve.slots=1", "serve.max_session_steps=8", "serve.log_dir=serve_log"])
seen["serve"] = torch.are_deterministic_algorithms_enabled()
reset()
evaluation([f"checkpoint_path={summary['checkpoint']}", "fabric.accelerator=cpu", "xla_deterministic_ops=False"])
seen["evaluation_off"] = not torch.are_deterministic_algorithms_enabled()
seen["cublas_workspace_off"] = "CUBLAS_WORKSPACE_CONFIG" not in os.environ
print("SEEN", seen)
sys.exit(0 if all(seen.values()) else 1)
"""


@pytest.mark.timeout(300)
def test_xla_deterministic_ops_turns_deterministic_mode_on_in_every_path(tmp_path):
    env = {**os.environ, **SUBPROCESS_ENV, "PYTHONPATH": str(REPO)}
    env.pop("CUBLAS_WORKSPACE_CONFIG", None)
    proc = subprocess.run(
        [sys.executable, "-c", DETERMINISM_SCRIPT, *TINY["ppo_anakin"], "algo.total_steps=64",
         "xla_deterministic_ops=True"],
        env=env, cwd=str(tmp_path), capture_output=True, text=True, timeout=240,
    )
    assert proc.returncode == 0, proc.stdout[-3000:] + proc.stderr[-3000:]
    assert "'train': True" in proc.stdout

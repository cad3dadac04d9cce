"""Recurrent PPO through the port's entry points, and its serving, on the CPU.

- ``exp=ppo_recurrent`` on CartPole-v1 at small widths trains (logging every
  scalar), resumes into version_1 with its optimizer state, evaluates, and
  its run dir serves through ``python -m sheeprl_tpu_torch serve``; a rollout
  that is not a whole number of sequences and a bf16 policy are refused, and
  without a card the entry point raises instead of running on the CPU;
- a run dir written by the JAX package's code (its config.yaml, Flax params
  and the optax clip + Adam + schedule state after one update) resumes in the
  port with the state's moments and counts, evaluates, and serves every
  session with the reward the JAX package's own ``serve`` gives the same
  seeds;
- the batched serve step against JAX's ``step_slot`` run per slot on the
  same parameters and observations, 3 ticks over 3 slots: greedy on
  CartPole, sampled on a multi-discrete and on a continuous dummy env with
  each tick's noise from the JAX key chain (``split(key)`` per step, then one
  key per action dimension); equal actions (within 1e-5 when continuous) and
  carries (``hx``, ``cx``, the previous action) within 1e-5;
- the behaviour ``test_serve/test_policies.py::
  test_ppo_recurrent_carry_advances_and_is_deterministic`` holds the JAX
  policy to: the carry's keys, and a session's stream the same whatever the
  slot count.
"""

from __future__ import annotations

import os
import re
import subprocess
import sys
import threading
from pathlib import Path

import jax
import numpy as np
import pytest
import torch
import yaml

from test_torch_helpers import SUBPROCESS_ENV, numpy_tree, optax_links

REPO = Path(__file__).resolve().parent.parent
COMMON = ["fabric.accelerator=cpu", "env.capture_video=False"]
SMALL = ["algo.rnn.lstm.hidden_size=8", "algo.dense_units=16", "algo.encoder.dense_units=16",
         "algo.encoder.mlp_features_dim=16"]
TINY = ["exp=ppo_recurrent", *COMMON, *SMALL, "env.num_envs=2", "algo.rollout_steps=16",
        "algo.per_rank_sequence_length=4", "algo.per_rank_num_batches=4", "algo.update_epochs=2",
        "checkpoint.every=32", "metric.log_every=32", "root_dir=tiny", "run_name=run"]
CASES = {
    "cartpole": (["exp=ppo_recurrent"], (2,), False),
    "multidiscrete": (["exp=ppo_recurrent", "env=dummy", "env.id=multidiscrete_dummy", "algo.mlp_keys.encoder=[state]",
                       "algo.rnn.pre_rnn_mlp.apply=True", "algo.rnn.post_rnn_mlp.apply=True"], (2, 2), False),
    "continuous": (["exp=ppo_recurrent", "env=dummy", "env.id=continuous_dummy", "algo.mlp_keys.encoder=[state]"],
                   (2,), True),
}
SESSION_RE = r"session seed=(\d+): \d+ steps, reward ([-\d.]+)"


def _serve_cli(run: Path, log_dir: Path, *extra: str) -> subprocess.CompletedProcess:
    env = {**os.environ, **SUBPROCESS_ENV, "PYTHONPATH": str(REPO)}
    return subprocess.run(
        [sys.executable, "-m", "sheeprl_tpu_torch", "serve", f"checkpoint_path={run}", "fabric.accelerator=cpu",
         "serve.sessions=3", "serve.slots=2", f"serve.log_dir={log_dir}", *extra],
        env=env, capture_output=True, text=True, timeout=240,
    )


@pytest.mark.timeout(600)
def test_cli_trains_resumes_evaluates_and_serves(tmp_path, capsys):
    from tensorboard.backend.event_processing.event_accumulator import EventAccumulator

    from sheeprl_tpu_torch.__main__ import main
    from sheeprl_tpu_torch.cli import run

    first = run(TINY + ["algo.total_steps=64"])
    ckpt = tmp_path / first["checkpoint"]
    assert first["train_phases"] == 2 and ckpt.is_file() and first["test_reward"] is not None
    assert sorted(first["metrics"]) == ["Loss/entropy_loss", "Loss/policy_loss", "Loss/value_loss"]
    assert all(np.isfinite(v) for v in first["metrics"].values())
    ea = EventAccumulator(str(tmp_path / first["log_dir"]))
    ea.Reload()
    assert {"Loss/policy_loss", "Loss/value_loss", "Loss/entropy_loss", "Time/sps_train", "Time/sps_env_interaction",
            "Test/cumulative_reward"} <= set(ea.Tags()["scalars"])
    resumed = run(TINY + ["algo.total_steps=96", f"checkpoint.resume_from={ckpt}"])
    assert resumed["log_dir"].endswith("version_1") and resumed["train_phases"] == 1
    assert resumed["policy_steps"] == 96
    capsys.readouterr()
    assert main(["evaluation", f"checkpoint_path={ckpt}", "fabric.accelerator=cpu"]) == 0
    assert "Test - Reward:" in capsys.readouterr().out
    proc = _serve_cli(tmp_path / "logs" / "runs" / "tiny" / "run", tmp_path / "serve_log", "serve.greedy=false")
    assert proc.returncode == 0, proc.stdout[-2000:] + proc.stderr[-3000:]
    assert len(re.findall(SESSION_RE, proc.stdout)) == 3
    summary = yaml.safe_load((tmp_path / "serve_log" / "summary.json").read_text())
    assert summary["algo"] == "ppo_recurrent" and summary["sessions_completed"] == 3
    with pytest.raises(ValueError, match="multiple of per_rank_sequence_length"):
        run(TINY + ["algo.total_steps=64", "algo.rollout_steps=10"])
    with pytest.raises(NotImplementedError, match="bf16 is not yet ported"):
        run(TINY + ["algo.total_steps=64", "fabric.precision=bf16-mixed"])
    if not torch.cuda.is_available():  # without a card the entry point raises, it does not run on the CPU
        with pytest.raises(RuntimeError, match="needs a CUDA device"):
            run([o for o in TINY if o != "fabric.accelerator=cpu"] + ["algo.total_steps=64"])


@pytest.mark.timeout(600)
def test_a_jax_checkpoint_resumes_evaluates_and_serves(tmp_path, capsys):
    import optax

    from sheeprl_tpu.algos.ppo_recurrent.agent import build_agent as jax_build_agent
    from sheeprl_tpu.config import compose as jax_compose
    from sheeprl_tpu.config import instantiate as jax_instantiate
    from sheeprl_tpu.parallel.fabric import Fabric as JaxFabric
    from sheeprl_tpu.serve.main import serve_main as jax_serve_main
    from sheeprl_tpu.utils.checkpoint import save_checkpoint as jax_save_checkpoint
    from sheeprl_tpu.utils.env import make_env as jax_make_env
    from sheeprl_tpu_torch.algos.ppo_recurrent.agent import build_agent
    from sheeprl_tpu_torch.algos.ppo_recurrent.ppo_recurrent import build_optimizer
    from sheeprl_tpu_torch.cli import evaluation, run
    from sheeprl_tpu_torch.config import compose
    from sheeprl_tpu_torch.interop.flax_to_torch import ppo_recurrent_to_torch
    from sheeprl_tpu_torch.interop.optax_to_torch import load_optimizer_state
    from sheeprl_tpu_torch.parallel.fabric import Fabric
    from sheeprl_tpu_torch.utils.checkpoint import load_checkpoint

    extra = ["algo.anneal_lr=True", "algo.total_steps=64"]
    cfg_jax = jax_compose(TINY + extra)
    space = jax_make_env(cfg_jax, 0, 0)().observation_space
    fabric = JaxFabric(devices=1, accelerator="cpu")
    fabric._setup()
    _, params = jax_build_agent(fabric, (2,), False, cfg_jax, space, jax.random.PRNGKey(4))
    # the JAX loop's optimizer: clip, then Adam on a schedule over 2 x 2 x 4 updates
    lr = optax.linear_schedule(init_value=cfg_jax.algo.optimizer.lr, end_value=0.0, transition_steps=2 * 2 * 4)
    tx = optax.chain(optax.clip_by_global_norm(cfg_jax.algo.max_grad_norm),
                     jax_instantiate(cfg_jax.algo.optimizer, lr=lr))
    grads = jax.tree_util.tree_map(lambda x: np.full_like(x, 0.3), params)
    updates, opt_state = jax.jit(tx.update)(grads, tx.init(params), params)
    params = numpy_tree(optax.apply_updates(params, updates))
    run_dir = tmp_path / "jax_run" / "version_0"
    ckpt = run_dir / "checkpoint" / "ckpt_32_0.ckpt"
    jax_save_checkpoint(str(ckpt), {"agent": params, "optimizer": opt_state, "iter_num": 1, "batch_size": 64,
                                    "last_log": 32, "last_checkpoint": 32})
    (run_dir / "config.yaml").write_text(yaml.safe_dump(cfg_jax.as_dict()))

    # the optax state as the resumed run loads it
    cfg = compose(TINY + extra)
    agent = build_agent(Fabric(accelerator="cpu"), (2,), False, cfg, space, 0, params)
    optimizer, _ = build_optimizer(cfg, agent, 2)
    load_optimizer_state(optimizer, load_checkpoint(str(ckpt))["optimizer"], ppo_recurrent_to_torch(agent))
    links = optax_links(opt_state)
    adam = links["ScaleByAdamState"]
    for key, moments in (("exp_avg", adam.mu), ("exp_avg_sq", adam.nu)):
        for p, theirs in zip(agent.parameters(), ppo_recurrent_to_torch(agent)(numpy_tree(moments))):
            np.testing.assert_array_equal(optimizer.state[p][key].numpy(), theirs)
    assert all(float(optimizer.state[p]["step"]) == 1 for p in agent.parameters())
    assert optimizer.param_groups[0]["schedule_count"] == int(links["ScaleByScheduleState"].count) == 1

    resumed = run(TINY + extra + [f"checkpoint.resume_from={ckpt}"])
    assert resumed["train_phases"] == 1 and resumed["policy_steps"] == 64
    assert all(np.isfinite(v) for v in resumed["metrics"].values())
    assert np.isfinite(evaluation([f"checkpoint_path={ckpt}", "fabric.accelerator=cpu"]))

    proc = _serve_cli(run_dir.parent, tmp_path / "serve_log")
    assert proc.returncode == 0, proc.stdout[-2000:] + proc.stderr[-3000:]
    ours = dict(re.findall(SESSION_RE, proc.stdout))
    capsys.readouterr()
    assert jax_serve_main([f"checkpoint_path={run_dir.parent}", "fabric.accelerator=cpu", "serve.sessions=3",
                           "serve.slots=2", f"serve.log_dir={tmp_path / 'jax_log'}",
                           "serve.telemetry.enabled=false"]) == 0
    theirs = dict(re.findall(SESSION_RE, capsys.readouterr().out))
    assert len(ours) == 3 and ours == theirs


def _jax_policy(case: str, greedy: bool):
    from sheeprl_tpu.config import compose as jax_compose
    from sheeprl_tpu.parallel.fabric import Fabric as JaxFabric
    from sheeprl_tpu.serve.policy import resolve_serve_policy

    cfg = jax_compose([*CASES[case][0], *COMMON, *SMALL])
    cfg["serve"] = {"greedy": greedy}
    cfg.seed = 1
    fabric = JaxFabric(devices=1, accelerator="cpu")
    fabric._setup()
    return resolve_serve_policy(fabric, cfg, None)


def _port_policy(case: str, greedy: bool, params):
    from sheeprl_tpu_torch.config import compose
    from sheeprl_tpu_torch.parallel.fabric import Fabric
    from sheeprl_tpu_torch.serve.policy import resolve_serve_policy

    cfg = compose([*CASES[case][0], *COMMON, *SMALL])
    cfg["serve"] = {"greedy": greedy}
    return resolve_serve_policy(Fabric(accelerator="cpu"), cfg, {"agent": params})


@pytest.mark.timeout(300)
@pytest.mark.parametrize(
    "case,greedy", [("cartpole", True), ("multidiscrete", False), ("continuous", False)],
    ids=["cartpole-greedy", "multidiscrete-sampled", "continuous-sampled"],
)
def test_serve_step_matches_jax_step_slot(case, greedy):
    jpol = _jax_policy(case, greedy)
    tpol = _port_policy(case, greedy, numpy_tree(jpol.params))
    _, actions_dim, is_continuous = CASES[case]
    assert tpol.meta == {"family": "ppo_recurrent", "greedy": greedy, "recurrent": True}
    step = jax.jit(jpol.step_slot)
    carries = [jpol.init_slot(jpol.params, jax.random.PRNGKey(s)) for s in (100, 101, 102)]
    carry = tpol.init_slots(3)
    rng = np.random.default_rng(0)
    for tick in range(3):
        obs = [{k: rng.standard_normal(s.shape).astype(s.dtype) for k, s in tpol.obs_spec.items()} for _ in carries]
        noise, expected = [], []
        for i, jc in enumerate(carries):
            step_key = jax.random.split(jc["key"])[1]
            if is_continuous:
                noise.append(np.asarray(jax.random.normal(step_key, (sum(actions_dim),))))
            else:
                keys = jax.random.split(step_key, len(actions_dim))
                noise.append(np.concatenate([np.asarray(jax.random.gumbel(k, (d,))) for k, d in zip(keys, actions_dim)]))
            action, carries[i] = step(jpol.params, jc, obs[i])
            expected.append(np.asarray(action))
        tobs = {k: torch.from_numpy(np.stack([o[k] for o in obs])) for k in tpol.obs_spec}
        actions, carry = tpol.step_slots(carry, tobs, {} if greedy else {"act": torch.from_numpy(np.stack(noise))})
        if is_continuous:
            np.testing.assert_allclose(actions.numpy(), np.stack(expected), rtol=0, atol=1e-5, err_msg=f"tick {tick}")
        else:
            assert actions.dtype == torch.int32
            np.testing.assert_array_equal(actions.numpy(), np.stack(expected), err_msg=f"tick {tick}")
        for k in ("prev_action", "hx", "cx"):
            np.testing.assert_allclose(carry[k].numpy(), np.stack([np.asarray(c[k]) for c in carries]), rtol=0,
                                       atol=1e-5, err_msg=f"tick {tick}: {k}")


def test_serving_carry_advances_and_is_deterministic():
    from sheeprl_tpu_torch.config import compose
    from sheeprl_tpu_torch.parallel.fabric import Fabric
    from sheeprl_tpu_torch.serve.policy import resolve_serve_policy
    from sheeprl_tpu_torch.serve.server import PolicyServer

    cfg = compose(["exp=ppo_recurrent", "env=dummy", "env.id=discrete_dummy", *COMMON, "algo.cnn_keys.encoder=[]",
                   "algo.mlp_keys.encoder=[state]", "metric.log_level=0"])
    cfg["serve"] = {"greedy": True}
    policy = resolve_serve_policy(Fabric(accelerator="cpu"), cfg, None)
    carry = policy.init_slots(1)
    assert set(carry) == {"prev_action", "hx", "cx"}
    rng = np.random.default_rng(1)
    obs_seq = [{k: rng.normal(size=s.shape).astype(s.dtype) for k, s in policy.obs_spec.items()} for _ in range(4)]
    _, carry = policy.step_slots(carry, {k: torch.from_numpy(v[None]) for k, v in obs_seq[0].items()}, {})
    assert carry["hx"].abs().sum() > 0 and carry["cx"].abs().sum() > 0

    def stream(slots: int):
        out = []
        with PolicyServer(policy, slots=slots, max_batch_wait_ms=1.0) as server:
            def client():
                session = server.open_session(seed=1000)
                out.extend(np.asarray(session.step(obs)) for obs in obs_seq)
                session.close()

            thread = threading.Thread(target=client)
            thread.start()
            thread.join()
        return np.stack(out)

    np.testing.assert_array_equal(stream(1), stream(3))

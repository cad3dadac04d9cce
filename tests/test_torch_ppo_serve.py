"""PPO and A2C serving in the port, against the JAX package, on the CPU.

- the batched PPO serve step (``algos/ppo/serve.py``) against JAX's
  ``step_slot`` run per slot, on the same parameters and observations, for 3
  ticks over 3 slots: greedy on CartPole, and sampled on CartPole, on a
  multi-discrete and on a continuous dummy env, the noise of each tick taken
  from the JAX key chain (``split(key)`` per step, then one key per action
  dimension); actions within 1e-5 (continuous) or equal (discrete);
- a checkpoint the JAX package writes for PPO on CartPole-v1, served through
  the port's CLI on the CPU: every session completes with the reward the JAX
  package's own ``serve`` gives the same seeds;
- a checkpoint the port writes for A2C, served through the CLI.
"""

from __future__ import annotations

import os
import re
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch
import yaml

from test_torch_helpers import SUBPROCESS_ENV, numpy_tree

REPO = Path(__file__).resolve().parent.parent
CASES = {
    "cartpole": (["exp=ppo"], (2,), False),
    "multidiscrete": (["exp=ppo", "env=dummy", "env.id=multidiscrete_dummy", "algo.mlp_keys.encoder=[state]"],
                      (2, 2), False),
    "continuous": (["exp=ppo", "env=dummy", "env.id=continuous_dummy", "algo.mlp_keys.encoder=[state]"],
                   (2,), True),
}
COMMON = ["fabric.accelerator=cpu", "env.capture_video=False"]


def _jax_side(case: str, greedy: bool):
    """The JAX PPO serving policy of ``case`` at its init from PRNGKey(1)."""
    from sheeprl_tpu.config import compose as jax_compose
    from sheeprl_tpu.parallel.fabric import Fabric as JaxFabric
    from sheeprl_tpu.serve.policy import resolve_serve_policy

    cfg = jax_compose([*CASES[case][0], *COMMON])
    cfg["serve"] = {"greedy": greedy}
    cfg.seed = 1
    fabric = JaxFabric(devices=1, accelerator="cpu")
    fabric._setup()
    return resolve_serve_policy(fabric, cfg, None)


def _port_side(case: str, greedy: bool, params):
    from sheeprl_tpu_torch.config import compose
    from sheeprl_tpu_torch.parallel.fabric import Fabric
    from sheeprl_tpu_torch.serve.policy import resolve_serve_policy

    cfg = compose([*CASES[case][0], *COMMON])
    cfg["serve"] = {"greedy": greedy}
    return resolve_serve_policy(Fabric(accelerator="cpu"), cfg, {"agent": params})


@pytest.mark.timeout(300)
@pytest.mark.parametrize(
    "case,greedy",
    [("cartpole", True), ("cartpole", False), ("multidiscrete", False), ("continuous", False)],
    ids=["cartpole-greedy", "cartpole-sampled", "multidiscrete-sampled", "continuous-sampled"],
)
def test_ppo_serve_step_matches_jax_step_slot(case, greedy):
    jpol = _jax_side(case, greedy)
    tpol = _port_side(case, greedy, numpy_tree(jpol.params))
    _, actions_dim, is_continuous = CASES[case]
    assert tpol.meta["family"] == "ppo" and tpol.init_slots(3) == {}
    step = jax.jit(jpol.step_slot)
    carries = [jpol.init_slot(jpol.params, jax.random.PRNGKey(s)) for s in (100, 101, 102)]
    rng = np.random.default_rng(0)
    for tick in range(3):
        obs = [{k: (rng.integers(0, 256, s.shape) if np.issubdtype(s.dtype, np.integer)
                    else rng.standard_normal(s.shape)).astype(s.dtype) for k, s in tpol.obs_spec.items()}
               for _ in carries]
        noise, expected = [], []
        for i, carry in enumerate(carries):
            step_key = jax.random.split(carry["key"])[1]
            if is_continuous:
                noise.append(np.asarray(jax.random.normal(step_key, (sum(actions_dim),))))
            else:
                keys = jax.random.split(step_key, len(actions_dim))
                noise.append(np.concatenate([np.asarray(jax.random.gumbel(k, (d,))) for k, d in zip(keys, actions_dim)]))
            action, carries[i] = step(jpol.params, carry, obs[i])
            expected.append(np.asarray(action))
        tobs = {k: torch.from_numpy(np.stack([o[k] for o in obs])) for k in tpol.obs_spec}
        tnoise = {} if greedy else {"act": torch.from_numpy(np.stack(noise))}
        actions, carry = tpol.step_slots({}, tobs, tnoise)
        assert carry == {}
        if is_continuous:
            np.testing.assert_allclose(actions.numpy(), np.stack(expected), rtol=0, atol=1e-5, err_msg=f"tick {tick}")
        else:
            assert actions.dtype == torch.int32
            np.testing.assert_array_equal(actions.numpy(), np.stack(expected), err_msg=f"tick {tick}")


def _serve_cli(run: Path, log_dir: Path, *extra: str) -> subprocess.CompletedProcess:
    env = {**os.environ, **SUBPROCESS_ENV, "PYTHONPATH": str(REPO)}
    return subprocess.run(
        [sys.executable, "-m", "sheeprl_tpu_torch", "serve", f"checkpoint_path={run}", "fabric.accelerator=cpu",
         "serve.sessions=3", "serve.slots=2", f"serve.log_dir={log_dir}", *extra],
        env=env, capture_output=True, text=True, timeout=240,
    )


@pytest.mark.timeout(300)
def test_cli_serves_a_jax_ppo_checkpoint(tmp_path, capsys):
    from sheeprl_tpu.config import compose as jax_compose
    from sheeprl_tpu.serve.main import serve_main as jax_serve_main
    from sheeprl_tpu.utils.checkpoint import save_checkpoint as jax_save

    jpol = _jax_side("cartpole", True)
    run = tmp_path / "run"
    jax_save(str(run / "version_0" / "checkpoint" / "ckpt_512_0.ckpt"), {"agent": jpol.params})
    with open(run / "version_0" / "config.yaml", "w") as f:
        yaml.safe_dump(jax_compose([*CASES["cartpole"][0], *COMMON]).as_dict(), f, sort_keys=False)
    proc = _serve_cli(run, tmp_path / "serve_log")
    assert proc.returncode == 0, proc.stdout[-2000:] + proc.stderr[-3000:]
    ours = dict(re.findall(r"session seed=(\d+): \d+ steps, reward ([-\d.]+)", proc.stdout))
    assert len(ours) == 3 and all(float(r) > 0 for r in ours.values())
    capsys.readouterr()
    rc = jax_serve_main([f"checkpoint_path={run}", "fabric.accelerator=cpu", "serve.sessions=3", "serve.slots=2",
                         f"serve.log_dir={tmp_path / 'jax_log'}", "serve.telemetry.enabled=false"])
    assert rc == 0
    theirs = dict(re.findall(r"session seed=(\d+): \d+ steps, reward ([-\d.]+)", capsys.readouterr().out))
    assert ours == theirs
    summary = yaml.safe_load((tmp_path / "serve_log" / "summary.json").read_text())
    assert summary["algo"] == "ppo" and summary["sessions_completed"] == 3
    assert (tmp_path / "serve_log" / "telemetry.jsonl").is_file()  # telemetry is on by default


@pytest.mark.timeout(300)
def test_cli_serves_a_port_a2c_checkpoint(tmp_path):
    from sheeprl_tpu_torch.config import compose
    from sheeprl_tpu_torch.interop.flax_to_torch import ppo_to_flax
    from sheeprl_tpu_torch.parallel.fabric import Fabric
    from sheeprl_tpu_torch.serve.policy import resolve_serve_policy
    from sheeprl_tpu_torch.utils.checkpoint import save_checkpoint

    cfg = compose(["exp=a2c", *COMMON])
    cfg["serve"] = {"greedy": True}
    policy = resolve_serve_policy(Fabric(accelerator="cpu"), cfg, None)
    run = tmp_path / "run"
    save_checkpoint(str(run / "version_0" / "checkpoint" / "ckpt_64_0.ckpt"), {"agent": ppo_to_flax(policy.module)})
    del cfg["serve"]
    with open(run / "version_0" / "config.yaml", "w") as f:
        yaml.safe_dump(cfg.as_dict(), f, sort_keys=False)
    proc = _serve_cli(run, tmp_path / "serve_log", "serve.greedy=false")
    assert proc.returncode == 0, proc.stdout[-2000:] + proc.stderr[-3000:]
    assert proc.stdout.count("session seed=") == 3 and "ERROR" not in proc.stdout
    summary = yaml.safe_load((tmp_path / "serve_log" / "summary.json").read_text())
    assert summary["algo"] == "a2c" and summary["sessions_completed"] == 3

"""The ``env_step`` serve fault in the port, and what serving still refuses,
on the CPU.

The fault arms a one-shot exception in the next ``env.step`` of any session
(``envs/wrappers.py::InjectedEnvFault``). The port's ``run_env_sessions`` records it
as that session's error, so the run exits 1; the JAX one lets it end the
client thread unrecorded (ROADMAP queue C item 7), so the JAX package is not
the reference for the exit code here. The other sessions complete.

Trajectory capture, which the JAX server takes as ``trajectories=``, is
refused by name.
"""

from __future__ import annotations

import json
from pathlib import Path

import numpy as np
import pytest
import torch
import yaml

from test_torch_helpers import overrides


@pytest.mark.timeout(300)
def test_env_step_fault_fails_one_session(tmp_path):
    from sheeprl_tpu.config import compose as jax_compose
    from sheeprl_tpu.obs.jsonl import read_events
    from sheeprl_tpu.utils.checkpoint import save_checkpoint as jax_save

    from sheeprl_tpu_torch.resilience import faults
    from sheeprl_tpu_torch.serve.main import serve_main
    from test_torch_helpers import _jax_agent

    run = tmp_path / "run"
    jax_save(str(run / "version_0" / "checkpoint" / "ckpt_0_0.ckpt"), {"agent": _jax_agent("discrete", (), 3)[1]})
    with open(run / "version_0" / "config.yaml", "w") as f:
        yaml.safe_dump(jax_compose(overrides("discrete")).as_dict(), f, sort_keys=False)
    log = Path(tmp_path / "log")
    faults.reset_faults()
    try:
        rc = serve_main([f"checkpoint_path={run}", "fabric.accelerator=cpu", "serve.sessions=3", "serve.slots=3",
                         "serve.max_session_steps=8", "env.wrapper.n_steps=8", f"serve.log_dir={log}",
                         "resilience.fault.kind=env_step", "resilience.fault.at_policy_step=6"])
    finally:
        faults.reset_faults()
    assert rc == 1
    summary = json.loads((log / "summary.json").read_text())
    assert summary["sessions_completed"] == 2
    events = read_events(str(log / "telemetry.jsonl"))
    assert [e["kind"] for e in events if e["event"] == "fault"] == ["env_step"]
    assert events[-1]["event"] == "summary" and events[-1]["clean_exit"] is True


def test_trajectory_capture_is_refused_by_name():
    from sheeprl_tpu_torch.serve.policy import ObsSpec, ServePolicy
    from sheeprl_tpu_torch.serve.server import PolicyServer

    policy = ServePolicy(
        algo="zero", device=torch.device("cpu"), init_slots=lambda n: {},
        step_slots=lambda carry, obs, noise: (torch.zeros(obs["state"].shape[0], 2), carry),
        noise_spec={}, obs_spec={"state": ObsSpec((3,), np.float32)}, action_shape=(2,),
    )
    with pytest.raises(NotImplementedError, match="trajectory capture .* is not yet ported"):
        PolicyServer(policy, slots=2, trajectories=object())

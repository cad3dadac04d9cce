"""Hot weight reload of the port's serve verb, against the JAX package, on the CPU.

- a candidate of other shapes (another width's checkpoint) is rejected by the
  port's layout check, as by the JAX package's ``params_aval_mismatch``, and the
  old weights keep serving;
- the checkpoint source follows the newest valid checkpoint, skipping one whose
  sha256 sidecar does not match, as the JAX discovery does;
- the ``reload_torn`` fault tears the candidate; it is rejected and the old
  weights keep serving;
- two sessions served across a swap see a pure version schedule: their actions
  equal a reference stepped with version A's weights up to the swap and B's
  after it, from the same carries and the same per-session noise;
- after a swap, the batched step equals the JAX ``step_slot`` with version B's
  parameters from the same carry and noise: float32 at ``H_ATOL``, bf16 under
  ``tests/test_torch_bf16_agent.py``'s rule (the port's bf16 output lies closer
  to JAX's bf16 than JAX's bf16 lies to its float32);
- the CLI, serving on the CPU with ``serve.reload.enabled=true``, applies a
  checkpoint published under its watched run dir mid-run.

Polls are driven by calling ``WeightReloader.step()`` and ticks by the test's
clients; the CLI test waits on the reload event in the telemetry stream.
"""

from __future__ import annotations

import json
import os
import signal
import subprocess
import sys
import threading
import time
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from test_torch_helpers import SUBPROCESS_ENV, overrides

REPO = Path(__file__).resolve().parent.parent
H_ATOL = 1e-4  # tests/test_torch_serve.py's bar for h after DV3 steps


def _jax_params(seed: int, extra=()):
    """A JAX DV3 agent's parameters at the small widths (numpy leaves)."""
    from test_torch_helpers import _jax_agent

    return jax.tree_util.tree_map(np.copy, _jax_agent("discrete", tuple(extra), seed)[1])


def _port_policy(params, precision: str = "32-true", greedy: bool = True):
    from sheeprl_tpu_torch.config import compose
    from sheeprl_tpu_torch.parallel.fabric import Fabric
    from sheeprl_tpu_torch.serve.policy import resolve_serve_policy

    cfg = compose(overrides("discrete"))
    cfg["serve"] = {"greedy": greedy}
    return resolve_serve_policy(Fabric(accelerator="cpu", precision=precision), cfg, {"agent": params})


def _save(path: Path, params) -> None:
    from sheeprl_tpu.utils.checkpoint import save_checkpoint as jax_save

    jax_save(str(path), {"agent": params})


def _reloader(policy, watch_dir: Path, current: Path, telemetry=None):
    from sheeprl_tpu_torch.serve.reload import CheckpointReloadSource, WeightReloader
    from sheeprl_tpu_torch.serve.server import PolicyServer

    server = PolicyServer(policy, slots=2)
    source = CheckpointReloadSource(str(watch_dir), current_path=str(current))
    return server, WeightReloader(server, source, telemetry=telemetry)


class _Events:
    """A stand-in for the serving telemetry that records reload calls."""

    def __init__(self):
        self.calls = []

    def observe_reload(self, **kw):
        self.calls.append(kw)


def _module_state(policy):
    return {k: v.clone() for k, v in policy.module.state_dict().items()}


def _same_state(policy, state) -> bool:
    return all(torch.equal(v, state[k]) for k, v in policy.module.state_dict().items())


@pytest.mark.timeout(300)
def test_candidate_with_other_shapes_is_rejected(tmp_path):
    from sheeprl_tpu.serve.reload import params_aval_mismatch as jax_mismatch

    from sheeprl_tpu_torch.serve.reload import params_aval_mismatch

    params = _jax_params(3)
    wider = _jax_params(3, ("algo.dense_units=16",))
    policy = _port_policy(params)
    boot = tmp_path / "ckpt_0_0.ckpt"
    _save(boot, params)
    _save(tmp_path / "ckpt_8_0.ckpt", wider)
    events = _Events()
    server, reloader = _reloader(policy, tmp_path, boot, telemetry=events)
    before = _module_state(policy)
    assert reloader.step() is None
    assert reloader.failures == 1 and server._pending_params is None and _same_state(policy, before)
    rejected = [c for c in events.calls if c.get("failed")]
    assert len(rejected) == 1 and "aval mismatch" in rejected[0]["reason"] and "shape changed" in rejected[0]["reason"]
    # the JAX package's check judges the same trees the same way
    assert jax_mismatch(params, wider) is not None and jax_mismatch(params, _jax_params(4)) is None
    assert params_aval_mismatch(reloader.stager.layout, _jax_params(4)) is None
    assert "dtype" in params_aval_mismatch(
        reloader.stager.layout, jax.tree_util.tree_map(lambda x: x.astype(np.float64), params)
    )


def test_checkpoint_source_follows_the_newest_valid_checkpoint(tmp_path):
    from sheeprl_tpu.resilience.discovery import find_latest_checkpoint as jax_latest

    from sheeprl_tpu_torch.serve.reload import CheckpointReloadSource

    params = {"w": np.zeros((2, 3), np.float32)}
    run = tmp_path / "run" / "version_0" / "checkpoint"
    boot = run / "ckpt_0_0.ckpt"
    _save(boot, params)
    source = CheckpointReloadSource(str(tmp_path / "run"), current_path=str(boot))
    assert source.peek_available() == 0 and source.poll() is None  # the boot checkpoint is not re-applied
    stamp = os.path.getmtime(boot)
    for i, step in enumerate((8, 16, 24)):
        _save(run / f"ckpt_{step}_0.ckpt", {"w": np.full((2, 3), step, np.float32)})
        os.utime(run / f"ckpt_{step}_0.ckpt", (stamp + i + 1, stamp + i + 1))
    # the newest one is corrupt: its sidecar no longer matches
    (run / "ckpt_24_0.ckpt.sha256").write_text("0" * 64 + "\n")
    assert jax_latest(str(tmp_path / "run")).endswith("ckpt_16_0.ckpt")
    assert source.peek_available() == 1
    tree, version, meta = source.poll()
    assert version == 1 and meta["checkpoint_step"] == 16 and float(tree["w"][0, 0]) == 16.0
    assert source.poll() is None
    _save(run / "ckpt_32_0.ckpt", {"w": np.full((2, 3), 32, np.float32)})
    os.utime(run / "ckpt_32_0.ckpt", (stamp + 9, stamp + 9))
    assert jax_latest(str(tmp_path / "run")).endswith("ckpt_32_0.ckpt")
    tree, version, meta = source.poll()
    assert version == 2 and meta["checkpoint_step"] == 32


@pytest.mark.timeout(300)
def test_reload_torn_keeps_the_old_weights(tmp_path):
    from sheeprl_tpu.resilience.discovery import is_valid_checkpoint as jax_valid

    from sheeprl_tpu_torch.resilience import faults

    params = _jax_params(3)
    policy = _port_policy(params)
    boot = tmp_path / "ckpt_0_0.ckpt"
    _save(boot, params)
    candidate = tmp_path / "ckpt_8_0.ckpt"
    _save(candidate, _jax_params(4))
    events = _Events()
    server, reloader = _reloader(policy, tmp_path, boot, telemetry=events)
    before = _module_state(policy)
    faults.reset_faults()
    try:
        faults.FaultPlan("reload_torn", 0).maybe_fire(1, lambda *a, **k: events.calls.append({"fault": k}))
        assert reloader.step() is None
    finally:
        faults.reset_faults()
    assert not jax_valid(str(candidate))  # the torn file fails the JAX integrity check too
    assert reloader.failures == 1 and server._pending_params is None and _same_state(policy, before)
    rejected = [c for c in events.calls if c.get("failed")]
    assert len(rejected) == 1 and "torn checkpoint rejected" in rejected[0]["reason"]
    assert events.calls[0]["fault"]["kind"] == "reload_torn"


@pytest.mark.timeout(300)
def test_sessions_spanning_a_swap_see_a_pure_version_schedule(tmp_path):
    from sheeprl_tpu_torch.serve.policy import draw_noise
    from sheeprl_tpu_torch.serve.reload import CheckpointReloadSource, WeightReloader
    from sheeprl_tpu_torch.serve.server import PolicyServer

    params_a, params_b = _jax_params(3), _jax_params(4)
    policy = _port_policy(params_a)
    boot = tmp_path / "ckpt_0_0.ckpt"
    _save(boot, params_a)
    _save(tmp_path / "ckpt_8_0.ckpt", params_b)
    seeds, ticks, swap_at = [21, 22], 6, 3
    rng = np.random.default_rng(5)
    obs = [[{k: (rng.integers(0, 256, s.shape) if np.issubdtype(s.dtype, np.integer)
                 else rng.standard_normal(s.shape)).astype(s.dtype) for k, s in policy.obs_spec.items()}
            for _ in range(ticks)] for _ in seeds]

    served = {0: [], 1: []}
    with PolicyServer(policy, slots=2, max_batch_wait_ms=50.0) as server:
        reloader = WeightReloader(server, CheckpointReloadSource(str(tmp_path), current_path=str(boot)))
        sessions = [server.open_session(seed=s) for s in seeds]  # admitted in order: slots 0, 1
        reached, go = threading.Barrier(3), threading.Event()

        def client(i):
            for t in range(ticks):
                if t == swap_at:
                    reached.wait()
                    go.wait()
                served[i].append(np.asarray(sessions[i].step(obs[i][t])))
            sessions[i].close()

        threads = [threading.Thread(target=client, args=(i,)) for i in range(2)]
        for t in threads:
            t.start()
        reached.wait(timeout=120)  # both sessions are between tick swap_at - 1 and swap_at
        assert reloader.step() == 1
        with server._cond:  # the tick loop swaps between ticks, then notifies
            assert server._cond.wait_for(lambda: server.weight_version == 1, timeout=120)
        go.set()
        for t in threads:
            t.join(timeout=120)
        assert not any(t.is_alive() for t in threads)
        assert server.weight_version == 1 and server.stats.ticks_by_version == {0: swap_at, 1: ticks - swap_at}

    # the reference: A's weights up to the swap, B's after, same carries and
    # noise; and A's weights throughout, which the swap must move away from
    ref_a, ref_b = _port_policy(params_a), _port_policy(params_b)
    carry, carry_a = ref_a.init_slots(2), ref_a.init_slots(2)
    gens = [torch.Generator().manual_seed(s) for s in seeds]
    gens_a = [torch.Generator().manual_seed(s) for s in seeds]
    for t in range(ticks):
        noise = {name: draw_noise(spec, gens, torch.device("cpu")) for name, spec in ref_a.noise_spec.items()}
        noise_a = {name: draw_noise(spec, gens_a, torch.device("cpu")) for name, spec in ref_a.noise_spec.items()}
        batch = {k: torch.from_numpy(np.stack([obs[i][t][k] for i in range(2)])) for k in ref_a.obs_spec}
        actions, carry = (ref_a if t < swap_at else ref_b).step_slots(carry, batch, noise)
        carry_a = ref_a.step_slots(carry_a, batch, noise_a)[1]
        for i in range(2):
            np.testing.assert_array_equal(served[i][t], actions[i].numpy(), err_msg=f"session {i} tick {t}")
    # closed sessions leave their last carry in the table: the schedule's, bit for bit
    for key, value in carry.items():
        assert torch.equal(server.table.states[key], value), key
    assert not torch.equal(server.table.states["h"], carry_a["h"])


def _jax_serve_policy(params, precision: str):
    from sheeprl_tpu.config import compose as jax_compose
    from sheeprl_tpu.parallel.fabric import Fabric as JaxFabric
    from sheeprl_tpu.serve.policy import resolve_serve_policy

    cfg = jax_compose(overrides("discrete"))
    cfg["serve"] = {"greedy": True}
    fabric = JaxFabric(devices=1, accelerator="cpu", precision=precision)
    fabric._setup()
    return resolve_serve_policy(fabric, cfg, {"agent": params})


@pytest.mark.timeout(300)
def test_post_swap_step_matches_jax_step_slot(tmp_path):
    """From one carry and one draw of noise (the JAX key chain's), the port's
    batched step after the swap to B against JAX's ``step_slot`` on B, in
    float32 and at bf16."""
    for precision in ("32-true", "bf16-mixed"):
        _post_swap_step(tmp_path / precision, precision)


def _post_swap_step(tmp_path: Path, precision: str) -> None:
    tmp_path.mkdir()
    params_a, params_b = _jax_params(3), _jax_params(4)
    policy = _port_policy(params_a, precision)
    boot = tmp_path / "ckpt_0_0.ckpt"
    _save(boot, params_a)
    _save(tmp_path / "ckpt_8_0.ckpt", params_b)
    server, reloader = _reloader(policy, tmp_path, boot)
    assert reloader.step() == 1
    with server._cond:  # the swap, as the tick loop runs it between ticks
        assert server._apply_pending_params_locked() == 1

    bf16 = precision.startswith("bf16")
    jpol = _jax_serve_policy(params_b, "bf16-true" if bf16 else "32-true")
    jpol32 = _jax_serve_policy(params_b, "32-true")
    step, step32 = jax.jit(jpol.step_slot), jax.jit(jpol32.step_slot)
    agent = policy.module
    seeds = [100, 101, 102]
    rng = np.random.default_rng(9)
    # a fixed carry: a few JAX steps from the initial state, on random observations
    carries = []
    for s in seeds:
        c = jpol32.init_slot(jpol32.params, jax.random.PRNGKey(s))
        for _ in range(2):
            o = {k: rng.integers(0, 256, sp.shape).astype(sp.dtype) if np.issubdtype(sp.dtype, np.integer)
                 else rng.standard_normal(sp.shape).astype(sp.dtype) for k, sp in policy.obs_spec.items()}
            _, c = step32(jpol32.params, c, o)
        carries.append(c)
    obs = [{k: rng.integers(0, 256, sp.shape).astype(sp.dtype) if np.issubdtype(sp.dtype, np.integer)
            else rng.standard_normal(sp.shape).astype(sp.dtype) for k, sp in policy.obs_spec.items()} for _ in seeds]
    dtype = jnp.bfloat16 if bf16 else jnp.float32
    gumbel = [jax.random.gumbel(jax.random.split(c["key"], 3)[1], (agent.stochastic_size, agent.discrete_size),
                                dtype).reshape(-1) for c in carries]
    expected = [step(jpol.params, {**c, "h": c["h"].astype(jnp.float32), "z": c["z"].astype(dtype)}, o)
                for c, o in zip(carries, obs)]
    expected32 = [step32(jpol32.params, c, o) for c, o in zip(carries, obs)]

    carry = {
        "action": torch.from_numpy(np.stack([np.asarray(c["action"]) for c in carries])),
        "h": torch.from_numpy(np.stack([np.asarray(c["h"], np.float32) for c in carries])),
        "z": torch.from_numpy(np.stack([np.asarray(c["z"], np.float32) for c in carries])).to(agent.dtype),
    }
    tobs = {k: torch.from_numpy(np.stack([o[k] for o in obs])) for k in policy.obs_spec}
    noise = {"repr": torch.from_numpy(np.stack([np.asarray(g, np.float32) for g in gumbel])).to(agent.dtype)}
    actions, new = policy.step_slots(carry, tobs, noise)
    h_jax = np.stack([np.asarray(e[1]["h"], np.float32) for e in expected])
    if not bf16:
        np.testing.assert_allclose(new["h"].numpy(), h_jax, rtol=0, atol=H_ATOL)
        np.testing.assert_array_equal(actions.numpy(), np.stack([np.asarray(e[0]) for e in expected]))
        np.testing.assert_array_equal(new["z"].numpy() > 0.5, np.stack([np.asarray(e[1]["z"]) for e in expected]) > 0.5)
        return
    assert new["z"].dtype == torch.bfloat16
    h32 = np.stack([np.asarray(e[1]["h"], np.float32) for e in expected32])
    d_port = float(np.mean(np.abs(new["h"].float().numpy() - h_jax)))
    d_ref = float(np.mean(np.abs(h_jax - h32)))
    assert d_port < d_ref, f"h: port-to-JAX-bf16 {d_port:.3e} >= JAX bf16-to-f32 {d_ref:.3e}"
    z_port = new["z"].float().numpy().reshape(3, agent.stochastic_size, -1).argmax(-1)
    z_jax = np.stack([np.asarray(e[1]["z"], np.float32) for e in expected]).reshape(3, agent.stochastic_size, -1)
    assert np.mean(z_port == z_jax.argmax(-1)) > 0.9


def _write_run(root: Path, params) -> Path:
    from sheeprl_tpu.config import compose as jax_compose

    ckpt = root / "version_0" / "checkpoint" / "ckpt_0_0.ckpt"
    _save(ckpt, params)
    with open(root / "version_0" / "config.yaml", "w") as f:
        yaml.safe_dump(jax_compose(overrides("discrete")).as_dict(), f, sort_keys=False)
    return ckpt


def _events(path: Path):
    if not path.is_file():
        return []
    out = []
    for line in path.read_text().splitlines():
        try:
            out.append(json.loads(line))
        except ValueError:
            pass  # a line in flight
    return out


def _wait_for(path: Path, pred, proc, what: str, timeout: float = 200.0):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        found = [e for e in _events(path) if pred(e)]
        if found:
            return found[0]
        if proc.poll() is not None:
            raise AssertionError(f"serve exited {proc.returncode} before {what}: {proc.stderr.read()[-3000:]}")
        time.sleep(0.05)
    raise AssertionError(f"no {what} in {timeout}s")


@pytest.mark.timeout(300)
def test_cli_serve_applies_a_checkpoint_published_mid_run(tmp_path):
    """The CLI follows its run dir: a checkpoint published there (renamed into
    place, then its sidecar) while sessions are being served is applied; a
    SIGTERM then drains the server (exit 75)."""
    from sheeprl_tpu.utils.checkpoint import save_checkpoint as jax_save

    run = tmp_path / "run"
    _write_run(run, _jax_params(3))
    log_dir = tmp_path / "serve_log"
    env = {**os.environ, **SUBPROCESS_ENV, "PYTHONPATH": str(REPO)}
    proc = subprocess.Popen(
        [
            sys.executable, "-m", "sheeprl_tpu_torch", "serve", f"checkpoint_path={run}", "fabric.accelerator=cpu",
            "serve.sessions=2", "serve.slots=2", "serve.max_session_steps=1000000", "env.wrapper.n_steps=1000000",
            "serve.reload.enabled=true", "serve.reload.poll_s=0.1", "serve.telemetry.every=32",
            "serve.drain_grace_s=0.5", f"serve.log_dir={log_dir}",
        ],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
    )
    try:
        stream = log_dir / "telemetry.jsonl"
        _wait_for(stream, lambda e: e["event"] == "window", proc, "served window")
        staged = tmp_path / "publish.tmp"
        jax_save(str(staged), {"agent": _jax_params(4)})
        target = run / "version_0" / "checkpoint" / "ckpt_8_0.ckpt"
        os.replace(staged, target)
        os.replace(str(staged) + ".sha256", str(target) + ".sha256")
        applied = _wait_for(stream, lambda e: e["event"] == "reload" and e.get("status") == "applied", proc,
                            "applied reload")
        assert applied["version"] == 1 and applied["stage_ms"] > 0 and applied["apply_ms"] >= 0
        _wait_for(stream, lambda e: e["event"] == "window" and e["serve"]["weights"]["version"] == 1, proc,
                  "window served at version 1")
        proc.send_signal(signal.SIGTERM)
        out, err = proc.communicate(timeout=120)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    assert proc.returncode == 75, out[-2000:] + err[-3000:]
    summary = json.loads((log_dir / "summary.json").read_text())
    assert summary["weight_version"] == 1 and summary["reloads"] == 1 and summary["reload_failures"] == 0
    assert summary["ticks_by_version"]["0"] >= 1 and summary["ticks_by_version"]["1"] >= 1
    events = _events(stream)
    assert [e["status"] for e in events if e["event"] == "drain"] == ["begin", "end"]
    assert events[-1]["event"] == "summary" and events[-1]["serve"]["weights"]["reloads"] == 1

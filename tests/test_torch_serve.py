"""The port's serving slice against the JAX package, on the CPU.

- the slice as a whole: the port's batched Dreamer-V3 serve step, 8 ticks over
  3 slots, held against the JAX ``step_slot`` run per slot, with the noise of
  every tick taken from the JAX key chain (``PRNGKey(seed)``, then
  ``split(key, 3)`` per step, as ``serve.py`` and ``slots.py`` do);
- the server: a session served beside others equals the same session served
  alone; rows without a request keep their carry bit-exact;
- checkpoints: the port reads a checkpoint the JAX package wrote (agent params
  and an ``optax.adam`` state) in a process where jax, flax and optax cannot be
  imported;
- the entry point: ``python -m sheeprl_tpu_torch serve ... fabric.accelerator=cpu``
  exits 0 on the discrete and continuous dummy envs, ``accelerator=auto`` raises
  without a card, and the fault kinds serving does not drive raise.

Float32 on both sides. The recurrent state passes through 8 steps of convs,
matmuls and LayerNorms summed in different orders, so h agrees to 1e-4; the
sampled one-hot states and the env actions agree exactly.
"""

from __future__ import annotations

import os
import pickle
import subprocess
import sys
import threading
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from sheeprl_tpu_torch.serve.policy import NoiseSpec, ObsSpec, ServePolicy
from sheeprl_tpu_torch.serve.server import PolicyServer
from sheeprl_tpu_torch.serve.slots import SlotTable
from test_torch_helpers import ACTIONS, SUBPROCESS_ENV, numpy_tree, overrides

REPO = Path(__file__).resolve().parent.parent
H_ATOL = 1e-4


def _jax_policy(kind: str, greedy: bool):
    from sheeprl_tpu.config import compose as jax_compose
    from sheeprl_tpu.parallel.fabric import Fabric as JaxFabric
    from sheeprl_tpu.serve.policy import resolve_serve_policy

    cfg = jax_compose(overrides(kind))
    cfg["serve"] = {"greedy": greedy}
    fabric = JaxFabric(devices=1, accelerator="cpu")
    fabric._setup()
    return resolve_serve_policy(fabric, cfg, None)


def _torch_policy(kind: str, greedy: bool, params=None):
    from sheeprl_tpu_torch.config import compose
    from sheeprl_tpu_torch.parallel.fabric import Fabric
    from sheeprl_tpu_torch.serve.policy import resolve_serve_policy

    cfg = compose(overrides(kind))
    cfg["serve"] = {"greedy": greedy}
    return resolve_serve_policy(Fabric(accelerator="cpu"), cfg, {"agent": params} if params is not None else None)


def _raw_obs(rng, spec, n=None):
    lead = () if n is None else (n,)
    return {
        k: (
            rng.integers(0, 256, (*lead, *s.shape)).astype(s.dtype)
            if np.issubdtype(np.dtype(s.dtype), np.integer)
            else rng.standard_normal((*lead, *s.shape)).astype(s.dtype)
        )
        for k, s in spec.items()
    }


@pytest.mark.timeout(300)
@pytest.mark.parametrize("kind,greedy", [("discrete", True), ("multidiscrete", False), ("continuous", False)])
def test_batched_serve_step_matches_jax_step_slot(kind, greedy):
    jpol = _jax_policy(kind, greedy)
    params = numpy_tree(jpol.params)
    tpol = _torch_policy(kind, greedy, params)
    agent = tpol.module
    actions_dim, is_continuous = ACTIONS[kind]
    seeds = [100, 101, 102]
    step = jax.jit(jpol.step_slot)
    jcarries = [jpol.init_slot(jpol.params, jax.random.PRNGKey(s)) for s in seeds]
    tcarry = tpol.init_slots(len(seeds))
    rng = np.random.default_rng(0)
    for tick in range(8):
        obs = [_raw_obs(rng, tpol.obs_spec) for _ in seeds]
        noise = {"repr": [], "act": []}
        expected = []
        for i, carry in enumerate(jcarries):
            _, k_repr, k_act = jax.random.split(carry["key"], 3)
            noise["repr"].append(
                jax.random.gumbel(k_repr, (agent.stochastic_size, agent.discrete_size)).reshape(-1)
            )
            if is_continuous:
                noise["act"].append(jax.random.normal(k_act, (sum(actions_dim),)))
            else:
                keys = jax.random.split(k_act, len(actions_dim))
                noise["act"].append(jnp.concatenate([jax.random.gumbel(k, (d,)) for k, d in zip(keys, actions_dim)]))
            action, jcarries[i] = step(jpol.params, carry, obs[i])
            expected.append(np.asarray(action))
        tobs = {k: torch.from_numpy(np.stack([o[k] for o in obs])) for k in tpol.obs_spec}
        tnoise = {k: torch.from_numpy(np.stack([np.asarray(v) for v in vs])) for k, vs in noise.items()}
        if greedy:
            del tnoise["act"]
        actions, tcarry = tpol.step_slots(tcarry, tobs, tnoise)
        for i, carry in enumerate(jcarries):
            if is_continuous:
                np.testing.assert_allclose(actions[i].numpy(), expected[i], atol=H_ATOL, err_msg=f"tick {tick}")
            else:
                np.testing.assert_array_equal(actions[i].numpy(), expected[i], err_msg=f"tick {tick}")
            np.testing.assert_allclose(tcarry["h"][i].numpy(), np.asarray(carry["h"]), atol=H_ATOL)
            np.testing.assert_array_equal(tcarry["z"][i].numpy() > 0.5, np.asarray(carry["z"]) > 0.5)
            np.testing.assert_allclose(tcarry["action"][i].numpy(), np.asarray(carry["action"]), atol=H_ATOL)


def _serve_streams(policy, obs_seqs, slots, seeds):
    out = {}
    with PolicyServer(policy, slots=slots, max_batch_wait_ms=1.0) as server:

        def client(i):
            session = server.open_session(seed=seeds[i])
            out[i] = [np.asarray(session.step(obs)) for obs in obs_seqs[i]]
            session.close()

        threads = [threading.Thread(target=client, args=(i,)) for i in range(len(obs_seqs))]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
        assert not any(t.is_alive() for t in threads)
    return out


@pytest.mark.timeout(300)
@pytest.mark.parametrize("kind,greedy", [("discrete", True), ("continuous", False)])
def test_server_sessions_are_batch_independent(kind, greedy):
    policy = _torch_policy(kind, greedy)
    rng = np.random.default_rng(1)
    seqs = [[_raw_obs(rng, policy.obs_spec) for _ in range(6)] for _ in range(3)]
    seeds = [1000, 1001, 1002]
    together = _serve_streams(policy, seqs, slots=2, seeds=seeds)
    for i in range(3):
        alone = _serve_streams(policy, [seqs[i]], slots=2, seeds=[seeds[i]])[0]
        for a, b in zip(together[i], alone):
            np.testing.assert_array_equal(a, b)


def _counter_policy():
    """A toy recurrent policy: the carry accumulates obs plus Gumbel noise."""

    def init_slots(n):
        return {"acc": torch.zeros(n, 3)}

    def step_slots(carry, obs, noise):
        acc = carry["acc"] + obs["state"].float() + noise["g"]
        return acc.sum(-1), {"acc": acc}

    return ServePolicy(
        algo="counter",
        device=torch.device("cpu"),
        init_slots=init_slots,
        step_slots=step_slots,
        noise_spec={"g": NoiseSpec("gumbel", 3)},
        obs_spec={"state": ObsSpec((3,), np.float32)},
        action_shape=(),
    )


def test_slot_table_masks_and_attaches():
    table = SlotTable(_counter_policy(), 3, base_seed=5)
    obs = {"state": np.ones((3, 3), np.float32)}
    table.step(obs, np.array([True, True, True]))
    before = {k: v.clone() for k, v in table.states.items()}
    table.step(obs, np.array([True, False, True]))
    assert torch.equal(table.states["acc"][1], before["acc"][1])  # bit-exact
    assert not torch.equal(table.states["acc"][0], before["acc"][0])
    # the masked row's generator did not advance: its next draw equals a fresh
    # generator advanced by one step
    table.attach({0: 9, 2: 9})
    assert not table.states["acc"][0].any() and not table.states["acc"][2].any()
    assert torch.equal(table.states["acc"][1], before["acc"][1])
    a = table.step(obs, np.array([True, False, True]))
    assert a[0] == a[2]  # same session seed, same observation, same noise
    assert table.state_bytes() == 3 * 3 * 4


def test_reads_a_checkpoint_written_by_the_jax_package(tmp_path):
    """A JAX-written checkpoint (agent params + optax.adam state + counters) loads
    in a process that cannot import jax, flax or optax, and its agent tree
    converts into the port's agent and back unchanged."""
    import optax

    from sheeprl_tpu.utils.checkpoint import save_checkpoint as jax_save

    from test_torch_helpers import paired_agents

    _, params, _, _, _ = paired_agents("discrete")
    opt = optax.adam(1e-3)
    state = {
        "agent": jax.tree_util.tree_map(jnp.asarray, params),
        "opt_state": {"world_model": opt.init(jax.tree_util.tree_map(jnp.asarray, params["world_model"]))},
        "iter_num": 3,
        "batch_size": 16,
    }
    ckpt = tmp_path / "ckpt_3_0.ckpt"
    jax_save(str(ckpt), state)
    out = tmp_path / "roundtrip.pkl"
    script = f"""
import sys
for name in ("jax", "jaxlib", "flax", "optax", "chex", "orbax"):
    sys.modules[name] = None  # any import of these now fails
import pickle
from sheeprl_tpu_torch.config import compose
from sheeprl_tpu_torch.algos.dreamer_v3.agent import build_agent
from sheeprl_tpu_torch.interop.flax_to_torch import agent_to_flax
from sheeprl_tpu_torch.parallel.fabric import Fabric
from sheeprl_tpu_torch.utils.checkpoint import load_checkpoint
from sheeprl_tpu_torch.utils.env import make_env
state = load_checkpoint({str(ckpt)!r})
assert state["iter_num"] == 3 and state["batch_size"] == 16
adam = state["opt_state"]["world_model"]  # optax's (ScaleByAdamState, EmptyState)
assert type(adam[0]).__module__.startswith("inert.optax"), type(adam[0])
cfg = compose({overrides("discrete")!r})
env = make_env(cfg, 0, 0)()
agent = build_agent(Fabric(accelerator="cpu"), (2,), False, cfg, env.observation_space, 0, state["agent"])
pickle.dump(agent_to_flax(agent), open({str(out)!r}, "wb"))
bad = [m for m in sys.modules if m.split(".")[0] in ("jax", "flax", "optax", "sheeprl_tpu") and sys.modules[m] is not None]
assert not bad, bad
"""
    env = {**os.environ, **SUBPROCESS_ENV, "PYTHONPATH": str(REPO)}
    proc = subprocess.run([sys.executable, "-c", script], env=env, capture_output=True, text=True, timeout=240)
    assert proc.returncode == 0, proc.stderr[-3000:]
    back = pickle.load(open(out, "rb"))
    for a, b in zip(jax.tree_util.tree_leaves(back), jax.tree_util.tree_leaves(params)):
        np.testing.assert_array_equal(a, b)


def test_refuses_classes_outside_the_admitted_modules(tmp_path):
    from sheeprl_tpu_torch.utils.checkpoint import load_checkpoint

    path = tmp_path / "evil.ckpt"
    with open(path, "wb") as f:
        pickle.dump({"agent": subprocess.Popen}, f)
    with pytest.raises(pickle.UnpicklingError, match="not admitted"):
        load_checkpoint(str(path))


def _write_run(tmp_path: Path, kind: str, writer: str) -> Path:
    """A run dir (version_0/{config.yaml, checkpoint/ckpt_0_0.ckpt}) of the small
    DV3 agent, written by the JAX package or by the port."""
    run = tmp_path / f"run_{writer}_{kind}"
    ckpt = run / "version_0" / "checkpoint" / "ckpt_0_0.ckpt"
    if writer == "jax":
        from sheeprl_tpu.config import compose as jax_compose
        from sheeprl_tpu.utils.checkpoint import save_checkpoint as jax_save

        from test_torch_helpers import paired_agents

        _, params, _, _, _ = paired_agents(kind)
        cfg = jax_compose(overrides(kind)).as_dict()
        jax_save(str(ckpt), {"agent": params})
    else:
        from sheeprl_tpu_torch.config import compose
        from sheeprl_tpu_torch.interop.flax_to_torch import agent_to_flax
        from sheeprl_tpu_torch.utils.checkpoint import save_checkpoint

        policy = _torch_policy(kind, True)
        cfg = compose(overrides(kind)).as_dict()
        save_checkpoint(str(ckpt), {"agent": agent_to_flax(policy.module)})
    with open(run / "version_0" / "config.yaml", "w") as f:
        yaml.safe_dump(cfg, f, sort_keys=False)
    return run


@pytest.mark.timeout(300)
@pytest.mark.parametrize("kind,writer", [("discrete", "jax"), ("continuous", "torch")])
def test_cli_serves_on_cpu(tmp_path, kind, writer):
    run = _write_run(tmp_path, kind, writer)
    log_dir = tmp_path / "serve_log"
    env = {**os.environ, **SUBPROCESS_ENV, "PYTHONPATH": str(REPO)}
    proc = subprocess.run(
        [
            sys.executable, "-m", "sheeprl_tpu_torch", "serve", f"checkpoint_path={run}",
            "fabric.accelerator=cpu", "serve.sessions=3", "serve.slots=2",
            "serve.max_session_steps=6", f"serve.log_dir={log_dir}",
        ],
        env=env, capture_output=True, text=True, timeout=240,
    )
    assert proc.returncode == 0, proc.stdout[-2000:] + proc.stderr[-3000:]
    assert proc.stdout.count("session seed=") == 3
    summary = yaml.safe_load(open(log_dir / "summary.json"))
    assert summary["sessions_completed"] == 3 and summary["device"] == "cpu"
    assert summary["steps"] == (15 if kind == "discrete" else 18)  # discrete_dummy ends after 5 steps


def test_auto_accelerator_needs_a_card(tmp_path):
    from sheeprl_tpu_torch.parallel.fabric import Fabric
    from sheeprl_tpu_torch.serve.main import serve_main

    if torch.cuda.is_available():
        assert Fabric(accelerator="auto").device.type == "cuda"
        return
    with pytest.raises(RuntimeError, match="needs a CUDA device"):
        Fabric(accelerator="auto")
    with pytest.raises(RuntimeError, match="needs a CUDA device"):
        Fabric(accelerator="gpu")
    run = _write_run(tmp_path, "discrete", "torch")
    with pytest.raises(RuntimeError, match="needs a CUDA device"):
        serve_main([f"checkpoint_path={run}", "fabric.accelerator=auto", "serve.sessions=1"])


@pytest.mark.parametrize("kind", ["ckpt_kill", "lr_spike", "kill_rank", "stale_heartbeat", "channel_drop"])
def test_unported_knobs_raise(tmp_path, kind):
    """The training-only and multi-rank fault kinds of the JAX package are
    refused by name; the serve kinds run (tests/test_torch_serve_supervisor.py)."""
    from sheeprl_tpu_torch.serve.main import serve_main

    run = _write_run(tmp_path, "discrete", "torch")
    with pytest.raises(NotImplementedError, match=f"resilience.fault.kind={kind}: not yet ported"):
        serve_main([f"checkpoint_path={run}", "fabric.accelerator=cpu", f"resilience.fault.kind={kind}"])


def test_serving_a_sac_checkpoint_at_bf16_is_not_yet_ported(tmp_path):
    """Dreamer-V3 serves at the bf16 policies; a SAC checkpoint served at
    bf16 is refused by name, as SAC's training is."""
    from sheeprl_tpu_torch.algos.sac.agent import build_agent
    from sheeprl_tpu_torch.config import compose
    from sheeprl_tpu_torch.interop.flax_to_torch import sac_to_flax
    from sheeprl_tpu_torch.parallel.fabric import Fabric
    from sheeprl_tpu_torch.serve.main import serve_main
    from sheeprl_tpu_torch.utils.checkpoint import save_checkpoint
    from test_torch_helpers import SAC_SMALL, sac_spaces

    cfg = compose(SAC_SMALL)
    agent = build_agent(Fabric(accelerator="cpu"), cfg, *sac_spaces(), 0)
    run = tmp_path / "run_sac"
    save_checkpoint(str(run / "version_0" / "checkpoint" / "ckpt_0_0.ckpt"), {"agent": sac_to_flax(agent)})
    with open(run / "version_0" / "config.yaml", "w") as f:
        yaml.safe_dump(cfg.as_dict(), f, sort_keys=False)
    with pytest.raises(NotImplementedError, match="bf16 is not yet ported"):
        serve_main([f"checkpoint_path={run}", "fabric.accelerator=cpu", "fabric.precision=bf16-mixed"])


def test_exit_codes_nothing_to_drive_and_drain(tmp_path):
    from sheeprl_tpu_torch.resilience import signals
    from sheeprl_tpu_torch.serve.main import serve_main

    run = _write_run(tmp_path, "continuous", "torch")
    base = [f"checkpoint_path={run}", "fabric.accelerator=cpu", f"serve.log_dir={tmp_path / 'log'}"]
    assert serve_main(base + ["serve.sessions=0"]) == 2
    # a preemption request mid-run drains the server: exit 75
    timer = threading.Timer(1.0, signals.request_preemption)
    timer.start()
    try:
        rc = serve_main(
            base
            + ["serve.sessions=2", "serve.max_session_steps=1000000", "serve.drain_grace_s=0.5",
               "env.wrapper.n_steps=1000000"]
        )
    finally:
        timer.cancel()
        signals.reset_preemption()
    assert rc == signals.PREEMPTED_EXIT_CODE

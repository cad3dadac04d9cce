"""Checkpoint-set manifests across the two packages: each reads the other's,
a commit needs every rank's ack, a crash inside the save (or the ``ckpt_kill``
fault) leaves the set unresolvable, a re-save clears stale acks, and both
packages' discovery prefer an older complete set over a newer torn one.

The port's ``checkpoint_manifest`` takes the ranks that share the save; the
JAX one reads them from the fabric's mesh (given here as a namespace with
``mesh.devices``).
"""

from __future__ import annotations

import json
import os
import time
from types import SimpleNamespace

import numpy as np
import pytest

from sheeprl_tpu.parallel import distributed as jax_par
from sheeprl_tpu.resilience import discovery as jax_discovery
from sheeprl_tpu.resilience import distributed as jax_dist
from sheeprl_tpu_torch.parallel import distributed as port_par
from sheeprl_tpu_torch.resilience import discovery as port_discovery
from sheeprl_tpu_torch.resilience import distributed as port_dist
from sheeprl_tpu_torch.resilience import faults as port_faults
from test_torch_resilience_coordinator import JaxFakeKV, PortFakeKV

FIELDS = ("schema", "step", "path", "ranks_expected", "ranks_committed", "complete")


def _mesh(*ranks):
    return SimpleNamespace(mesh=SimpleNamespace(devices=np.array([SimpleNamespace(process_index=r) for r in ranks],
                                                                 dtype=object)))


@pytest.fixture
def planes(monkeypatch):
    """Both packages as process ``me`` of two, each on its own fake plane."""
    jax_kv, port_kv = JaxFakeKV(), PortFakeKV()
    monkeypatch.setattr(jax_dist, "_kv", lambda: jax_kv)
    monkeypatch.setattr(port_dist, "_kv", lambda: port_kv)

    def rank(me):
        for module in (jax_par, port_par):
            monkeypatch.setattr(module, "process_count", lambda: 2)
            monkeypatch.setattr(module, "process_index", lambda me=me: me)

    rank(0)
    port_faults.reset_faults()
    yield jax_kv, port_kv, rank
    port_faults.reset_faults()


def _write(path, data=b"x"):
    with open(path, "wb") as f:
        f.write(data)


def test_each_package_reads_the_others_manifest(tmp_path, planes):
    """A committed set written by either package: the other reads the same
    fields and resolves it; an incomplete one vetoes its set in both."""
    runs = {"jax": tmp_path / "jax", "port": tmp_path / "port"}
    for name, run in runs.items():
        run.mkdir()
        ckpt = str(run / "ckpt_64_0.ckpt")
        manifest = (jax_dist.checkpoint_manifest(_mesh(0), ckpt) if name == "jax"
                    else port_dist.checkpoint_manifest(ckpt, ranks=(0,)))
        with manifest:
            _write(ckpt)
    ours = port_discovery.read_manifest(str(runs["port"] / "ckpt_64_0.ckpt"))
    theirs = jax_discovery.read_manifest(str(runs["jax"] / "ckpt_64_0.ckpt"))
    assert {k: ours[k] for k in FIELDS} == {k: theirs[k] for k in FIELDS}
    assert ours["complete"] is True and ours["ranks_committed"] == [0]
    for run in runs.values():
        for discovery in (jax_discovery, port_discovery):
            assert discovery.read_manifest(str(run / "ckpt_64_0.ckpt")) == json.loads(
                (run / "ckpt_64.manifest.json").read_text())
            assert discovery.find_latest_checkpoint(str(run)) == str(run / "ckpt_64_0.ckpt")
    # a begun, never committed manifest vetoes the set in both packages
    for run in runs.values():
        (run / "ckpt_64.manifest.json").write_text(json.dumps({**ours, "complete": False}))
        for discovery in (jax_discovery, port_discovery):
            assert not discovery.is_valid_checkpoint(str(run / "ckpt_64_0.ckpt"))


def test_a_commit_needs_every_ack_and_a_resave_clears_stale_ones(tmp_path, planes):
    jax_kv, port_kv, rank = planes
    results = {}
    for name in ("jax", "port"):
        run = tmp_path / name
        run.mkdir()
        ckpt = str(run / "ckpt_100_0.ckpt")

        def manifest(timeout_s, name=name, ckpt=ckpt):
            if name == "jax":
                return jax_dist.checkpoint_manifest(_mesh(0, 1), ckpt, timeout_s=timeout_s)
            return port_dist.checkpoint_manifest(ckpt, ranks=(0, 1), timeout_s=timeout_s)

        def ack(name=name):
            key = "sheeprl_res/ckptack/ckpt_100.manifest.json/s100/r1"
            jax_kv.key_value_set(key, "1") if name == "jax" else port_kv.set(key, "1")

        steps = []
        with manifest(0.2):  # no ack: stays incomplete
            _write(ckpt)
        steps.append(port_discovery.read_manifest(ckpt)["complete"])
        with manifest(5.0):  # rank 1 acks during the save
            ack()
        steps.append(port_discovery.read_manifest(ckpt)["complete"])
        ack()  # a stale ack of that save must not satisfy the next one
        with manifest(0.2):
            _write(ckpt, b"y")
        steps.append(port_discovery.read_manifest(ckpt)["complete"])
        results[name] = steps
    assert results["port"] == results["jax"] == [False, True, False]
    assert not port_kv.get_many(["sheeprl_res/ckptack/ckpt_100.manifest.json/s100/r1"])
    # rank 1 writes no manifest, only its ack, under rank 0's manifest name
    rank(1)
    ckpt = str(tmp_path / "ckpt_64_1.ckpt")
    with port_dist.checkpoint_manifest(ckpt, ranks=(0, 1), timeout_s=1.0):
        pass
    assert port_discovery.read_manifest(ckpt) is None
    assert port_kv.get("sheeprl_res/ckptack/ckpt_64.manifest.json/s64/r1") == "1"


def test_a_crash_inside_the_save_leaves_the_set_incomplete(tmp_path, planes):
    for name in ("jax", "port"):
        run = tmp_path / name
        run.mkdir()
        ckpt = str(run / "ckpt_8_0.ckpt")
        manifest = (jax_dist.checkpoint_manifest(_mesh(0, 1), ckpt, timeout_s=0.2) if name == "jax"
                    else port_dist.checkpoint_manifest(ckpt, ranks=(0, 1), timeout_s=0.2))
        with pytest.raises(RuntimeError, match="boom"):
            with manifest:
                _write(ckpt, b"torn")
                raise RuntimeError("boom")
        for discovery in (jax_discovery, port_discovery):
            assert discovery.read_manifest(ckpt)["complete"] is False
            assert not discovery.is_valid_checkpoint(ckpt)


def test_discovery_prefers_an_older_complete_set_over_a_newer_torn_one(tmp_path):
    older, newer = tmp_path / "ckpt_8_0.ckpt", tmp_path / "ckpt_16_0.ckpt"
    _write(older)
    (tmp_path / "ckpt_8.manifest.json").write_text(
        json.dumps({"schema": 1, "step": 8, "complete": True, "ranks_expected": [0], "ranks_committed": [0]}))
    _write(newer)
    (tmp_path / "ckpt_16.manifest.json").write_text(
        json.dumps({"schema": 1, "step": 16, "complete": False, "ranks_expected": [0, 1]}))
    past = time.time() - 60
    os.utime(older, (past, past))
    for discovery in (jax_discovery, port_discovery):
        assert not discovery.is_valid_checkpoint(str(newer))
        assert discovery.find_latest_checkpoint(str(tmp_path)) == str(older)


@pytest.mark.parametrize("processes", [1, 2])
def test_ckpt_kill_leaves_the_torn_artifact_both_discoveries_skip(tmp_path, planes, monkeypatch, processes):
    """The fault raises between the temporary write and the rename: the
    ``.tmp`` stays, the step's manifest (in a two-process run) stays
    incomplete, and both packages' discovery fall back to the same earlier
    checkpoint. One shot: the next write lands."""
    from sheeprl_tpu_torch.utils.checkpoint import write_run_checkpoint

    if processes == 1:
        for module in (jax_par, port_par):
            monkeypatch.setattr(module, "process_count", lambda: 1)
    run = tmp_path / "version_0" / "checkpoint"
    write_run_checkpoint(str(run / "ckpt_8_0.ckpt"), {"iter_num": 4})
    past = time.time() - 60
    os.utime(run / "ckpt_8_0.ckpt", (past, past))
    port_faults.build_fault_plan({"fault": {"kind": "ckpt_kill", "at_policy_step": 16}}, 0).maybe_fire(
        16, lambda *a, **k: None)
    with pytest.raises(port_faults.InjectedFaultError, match="ckpt_kill: injected kill during checkpoint write"):
        write_run_checkpoint(str(run / "ckpt_16_0.ckpt"), {"iter_num": 8})
    assert (run / "ckpt_16_0.ckpt.tmp").is_file() and not (run / "ckpt_16_0.ckpt").exists()
    if processes == 2:
        assert json.loads((run / "ckpt_16.manifest.json").read_text())["complete"] is False
    else:
        assert not (run / "ckpt_16.manifest.json").exists()
    for discovery in (jax_discovery, port_discovery):
        assert discovery.find_latest_checkpoint(str(tmp_path)) == str(run / "ckpt_8_0.ckpt")
    write_run_checkpoint(str(run / "ckpt_16_0.ckpt"), {"iter_num": 8})
    for discovery in (jax_discovery, port_discovery):
        assert discovery.find_latest_checkpoint(str(tmp_path)) == str(run / "ckpt_16_0.ckpt")

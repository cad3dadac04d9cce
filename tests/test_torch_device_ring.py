"""The port's replay ring on the device (``sheeprl_tpu_torch/data/device_ring.py``)
against the JAX package's (``sheeprl_tpu/data/device_ring.py``), on the CPU.

- ``ring_capacity`` and ``ring_init`` refuse what the JAX functions refuse;
- ``ring_write`` leaves the same rows, cursor and fill as the JAX one through
  a wrap and an oversize block;
- ``ring_sample`` draws the same slots, index for index, on the fill ramp,
  on a full ring and with a draw larger than the slot count, from the round
  keys the JAX key gives;
- the snapshot into the host twin and back (through a checkpoint file), and a
  JAX buffer's pickled state rebuilt as the port's;
- the ``DeviceRingSampler`` surface behind ``make_replay_sampler``.

Everything is compared exactly: rows are copied, never computed.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

SPECS = {"observations": (3,), "rewards": (1,)}


def _rows(start: int, steps: int, n_envs: int) -> dict:
    """Rows whose values encode (step, env)."""
    base = np.arange(start, start + steps, dtype=np.float32)[:, None, None]
    env = np.arange(n_envs, dtype=np.float32)[None, :, None] / 100.0
    return {"observations": np.broadcast_to(base + env, (steps, n_envs, 3)).copy(),
            "rewards": (base + env).reshape(steps, n_envs, 1)}


def _rings(capacity: int, n_envs: int):
    from sheeprl_tpu.data.device_ring import ring_init as jax_ring_init
    from sheeprl_tpu_torch.data.device_ring import ring_init

    jring = jax_ring_init(capacity, n_envs, {k: (s, np.float32) for k, s in SPECS.items()})
    ring = ring_init(capacity, n_envs, {k: (s, torch.float32) for k, s in SPECS.items()}, "cpu")
    return jring, ring


def _same_ring(ring, jring) -> None:
    for k in SPECS:
        np.testing.assert_array_equal(ring["data"][k].numpy(), np.asarray(jring["data"][k]), err_msg=k)
    assert (ring["pos"], ring["fill"]) == (int(jring["pos"]), int(jring["fill"]))


def _round_keys(key) -> torch.Tensor:
    """The 8 round keys the JAX ``prp_permutation`` draws from ``key``."""
    return torch.from_numpy(np.asarray(jax.random.randint(key, (8,), 0, np.iinfo(np.int32).max)).astype(np.int64))


def test_ring_capacity_and_init_refuse_what_the_jax_functions_refuse():
    from sheeprl_tpu.data.device_ring import ring_capacity as jax_ring_capacity
    from sheeprl_tpu_torch.data.device_ring import ring_capacity, ring_init

    for size, n_envs in ((100, 4), (128, 4), (1, 8), (262144, 64), (262144, 512), (5, 2)):
        assert ring_capacity(size, n_envs) == jax_ring_capacity(size, n_envs)
    with pytest.raises(ValueError, match="power-of-two env count"):
        ring_capacity(100, 3)
    for capacity, n_envs in ((3, 4), (1, 1)):
        with pytest.raises(ValueError, match="power-of-two slot count"):
            ring_init(capacity, n_envs, {"rewards": ((1,), torch.float32)}, "cpu")


def test_ring_write_matches_the_jax_write_through_a_wrap_and_an_oversize_block():
    from sheeprl_tpu.data.device_ring import ring_write as jax_ring_write
    from sheeprl_tpu_torch.data.device_ring import ring_write

    capacity, n_envs = 8, 4
    jring, ring = _rings(capacity, n_envs)
    write = jax.jit(jax_ring_write)  # as the JAX sampler runs it
    start = 0
    # 5 rows, 2 rows (to 7), 3 rows (wraps: 1 at the end, 2 at the head), 11
    # rows (oversize: its trailing 8, written from the cursor), then 1
    for steps in (5, 2, 3, 11, 1):
        rows = _rows(start, steps, n_envs)
        start += steps
        jring = write(jring, {k: jnp.asarray(v) for k, v in rows.items()})
        ring_write(ring, {k: torch.from_numpy(v) for k, v in rows.items()})
        _same_ring(ring, jring)
    # the oversize block moved the cursor by capacity rows, not by 11
    assert ring["fill"] == capacity and ring["pos"] == (5 + 2 + 3 + capacity + 1) % capacity


@pytest.mark.parametrize("capacity,n_envs,fills,batch,n_samples", [
    # the fill ramp, with 36 draws of 16 slots: they wrap around the permutation
    (8, 2, (1, 3, 6, 8), 12, 3),
    # full, then wrapped: 64 draws of 64 slots, a bijection
    (16, 4, (16, 21), 16, 4),
], ids=["fill-ramp-and-draws-over-slots", "full"])
def test_ring_sample_draws_the_jax_slots_index_for_index(capacity, n_envs, fills, batch, n_samples):
    from sheeprl_tpu.data.device_ring import ring_sample as jax_ring_sample
    from sheeprl_tpu.data.device_ring import ring_write as jax_ring_write
    from sheeprl_tpu_torch.data.device_ring import ring_sample, ring_write

    jring, ring = _rings(capacity, n_envs)
    sample = jax.jit(jax_ring_sample, static_argnames=("batch_size", "n_samples"))
    written = 0
    for i, fill in enumerate(fills):
        rows = _rows(written, fill - written, n_envs)
        written = fill
        jring = jax_ring_write(jring, {k: jnp.asarray(v) for k, v in rows.items()})
        ring_write(ring, {k: torch.from_numpy(v) for k, v in rows.items()})
        key = jax.random.PRNGKey(10 + i)
        theirs = sample(jring, key, batch_size=batch, n_samples=n_samples)
        ours = ring_sample(ring, _round_keys(key), batch, n_samples)
        for k in SPECS:
            assert ours[k].shape == (n_samples, batch, *SPECS[k])
            np.testing.assert_array_equal(ours[k].numpy(), np.asarray(theirs[k]), err_msg=f"{k} at fill {fill}")
        steps = ours["rewards"].numpy().reshape(-1)
        # every draw lies in the filled region: the newest min(fill, capacity) rows
        assert written - min(fill, capacity) <= steps.min() and steps.max() < written
    if fills[-1] >= capacity and batch * n_samples == capacity * n_envs:
        # a full ring: the draw covers every slot once
        assert len(np.unique(steps)) == capacity * n_envs
    with pytest.raises(ValueError, match="must be > 0"):
        ring_sample(ring, _round_keys(key), 0)


def test_the_ring_snapshot_round_trips_and_a_jax_buffer_becomes_the_ports(tmp_path):
    """Snapshot into the twin (its cursor and fullness from the ring), save
    and load as a checkpoint's buffer, land back on the device: the same
    ring. A JAX ``ReplayBuffer`` (not full, so pickled as its ``[:_pos]``
    prefix) loads as an inert object whose state rebuilds the same buffer."""
    from sheeprl_tpu.data.buffers import ReplayBuffer as JaxReplayBuffer
    from sheeprl_tpu.utils.checkpoint import save_checkpoint as jax_save_checkpoint
    from sheeprl_tpu_torch.data.device_ring import (
        buffer_from_jax_state,
        buffer_to_ring,
        ring_to_buffer,
        ring_write,
    )
    from sheeprl_tpu_torch.utils.checkpoint import InertObject, load_checkpoint, save_checkpoint

    # 6 rows, and 11 (oversize: the trailing 8 from the cursor, which stays at 0)
    for steps, full, pos in ((6, False, 6), (11, True, 0)):
        _, ring = _rings(8, 4)
        ring_write(ring, {k: torch.from_numpy(v) for k, v in _rows(0, steps, 4).items()})
        rb = ring_to_buffer(ring)
        assert (rb._pos, rb.full, rb.buffer_size, rb.n_envs) == (pos, full, 8, 4)
        save_checkpoint(str(tmp_path / "rb.ckpt"), {"rb": rb})
        back = buffer_to_ring(load_checkpoint(str(tmp_path / "rb.ckpt"))["rb"], "cpu")
        assert (back["pos"], back["fill"]) == (ring["pos"], ring["fill"])
        filled = ring["fill"]
        for k in SPECS:
            torch.testing.assert_close(back["data"][k][:filled], ring["data"][k][:filled], rtol=0, atol=0)
        # the ring's writes leave the twin as it was
        ring_write(back, {k: torch.from_numpy(v) for k, v in _rows(100, 1, 4).items()})
        assert float(rb["rewards"].max()) < 100

    jrb = JaxReplayBuffer(16, 2, memmap=False)
    jrb.add({k: v[:, :2] for k, v in _rows(0, 5, 2).items()})
    jax_save_checkpoint(str(tmp_path / "jax.ckpt"), {"rb": jrb})
    inert = load_checkpoint(str(tmp_path / "jax.ckpt"))["rb"]
    assert isinstance(inert, InertObject) and inert.state["_truncated_to_pos"]
    rb = buffer_from_jax_state(inert.state)
    assert (rb._pos, rb.full, rb.buffer_size, rb.n_envs) == (5, False, 16, 2)
    for k in SPECS:
        np.testing.assert_array_equal(rb[k][:5], np.asarray(jrb[k][:5]))
    ring = buffer_to_ring(rb, "cpu")
    assert (ring["pos"], ring["fill"]) == (5, 5)


def test_the_device_ring_sampler_surface():
    from sheeprl_tpu_torch.data.buffers import ReplayBuffer
    from sheeprl_tpu_torch.data.prefetch import make_replay_sampler

    rb = ReplayBuffer(8, 4, memmap=False)
    with pytest.raises(ValueError, match="sample_next_obs=True is a host-replay feature"):
        make_replay_sampler(rb, backend="device", sample_kwargs={"batch_size": 4, "sample_next_obs": True})
    with pytest.raises(ValueError, match="host-side sample transforms"):
        make_replay_sampler(rb, backend="device", sample_kwargs={"batch_size": 4}, uint8_keys=("rgb",))
    with pytest.raises(NotImplementedError, match="sample inline"):
        make_replay_sampler(rb, {"enabled": True}, sample_kwargs={"batch_size": 4})

    with make_replay_sampler(rb, {"enabled": True, "depth": 4}, backend="device", seed=3,
                             sample_kwargs={"batch_size": 4, "n_samples": 9}) as sampler:
        assert sampler.buffer is rb and sampler.ring is None
        with pytest.raises(RuntimeError, match="call add\\(\\) first"):
            sampler.sample(1)
        sampler.add(_rows(0, 3, 4))
        sampler.add({k: torch.from_numpy(v) for k, v in _rows(3, 7, 4).items()})
        block = sampler.sample(2)
        assert block["observations"].shape == (2, 4, 3)
        sampler.note_writes(6)
        snap = sampler.telemetry_snapshot()
        assert (snap["ring_fill"], snap["ring_capacity"], snap["sample_calls"], snap["units"]) == (8, 8, 1, 2)
        assert snap["ring_overwritten"] == (3 + 7 + 6 - 8) * 4
        # the sampler's own generator: the same seed draws the same slots
        again = make_replay_sampler(ReplayBuffer(8, 4), backend="device", seed=3, sample_kwargs={"batch_size": 4})
        again.add(_rows(0, 3, 4))
        again.add(_rows(3, 7, 4))
        torch.testing.assert_close(again.sample(2)["rewards"], block["rewards"], rtol=0, atol=0)

        twin = sampler.sync_to_host()
        assert twin is rb and rb._pos == 10 % 8 and rb.full
        sampler.ring = None
        sampler.restore_from_host()
        assert (sampler.ring["pos"], sampler.ring["fill"]) == (2, 8)
        # a restored twin lands on the device at construction
        resumed = make_replay_sampler(rb, backend="device", sample_kwargs={"batch_size": 4})
        torch.testing.assert_close(resumed.ring["data"]["rewards"], sampler.ring["data"]["rewards"], rtol=0, atol=0)

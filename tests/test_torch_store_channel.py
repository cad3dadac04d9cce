"""The port's object channel over a ``torch.distributed.TCPStore``
(``sheeprl_tpu_torch/parallel/distributed.py``), on the CPU: a master store and
a client store in this process, the channel's source on one and a receiver on
the other, in two threads.

- a payload over the store's 8 MiB value limit round-trips, in chunks;
- the source deletes round k - 2's keys when it writes round k;
- a bounded get that sees no message raises ``ChannelTimeout`` within
  ``timeout_s + poll_s``, and the client store still works afterwards;
- a published failure marker ends a wait with ``ChannelPeerError`` naming the
  rank and the reason;
- a second channel with the same source reads and writes its own keys;
- the marker (attempt-scoped, its reason cut at 512 characters) is the JAX
  package's, key and value, on the same injected in-memory plane.
"""

from __future__ import annotations

import datetime
import pickle
import threading
import time

import numpy as np
import pytest
import torch


@pytest.fixture
def stores():
    """A master on a free port and a client of it: the player's and the
    learner's ends of one run."""
    from torch.distributed import TCPStore

    timeout = datetime.timedelta(seconds=30)
    master = TCPStore("127.0.0.1", 0, 2, True, timeout=timeout, wait_for_workers=False)
    client = TCPStore("127.0.0.1", master.port, 2, False, timeout=timeout)
    yield master, client


def _channel(src: int, store, rank: int, **kw):
    from sheeprl_tpu_torch.parallel.distributed import BroadcastChannel

    return BroadcastChannel(src, store=store, rank=rank, **{"timeout_s": 30.0, "poll_s": 0.2, **kw})


def _rows_in_chunks(n: int) -> int:
    """int64 rows that pickle into ``n`` chunks."""
    from sheeprl_tpu_torch.parallel.distributed import CHUNK_BYTES

    return (n - 1) * CHUNK_BYTES // 8 + 1024


def _get_in_thread(channel):
    out = {}

    def body():
        try:
            out["msg"] = channel.get()
        except BaseException as exc:  # handed to the test's thread
            out["exc"] = exc

    thread = threading.Thread(target=body, daemon=True)
    thread.start()
    return thread, out


@pytest.mark.timeout(60)
def test_a_payload_over_the_value_limit_crosses_in_chunks(stores):
    from sheeprl_tpu_torch.parallel.distributed import CHUNK_BYTES

    master, client = stores
    source, receiver = _channel(0, master, 0), _channel(0, client, 1)
    rng = np.random.default_rng(0)
    block = {"obs": torch.from_numpy(rng.standard_normal((10 * 1024 * 1024 // 4,)).astype(np.float32)), "step": 7}
    thread, out = _get_in_thread(receiver)
    source.put(block)
    thread.join(timeout=30)
    assert "exc" not in out, out.get("exc")
    assert out["msg"]["step"] == 7 and torch.equal(out["msg"]["obs"], block["obs"])
    tag = source._tag(0)
    n = int(client.get(f"{tag}/n"))
    assert n == -(-len(pickle.dumps(block, protocol=pickle.HIGHEST_PROTOCOL)) // CHUNK_BYTES) and n >= 5
    assert all(client.check([f"{tag}/c{i}"]) for i in range(n))


@pytest.mark.timeout(60)
def test_round_k_deletes_round_k_minus_2(stores):
    master, client = stores
    source, receiver = _channel(0, master, 0), _channel(0, client, 1)
    for k in range(4):
        source.put({"round": k, "rows": torch.arange(_rows_in_chunks(3))})
        assert receiver.get()["round"] == k
        live = [r for r in range(k + 1) if client.check([f"{source._tag(r)}/n"])]
        assert live == [r for r in (k - 1, k) if r >= 0], (k, live)
        if k >= 2:
            gone = source._tag(k - 2)
            assert not any(client.check([f"{gone}/c{i}"]) for i in range(3))


@pytest.mark.timeout(60)
def test_a_bounded_get_times_out_and_leaves_the_store_usable(stores):
    from sheeprl_tpu_torch.parallel.distributed import ChannelTimeout

    master, client = stores
    receiver = _channel(0, client, 1, timeout_s=1.0, poll_s=0.3)
    t0 = time.monotonic()
    with pytest.raises(ChannelTimeout, match="timed out after 1s"):
        receiver.get()
    assert time.monotonic() - t0 <= 1.0 + 0.3 + 0.5
    # the same client connection: a plain key, then the channel's next round
    master.set("after", b"ok")
    assert client.get("after") == b"ok"
    source = _channel(0, master, 0)
    source.put("round 0")
    assert receiver.get() == "round 0"


@pytest.mark.timeout(60)
def test_a_published_marker_ends_a_wait_with_the_peer_error(stores):
    from sheeprl_tpu_torch.parallel.distributed import ChannelPeerError, StoreKV, publish_channel_error

    master, client = stores
    receiver = _channel(1, master, 0, timeout_s=30.0, poll_s=0.2)
    thread, out = _get_in_thread(receiver)
    time.sleep(0.3)
    t0 = time.monotonic()
    assert publish_channel_error("checkpoint resume load failed: FileNotFoundError", rank=1, kv=StoreKV(client))
    thread.join(timeout=10)
    assert time.monotonic() - t0 < 2.0
    assert isinstance(out.get("exc"), ChannelPeerError)
    assert "rank 1: checkpoint resume load failed: FileNotFoundError" in str(out["exc"])


@pytest.mark.timeout(60)
def test_a_second_channel_with_the_same_source_has_its_own_keys(stores):
    master, client = stores
    first_src, first_dst = _channel(0, master, 0), _channel(0, client, 1)
    second_src, second_dst = _channel(0, master, 0), _channel(0, client, 1)
    assert (first_src.nonce, second_src.nonce) == (first_dst.nonce, second_dst.nonce)
    assert first_src.nonce != second_src.nonce
    for k in range(3):
        first_src.put(("first", k))
        second_src.put(("second", k))
        assert second_dst.get() == ("second", k)
        assert first_dst.get() == ("first", k)


@pytest.mark.timeout(60)
def test_the_marker_is_the_jax_packages_attempt_scoped_and_cut(stores, monkeypatch):
    from sheeprl_tpu.data.service import LocalKV
    from sheeprl_tpu.parallel import distributed as jax_distributed
    from sheeprl_tpu_torch.parallel import distributed

    master, client = stores
    ours, theirs = LocalKV(), LocalKV()
    assert distributed.poll_channel_error(ours) is None and jax_distributed.poll_channel_error(theirs) is None
    for attempt, rank, reason in (("0", 1, "x" * 10_000), ("1", 0, "learner train loop failed: boom")):
        monkeypatch.setenv("SHEEPRL_GANG_ATTEMPT", attempt)
        assert distributed.poll_channel_error(ours) is None  # this attempt has no marker yet
        assert distributed.publish_channel_error(reason, rank=rank, kv=ours)
        assert jax_distributed.publish_channel_error(reason, rank=rank, kv=theirs)
        assert ours._data == theirs._data
        marker = distributed.poll_channel_error(ours)
        assert marker == jax_distributed.poll_channel_error(theirs) == f"rank {rank}: {reason}"[:512]
        assert len(marker) <= 512
        # the store's plane holds the same marker under the same key (a set is
        # not acknowledged, so the other connection may see it a moment later)
        assert distributed.publish_channel_error(reason, rank=rank, kv=distributed.StoreKV(master))
        deadline = time.monotonic() + 5.0
        while distributed.poll_channel_error(distributed.StoreKV(client)) is None and time.monotonic() < deadline:
            time.sleep(0.01)
        assert distributed.poll_channel_error(distributed.StoreKV(client)) == marker
    monkeypatch.setenv("SHEEPRL_GANG_ATTEMPT", "0")
    assert distributed.poll_channel_error(ours) == f"rank 1: {'x' * 10_000}"[:512]
    # outside a multi-process run there is no plane: nothing written, nothing read
    assert distributed.publish_channel_error("boom") is False and distributed.poll_channel_error() is None

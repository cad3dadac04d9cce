"""The port's coordinator and channel on a real ``torch.distributed.TCPStore``
(in this process, port 0), where the JAX package's fake KV cannot go: two
coordinators in two threads, each on its own client connection; a channel
wait whose slice is several times the heartbeat timeout beside them; the
``channel_drop`` fault; and the store's master dying under a client.
"""

from __future__ import annotations

import datetime
import json
import subprocess
import sys
import threading
import time

import pytest

from sheeprl_tpu_torch.parallel import distributed as par_dist
from sheeprl_tpu_torch.resilience import distributed as res_dist
from sheeprl_tpu_torch.resilience import faults, signals
from test_torch_helpers import SUBPROCESS_ENV


@pytest.fixture
def master():
    from torch.distributed import TCPStore

    store = TCPStore("127.0.0.1", 0, 2, True, timeout=datetime.timedelta(seconds=30), wait_for_workers=False)
    signals.reset_preemption()
    faults.reset_faults()
    yield store
    faults.reset_faults()
    signals.reset_preemption()
    coord = res_dist.active_coordinator()
    if coord is not None:
        coord.close()


def _client(store):
    from torch.distributed import TCPStore

    return TCPStore("127.0.0.1", store.port, 2, False, timeout=datetime.timedelta(seconds=30))


def _wait_for(cond, timeout):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if cond():
            return True
        time.sleep(0.02)
    return False


def test_two_coordinators_on_a_real_store_agree_beat_and_declare_a_silent_peer_dead(master):
    """Each coordinator on its own connection: rank 1's signal becomes rank 0's
    decision, both beat, and when rank 1's threads stop without leaving, rank 0
    declares it dead within the heartbeat timeout."""
    events = []
    kw = dict(heartbeat_interval=0.05, heartbeat_timeout=0.5, startup_timeout=5.0, poll_interval=0.01,
              namespace="real/agree")
    c0 = res_dist.DistributedCoordinator(0, 2, kv=par_dist.StoreKV(_client(master)),
                                         emit=lambda ev, **f: events.append((ev, f)), **kw)
    c1 = res_dist.DistributedCoordinator(1, 2, kv=par_dist.StoreKV(_client(master)), **kw)
    c0.start(), c1.start()
    try:
        steps = iter(range(0, 4000, 4))

        def both_step(local1=False):
            step = next(steps)
            for coord, local in ((c0, False), (c1, local1)):
                threading.Thread(target=coord.step, args=(step,), kwargs={"local_preempt": local}).start()
            time.sleep(0.02)

        for _ in range(3):
            both_step()
        both_step(local1=True)
        assert _wait_for(lambda: (both_step() or True) and c1.decision() is not None, 5.0)
        assert c0.decision() == c1.decision() and c0.decision()["requested_by"] == [1]
        assert _wait_for(lambda: 1 in c0._hb_seen and 0 in c1._hb_seen, 5.0)
        assert c0.abort_info() is None and c1.abort_info() is None
        # rank 1 goes silent without its "left" record: a dead peer
        c1._stop.set()
        for t in c1._threads:
            t.join()
        c1._threads = []
        t0 = time.monotonic()
        assert _wait_for(lambda: c0.abort_info() is not None, 5.0)
        assert time.monotonic() - t0 < 0.5 + 1.0
        assert c0.abort_info()["rank"] == 1 and [e for e, _ in events] == ["health"]
        with pytest.raises(res_dist.RankFailureError, match="rank 1"):
            c0.check_abort()
    finally:
        c1.close()
        c0.close()


def test_a_long_channel_wait_neither_silences_the_heartbeats_nor_outlasts_a_verdict(master):
    """A channel ``get`` on this process's main connection with ``poll_s``
    ten times the heartbeat timeout: the coordinators, on their own
    connections, keep beating through it (no false death); once the peer is
    silent, the wait's slice is capped at the heartbeat interval, so it ends
    with ``RankFailureError`` within a second of the verdict, not after
    ``poll_s``."""
    kw = dict(heartbeat_interval=0.1, heartbeat_timeout=0.5, startup_timeout=5.0, namespace="real/wait")
    c1 = res_dist.DistributedCoordinator(1, 2, kv=par_dist.StoreKV(_client(master)), **kw).start()
    c0 = res_dist.DistributedCoordinator(0, 2, kv=par_dist.StoreKV(_client(master)), **kw).start()
    assert res_dist.active_coordinator() is c0
    channel = par_dist.BroadcastChannel(src=1, rank=0, store=master, timeout_s=60.0, poll_s=5.0,
                                        abort_check=res_dist.channel_abort_check,
                                        abort_poll=res_dist.channel_abort_poll)
    outcome = {}

    def wait():
        t0 = time.monotonic()
        try:
            channel.get()
        except BaseException as exc:  # the verdict, or a timeout
            outcome["exc"] = exc
        outcome["seconds"] = time.monotonic() - t0

    waiter = threading.Thread(target=wait)
    waiter.start()
    try:
        time.sleep(2.0)  # four heartbeat timeouts, inside one configured poll slice
        assert c0.abort_info() is None and c1.abort_info() is None
        c1._stop.set()  # the peer dies
        for t in c1._threads:
            t.join()
        c1._threads = []
        waiter.join(timeout=10.0)
        assert not waiter.is_alive()
        assert isinstance(outcome["exc"], res_dist.RankFailureError)
        assert outcome["seconds"] < 2.0 + 0.5 + 1.5
    finally:
        c1.close()
        c0.close()


def test_channel_drop_loses_exactly_one_put_on_a_real_store(master):
    """The fault's target advances its sequence with no payload; the receiver's
    bounded wait for that message times out; the next put lands."""
    faults.build_fault_plan({"fault": {"kind": "channel_drop", "rank": 0}}, process_rank=0).maybe_fire(
        0, lambda *a, **k: None)
    source = par_dist.BroadcastChannel(src=0, rank=0, store=master, timeout_s=1.0, poll_s=0.2)
    receiver = par_dist.BroadcastChannel(src=0, rank=1, store=_client(master), timeout_s=0.6, poll_s=0.2)
    source.put({"round": 0})  # lost on the wire
    assert source._seq == 1 and not master.check([f"{source._tag(0)}/n"])
    with pytest.raises(par_dist.ChannelTimeout, match="timed out"):
        receiver.get()
    source.put({"round": 1})
    source.put({"round": 2})  # the lost put left no keys for this put to delete
    receiver._seq = 1
    assert receiver.get() == {"round": 1} and receiver.get() == {"round": 2}
    kv = par_dist.StoreKV(master)
    kv.set("k/a", "1")
    assert kv.get_many(["k/a", "k/b"]) == {"k/a": "1"}
    kv.delete("k/a")
    assert kv.get("k/a") is None


def test_the_masters_death_ends_a_clients_wait_and_its_coordinators_reads(tmp_path):
    """Rank 0 is the store's master: once it dies, a client's channel wait
    raises ``RankFailureError`` within a second (not the store's 300 s
    timeout), and the client's coordinator reads silence and declares rank 0
    dead within its heartbeat timeout."""
    import os

    from torch.distributed import TCPStore

    script = (
        "import datetime, sys, time\n"
        "from torch.distributed import TCPStore\n"
        "s = TCPStore('127.0.0.1', 0, 2, True, timeout=datetime.timedelta(seconds=30), wait_for_workers=False)\n"
        "print(s.port, flush=True)\n"
        "time.sleep(120)\n"
    )
    proc = subprocess.Popen([sys.executable, "-c", script], stdout=subprocess.PIPE, text=True,
                            env={**os.environ, **SUBPROCESS_ENV})
    try:
        port = int(proc.stdout.readline())
        client = TCPStore("127.0.0.1", port, 2, False, timeout=datetime.timedelta(seconds=300))
        coord = res_dist.DistributedCoordinator(
            1, 2, kv=par_dist.StoreKV(TCPStore("127.0.0.1", port, 2, False, timeout=datetime.timedelta(seconds=300))),
            heartbeat_interval=0.05, heartbeat_timeout=0.5, startup_timeout=5.0, namespace="real/master",
        )
        par_dist.StoreKV(client).set("real/master/hb/r0", json.dumps({"n": 1}))
        coord.start()
        assert _wait_for(lambda: 0 in coord._hb_seen, 5.0)
        channel = par_dist.BroadcastChannel(src=0, rank=1, store=client, timeout_s=300.0, poll_s=30.0)
        proc.kill()
        proc.wait()
        t0 = time.monotonic()
        with pytest.raises(res_dist.RankFailureError, match="rank 0 of this run is gone"):
            channel.get()
        assert time.monotonic() - t0 < 1.0
        assert _wait_for(lambda: coord.abort_info() is not None, 5.0)
        assert coord.abort_info()["rank"] == 0
        coord.close()
    finally:
        proc.kill()
        proc.wait()

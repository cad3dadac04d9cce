"""The multi-process plane of the port: a ``torch.distributed.TCPStore`` and the
object channel over it (port of the key-value half of
``sheeprl_tpu/parallel/distributed.py``).

:func:`initialize` opens the store: process 0 is its master, on the
coordinator's port, and every other process a client. Port 0 binds a free
port; the master then prints the address it took
(``[sheeprl] coordinator listening on host:port``), for the launcher to hand to
the other processes. Outside a multi-process run :func:`store` is None and
:func:`process_count` is 1.

:class:`BroadcastChannel` carries one role's messages to the others, with the
JAX channel's surface and semantics: the source pickles a message into chunks
of ``CHUNK_BYTES`` (the store refuses one value over 8 MiB), writes them, then
a manifest key with the count; a receiver waits for the manifest and
reassembles. The source deletes round ``k - 2``'s keys when it writes round
``k`` (the blocking alternation guarantees every receiver has read round
``k - 1``, but the first put, the geometry handshake, has no ack). A ``get``
waits in ``poll_s`` slices up to ``timeout_s``, and between slices runs
``abort_check`` and looks for a peer's failure marker
(:func:`publish_channel_error`): a slice that ends with no message is a
``wait`` that timed out, which leaves the store's connection usable. A
``put`` retries a store write with backoff.

The JAX object-plane helpers (``host_allsum``, ``host_broadcast_object``,
``host_allgather_object``, ``barrier``, ``replicated_to_host``) serve the
multi-process data-parallel path only, which the port does not run yet.
"""

from __future__ import annotations

import datetime
import os
import pickle
import time
from typing import Any, Dict, Optional, Tuple

# well under the store's 8 MiB value limit (the JAX channel's 2 MiB)
CHUNK_BYTES = 2 * 1024 * 1024
# how long a client keeps trying to reach the master, and the store's own
# timeout for an unbounded get
STORE_TIMEOUT_S = 300.0

_store: Any = None
_world = 1
_rank = 0


def process_count() -> int:
    return _world if _store is not None else 1


def process_index() -> int:
    return _rank if _store is not None else 0


def store() -> Any:
    """This process's store, or None outside a multi-process run."""
    return _store


def _split_address(coordinator: str) -> Tuple[str, int]:
    host, _, port = coordinator.rpartition(":")
    if not host or not port.isdigit():
        raise ValueError(f"the coordinator address must be host:port, got {coordinator!r}")
    return host.strip("[]"), int(port)


def initialize(coordinator: Optional[str], num_processes: Optional[int], process_id: Optional[int],
               timeout_s: float = STORE_TIMEOUT_S) -> None:
    """Open this process's store: the master for ``process_id`` 0, a client
    otherwise. A no-op without a coordinator, for one process, or when the
    store is already open."""
    global _store, _world, _rank
    if _store is not None or not coordinator:
        return
    num_processes = int(num_processes or 0)
    if num_processes < 2:
        return
    from torch.distributed import TCPStore

    host, port = _split_address(coordinator)
    rank = int(process_id or 0)
    if not 0 <= rank < num_processes:
        raise ValueError(f"process {rank} of {num_processes}: the rank must lie in [0, {num_processes})")
    timeout = datetime.timedelta(seconds=timeout_s)
    if rank == 0:
        _store = TCPStore(host, port, num_processes, True, timeout=timeout, wait_for_workers=False)
        print(f"[sheeprl] coordinator listening on {host}:{_store.port}", flush=True)
    else:
        _store = TCPStore(host, port, num_processes, False, timeout=timeout)
    _world, _rank = num_processes, rank


class ChannelError(RuntimeError):
    """An operation under a :class:`BroadcastChannel` op failed. The
    alternation may then be out of step, so a crash path must not put again."""


class ChannelTimeout(ChannelError):
    """A bounded ``get`` ran out of time with no message: the source is slow,
    hung or dead."""


class ChannelPeerError(ChannelError):
    """A peer published a failure marker (:func:`publish_channel_error`) while
    this process waited on the channel; the message names its rank and
    reason."""


class StoreKV:
    """A store seen as the JAX package's key-value surface: ``set`` a string,
    ``get`` it back (None when the key is missing, without blocking)."""

    def __init__(self, store: Any):
        self.store = store

    def set(self, key: str, value: str) -> None:
        self.store.set(key, str(value))

    def get(self, key: str) -> Optional[str]:
        if not self.store.check([key]):
            return None
        return self.store.get(key).decode()


def _default_kv() -> Optional[StoreKV]:
    return StoreKV(_store) if _store is not None else None


def _channel_error_key() -> str:
    # attempt-scoped: a restarted attempt never reads the marker that ended the last
    return f"sheeprl_chan/err/a{os.environ.get('SHEEPRL_GANG_ATTEMPT', '0')}"


def publish_channel_error(reason: str, *, rank: Optional[int] = None, kv: Any = None) -> bool:
    """Write the failure marker that ends every peer's channel wait (a
    ``put`` writes only on the channel's source, so a failed receiver has no
    other way to reach the peers waiting on it). Returns whether it was
    written; never raises, so the failure itself surfaces either way. ``kv``
    injects the plane (a :class:`StoreKV` or a test's in-memory one)."""
    try:
        kv = kv if kv is not None else _default_kv()
        if kv is None:
            return False
        who = rank if rank is not None else process_index()
        kv.set(_channel_error_key(), f"rank {who}: {reason}"[:512])
        return True
    except Exception:
        return False


def poll_channel_error(kv: Any = None) -> Optional[str]:
    """A peer's failure marker, or None (also outside a multi-process run)."""
    try:
        kv = kv if kv is not None else _default_kv()
        if kv is None:
            return None
        return kv.get(_channel_error_key())
    except Exception:
        return None


def channels_made(src: int, store: Any = None) -> int:
    """How many channels with source ``src`` this process made on ``store``
    (its own by default)."""
    store = store if store is not None else _store
    return BroadcastChannel._nonces.get(id(store), (None, {}))[1].get(int(src), 0)


def _is_timeout(exc: BaseException) -> bool:
    """Whether a store error is a ``wait`` whose slice ran out."""
    from torch.distributed import DistStoreError

    return isinstance(exc, DistStoreError) and "timeout" in str(exc).lower()


class BroadcastChannel:
    """One role's messages to the others over the store, with a queue's
    ``put``/``get``: ``put`` writes on the source (``src``) and only advances
    the sequence elsewhere; ``get`` blocks, bounded, on a receiver. ``store``
    and ``rank`` default to this process's (tests pass their own)."""

    TIMEOUT_S = 1800.0
    POLL_S = 30.0
    PUT_RETRIES = 3
    # channels made per (store, src): a second channel with the same source in
    # one run reads and writes its own keys; every process makes its channels
    # at the same points of the protocol, so the counts agree
    _nonces: Dict[int, Tuple[Any, Dict[int, int]]] = {}

    def __init__(self, src: int, *, timeout_s: Optional[float] = None, poll_s: Optional[float] = None,
                 abort_check: Any = None, store: Any = None, rank: Optional[int] = None):
        self.src = int(src)
        self.timeout_s = float(timeout_s if timeout_s is not None else self.TIMEOUT_S)
        self.poll_s = float(poll_s if poll_s is not None else self.POLL_S)
        self.abort_check = abort_check
        self.store = store if store is not None else _store
        if self.store is None:
            raise ChannelError("BroadcastChannel needs a store: initialize() a multi-process run first")
        self.rank = int(rank if rank is not None else process_index())
        self.kv = StoreKV(self.store)
        _, counts = BroadcastChannel._nonces.setdefault(id(self.store), (self.store, {}))
        self.nonce = counts.get(self.src, 0)
        counts[self.src] = self.nonce + 1
        self._seq = 0
        self._chunks: Dict[int, int] = {}

    def _tag(self, seq: int) -> str:
        return f"sheeprl_chan/i{self.nonce}/src{self.src}/{seq}"

    def put(self, msg: Any) -> None:
        try:
            if self.rank == self.src:
                payload = pickle.dumps(msg, protocol=pickle.HIGHEST_PROTOCOL)
                if self._seq > 1:
                    old = self._tag(self._seq - 2)
                    for key in [f"{old}/c{i}" for i in range(self._chunks.pop(self._seq - 2))] + [f"{old}/n"]:
                        self._retry(lambda key=key: self.store.delete_key(key))
                tag = self._tag(self._seq)
                n = max(1, -(-len(payload) // CHUNK_BYTES))
                view = memoryview(payload)
                for i in range(n):
                    chunk = bytes(view[i * CHUNK_BYTES:(i + 1) * CHUNK_BYTES])
                    self._retry(lambda i=i, chunk=chunk: self.store.set(f"{tag}/c{i}", chunk))
                self._retry(lambda: self.store.set(f"{tag}/n", str(n)))
                self._chunks[self._seq] = n
            self._seq += 1
        except BaseException as exc:
            raise ChannelError(f"channel put (src={self.src}) failed") from exc

    def get(self) -> Any:
        try:
            if self.rank == self.src:
                raise RuntimeError("the channel's source must put, not get")
            tag = self._tag(self._seq)
            n = int(self._bounded_get(f"{tag}/n"))
            payload = b"".join(self.store.get(f"{tag}/c{i}") for i in range(n))
            self._seq += 1
            return pickle.loads(payload)
        except BaseException as exc:
            if isinstance(exc, (ChannelTimeout, ChannelPeerError)):
                raise
            from sheeprl_tpu_torch.resilience.distributed import RankFailureError

            if isinstance(exc, RankFailureError):
                raise
            raise ChannelError(f"channel get (src={self.src}) failed") from exc

    def _bounded_get(self, key: str) -> bytes:
        """Wait for ``key`` in ``poll_s`` slices up to ``timeout_s``; between
        slices, the abort check and the peers' failure marker."""
        deadline = time.monotonic() + self.timeout_s
        while True:
            if self.abort_check is not None:
                self.abort_check()
            peer_error = poll_channel_error(self.kv)
            if peer_error is not None:
                raise ChannelPeerError(f"channel get (src={self.src}) aborted: a peer rank failed: {peer_error}")
            remaining = deadline - time.monotonic()
            if remaining <= 0:
                raise ChannelTimeout(
                    f"channel get (src={self.src}) timed out after {self.timeout_s:g}s waiting for {key!r}: "
                    "the source rank is slow, hung or dead"
                )
            try:
                self.store.wait([key], datetime.timedelta(seconds=max(min(self.poll_s, remaining), 0.05)))
            except Exception as exc:
                if not _is_timeout(exc):
                    raise
                continue  # the slice ran out: check again and keep waiting
            return self.store.get(key)

    def _retry(self, op) -> None:
        delay = 0.1
        for attempt in range(self.PUT_RETRIES):
            try:
                op()
                return
            except Exception:
                if attempt == self.PUT_RETRIES - 1:
                    raise
                time.sleep(delay)
                delay *= 2


"""The run's log directory and its metric logger (port of
``sheeprl_tpu/utils/logger.py``: ``get_log_dir``, ``TensorBoardLogger``,
``get_logger``).

A run writes into ``<hydra.run.dir>/version_N`` (``hydra.run.dir`` defaults to
``logs/runs/<root_dir>/<run_name>``), N one more than the highest version
already there. With ``metric.log_level`` > 0 its scalars go to a TensorBoard
event file in that directory.

The event file is written here, with no package: the machine with the card
has neither ``tensorboard`` nor ``tensorboardX``. It is TensorBoard's format,
records framed as TFRecords (the payload's length as a little-endian uint64,
the length's masked CRC32C, the payload, the payload's masked CRC32C), each
payload a protobuf ``Event``: a ``file_version`` record first, then one
``Event{wall_time, step, summary{value{tag, simple_value}}}`` per scalar.
TensorBoard's ``EventAccumulator`` reads it back. ``MLFlowLogger`` is not
ported.
"""

from __future__ import annotations

import os
import socket
import struct
import time
from pathlib import Path
from typing import Any, Dict, Optional


def run_base_dir(cfg) -> Path:
    hydra_dir = ((cfg.get("hydra") or {}).get("run") or {}).get("dir")
    return Path(hydra_dir) if hydra_dir else Path("logs") / "runs" / cfg.root_dir / cfg.run_name


def get_log_dir(cfg) -> str:
    base = run_base_dir(cfg)
    versions = []
    if base.is_dir():
        for d in base.iterdir():
            if d.name.startswith("version_") and d.name[len("version_") :].isdigit():
                versions.append(int(d.name[len("version_") :]))
    log_dir = str(base / f"version_{max(versions) + 1 if versions else 0}")
    os.makedirs(log_dir, exist_ok=True)
    return log_dir


# -- the event file -------------------------------------------------------------------
def _crc32c_table() -> tuple:
    table = []
    for n in range(256):
        c = n
        for _ in range(8):
            c = (c >> 1) ^ 0x82F63B78 if c & 1 else c >> 1
        table.append(c)
    return tuple(table)


_CRC32C = _crc32c_table()


def crc32c(data: bytes) -> int:
    """CRC-32C (Castagnoli), the checksum TFRecord framing uses."""
    crc = 0xFFFFFFFF
    for b in data:
        crc = _CRC32C[(crc ^ b) & 0xFF] ^ (crc >> 8)
    return crc ^ 0xFFFFFFFF


def masked_crc32c(data: bytes) -> int:
    crc = crc32c(data)
    return (((crc >> 15) | (crc << 17)) + 0xA282EAD8) & 0xFFFFFFFF


def tfrecord(payload: bytes) -> bytes:
    length = struct.pack("<Q", len(payload))
    return length + struct.pack("<I", masked_crc32c(length)) + payload + struct.pack("<I", masked_crc32c(payload))


def _varint(n: int) -> bytes:
    out = bytearray()
    while True:
        byte = n & 0x7F
        n >>= 7
        if n:
            out.append(byte | 0x80)
        else:
            out.append(byte)
            return bytes(out)


def _length_delimited(field: int, payload: bytes) -> bytes:
    return _varint(field << 3 | 2) + _varint(len(payload)) + payload


def scalar_event(tag: str, value: float, step: int, wall_time: float) -> bytes:
    """``Event{wall_time=1, step=2, summary=5{value=1{tag=1, simple_value=2}}}``."""
    summary_value = _length_delimited(1, tag.encode()) + _varint(2 << 3 | 5) + struct.pack("<f", value)
    summary = _length_delimited(1, summary_value)
    return (
        _varint(1 << 3 | 1) + struct.pack("<d", wall_time)
        + _varint(2 << 3 | 0) + _varint(int(step))
        + _length_delimited(5, summary)
    )


def version_event(wall_time: float) -> bytes:
    """``Event{wall_time=1, file_version=3: "brain.Event:2"}``, an event file's first record."""
    return _varint(1 << 3 | 1) + struct.pack("<d", wall_time) + _length_delimited(3, b"brain.Event:2")


class EventFileWriter:
    """Appends scalar events to ``events.out.tfevents.<time>.<host>.<pid>`` in ``log_dir``."""

    def __init__(self, log_dir: str) -> None:
        os.makedirs(log_dir, exist_ok=True)
        now = time.time()
        self.path = os.path.join(log_dir, f"events.out.tfevents.{int(now):010d}.{socket.gethostname()}.{os.getpid()}")
        self._file = open(self.path, "ab")
        self._file.write(tfrecord(version_event(now)))
        self._file.flush()

    def add_scalar(self, tag: str, value: float, step: int) -> None:
        self._file.write(tfrecord(scalar_event(tag, float(value), step, time.time())))

    def flush(self) -> None:
        self._file.flush()

    def close(self) -> None:
        if not self._file.closed:
            self._file.close()


class TensorBoardLogger:
    """Scalars into ``<root_dir>/<name>/<version>`` (the JAX package's layout)."""

    def __init__(self, root_dir: str = "logs/runs", name: str = "run", version: Optional[str] = None, **_: Any) -> None:
        self.root_dir = root_dir
        self.name = name
        self._version = version
        self._writer: Optional[EventFileWriter] = None

    @property
    def version(self) -> str:
        if self._version is None:
            base = Path(self.root_dir) / self.name
            existing = []
            if base.is_dir():
                for d in base.iterdir():
                    if d.name.startswith("version_") and d.name[len("version_") :].isdigit():
                        existing.append(int(d.name[len("version_") :]))
            self._version = f"version_{max(existing) + 1 if existing else 0}"
        return self._version

    @property
    def log_dir(self) -> str:
        return str(Path(self.root_dir) / self.name / self.version)

    @property
    def writer(self) -> EventFileWriter:
        if self._writer is None:
            self._writer = EventFileWriter(self.log_dir)
        return self._writer

    def log_metrics(self, metrics: Dict[str, float], step: Optional[int] = None) -> None:
        for k, v in metrics.items():
            try:
                value = float(v)
            except (TypeError, ValueError):
                continue
            self.writer.add_scalar(k, value, 0 if step is None else step)
        if self._writer is not None:
            self._writer.flush()

    def finalize(self) -> None:
        if self._writer is not None:
            self._writer.close()
            self._writer = None


def get_logger(cfg, log_dir: Optional[str] = None) -> Optional[TensorBoardLogger]:
    """The run's logger, or None when ``metric.log_level`` is 0. Given the run's
    ``log_dir``, the logger writes inside it."""
    if int(cfg.metric.log_level) == 0:
        return None
    from sheeprl_tpu_torch.config import instantiate

    logger_cfg = dict(cfg.metric.logger)
    if "TensorBoardLogger" not in str(logger_cfg.get("_target_", "")):
        raise NotImplementedError(
            f"metric.logger {logger_cfg.get('_target_')!r} is not yet ported to sheeprl_tpu_torch "
            "(only sheeprl_tpu_torch.utils.logger.TensorBoardLogger is)"
        )
    if log_dir is not None:
        p = Path(log_dir)
        logger_cfg["root_dir"] = str(p.parent.parent)
        logger_cfg["name"] = p.parent.name
        logger_cfg["version"] = p.name
    return instantiate(logger_cfg)

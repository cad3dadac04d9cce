"""Telemetry stream discovery + merge: one ordered event stream per run.

Copy of ``sheeprl_tpu/obs/streams.py`` kept by the port (which imports
nothing of the JAX package); its events keep the JAX package's names and
``SCHEMA_VERSION``, so either package's offline verbs read the other's streams.

A run can scatter its telemetry over several JSONL files: decoupled MPMD
topologies (sac_decoupled / ppo_decoupled / dv3_decoupled) write one file per
role process (the player's ``telemetry.jsonl`` plus ``telemetry.<role>.jsonl``
for the learner slice), and the supervisor pins all restart *attempts* of a run
onto one shared run-base file while each attempt may also leave per-version
artifacts. The diagnosis engine (``obs/diagnose.py``) wants ONE ordered stream.

Merging key: every modern event carries ``(rank, attempt, seq)`` (see
``obs/jsonl.py``); within one file that triple is append-ordered, so a k-way
merge that pops the earliest head by wall-clock ``time`` — with
``(attempt, seq)`` as the tiebreak — yields a globally time-ordered stream that
never reorders any single writer's events. All writers of one run share the
host clock (the topologies here are single-host; multi-host pods write per-host
run dirs), so wall-clock alignment is exact up to NTP skew; per-stream order is
preserved regardless, which is the invariant the detectors rely on.

Old streams written before the identity fields existed still merge: missing
``rank``/``attempt`` default to 0 and ``seq`` to the line index.

Besides the offline merge, this module provides the *follow mode* ``watch``
builds on (``tail -F`` semantics): :class:`StreamCursor` incrementally reads one
growing file — a torn final line (a write in flight, or a crashed writer's
unfinished tail) is held back and retried on the next poll, never dropped — and
:class:`RunFollower` re-discovers streams every poll (the learner's per-role
file appears seconds after the player's; supervisor attempts append to the same
run-base file) and yields each poll's new events in merge order.
"""

from __future__ import annotations

import heapq
import json
import os
from typing import Any, Dict, List, Optional, Sequence

from sheeprl_tpu_torch.obs.jsonl import parse_stream_line, read_events

__all__ = [
    "RunFollower",
    "StreamCursor",
    "discover_streams",
    "fleet_members",
    "is_primary_event",
    "load_stream",
    "member_of",
    "merge_streams",
    "merged_events",
]


def is_primary_event(event: Dict[str, Any]) -> bool:
    """Whether an (annotated) event belongs to the run's PRIMARY stream: the
    rank-0 ``telemetry.jsonl`` — the player's/controller's own file, also the
    run-base path the supervisor pins across attempts. Per-role learner streams
    are ``telemetry.<role>.jsonl`` siblings with their own cadence and summary;
    both ``watch``'s exit protocol and ``compare``'s window distributions key on
    this predicate, which is why it lives here and not in either consumer."""
    stream = str(event.get("stream") or "telemetry.jsonl")
    return int(event.get("rank") or 0) == 0 and os.path.basename(stream) == "telemetry.jsonl"


def fleet_members(run_dir: str) -> Optional[Dict[str, str]]:
    """When ``run_dir`` is a FLEET directory (``sheeprl.py fleet`` writes a
    ``fleet.json`` marker), the member-name → member-run-dir mapping; None for
    an ordinary run dir. Flat stream discovery would merge every member's
    rank-0 ``telemetry.jsonl`` into one confused "run" (N start events, N
    summaries); consumers that want per-run semantics (``diagnose``, ``watch``)
    use this to treat the fleet as one unit of N member runs instead."""
    if not os.path.isdir(str(run_dir)):
        return None
    marker_path = os.path.join(str(run_dir), "fleet.json")  # the fleet runner's marker
    if not os.path.isfile(marker_path):
        return None
    try:
        with open(marker_path) as fh:
            marker = json.load(fh)
    except (OSError, ValueError):
        return None
    if not isinstance(marker, dict):
        return None
    members = marker.get("members") or {}
    return {
        str(name): os.path.join(str(run_dir), str(rel)) for name, rel in sorted(members.items())
    }


def member_of(stream_label: str) -> Optional[str]:
    """The fleet member a (relative) stream label belongs to — labels of member
    streams start with ``members/<name>/`` under a fleet dir — or None for the
    fleet's own stream (``telemetry.fleet.jsonl``) / a non-fleet label."""
    parts = str(stream_label).replace(os.sep, "/").split("/")
    if len(parts) >= 3 and parts[0] == "members":
        return parts[1]
    return None


def discover_streams(run_dir: str) -> List[str]:
    """Every ``telemetry*.jsonl`` under ``run_dir`` (recursively — per-version
    subdirs and per-role siblings included), sorted for determinism. Accepts a
    direct file path too, so ``diagnose`` can be pointed at a single stream."""
    if os.path.isfile(run_dir):
        return [run_dir]
    found: List[str] = []
    for root, _dirs, files in os.walk(run_dir):
        for name in files:
            if name.startswith("telemetry") and name.endswith(".jsonl"):
                found.append(os.path.join(root, name))
    return sorted(found)


def load_stream(path: str, base_dir: Optional[str] = None) -> List[Dict[str, Any]]:
    """Parse one JSONL stream, annotating each event with its source ``stream``
    (path relative to ``base_dir`` when given) and defaulting the identity
    fields of pre-identity events (rank/attempt 0, seq = line index) so old
    recordings merge alongside new ones."""
    stream = os.path.relpath(path, base_dir) if base_dir else path
    events = read_events(path)
    for idx, event in enumerate(events):
        event["stream"] = stream
        event.setdefault("rank", 0)
        event.setdefault("attempt", 0)
        event.setdefault("seq", idx)
    return events


def merge_streams(
    streams: Sequence[Sequence[Dict[str, Any]]],
) -> List[Dict[str, Any]]:
    """K-way merge of per-file event lists into one stream ordered by wall-clock
    ``time`` (tiebreak: attempt, then seq, then stream index), preserving each
    input stream's own order even across clock anomalies."""
    heads: List[tuple] = []
    for sidx, events in enumerate(streams):
        if events:
            heads.append((_key(events[0], sidx), sidx, 0))
    heapq.heapify(heads)
    merged: List[Dict[str, Any]] = []
    while heads:
        _, sidx, pos = heapq.heappop(heads)
        merged.append(streams[sidx][pos])
        nxt = pos + 1
        if nxt < len(streams[sidx]):
            heapq.heappush(heads, (_key(streams[sidx][nxt], sidx), sidx, nxt))
    return merged


def _key(event: Dict[str, Any], stream_idx: int) -> tuple:
    return (
        float(event.get("time") or 0.0),
        int(event.get("attempt") or 0),
        int(event.get("seq") or 0),
        stream_idx,
    )


def merged_events(run_dir: str) -> List[Dict[str, Any]]:
    """Discover + load + merge every telemetry stream of ``run_dir`` into one
    ordered list (empty when the run left no stream)."""
    base = run_dir if os.path.isdir(run_dir) else os.path.dirname(run_dir)
    paths = discover_streams(run_dir)
    return merge_streams([load_stream(p, base_dir=base) for p in paths])


# ---------------------------------------------------------------------------------
# follow mode (tail -F semantics for live runs)
# ---------------------------------------------------------------------------------
class StreamCursor:
    """Incremental reader over one growing JSONL stream.

    Each :meth:`poll` reads the bytes appended since the last poll and returns
    the newly completed events, annotated like :func:`load_stream` (``stream``
    label, identity defaults). Two invariants make this safe against a live
    writer:

    - only newline-terminated lines are consumed; a torn final line (the sink's
      write may be in flight) stays in the pending buffer and is RETRIED on the
      next poll — it is never dropped and never an error;
    - a completed line that still fails to parse (a crashed writer's torn
      fragment with a later attempt's event appended behind it) goes through
      :func:`~sheeprl_tpu_torch.obs.jsonl.parse_stream_line` recovery, so the
      follow-on event survives.

    A not-yet-existing file is a valid cursor target (polls return nothing until
    it appears) — the learner's per-role stream is created seconds after the
    player's.
    """

    def __init__(self, path: str, stream: Optional[str] = None) -> None:
        self.path = str(path)
        self.stream = stream if stream is not None else self.path
        self._offset = 0
        self._pending = b""
        self._events_read = 0  # seq default for pre-identity events, as in load_stream

    def poll(self) -> List[Dict[str, Any]]:
        try:
            with open(self.path, "rb") as fh:
                fh.seek(self._offset)
                data = fh.read()
        except OSError:
            return []
        if not data:
            return []
        self._offset += len(data)
        buf = self._pending + data
        *complete, self._pending = buf.split(b"\n")
        events: List[Dict[str, Any]] = []
        for raw in complete:
            for event in parse_stream_line(raw.decode("utf-8", errors="replace")):
                event["stream"] = self.stream
                event.setdefault("rank", 0)
                event.setdefault("attempt", 0)
                event.setdefault("seq", self._events_read)
                self._events_read += 1
                events.append(event)
        return events


class RunFollower:
    """Follow every telemetry stream of a (possibly still-materializing) run dir.

    Each :meth:`poll` re-discovers ``telemetry*.jsonl`` files (streams appear
    over a run's lifetime: versioned subdirs, late per-role files), drains every
    cursor, and returns the batch ordered by the same key the offline merge
    uses — so per-stream order is preserved and cross-stream order is wall-clock
    within the batch. The run dir itself may not exist yet (``watch`` is
    typically started alongside the launch)."""

    def __init__(self, run_dir: str) -> None:
        self.run_dir = str(run_dir)
        self._cursors: Dict[str, StreamCursor] = {}

    @property
    def streams(self) -> List[str]:
        """Relative labels of every stream discovered so far."""
        return sorted(c.stream for c in self._cursors.values())

    def poll(self) -> List[Dict[str, Any]]:
        if os.path.exists(self.run_dir):
            base = self.run_dir if os.path.isdir(self.run_dir) else os.path.dirname(self.run_dir)
            for path in discover_streams(self.run_dir):
                if path not in self._cursors:
                    label = os.path.relpath(path, base) if base else path
                    self._cursors[path] = StreamCursor(path, stream=label)
        # the batch goes through the same k-way merge as the offline path, so a
        # stream whose clock jumped backwards is still never reordered against
        # itself (batch sort by time alone would break that invariant)
        per_stream = [self._cursors[path].poll() for path in sorted(self._cursors)]
        return merge_streams([events for events in per_stream if events])

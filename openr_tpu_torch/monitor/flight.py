"""Per-node flight recorder: a bounded ring of recent structured events
(the port's copy of `openr_tpu/monitor/flight.py`).

OpenrNode attaches one to its `Counters` (`counters.flight`), so a module
records with `counters.flight_record(kind, **attrs)` through the object
it already holds. The ring is a post-mortem artifact, not a metric:
`dump()` returns it as JSON-able dicts, oldest first. The record sites of
the JAX package's KvStore and Fib are not part of the port yet: the
port's ring holds what its callers record.
"""

from __future__ import annotations

import collections
import itertools
import time
from dataclasses import dataclass, field
from typing import Any

#: default ring capacity
DEFAULT_CAPACITY = 512


@dataclass
class FlightEvent:
    """One recorded event: wall-clock and monotonic stamps, a dotted kind
    and JSON-able attributes."""

    ts: float  # epoch seconds (alignable across nodes)
    mono_ns: int  # monotonic, exact within the node
    seq: int  # per-recorder sequence
    kind: str
    attrs: dict[str, Any] = field(default_factory=dict)

    def to_jsonable(self) -> dict:
        return {
            "ts": self.ts,
            "mono_ns": self.mono_ns,
            "seq": self.seq,
            "kind": self.kind,
            "attrs": self.attrs,
        }


class FlightRecorder:
    """Bounded ring of `FlightEvent`s (the oldest evicted first)."""

    def __init__(self, node: str = "", capacity: int = DEFAULT_CAPACITY):
        self.node = node
        self.capacity = capacity
        self._ring: collections.deque[FlightEvent] = collections.deque(
            maxlen=capacity
        )
        self._seq = itertools.count()
        self.recorded = 0  # lifetime count (the ring's length saturates)

    def record(self, kind: str, **attrs: Any) -> None:
        """Append one event."""
        self.recorded += 1
        self._ring.append(
            FlightEvent(
                ts=time.time(),
                mono_ns=time.monotonic_ns(),
                seq=next(self._seq),
                kind=kind,
                attrs=attrs,
            )
        )

    def dump(self, limit: int | None = None) -> list[dict]:
        """JSON-able snapshot, oldest first; `limit` keeps the newest N
        (0: none)."""
        events = list(self._ring)
        if limit is not None and limit >= 0:
            events = events[-limit:] if limit else []
        return [e.to_jsonable() for e in events]

    def clear(self) -> None:
        self._ring.clear()

    def __len__(self) -> int:
        return len(self._ring)

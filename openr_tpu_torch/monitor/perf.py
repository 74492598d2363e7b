"""PerfEvents: per-update convergence tracing (the port's copy of the
marker list of `openr_tpu/monitor/perf.py`; the cross-node flood spans
are not part of the port: `span_bin`, the packed span a JAX node may
stamp, is carried as opaque bytes and never unpacked or stamped).

An ordered list of (stage marker, monotonic ns, node) rides each queue
payload: a Publication into Decision, the RouteUpdate out of it. The
stage markers, in pipeline order:

  NEIGHBOR_EVENT      Spark emitted a neighbor up/down/restart event
  ADJ_DB_UPDATED      LinkMonitor folded it into the adjacency set
  KVSTORE_FLOODED     KvStore accepted and published the update
  DECISION_RECEIVED   Decision buffered the publication
  DECISION_DEBOUNCED  the debounce window fired; the rebuild started
  REBUILD_FULL        the rebuild solved from scratch
  REBUILD_PREFIX_ONLY the rebuild re-assembled touched prefixes only
  REBUILD_TOPO_DELTA  the rebuild warm-started from the cached solve
  SPF_SOLVE_DONE      solve, assembly and diff finished
  ROUTE_UPDATE_SENT   the route delta was pushed toward Fib
  FIB_PROGRAMMED      Fib programmed the delta

Timestamps are `time.monotonic_ns()`: exact for deltas within one
process.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field

NEIGHBOR_EVENT = "NEIGHBOR_EVENT"
ADJ_DB_UPDATED = "ADJ_DB_UPDATED"
KVSTORE_FLOODED = "KVSTORE_FLOODED"
DECISION_RECEIVED = "DECISION_RECEIVED"
DECISION_DEBOUNCED = "DECISION_DEBOUNCED"
REBUILD_FULL = "REBUILD_FULL"
REBUILD_PREFIX_ONLY = "REBUILD_PREFIX_ONLY"
REBUILD_TOPO_DELTA = "REBUILD_TOPO_DELTA"
SPF_SOLVE_DONE = "SPF_SOLVE_DONE"
ROUTE_UPDATE_SENT = "ROUTE_UPDATE_SENT"
FIB_PROGRAMMED = "FIB_PROGRAMMED"

# the stage order; the three REBUILD_* markers are alternatives at one
# position (exactly one is stamped a rebuild)
ALL_MARKERS = (
    NEIGHBOR_EVENT,
    ADJ_DB_UPDATED,
    KVSTORE_FLOODED,
    DECISION_RECEIVED,
    DECISION_DEBOUNCED,
    REBUILD_FULL,
    REBUILD_PREFIX_ONLY,
    REBUILD_TOPO_DELTA,
    SPF_SOLVE_DONE,
    ROUTE_UPDATE_SENT,
    FIB_PROGRAMMED,
)

# a full trace evicts a middle marker rather than drop a new stamp
MAX_EVENTS_PER_TRACE = 64
# a merge of coalesced traces is trimmed to this many markers
_MERGE_CAP = MAX_EVENTS_PER_TRACE - 8


@dataclass
class PerfEvent:
    """One stage marker; `ts_ns` is monotonic nanoseconds."""

    event: str
    ts_ns: int = 0
    node: str = ""


def _cap_events(ev: list[PerfEvent], cap: int) -> list[PerfEvent]:
    """Trim a marker list to about `cap`, keeping the origin, the newest
    stamps and at least one stamp per node (so a multi-hop trace keeps
    every hop; the result may exceed `cap` by the nodes outside the kept
    tail)."""
    if len(ev) <= cap:
        return list(ev)
    keep: set[int] = {0, len(ev) - 1}
    seen: set[str] = set()
    for i, e in enumerate(ev):  # each node's earliest marker
        if e.node not in seen:
            seen.add(e.node)
            keep.add(i)
    i = len(ev) - 1
    while len(keep) < cap and i >= 0:
        keep.add(i)
        i -= 1
    return [ev[i] for i in sorted(keep)]


@dataclass
class PerfEvents:
    """Ordered marker list carried on queue payloads; `deltas()` is the
    per-stage breakdown. `span_bin` is the JAX package's appended wire
    field for its packed flood span: the binary codec encodes fields by
    position, so the port carries it to keep the two packages' bytes
    equal."""

    events: list[PerfEvent] = field(default_factory=list)
    span_bin: bytes | None = None

    @classmethod
    def start(cls, event: str, node: str = "") -> "PerfEvents":
        pe = cls()
        pe.add_perf_event(event, node=node)
        return pe

    def add_perf_event(
        self, event: str, node: str = "", ts_ns: int | None = None
    ) -> None:
        """Stamp one stage marker."""
        if len(self.events) >= MAX_EVENTS_PER_TRACE:
            self._evict_one()
        self.events.append(
            PerfEvent(
                event=event,
                ts_ns=time.monotonic_ns() if ts_ns is None else ts_ns,
                node=node,
            )
        )

    def _evict_one(self) -> None:
        """Evict one middle marker: never the origin, never the newest,
        and never a node's last remaining stamp; the second-oldest when
        every node is down to one."""
        counts: dict[str, int] = {}
        for e in self.events:
            counts[e.node] = counts.get(e.node, 0) + 1
        for i in range(1, len(self.events) - 1):
            if counts[self.events[i].node] > 1:
                self.events.pop(i)
                return
        self.events.pop(1)

    def copy(self) -> "PerfEvents":
        """Independent snapshot: each consumer that stamps on its own
        schedule takes its own copy (the span bytes are immutable)."""
        return PerfEvents(events=list(self.events), span_bin=self.span_bin)

    def merge(self, other: "PerfEvents") -> "PerfEvents":
        """Two traces combined (coalesced floods): the union of markers
        in timestamp order, trimmed by `_cap_events`; self's span bytes,
        else other's."""
        ev = sorted([*self.events, *other.events], key=lambda e: e.ts_ns)
        if len(ev) > _MERGE_CAP:
            ev = _cap_events(ev, _MERGE_CAP)
        return PerfEvents(events=ev, span_bin=self.span_bin or other.span_bin)

    def deltas(self) -> list[tuple[str, float]]:
        """Per-stage (event, ms since the previous marker); the first
        stage is 0."""
        out: list[tuple[str, float]] = []
        prev: int | None = None
        for e in self.events:
            out.append(
                (e.event, 0.0 if prev is None else (e.ts_ns - prev) / 1e6)
            )
            prev = e.ts_ns
        return out

    def total_ms(self) -> float:
        if len(self.events) < 2:
            return 0.0
        return (self.events[-1].ts_ns - self.events[0].ts_ns) / 1e6

    def last_event(self) -> str:
        return self.events[-1].event if self.events else ""

    def names(self) -> list[str]:
        """The marker names in stamp order."""
        return [e.event for e in self.events]

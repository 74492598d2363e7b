"""Monitor: the drain of the event-log samples and of completed
convergence traces (the port's copy of `openr_tpu/monitor/monitor.py`).

Modules push structured `LogSample`s (neighbour up / down, overload
changes) onto the log-sample queue, and Fib pushes each `PerfEvents`
trace it completed at `FIB_PROGRAMMED` onto the perf-events queue;
Monitor keeps the newest of each in a bounded ring. Every completed
trace of one node also feeds the windowed `monitor.convergence_ms`
stat. The cross-node flood spans (`recent_flood_traces`) come with the
port's `monitor/flood_trace.py`.
"""

from __future__ import annotations

import collections
import logging
import time
from dataclasses import dataclass, field
from typing import Any

from openr_tpu_torch.common.eventbase import OpenrModule
from openr_tpu_torch.messaging import QueueClosedError, RQueue

log = logging.getLogger(__name__)


@dataclass
class LogSample:
    """One structured event record."""

    event: str  # e.g. "NEIGHBOR_UP", "NODE_OVERLOAD_SET"
    attrs: dict[str, Any] = field(default_factory=dict)
    ts: float = 0.0  # epoch seconds; stamped by Monitor if 0


class Monitor(OpenrModule):
    """Drains the log-sample queue into a ring of recent events, and the
    perf-events queue into a ring of recent traces."""

    MAX_EVENTS = 1000
    MAX_PERF_TRACES = 256

    def __init__(
        self,
        config,
        log_sample_reader: RQueue,
        perf_events_reader: RQueue | None = None,
        counters=None,
    ):
        super().__init__(f"{config.node_name}.monitor", counters=counters)
        self.node_name = config.node_name
        self.reader = log_sample_reader
        self.perf_reader = perf_events_reader
        self.events: collections.deque[LogSample] = collections.deque(
            maxlen=self.MAX_EVENTS
        )
        self.perf_traces: collections.deque = collections.deque(
            maxlen=self.MAX_PERF_TRACES
        )

    async def main(self) -> None:
        self.spawn(self._drain(), name=f"{self.name}.drain")
        if self.perf_reader is not None:
            self.spawn(self._drain_perf(), name=f"{self.name}.perf")

    async def _drain(self) -> None:
        while True:
            try:
                sample = await self.reader.get()
            except QueueClosedError:
                return
            if sample.ts == 0.0:
                sample.ts = time.time()
            sample.attrs.setdefault("node_name", self.node_name)
            self.events.append(sample)
            if self.counters:
                self.counters.increment("monitor.log_samples")
            log.debug("event %s %s", sample.event, sample.attrs)

    async def _drain_perf(self) -> None:
        """Keep each completed trace; a trace stamped on one node feeds
        `monitor.convergence_ms` (markers of different hosts carry
        unrelated monotonic clocks, so a multi-origin trace is counted
        apart)."""
        while True:
            try:
                trace = await self.perf_reader.get()
            except QueueClosedError:
                return
            self.perf_traces.append(trace)
            if self.counters:
                self.counters.increment("monitor.perf_traces")
                origins = {e.node for e in trace.events if e.node}
                if len(origins) <= 1:
                    self.counters.add_value(
                        "monitor.convergence_ms", trace.total_ms()
                    )
                else:
                    self.counters.increment(
                        "monitor.perf_traces_multi_origin"
                    )

    def recent(self, limit: int = 100, event: str | None = None) -> list[LogSample]:
        out = [
            s for s in self.events if event is None or s.event == event
        ]
        return out[-limit:]

    def recent_perf(self, limit: int = 20) -> list:
        """The newest completed convergence traces, oldest first."""
        return list(self.perf_traces)[-limit:]

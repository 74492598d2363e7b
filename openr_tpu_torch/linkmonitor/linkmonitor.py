"""LinkMonitor: interfaces to Spark; neighbours to adjacencies to
KvStore (the port's copy of `openr_tpu/linkmonitor/linkmonitor.py`).

    lm = LinkMonitor(config, spark, kv_client,
                     neighbor_events.get_reader(), peer_events)
    await lm.start()

* Interface events pass the include / exclude regexes; a flapping
  interface waits out an exponential hold-down before Spark runs
  discovery on it again (`spark.add_interface` / `remove_interface`, the
  only calls made on `spark`).
* Neighbour events keep the adjacency book, give each adjacency a label
  from `SR_LOCAL_RANGE`, and push `PeerEvent`s so that KvStore opens or
  closes its peer session.
* `advertise_adjacencies`, debounced, persists `adj:<node>` into every
  area through the KvStoreClient; the neighbour events' convergence
  traces, stamped `ADJ_DB_UPDATED`, merge into the one trace that rides
  that write.
* The operator's levers: node overload, link overload (a soft drain) and
  a per-link metric override.
"""

from __future__ import annotations

import asyncio
import logging
import re

from openr_tpu_torch.common.backoff import ExponentialBackoff
from openr_tpu_torch.common.constants import SR_LOCAL_RANGE, adj_key
from openr_tpu_torch.common.eventbase import OpenrModule
from openr_tpu_torch.common.throttle import AsyncDebounce
from openr_tpu_torch.config import Config
from openr_tpu_torch.kvstore.client import KvStoreClient
from openr_tpu_torch.kvstore.kvstore import PeerEvent, PeerSpec
from openr_tpu_torch.messaging import QueueClosedError, ReplicateQueue, RQueue
from openr_tpu_torch.monitor import perf
from openr_tpu_torch.monitor.monitor import LogSample
from openr_tpu_torch.types.events import (
    InterfaceInfo,
    NeighborEvent,
    NeighborEventType,
    NeighborInfo,
)
from openr_tpu_torch.types.serde import to_wire
from openr_tpu_torch.types.topology import Adjacency, AdjacencyDatabase

log = logging.getLogger(__name__)


class LinkMonitor(OpenrModule):
    def __init__(
        self,
        config: Config,
        spark,  # anything with add_interface / remove_interface
        kv_client: KvStoreClient,
        neighbor_events_reader: RQueue,
        peer_events_queue: ReplicateQueue,
        interface_events_reader: RQueue | None = None,
        log_samples_queue: ReplicateQueue | None = None,
        counters=None,
    ):
        super().__init__(f"{config.node_name}.linkmonitor", counters=counters)
        self.config = config
        self.node_name = config.node_name
        self.spark = spark
        self.kv_client = kv_client
        self.nbr_reader = neighbor_events_reader
        self.peer_queue = peer_events_queue
        self.if_reader = interface_events_reader
        self.log_queue = log_samples_queue

        self.interfaces: dict[str, InterfaceInfo] = {}
        self._if_backoff: dict[str, ExponentialBackoff] = {}
        # (area, neighbour, local_if) -> (NeighborInfo, adj_label)
        self.adjacencies: dict[tuple[str, str, str], tuple[NeighborInfo, int]] = {}
        self.node_overloaded = False
        self._metric_override: dict[str, int] = {}  # if_name -> metric
        self._link_overload: set[str] = set()  # drained links
        self._next_adj_label = SR_LOCAL_RANGE[0]
        # the trace of the neighbour events folded into the next
        # advertisement (merged across the debounce window)
        self._pending_perf: perf.PerfEvents | None = None
        self._advertise_debounce = AsyncDebounce(
            min_ms=10,
            max_ms=self.config.node.link_monitor.linkflap_initial_backoff_ms
            + 1000,
            fn=self.advertise_adjacencies,
            owner=self.name,
            counters=counters,
        )

    # ----------------------------------------------------------------- main

    async def main(self) -> None:
        self.spawn(self._neighbor_loop(), name=f"{self.name}.nbr")
        if self.if_reader is not None:
            self.spawn(self._interface_loop(), name=f"{self.name}.if")

    async def cleanup(self) -> None:
        self._advertise_debounce.cancel()

    # ----------------------------------------------------------- interfaces

    def _if_allowed(self, name: str) -> bool:
        lm = self.config.node.link_monitor
        if lm.include_interface_regexes:
            if not any(
                re.fullmatch(p, name) for p in lm.include_interface_regexes
            ):
                return False
        if any(re.fullmatch(p, name) for p in lm.exclude_interface_regexes):
            return False
        return True

    async def _interface_loop(self) -> None:
        while True:
            try:
                ev = await self.if_reader.get()
            except QueueClosedError:
                return
            for info in ev.interfaces:
                self.update_interface(info)

    def update_interface(self, info: InterfaceInfo) -> None:
        """One interface state change, with flap damping: a down→up
        counts against the interface's backoff, and an up inside the
        hold-down reaches Spark only when it ends."""
        if not self._if_allowed(info.name):
            return
        lm = self.config.node.link_monitor
        prev = self.interfaces.get(info.name)
        self.interfaces[info.name] = info
        backoff = self._if_backoff.setdefault(
            info.name,
            ExponentialBackoff(
                lm.linkflap_initial_backoff_ms, lm.linkflap_max_backoff_ms
            ),
        )
        if info.is_up:
            if prev is not None and not prev.is_up:
                backoff.report_error()
            wait = backoff.time_remaining_s()
            if wait > 0:
                if self.counters is not None:
                    self.counters.increment("linkmonitor.flap_damped")
                self.spawn(self._delayed_if_up(info.name, wait))
            else:
                self.spark.add_interface(info.name)
        else:
            self.spark.remove_interface(info.name)

    async def _delayed_if_up(self, if_name: str, wait: float) -> None:
        await asyncio.sleep(wait)
        info = self.interfaces.get(if_name)
        if info is not None and info.is_up and not self.stopped:
            self.spark.add_interface(if_name)

    # ------------------------------------------------------------ neighbors

    async def _neighbor_loop(self) -> None:
        while True:
            try:
                ev: NeighborEvent = await self.nbr_reader.get()
            except QueueClosedError:
                return
            self._process_neighbor_event(ev)

    def _process_neighbor_event(self, ev: NeighborEvent) -> None:
        info = ev.info
        key = (info.area, info.node_name, info.local_if)
        if ev.type in (
            NeighborEventType.NEIGHBOR_UP,
            NeighborEventType.NEIGHBOR_RESTARTED,
        ):
            label = (
                self.adjacencies[key][1]
                if key in self.adjacencies
                else self._alloc_adj_label()
            )
            self.adjacencies[key] = (info, label)
            self.peer_queue.push(
                PeerEvent(
                    area=info.area,
                    peers_to_add=[
                        PeerSpec(
                            node_name=info.node_name,
                            endpoint=self._peer_endpoint(info),
                            area=info.area,
                        )
                    ],
                )
            )
            if self.counters is not None:
                self.counters.increment("linkmonitor.neighbor_up")
            self._log_event(
                "NEIGHBOR_RESTARTED"
                if ev.type == NeighborEventType.NEIGHBOR_RESTARTED
                else "NEIGHBOR_UP",
                neighbor=info.node_name,
                interface=info.local_if, area=info.area,
            )
        elif ev.type == NeighborEventType.NEIGHBOR_DOWN:
            self.adjacencies.pop(key, None)
            # drop the KvStore peer only when no adjacency to that node
            # is left on any interface (parallel links)
            if not any(
                k[0] == info.area and k[1] == info.node_name
                for k in self.adjacencies
            ):
                self.peer_queue.push(
                    PeerEvent(
                        area=info.area, peers_to_del=[info.node_name]
                    )
                )
            if self.counters is not None:
                self.counters.increment("linkmonitor.neighbor_down")
            self._log_event("NEIGHBOR_DOWN", neighbor=info.node_name,
                            interface=info.local_if, area=info.area)
        elif ev.type == NeighborEventType.NEIGHBOR_RESTARTING:
            # graceful restart: hold the adjacency, advertise nothing
            return
        elif ev.type == NeighborEventType.NEIGHBOR_RTT_CHANGE:
            if key in self.adjacencies:
                label = self.adjacencies[key][1]
                self.adjacencies[key] = (info, label)
            if not self.config.node.link_monitor.use_rtt_metric:
                return
        # only events that reach the advertisement carry their trace on
        if ev.perf_events is not None:
            ev.perf_events.add_perf_event(
                perf.ADJ_DB_UPDATED, node=self.node_name
            )
            self._pending_perf = (
                ev.perf_events
                if self._pending_perf is None
                else self._pending_perf.merge(ev.perf_events)
            )
        self._advertise_debounce.poke()

    def _peer_endpoint(self, info: NeighborInfo):
        """In-process transports key peers by name (None); TCP ones take
        (host, port)."""
        if info.kvstore_port:
            return (info.endpoint_host or "127.0.0.1", info.kvstore_port)
        return None

    def _alloc_adj_label(self) -> int:
        label = self._next_adj_label
        self._next_adj_label += 1
        if self._next_adj_label > SR_LOCAL_RANGE[1]:
            self._next_adj_label = SR_LOCAL_RANGE[0]
        return label

    # ---------------------------------------------------------- advertising

    def _metric_for(self, info: NeighborInfo) -> int:
        if info.local_if in self._metric_override:
            return self._metric_override[info.local_if]
        if self.config.node.link_monitor.use_rtt_metric and info.rtt_us:
            return max(1, info.rtt_us // 100)
        return 1  # a hop

    def build_adjacency_db(self, area: str) -> AdjacencyDatabase:
        adjs = []
        sr = self.config.node.segment_routing
        for (a, node, local_if), (info, label) in sorted(
            self.adjacencies.items()
        ):
            if a != area:
                continue
            adjs.append(
                Adjacency(
                    other_node_name=node,
                    if_name=local_if,
                    other_if_name=info.remote_if,
                    metric=self._metric_for(info),
                    adj_label=label if sr.enable else 0,
                    rtt_us=info.rtt_us,
                    is_overloaded=local_if in self._link_overload,
                )
            )
        return AdjacencyDatabase(
            this_node_name=self.node_name,
            adjacencies=tuple(adjs),
            is_overloaded=self.node_overloaded,
            node_label=self._node_label(),
            area=area,
        )

    def _node_label(self) -> int:
        sr = self.config.node.segment_routing
        if not sr.enable:
            return 0
        if sr.node_segment_label:
            return sr.node_segment_label
        # picked from the global range by the name (Python's hash, as
        # the JAX package does: stable within one process only)
        lo, hi = sr.sr_global_range
        return lo + (hash(self.node_name) % (hi - lo))

    def advertise_adjacencies(self) -> None:
        """Persist `adj:<node>` into every area's KvStore, with a finite
        TTL (a node that dies without a goodbye fades out by it; the
        client refreshes live keys)."""
        pe, self._pending_perf = self._pending_perf, None
        for area in self.config.area_ids():
            db = self.build_adjacency_db(area)
            self.kv_client.persist_key(
                area,
                adj_key(self.node_name),
                to_wire(db),
                ttl_ms=self.config.node.kvstore.key_ttl_ms,
                # each area's publication is stamped by its own pipeline
                perf_events=pe.copy() if pe is not None else None,
            )
        if self.counters is not None:
            self.counters.increment("linkmonitor.adj_advertised")

    # ------------------------------------------------------------- operator

    def dump_interfaces(self) -> list[dict]:
        """The interfaces with their adjacencies, as an operator sees
        them."""
        out = []
        for name, info in sorted(self.interfaces.items()):
            adjs = [
                {"neighbor": node, "area": a, "remote_if": nb.remote_if,
                 "metric": self._metric_for(nb), "rtt_us": nb.rtt_us}
                for (a, node, local_if), (nb, _label) in sorted(
                    self.adjacencies.items()
                )
                if local_if == name
            ]
            out.append({
                "name": name,
                "is_up": info.is_up,
                "metric_override": self._metric_override.get(name),
                "is_overloaded": name in self._link_overload,
                "adjacencies": adjs,
            })
        return out

    def set_node_overload(self, overloaded: bool) -> None:
        if self.node_overloaded != overloaded:
            self.node_overloaded = overloaded
            self._log_event(
                "NODE_OVERLOAD_SET" if overloaded else "NODE_OVERLOAD_UNSET"
            )
            self._advertise_debounce.poke()

    def _log_event(self, event: str, **attrs) -> None:
        if self.log_queue is not None:
            self.log_queue.push(LogSample(event=event, attrs=attrs))

    def set_link_metric(self, if_name: str, metric: int | None) -> None:
        """Override one link's metric (None: back to the computed one)."""
        if metric is None:
            self._metric_override.pop(if_name, None)
        else:
            self._metric_override[if_name] = metric
        self._advertise_debounce.poke()

    def set_link_overload(self, if_name: str, overloaded: bool) -> None:
        """Drain one link: its adjacency is advertised overloaded, so
        every solver excludes both directions from transit while the
        adjacency stays up. An unknown interface raises (a mistyped
        drain must not pass as done)."""
        if if_name not in self.interfaces:
            raise ValueError(
                f"unknown interface {if_name!r} "
                f"(have: {sorted(self.interfaces) or 'none'})"
            )
        changed = (if_name in self._link_overload) != overloaded
        if overloaded:
            self._link_overload.add(if_name)
        else:
            self._link_overload.discard(if_name)
        if changed:
            self._log_event(
                "LINK_OVERLOAD_SET" if overloaded else "LINK_OVERLOAD_UNSET",
                if_name=if_name,
            )
            self._advertise_debounce.poke()

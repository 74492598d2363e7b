"""CtrlServer (the port's copy of `openr_tpu/ctrl/server.py`): the
OpenrCtrlHandler equivalent, an RPC service over one `OpenrNode`'s
module graph.

Every module shares the node's asyncio loop, so queries call module
methods directly; the two subscriptions (`subscribe_kvstore`,
`subscribe_fib`) are fanned out from one queue reader per stream to any
number of RPC stream writers. `check_fib_oracle` holds the programmed
FIB to the port's host oracle, solved in a worker thread.

Two handlers need modules the port does not have yet, and answer with an
RPC error naming the module: `get_flood_traces` (`monitor/flood_trace.py`)
and `get_wire_schema` (`types/wirelock.py`'s `extract_schema`). The
port's node has no persistence, so `get_persist_status` and
`persist_control` give the reference's answers for such a node.
"""

from __future__ import annotations

import asyncio
import logging

from openr_tpu_torch.common.eventbase import OpenrModule
from openr_tpu_torch.kvstore.kvstore import pub_to_json_value, value_from_json
from openr_tpu_torch.messaging import QueueClosedError, RQueue
from openr_tpu_torch.rpc import RpcServer
from openr_tpu_torch.types.kvstore import KeyDumpParams, Publication
from openr_tpu_torch.types.network import IpPrefix
from openr_tpu_torch.types.serde import from_jsonable, to_jsonable
from openr_tpu_torch.types.topology import PrefixEntry

log = logging.getLogger(__name__)


class CtrlServer(OpenrModule):
    """RPC service over one OpenrNode's module graph."""

    def __init__(self, node, host: str = "127.0.0.1", port: int = 0):
        super().__init__(f"{node.name}.ctrl", counters=node.counters)
        self.node = node
        self.host = host
        self._requested_port = port
        self.port: int | None = None
        # counters: the ctrl plane shares the node's rpc.bytes_tx/rx
        # byte accounting and answers the binary-codec negotiation
        self.server = RpcServer(name=self.name, counters=node.counters)
        # readers must exist before any module starts pushing
        self._kv_reader = node.kvstore_pubs.get_reader(f"{self.name}.kvsub")
        self._fib_reader = node.fib_updates.get_reader(f"{self.name}.fibsub")
        self._kv_subs: set[RQueue] = set()
        self._fib_subs: set[RQueue] = set()
        self._register_all()

    # ------------------------------------------------------------ lifecycle

    async def main(self) -> None:
        from openr_tpu_torch.rpc.tls import server_ssl_context

        tls = getattr(self.node.config.node, "tls", None)
        ssl_ctx = server_ssl_context(tls) if tls is not None else None
        self.port = await self.server.start(
            self.host, self._requested_port, ssl=ssl_ctx
        )
        self.spawn(self._fanout(self._kv_reader, self._kv_subs, self._encode_pub),
                   name=f"{self.name}.kvfan")
        self.spawn(self._fanout(self._fib_reader, self._fib_subs, self._encode_fib),
                   name=f"{self.name}.fibfan")

    async def cleanup(self) -> None:
        await self.server.stop()

    # ------------------------------------------------------------ fan-out

    async def _fanout(self, reader, subs: set[RQueue], encode) -> None:
        """Drain one module queue, replicate to every live subscriber
        (reference: OpenrCtrlHandler's kvStorePublishers_ / fibPublishers_
        lists fed from the subscriber fibers). Subscriber queues are
        messaging-seam RQueues; the bound is enforced here at put time
        (SUB_QUEUE_MAX is a live instance knob) by evicting the OLDEST
        buffered item, so the fan-out never blocks and the subscriber
        keeps its stream minus the stalest update (reference:
        OpenrCtrlHandler sheds on backed-up publisher streams)."""
        while True:
            try:
                item = await reader.get()
            except QueueClosedError:
                for q in subs:
                    if q.qsize() >= self.SUB_QUEUE_MAX:
                        # a retained-but-stalled subscriber may sit at
                        # exactly the bound: shed one item so the
                        # end-of-stream sentinel always lands
                        q.try_get()
                    q.put_nowait(None)
                return
            if not subs:  # nobody listening — skip the encode work
                continue
            payload = encode(item)
            if payload is None:
                continue
            for q in list(subs):
                if q.qsize() >= self.SUB_QUEUE_MAX:
                    q.try_get()
                    if self.counters:
                        self.counters.increment("ctrl.sub_evictions")
                q.put_nowait(payload)

    @staticmethod
    def _encode_pub(pub) -> dict | None:
        if not isinstance(pub, Publication):
            return None
        return {
            "area": pub.area,
            "key_vals": {k: pub_to_json_value(v) for k, v in pub.key_vals.items()},
            "expired_keys": list(pub.expired_keys),
        }

    @staticmethod
    def _encode_fib(upd) -> dict | None:
        return {
            "type": int(upd.type),
            "unicast_to_update": [
                _unicast_json(e.to_unicast_route())
                for e in upd.unicast_to_update.values()
            ],
            "unicast_to_delete": [str(p) for p in upd.unicast_to_delete],
            "mpls_to_update": [
                _mpls_json(e.to_mpls_route())
                for e in upd.mpls_to_update.values()
            ],
            "mpls_to_delete": list(upd.mpls_to_delete),
        }

    # ------------------------------------------------------------ handlers

    def _register_all(self) -> None:
        s = self.server
        for name in (
            "get_my_node_name", "get_initialization_status", "get_counters",
            "get_kvstore_keyvals", "set_kvstore_keyvals", "dump_kvstore",
            "get_kvstore_areas", "get_kvstore_peers",
            "get_kvstore_flood_topo", "validate",
            "get_route_db_computed", "get_route_db_programmed",
            "get_decision_adjacency_dbs", "get_received_routes",
            "get_spf_path",
            "get_interfaces", "set_node_overload", "set_interface_metric",
            "set_interface_overload", "get_spark_neighbors",
            "fib_add_unicast", "fib_del_unicast", "get_fib_client_routes",
            "fib_validate",
            "advertise_prefixes", "withdraw_prefixes", "get_advertised_prefixes",
            "set_rib_policy", "get_rib_policy", "get_event_logs",
            "get_perf_events", "get_counters_prometheus",
            "get_flood_traces", "get_flight_recorder",
            "get_device_telemetry", "get_work_ledger",
            "get_kvstore_digest", "get_convergence_state",
            "check_fib_oracle", "chaos_set_drop", "set_udp_peer",
            "work_ledger_control", "spark_announce_restart",
            "get_persist_status", "persist_control", "get_wire_schema",
        ):
            s.register(name, getattr(self, name))
        s.register_stream("subscribe_kvstore", self.subscribe_kvstore)
        s.register_stream("subscribe_fib", self.subscribe_fib)

    # --- node / process -----------------------------------------------------

    async def get_my_node_name(self, params: dict) -> str:
        return self.node.name

    async def get_initialization_status(self, params: dict) -> dict:
        """reference: OpenrCtrl initialization-event query — the
        KVSTORE_SYNCED → RIB_COMPUTED → FIB_SYNCED gates."""
        n = self.node
        return {
            "KVSTORE_SYNCED": n.kvstore.initial_sync_done.is_set(),
            "RIB_COMPUTED": n.decision.rib_computed.is_set(),
            "FIB_SYNCED": n.fib.synced.is_set(),
            "INITIALIZED": n.initialized,
        }

    async def get_event_logs(self, params: dict) -> list:
        """reference: Monitor event-log dump (`breeze monitor logs`)."""
        limit = params.get("limit")
        samples = self.node.monitor.recent(
            limit=int(limit) if limit is not None else 100,
            event=params.get("event"),
        )
        return [
            {"event": s.event, "ts": s.ts, "attrs": s.attrs} for s in samples
        ]

    async def get_counters(self, params: dict) -> dict:
        """reference: fb303 getCounters."""
        prefix = params.get("prefix") or ""
        snap = self.node.counters.snapshot()
        return {k: v for k, v in snap.items() if k.startswith(prefix)}

    async def get_perf_events(self, params: dict) -> dict:
        """Recent completed convergence traces with per-stage deltas
        (reference: getPerfDb / breeze perf)."""
        limit = int(params.get("limit") or 20)
        return {
            "node": self.node.name,
            "traces": [
                pe.to_jsonable()
                for pe in self.node.monitor.recent_perf(limit)
            ],
        }

    async def get_flood_traces(self, params: dict) -> dict:
        """Completed sampled flood spans with their waterfalls: needs the
        hop spans and `monitor/flood_trace.py`, which the port does not
        have yet. The RPC answers with an error naming it."""
        raise NotImplementedError(
            "get_flood_traces needs monitor/flood_trace.py (and the "
            "KvStore's hop spans), which is not part of the port yet"
        )

    async def get_flight_recorder(self, params: dict) -> dict:
        """This node's flight-recorder ring (monitor/flight.py), newest
        `limit` events — the on-demand counterpart of the automatic
        invariant-failure dump."""
        fr = getattr(self.node, "flight", None)
        if fr is None:
            return {"node": self.node.name, "events": [], "recorded": 0}
        limit = params.get("limit")
        return {
            "node": self.node.name,
            "recorded": fr.recorded,
            "capacity": fr.capacity,
            "events": fr.dump(
                limit=int(limit) if limit is not None else None
            ),
        }

    async def get_device_telemetry(self, params: dict) -> dict:
        """Device telemetry plane:
        the process-wide kernel cost ledger joined server-side with
        this node's measured span stats into achieved-throughput rows,
        plus per-device HBM gauges (None-degraded on CPU backends) and
        the last sharded solve's per-device shard layout."""
        from openr_tpu_torch.monitor import device as device_telemetry

        rows = device_telemetry.kernel_rows()
        snap = self.node.counters.snapshot()
        dec = getattr(self.node, "decision", None)
        solver = getattr(dec, "solver", None) if dec is not None else None
        return {
            "node": self.node.name,
            "kernels": device_telemetry.efficiency_rows(rows, snap),
            "devices": device_telemetry.sample_hbm() or [],
            "hbm_available": bool(device_telemetry.telemetry().hbm_available),
            "shards": (
                list(solver.last_shard_rows) if solver is not None else []
            ),
        }

    async def get_work_ledger(self, params: dict) -> dict:
        """Steady-state work ledger:
        the process-wide per-stage touched/delta/ratio accounting,
        joined server-side into per-stage rows (cumulative + since-warm
        when a warm boundary was marked) plus the top offending stage —
        same join shape as get_device_telemetry."""
        from openr_tpu_torch.monitor import work_ledger

        led = work_ledger.ledger()
        return {
            "node": self.node.name,
            "warm_marked": led.warm_marked,
            "stages": led.rows(),
            "top_offender": led.top_offender(),
        }

    async def get_counters_prometheus(self, params: dict) -> dict:
        """Prometheus text exposition (format 0.0.4) of this node's
        counters + windowed latency stats. The `text` field is what an
        HTTP /metrics endpoint would serve verbatim."""
        from openr_tpu_torch.monitor import render_prometheus

        return {
            "content_type": "text/plain; version=0.0.4",
            "text": render_prometheus(self.node.counters, self.node.name),
        }

    # --- kvstore ------------------------------------------------------------

    def _area(self, params: dict) -> str:
        return params.get("area") or self.node.config.area_ids()[0]

    async def get_kvstore_keyvals(self, params: dict) -> dict:
        area = self._area(params)
        out = {}
        for k in params.get("keys") or []:
            v = self.node.kvstore.get_key(area, k)
            if v is not None:
                out[k] = pub_to_json_value(v)
        return {"key_vals": out}

    async def set_kvstore_keyvals(self, params: dict) -> dict:
        area = self._area(params)
        accepted: dict[str, bool] = {}
        for k, raw in (params.get("key_vals") or {}).items():
            accepted[k] = self.node.kvstore.set_key(
                area, k, value_from_json(raw).with_hash()
            )
        # a merge-rejected write (stale version) must not read as
        # success: the caller reports it
        return {"ok": all(accepted.values()), "accepted": accepted}

    async def dump_kvstore(self, params: dict) -> dict:
        area = self._area(params)
        dump_params = KeyDumpParams(
            prefix=params.get("prefix") or "",
            originator_ids=tuple(params.get("originator_ids") or ()),
        )
        kv = self.node.kvstore.dump(area, dump_params)
        return {"key_vals": {k: pub_to_json_value(v) for k, v in kv.items()}}

    async def get_kvstore_areas(self, params: dict) -> dict:
        """reference: getKvStoreAreaSummary — per-area key/peer counts."""
        out = {}
        for area in self.node.config.areas:
            kv = self.node.kvstore.dump(area.area_id)
            peers = self.node.kvstore.get_peers(area.area_id)
            out[area.area_id] = {
                "num_keys": len(kv),
                "peers": sorted(peers),
            }
        return out

    async def get_kvstore_peers(self, params: dict) -> dict:
        area = self._area(params)
        return {"peers": sorted(self.node.kvstore.get_peers(area))}

    async def get_kvstore_flood_topo(self, params: dict) -> dict:
        """DUAL flood-optimization SPT (reference: getSptInfos)."""
        return self.node.kvstore.get_flood_topo(self._area(params))

    async def validate(self, params: dict) -> dict:
        """End-to-end node health cross-checks (reference: the `openr
        validate` checker): initialization gates, Spark↔LSDB
        adjacency consistency, own keys present in KvStore, computed vs
        programmed route convergence, watchdog state."""
        from openr_tpu_torch.common import constants as C
        from openr_tpu_torch.spark.spark import SparkNeighborState

        n = self.node
        checks: list[dict] = []

        def check(name: str, ok: bool, detail: str = "") -> None:
            checks.append({"name": name, "pass": bool(ok), "detail": detail})

        st = await self.get_initialization_status({})
        for gate in ("KVSTORE_SYNCED", "RIB_COMPUTED", "FIB_SYNCED"):
            check(f"init.{gate}", bool(st.get(gate)))

        # Spark ESTABLISHED neighbors all appear in our advertised adj db
        established = {
            nname
            for (_ifn, nname), nb in n.spark.neighbors.items()
            if nb.state == SparkNeighborState.ESTABLISHED
        }
        advertised = set()
        for area in n.config.area_ids():
            v = n.kvstore.get_key(area, C.adj_key(n.name))
            if v is not None and v.value is not None:
                from openr_tpu_torch.types.serde import from_wire
                from openr_tpu_torch.types.topology import AdjacencyDatabase

                db = from_wire(v.value, AdjacencyDatabase)
                advertised |= {a.other_node_name for a in db.adjacencies}
        missing = established - advertised
        check(
            "spark.neighbors_advertised",
            not missing,
            f"established-but-unadvertised: {sorted(missing)}" if missing else
            f"{len(established)} neighbors",
        )

        # Decision's LSDB contains our own adjacency db (flood loopback)
        in_lsdb = any(
            n.decision.link_states[a].adjacency_db(n.name) is not None
            for a in n.decision.link_states
        )
        check("decision.own_adj_in_lsdb", in_lsdb or not established)

        # computed RIB vs programmed FIB convergence — VALUE-level diff
        # from Fib itself (a nexthop change stuck in the retry loop
        # leaves the same prefixes programmed with stale contents)
        fibstate = n.fib.pending_changes()
        check(
            "fib.converged",
            fibstate["converged"],
            f"rib={len(n.decision.rib.unicast_routes)} "
            f"desired={fibstate['desired_unicast']}u/"
            f"{fibstate['desired_mpls']}m "
            + (
                f"stale={fibstate['stale']} "
                f"stale_mpls={fibstate['stale_mpls']} "
                f"pending={fibstate['pending']}"
                if not fibstate["converged"] else "programmed-ok"
            ),
        )

        # watchdog has not fired
        wd = getattr(n, "watchdog", None)
        check("watchdog.healthy", wd is None or not wd.fired)

        return {
            "pass": all(c["pass"] for c in checks),
            "checks": checks,
        }

    async def subscribe_kvstore(self, params: dict, stream) -> None:
        """reference: subscribeAndGetKvStoreFiltered (thrift server-stream):
        snapshot-then-deltas, with optional key-prefix filter."""
        area = self._area(params)
        prefix = params.get("prefix") or ""
        # register BEFORE the snapshot: a publication arriving while the
        # snapshot is in flight must land in the delta stream (overlap is
        # harmless, a lost update is not)
        q = self._add_sub(self._kv_subs)
        try:
            if params.get("snapshot", True):
                kv = self.node.kvstore.dump(area, KeyDumpParams(prefix=prefix))
                await stream.send({
                    "area": area,
                    "key_vals": {k: pub_to_json_value(v) for k, v in kv.items()},
                    "expired_keys": [],
                    "snapshot": True,
                })
            await self._drain_sub(q, stream,
                                  lambda p: _filter_pub(p, area, prefix))
        finally:
            self._remove_sub(self._kv_subs, q)

    # --- decision / fib -----------------------------------------------------

    async def get_route_db_computed(self, params: dict) -> dict:
        """reference: getRouteDbComputed — the Decision RIB."""
        db = self.node.decision.get_route_db()
        return {
            "node": self.node.name,
            "unicast_routes": [
                {
                    **_unicast_json(e.to_unicast_route()),
                    "igp_cost": e.igp_cost,
                    "best_nodes": list(e.best_nodes),
                    "backup_nexthops": [
                        to_jsonable(nh) for nh in e.backup_nexthops
                    ],
                }
                for e in db.unicast_routes.values()
            ],
            "mpls_routes": [
                _mpls_json(e.to_mpls_route())
                for e in db.mpls_routes.values()
            ],
        }

    async def get_route_db_programmed(self, params: dict) -> dict:
        """reference: getRouteDb (programmed, from Fib)."""
        fib = self.node.fib
        return {
            "node": self.node.name,
            "unicast_routes": [
                _unicast_json(r) for r in fib.get_programmed_unicast()
            ],
            "mpls_routes": [
                _mpls_json(r) for r in fib.get_programmed_mpls()
            ],
        }

    async def get_decision_adjacency_dbs(self, params: dict) -> dict:
        """reference: getDecisionAdjacenciesFiltered — the LSDB view."""
        out = {}
        for area, dbs in self.node.decision.get_adj_dbs().items():
            out[area] = [to_jsonable(db) for db in dbs]
        return out

    async def get_received_routes(self, params: dict) -> dict:
        """reference: getReceivedRoutesFiltered — prefix DB view."""
        return to_jsonable(self.node.decision.get_received_routes())

    async def get_spf_path(self, params: dict) -> dict:
        """reference: breeze `decision path` — shortest path between
        two nodes from Decision's LSDB (src defaults to this node)."""
        src = params.get("src") or self.node.name
        dst = params["dst"]
        return self.node.decision.get_spf_path(
            src, dst, params.get("area")
        )

    async def subscribe_fib(self, params: dict, stream) -> None:
        """reference: subscribeAndGetFib — programmed-route stream."""
        q = self._add_sub(self._fib_subs)
        try:
            await self._drain_sub(q, stream, lambda p: p)
        finally:
            self._remove_sub(self._fib_subs, q)

    # --- link monitor -------------------------------------------------------

    async def get_interfaces(self, params: dict) -> dict:
        """reference: getInterfaces / dumpLinks."""
        lm = self.node.linkmonitor
        return {
            "node": self.node.name,
            "is_overloaded": lm.node_overloaded,
            "interfaces": lm.dump_interfaces(),
        }

    async def set_node_overload(self, params: dict) -> dict:
        """reference: setNodeOverload / unsetNodeOverload."""
        self.node.linkmonitor.set_node_overload(bool(params.get("overload", True)))
        return {"ok": True}

    async def set_interface_metric(self, params: dict) -> dict:
        """reference: setInterfaceMetric / unsetInterfaceMetric."""
        metric = params.get("metric")
        self.node.linkmonitor.set_link_metric(
            params["interface"], int(metric) if metric is not None else None
        )
        return {"ok": True}

    async def fib_add_unicast(self, params: dict) -> dict:
        """reference: breeze fib add-route — manual route injection
        straight through the FibService under CLIENT_ID_STATIC (openr's
        own sync never touches that table). For platform debugging; the
        route bypasses Decision entirely."""
        from openr_tpu_torch.fib.fib import CLIENT_ID_STATIC
        from openr_tpu_torch.types.network import IpPrefix, NextHop, UnicastRoute

        routes = [
            UnicastRoute(
                dest=IpPrefix.make(r["prefix"]),
                nexthops=tuple(
                    NextHop(
                        address=nh["address"],
                        if_name=nh.get("if_name", ""),
                        metric=int(nh.get("metric", 1)),
                    )
                    for nh in r["nexthops"]
                ),
            )
            for r in params["routes"]
        ]
        await self.node.fib.handler.add_unicast_routes(
            CLIENT_ID_STATIC, routes
        )
        return {"ok": True, "added": len(routes)}

    async def fib_del_unicast(self, params: dict) -> dict:
        """reference: breeze fib del-route."""
        from openr_tpu_torch.fib.fib import CLIENT_ID_STATIC
        from openr_tpu_torch.types.network import IpPrefix

        prefixes = [IpPrefix.make(p) for p in params["prefixes"]]
        await self.node.fib.handler.delete_unicast_routes(
            CLIENT_ID_STATIC, prefixes
        )
        return {"ok": True, "deleted": len(prefixes)}

    async def fib_validate(self, params: dict) -> dict:
        """reference: breeze fib validate — Fib's programmed book vs
        an actual FibService dump, compared on the dataplane projection
        (the fields the kernel really stores)."""
        from openr_tpu_torch.fib.fib import (
            CLIENT_ID_OPENR,
            _dataplane_key_mpls,
            _dataplane_key_unicast,
        )

        fib = self.node.fib
        book_u = {
            _dataplane_key_unicast(r): r
            for r in fib.get_programmed_unicast()
        }
        have_u = {
            _dataplane_key_unicast(r): r
            for r in await fib.handler.get_route_table_by_client(
                CLIENT_ID_OPENR
            )
        }
        book_m = {
            _dataplane_key_mpls(r): r for r in fib.get_programmed_mpls()
        }
        have_m = {
            _dataplane_key_mpls(r): r
            for r in await fib.handler.get_mpls_route_table_by_client(
                CLIENT_ID_OPENR
            )
        }
        missing = [str(book_u[k].dest) for k in book_u.keys() - have_u.keys()]
        extra = [str(have_u[k].dest) for k in have_u.keys() - book_u.keys()]
        missing_m = [book_m[k].top_label for k in book_m.keys() - have_m.keys()]
        extra_m = [have_m[k].top_label for k in have_m.keys() - book_m.keys()]
        return {
            "pass": not (missing or extra or missing_m or extra_m),
            "book_unicast": len(book_u),
            "dataplane_unicast": len(have_u),
            "missing_in_dataplane": sorted(missing),
            "extra_in_dataplane": sorted(extra),
            "book_mpls": len(book_m),
            "dataplane_mpls": len(have_m),
            "missing_mpls": sorted(missing_m),
            "extra_mpls": sorted(extra_m),
        }

    async def get_fib_client_routes(self, params: dict) -> dict:
        """Dump a FibService table by client id (default: the static
        table breeze `fib add` writes; pass client_id 786 for openr's
        own)."""
        from openr_tpu_torch.fib.fib import CLIENT_ID_STATIC

        cid = int(params.get("client_id", CLIENT_ID_STATIC))
        routes = await self.node.fib.handler.get_route_table_by_client(cid)
        return {
            "client_id": cid,
            "unicast_routes": [_unicast_json(r) for r in routes],
        }

    async def get_spark_neighbors(self, params: dict) -> dict:
        """reference: getNeighbors / breeze spark neighbors — the
        discovery FSM's live view, pre-LinkMonitor."""
        import time as _time

        now = _time.monotonic()
        return {
            "neighbors": [
                {
                    "node": nb.node_name,
                    "local_if": nb.local_if,
                    "remote_if": nb.remote_if,
                    "state": nb.state.name,
                    "area": nb.area,
                    "hold_time_ms": nb.hold_time_ms,
                    "rtt_us": nb.rtt_us,
                    "last_heard_ms_ago": int((now - nb.last_heard) * 1e3)
                    if nb.last_heard
                    else None,
                }
                for nb in self.node.spark.neighbors.values()
            ]
        }

    async def set_interface_overload(self, params: dict) -> dict:
        """reference: setInterfaceOverload / unsetInterfaceOverload —
        soft-drain one link for maintenance."""
        self.node.linkmonitor.set_link_overload(
            params["interface"], bool(params.get("overload", True))
        )
        return {"ok": True}

    # --- prefix manager -----------------------------------------------------

    async def advertise_prefixes(self, params: dict) -> dict:
        """reference: advertisePrefixes (PrefixType API source)."""
        from openr_tpu_torch.prefixmgr.prefix_manager import (
            PrefixEvent, PrefixEventType, PrefixSource,
        )
        entries = [
            from_jsonable(raw, PrefixEntry) if isinstance(raw, dict)
            else PrefixEntry(prefix=IpPrefix.make(raw))
            for raw in params.get("prefixes") or []
        ]
        self.node.prefix_events.push(PrefixEvent(
            type=PrefixEventType.ADD_PREFIXES,
            source=PrefixSource.API,
            entries=tuple(entries),
        ))
        return {"advertised": len(entries)}

    async def withdraw_prefixes(self, params: dict) -> dict:
        from openr_tpu_torch.prefixmgr.prefix_manager import (
            PrefixEvent, PrefixEventType, PrefixSource,
        )
        entries = tuple(
            PrefixEntry(prefix=IpPrefix.make(raw))
            for raw in params.get("prefixes") or []
        )
        self.node.prefix_events.push(PrefixEvent(
            type=PrefixEventType.WITHDRAW_PREFIXES,
            source=PrefixSource.API,
            entries=entries,
        ))
        return {"withdrawn": len(entries)}

    async def get_advertised_prefixes(self, params: dict) -> dict:
        """reference: getAdvertisedRoutesFiltered."""
        adv = self.node.prefixmgr.get_advertised()
        return {str(p): to_jsonable(e) for p, e in adv.items()}

    # --- rib policy ---------------------------------------------------------

    async def set_rib_policy(self, params: dict) -> dict:
        """reference: setRibPolicy (policy with TTL, Decision-side)."""
        from openr_tpu_torch.policy import RibPolicy
        policy = from_jsonable(params["policy"], RibPolicy)
        self.node.decision.set_rib_policy(policy)
        return {"ok": True}

    async def get_rib_policy(self, params: dict) -> dict:
        pol = self.node.decision.get_rib_policy()
        return {"policy": to_jsonable(pol) if pol is not None else None}

    # --- multi-process harness (emulator/procs.py observation plane) --------

    async def get_kvstore_digest(self, params: dict) -> dict:
        """Compact per-area (version, originator, hash) digest of every
        key — the cross-process KvStore-consistency invariant compares
        these triples across the fleet instead of shipping full
        dump_kvstore payloads (at 100k prefixes a dump is MBs, the
        digest is the keys only)."""
        out: dict[str, dict] = {}
        for area, db in self.node.kvstore.dbs.items():
            out[area] = {
                k: [v.version, v.originator_id, v.with_hash().hash]
                for k, v in db.kv.items()
            }
        return {"node": self.node.name, "areas": out}

    async def get_convergence_state(self, params: dict) -> dict:
        """One-call convergence + stuck-state snapshot: the init gates,
        Decision's buffered work, Fib's desired-vs-programmed delta and
        retry backoff, and every KvStore peer's sync/session/backlog/
        backoff state. Serves the supervisor's converged() poll, the
        no-stuck-state invariant, and `breeze cluster status` — all of
        which would otherwise need four round trips per node."""
        n = self.node
        dec = n.decision
        pc = n.fib.pending_changes()
        fib_cfg = n.config.node.fib
        peers = []
        for (area, pname), peer in n.kvstore.peers.items():
            peers.append({
                "area": area,
                "peer": pname,
                "synced": bool(peer.synced),
                "session": peer.session is not None,
                "pending_keys": len(peer.pending_keys),
                "pending_expired": len(peer.pending_expired),
                "backoff_ms": round(peer.backoff.current_ms, 1),
                "backoff_error": bool(peer.backoff.has_error),
            })
        # policied messaging-seam watermarks ride along so the bounded-
        # depth invariant (class 5) needs no extra round trip and no
        # config side-channel for the cap
        cap = n.config.node.messaging.queue_maxsize
        queues = []
        if cap > 0:
            for key, q in getattr(n, "queues", {}).items():
                if q.policy is None:
                    continue  # control-event seams are unbounded by design
                for r in q.readers:
                    queues.append({
                        "key": key,
                        "reader": r.name,
                        "highwater": r.highwater,
                        "overflow": r.overflow,
                    })
        return {
            "node": n.name,
            "initialized": bool(n.initialized),
            "decision_pending_kvs": len(dec._pending_kvs),
            "decision_debounce_pending": bool(dec.debounce.pending),
            "queue_cap": cap,
            "queues": queues,
            "fib": {
                "converged": bool(pc["converged"]),
                "pending": pc["pending"],
                "stale": [str(s) for s in list(pc["stale"])[:8]],
                "programmed_unicast": len(n.fib.programmed_unicast),
                "programmed_mpls": len(n.fib.programmed_mpls),
                "backoff_ms": round(n.fib.backoff.current_ms, 1),
                "backoff_error": bool(n.fib.backoff.has_error),
                "backoff_saturated": bool(
                    n.fib.backoff.current_ms >= fib_cfg.max_retry_ms
                ),
            },
            "peers": peers,
        }

    async def check_fib_oracle(self, params: dict) -> dict:
        """FIB/oracle parity, computed where the LSDB lives: snapshot
        this node's LinkState/PrefixState on the loop (copy-on-write,
        consistent), run the from-scratch CPU-oracle solve in a worker
        thread, and diff against the programmed FIB. The cross-process
        invariant checker calls this instead of shipping whole LSDBs
        over ctrl — the verdict is a few ints either way."""
        from openr_tpu_torch.decision.decision import merge_area_ribs
        from openr_tpu_torch.decision.oracle import (
            compute_routes as oracle_compute_routes,
        )

        n = self.node
        dec = n.decision
        if dec.rib_policy is not None:
            # the policy mutates routes after the solve; parity is
            # undefined — same skip as the in-process checker
            return {"node": n.name, "pass": True, "skipped": "rib_policy"}
        dcfg = n.config.node.decision
        link_states = dec.link_states  # property: drains pending pubs
        prefix_states = dec.prefix_states
        snaps = {
            a: (link_states[a].snapshot(), prefix_states[a].snapshot())
            for a in link_states
        }
        name = n.name

        def solve():
            per_area = {
                a: oracle_compute_routes(
                    ls, ps, name,
                    enable_lfa=dcfg.enable_lfa,
                    ksp_k=dcfg.ksp_paths,
                )
                for a, (ls, ps) in snaps.items()
            }
            return merge_area_ribs(per_area, name)

        want = await asyncio.to_thread(solve)
        want_u = {
            p: e.to_unicast_route() for p, e in want.unicast_routes.items()
        }
        want_m = {
            lbl: e.to_mpls_route() for lbl, e in want.mpls_routes.items()
        }
        got_u = n.fib.programmed_unicast
        got_m = n.fib.programmed_mpls
        diff_u = sorted(
            str(p)
            for p in set(got_u) | set(want_u)
            if got_u.get(p) != want_u.get(p)
        )
        diff_m = sorted(
            str(lbl)
            for lbl in set(got_m) | set(want_m)
            if got_m.get(lbl) != want_m.get(lbl)
        )
        return {
            "node": name,
            "pass": not diff_u and not diff_m,
            "unicast_mismatches": len(diff_u),
            "mpls_mismatches": len(diff_m),
            "sample": diff_u[:3] + diff_m[:3],
            "oracle_unicast": len(want_u),
            "programmed_unicast": len(got_u),
        }

    async def chaos_set_drop(self, params: dict) -> dict:
        """Install/remove socket-level drop rules on this node's UDP io
        provider (UdpIoProvider.set_drop) — the multi-process partition
        primitive: dropped interfaces stop sending AND discard received
        datagrams, so Spark's hold timer expires exactly as it would on
        a filtered physical link. ops: add | remove | clear."""
        io = getattr(self.node.spark, "io", None)
        if io is None or not hasattr(io, "set_drop"):
            return {"ok": False, "error": "io provider has no drop seam"}
        op = params.get("op") or "add"
        if op == "clear":
            io.clear_drops()
        elif op in ("add", "remove"):
            for ifn in params.get("if_names") or []:
                io.set_drop(ifn, op == "add")
        else:
            return {"ok": False, "error": f"unknown op {op!r}"}
        return {"ok": True, "dropped": io.drop_rules()}

    async def set_udp_peer(self, params: dict) -> dict:
        """Point one UDP interface at its neighbor's (host, port) —
        the supervisor's post-spawn wiring step. Every process binds
        its interfaces to ephemeral ports (no collisions, no guessing),
        reports them via the readiness handshake, and the supervisor
        closes the loop here; UdpIoProvider.send no-ops until the peer
        is set, so hellos simply start flowing once both ends are
        wired (same call re-wires a neighbor after a restart)."""
        io = getattr(self.node.spark, "io", None)
        if io is None or not hasattr(io, "set_peer"):
            return {"ok": False, "error": "io provider has no peer wiring"}
        io.set_peer(params["if_name"], (params["host"], int(params["port"])))
        return {"ok": True}

    async def work_ledger_control(self, params: dict) -> dict:
        """Drive the per-process work ledger across the fleet: the
        supervisor marks every process warm after the first converged
        round, then reads steady violations during the invariant sweep
        (work-proportionality class #6 — the ledger is per-process
        state the checker can no longer reach directly).
        ops: mark_warm | reset_warm | reset | violations."""
        from openr_tpu_torch.monitor import work_ledger

        op = params.get("op")
        led = work_ledger.ledger()
        if op == "mark_warm":
            led.mark_warm()
        elif op == "reset_warm":
            led.reset_warm()
        elif op == "reset":
            led.reset()
        elif op == "violations":
            exempt = tuple(params.get("exempt") or ())
            return {
                "node": self.node.name,
                "warm_marked": led.warm_marked,
                "violations": led.steady_violations(exempt=exempt),
            }
        else:
            return {"ok": False, "error": f"unknown op {op!r}"}
        return {"ok": True, "warm_marked": led.warm_marked}

    async def get_persist_status(self, params: dict) -> dict:
        """Operational view of the durable-state plane:
        journal size, records since compaction, last-fsync age, per-book
        digests and the recovery stats from this boot — the byte-parity
        token the crash-recovery invariant compares across incarnations
        (`breeze persist status` renders this)."""
        if self.node.persist is None:
            return {"node": self.node.name, "enabled": False}
        return {
            "node": self.node.name,
            "enabled": True,
            **self.node.persist.status(),
        }

    async def persist_control(self, params: dict) -> dict:
        """Drive the persist plane from the harness: arm one-shot disk
        faults (seeded torn/corrupt/enospc/crash_between_rename/
        slow_fsync — the chaos machinery's disk seam on a live process),
        force a compaction, or fsync now. ops: inject | compact | sync."""
        plane = self.node.persist
        if plane is None:
            return {"ok": False, "error": "persistence disabled"}
        op = params.get("op")
        if op == "inject":
            kind = params.get("kind")
            try:
                plane.faults.arm(kind, **(params.get("params") or {}))
            except (ValueError, TypeError) as exc:
                return {"ok": False, "error": str(exc)}
        elif op == "compact":
            return {"ok": plane.compact(force=bool(params.get("force")))}
        elif op == "sync":
            plane.sync()
        else:
            return {"ok": False, "error": f"unknown op {op!r}"}
        return {"ok": True, "faults": plane.faults.status()}

    async def get_wire_schema(self, params: dict) -> dict:
        """The wire schema this node runs, with the live extracted
        schema: needs `types/wirelock.py`'s `extract_schema`, which the
        port does not have yet. The RPC answers with an error naming it."""
        raise NotImplementedError(
            "get_wire_schema needs types/wirelock.py extract_schema, "
            "which is not part of the port yet"
        )

    async def spark_announce_restart(self, params: dict) -> dict:
        """Graceful-restart announcement (the in-process emulator's
        `crash_node(graceful=True)` preamble): neighbors hold the
        adjacency for gr_time_ms while the supervisor SIGTERMs and
        respawns this process."""
        await self.node.spark.announce_restart()
        return {"ok": True}

    # ------------------------------------------------------------ plumbing

    SUB_QUEUE_MAX = 4096  # per-subscriber buffer before eviction

    def _add_sub(self, subs: set[RQueue]) -> RQueue:
        # unbounded messaging-seam queue; _fanout enforces SUB_QUEUE_MAX
        # at put time (eviction, not blocking)
        q: RQueue = RQueue(name=f"{self.name}.sub{len(subs)}")
        subs.add(q)
        if self.counters:
            self.counters.increment(f"{self.name}.subscribers")
        return q

    def _remove_sub(self, subs: set[RQueue], q: RQueue) -> None:
        subs.discard(q)
        if self.counters:
            self.counters.increment(f"{self.name}.subscribers", -1)

    async def _drain_sub(self, q: RQueue, stream, xform) -> None:
        """Forward one subscriber's queue to its RPC stream until the
        stream disconnects or the fan-out ends/evicts it (None)."""
        while True:
            item = await q.get()
            if item is None:
                return
            out = xform(item)
            if out is not None:
                await stream.send(out)  # raises RpcError on disconnect


def _unicast_json(r) -> dict:
    """Operator-facing route encoding: prefixes flattened to strings."""
    return {
        "dest": str(r.dest),
        "nexthops": [to_jsonable(nh) for nh in r.nexthops],
    }


def _mpls_json(r) -> dict:
    return {
        "top_label": r.top_label,
        "nexthops": [to_jsonable(nh) for nh in r.nexthops],
    }


def _filter_pub(payload: dict, area: str, prefix: str) -> dict | None:
    """Apply the subscriber's area + key-prefix filter to an encoded
    publication (reference: KvStoreFilters on the subscribe path)."""
    if payload.get("area") != area:
        return None
    if not prefix:
        return payload
    kv = {k: v for k, v in payload["key_vals"].items() if k.startswith(prefix)}
    exp = [k for k in payload["expired_keys"] if k.startswith(prefix)]
    if not kv and not exp:
        return None
    return {"area": area, "key_vals": kv, "expired_keys": exp}

"""One node's route pipeline on the port, held against the JAX package's
on the CPU: Spark → LinkMonitor → KvStore → Decision → Fib →
PrefixManager.

Each package runs its own `OpenrNode` (`node.py`) on a `MockIoHub`: the
port's Decision with `device="cpu"`, the JAX package's with its host
solver, the KvStore peering over `InProcKvTransport`, Fib programming a
`MockFibHandler`, PrefixManager originating the node's loopback and an
aggregate gated on the routes Fib programmed, and Monitor draining the
log samples and the completed traces. The neighbour events come from
Spark: each of N's neighbours is a Spark speaker of its own on N's hub,
linked over the generator's interfaces.

* Parity: both packages' nodes N (node-0 of a seeded `fat_tree(4)`)
  face a store F holding every other node's keys (registered under the
  name of each of N's neighbours, so N's KvStore peers with it through
  LinkMonitor's PeerEvents). N's interfaces come up one at a time, so
  that LinkMonitor gives the same adjacency labels in both packages. The
  same seeded rounds — fabric flaps set on F, N's own link metrics
  through `LinkMonitor.set_link_metric`, a neighbour's link taken down
  (Spark's hold timer) and up (rediscovery), a link drained — run on
  both. After each round the programmed tables are equal, byte for
  byte, equal to the converted RIB of a fresh solve of the generator's
  LSDB (N's own adjacency database replaced by LinkMonitor's), N's
  adjacency databases are equal but for the RTTs each Spark measured,
  and every completed trace carries the same marker names in the same
  order (`shapes`: a pair merged twice into one advertisement counted
  once).
* The node's traces end at FIB_PROGRAMMED: a neighbour event's starts
  at NEIGHBOR_EVENT, then ADJ_DB_UPDATED; a fabric flap's at F's
  ADJ_DB_UPDATED and KVSTORE_FLOODED, each then through N's
  KVSTORE_FLOODED, the Decision's markers and ROUTE_UPDATE_SENT.
* A failed program pass keeps its traces pending until a pass
  succeeds, and the table converges.
* Cross-area redistribution end to end (the port's counterpart of
  `tests/test_redistribution.py::test_abr_end_to_end`): n1 (area A) —
  abr (A and B) — n2 (area B), three port nodes on one hub, the ABR's
  areas taking their neighbours by name; n1's loopback reaches n2's RIB
  through abr with area stack ("A",) and distance 1, and back.
"""

import asyncio
import dataclasses
import types

import numpy as np
import pytest

import openr_tpu.common.constants as rC
import openr_tpu.config as rcfg
import openr_tpu.decision.decision as rdec
import openr_tpu.fib as rfib
import openr_tpu.fib.fib as rfibm
import openr_tpu.kvstore as rkvs
import openr_tpu.kvstore.kvstore as rkvstore
import openr_tpu.linkmonitor as rlm
import openr_tpu.messaging as rmsg
import openr_tpu.monitor as rmon
import openr_tpu.monitor.perf as rperf
import openr_tpu.node as rnode
import openr_tpu.policy as rpolicy
import openr_tpu.prefixmgr as rpm
import openr_tpu.spark as rspark
import openr_tpu.types.events as rev
import openr_tpu.types.kvstore as rkv
import openr_tpu.types.serde as rs
import openr_tpu.types.topology as rtopo
from openr_tpu.utils import topogen as rtopogen
from openr_tpu_torch import config as pcfg
from openr_tpu_torch import fib as pfib
from openr_tpu_torch import kvstore as pkvs
from openr_tpu_torch import linkmonitor as plm
from openr_tpu_torch import messaging as pmsg
from openr_tpu_torch import monitor as pmon
from openr_tpu_torch import node as pnode
from openr_tpu_torch import policy as ppolicy
from openr_tpu_torch import prefixmgr as ppm
from openr_tpu_torch import spark as pspark
from openr_tpu_torch.common import constants as pC
from openr_tpu_torch.decision import decision as pdec
from openr_tpu_torch.decision.linkstate import LinkState, PrefixState
from openr_tpu_torch.decision.spf_backend import TorchSpfSolver
from openr_tpu_torch.kvstore import kvstore as pkvstore
from openr_tpu_torch.monitor import perf as pperf
from openr_tpu_torch.types import events as pev
from openr_tpu_torch.types import kvstore as pkv
from openr_tpu_torch.types import serde as ps
from openr_tpu_torch.types import topology as ptopo
from openr_tpu_torch.types.network import IpPrefix
from openr_tpu_torch.utils import topogen as ptopogen

SEED = 20260605
FABRIC = "fabric"
ME = "node-0"
AGGREGATE = "10.0.0.0/16"

PKGS = {
    "ref": types.SimpleNamespace(
        C=rC, cfg=rcfg, dec=rdec, fib=rfib, fibm=rfibm, kvs=rkvs,
        kvstore=rkvstore, lm=rlm, msg=rmsg, mon=rmon, perf=rperf, pm=rpm,
        ev=rev, kv=rkv, serde=rs, topo=rtopo, policy=rpolicy, node=rnode,
        spark=rspark),
    "port": types.SimpleNamespace(
        C=pC, cfg=pcfg, dec=pdec, fib=pfib, fibm=pfib.fib, kvs=pkvs,
        kvstore=pkvstore, lm=plm, msg=pmsg, mon=pmon, perf=pperf, pm=ppm,
        ev=pev, kv=pkv, serde=ps, topo=ptopo, policy=ppolicy, node=pnode,
        spark=pspark),
}


SPARK = dict(hello_time_ms=100, fastinit_hello_time_ms=20,
             handshake_time_ms=20, keepalive_time_ms=100, hold_time_ms=1500,
             graceful_restart_time_ms=3000)


def node_config(pkg, name: str, **kw):
    """A node's config in `pkg`: Spark's timers short, the watchdog off
    (not part of the port yet)."""
    C = pkg.cfg
    return C.Config(C.NodeConfig(
        node_name=name, spark=C.SparkConfig(**SPARK),
        watchdog=C.WatchdogConfig(enable=False), **kw))


class Node:
    """One package's `OpenrNode` (device="cpu" on the port, the host
    solver in the JAX package) on a `MockIoHub`, with the helpers the
    checks read; every other attribute is the node's."""

    def __init__(self, pkg, cfg, transport, hub):
        self.pkg = pkg
        solver = {"device": "cpu"} if pkg is PKGS["port"] else {
            "solver": "cpu"}
        self.node = pkg.node.OpenrNode(cfg, hub.io_for(cfg.node_name),
                                       transport, **solver)
        transport.register(self.node.name, self.node.kvstore)
        self.handler = self.node.fib_handler
        self.traces_seen = 0

    def __getattr__(self, name):
        return getattr(self.node, name)

    def interfaces_up(self, names) -> None:
        for n in names:
            self.node.set_interface(n)

    def adjacency(self, nbr: str, local_if: str, area: str = "0") -> bool:
        """LinkMonitor holds the adjacency to `nbr` over `local_if`."""
        return (area, nbr, local_if) in self.node.linkmonitor.adjacencies

    def busy(self) -> bool:
        d, f = self.decision, self.fib
        qs = list(self.node.queues.values())
        return bool(
            any(r.qsize() for qu in qs[:7] for r in qu.readers)
            or self.linkmonitor._advertise_debounce.pending
            or d.debounce.pending or d._pending_kvs
            or f._dirty.is_set() or not f.pending_changes()["converged"])

    def table(self) -> dict:
        client = self.pkg.fibm.CLIENT_ID_OPENR
        S = self.pkg.serde
        return dict(
            unicast={str(p): S.to_wire(r) for p, r in sorted(
                self.handler.unicast.get(client, {}).items())},
            mpls={lb: S.to_wire(r) for lb, r in sorted(
                self.handler.mpls.get(client, {}).items())})

    def new_traces(self) -> list:
        traces = list(self.monitor.perf_traces)
        total = self.counters.get("monitor.perf_traces")
        new = traces[len(traces) - int(total - self.traces_seen):] \
            if total > self.traces_seen else []
        self.traces_seen = total
        return [[(e.event, e.node) for e in t.events] for t in new]


async def until(cond, what: str, timeout: float = 20.0) -> None:
    t0 = asyncio.get_event_loop().time()
    while not cond():
        assert asyncio.get_event_loop().time() - t0 < timeout, what
        await asyncio.sleep(0.01)


async def quiet(nodes, stores, timeout: float = 20.0) -> None:
    """Until no node is busy, every pair of stores holds the same keys,
    and both stay so for 30 ms."""
    t0 = asyncio.get_event_loop().time()
    calm = 0
    while calm < 3:
        same = all(a.dbs[ar].store_hash() == b.dbs[ar].store_hash()
                   for a, b, ar in stores)
        calm = calm + 1 if same and not any(n.busy() for n in nodes) else 0
        assert asyncio.get_event_loop().time() - t0 < timeout, (
            [n.busy() for n in nodes], same)
        await asyncio.sleep(0.01)


class Pipeline:
    """Node N of one package facing the fabric store F, and N's
    neighbours as Spark speakers on N's hub."""

    def __init__(self, pkg, adj, pfx):
        self.pkg = pkg
        C = pkg.cfg
        self.me_db = next(db for db in adj if db.this_node_name == ME)
        cfg = node_config(
            pkg, ME,
            segment_routing=C.SegmentRoutingConfig(
                enable=True, node_segment_label=self.me_db.node_label),
            originated_prefixes=(
                C.OriginatedPrefix(prefix=str(pfx_of(pfx, ME).prefix)),
                C.OriginatedPrefix(prefix=AGGREGATE,
                                   minimum_supporting_routes=8)))
        self.transport = pkg.kvs.InProcKvTransport()
        self.f = pkg.kvs.KvStore(pkg.cfg.Config.default(FABRIC),
                                 self.transport,
                                 pkg.msg.ReplicateQueue(name="f"))
        for a in self.me_db.adjacencies:  # N's neighbours' stores: F
            self.transport.register(a.other_node_name, self.f)
        self.transport.register(FABRIC, self.f)
        self.hub = pkg.spark.MockIoHub()
        self.n = Node(pkg, cfg, self.transport, self.hub)
        # each neighbour a Spark of its own, linked to N over the
        # generator's interfaces
        self.speakers = []
        for a in self.me_db.adjacencies:
            self.hub.link(ME, a.if_name, a.other_node_name, a.other_if_name)
            self.speakers.append((pkg.spark.Spark(
                node_config(pkg, a.other_node_name),
                self.hub.io_for(a.other_node_name),
                pkg.msg.ReplicateQueue(name=f"{a.other_node_name}.nbr")),
                a.other_if_name))
        self.versions = {}
        for db in adj:
            if db.this_node_name != ME:
                self.set_adj(db)
        for db in pfx:
            if db.this_node_name != ME:
                key = pkg.C.prefix_key(db.this_node_name, "0",
                                       db.prefix_entries[0].prefix.prefix)
                self.f.set_key("0", key, pkg.kv.Value(
                    version=1, originator_id=db.this_node_name,
                    value=pkg.serde.to_wire(db)).with_hash())

    def set_adj(self, db, traced=False) -> None:
        node = db.this_node_name
        self.versions[node] = self.versions.get(node, 0) + 1
        pe = (self.pkg.perf.PerfEvents.start(self.pkg.perf.ADJ_DB_UPDATED,
                                             node=FABRIC) if traced else None)
        self.f.set_key("0", self.pkg.C.adj_key(node), self.pkg.kv.Value(
            version=self.versions[node], originator_id=node,
            value=self.pkg.serde.to_wire(db)).with_hash(), perf_events=pe)

    def advertised(self, a) -> bool:
        """F holds N's adjacency database with the link `a`."""
        v = self.f.get_key("0", self.pkg.C.adj_key(ME))
        return v is not None and any(
            x.if_name == a.if_name for x in self.pkg.serde.from_wire(
                v.value, self.pkg.topo.AdjacencyDatabase).adjacencies)

    async def start(self) -> None:
        await self.f.start()
        self.f.add_peer_sync(self.pkg.kvstore.PeerSpec(node_name=ME))
        for sp, ifn in self.speakers:
            await sp.start()
            sp.add_interface(ifn)
        await self.n.start()
        # one interface, and so one neighbour, at a time: LinkMonitor
        # gives the adjacency labels in the order the neighbours come up,
        # the same in both packages
        for a in self.me_db.adjacencies:
            self.n.interfaces_up([a.if_name])
            await until(lambda a=a: self.advertised(a),
                        f"{ME} advertises {a.if_name}")

    async def stop(self) -> None:
        await self.n.stop()
        for sp, _ifn in self.speakers:
            await sp.stop()
        await self.f.stop()

    def stores(self):
        return [(self.f, self.n.kvstore, "0")]


def pfx_of(pfx, node):
    return next(db for db in pfx if db.this_node_name == node)\
        .prefix_entries[0]


def draw_rounds(seed: int, adj) -> list:
    """Seeded rounds: fabric flaps (one or three adjacency metrics of
    other nodes, traced), N's own link metrics set and cleared, a
    neighbour down and back up (traced), a link drained and undrained;
    a RibPolicy installed after the fifth round and removed after the
    ninth."""
    rng = np.random.default_rng(seed)
    me = next(db for db in adj if db.this_node_name == ME)
    others = [db.this_node_name for db in adj if db.this_node_name != ME]
    out = []
    for i in range(10):
        r = i % 5
        if r in (0, 3):
            flaps = []
            for _ in range(int(rng.choice([1, 3]))):
                node = str(rng.choice(others))
                k = int(rng.integers(0, 2))
                flaps.append((node, k, int(rng.integers(1, 30))))
            out.append(("flap", flaps))
        elif r == 1:
            a = me.adjacencies[int(rng.integers(0, len(me.adjacencies)))]
            out.append(("metric", a.if_name, int(rng.integers(1, 30))))
            out.append(("metric", a.if_name, None))
        elif r == 2:
            k = int(rng.integers(0, len(me.adjacencies)))
            out.append(("down", k))
            out.append(("up", k))
        else:
            a = me.adjacencies[int(rng.integers(0, len(me.adjacencies)))]
            out.append(("drain", a.if_name, True))
            out.append(("drain", a.if_name, False))
        if i in (4, 8):
            out.append(("policy", i == 4))
    return out


def rib_policy(pkg, me_db):
    """Weights 3 and 0 on N's first two neighbours for the loopbacks of
    nodes 0-15: a next hop reweighted, routes through the second alone
    removed."""
    nbrs = [a.other_node_name for a in me_db.adjacencies]
    return pkg.policy.RibPolicy(statements=(pkg.policy.RibPolicyStatement(
        name="lo", match_prefixes=("10.0.0.0/28",),
        neighbor_to_weight={nbrs[0]: 3, nbrs[1]: 0}),), ttl_secs=3600.0)


def apply_round(p: Pipeline, spec, dbs: dict) -> None:
    lm = p.n.linkmonitor
    if spec[0] == "flap":
        for node, k, metric in spec[1]:
            db = dbs[node]
            adjs = list(db.adjacencies)
            adjs[k] = dataclasses.replace(adjs[k], metric=metric)
            dbs[node] = dataclasses.replace(db, adjacencies=tuple(adjs))
        for j, node in enumerate(dict.fromkeys(n for n, _k, _m in spec[1])):
            p.set_adj(dbs[node], traced=j == 0)
    elif spec[0] == "metric":
        lm.set_link_metric(spec[1], spec[2])
    elif spec[0] in ("down", "up"):
        # the link down (Spark's hold timer expires: NEIGHBOR_DOWN) or
        # back up (rediscovery: NEIGHBOR_UP)
        a = p.me_db.adjacencies[spec[1]]
        p.hub.set_link(ME, a.if_name, spec[0] == "up")
    elif spec[0] == "policy":
        p.n.decision.set_rib_policy(
            rib_policy(p.pkg, p.me_db) if spec[1] else None)
    else:
        lm.set_link_overload(spec[1], spec[2])


def shapes(traces) -> list:
    """Each trace's marker names, a (marker, node) pair's repeats left
    out: a neighbour event whose handshake raced its neighbour's (Spark
    then emits NEIGHBOR_RESTARTED after NEIGHBOR_UP) merges into the same
    advertisement in one package and not in the other, in whichever
    order the two Sparks' timers ran. A trace of one origin has no
    repeated pair."""
    return [[e for e, _n in dict.fromkeys(t)] for t in traces]


def without_rtt(db):
    return dataclasses.replace(db, adjacencies=tuple(
        dataclasses.replace(a, rtt_us=0) for a in db.adjacencies))


async def round_settled(p: Pipeline, spec) -> None:
    """A link taken down or up has reached N's LinkMonitor."""
    if spec[0] in ("down", "up"):
        a = p.me_db.adjacencies[spec[1]]
        await until(lambda: p.n.adjacency(a.other_node_name, a.if_name)
                    == (spec[0] == "up"), f"{ME} {spec[0]} {a.if_name}")


def fresh_table(adj_dbs_now, own_db, prefix_dbs, policy=None) -> dict:
    """The port's CPU solve of the generator's LSDB with N's database
    replaced by LinkMonitor's (and `policy` applied), converted to FIB
    routes as bytes."""
    ls, ps_ = LinkState(), PrefixState()
    for db in adj_dbs_now.values():
        ls.update_adjacency_db(db if db.this_node_name != ME else own_db)
    for db in prefix_dbs:
        ps_.update_prefix_db(db)
    rdb = TorchSpfSolver(device="cpu").compute_routes(ls, ps_, ME)
    if policy is not None:
        policy.apply(rdb)
    return dict(
        unicast={str(p): ps.to_wire(e.to_unicast_route())
                 for p, e in sorted(rdb.unicast_routes.items())},
        mpls={lb: ps.to_wire(e.to_mpls_route())
              for lb, e in sorted(rdb.mpls_routes.items())})


STARTUP = ["NEIGHBOR_EVENT", "ADJ_DB_UPDATED", "KVSTORE_FLOODED",
           "DECISION_RECEIVED", "DECISION_DEBOUNCED", "REBUILD_FULL",
           "SPF_SOLVE_DONE", "ROUTE_UPDATE_SENT", "FIB_PROGRAMMED"]


@pytest.mark.parametrize("seed", range(2))
def test_pipeline_parity_with_the_jax_package(seed):
    r_adj, r_pfx = rtopogen.fat_tree(4, metric=10)
    p_adj, p_pfx = ptopogen.fat_tree(4, metric=10)
    assert [rs.to_wire(d) for d in r_adj] == [ps.to_wire(d) for d in p_adj]
    rounds = draw_rounds(SEED + seed, p_adj)

    async def body():
        runs = [Pipeline(PKGS["ref"], r_adj, r_pfx),
                Pipeline(PKGS["port"], p_adj, p_pfx)]
        dbs = [{db.this_node_name: db for db in adj}
               for adj in (r_adj, p_adj)]
        for p in runs:
            await p.start()
        nodes = [p.n for p in runs]
        stores = [s for p in runs for s in p.stores()]
        try:
            await quiet(nodes, stores)
            for p in runs:
                assert p.n.kvstore.initial_sync_done.is_set()
                assert p.n.decision.rib_computed.is_set()
                assert p.n.fib.synced.is_set()
            seen, policy, reweighted = [], None, 0
            for i, spec in enumerate([("start",)] + rounds):
                if i:
                    for p, d in zip(runs, dbs):
                        apply_round(p, spec, d)
                    for p in runs:
                        await round_settled(p, spec)
                    await quiet(nodes, stores)
                ref, port = (p.n.table() for p in runs)
                assert port == ref, (i, spec)
                own = runs[1].n.linkmonitor.build_adjacency_db("0")
                # equal but for the RTTs, which each Spark measures
                assert ps.to_wire(without_rtt(own)) == rs.to_wire(without_rtt(
                    runs[0].n.linkmonitor.build_adjacency_db("0")))
                if spec[0] == "policy":
                    policy = rib_policy(PKGS["port"], runs[1].me_db) \
                        if spec[1] else None
                want = fresh_table(dbs[1], own, p_pfx, policy)
                if policy is not None:
                    reweighted += sum(
                        1 for r in runs[1].n.handler.unicast[
                            pfib.CLIENT_ID_OPENR].values()
                        if any(nh.weight == 3 for nh in r.nexthops))
                assert port["unicast"] == want["unicast"], (i, spec)
                assert port["mpls"] == want["mpls"], (i, spec)
                r_tr, p_tr = (p.n.new_traces() for p in runs)
                assert shapes(p_tr) == shapes(r_tr), (i, spec)
                seen += p_tr
            assert reweighted  # the policy moved programmed routes
            names = [[e for e, _n in t] for t in seen]
            assert STARTUP in names
            for t in seen:
                assert t[-1] == ("FIB_PROGRAMMED", ME)
            fab = [t for t in seen if t[0] == ("ADJ_DB_UPDATED", FABRIC)]
            assert fab and all(t[1] == ("KVSTORE_FLOODED", FABRIC)
                               and t[2] == ("KVSTORE_FLOODED", ME)
                               for t in fab)
            # the gated aggregate reached the fabric once Fib synced
            key = pC.prefix_key(ME, "0", AGGREGATE)
            for p in runs:
                v = p.f.get_key("0", key)
                assert v is not None and not p.pkg.serde.from_wire(
                    v.value, p.pkg.topo.PrefixDatabase).delete_prefix
            mon = runs[1].n.monitor
            assert mon.recent(event="NEIGHBOR_UP") and mon.recent(event="NEIGHBOR_DOWN")
            assert runs[1].n.counters.stats["monitor.convergence_ms"].count
        finally:
            for p in runs:
                await p.stop()

    asyncio.run(body())


def test_failed_pass_keeps_its_trace_pending():
    """With the handler failing, a fabric flap's trace is not completed
    by the failed passes; it completes, once, after the pass that
    succeeds, and the table converges to the fresh solve's."""
    adj, pfx = ptopogen.fat_tree(4, metric=10)

    async def body():
        p = Pipeline(PKGS["port"], adj, pfx)
        dbs = {db.this_node_name: db for db in adj}
        await p.start()
        try:
            await quiet([p.n], p.stores())
            p.n.new_traces()
            fails0 = p.n.counters.get("fib.program_fail")
            p.n.handler.fail_next_n = 3
            apply_round(p, ("flap", [("node-4", 0, 1)]), dbs)
            await quiet([p.n], p.stores())
            assert p.n.counters.get("fib.program_fail") - fails0 == 3
            (trace,) = p.n.new_traces()
            assert [e for e, _n in trace][-2:] == ["ROUTE_UPDATE_SENT",
                                                  "FIB_PROGRAMMED"]
            assert p.n.fib.pending_changes()["converged"]
            own = p.n.linkmonitor.build_adjacency_db("0")
            assert p.n.table() == fresh_table(dbs, own, pfx)
        finally:
            await p.stop()

    asyncio.run(body())


def test_abr_end_to_end_on_the_port():
    """n1 (area A) — abr (A and B) — n2 (area B), three port nodes."""
    C = pcfg

    def node_cfg(name, areas, loopback):
        # the ABR negotiates each neighbour into its area by name
        return node_config(
            PKGS["port"], name,
            kvstore=C.KvstoreConfig(initial_sync_grace_s=0.5),
            areas=tuple(C.AreaConfig(area_id=a, neighbor_regexes=(
                (".*",) if len(areas) == 1 else (nbr,)))
                for a, nbr in zip(areas, ("n1", "n2"))),
            originated_prefixes=(C.OriginatedPrefix(prefix=loopback),))

    async def body():
        t = pkvs.InProcKvTransport()
        hub = pspark.MockIoHub()
        nodes = {
            "n1": Node(PKGS["port"], node_cfg("n1", ("A",), "10.91.0.1/32"),
                       t, hub),
            "abr": Node(PKGS["port"], node_cfg("abr", ("A", "B"),
                                               "10.91.0.2/32"), t, hub),
            "n2": Node(PKGS["port"], node_cfg("n2", ("B",), "10.91.0.3/32"),
                       t, hub),
        }
        links = (("n1", "abr"), ("abr", "n2"))
        for a, b in links:
            hub.link(a, f"if_{a}_{b}", b, f"if_{b}_{a}")
        for n in nodes.values():
            await n.start()
        for a, b in links:
            nodes[a].interfaces_up([f"if_{a}_{b}"])
            nodes[b].interfaces_up([f"if_{b}_{a}"])
        try:
            async def learned(node, prefix):
                target = IpPrefix.make(prefix)
                for _ in range(500):
                    if target in nodes[node].decision.rib.unicast_routes:
                        return nodes[node].decision.rib.unicast_routes[target]
                    await asyncio.sleep(0.02)
                raise AssertionError(f"{node} never learned {prefix}")

            entry = await learned("n2", "10.91.0.1/32")
            assert entry.best_node == "abr"
            assert entry.best_entry.area_stack == ("A",)
            assert entry.best_entry.metrics.distance == 1
            back = await learned("n1", "10.91.0.3/32")
            assert back.best_node == "abr"
            # and n2's Fib programmed it
            client = pfib.CLIENT_ID_OPENR
            for _ in range(200):
                if entry.prefix in nodes["n2"].handler.unicast.get(client, {}):
                    break
                await asyncio.sleep(0.02)
            else:
                raise AssertionError("n2's Fib did not program the route")
        finally:
            for n in nodes.values():
                await n.stop()

    asyncio.run(body())


# ---- the configs and constants the new modules read ---------------------------


# the sections the port copies whole, less the fields nothing reads: the
# adjacency labels come from the SR_LOCAL_RANGE constant in both packages,
# `install_to_fib` is read by neither, and NodeConfig's `enable_v4`,
# `enable_best_route_selection` and `dry_run` by no module. None: the
# port's fields are the JAX package's in its order (the "-full" cases say
# which are left out)
@pytest.mark.parametrize("name,left_out", [
    ("LinkMonitorConfig", set()), ("FibConfig", set()),
    ("SegmentRoutingConfig", {"sr_local_range"}),
    ("OriginatedPrefix", {"install_to_fib"}),
    ("PrefixAllocationConfig", set()), ("NodeConfig", None),
    ("AreaConfig", None),
    ("SparkConfig", set()), ("MessagingConfig", set()),
    ("WatchdogConfig", set()), ("PolicyStatementConfig", set()),
    ("RouteMapTermConfig", set()), ("UdpInterfaceConfig", set()),
    ("TlsConfig", set()),
    pytest.param("NodeConfig", {"enable_v4", "enable_best_route_selection",
                                "dry_run"}, id="NodeConfig-full"),
    pytest.param("AreaConfig", set(), id="AreaConfig-full"),
])
def test_config_fields_and_defaults_equal(name, left_out):
    """Each field the port keeps has the JAX package's name, type and
    default, in its order; the sections keep every field but the ones
    named."""
    ref, port = getattr(rcfg.config, name), getattr(pcfg, name)
    want = {f.name: str(f.type) for f in dataclasses.fields(ref)}
    got = [(f.name, str(f.type)) for f in dataclasses.fields(port)]
    assert got == [(n, want.get(n)) for n, _ in got]
    names = [n for n, _ in got]
    assert names == [n for n in want if n in names]
    if left_out is not None:
        assert names == [n for n in want if n not in left_out]
    kw = {"OriginatedPrefix": {"prefix": "10.0.0.0/8"},
          "UdpInterfaceConfig": dict(if_name="u", local_port=0,
                                     peer_host="h", peer_port=1)}.get(name, {})
    ref_defaults = dataclasses.asdict(ref(**kw))
    port_defaults = dataclasses.asdict(port(**kw))
    # the sections the port keeps in part are held by their own tests
    # (AreaConfig and SegmentRoutingConfig here, KvstoreConfig and
    # DecisionConfig beside their modules')
    kept = [n for n in names if n not in (
        "areas", "kvstore", "decision", "segment_routing")]
    assert {n: port_defaults[n] for n in kept} == \
        {n: ref_defaults[n] for n in kept}
    assert {"link_monitor", "fib", "segment_routing", "originated_prefixes",
            "prefix_allocation"} <= {f.name for f in dataclasses.fields(
                pcfg.NodeConfig)}


def test_config_json_reads_across_packages():
    """A JAX package's config document is read by the port's
    `Config.from_json` (the fields the port leaves out are skipped), and
    the port's `to_json` by the JAX package's, each section equal."""
    C = pcfg
    port = C.Config(C.NodeConfig(
        node_name="n", spark=C.SparkConfig(hello_time_ms=700),
        watchdog=C.WatchdogConfig(enable=False), kvstore_port=0,
        udp_interfaces=(C.UdpInterfaceConfig("u0", 0, "127.0.0.1", 9),),
        tls=C.TlsConfig(enabled=True, cert_path="c", key_path="k"),
        prefix_route_map=(C.RouteMapTermConfig(seq=5, set_tags=("t",)),)))
    ref = rcfg.Config.from_json(port.to_json())
    back = C.Config.from_json(ref.to_json())
    assert back.node == port.node
    for sect in ("spark", "watchdog", "udp_interfaces", "tls",
                 "prefix_route_map", "messaging", "areas"):
        assert rs.to_wire(getattr(ref.node, sect)) == ps.to_wire(
            getattr(port.node, sect)), sect


def test_constants_equal():
    for k in ("CTRL_PORT", "KVSTORE_PORT",
              "SPARK_HELLO_INTERVAL_MS", "SPARK_FASTINIT_HELLO_INTERVAL_MS",
              "SPARK_HANDSHAKE_INTERVAL_MS", "SPARK_HEARTBEAT_INTERVAL_MS",
              "SPARK_HOLD_TIME_MS", "SPARK_GR_HOLD_TIME_MS", "QUEUE_MAXSIZE",
              "SPARK_INBOX_MAXSIZE", "WATCHDOG_INTERVAL_S",
              "WATCHDOG_THREAD_TIMEOUT_S",
              "LINK_FLAP_INITIAL_BACKOFF_MS", "LINK_FLAP_MAX_BACKOFF_MS",
              "FIB_INITIAL_RETRY_MS", "FIB_MAX_RETRY_MS",
              "FIB_SYNC_INTERVAL_S", "FIB_CLIENT_OPENR", "FIB_CLIENT_STATIC",
              "SR_GLOBAL_RANGE", "SR_LOCAL_RANGE", "MPLS_LABEL_MIN",
              "MPLS_LABEL_MAX"):
        assert getattr(pC, k) == getattr(rC, k), k


@pytest.mark.parametrize("bad", [
    dict(fib=dict(initial_retry_ms=0)), dict(fib=dict(initial_retry_ms=9,
                                                      max_retry_ms=8)),
    dict(segment_routing=dict(enable=True, sr_global_range=(1, 5))),
    dict(originated_prefixes=("nonsense",)),
    dict(prefix_allocation=dict(seed_prefix="10.0.0.0/8",
                                alloc_prefix_len=8)),
    dict(prefix_allocation=dict(seed_prefix="bad", alloc_prefix_len=24)),
    dict(),
])
def test_config_validation_agrees(bad):
    """The same NodeConfig is refused (ConfigError) or taken by both."""
    outcomes = []
    for C in (rcfg, pcfg):
        kw = {}
        for sect, v in bad.items():
            if sect == "originated_prefixes":
                kw[sect] = tuple(C.OriginatedPrefix(prefix=p) for p in v)
            elif sect == "prefix_allocation":
                kw[sect] = C.PrefixAllocationConfig(**v)
            else:
                cls = {"fib": C.FibConfig,
                       "segment_routing": C.SegmentRoutingConfig}[sect]
                kw[sect] = cls(**v)
        try:
            C.Config(C.NodeConfig(node_name="n", **kw))
            outcomes.append("ok")
        except C.ConfigError:
            outcomes.append("refused")
    assert outcomes[0] == outcomes[1]
    assert outcomes[0] == ("ok" if not bad else "refused")

"""The port's LinkMonitor (`openr_tpu_torch.linkmonitor`) and neighbour /
interface events (`openr_tpu_torch.types.events`) held against the JAX
package's on the CPU.

* The JAX file's two standalone LinkMonitor cases
  (`tests/test_spark_linkmonitor.py`: flap damping, node overload) on
  the port, with a stand-in for Spark (Spark is not ported: LinkMonitor
  calls only `add_interface` / `remove_interface` on it).
* Events: seeded NeighborEvents (with traces) and InterfaceEvents encode
  to the same bytes in both packages, in both codecs, and decode across.
* Parity: one seeded stream of neighbour events (up, down, restarting,
  restarted, RTT changes, parallel links, two areas), interface events,
  metric overrides, link and node overloads goes to a JAX and a port
  LinkMonitor, each on its own package's KvStoreClient and KvStore, with
  segment routing on. After every step the adjacency databases of both
  areas (bytes, labels), the `adj:<node>` values in the stores, the
  PeerEvents, the interfaces handed to Spark, the log samples and the
  advertised traces are equal.
"""

import asyncio
import dataclasses
import types

import numpy as np
import pytest

import openr_tpu.kvstore as rkvs
import openr_tpu.linkmonitor as rlm
import openr_tpu.monitor.perf as rperf
import openr_tpu.types.events as rev
import openr_tpu.types.serde as rs
from openr_tpu import config as rcfg
from openr_tpu.messaging import ReplicateQueue as RefQueue
from openr_tpu.monitor import Counters as RefCounters
from openr_tpu_torch import config as pcfg
from openr_tpu_torch import kvstore as pkvs
from openr_tpu_torch import linkmonitor as plm
from openr_tpu_torch.common.constants import adj_key
from openr_tpu_torch.messaging import ReplicateQueue
from openr_tpu_torch.monitor import Counters
from openr_tpu_torch.monitor import perf as pperf
from openr_tpu_torch.types import events as pev
from openr_tpu_torch.types import serde as ps
from openr_tpu_torch.types.topology import AdjacencyDatabase

SEED = 20260604


class SparkStandIn:
    """What LinkMonitor calls on Spark: the interfaces it runs discovery
    on, and every call in order."""

    def __init__(self):
        self.interfaces: set[str] = set()
        self.calls: list[tuple[str, str]] = []

    def add_interface(self, name: str) -> None:
        self.interfaces.add(name)
        self.calls.append(("add", name))

    def remove_interface(self, name: str) -> None:
        self.interfaces.discard(name)
        self.calls.append(("remove", name))


def _mk_node(name: str) -> dict:
    """The JAX file's `_mk_node` on the port, Spark's place taken by the
    stand-in."""
    cfg = pcfg.Config(pcfg.NodeConfig(node_name=name))
    counters = Counters()
    pubs = ReplicateQueue(name=f"{name}.pubs")
    transport = pkvs.InProcKvTransport()
    store = pkvs.KvStore(cfg, transport, pubs, counters=counters)
    transport.register(name, store)
    client = pkvs.KvStoreClient(store, name, pubs.get_reader(),
                                counters=counters)
    nbr = ReplicateQueue(name=f"{name}.nbr")
    peers = ReplicateQueue(name=f"{name}.peers")
    spark = SparkStandIn()
    lm = plm.LinkMonitor(cfg, spark, client, nbr.get_reader(), peers,
                         counters=counters)
    return dict(store=store, client=client, spark=spark, lm=lm,
                counters=counters)


async def settle(cond, timeout=3.0) -> bool:
    t0 = asyncio.get_event_loop().time()
    while not cond():
        if asyncio.get_event_loop().time() - t0 > timeout:
            return False
        await asyncio.sleep(0.01)
    return True


def test_linkmonitor_flap_damping():
    async def main():
        n = _mk_node("a")
        for mod in ("store", "client", "lm"):
            await n[mod].start()
        lm = n["lm"]
        for _ in range(4):
            lm.update_interface(pev.InterfaceInfo(name="if-x", is_up=True))
            lm.update_interface(pev.InterfaceInfo(name="if-x", is_up=False))
        lm.update_interface(pev.InterfaceInfo(name="if-x", is_up=True))
        # damped: the interface is not handed to Spark at once
        assert "if-x" not in n["spark"].interfaces
        assert n["counters"].get("linkmonitor.flap_damped") > 0
        for mod in ("lm", "client", "store"):
            await n[mod].stop()

    asyncio.run(main())


def test_node_overload_advertised():
    async def main():
        n = _mk_node("a")
        for mod in ("store", "client", "lm"):
            await n[mod].start()

        def overloaded():
            v = n["store"].get_key("0", adj_key("a"))
            return v is not None and ps.from_wire(
                v.value, AdjacencyDatabase).is_overloaded

        n["lm"].set_node_overload(True)
        assert await settle(overloaded)
        n["lm"].set_node_overload(False)
        assert await settle(lambda: not overloaded())
        for mod in ("lm", "client", "store"):
            await n[mod].stop()

    asyncio.run(main())


# ---- events ------------------------------------------------------------------

EV = {"ref": (rev, rperf, rs), "port": (pev, pperf, ps)}


def draw_info(rng) -> dict:
    return dict(node_name=f"n{int(rng.integers(0, 6))}",
                local_if=f"if{int(rng.integers(0, 8))}",
                remote_if=f"rif{int(rng.integers(0, 8))}",
                area=str(rng.choice(["A", "B"])),
                kvstore_port=int(rng.choice([0, 0, 2019])),
                hold_time_ms=int(rng.integers(0, 3000)),
                rtt_us=int(rng.integers(0, 5000)),
                label=int(rng.integers(0, 60_000)),
                endpoint_host=str(rng.choice(["", "10.0.0.1"])))


def make_event(pkg, kind: int, info: dict, traced: bool, ts: int = 0):
    ev, perf, _serde = EV[pkg]
    pe = None
    if traced:
        pe = perf.PerfEvents()
        pe.add_perf_event(perf.NEIGHBOR_EVENT, node=info["node_name"],
                          ts_ns=ts)
    return ev.NeighborEvent(type=ev.NeighborEventType(kind),
                            info=ev.NeighborInfo(**info), perf_events=pe)


@pytest.mark.parametrize("trial", range(10))
def test_event_bytes_equal(trial):
    rng = np.random.default_rng(SEED + trial)
    for _ in range(10):
        info, kind = draw_info(rng), int(rng.integers(0, 5))
        traced, ts = bool(rng.random() < 0.5), int(rng.integers(0, 1 << 40))
        r, p = (make_event(k, kind, info, traced, ts) for k in EV)
        assert ps.to_wire(p) == rs.to_wire(r)
        assert ps.to_wire_bin(p) == rs.to_wire_bin(r)
        back = ps.from_wire_bin(rs.to_wire_bin(r), pev.NeighborEvent)
        assert back == p and back.perf_events == p.perf_events
        ifs = [dict(name=f"if{i}", is_up=bool(rng.random() < 0.5),
                    ifindex=int(rng.integers(0, 100)),
                    addrs=tuple(f"10.0.{i}.{j}/31"
                                for j in range(int(rng.integers(0, 3)))))
               for i in range(int(rng.integers(0, 4)))]
        ri = rev.InterfaceEvent(interfaces=[rev.InterfaceInfo(**d)
                                            for d in ifs])
        pi = pev.InterfaceEvent(interfaces=[pev.InterfaceInfo(**d)
                                            for d in ifs])
        assert ps.to_wire(pi) == rs.to_wire(ri)
        assert ps.to_wire_bin(pi) == rs.to_wire_bin(ri)
        assert ps.from_wire(rs.to_wire(ri), pev.InterfaceEvent) == pi


# ---- parity with the JAX package's LinkMonitor ---------------------------------

PKGS = {
    "ref": types.SimpleNamespace(
        cfg=rcfg, kvs=rkvs, lm=rlm, ev=rev, perf=rperf, serde=rs,
        Queue=RefQueue, Counters=RefCounters),
    "port": types.SimpleNamespace(
        cfg=pcfg, kvs=pkvs, lm=plm, ev=pev, perf=pperf, serde=ps,
        Queue=ReplicateQueue, Counters=Counters),
}
AREAS = ("A", "B")


def draw_steps(seed: int, n: int = 80) -> list:
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        r = rng.random()
        if r < 0.55:
            info = draw_info(rng)
            info["kvstore_port"] = 0
            out.append(("nbr", int(rng.choice([0, 0, 0, 1, 2, 3, 4])), info,
                        bool(rng.random() < 0.5), int(rng.integers(1, 1 << 40))))
        elif r < 0.7:
            out.append(("if", f"if{int(rng.integers(0, 8))}",
                        bool(rng.random() < 0.6)))
        elif r < 0.82:
            out.append(("metric", f"if{int(rng.integers(0, 8))}",
                        None if rng.random() < 0.3
                        else int(rng.integers(1, 100))))
        elif r < 0.92:
            out.append(("link_overload", f"if{int(rng.integers(0, 8))}",
                        bool(rng.random() < 0.5)))
        else:
            out.append(("node_overload", bool(rng.random() < 0.5)))
    return out


class LmRun:
    def __init__(self, pkg, rtt: bool):
        self.pkg = pkg
        C = pkg.cfg
        self.cfg = C.Config(C.NodeConfig(
            node_name="me",
            areas=tuple(C.AreaConfig(area_id=a) for a in AREAS),
            # a long hold-down: the damping decisions do not race the
            # clock between the two packages
            link_monitor=C.LinkMonitorConfig(
                linkflap_initial_backoff_ms=60_000, use_rtt_metric=rtt,
                exclude_interface_regexes=("if7",)),
            segment_routing=C.SegmentRoutingConfig(enable=True)))
        pubs = pkg.Queue(name="pubs")
        self.store = pkg.kvs.KvStore(self.cfg, pkg.kvs.InProcKvTransport(),
                                     pubs)
        client = pkg.kvs.KvStoreClient(self.store, "me", pubs.get_reader())
        self.pubs_r = pubs.get_reader()
        self.peers = pkg.Queue(name="peers")
        self.peers_r = self.peers.get_reader()
        self.logs = pkg.Queue(name="logs")
        self.logs_r = self.logs.get_reader()
        self.spark = SparkStandIn()
        self.lm = pkg.lm.LinkMonitor(
            self.cfg, self.spark, client, pkg.Queue().get_reader(),
            self.peers, log_samples_queue=self.logs)

    def step(self, spec) -> str | None:
        lm = self.lm
        try:
            if spec[0] == "nbr":
                _, kind, info, traced, ts = spec
                ev = self.pkg.ev
                pe = None
                if traced:
                    pe = self.pkg.perf.PerfEvents()
                    pe.add_perf_event(self.pkg.perf.NEIGHBOR_EVENT,
                                      node=info["node_name"], ts_ns=ts)
                lm._process_neighbor_event(ev.NeighborEvent(
                    type=ev.NeighborEventType(kind),
                    info=ev.NeighborInfo(**info), perf_events=pe))
            elif spec[0] == "if":
                lm.update_interface(self.pkg.ev.InterfaceInfo(
                    name=spec[1], is_up=spec[2]))
            elif spec[0] == "metric":
                lm.set_link_metric(spec[1], spec[2])
            elif spec[0] == "link_overload":
                lm.set_link_overload(spec[1], spec[2])
            else:
                lm.set_node_overload(spec[1])
        except ValueError as e:
            return str(e)
        # the debounced advertisement, run now
        pending = lm._advertise_debounce.pending
        lm._advertise_debounce.cancel()
        if pending:
            lm.advertise_adjacencies()
        return None

    def observed(self) -> dict:
        S, lm = self.pkg.serde, self.lm
        dbs = [lm.build_adjacency_db(a) for a in AREAS]
        stored = {a: (v.version, v.value) if (v := self.store.get_key(
            a, "adj:me")) is not None else None for a in AREAS}
        peers = []
        while self.peers_r.qsize():
            peers.append(dataclasses.asdict(self.peers_r.get_nowait()))
        logs = []
        while self.logs_r.qsize():
            s = self.logs_r.get_nowait()
            logs.append((s.event, s.attrs))
        traces = []
        while self.pubs_r.qsize():
            pub = self.pubs_r.get_nowait()
            if pub.perf_events is not None:
                traces.append((pub.area, [(e.event, e.node, e.ts_ns)
                                          for e in pub.perf_events.events
                                          if e.event != "KVSTORE_FLOODED"]))
        calls, self.spark.calls = self.spark.calls, []
        return dict(
            dbs=[S.to_wire(d) for d in dbs],
            dbs_bin=[S.to_wire_bin(d) for d in dbs],
            labels={k: lb for k, (_i, lb) in lm.adjacencies.items()},
            stored=stored, peers=peers, logs=logs, spark=calls,
            interfaces=lm.dump_interfaces(), traces=traces,
            damped=sorted(lm._if_backoff))


@pytest.mark.parametrize("seed,rtt", [(0, False), (1, True), (2, False),
                                      (3, True)])
def test_linkmonitor_parity_with_the_jax_package(seed, rtt):
    steps = draw_steps(SEED + seed)

    async def body():
        ref, port = LmRun(PKGS["ref"], rtt), LmRun(PKGS["port"], rtt)
        adv = 0
        for i, spec in enumerate(steps):
            errs = [run.step(spec) for run in (ref, port)]
            assert errs[0] == errs[1], (i, spec)
            r_obs, p_obs = ref.observed(), port.observed()
            # ADJ_DB_UPDATED is stamped with each package's clock
            for obs in (r_obs, p_obs):
                obs["traces"] = [(a, [(e, n, t) if e != "ADJ_DB_UPDATED"
                                      else (e, n, 0) for e, n, t in ev])
                                 for a, ev in obs["traces"]]
            assert p_obs == r_obs, (i, spec)
            adv += bool(r_obs["stored"]["A"] or r_obs["stored"]["B"])
        assert adv
        for run in (ref, port):
            for t in list(run.lm._tasks):
                t.cancel()

    asyncio.run(body())

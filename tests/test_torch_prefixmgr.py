"""The port's PrefixManager and PrefixRange (`openr_tpu_torch.prefixmgr`)
held against the JAX package's on the CPU.

* Every case of `tests/test_prefixmgr.py` runs on the port: the JAX test
  module's source, with each `openr_tpu` import pointed at
  `openr_tpu_torch`, executed as a module of its own.
* The cases of `tests/test_redistribution.py` and the range cases of
  `tests/test_prefix_scale.py` run on the port the same way, each
  function taken from its file's source; the range case's Decision is
  the port's on the CPU. The work-proportional case is held by the
  port's own work ledger. `test_abr_end_to_end` needs the JAX package's
  emulator cluster (Spark, TCP): its port counterpart, three in-process
  nodes across two areas, is in `tests/test_torch_node_pipeline.py`.
* Parity: one seeded stream of origination events (sources, metrics,
  tags, destination areas, ranges, withdrawals), Fib programmed updates
  (the supporting routes of gated config originations) and RIB updates
  (cross-area redistribution, under an origination policy) goes to a
  JAX and a port manager, each through its own package's KvStoreClient
  and KvStore. Every advertisement and tombstone has the same key and
  the same bytes (the JSON value and its `to_wire_bin` re-encoding),
  and the stores end equal.
"""

import ast
import pathlib
import re
import types

import numpy as np
import pytest

import openr_tpu.kvstore as rkvs
import openr_tpu.policy as rpolicy
import openr_tpu.prefixmgr as rpm
import openr_tpu.prefixmgr.ranges as rranges
import openr_tpu.types.network as rnet
import openr_tpu.types.routes as rroutes
import openr_tpu.types.serde as rs
import openr_tpu.types.topology as rtopo
from openr_tpu import config as rcfg
from openr_tpu.messaging import ReplicateQueue as RefQueue
from openr_tpu.monitor import Counters as RefCounters
from openr_tpu_torch import config as pcfg
from openr_tpu_torch import kvstore as pkvs
from openr_tpu_torch import policy as ppolicy
from openr_tpu_torch import prefixmgr as ppm
from openr_tpu_torch.decision.decision import Decision
from openr_tpu_torch.messaging import ReplicateQueue
from openr_tpu_torch.monitor import Counters, work_ledger
from openr_tpu_torch.prefixmgr import ranges as pranges
from openr_tpu_torch.types import network as pnet
from openr_tpu_torch.types import routes as proutes
from openr_tpu_torch.types import serde as ps
from openr_tpu_torch.types import topology as ptopo

TESTS = pathlib.Path(__file__).resolve().parent
SEED = 20260602


def port_source(name: str) -> str:
    src = (TESTS / f"{name}.py").read_text()
    port_src = re.sub(r"\bopenr_tpu\b", "openr_tpu_torch", src)
    assert not re.search(r"\bopenr_tpu\b", port_src)
    return port_src


def on_port(name: str) -> types.ModuleType:
    """`tests/<name>.py` with every import of the JAX package pointed at
    the port, executed as a module of its own."""
    mod = types.ModuleType(f"{name}_on_port")
    mod.__file__ = str(TESTS / f"{name}.py")
    exec(compile(port_source(name), f"{name}.py on the port", "exec"),
         mod.__dict__)
    return mod


def port_functions(name: str, wanted, **overrides) -> dict:
    """The top-level functions and classes `wanted` of
    `tests/<name>.py`, pointed at the port, in a namespace with that
    file's imports (each on its own: an import of a module the port has
    not got is left out, and a case that needs it fails by name) and
    `overrides`."""
    tree = ast.parse(port_source(name))
    ns = {"__name__": f"{name}_on_port"}
    for node in tree.body:
        if isinstance(node, (ast.Import, ast.ImportFrom)):
            try:
                exec(compile(ast.Module([node], []), name, "exec"), ns)
            except ImportError:
                pass
    found = set()
    for node in tree.body:
        if isinstance(node, (ast.FunctionDef, ast.ClassDef)) \
                and node.name in wanted:
            exec(compile(ast.Module([node], []), f"{name}.py on the port",
                         "exec"), ns)
            found.add(node.name)
    assert found == set(wanted), set(wanted) - found
    ns.update(overrides)
    return ns


def cases(mod):
    return sorted(n for n, f in vars(mod).items()
                  if n.startswith("test_") and callable(f))


def mk_decision(backend="cpu", name="node-0"):
    """The port's Decision on the CPU, for the range case's ingest."""
    assert backend == "cpu"
    cfg = pcfg.Config(pcfg.NodeConfig(node_name=name))
    return Decision(cfg, ReplicateQueue(name="pubs").get_reader(),
                    ReplicateQueue(name="routes"), counters=Counters(),
                    device="cpu")


PM_CASES = on_port("test_prefixmgr")
REDIST = ("test_fold_redistributes_into_other_area",
          "test_area_stack_prevents_loops", "test_withdraw_on_route_delete",
          "test_full_sync_replaces_rib_entries",
          "test_redistribution_work_under_churn",
          "test_best_book_parity_under_churn")
REDIST_NS = port_functions("test_redistribution", REDIST + (
    "run", "_RecordingKv", "_mk_pm", "_rib_entry", "_best_walk"))
RANGES = ("test_prefix_range_arithmetic",
          "test_prefix_manager_range_origination")
RANGES_NS = port_functions("test_prefix_scale", RANGES + ("run",),
                           mk_decision=mk_decision)


@pytest.mark.parametrize("case", cases(PM_CASES))
def test_prefixmgr_case_on_port(case):
    getattr(PM_CASES, case)()


@pytest.mark.parametrize("case", REDIST)
def test_redistribution_case_on_port(case):
    led = work_ledger.ledger()
    led.reset_warm()
    try:
        REDIST_NS[case]()
        if case == "test_redistribution_work_under_churn":
            # the JAX file's work_proportional marker, on the port's
            # ledger: no steady round did O(table) work
            assert led.warm_marked
            assert work_ledger.steady_violation_report() is None
    finally:
        led.reset_warm()


@pytest.mark.parametrize("case", RANGES)
def test_prefix_scale_range_case_on_port(case):
    RANGES_NS[case]()


def test_mirrored_modules_use_the_port():
    for ns in (vars(PM_CASES), REDIST_NS, RANGES_NS):
        for name in ("PrefixManager", "Config", "Counters", "IpPrefix",
                     "PrefixEntry", "RouteUpdate", "KvStore", "PrefixRange",
                     "work_ledger", "Decision"):
            obj = ns.get(name)
            if obj is not None:
                mod = getattr(obj, "__module__", None) or obj.__name__
                assert mod.startswith("openr_tpu_torch."), name
    assert len(cases(PM_CASES)) >= 4
    assert RANGES_NS["mk_decision"] is mk_decision


def test_persist_raises():
    kv = types.SimpleNamespace()
    with pytest.raises(NotImplementedError, match="persist"):
        ppm.PrefixManager(pcfg.Config.default("node-0"), kv,
                          persist=object())


# ---- parity with the JAX package's PrefixManager ----------------------------

PKGS = {
    "ref": types.SimpleNamespace(
        cfg=rcfg, kvs=rkvs, pm=rpm, ranges=rranges, net=rnet,
        routes=rroutes, topo=rtopo, serde=rs, policy=rpolicy,
        Queue=RefQueue, Counters=RefCounters),
    "port": types.SimpleNamespace(
        cfg=pcfg, kvs=pkvs, pm=ppm, ranges=pranges, net=pnet,
        routes=proutes, topo=ptopo, serde=ps, policy=ppolicy,
        Queue=ReplicateQueue, Counters=Counters),
}
AREAS = ("A", "B")
TAGS = ("gold", "deny", "edge")
AGGREGATES = ("10.20.0.0/16", "10.30.0.0/16")


class RecordingClient:
    """A KvStoreClient's persist_key / unset_key, recorded in call
    order before they reach the client."""

    def __init__(self, client):
        self.client = client
        self.log = []

    def persist_key(self, area, key, value, ttl_ms=0, perf_events=None):
        self.log.append(("persist", area, key, value, ttl_ms))
        self.client.persist_key(area, key, value, ttl_ms=ttl_ms,
                                perf_events=perf_events)

    def unset_key(self, area, key):
        self.log.append(("unset", area, key))
        self.client.unset_key(area, key)


def draw_entry(rng) -> dict:
    return dict(prefix=f"10.{int(rng.integers(40, 44))}."
                       f"{int(rng.integers(0, 8))}.0/24",
                path=int(rng.choice([900, 1000, 1100])),
                source=int(rng.choice([90, 100, 110])),
                distance=int(rng.integers(0, 3)),
                tags=tuple(sorted({str(t) for t in rng.choice(
                    TAGS, int(rng.integers(0, 3)), replace=False)})),
                stack=tuple(rng.choice(["A", "B"], int(rng.integers(0, 2)))))


def draw_events(seed: int, n: int = 120) -> list:
    """A seeded stream of ("event", ...), ("fib", ...) and ("rib", ...)
    steps as plain specs."""
    rng = np.random.default_rng(seed)
    ranges = [("17.0.0.0", 32, 2500), ("17.1.0.0", 24, 40),
              ("18.0.0.0", 32, 7)]
    programmed = set()
    out = []
    for _ in range(n):
        r = rng.random()
        if r < 0.4:
            kind = int(rng.choice([0, 0, 0, 1, 1, 2]))
            src = int(rng.choice([20, 30, 40]))
            ents = [draw_entry(rng) for _ in range(int(rng.integers(0, 4)))]
            rgs = ([(ranges[int(rng.integers(0, 3))],
                     int(rng.choice([900, 1000])))]
                   if kind < 2 and rng.random() < 0.3 else [])
            areas = tuple(sorted({str(a) for a in rng.choice(
                AREAS, int(rng.integers(0, 3)), replace=False)}))
            out.append(("event", kind, src, ents, rgs, areas))
        elif r < 0.7:
            full = bool(rng.random() < 0.2)
            cands = [f"10.{20 + 10 * int(rng.integers(0, 2))}."
                     f"{int(rng.integers(0, 4))}.{int(rng.integers(0, 8))}/32"
                     for _ in range(int(rng.integers(0, 6)))]
            if full:
                programmed = set(cands)
                out.append(("fib", True, cands, []))
            else:
                dels = [p for p in sorted(programmed)
                        if rng.random() < 0.3]
                programmed = (programmed | set(cands)) - set(dels)
                out.append(("fib", False, cands, dels))
        else:
            full = bool(rng.random() < 0.15)
            upd = []
            for _ in range(int(rng.integers(0, 5))):
                e = draw_entry(rng)
                upd.append((e, str(rng.choice(AREAS))))
            dels = [draw_entry(rng)["prefix"]
                    for _ in range(int(rng.integers(0, 3)))]
            out.append(("rib", full, upd, dels))
    return out


class PmRun:
    """One package's PrefixManager on a two-area store and client, with
    gated config originations and an origination policy."""

    def __init__(self, pkg):
        self.pkg = pkg
        C = pkg.cfg
        node = C.NodeConfig(
            node_name="abr",
            areas=tuple(C.AreaConfig(area_id=a) for a in AREAS),
            originated_prefixes=(
                C.OriginatedPrefix(prefix=AGGREGATES[0],
                                   minimum_supporting_routes=2,
                                   tags=("agg",)),
                C.OriginatedPrefix(prefix=AGGREGATES[1],
                                   minimum_supporting_routes=1,
                                   path_preference=800),
                C.OriginatedPrefix(prefix="10.99.0.1/32"),
            ))
        self.cfg = C.Config(node)
        pubs = pkg.Queue(name="pubs")
        self.store = pkg.kvs.KvStore(self.cfg, pkg.kvs.InProcKvTransport(),
                                     pubs, counters=pkg.Counters())
        client = pkg.kvs.KvStoreClient(self.store, "abr", pubs.get_reader())
        self.kv = RecordingClient(client)
        pol = pkg.policy.PolicyManager(statements=(
            pkg.policy.PolicyStatement(name="deny", match_tags=("deny",),
                                       action_accept=False),
            pkg.policy.PolicyStatement(name="gold", match_tags=("gold",),
                                       set_path_preference=1200,
                                       add_tags=("seen",)),
        ))
        self.pm = pkg.pm.PrefixManager(self.cfg, self.kv, policy=pol,
                                       counters=pkg.Counters())

    def entry(self, e):
        T = self.pkg.topo
        return T.PrefixEntry(
            prefix=self.pkg.net.IpPrefix.make(e["prefix"]),
            metrics=T.PrefixMetrics(path_preference=e["path"],
                                    source_preference=e["source"],
                                    distance=e["distance"]),
            tags=e["tags"], area_stack=e["stack"])

    def step(self, spec) -> None:
        P, R, N = self.pkg.pm, self.pkg.routes, self.pkg.net
        pm = self.pm
        if spec[0] == "event":
            _, kind, src, ents, rgs, areas = spec
            pm.process_event(P.PrefixEvent(
                type=P.PrefixEventType(kind), source=P.PrefixSource(src),
                entries=tuple(self.entry(e) for e in ents),
                dest_areas=areas,
                ranges=tuple(self.pkg.ranges.PrefixRange(
                    base=b, plen=pl, count=c,
                    template=self.pkg.topo.PrefixEntry(
                        prefix=N.IpPrefix(prefix="0.0.0.0/32"),
                        metrics=self.pkg.topo.PrefixMetrics(
                            path_preference=pp)))
                    for (b, pl, c), pp in rgs)))
        elif spec[0] == "fib":
            _, full, adds, dels = spec
            upd = R.RouteUpdate(type=(R.RouteUpdateType.FULL_SYNC if full
                                      else R.RouteUpdateType.INCREMENTAL))
            for p in adds:
                ip = N.IpPrefix.make(p)
                upd.unicast_to_update[ip] = R.RibEntry(prefix=ip,
                                                       nexthops=())
            upd.unicast_to_delete = [N.IpPrefix.make(p) for p in dels]
            pm._fold_fib_update(upd)
            pm._sync_originations()
            pm._sync_advertisements()
        else:
            _, full, upds, dels = spec
            upd = R.RouteUpdate(type=(R.RouteUpdateType.FULL_SYNC if full
                                      else R.RouteUpdateType.INCREMENTAL))
            for e, area in upds:
                ent = self.entry(e)
                upd.unicast_to_update[ent.prefix] = R.RibEntry(
                    prefix=ent.prefix,
                    nexthops=(N.NextHop(address="n1", if_name="if1",
                                        area=area),),
                    best_node="n1", best_entry=ent)
            upd.unicast_to_delete = [N.IpPrefix.make(p) for p in dels]
            pm.fold_rib_update(upd)
            pm._sync_advertisements()

    def observed(self):
        """The calls the step made: keys, values and their binary
        re-encodings; and the advertised book."""
        S, T = self.pkg.serde, self.pkg.topo
        log, self.kv.log = self.kv.log, []
        out = []
        for call in log:
            if call[0] == "persist":
                db = S.from_wire(call[3], T.PrefixDatabase)
                out.append(call + (S.to_wire_bin(db), db.delete_prefix))
            else:
                out.append(call)
        adv = {str(p): S.to_wire_bin(e)
               for p, e in self.pm.get_advertised().items()}
        return out, adv

    def stores(self):
        return {a: {k: (v.version, v.originator_id, v.value, v.ttl_version)
                    for k, v in self.store.dump(a).items()} for a in AREAS}


@pytest.mark.parametrize("seed", range(4))
def test_prefixmgr_parity_with_the_jax_package(seed):
    specs = draw_events(SEED + seed)
    ref, port = PmRun(PKGS["ref"]), PmRun(PKGS["port"])
    tombstones = gated = 0
    for run in (ref, port):
        run.pm._sync_originations()  # main()'s first pass
        run.pm._sync_advertisements()
    for i, spec in enumerate(specs + [("fib", True, [], [])]):
        for run in (ref, port):
            run.step(spec)
        r_obs, p_obs = ref.observed(), port.observed()
        assert p_obs == r_obs, (i, spec)
        tombstones += sum(1 for c in r_obs[0] if c[0] == "persist" and c[-1])
        gated += any(AGGREGATES[0] in c[2] for c in r_obs[0])
    assert port.stores() == ref.stores()
    # the stream exercised withdrawals and the FIB gate both ways
    assert tombstones and gated >= 2


def test_prefix_range_bytes_equal():
    rng = np.random.default_rng(SEED)
    for _ in range(20):
        plen = int(rng.choice([24, 28, 32]))
        base = int(rng.integers(0, 1 << 20)) << (32 - plen) & 0xFFFFFFFF
        base &= ~((1 << (32 - plen)) - 1)
        count = int(rng.integers(1, 3000))
        if base + count * (1 << (32 - plen)) > 1 << 32:
            continue
        b = ".".join(str(base >> s & 0xFF) for s in (24, 16, 8, 0))
        made = []
        for pkg in PKGS.values():
            t = pkg.topo.PrefixEntry(
                prefix=pkg.net.IpPrefix(prefix="0.0.0.0/32"),
                tags=("r",), weight=1)
            made.append(pkg.ranges.PrefixRange(base=b, plen=plen,
                                               count=count, template=t))
        r, p = made
        assert ps.to_wire_bin(p) == rs.to_wire_bin(r)
        assert ps.to_wire(p) == rs.to_wire(r)
        assert ps.from_wire_bin(rs.to_wire_bin(r), pranges.PrefixRange) == p
        assert [(f, ps.to_wire(list(e))) for f, e in p.chunks(512)] == \
            [(f, rs.to_wire(list(e))) for f, e in r.chunks(512)]
    assert pranges.RANGE_CHUNK == rranges.RANGE_CHUNK

"""The port's own Decision (`openr_tpu_torch.decision.decision`) held
against the JAX package's on the CPU: both are fed the same seeded churn
as publications (the same wire bytes), and after every rebuild their
RIBs, their RouteUpdates (the port's converted into the reference's
classes by `hook.RouteConverter`), the rebuild path, the decode tiers and
the perf markers are equal. The JAX side solves with `TpuSpfSolver`
(`native_rib="off"`) on JAX's CPU platform. Also the port's copies the
Decision stands on: the JSON wire codec byte for byte, the cross-area
merges, `AsyncDebounce`, `ReplicateQueue`, `DecisionConfig`."""

import asyncio
import dataclasses

import numpy as np
import pytest
import torch

import openr_tpu.monitor.perf as ref_perf
import openr_tpu.types.network as ref_network
import openr_tpu.types.routes as ref_routes
import openr_tpu.types.topology as ref_topology
from openr_tpu.common.constants import DEFAULT_AREA, adj_key, prefix_key
from openr_tpu.common.throttle import AsyncDebounce as RefDebounce
from openr_tpu.config import AreaConfig as RefAreaConfig
from openr_tpu.config import Config as RefConfig
from openr_tpu.config import DecisionConfig as RefDecisionConfig
from openr_tpu.config import NodeConfig as RefNodeConfig
from openr_tpu.decision import decision as ref_decision
from openr_tpu.messaging import ReplicateQueue as RefQueue
from openr_tpu.monitor import Counters as RefCounters
from openr_tpu.types import serde as ref_serde
from openr_tpu.types.kvstore import value_hash as ref_value_hash
from openr_tpu.utils import topogen
from openr_tpu_torch import config as pconfig
from openr_tpu_torch import messaging as pmessaging
from openr_tpu_torch.common import constants as pconst
from openr_tpu_torch.common.throttle import AsyncDebounce
from openr_tpu_torch.decision import decision as pdecision
from openr_tpu_torch.decision import hook
from openr_tpu_torch.decision import oracle as poracle
from openr_tpu_torch.monitor import Counters, perf
from openr_tpu_torch.types import kvstore as pkv
from openr_tpu_torch.types import network as pnetwork
from openr_tpu_torch.types import routes as proutes
from openr_tpu_torch.types import serde as pserde
from openr_tpu_torch.types import topology as ptopology
from tests.test_rebuild_scoped import adj_pub, prefix_pub, run
from tests.test_torch_decision import anycast_pub, next_pub

# one intra-op thread: the suite runs several test workers at once
torch.set_num_threads(1)


def mk_pair(areas=(DEFAULT_AREA,), **dcfg):
    """(reference Decision, its reader, port Decision, its reader)."""
    ref_cfg = RefConfig(RefNodeConfig(
        node_name="node-0", areas=tuple(RefAreaConfig(area_id=a) for a in areas),
        decision=RefDecisionConfig(**dict(dcfg, native_rib="off"))))
    ref_routes_q = RefQueue(name="routes")
    r_ref = ref_routes_q.get_reader()
    d_ref = ref_decision.Decision(
        ref_cfg, RefQueue(name="pubs").get_reader(), ref_routes_q,
        solver="tpu", counters=RefCounters())
    cfg = pconfig.Config(pconfig.NodeConfig(
        node_name="node-0",
        areas=tuple(pconfig.AreaConfig(area_id=a) for a in areas),
        decision=pconfig.DecisionConfig(**dcfg)))
    routes_q = pmessaging.ReplicateQueue(name="routes")
    r_port = routes_q.get_reader()
    d_port = pdecision.Decision(
        cfg, pmessaging.ReplicateQueue(name="pubs").get_reader(), routes_q,
        counters=Counters(), device="cpu")
    return d_ref, r_ref, d_port, r_port


def port_pub(pub, traced: bool):
    """The port's Publication of a reference one: the same keys, values
    and wire bytes, and a trace of its own."""
    return pkv.Publication(
        area=pub.area,
        key_vals={k: pkv.Value(
            version=v.version, originator_id=v.originator_id, value=v.value,
            ttl=v.ttl, ttl_version=v.ttl_version, hash=v.hash)
            for k, v in pub.key_vals.items()},
        expired_keys=list(pub.expired_keys),
        perf_events=(perf.PerfEvents.start(perf.KVSTORE_FLOODED, node="t")
                     if traced else None),
    )


def converter():
    return hook.RouteConverter(ref_routes, ref_network,
                               topology_types=ref_topology)


def drain(reader):
    return [reader.get_nowait() for _ in range(reader.qsize())]


def markers(update):
    return [[e.event for e in pe.events] for pe in update.perf_events]


def churn_parity(d_ref, r_ref, d_port, r_port, steps, seed, topo,
                 areas=(DEFAULT_AREA,)):
    """Feed both Decisions the same churn (`test_torch_decision`'s
    generator; with two areas each step lands in a seeded area) and hold
    them equal after every rebuild. Returns the rebuild paths taken."""
    conv = converter()
    paths = []

    async def body():
        adj_dbs, prefix_dbs = topo
        names = [db.this_node_name for db in adj_dbs]
        pubs = [adj_pub(adj_dbs, area=a) for a in areas]
        pubs += [prefix_pub(prefix_dbs, area=areas[0]),
                 anycast_pub(names, 1)]
        pubs[-1].area = areas[-1]
        rng = np.random.default_rng(seed)
        adj_cur = {db.this_node_name: db for db in adj_dbs}
        expired: set[str] = set()
        for step in range(-1, steps):
            if step >= 0:
                pub = next_pub(rng, step, names, adj_cur, expired)
                pub.area = areas[int(rng.integers(0, len(areas)))]
                pubs = [pub]
            for i, pub in enumerate(pubs):
                traced = step >= 0 or i == 0
                if traced:
                    pub.perf_events = ref_perf.PerfEvents.start(
                        ref_perf.KVSTORE_FLOODED, node="t")
                d_ref.process_publication(pub)
                d_port.process_publication(port_pub(pub, traced))
            await d_ref._rebuild_routes()
            await d_port._rebuild_routes()
            assert d_port._rebuild_path == d_ref._rebuild_path, step
            paths.append(d_port._rebuild_path)
            assert d_port.decode_stats == d_ref.decode_stats, step
            got = conv.route_db(d_port.rib)
            assert got.unicast_routes == d_ref.rib.unicast_routes, step
            assert got.mpls_routes == d_ref.rib.mpls_routes, step
            u_ref, u_port = drain(r_ref), drain(r_port)
            assert [conv.update(u) for u in u_port] == u_ref, step
            assert [markers(u) for u in u_port] == [
                markers(u) for u in u_ref], step

    run(body())
    return paths


@pytest.mark.parametrize("seed", [42, 7, 2026])
def test_churn_parity_with_the_reference_decision(seed):
    d_ref, r_ref, d_port, r_port = mk_pair()
    paths = churn_parity(d_ref, r_ref, d_port, r_port, 20, seed,
                         topogen.fat_tree(4))
    assert {"full", "prefix_only", "topo_delta"} <= set(paths)
    assert d_port.solver.warm_solves > 0
    c = d_port.counters
    assert c.get("decision.spf.solves") == d_port.solver.solve_count > 0
    assert c.get("decision.rebuild.topo_delta") == paths.count("topo_delta")
    assert sum(d_port.decode_stats.values()) > 0


@pytest.mark.parametrize("knobs", [
    dict(enable_lfa=True),
    dict(spf_kernel="dense"),
    dict(ksp_paths=4),
])
def test_churn_parity_under_the_decision_knobs(knobs):
    d_ref, r_ref, d_port, r_port = mk_pair(**knobs)
    s = d_port.solver
    assert s.enable_lfa == knobs.get("enable_lfa", False)
    assert s.kernel_impl == knobs.get("spf_kernel", "split")
    assert s.ksp_k == knobs.get("ksp_paths", 2)
    paths = churn_parity(d_ref, r_ref, d_port, r_port, 14, 5,
                         topogen.grid(4, 4))
    assert "prefix_only" in paths


@pytest.mark.parametrize("seed", [3, 11])
def test_churn_parity_over_two_areas(seed):
    areas = ("0", "1")
    d_ref, r_ref, d_port, r_port = mk_pair(areas=areas)
    paths = churn_parity(d_ref, r_ref, d_port, r_port, 16, seed,
                         topogen.fat_tree(4), areas=areas)
    assert "full" in paths and len(set(paths)) > 1
    assert set(d_port._area_cache) == set(areas)
    assert d_port.counters.get("decision.merge.scoped") == d_ref.counters.get(
        "decision.merge.scoped")


def test_accessors_match_the_reference():
    d_ref, r_ref, d_port, r_port = mk_pair()
    churn_parity(d_ref, r_ref, d_port, r_port, 6, 9, topogen.grid(4, 4))
    for src, dst in (("node-0", "node-15"), ("node-3", "node-8"),
                     ("node-5", "node-5"), ("node-0", "nowhere")):
        assert d_port.get_spf_path(src, dst) == d_ref.get_spf_path(src, dst)
    assert d_port.get_received_routes() == d_ref.get_received_routes()
    got = {a: [pserde.to_wire(db) for db in dbs]
           for a, dbs in d_port.get_adj_dbs().items()}
    want = {a: [ref_serde.to_wire(db) for db in dbs]
            for a, dbs in d_ref.get_adj_dbs().items()}
    assert got == want
    assert d_port.get_route_db() is d_port.rib
    d_port.trim_warm_state()
    assert d_port.warm_cache_bytes() == 0
    assert d_port.prefix_table_bytes() > 0


def test_live_decision_debounces_and_emits():
    """Started, the port's Decision reads its queue, debounces a burst
    into one rebuild and pushes one FULL_SYNC, then an incremental
    update for a metric flap, with the perf markers in stage order."""
    cfg = pconfig.Config.default("node-0")
    cfg.node.decision.debounce_min_ms = 2
    cfg.node.decision.debounce_max_ms = 20
    pubs = pmessaging.ReplicateQueue(name="pubs")
    routes = pmessaging.ReplicateQueue(name="routes")
    reader = routes.get_reader()
    d = pdecision.Decision(cfg, pubs.get_reader(), routes, device="cpu")
    adj_dbs, prefix_dbs = topogen.grid(3, 3)

    async def body():
        await d.start()
        for pub in (adj_pub(adj_dbs), prefix_pub(prefix_dbs)):
            pubs.push(port_pub(pub, traced=True))
        first = await asyncio.wait_for(reader.get(), 30)
        assert first.type == proutes.RouteUpdateType.FULL_SYNC
        assert d.debounce.fires == 1 and d._spf_runs == 1
        # node-1's link to node-2: node-0 then reaches node-2 at cost 4
        # over both of its links instead of 2 over one
        db = adj_dbs[1]
        adjs = [dataclasses.replace(a, metric=9)
                if a.other_node_name == "node-2" else a
                for a in db.adjacencies]
        pubs.push(port_pub(adj_pub([dataclasses.replace(
            db, adjacencies=tuple(adjs))], version=2), traced=True))
        upd = await asyncio.wait_for(reader.get(), 30)
        assert upd.type == proutes.RouteUpdateType.INCREMENTAL
        assert not upd.empty() and d._rebuild_path == "topo_delta"
        assert [pe.names() for pe in upd.perf_events] == [[
            perf.KVSTORE_FLOODED, perf.DECISION_RECEIVED,
            perf.DECISION_DEBOUNCED, perf.REBUILD_TOPO_DELTA,
            perf.SPF_SOLVE_DONE, perf.ROUTE_UPDATE_SENT]]
        await d.stop()
        pubs.close()

    run(body())


def test_a_failed_solve_is_raised(monkeypatch):
    """A solve that raises (as a kernel that fails to build or launch
    does) comes out of `_rebuild_routes`, with the RIB, the per-area
    caches cleared and the batch's traces kept for the next rebuild;
    started, the debounce task's guard counts it and no update is
    pushed. The next rebuild after the fault recovers."""
    cfg = pconfig.Config.default("node-0")
    cfg.node.decision.debounce_min_ms = 2
    cfg.node.decision.debounce_max_ms = 20
    pubs = pmessaging.ReplicateQueue(name="pubs")
    routes = pmessaging.ReplicateQueue(name="routes")
    reader = routes.get_reader()
    counters = Counters()
    d = pdecision.Decision(cfg, pubs.get_reader(), routes,
                           counters=counters, device="cpu")
    adj_dbs, prefix_dbs = topogen.grid(3, 3)
    solve = d.solver.compute_routes

    def broken(*a, **kw):
        raise RuntimeError("kernel launch failed")

    async def body():
        for pub in (adj_pub(adj_dbs), prefix_pub(prefix_dbs)):
            d.process_publication(port_pub(pub, traced=True))
        monkeypatch.setattr(d.solver, "compute_routes", broken)
        with pytest.raises(RuntimeError, match="kernel launch failed"):
            await d._rebuild_routes()
        assert d._spf_runs == 0 and not d.rib_computed.is_set()
        assert not d._area_cache and reader.qsize() == 0
        assert len(d._pending_perf) == 2
        # started: the debounce's task fails, its guard counts it
        await d.start()
        d.debounce.poke()
        # up to 30 s, as the wait below: the worker thread may start late
        # on a loaded host. The task's guard counts the exception in a
        # done-callback, one loop turn after `pending` turns false, so
        # the wait goes on until the count is in, within the same 30 s
        key = f"{d.name}.task_exceptions"
        for _ in range(6000):
            await asyncio.sleep(0.005)
            if not d.debounce.pending and counters.get(key) >= 1:
                break
        await asyncio.sleep(0)
        assert counters.get(key) == 1
        assert d.debounce.fires == 1 and d._spf_runs == 0
        assert reader.qsize() == 0
        monkeypatch.setattr(d.solver, "compute_routes", solve)
        d.debounce.poke()
        first = await asyncio.wait_for(reader.get(), 30)
        assert first.type == proutes.RouteUpdateType.FULL_SYNC
        assert d._spf_runs == 1 and len(first.perf_events) == 2
        await d.stop()
        pubs.close()

    run(body())


def test_decision_runs_on_the_card_unless_asked(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    q = pmessaging.ReplicateQueue(name="x")
    with pytest.raises(RuntimeError, match="CUDA"):
        pdecision.Decision(pconfig.Config.default("node-0"), q.get_reader(), q)
    d = pdecision.Decision(pconfig.Config.default("node-0"), q.get_reader(),
                           q, device="cpu")
    assert d.device.type == "cpu" and d.solver.device.type == "cpu"


@pytest.mark.parametrize("knob,msg", [
    (dict(native_rib="on"), "not part of the port"),
])
def test_what_the_port_lacks_raises(knob, msg):
    cfg = pconfig.Config(pconfig.NodeConfig(
        node_name="node-0", decision=pconfig.DecisionConfig(**knob)))
    q = pmessaging.ReplicateQueue(name="x")
    with pytest.raises(ValueError, match=msg):
        pdecision.Decision(cfg, q.get_reader(), q, device="cpu")


def mk_oracle_pair(**dcfg):
    """(reference Decision on its "cpu" backend, its reader, port Decision
    with `use_tpu_solver=False`, its reader)."""
    ref_cfg = RefConfig(RefNodeConfig(
        node_name="node-0", decision=RefDecisionConfig(**dcfg)))
    ref_routes_q = RefQueue(name="routes")
    r_ref = ref_routes_q.get_reader()
    d_ref = ref_decision.Decision(
        ref_cfg, RefQueue(name="pubs").get_reader(), ref_routes_q,
        solver="cpu", counters=RefCounters())
    cfg = pconfig.Config(pconfig.NodeConfig(
        node_name="node-0",
        decision=pconfig.DecisionConfig(use_tpu_solver=False, **dcfg)))
    routes_q = pmessaging.ReplicateQueue(name="routes")
    r_port = routes_q.get_reader()
    d_port = pdecision.Decision(
        cfg, pmessaging.ReplicateQueue(name="pubs").get_reader(), routes_q,
        counters=Counters())
    return d_ref, r_ref, d_port, r_port


def test_the_oracle_backend_builds_no_solver_and_needs_no_cuda(monkeypatch):
    """`use_tpu_solver=False` with no `device`: no CUDA asked for, no
    solver built, and every solve runs in the host oracle."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)

    def no_solver(*a, **k):
        raise AssertionError("the oracle backend built a solver")

    monkeypatch.setattr(hook, "solver_for", no_solver)
    monkeypatch.setattr(torch.cuda, "device", no_solver)
    d_ref, r_ref, d_port, r_port = mk_oracle_pair()
    assert d_port.backend == "oracle"
    assert d_port.solver is None and d_port.device is None
    assert isinstance(d_port.engine, poracle.OracleEngine)
    churn_parity(d_ref, r_ref, d_port, r_port, 4, 1, topogen.ring(16))
    art = d_port._area_cache[DEFAULT_AREA]["art"]
    assert art.solved is None and art.spf is not None
    assert d_port.warm_cache_bytes() >= 0 and d_port.prefix_table_bytes() > 0
    d_port.trim_warm_state()
    assert art.radj is None and art.spf.preds is None


@pytest.mark.parametrize("seed", [42, 7, 2026])
def test_oracle_backend_churn_parity_with_the_reference_cpu_backend(seed):
    """The port's Decision on the oracle against the JAX Decision's "cpu"
    backend, rebuild by rebuild: RIBs, RouteUpdates, rebuild paths,
    decode tiers and perf markers."""
    d_ref, r_ref, d_port, r_port = mk_oracle_pair()
    paths = churn_parity(d_ref, r_ref, d_port, r_port, 20, seed,
                         topogen.fat_tree(4))
    assert {"full", "prefix_only", "topo_delta"} <= set(paths)
    c, rc = d_port.counters, d_ref.counters
    for k in ("decision.rebuild.topo_delta", "decision.rebuild.full",
              "decision.rebuild.prefix_only", "decision.spf.warm_starts",
              "decision.rebuild.area_solves", "decision.nexthop_groups"):
        assert c.get(k) == rc.get(k), k
    assert "decision.spf.solves" not in c.counters  # no solver to count


@pytest.mark.parametrize("knobs", [dict(enable_lfa=True),
                                   dict(ksp_paths=4)])
def test_oracle_backend_churn_parity_under_the_knobs(knobs):
    d_ref, r_ref, d_port, r_port = mk_oracle_pair(**knobs)
    paths = churn_parity(d_ref, r_ref, d_port, r_port, 14, 5,
                         topogen.grid(4, 4))
    assert "prefix_only" in paths


# ------------------------------------------------------------------ config


@pytest.mark.parametrize("pair", [
    (RefDecisionConfig, pconfig.DecisionConfig, True),
    (RefAreaConfig, pconfig.AreaConfig, False),
])
def test_config_fields_and_defaults_equal(pair):
    """Each field the port keeps has the reference's name, type and
    default; `DecisionConfig` keeps every field, `AreaConfig` only the
    area id."""
    ref, port, whole = pair
    want = {f.name: f.type for f in dataclasses.fields(ref)}
    got = [(f.name, f.type) for f in dataclasses.fields(port)]
    assert got == [(n, want.get(n)) for n, _ in got]
    if whole:
        assert [n for n, _ in got] == list(want)
    ref_defaults = dataclasses.asdict(ref())
    assert dataclasses.asdict(port()) == {
        n: ref_defaults[n] for n, _ in got}


def test_config_validation_and_accessors():
    cfg = pconfig.Config.default("node-7", areas=(
        pconfig.AreaConfig("a"), pconfig.AreaConfig("b")))
    ref = RefConfig.default("node-7", areas=(
        RefAreaConfig("a"), RefAreaConfig("b")))
    assert cfg.area_ids() == ref.area_ids() == ["a", "b"]
    assert cfg.node_name == ref.node_name
    for bad in (dict(node_name="a:b"), dict(areas=()),
                dict(decision=pconfig.DecisionConfig(ksp_paths=17)),
                dict(decision=pconfig.DecisionConfig(debounce_min_ms=300))):
        with pytest.raises(pconfig.ConfigError):
            pconfig.Config(dataclasses.replace(
                pconfig.NodeConfig(node_name="n"), **bad))


# ------------------------------------------------------------------- serde


def _rand_adj(rng, mod):
    return mod.Adjacency(
        other_node_name=f"node-{int(rng.integers(0, 10_000))}",
        if_name=f"if_{int(rng.integers(0, 64))}",
        metric=int(rng.integers(1, 1 << 20)),
        adj_label=int(rng.integers(0, 60_000)),
        is_overloaded=bool(rng.integers(0, 2)),
        rtt_us=int(rng.integers(0, 5000)),
        weight=int(rng.integers(0, 8)),
        other_if_name=f"if_{int(rng.integers(0, 64))}" if rng.integers(0, 2)
        else "",
    )


def _rand_adj_db(rng, mod):
    return mod.AdjacencyDatabase(
        this_node_name=f"node-{int(rng.integers(0, 10_000))}",
        adjacencies=tuple(_rand_adj(rng, mod)
                          for _ in range(int(rng.integers(0, 9)))),
        is_overloaded=bool(rng.integers(0, 2)),
        node_label=int(rng.integers(0, 50_000)),
        area=str(int(rng.integers(0, 3))),
    )


def _rand_prefix_db(rng, mod, net):
    entries = []
    for _ in range(int(rng.integers(1, 5))):
        v6 = rng.integers(0, 4) == 0
        pfx = (f"2001:db8:{int(rng.integers(0, 9999)):x}::/64" if v6 else
               f"10.{int(rng.integers(0, 256))}.{int(rng.integers(0, 256))}"
               f".0/24")
        entries.append(mod.PrefixEntry(
            prefix=net.IpPrefix.make(pfx),
            metrics=mod.PrefixMetrics(
                path_preference=int(rng.integers(0, 2000)),
                source_preference=int(rng.integers(0, 200)),
                distance=int(rng.integers(0, 10))),
            forwarding_type=mod.ForwardingType(int(rng.integers(0, 2))),
            forwarding_algorithm=mod.ForwardingAlgorithm(
                int(rng.integers(0, 2))),
            tags=tuple(f"t{int(x)}" for x in rng.integers(0, 9, 2)),
            area_stack=("0",) if rng.integers(0, 2) else (),
            weight=int(rng.integers(0, 5)),
            min_nexthop=int(rng.integers(0, 3)),
        ))
    return mod.PrefixDatabase(
        this_node_name=f"node-{int(rng.integers(0, 10_000))}",
        prefix_entries=tuple(entries),
        area=str(int(rng.integers(0, 3))),
        delete_prefix=bool(rng.integers(0, 2)),
    )


_SCHEMAS = {
    "Adjacency": lambda rng, m, n: _rand_adj(rng, m),
    "AdjacencyDatabase": lambda rng, m, n: _rand_adj_db(rng, m),
    "PrefixDatabase": _rand_prefix_db,
}


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
@pytest.mark.parametrize("schema", sorted(_SCHEMAS))
def test_wire_bytes_equal_across_the_packages(schema, seed):
    """Equal objects encode to equal bytes in both packages, and each
    package decodes the other's bytes to its own equal object: Decision's
    splice tiers compare these bytes."""
    make = _SCHEMAS[schema]
    for i in range(20):
        ref_obj = make(np.random.default_rng([seed, i]), ref_topology,
                       ref_network)
        port_obj = make(np.random.default_rng([seed, i]), ptopology,
                        pnetwork)
        b = ref_serde.to_wire(ref_obj)
        assert pserde.to_wire(port_obj) == b
        cls = getattr(ptopology, schema)
        assert pserde.from_wire(b, cls) == port_obj
        assert ref_serde.from_wire(pserde.to_wire(port_obj),
                                   type(ref_obj)) == ref_obj


def test_keys_and_value_hash_equal_across_the_packages():
    for node, area, pfx in (("node-1", "0", "10.0.0.0/24"),
                            ("n", "spine", "2001:db8::/64")):
        key = pconst.prefix_key(node, area, pfx)
        assert key == prefix_key(node, area, pfx)
        assert pconst.parse_prefix_key(key) == (node, area, pfx)
        assert pconst.parse_adj_key(pconst.adj_key(node)) == node
        assert pconst.adj_key(node) == adj_key(node)
    assert pconst.parse_prefix_key("prefix:a:b") is None
    for v in (None, b"", b"xyz"):
        assert pkv.value_hash(3, "node-1", v) == ref_value_hash(3, "node-1", v)


# ------------------------------------------------------------------ merges


def _rand_area_ribs(rng, n_areas):
    """Per-area RIBs of both packages' classes over shared prefixes and
    labels, with metric and IGP ties so that the folds union."""
    ref_ribs, port_ribs = {}, {}
    for a in range(n_areas):
        area = f"a{a}"
        r = ref_routes.RouteDatabase(this_node_name="me")
        p = proutes.RouteDatabase(this_node_name="me")
        for k in range(12):
            if rng.integers(0, 4) == 0:
                continue
            pstr = f"10.9.{k}.0/24"
            pp = int(rng.choice([100, 200]))
            igp = int(rng.choice([10, 20]))
            weighted = k % 3 == 0
            nhs = []
            for j in sorted(rng.choice(6, int(rng.integers(1, 4)), False)):
                w = int(rng.integers(1, 5)) if weighted else 0
                nhs.append((f"n{j}", f"if{j}", igp, w, area))
            for mod_r, mod_n, mod_t, rib in (
                    (ref_routes, ref_network, ref_topology, r),
                    (proutes, pnetwork, ptopology, p)):
                ip = mod_n.IpPrefix(prefix=pstr)
                rib.unicast_routes[ip] = mod_r.RibEntry(
                    prefix=ip,
                    nexthops=tuple(sorted(mod_n.NextHop(
                        address=x[0], if_name=x[1], metric=x[2], weight=x[3],
                        area=x[4], neighbor_node=x[0]) for x in nhs)),
                    best_node="n0",
                    best_entry=mod_t.PrefixEntry(
                        prefix=ip,
                        metrics=mod_t.PrefixMetrics(path_preference=pp)),
                    igp_cost=igp,
                )
        for label in range(100, 106):
            if rng.integers(0, 3) == 0:
                continue
            m = int(rng.choice([5, 7]))
            js = sorted(rng.choice(5, 2, False))
            for mod_r, mod_n, rib in ((ref_routes, ref_network, r),
                                      (proutes, pnetwork, p)):
                rib.mpls_routes[label] = mod_r.RibMplsEntry(
                    label=label, nexthops=tuple(sorted(mod_n.NextHop(
                        address=f"n{j}", if_name=f"if{j}", metric=m,
                        area=area, neighbor_node=f"n{j}") for j in js)))
        ref_ribs[area], port_ribs[area] = r, p
    return ref_ribs, port_ribs


@pytest.mark.parametrize("seed", [0, 1, 2, 3, 4])
def test_cross_area_merges_equal_the_reference(seed):
    rng = np.random.default_rng(seed)
    ref_ribs, port_ribs = _rand_area_ribs(rng, 3)
    conv = converter()
    merged = pdecision.merge_area_ribs(port_ribs, "me")
    want = ref_decision.merge_area_ribs(ref_ribs, "me")
    got = conv.route_db(merged)
    assert got.unicast_routes == want.unicast_routes
    assert got.mpls_routes == want.mpls_routes
    # a scoped fold against a base: half the prefixes and labels in scope
    ref_base, port_base = _rand_area_ribs(np.random.default_rng(seed + 50), 1)
    ref_base = next(iter(ref_base.values()))
    port_base = next(iter(port_base.values()))
    scope = sorted({p.prefix for rib in port_ribs.values()
                    for p in rib.unicast_routes})[::2]
    labels = (100, 102, 104, 105)
    got_u = pdecision.merge_scope_delta(
        port_ribs, port_base, [pnetwork.IpPrefix(prefix=s) for s in scope],
        labels)
    want_u = ref_decision.merge_scope_delta(
        ref_ribs, ref_base, [ref_network.IpPrefix(prefix=s) for s in scope],
        labels)
    assert conv.update(got_u) == want_u
    assert not want_u.empty()


# --------------------------------------------------------- debounce, queues


class VirtualClock:
    """A clock that moves only when the test says: the debouncers'
    `time.monotonic` and `asyncio.sleep` read it, so both packages see
    the same pokes at the same instants, whatever the host's load."""

    def __init__(self):
        self.now = 0.0
        self.waiters: list = []

    def monotonic(self) -> float:
        return self.now

    async def sleep(self, dt: float) -> None:
        fut = asyncio.get_event_loop().create_future()
        self.waiters.append((self.now + max(dt, 0.0), fut))
        await fut

    async def run_until(self, t: float) -> None:
        """Wake the sleepers due by `t` in order, letting the woken tasks
        run before the next."""
        while True:
            for _ in range(8):
                await asyncio.sleep(0)
            due = [w for w in self.waiters if w[0] <= t]
            if not due:
                break
            w = min(due, key=lambda x: x[0])
            self.waiters.remove(w)
            self.now = max(self.now, w[0])
            if not w[1].done():
                w[1].set_result(None)
        self.now = t


def test_debounce_behaves_as_the_reference(monkeypatch):
    """Both debouncers on one virtual clock, poked at the same instants:
    a burst of pokes closer than min fires at the max cap and after the
    burst, a lone poke fires once, a poke during a slow fn fires once
    more after it; the pokes each fire saw are equal."""
    import types

    from openr_tpu.common import throttle as ref_throttle
    from openr_tpu_torch.common import throttle as port_throttle

    clock = VirtualClock()
    for mod in (ref_throttle, port_throttle):
        monkeypatch.setattr(mod, "time",
                            types.SimpleNamespace(monotonic=clock.monotonic))
        monkeypatch.setattr(mod, "asyncio", types.SimpleNamespace(
            sleep=clock.sleep, get_event_loop=asyncio.get_event_loop,
            iscoroutine=asyncio.iscoroutine))

    async def body():
        seen = {"ref": [], "port": []}
        debs = {}

        def fn_for(tag):
            async def fn():
                seen[tag].append((clock.now, debs[tag].pokes))
                await clock.sleep(0.03)  # a slow rebuild
            return fn

        debs["ref"] = RefDebounce(20, 60, fn_for("ref"))
        debs["port"] = AsyncDebounce(20, 60, fn_for("port"))

        def poke():
            for d in debs.values():
                d.poke()

        for _ in range(20):  # 100 ms of pokes 5 ms apart
            poke()
            await clock.run_until(clock.now + 0.005)
        await clock.run_until(clock.now + 0.25)
        poke()  # a lone poke
        await clock.run_until(clock.now + 0.035)
        poke()  # lands while the slow fn runs
        await clock.run_until(clock.now + 0.3)
        assert not any(d.pending for d in debs.values())
        return seen, [(d.fires, d.pokes) for d in debs.values()]

    seen, counts = asyncio.run(body())
    assert counts[0] == counts[1]
    assert seen["ref"] == seen["port"]
    assert counts[0][0] >= 4


_QUEUE_SCRIPT = [("push", i) for i in range(7)] + [
    ("get", 0), ("get", 1), ("push", 7), ("push", 8), ("get", 0),
    ("push", 9), ("get", 1), ("get", 1), ("get", 1), ("close", None),
    ("get", 0), ("get", 0), ("push", 10),
]


def _run_queue_script(mod, policy):
    """Drive a queue through `_QUEUE_SCRIPT`; returns what each step saw
    and the readers' stats."""
    q = mod.ReplicateQueue(
        name="q", maxsize=3, policy=policy,
        coalesce_fn=(lambda a, b: a + b if b % 2 == 0 else None))
    readers = [q.get_reader(), q.get_reader()]
    seen = []
    for op, arg in _QUEUE_SCRIPT:
        try:
            if op == "push":
                seen.append(("push", q.push(arg)))
            elif op == "get":
                seen.append(("get", readers[arg].get_nowait()))
            else:
                q.close()
                seen.append(("close", q.num_readers))
        except (mod.QueueFullError, mod.QueueClosedError) as e:
            seen.append((op, type(e).__name__))
    stats = [(r.highwater, r.coalesced, r.shed, r.overflow, r.qsize(),
              r.closed) for r in readers]
    return seen, stats, q.num_writes


@pytest.mark.parametrize("policy", [None, "block", "coalesce",
                                    "shed_oldest"])
def test_replicate_queue_behaves_as_the_reference(policy):
    from openr_tpu import messaging as ref_messaging

    assert _run_queue_script(pmessaging, policy) == _run_queue_script(
        ref_messaging, policy)


def test_queue_async_get_put_and_close():
    async def body(mod):
        q = mod.ReplicateQueue(name="q", maxsize=1, policy="block")
        r = q.get_reader()
        out = []

        async def consume():
            while True:
                try:
                    out.append(await r.get())
                except mod.QueueClosedError:
                    return

        task = asyncio.ensure_future(consume())
        for i in range(5):
            await q.put(i)
        await asyncio.sleep(0)
        q.close()
        await task
        return out, r.highwater

    from openr_tpu import messaging as ref_messaging

    assert asyncio.run(body(pmessaging)) == asyncio.run(body(ref_messaging))

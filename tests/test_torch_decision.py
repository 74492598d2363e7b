"""The port behind a real Decision: `hook.attach` on a Decision built with
the "cpu" backend, fed the same seeded churn (prefix adds and
withdrawals, metric flaps, overload toggles, node expiry and
re-advertisement) as a Decision on `TpuSpfSolver`, gives equal RIBs and
equal `RouteUpdate`s after every rebuild, with routes of the reference's
classes only, through the full, prefix-only and topology-delta
rebuilds."""

import dataclasses

import numpy as np
import pytest
import torch

import openr_tpu.types.network as ref_network
import openr_tpu.types.routes as ref_routes
from openr_tpu.common.constants import DEFAULT_AREA, adj_key, prefix_key
from openr_tpu.config import Config, DecisionConfig, NodeConfig
from openr_tpu.decision.decision import Decision
from openr_tpu.messaging import ReplicateQueue
from openr_tpu.monitor import Counters
from openr_tpu.types.kvstore import Publication
from openr_tpu.types.topology import PrefixDatabase, PrefixEntry
from openr_tpu.utils import topogen
from openr_tpu_torch.decision import hook
from tests.test_rebuild_scoped import adj_pub, one_prefix_pub, prefix_pub, run

# one intra-op thread: the suite runs several test workers at once
torch.set_num_threads(1)


def mk(backend, port=False, **dcfg):
    if backend == "tpu":
        # the reference solves on its device, never in the host C++
        # engine, so its RouteUpdate deletion order follows the same
        # path as the port's
        dcfg.setdefault("native_rib", "off")
    cfg = Config(NodeConfig(node_name="node-0",
                            decision=DecisionConfig(**dcfg)))
    routes = ReplicateQueue(name="routes")
    reader = routes.get_reader()
    d = Decision(cfg, ReplicateQueue(name="pubs").get_reader(), routes,
                 solver=backend, counters=Counters())
    if port:
        hook.attach(d, ref_routes, ref_network, device="cpu")
    return d, reader


def drain(reader):
    return [reader.get_nowait() for _ in range(reader.qsize())]


def assert_reference_types(rib):
    for e in rib.unicast_routes.values():
        assert type(e) is ref_routes.RibEntry
        for nh in (*e.nexthops, *e.backup_nexthops):
            assert type(nh) is ref_network.NextHop
            assert nh.mpls_action is None or type(nh.mpls_action) is \
                ref_network.MplsAction
        assert type(e.nexthops) in (tuple, ref_routes.NexthopGroup)
    for e in rib.mpls_routes.values():
        assert type(e) is ref_routes.RibMplsEntry
        assert all(type(nh) is ref_network.NextHop for nh in e.nexthops)


def anycast_pub(names, version):
    """Two advertisers for each of four /24s: the anycast election."""
    dbs = [PrefixDatabase(this_node_name=names[i], prefix_entries=(
        PrefixEntry(prefix=ref_network.IpPrefix(prefix=f"10.60.{k}.0/24")),))
        for k in range(4) for i in (3 + k, 9 + k)]
    return prefix_pub(dbs, version=version)


def churn(d_ref, d_port, r_ref, r_port, steps, seed, topo):
    async def body():
        adj_dbs, prefix_dbs = topo
        names = [db.this_node_name for db in adj_dbs]
        pubs = [adj_pub(adj_dbs), prefix_pub(prefix_dbs),
                anycast_pub(names, 1)]
        rng = np.random.default_rng(seed)
        adj_cur = {db.this_node_name: db for db in adj_dbs}
        expired: set[str] = set()
        for step in range(-1, steps):
            if step >= 0:
                pubs = [next_pub(rng, step, names, adj_cur, expired)]
            for pub in pubs:
                d_ref.process_publication(pub)
                d_port.process_publication(pub)
            await d_ref._rebuild_routes()
            await d_port._rebuild_routes()
            assert d_port.rib.unicast_routes == d_ref.rib.unicast_routes, step
            assert d_port.rib.mpls_routes == d_ref.rib.mpls_routes, step
            assert drain(r_port) == drain(r_ref), step
            assert_reference_types(d_port.rib)

    run(body())


def next_pub(rng, step, names, adj_cur, expired):
    """The churn of `test_rebuild_scoped.test_randomized_churn_parity`,
    with flaps off the root's own links weighted up so the warm path
    runs."""
    op = int(rng.integers(0, 10))
    name = names[int(rng.integers(1, len(names)))]  # never self
    if op < 3:
        i = int(rng.integers(0, len(names)))
        pstr = f"10.44.{i}.0/24"
        if rng.integers(0, 2):
            return one_prefix_pub(names[i], pstr, version=step + 2)
        return Publication(
            expired_keys=[prefix_key(names[i], DEFAULT_AREA, pstr)])
    if op < 7:
        db = adj_cur[name]
        adjs = list(db.adjacencies)
        k = int(rng.integers(0, len(adjs)))
        adjs[k] = dataclasses.replace(adjs[k],
                                      metric=int(rng.integers(1, 32)))
        db = dataclasses.replace(db, adjacencies=tuple(adjs))
        adj_cur[name] = db
        return adj_pub([db], version=step + 2)
    if op < 8:
        db = dataclasses.replace(adj_cur[name],
                                 is_overloaded=not adj_cur[name].is_overloaded)
        adj_cur[name] = db
        return adj_pub([db], version=step + 2)
    if op < 9 and name not in expired:
        expired.add(name)
        return Publication(expired_keys=[adj_key(name)])
    expired.discard(name)
    return adj_pub([adj_cur[name]], version=step + 2)


@pytest.mark.parametrize("seed", [42, 7, 2026])
def test_randomized_churn_parity_with_the_port_attached(seed):
    d_ref, r_ref = mk("tpu")
    d_port, r_port = mk("cpu", port=True)
    churn(d_ref, d_port, r_ref, r_port, 20, seed, topogen.fat_tree(4))
    c = d_port.counters
    assert c.get("decision.rebuild.prefix_only") > 0
    assert c.get("decision.rebuild.topo_delta") > 0
    assert d_port._tpu.solver.warm_solves > 0
    assert c.get("decision.spf.solves") == d_port._tpu.solve_count > 0
    assert {"profile.spf:batched_solve_ms", "profile.spf:rib_assembly_ms",
            "profile.spf:warm_solve_ms"} <= set(c.stats)
    d_port.warm_cache_bytes()
    d_port.trim_warm_state()
    assert d_port.warm_cache_bytes() == 0
    assert len(d_port._tpu.convert) == 0


@pytest.mark.parametrize("knobs", [
    dict(enable_lfa=True),
    dict(spf_kernel="dense"),
    dict(ksp_paths=4),
])
def test_churn_parity_under_the_decision_knobs(knobs):
    """The knobs the hook copies from the Decision's config reach the
    port's solver, and the RIBs still match step by step."""
    d_ref, r_ref = mk("tpu", **knobs)
    d_port, r_port = mk("cpu", port=True, **knobs)
    s = d_port._tpu.solver
    assert s.enable_lfa == knobs.get("enable_lfa", False)
    assert s.kernel_impl == knobs.get("spf_kernel", "split")
    assert s.ksp_k == knobs.get("ksp_paths", 2)
    assert s.counters is d_port.counters
    churn(d_ref, d_port, r_ref, r_port, 12, 5, topogen.grid(4, 4))
    assert d_port.counters.get("decision.rebuild.prefix_only") > 0


def test_warm_state_and_trim_through_the_decision():
    d, reader = mk("cpu", port=True)

    async def body():
        adj_dbs, prefix_dbs = topogen.grid(4, 4)
        d.process_publication(adj_pub(adj_dbs))
        d.process_publication(prefix_pub(prefix_dbs))
        await d._rebuild_routes()

    run(body())
    arts = [c["art"] for c in d._area_cache.values() if c["art"]]
    assert arts
    np.asarray(arts[0].solved[1])  # the warm path's host mirror
    assert d.warm_cache_bytes() > 0
    adapter = d._tpu
    assert len(adapter.convert) > 0 and adapter.solver._uni_cache
    d.trim_warm_state()
    assert d.warm_cache_bytes() == 0
    assert len(adapter.convert) == 0
    assert adapter.solver._mpls_fingerprint_cap == 8
    (update,) = drain(reader)
    assert update.type == ref_routes.RouteUpdateType.FULL_SYNC
    assert update.unicast_to_update


def test_no_comparison_mixes_the_packages():
    """The adapter's routes equal the reference solver's and never the
    port's own objects (the port's classes compare unequal to the
    reference's)."""
    from openr_tpu.decision.linkstate import LinkState, PrefixState
    from openr_tpu.decision.spf_backend import TpuSpfSolver

    adj_dbs, prefix_dbs = topogen.fat_tree(4)
    ls, ps = LinkState(), PrefixState()
    for db in adj_dbs:
        ls.update_adjacency_db(db)
    for db in prefix_dbs:
        ps.update_prefix_db(db)
    d, _ = mk("cpu")
    adapter = hook.attach(d, ref_routes, ref_network, device="cpu")
    raw = adapter.solver.compute_routes(ls, ps, "node-0")
    got = adapter.compute_routes(ls, ps, "node-0")
    ref = TpuSpfSolver(native_rib="off").compute_routes(ls, ps, "node-0")
    assert got.unicast_routes == ref.unicast_routes
    assert got.mpls_routes == ref.mpls_routes
    p = next(iter(raw.unicast_routes))
    assert raw.unicast_routes[p] != ref.unicast_routes[p]  # the hazard
    # memoised by identity: a hot RIB converts to the same objects, and
    # one port group to one reference group
    again = adapter.compute_routes(ls, ps, "node-0")
    assert all(again.unicast_routes[k] is got.unicast_routes[k]
               for k in got.unicast_routes)
    groups = {}
    for e in raw.unicast_routes.values():
        conv = adapter.convert.nexthops(e.nexthops)
        assert groups.setdefault(id(e.nexthops), conv) is conv
        assert type(conv) is ref_routes.NexthopGroup


def test_attach_raises_for_what_the_port_lacks():
    d, _ = mk("cpu", native_rib="on")
    with pytest.raises(ValueError, match="not part of the port"):
        hook.attach(d, ref_routes, ref_network, device="cpu")
    d, _ = mk("cpu")
    d.config.node.decision.mesh_sources = 2
    with pytest.raises(ValueError, match="needs 2 devices, have 1"):
        hook.attach(d, ref_routes, ref_network, device="cpu",
                    mesh_devices=["cpu"])
    assert d._tpu is None

"""The port's cross-rebuild route caches (`TorchSpfSolver._uni_cache`,
`_mpls_cache`, `_mpls_cls_cache`): over seeded rounds of metric flaps,
overload toggles, prefix adds and withdrawals and unchanged views, the
RouteDatabase of a solver whose caches are hot equals
`TpuSpfSolver(native_rib="off")`'s and a fresh port solver's; on an
unchanged view its plain, anycast and MPLS node entries are the same
objects; a flap that drops one of two equal-cost paths without moving any
distance rebuilds every route through it; `trim_caches(k)` bounds every
cache; `compute_fleet_ribs` raises the fingerprint cap; the artifact's
warm state is measured and dropped; and the named spans reach a
counters object."""

import dataclasses

import numpy as np
import pytest
import torch

from openr_tpu.decision.spf_backend import TpuSpfSolver
from openr_tpu_torch import TorchSpfSolver
from openr_tpu_torch.decision.fleet import compute_fleet_ribs
from tests.test_torch_routes import JAX, PORT, canon, canon_routes

# one intra-op thread: the suite runs several test workers at once
torch.set_num_threads(1)

ROOT = "node-0"


def topo_adj(pkg, topo):
    if topo == "fat_tree4":
        adj, _ = pkg.topo.fat_tree(4)
    else:
        adj, _ = pkg.topo.erdos_renyi(40, avg_degree=4, seed=3, max_metric=8)
    # adjacency labels on the root: the MPLS adjacency section
    return [
        dataclasses.replace(db, adjacencies=tuple(
            dataclasses.replace(a, adj_label=50_000 + i)
            for i, a in enumerate(db.adjacencies)
        )) if db.this_node_name == ROOT else db
        for db in adj
    ]


def prefix_dbs(pkg, names, seed=7):
    """The seeded prefix mix: every node's loopback (plain), /24s from
    two advertisers (anycast), UCMP /24s from two advertisers at weights 1
    and 3, and KSP2_ED_ECMP /24s over SR-MPLS."""
    t = pkg.t
    rng = np.random.default_rng(seed)
    out = []

    def add(node, prefix, **kw):
        out.append(t.PrefixDatabase(
            this_node_name=node,
            prefix_entries=(t.PrefixEntry(prefix=t.IpPrefix.make(prefix),
                                          **kw),),
        ))

    for i, n in enumerate(names):
        add(n, f"10.0.{i}.1/32")
    pick = lambda: names[int(rng.integers(1, len(names)))]  # noqa: E731
    for k in range(6):
        a, b = pick(), pick()
        add(a, f"10.50.{k}.0/24")
        add(b, f"10.50.{k}.0/24")
    for k in range(3):
        add(pick(), f"20.{k}.0.0/24", weight=1)
        add(pick(), f"20.{k}.0.0/24", weight=3)
    for k in range(4):
        add(pick(), f"30.{k}.0.0/24",
            forwarding_type=t.ForwardingType.SR_MPLS,
            forwarding_algorithm=t.ForwardingAlgorithm.KSP2_ED_ECMP)
    return out


def build(pkg, topo):
    adj = topo_adj(pkg, topo)
    ls, ps = pkg.ls(), pkg.ps()
    for db in adj:
        ls.update_adjacency_db(db)
    for db in prefix_dbs(pkg, [db.this_node_name for db in adj]):
        ps.update_prefix_db(db)
    return ls, ps


def port_solver(lfa, **kw):
    s = TorchSpfSolver(device="cpu", enable_lfa=lfa, ksp_k=2, **kw)
    s.elect_device_min = 0  # the device election's twin
    return s


class Both:
    """The same states in both packages, mutated in step."""

    def __init__(self, topo):
        self.j = build(JAX, topo)
        self.p = build(PORT, topo)
        self.names = [db.this_node_name for db in topo_adj(PORT, topo)]

    def adj(self, pkg, node):
        return (self.j if pkg is JAX else self.p)[0].adjacency_db(node)

    def update_adj(self, fn):
        for pkg, (ls, _ps) in ((JAX, self.j), (PORT, self.p)):
            ls.update_adjacency_db(fn(pkg))

    def update_prefix(self, node, prefix, withdraw):
        for pkg, (_ls, ps) in ((JAX, self.j), (PORT, self.p)):
            t = pkg.t
            if withdraw:
                ps.withdraw(node, t.IpPrefix.make(prefix))
            else:
                ps.update_prefix_db(t.PrefixDatabase(
                    this_node_name=node,
                    prefix_entries=(t.PrefixEntry(
                        prefix=t.IpPrefix.make(prefix)),),
                ))


def mutate(both, rng, step) -> str:
    """One seeded round; returns its kind."""
    op = int(rng.integers(0, 4)) if step else 3
    node = both.names[int(rng.integers(1, len(both.names)))]
    if op == 0:
        k = int(rng.integers(len(both.adj(PORT, node).adjacencies)))
        m = int(rng.integers(1, 12))

        def flap(pkg):
            db = both.adj(pkg, node)
            adjs = list(db.adjacencies)
            adjs[k] = dataclasses.replace(adjs[k], metric=m)
            return dataclasses.replace(db, adjacencies=tuple(adjs))

        both.update_adj(flap)
        return "flap"
    if op == 1:
        both.update_adj(lambda pkg: dataclasses.replace(
            both.adj(pkg, node),
            is_overloaded=not both.adj(pkg, node).is_overloaded))
        return "overload"
    if op == 2:
        i = int(rng.integers(0, 4))
        prefix = f"10.77.{i}.0/24"
        both.update_prefix(node, prefix, bool(rng.integers(0, 2)))
        return "prefix"
    return "unchanged"


def node_entries(rdb, lfa):
    """The entries an unchanged view must hand back as the same
    objects: the plain and anycast routes (with LFA every route takes the
    general path, which keeps no cache, as in the reference) and every
    node-segment label."""
    uni = {} if lfa else {p: e for p, e in rdb.unicast_routes.items()
                          if not p.prefix.startswith(("20.", "30."))}
    mpls = {lbl: e for lbl, e in rdb.mpls_routes.items() if lbl < 50_000}
    return uni, mpls


@pytest.mark.parametrize("lfa", [False, True])
@pytest.mark.parametrize("topo", ["fat_tree4", "er40"])
def test_hot_caches_equal_jax_and_cold_over_rounds(topo, lfa):
    both = Both(topo)
    hot = port_solver(lfa)
    rng = np.random.default_rng(2026)
    kinds = set()
    prev = None
    for step in range(14):
        kind = mutate(both, rng, step)
        kinds.add(kind)
        ref = TpuSpfSolver(native_rib="off", enable_lfa=lfa,
                           ksp_k=2).compute_routes(*both.j, ROOT)
        got = hot.compute_routes(*both.p, ROOT)
        cold = port_solver(lfa).compute_routes(*both.p, ROOT)
        assert canon(got) == canon(ref), (step, kind)
        assert got.unicast_routes == cold.unicast_routes, (step, kind)
        assert got.mpls_routes == cold.mpls_routes, (step, kind)
        assert any(p.prefix.startswith("30.") for p in got.unicast_routes)
        if kind == "unchanged" and prev is not None:
            for a, b in zip(node_entries(prev, lfa), node_entries(got, lfa)):
                assert a.keys() == b.keys()
                assert all(a[k] is b[k] for k in a), step
                assert a or lfa
        prev = got
    assert {"flap", "overload", "prefix", "unchanged"} <= kinds
    assert hot._uni_cache or lfa
    assert hot._mpls_cache and hot._mpls_cls_cache


def diamond(pkg, ax_metric):
    """node-0 reaches node-3 through node-1 and node-2 at equal cost (2),
    and node-4 behind node-3; `ax_metric` on node-1 -> node-3."""
    t = pkg.t
    links = {(0, 1): 1, (0, 2): 1, (1, 3): ax_metric, (2, 3): 1, (3, 4): 1,
             (2, 5): 4}
    adj = {i: [] for i in range(6)}
    for (a, b), m in links.items():
        for u, v, w in ((a, b, m), (b, a, 1 if (a, b) == (1, 3) else m)):
            adj[u].append(t.Adjacency(
                other_node_name=f"node-{v}", if_name=f"if_{u}_{v}",
                metric=w, other_if_name=f"if_{v}_{u}"))
    return [t.AdjacencyDatabase(this_node_name=f"node-{i}",
                                adjacencies=tuple(adj[i]),
                                node_label=101 + i)
            for i in range(6)]


def test_equal_cost_path_drop_rebuilds_the_routes_through_it():
    """The flap raises node-1 -> node-3 from 1 to 2: node-3 stays at
    distance 2 and stays the anycast winner, but loses node-1 as a first
    hop. No cache may hand back the two-path entries."""
    out = {}
    for pkg in (JAX, PORT):
        t = pkg.t
        ls, ps = pkg.ls(), pkg.ps()
        for db in diamond(pkg, 1):
            ls.update_adjacency_db(db)
        for node, prefix in (("node-3", "10.9.0.0/24"),
                             ("node-5", "10.9.0.0/24"),
                             ("node-3", "10.3.0.1/32"),
                             ("node-4", "10.4.0.1/32")):
            ps.update_prefix_db(t.PrefixDatabase(
                this_node_name=node,
                prefix_entries=(
                    t.PrefixEntry(prefix=t.IpPrefix.make(prefix)),),
            ))
        out[pkg is PORT] = (ls, ps)
    solver = port_solver(False)
    before = solver.compute_routes(*out[True], ROOT)
    for pkg in (JAX, PORT):
        db = next(d for d in diamond(pkg, 2) if d.this_node_name == "node-1")
        out[pkg is PORT][0].update_adjacency_db(db)
    after = solver.compute_routes(*out[True], ROOT)
    ref = TpuSpfSolver(native_rib="off").compute_routes(*out[False], ROOT)
    assert canon(after) == canon(ref)
    assert after.unicast_routes == port_solver(False).compute_routes(
        *out[True], ROOT).unicast_routes
    for prefix in ("10.9.0.0/24", "10.3.0.1/32", "10.4.0.1/32"):
        p = PORT.t.IpPrefix.make(prefix)
        assert after.unicast_routes[p].igp_cost == \
            before.unicast_routes[p].igp_cost
        assert len(before.unicast_routes[p].nexthops) == 2
        assert [nh.neighbor_node for nh in after.unicast_routes[p].nexthops] \
            == ["node-2"]
    assert len(after.mpls_routes[104].nexthops) == 1


def test_trim_caches_bounds_every_cache():
    both = Both("er40")
    solver = port_solver(False)
    for i in range(6):
        solver.compute_routes(*both.p, f"node-{i}")
    caches = (solver._uni_cache, solver._mpls_cache, solver._mpls_cls_cache)
    assert all(len(c) == 6 for c in caches)
    solver._elect_dev["x"] = object()
    solver.trim_caches(2)
    assert solver._mpls_fingerprint_cap == 2
    assert all(len(c) <= 2 for c in caches)
    assert not solver._elect_dev and not solver._warm_out
    for i in range(4):
        solver.compute_routes(*both.p, f"node-{i}")
    assert all(len(c) <= 2 for c in caches)
    # the most recently used fingerprints stay: node-3's RIB is served hot
    again = solver.compute_routes(*both.p, "node-3")
    last = solver.compute_routes(*both.p, "node-3")
    assert all(again.mpls_routes[k] is last.mpls_routes[k]
               for k in last.mpls_routes)
    solver.trim_caches(0)
    assert not any(caches)
    ref = TpuSpfSolver(native_rib="off").compute_routes(*both.j, "node-3")
    assert canon(solver.compute_routes(*both.p, "node-3")) == canon(ref)
    assert not any(caches)  # a cap of 0 keeps nothing


def test_lru_refresh_keeps_the_used_fingerprint():
    """Pop-then-set: a fingerprint used again moves to the newest end, so
    the next eviction takes the oldest unused one."""
    both = Both("er40")
    solver = port_solver(False)
    solver.trim_caches(2)
    first0 = solver.compute_routes(*both.p, "node-0")
    first1 = solver.compute_routes(*both.p, "node-1")
    solver.compute_routes(*both.p, "node-0")  # refresh node-0's cells
    solver.compute_routes(*both.p, "node-2")  # evicts node-1's, not node-0's
    hot0 = solver.compute_routes(*both.p, "node-0")
    again1 = solver.compute_routes(*both.p, "node-1")
    assert hot0.mpls_routes == first0.mpls_routes
    assert again1.mpls_routes == first1.mpls_routes
    for a, b in zip(node_entries(first0, False), node_entries(hot0, False)):
        assert a and all(a[k] is b[k] for k in a)
    for a, b in zip(node_entries(first1, False),
                    node_entries(again1, False)):
        assert a and not any(a[k] is b[k] for k in a)


def test_fleet_raises_the_fingerprint_cap():
    both = Both("fat_tree4")
    solver = port_solver(False)
    f1 = compute_fleet_ribs(*both.p, solver=solver)
    assert solver._mpls_fingerprint_cap == len(f1) + 1
    assert len(solver._mpls_cache) == len(f1) == 20
    f2 = compute_fleet_ribs(*both.p, solver=solver)
    for node in f1:
        assert f1[node].mpls_routes == f2[node].mpls_routes
        for a, b in zip(node_entries(f1[node], False),
                        node_entries(f2[node], False)):
            assert a and all(a[k] is b[k] for k in a)
    assert len(solver._mpls_cache) == 20
    solver.trim_caches()
    assert solver._mpls_fingerprint_cap == 8
    assert len(solver._mpls_cache) <= 8


def test_warm_state_bytes_and_drop():
    both = Both("er40")
    solver = port_solver(False)
    ref_solver = TpuSpfSolver(native_rib="off")
    _rdb, art = solver.compute_routes(*both.p, ROOT, return_artifact=True)
    _jrdb, jart = ref_solver.compute_routes(*both.j, ROOT,
                                            return_artifact=True)
    assert art.warm_state_bytes() == 0  # no host mirror yet
    mat = np.asarray(art.solved[1])
    assert art.warm_state_bytes() == mat.nbytes > 0
    art.drop_warm_state()
    assert art.warm_state_bytes() == 0
    prefixes = set(both.p[1].prefixes)
    got = solver.assemble_prefix_routes(art, both.p[1], prefixes)
    ref = ref_solver.assemble_prefix_routes(jart, both.j[1],
                                            set(both.j[1].prefixes))
    assert canon_routes(got) == canon_routes(ref)
    assert art.warm_state_bytes() == 0  # the scoped path needs no mirror


def flap_pairs(ls, node, k, metric):
    db = ls.adjacency_db(node)
    adjs = list(db.adjacencies)
    old = adjs[k]
    adjs[k] = dataclasses.replace(old, metric=metric)
    changed, pairs = ls.update_adjacency_db_delta(
        dataclasses.replace(db, adjacencies=tuple(adjs)))
    assert changed and pairs
    return pairs, old.metric


def sole_tight_edge(ls, art):
    """(node, adjacency index, metric) of the first adjacency u -> v, u
    not the root, that is v's only tight in-edge: raising it raises v's
    distance."""
    csr, dist = art.solved[0], art.solved[1]
    d = np.asarray(dist[:, 0]).astype(np.int64)
    e = csr.num_edges
    src, dst = csr.edge_src[:e], csr.edge_dst[:e]
    tight = d[src] + csr.edge_metric[:e] == d[dst]
    root = csr.name_to_id[ROOT]
    for i in np.nonzero(tight & (src != root))[0]:
        v = dst[i]
        if (tight & (dst == v)).sum() == 1:
            u_name, v_name = csr.node_names[src[i]], csr.node_names[v]
            adjs = ls.adjacency_db(u_name).adjacencies
            k = next(j for j, a in enumerate(adjs)
                     if a.other_node_name == v_name)
            return u_name, k, adjs[k].metric
    raise AssertionError("no sole tight edge")


def test_warm_path_goes_through_the_caches():
    """A flap and its revert through `warm_compute_routes`: each warm RIB
    equals a fresh solver's cold one, and after the revert the plain and
    node-segment routes the flap moved are the cold call's objects
    again."""
    both = Both("er40")
    ls, ps = both.p
    solver = port_solver(False)
    cold, art = solver.compute_routes(ls, ps, ROOT, return_artifact=True)
    node, k, metric = sole_tight_edge(ls, art)
    pairs, old_metric = flap_pairs(ls, node, k, metric + 20)
    got = solver.warm_compute_routes(art, ls, ps, ROOT, pairs, set(), cold,
                                     0.5)
    assert got is not None
    rdb, art2, touched, labels, _region = got
    fresh = port_solver(False).compute_routes(ls, ps, ROOT)
    assert rdb.unicast_routes == fresh.unicast_routes
    assert rdb.mpls_routes == fresh.mpls_routes
    assert touched and labels
    pairs, _ = flap_pairs(ls, node, k, old_metric)
    got = solver.warm_compute_routes(art2, ls, ps, ROOT, pairs, set(), rdb,
                                     0.5)
    assert got is not None
    rdb2, _art3, touched2, labels2, _ = got
    assert rdb2.unicast_routes == cold.unicast_routes
    assert rdb2.mpls_routes == cold.mpls_routes
    plain = [p for p in touched2 if p.prefix.startswith("10.0.")
             and p in cold.unicast_routes]
    assert plain
    assert all(rdb2.unicast_routes[p] is cold.unicast_routes[p]
               for p in plain)
    assert all(rdb2.mpls_routes[lbl] is cold.mpls_routes[lbl]
               for lbl in labels2 if lbl in cold.mpls_routes)


class Stats:
    """A stand-in counters object."""

    def __init__(self):
        self.samples: dict[str, list] = {}

    def add_value(self, key, value):
        self.samples.setdefault(key, []).append(value)


def test_spans_reach_the_counters():
    both = Both("er40")
    ls, ps = both.p
    st = Stats()
    solver = port_solver(False, counters=st)
    rdb, art = solver.compute_routes(ls, ps, ROOT, return_artifact=True)
    node = "node-7"
    pairs, _ = flap_pairs(ls, node, 0, 9)
    assert solver.warm_compute_routes(art, ls, ps, ROOT, pairs, set(), rdb,
                                      0.5) is not None
    port_solver(False, counters=st, use_dense=True).compute_routes(
        ls, ps, ROOT)
    assert {
        "profile.spf:batched_solve_ms", "profile.spf:rib_assembly_ms",
        "profile.spf:election_ms", "profile.spf:ksp_ms",
        "profile.spf:warm_solve_ms", "profile.spf:batched_dist_ms",
    } <= set(st.samples)
    assert all(v >= 0 for vs in st.samples.values() for v in vs)


@pytest.mark.parametrize("native_rib", ["auto", "off", "on"])
def test_native_rib_knob(native_rib):
    if native_rib == "on":
        with pytest.raises(ValueError, match="not part of the port"):
            TorchSpfSolver(device="cpu", native_rib=native_rib)
        return
    both = Both("fat_tree4")
    got = TorchSpfSolver(device="cpu", native_rib=native_rib
                         ).compute_routes(*both.p, ROOT)
    ref = TpuSpfSolver(native_rib="off").compute_routes(*both.j, ROOT)
    assert canon(got) == canon(ref)

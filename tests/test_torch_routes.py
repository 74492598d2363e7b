"""`TorchSpfSolver(device="cpu", ...)` gives the same RouteDatabase
(unicast and MPLS) as `TpuSpfSolver(native_rib="off", ...)` for every
prefix shape of the general per-prefix path: the KSP + LFA config of
`benchmarks/bench_ksp_lfa.py` at its defaults, the LFA cases of
`tests/test_lfa.py`, and the KSP2 and UCMP cases of
`tests/test_ksp_ucmp.py`; `assemble_prefix_routes` with KSP prefixes
equals the reference's; and `warm_compute_routes` declines with LFA on."""

import dataclasses
import enum
from dataclasses import replace
from types import SimpleNamespace

import numpy as np
import pytest
import torch

import openr_tpu.types as jtypes
import openr_tpu_torch.types as ptypes
from openr_tpu.common.constants import MPLS_LABEL_MIN
from openr_tpu.decision.linkstate import LinkState as JaxLinkState
from openr_tpu.decision.linkstate import PrefixState as JaxPrefixState
from openr_tpu.decision.spf_backend import TpuSpfSolver
from openr_tpu.utils import topogen as jtopo
from openr_tpu_torch import LinkState, PrefixState, TorchSpfSolver
from openr_tpu_torch.utils import topogen as ptopo

# one intra-op thread: the suite runs several test workers at once
torch.set_num_threads(1)

JAX = SimpleNamespace(t=jtypes, topo=jtopo, ls=JaxLinkState, ps=JaxPrefixState)
PORT = SimpleNamespace(t=ptypes, topo=ptopo, ls=LinkState, ps=PrefixState)


def _plain(x):
    if isinstance(x, dict):
        return tuple(sorted((_plain(k), _plain(v)) for k, v in x.items()))
    if isinstance(x, (list, tuple)):
        return tuple(_plain(v) for v in x)
    if isinstance(x, enum.Enum):
        return int(x.value)
    return x


def canon_routes(routes: dict):
    return tuple(sorted(
        (getattr(k, "prefix", k), _plain(dataclasses.asdict(e)))
        for k, e in routes.items()
    ))


def canon(rdb):
    return canon_routes(rdb.unicast_routes), canon_routes(rdb.mpls_routes)


def states(pkg, case):
    """(LinkState, PrefixState) of `case(pkg)` = (adj dbs, prefix dbs)."""
    adj, pfx = case(pkg)
    ls, ps = pkg.ls(), pkg.ps()
    for db in adj:
        ls.update_adjacency_db(db)
    for db in pfx:
        ps.update_prefix_db(db)
    return ls, ps


def assert_same_rib(case, roots, **kw):
    """The two solvers' RIBs of `case` from each root; returns the
    port's RIBs."""
    jls, jps = states(JAX, case)
    pls, pps = states(PORT, case)
    ref_solver = TpuSpfSolver(native_rib="off", **kw)
    solver = TorchSpfSolver(device="cpu", **kw)
    out = []
    for me in roots:
        ref = ref_solver.compute_routes(jls, jps, me)
        got = solver.compute_routes(pls, pps, me)
        assert canon(got) == canon(ref), me
        out.append(got)
    return out


# ------------------------------------------------ bench_ksp_lfa config


def bench_case(rings=8, ring_size=16, ksp_frac=0.1):
    """`bench_ksp_lfa`'s states: the backbone, one /24 per node, a
    `ksp_frac` share of them KSP2_ED_ECMP over SR-MPLS."""
    def case(pkg):
        t = pkg.t
        if pkg is JAX:
            from benchmarks.bench_ksp_lfa import build_backbone

            dbs = build_backbone(rings, ring_size)
        else:
            dbs = ptopo.backbone(rings, ring_size)
        n = len(dbs)
        rng = np.random.default_rng(0)
        ksp_nodes = set(rng.choice(n, size=max(1, int(n * ksp_frac)),
                                   replace=False).tolist())
        pfx = []
        for i in range(n):
            ksp = i in ksp_nodes
            pfx.append(t.PrefixDatabase(
                this_node_name=f"bb{i}",
                prefix_entries=(t.PrefixEntry(
                    prefix=t.IpPrefix.make(f"10.{(i >> 8) & 255}.{i & 255}.0/24"),
                    metrics=t.PrefixMetrics(),
                    forwarding_type=(t.ForwardingType.SR_MPLS if ksp
                                     else t.ForwardingType.IP),
                    forwarding_algorithm=(
                        t.ForwardingAlgorithm.KSP2_ED_ECMP if ksp
                        else t.ForwardingAlgorithm.SP_ECMP),
                ),),
            ))
        return dbs, pfx

    return case


def test_backbone_equals_build_backbone():
    from benchmarks.bench_ksp_lfa import build_backbone

    for rings, size in ((8, 16), (3, 5)):
        ref = [_plain(dataclasses.asdict(d)) for d in build_backbone(rings, size)]
        got = [_plain(dataclasses.asdict(d))
               for d in ptopo.backbone(rings, size)]
        assert got == ref


def test_bench_ksp_lfa_config_equal():
    """Config 4 at the bench's defaults: 8 x 16 backbone, 10% KSP
    prefixes, k = 16, LFA on, root bb1."""
    (got,) = assert_same_rib(bench_case(), ["bb1"], enable_lfa=True,
                             ksp_k=16)
    ksp = [e for e in got.unicast_routes.values()
           if e.best_entry.forwarding_algorithm
           == ptypes.ForwardingAlgorithm.KSP2_ED_ECMP]
    assert len(ksp) >= 10
    assert any(nh.mpls_action is not None for e in ksp for nh in e.nexthops)
    assert len(got.unicast_routes) == 127


# ------------------------------------------------------------ LFA cases


def _lfa_case(dbs_spec, prefix_map):
    """`dbs_spec`: [(node, [(other, if, metric)], overloaded)]."""
    def case(pkg):
        t = pkg.t
        dbs = [
            t.AdjacencyDatabase(
                this_node_name=node,
                adjacencies=tuple(
                    t.Adjacency(other_node_name=o, if_name=i,
                                other_if_name=f"r-{i}", metric=m)
                    for o, i, m in adjs
                ),
                is_overloaded=over,
            )
            for node, adjs, over in dbs_spec
        ]
        pfx = [
            t.PrefixDatabase(this_node_name=node, prefix_entries=(
                t.PrefixEntry(prefix=t.IpPrefix.make(p)),))
            for node, p in prefix_map.items()
        ]
        return dbs, pfx

    return case


SQUARE = [
    ("s", [("a", "sa", 1), ("b", "sb", 1)], False),
    ("a", [("s", "as", 1), ("d", "ad", 1)], False),
    ("b", [("s", "bs", 1), ("d", "bd", 2)], False),
    ("d", [("a", "da", 1), ("b", "db", 2)], False),
]


def test_lfa_square_backup_equal():
    (got,) = assert_same_rib(_lfa_case(SQUARE, {"d": "10.0.0.4/32"}), ["s"],
                             enable_lfa=True)
    e = got.unicast_routes[ptypes.IpPrefix.make("10.0.0.4/32")]
    assert [nh.address for nh in e.nexthops] == ["a"]
    assert [(nh.address, nh.metric) for nh in e.backup_nexthops] == [("b", 3)]


def test_lfa_looping_and_overloaded_neighbor_equal():
    line = [
        ("s", [("a", "sa", 1), ("b", "sb", 1)], False),
        ("a", [("s", "as", 1), ("d", "ad", 1)], False),
        ("b", [("s", "bs", 1)], False),
        ("d", [("a", "da", 1)], False),
    ]
    (got,) = assert_same_rib(_lfa_case(line, {"d": "10.0.0.4/32"}), ["s"],
                             enable_lfa=True)
    assert got.unicast_routes[
        ptypes.IpPrefix.make("10.0.0.4/32")].backup_nexthops == ()
    over = [(n, a, n == "b") for n, a, _o in SQUARE]
    (got,) = assert_same_rib(
        _lfa_case(over, {"d": "10.0.0.4/32", "b": "10.0.0.2/32"}), ["s"],
        enable_lfa=True,
    )
    assert got.unicast_routes[
        ptypes.IpPrefix.make("10.0.0.4/32")].backup_nexthops == ()


@pytest.mark.parametrize("topo", ["grid", "ring", "fat_tree"])
def test_lfa_topologies_equal(topo):
    args = {"grid": (4, 4), "ring": (8,), "fat_tree": (4,)}[topo]

    def case(pkg):
        return getattr(pkg.topo, topo)(*args)

    names = [db.this_node_name for db in case(PORT)[0]][:6]
    assert_same_rib(case, names[::2], enable_lfa=True)


def test_lfa_weighted_random_equal_with_backups():
    rng = np.random.default_rng(11)
    n = 24
    names = [f"w{i}" for i in range(n)]
    edges = {}
    for i in range(n):
        edges[(i, (i + 1) % n)] = int(rng.integers(1, 20))
        edges[((i + 1) % n, i)] = int(rng.integers(1, 20))
    for _ in range(2 * n):
        a, b = rng.integers(0, n, 2)
        if a != b:
            edges[(int(a), int(b))] = int(rng.integers(1, 20))
            edges[(int(b), int(a))] = int(rng.integers(1, 20))
    by_src: dict = {}
    for (a, b), m in edges.items():
        by_src.setdefault(a, []).append((b, m))
    spec = [
        (names[a], [(names[b], f"if{a}-{b}", m) for b, m in sorted(outs)],
         False)
        for a, outs in sorted(by_src.items())
    ]
    case = _lfa_case(spec, {names[i]: f"10.1.{i}.0/24" for i in range(n)})
    ribs = assert_same_rib(case, names[:8:2], enable_lfa=True)
    assert sum(len(e.backup_nexthops) for r in ribs
               for e in r.unicast_routes.values()) > 0


# ------------------------------------------------------ KSP2 and UCMP


def ksp2_entry(t, pfx, **kw):
    return t.PrefixEntry(
        prefix=t.IpPrefix.make(pfx),
        forwarding_type=t.ForwardingType.SR_MPLS,
        forwarding_algorithm=t.ForwardingAlgorithm.KSP2_ED_ECMP,
        **kw,
    )


def _strip(db, other):
    return replace(db, adjacencies=tuple(
        a for a in db.adjacencies if a.other_node_name != other))


def _line3(pkg):
    adj, _ = pkg.topo.ring(3)
    return [_strip(adj[0], "node-2"), adj[1], _strip(adj[2], "node-0")]


def _ring4_ksp(pkg):
    adj, _ = pkg.topo.ring(4)
    t = pkg.t
    return adj, [t.PrefixDatabase(this_node_name="node-2",
                                  prefix_entries=(ksp2_entry(t, "10.9.0.0/16"),))]


def _longer_second(pkg):
    t = pkg.t

    def adj(me, *links):
        return t.AdjacencyDatabase(
            this_node_name=me,
            node_label=MPLS_LABEL_MIN + 100 + ord(me[0]),
            adjacencies=tuple(
                t.Adjacency(other_node_name=o, if_name=f"if-{me}-{o}", metric=m)
                for o, m in links
            ),
        )

    dbs = [
        adj("a", ("b", 1), ("c", 1)),
        adj("b", ("a", 1), ("z", 1)),
        adj("c", ("a", 1), ("d", 1)),
        adj("d", ("c", 1), ("z", 1)),
        adj("z", ("b", 1), ("d", 1)),
    ]
    return dbs, [t.PrefixDatabase(this_node_name="z",
                                  prefix_entries=(ksp2_entry(t, "10.9.0.0/16"),))]


def _no_second(pkg):
    t = pkg.t
    return _line3(pkg), [t.PrefixDatabase(
        this_node_name="node-2", prefix_entries=(ksp2_entry(t, "10.9.0.0/16"),))]


def _ucmp(w1, w3):
    def case(pkg):
        t = pkg.t
        adj, _ = pkg.topo.ring(4)
        return adj, [
            t.PrefixDatabase(this_node_name=node, prefix_entries=(
                t.PrefixEntry(prefix=t.IpPrefix.make("10.9.0.0/16"), weight=w),))
            for node, w in (("node-1", w1), ("node-3", w3))
        ]

    return case


def _mixed_grid(pkg):
    t = pkg.t
    adj, pfx = pkg.topo.grid(3, 3)
    extra = [
        t.PrefixDatabase(this_node_name="node-8",
                         prefix_entries=(ksp2_entry(t, "10.80.0.0/16"),)),
        t.PrefixDatabase(this_node_name="node-2", prefix_entries=(
            t.PrefixEntry(prefix=t.IpPrefix.make("10.81.0.0/16"), weight=2),)),
        t.PrefixDatabase(this_node_name="node-6", prefix_entries=(
            t.PrefixEntry(prefix=t.IpPrefix.make("10.81.0.0/16"), weight=5),)),
    ]
    return list(adj), list(pfx) + extra


def _min_nexthop(pkg):
    t = pkg.t
    e = ksp2_entry(t, "10.9.0.0/16", min_nexthop=2)
    return _line3(pkg), [t.PrefixDatabase(this_node_name="node-2",
                                          prefix_entries=(e,))]


def _unlabeled(pkg):
    t = pkg.t
    adj, _ = pkg.topo.ring(6)
    adj = [replace(db, node_label=0) if db.this_node_name == "node-2" else db
           for db in adj]
    return adj, [t.PrefixDatabase(this_node_name="node-3",
                                  prefix_entries=(ksp2_entry(t, "10.9.0.0/16"),))]


def _fat_tree_k16(pkg):
    t = pkg.t
    adj, pfx = pkg.topo.fat_tree(4)
    nodes = [db.this_node_name for db in adj]
    extra = [
        t.PrefixDatabase(this_node_name=n, prefix_entries=(
            ksp2_entry(t, f"10.{90 + i}.0.0/16"),))
        for i, n in enumerate(nodes[::3])
    ]
    return list(adj), list(pfx) + extra


def _overloaded(pkg):
    t = pkg.t
    adj, _ = pkg.topo.grid(3, 3)
    adj = [replace(db, is_overloaded=(db.this_node_name == "node-4"))
           for db in adj]
    return adj, [t.PrefixDatabase(this_node_name="node-8",
                                  prefix_entries=(ksp2_entry(t, "10.71.0.0/16"),))]


def _drained(labels):
    def case(pkg):
        t = pkg.t
        adj, _ = pkg.topo.ring(4)
        dbs = []
        label = 50_000
        for db in adj:
            adjs = []
            for a in db.adjacencies:
                if db.this_node_name == "node-2":
                    a = replace(a, is_overloaded=a.other_node_name == "node-1")
                if labels:
                    a = replace(a, adj_label=label)
                    label += 1
                adjs.append(a)
            dbs.append(replace(db, adjacencies=tuple(adjs)))
        return dbs, [t.PrefixDatabase(
            this_node_name="node-2",
            prefix_entries=(ksp2_entry(t, "10.9.0.0/16"),))]

    return case


KSP_UCMP_CASES = {
    # name: (case, roots, solver kwargs)
    "ring4_disjoint": (_ring4_ksp, ["node-0"], {}),
    "second_path_longer": (_longer_second, ["a"], {}),
    "no_second_path": (_no_second, ["node-0"], {}),
    "ucmp_weighted_anycast": (_ucmp(3, 1), ["node-0"], {}),
    "ucmp_normalized": (_ucmp(4, 2), ["node-0"], {}),
    "mixed_grid": (_mixed_grid, ["node-0", "node-4", "node-7"], {}),
    "min_nexthop": (_min_nexthop, ["node-0"], {}),
    "unlabeled_interior_hop": (_unlabeled, ["node-0"], {}),
    "fat_tree_k16": (_fat_tree_k16, ["node-0", "node-10", "node-19"],
                     {"ksp_k": 16}),
    "ring6_k16": (lambda pkg: (pkg.topo.ring(6)[0], [pkg.t.PrefixDatabase(
        this_node_name="node-3",
        prefix_entries=(ksp2_entry(pkg.t, "10.70.0.0/16"),))]),
        ["node-0"], {"ksp_k": 16}),
    "overloaded_k4": (_overloaded, ["node-0"], {"ksp_k": 4}),
    "drained_link": (_drained(False), ["node-0"], {}),
    "drained_link_labels": (_drained(True), ["node-1"], {}),
}


@pytest.mark.parametrize("name", sorted(KSP_UCMP_CASES))
def test_ksp_ucmp_cases_equal(name):
    case, roots, kw = KSP_UCMP_CASES[name]
    ribs = assert_same_rib(case, roots, **kw)
    p = ptypes.IpPrefix.make("10.9.0.0/16")
    rib = ribs[0].unicast_routes
    if name == "ring4_disjoint":
        assert {nh.neighbor_node for nh in rib[p].nexthops} == {
            "node-1", "node-3"}
        assert all(nh.mpls_action.action == ptypes.MplsActionType.PUSH
                   for nh in rib[p].nexthops)
    elif name == "second_path_longer":
        assert sorted(nh.metric for nh in rib[p].nexthops) == [2, 3]
    elif name == "ucmp_weighted_anycast":
        assert {nh.neighbor_node: nh.weight for nh in rib[p].nexthops} == {
            "node-1": 3, "node-3": 1}
    elif name == "ucmp_normalized":
        assert {nh.neighbor_node: nh.weight for nh in rib[p].nexthops} == {
            "node-1": 2, "node-3": 1}
    elif name == "min_nexthop":
        assert p not in rib
    elif name == "unlabeled_interior_hop":
        assert {nh.neighbor_node for nh in rib[p].nexthops} == {"node-5"}
    elif name == "ring6_k16":
        assert len(rib[ptypes.IpPrefix.make("10.70.0.0/16")].nexthops) == 2
    elif name == "drained_link":
        assert {nh.neighbor_node for nh in rib[p].nexthops} == {"node-3"}


def test_assemble_prefix_routes_with_ksp_equal():
    """The scoped reassembly (no new solve) of KSP, UCMP and plain
    prefixes against an artifact equals the reference's."""
    jls, jps = states(JAX, _mixed_grid)
    pls, pps = states(PORT, _mixed_grid)
    for kw in ({}, {"enable_lfa": True}):
        ref_solver = TpuSpfSolver(native_rib="off", **kw)
        solver = TorchSpfSolver(device="cpu", **kw)
        _r, jart = ref_solver.compute_routes(jls, jps, "node-4",
                                             return_artifact=True)
        _g, part = solver.compute_routes(pls, pps, "node-4",
                                         return_artifact=True)
        assert part.ksp_k == solver.ksp_k
        prefixes = set(list(pps.prefixes)[::2]) | {
            ptypes.IpPrefix.make("10.80.0.0/16"),
            ptypes.IpPrefix.make("10.81.0.0/16"),
        }
        jprefixes = {jtypes.IpPrefix(prefix=p.prefix) for p in prefixes}
        ref = ref_solver.assemble_prefix_routes(jart, jps, jprefixes)
        got = solver.assemble_prefix_routes(part, pps, prefixes)
        assert canon_routes(got) == canon_routes(ref)
        assert ptypes.IpPrefix.make("10.80.0.0/16") in got
        assert solver.last_ksp_stats["jobs"] == 1


def test_warm_declines_with_lfa():
    jls, jps = states(JAX, _mixed_grid)
    pls, pps = states(PORT, _mixed_grid)
    ref_solver = TpuSpfSolver(native_rib="off", enable_lfa=True)
    solver = TorchSpfSolver(device="cpu", enable_lfa=True)
    jrdb, jart = ref_solver.compute_routes(jls, jps, "node-0",
                                           return_artifact=True)
    prdb, part = solver.compute_routes(pls, pps, "node-0",
                                       return_artifact=True)
    ref = ref_solver.warm_compute_routes(
        jart, jls, jps, "node-0", {("node-4", "node-5")}, set(), jrdb, 0.25)
    got = solver.warm_compute_routes(
        part, pls, pps, "node-0", {("node-4", "node-5")}, set(), prdb, 0.25)
    assert ref is None and got is None

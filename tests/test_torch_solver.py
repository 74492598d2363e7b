"""`TorchSpfSolver(device="cpu").compute_routes` builds the same
RouteDatabase as `TpuSpfSolver(native_rib="off").compute_routes` on the
same topology."""

import dataclasses
import enum
from dataclasses import replace

import numpy as np
import pytest
import torch

from openr_tpu.decision.linkstate import LinkState as JaxLinkState
from openr_tpu.decision.linkstate import PrefixState as JaxPrefixState
from openr_tpu.decision.spf_backend import TpuSpfSolver
from openr_tpu.utils import topogen as jtopo
from openr_tpu_torch import LinkState, PrefixState, TorchSpfSolver
from openr_tpu_torch.convert import csr_from_numpy
from openr_tpu_torch.decision.spf_backend import LazyDist
from openr_tpu_torch.utils import topogen as ptopo

# one intra-op thread: the suite runs several test workers at once
torch.set_num_threads(1)


def _plain(x):
    if isinstance(x, dict):
        return tuple(sorted((_plain(k), _plain(v)) for k, v in x.items()))
    if isinstance(x, (list, tuple)):
        return tuple(_plain(v) for v in x)
    if isinstance(x, enum.Enum):
        return int(x.value)
    return x


def canon(rdb):
    """A package-independent canonical form of a RouteDatabase: every
    entry through `dataclasses.asdict`, enums as ints, dicts as sorted
    item tuples."""
    return (
        rdb.this_node_name,
        tuple(sorted(
            (p.prefix, _plain(dataclasses.asdict(e)))
            for p, e in rdb.unicast_routes.items()
        )),
        tuple(sorted(
            (label, _plain(dataclasses.asdict(e)))
            for label, e in rdb.mpls_routes.items()
        )),
    )


def _states(mod, ls_cls, ps_cls, gen, args, overloaded=(), labels=False):
    adj, pfx = getattr(mod, gen)(*args)
    ls, ps = ls_cls(), ps_cls()
    for db in adj:
        if db.this_node_name in overloaded:
            db = replace(db, is_overloaded=True)
        if labels and db.this_node_name == "node-0":
            # adjacency SR labels on the root: the MPLS adj-label section
            db = replace(db, adjacencies=tuple(
                replace(a, adj_label=50_000 + i)
                for i, a in enumerate(db.adjacencies)
            ))
        ls.update_adjacency_db(db)
    for db in pfx:
        ps.update_prefix_db(db)
    return ls, ps


TOPOS = {
    "fat_tree4": ("fat_tree", (4,), {}),
    "grid": ("grid", (6, 5), {}),
    "wan_like": ("wan_like", (48, 7), {}),
    "overloaded": ("wan_like", (40, 2),
                   dict(overloaded=("node-1", "node-5", "node-20"))),
    "adj_labels": ("grid", (4, 4), dict(labels=True)),
    "hub_and_spoke": ("hub_and_spoke", (3, 30), {}),
}


@pytest.mark.parametrize("topo", sorted(TOPOS))
def test_compute_routes_equal(topo):
    gen, args, kw = TOPOS[topo]
    jls, jps = _states(jtopo, JaxLinkState, JaxPrefixState, gen, args, **kw)
    pls, pps = _states(ptopo, LinkState, PrefixState, gen, args, **kw)
    for me in ("node-0", "node-3") if topo == "wan_like" else ("node-0",):
        ref = TpuSpfSolver(native_rib="off").compute_routes(jls, jps, me)
        got = TorchSpfSolver(device="cpu").compute_routes(pls, pps, me)
        assert len(got.unicast_routes) > 0
        assert canon(got) == canon(ref)


def test_compute_routes_equal_erdos_renyi_lsdb():
    jls, jps, jcsr = jtopo.erdos_renyi_lsdb(2000, avg_degree=10, seed=1)
    pls, pps, _ = ptopo.erdos_renyi_lsdb(2000, avg_degree=10, seed=1)
    ref = TpuSpfSolver(native_rib="off").compute_routes(jls, jps, "node-0")
    solver = TorchSpfSolver(device="cpu")
    got = solver.compute_routes(pls, pps, "node-0")
    assert len(got.unicast_routes) == 1999
    assert canon(got) == canon(ref)
    # the same LSDB carried across from the JAX package's CsrGraph
    moved = ptopo.LsdbView(csr_from_numpy(
        num_nodes=jcsr.num_nodes, num_edges=jcsr.num_edges,
        edge_src=jcsr.edge_src, edge_dst=jcsr.edge_dst,
        edge_metric=jcsr.edge_metric,
        node_overloaded=jcsr.node_overloaded, node_mask=jcsr.node_mask,
        node_names=jcsr.node_names, adj_details=jcsr.adj_details,
    ))
    got2 = TorchSpfSolver(device="cpu").compute_routes(moved, pps, "node-0")
    assert canon(got2) == canon(ref)
    st = solver.last_solve_stats
    assert st["host_syncs"] == st["replays"] >= 1
    assert st["relax_launches"] == 0  # CPU: the plain version, no kernel


def test_solve_returns_lazy_dist_and_lfa():
    jls, _ = _states(jtopo, JaxLinkState, JaxPrefixState, "wan_like",
                     (40, 2), overloaded=("node-5",))
    pls, _ = _states(ptopo, LinkState, PrefixState, "wan_like", (40, 2),
                     overloaded=("node-5",))
    ref = TpuSpfSolver(native_rib="off", enable_lfa=True).solve(jls, "node-0")
    got = TorchSpfSolver(device="cpu", enable_lfa=True).solve(pls, "node-0")
    assert isinstance(got[1], LazyDist)
    np.testing.assert_array_equal(np.asarray(got[1]), np.asarray(ref[1]))
    np.testing.assert_array_equal(got[1][:, 0], np.asarray(ref[1])[:, 0])
    np.testing.assert_array_equal(got[2], ref[2])
    np.testing.assert_array_equal(got[4], ref[4])
    assert got[3] == ref[3]
    assert TorchSpfSolver(device="cpu").solve(pls, "node-999") is None


def _shape_state(types, mod, ls_cls, ps_cls, shape):
    """grid(3,3) states with one prefix shape outside the plain one: a
    second advertiser of node-4's loopback (multi-advertiser election), a
    UCMP weight on node-8's loopback, or none (for LFA)."""
    ls, ps = _states(mod, ls_cls, ps_cls, "grid", (3, 3))
    if shape == "multi":
        ps.update_prefix_db(types.PrefixDatabase(
            this_node_name="node-8",
            prefix_entries=(types.PrefixEntry(prefix=mod.loopback(4)),),
        ))
    elif shape == "ucmp":
        ps.update_prefix_db(types.PrefixDatabase(
            this_node_name="node-8",
            prefix_entries=(types.PrefixEntry(
                prefix=mod.loopback(8), weight=2),),
        ))
    return ls, ps


@pytest.mark.parametrize("shape", ["multi", "ucmp", "lfa"])
def test_formerly_refused_shapes_equal(shape):
    """The three shapes the first port slices refused (multi-advertiser
    election, UCMP weights, LFA assembly) give the reference's RIB."""
    from openr_tpu import types as jtypes
    from openr_tpu_torch import types as ptypes

    lfa = shape == "lfa"
    jls, jps = _shape_state(jtypes, jtopo, JaxLinkState, JaxPrefixState, shape)
    pls, pps = _shape_state(ptypes, ptopo, LinkState, PrefixState, shape)
    ref = TpuSpfSolver(native_rib="off", enable_lfa=lfa).compute_routes(
        jls, jps, "node-0"
    )
    got = TorchSpfSolver(device="cpu", enable_lfa=lfa).compute_routes(
        pls, pps, "node-0"
    )
    assert len(got.unicast_routes) == 8
    assert canon(got) == canon(ref)


def _general_prefixes(types, mod):
    """Prefixes outside the plain shape that the general path serves:
    min_nexthop met and unmet, and an advertiser not in the topology."""
    return [
        types.PrefixDatabase(
            this_node_name="node-8",
            prefix_entries=(types.PrefixEntry(
                prefix=types.IpPrefix.make("10.77.0.0/16"), min_nexthop=2),),
        ),
        types.PrefixDatabase(
            this_node_name="node-29",
            prefix_entries=(types.PrefixEntry(
                prefix=types.IpPrefix.make("10.78.0.0/16"), min_nexthop=3),),
        ),
        types.PrefixDatabase(
            this_node_name="node-999",
            prefix_entries=(types.PrefixEntry(
                prefix=types.IpPrefix.make("10.79.0.0/16")),),
        ),
    ]


@pytest.mark.parametrize("me", ["node-0", "node-14"])
def test_general_path_prefixes_equal(me):
    from openr_tpu import types as jtypes
    from openr_tpu_torch import types as ptypes

    jls, jps = _states(jtopo, JaxLinkState, JaxPrefixState, "grid", (6, 5))
    pls, pps = _states(ptopo, LinkState, PrefixState, "grid", (6, 5))
    for db in _general_prefixes(jtypes, jtopo):
        jps.update_prefix_db(db)
    for db in _general_prefixes(ptypes, ptopo):
        pps.update_prefix_db(db)
    ref = TpuSpfSolver(native_rib="off").compute_routes(jls, jps, me)
    got = TorchSpfSolver(device="cpu").compute_routes(pls, pps, me)
    assert canon(got) == canon(ref)
    have = {p.prefix for p in got.unicast_routes}
    assert "10.77.0.0/16" in have and "10.79.0.0/16" not in have

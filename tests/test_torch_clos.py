"""BASELINE config 2's shapes at a small size: a fat-tree Clos fabric
(and a hub-and-spoke fabric whose hubs take the generic relax kernel's
wide shapes, B 256 and an overflow of 128 slots) with config 2's prefix
mix — a ramp of /32s with every 4th one anycast from two nodes, the
topology's loopbacks, and one UCMP /24 per pod from two ToRs at weights
1 and 3 — through `TorchSpfSolver(device="cpu")` and
`TpuSpfSolver(native_rib="off")` from a core, an aggregation and a hub
root: equal RouteDatabases, unicast and MPLS, with the election on its
NumPy path and on the device twin (`elect_device_min = 0`)."""

import pytest
import torch

from openr_tpu.decision.spf_backend import TpuSpfSolver
from openr_tpu_torch import TorchSpfSolver
from openr_tpu_torch.ops.spf_split import build_split_tables
from tests.test_torch_routes import JAX, PORT, canon

# one intra-op thread: the suite runs several test workers at once
torch.set_num_threads(1)


def fat_tree_ucmp(k):
    """One UCMP /24 per pod of `fat_tree(k)`: its ToRs 0 and 1 at
    weights 1 and 3."""
    half = k // 2
    tor0 = half * half + k * half
    return [(f"20.{p}.0.0/24",
             ((tor0 + p * half, 1), (tor0 + p * half + 1, 3)))
            for p in range(k)]


def config2_states(pkg, topo, n_ramp, ucmp):
    """(LinkState, PrefixState) of config 2's mix on `topo(pkg)` = (adj
    dbs, loopback prefix dbs): `ramp_prefix_state(names, n_ramp,
    anycast_every=4)`, then the loopbacks and the UCMP /24s `ucmp` =
    [(prefix, ((node index, weight), ...))] added with
    `update_prefix_db`."""
    t = pkg.t
    adj, pfx = topo(pkg)
    ls = pkg.ls()
    for db in adj:
        ls.update_adjacency_db(db)
    names = [db.this_node_name for db in adj]
    ps = pkg.topo.ramp_prefix_state(names, n_ramp, anycast_every=4)
    for db in pfx:
        ps.update_prefix_db(db)
    for prefix, advs in ucmp:
        for node, w in advs:
            ps.update_prefix_db(t.PrefixDatabase(
                this_node_name=names[node],
                prefix_entries=(t.PrefixEntry(
                    prefix=t.IpPrefix.make(prefix), weight=w),),
            ))
    return ls, ps


FAT8 = (lambda pkg: pkg.topo.fat_tree(8, metric=10), 400, fat_tree_ucmp(8))
HUB = (lambda pkg: pkg.topo.hub_and_spoke(2, 130), 400,
       [(f"20.{i}.0.0/24", ((2 + 2 * i, 1), (3 + 2 * i, 3)))
        for i in range(10)])


@pytest.mark.parametrize("elect_min", [None, 0])
@pytest.mark.parametrize("case,me", [
    (FAT8, "node-0"),    # a core switch
    (FAT8, "node-16"),   # an aggregation switch
    (HUB, "node-0"),     # a hub: B 256, overflow of 128 slots
])
def test_config2_mix_equals_jax(case, me, elect_min):
    topo, n_ramp, ucmp = case
    jls, jps = config2_states(JAX, topo, n_ramp, ucmp)
    pls, pps = config2_states(PORT, topo, n_ramp, ucmp)
    ref = TpuSpfSolver(native_rib="off").compute_routes(jls, jps, me)
    solver = TorchSpfSolver(device="cpu")
    if elect_min is not None:
        solver.elect_device_min = elect_min
    got = solver.compute_routes(pls, pps, me)
    assert canon(got) == canon(ref)
    assert solver.elect_stats["multi"] == n_ramp // 4
    assert (solver.elect_stats["device_elections"] > 0) == (elect_min == 0)
    ucmp_routes = [e for p, e in got.unicast_routes.items()
                   if p.prefix.startswith("20.")]
    assert len(ucmp_routes) == len(ucmp)
    # from a core every pod lies behind one aggregation switch; from an
    # aggregation switch or a hub the two advertisers are direct
    # neighbors, so the weights 1 and 3 show
    weighted = [e for e in ucmp_routes
                if len({nh.weight for nh in e.nexthops}) > 1]
    assert bool(weighted) == (case is HUB or me != "node-0")
    assert got.mpls_routes


def test_hub_shapes_are_the_wide_ones():
    """The hub fabric's split tables are the shapes the CPU run is meant
    to cover: B 256 at a hub root and an overflow table of 128 slots."""
    ls, _ps = config2_states(PORT, *HUB)
    csr = ls.to_csr()
    t = build_split_tables(csr.edge_src, csr.edge_dst, csr.edge_metric,
                           csr.num_nodes)
    assert t["ov_nbr"].shape[1] == 128
    nbrs = {d for (s, d) in csr.adj_details if s == csr.name_to_id["node-0"]}
    assert len(nbrs) == 131

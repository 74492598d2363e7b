"""The port's KSP (`openr_tpu_torch/ops/ksp.py`, on the CPU through the
plain versions of its two kernels) is byte-equal to the JAX package's
`ksp_edge_disjoint_dense` (costs, paths, hops) on the cases of
`tests/test_ksp_kernel.py`; its dense tables, path decoding and route
construction equal the JAX ones; each kernel step's plain version is
checked step by step against an unpacked recomputation; the SSSP to
fixpoint equals the host-read loop of single sweeps (sweep count
included) and scipy's Dijkstra on the masked graph; the device round
words skip every round after an empty one, with rounds and sweeps
counted as a host-read round loop counts them; and the dense `wgt`
after a patch-journal scatter equals fresh tables of the patched CSR."""

import dataclasses
import enum
from dataclasses import replace

import numpy as np
import pytest
import torch

from openr_tpu.decision.ksp import k_edge_disjoint_paths
from openr_tpu.decision.ksp import ksp_route_from_paths as jax_route
from openr_tpu.ops import ksp as jksp
from openr_tpu.ops.spf import build_dense_tables as jax_dense
from openr_tpu_torch import LinkState, TorchSpfSolver
from openr_tpu_torch.decision.ksp import ksp_route_from_paths
from openr_tpu_torch.ops import ksp
from openr_tpu_torch.ops.spf import build_dense_tables, pad_batch

INF = 1 << 30
N = 24  # nodes of the random KSP graphs (`tests/test_ksp_kernel.py`'s)

# one intra-op thread: the suite runs several test workers at once
torch.set_num_threads(1)


def random_graph(rng, n, p=0.25, max_metric=10):
    """Random symmetric-connectivity digraph with asymmetric metrics:
    (oracle adjacency, dst-sorted edge arrays, names)."""
    names = [f"n{i:03d}" for i in range(n)]
    adj = {nm: {} for nm in names}
    edges = []
    for i in range(n):
        for j in range(i + 1, n):
            if rng.random() < p:
                w_ij = int(rng.integers(1, max_metric + 1))
                w_ji = int(rng.integers(1, max_metric + 1))
                adj[names[i]][names[j]] = w_ij
                adj[names[j]][names[i]] = w_ji
                edges.append((i, j, w_ij))
                edges.append((j, i, w_ji))
    edges.sort(key=lambda e: (e[1], e[0]))
    arrs = tuple(
        np.array([e[c] for e in edges], dtype=np.int32) for c in range(3)
    )
    return adj, arrs, names


def _plain(x):
    if isinstance(x, dict):
        return tuple(sorted((_plain(k), _plain(v)) for k, v in x.items()))
    if isinstance(x, (list, tuple)):
        return tuple(_plain(v) for v in x)
    if isinstance(x, enum.Enum):
        return int(x.value)
    return x


def pad_dests(dests, root_id):
    out = np.full(pad_batch(len(dests)), root_id, dtype=np.int32)
    out[: len(dests)] = dests
    return out


def _case(seed):
    rng = np.random.default_rng(seed)
    adj, (src, dst, met), names = random_graph(rng, N)
    nbr, wgt = build_dense_tables(src, dst, met, N)
    over_ids = sorted(rng.choice(N, size=2, replace=False))
    over = np.zeros(N, dtype=bool)
    over[over_ids] = True
    dests = np.array(
        sorted(rng.choice(np.arange(1, N), size=8, replace=False)),
        dtype=np.int32,
    )
    blocked = ksp.build_ksp_blocked(nbr, over, 0)
    return adj, names, nbr, wgt, blocked, over, pad_dests(dests, 0), dests


def _assert_equal(got, ref):
    for g, r in zip(got, ref):
        assert g.dtype == torch.int32
        np.testing.assert_array_equal(g.numpy(), np.asarray(r))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_build_dense_tables_equals_jax(seed):
    rng = np.random.default_rng(seed)
    _adj, (src, dst, met), _names = random_graph(rng, 40, p=0.3)
    for vp in (40, 64):
        got = build_dense_tables(src, dst, met, vp)
        ref = jax_dense(src, dst, met, vp)
        for g, r in zip(got, ref):
            np.testing.assert_array_equal(g, r)
    # no edges at all
    empty = np.zeros(0, np.int32)
    for g, r in zip(build_dense_tables(empty, empty, empty, 16),
                    jax_dense(empty, empty, empty, 16)):
        np.testing.assert_array_equal(g, r)


@pytest.mark.parametrize("dist0", [False, True])
@pytest.mark.parametrize("k", [2, 4, 16])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_ksp_equals_jax(k, seed, dist0):
    adj, names, nbr, wgt, blocked, over, dests, real = _case(seed)
    d0 = None
    if dist0:
        # the unbanned distances from root 0 (as the solve gives them)
        c1, _p, _h = jksp.ksp_edge_disjoint_dense(
            nbr, wgt, blocked, np.int32(0), np.arange(N, dtype=np.int32),
            k=1, max_hops=N - 1,
        )
        d0 = np.asarray(c1[0]).astype(np.int32)
        d0[0] = 0
    ref = jksp.ksp_edge_disjoint_dense(
        nbr, wgt, blocked, np.int32(0), dests, k=k, max_hops=N - 1,
        dist0=d0,
    )
    stats: dict = {}
    got = ksp.ksp_edge_disjoint_dense(
        nbr, wgt, blocked, np.int32(0), dests, k=k, max_hops=N - 1,
        dist0=d0, device="cpu", stats=stats,
    )
    _assert_equal(got, ref)
    assert stats["rounds"] >= 1 and stats["sweeps"] >= (0 if dist0 else 1)
    # and the oracle's successive host re-solves
    overloaded = {names[i] for i in np.nonzero(over)[0]}
    costs, paths = got[0].numpy(), got[1].numpy()
    for b, dest_id in enumerate(real):
        want = k_edge_disjoint_paths(adj, names[0], [names[dest_id]],
                                     overloaded, k=k)
        assert ksp.paths_to_host(costs, paths, names, b) == want


def _line_tables(n, edges):
    edges = sorted(edges, key=lambda e: (e[1], e[0]))
    cols = [np.array([e[c] for e in edges], np.int32) for c in range(3)]
    return build_dense_tables(*cols, n)


def test_ksp_root_and_unreachable_equals_jax():
    """dest == root and a dest in another component: no path."""
    edges = []
    for base in (0, 6):
        for i in range(base, base + 5):
            edges += [(i, i + 1, 1), (i + 1, i, 1)]
    nbr, wgt = _line_tables(12, edges)
    blocked = ksp.build_ksp_blocked(nbr, np.zeros(12, bool), 0)
    dests = np.array([0, 8], dtype=np.int32)
    ref = jksp.ksp_edge_disjoint_dense(
        nbr, wgt, blocked, np.int32(0), dests, k=4, max_hops=11
    )
    got = ksp.ksp_edge_disjoint_dense(
        nbr, wgt, blocked, 0, dests, k=4, max_hops=11, device="cpu"
    )
    _assert_equal(got, ref)
    assert (got[0] >= INF).all()


def test_ksp_parallel_capacity_line_equals_jax():
    """A 4-node ladder: exactly 2 edge-disjoint paths; round 3 finds none
    and ends the call."""
    names = ["a", "b", "c", "d"]
    edges = [(0, 1, 1), (0, 2, 1), (1, 0, 1), (1, 3, 1), (2, 0, 1),
             (2, 3, 1), (3, 1, 1), (3, 2, 1)]
    nbr, wgt = _line_tables(4, edges)
    blocked = ksp.build_ksp_blocked(nbr, np.zeros(4, bool), 0)
    args = (nbr, wgt, blocked, np.int32(0), np.array([3], np.int32))
    ref = jksp.ksp_edge_disjoint_dense(*args, k=4, max_hops=3)
    stats: dict = {}
    got = ksp.ksp_edge_disjoint_dense(*args, k=4, max_hops=3, device="cpu",
                                      stats=stats)
    _assert_equal(got, ref)
    assert stats["rounds"] == 3  # the early exit
    got_h = ksp.paths_to_host(got[0].numpy(), got[1].numpy(), names, 0)
    assert got_h == [(2, ["a", "b", "d"]), (2, ["a", "c", "d"])]
    assert got_h == jksp.paths_to_host(
        np.asarray(ref[0]), np.asarray(ref[1]), names, 0
    )


def test_ksp_max_hops_cut_equals_jax():
    """A walk that runs out of max_hops fails, as the reference's."""
    edges = []
    for i in range(7):
        edges += [(i, i + 1, 1), (i + 1, i, 1)]
    nbr, wgt = _line_tables(8, edges)
    blocked = ksp.build_ksp_blocked(nbr, np.zeros(8, bool), 0)
    args = (nbr, wgt, blocked, np.int32(0), np.array([3, 7], np.int32))
    _assert_equal(
        ksp.ksp_edge_disjoint_dense(*args, k=2, max_hops=4, device="cpu"),
        jksp.ksp_edge_disjoint_dense(*args, k=2, max_hops=4),
    )


def _step_case(seed, v=64, d=8, b=40):
    rng = np.random.default_rng(seed)
    nbr = rng.integers(0, v, (v, d)).astype(np.int32)
    wgt = rng.integers(1, 9, (v, d)).astype(np.int32)
    wgt[rng.random((v, d)) < 0.2] = INF
    blocked = rng.random((v, d)) < 0.1
    banned = rng.random((v, d, b)) < 0.15
    dist = rng.integers(0, 60, (v, b)).astype(np.int32)
    dist[rng.random((v, b)) < 0.3] = INF
    return nbr, wgt, blocked, banned, dist


@pytest.mark.parametrize("seed", [0, 1])
def test_relax_sweep_ref_equals_unpacked_sweep(seed):
    nbr, wgt, blocked, banned, dist = _step_case(seed)
    t = torch.from_numpy
    out = torch.empty_like(t(dist))
    changed = torch.zeros(1, dtype=torch.int32)
    bans = ksp.pack_bans(t(banned))
    np.testing.assert_array_equal(ksp.unpack_bans(bans, 40).numpy(), banned)
    ksp.ksp_relax(t(dist), out, t(nbr), t(wgt), t(blocked), bans, changed)
    # the reference's one sweep on bools, in int64
    g = dist.astype(np.int64)[nbr]  # [v, d, b]
    usable = ~blocked[:, :, None] & ~banned & (wgt[:, :, None] < INF) & (
        g < INF
    )
    cand = np.where(usable, np.minimum(g + wgt[:, :, None], INF), INF)
    want = np.minimum(cand.min(axis=1), dist)
    np.testing.assert_array_equal(out.numpy(), want)
    assert int(changed.item()) == int((want < dist).any()) == 1


def test_ban_words_round_trip_every_bit():
    banned = torch.zeros(2, 3, 70, dtype=torch.bool)
    banned[0, 1, 31] = banned[1, 2, 32] = banned[1, 0, 69] = True
    banned[0, 0, :] = True
    words = ksp.pack_bans(banned)
    assert words.shape == (2, 3, 3) and words.dtype == torch.int32
    assert int(words[0, 1, 0]) == -(1 << 31)  # bit 31: the sign bit
    assert int(words[0, 0, 2]) == (1 << 6) - 1
    assert torch.equal(ksp.unpack_bans(words, 70), banned)


def test_wrappers_check_inputs():
    nbr, wgt, blocked, banned, dist = _step_case(0, b=8)
    t = torch.from_numpy
    bans = ksp.pack_bans(t(banned))
    out = torch.empty_like(t(dist))
    ch = torch.zeros(1, dtype=torch.int32)
    with pytest.raises(TypeError):
        ksp.ksp_relax(t(dist).long(), out, t(nbr), t(wgt), t(blocked), bans, ch)
    with pytest.raises(ValueError):  # bans for the wrong job count
        ksp.ksp_relax(t(dist), out, t(nbr), t(wgt), t(blocked),
                      torch.zeros(64, 8, 2, dtype=torch.int32), ch)
    with pytest.raises(ValueError):
        ksp.ksp_walk(t(dist), t(nbr), t(wgt), t(blocked), bans,
                     torch.zeros(4, dtype=torch.int32), 0, 5,
                     torch.zeros(8, dtype=torch.int32),
                     torch.zeros(8, 6, dtype=torch.int32),
                     torch.zeros(8, dtype=torch.int32), ch)
    before = dict(ksp.LAUNCHES)
    ksp.ksp_relax(t(dist), out, t(nbr), t(wgt), t(blocked), bans, ch)
    assert ksp.LAUNCHES == before  # CPU: the plain version, no kernel
    # arrays, no device: the card, which this host lacks
    with pytest.raises((RuntimeError, AssertionError)):
        ksp.ksp_edge_disjoint_dense(nbr, wgt, blocked, 0,
                                    np.zeros(8, np.int32), k=1, max_hops=3)


def test_paths_to_host_and_route_equal_jax():
    from openr_tpu.decision.linkstate import LinkState as JaxLinkState
    from openr_tpu.types import topology as jt
    from openr_tpu.types.network import IpPrefix as JIp
    from openr_tpu.utils import topogen as jtopo
    from openr_tpu_torch.types import topology as pt
    from openr_tpu_torch.types.network import IpPrefix as PIp
    from openr_tpu_torch.utils import topogen as ptopo

    adj_j, _ = jtopo.ring(6)
    adj_p, _ = ptopo.ring(6)
    jls, pls = JaxLinkState(), LinkState()
    for db in adj_j:
        jls.update_adjacency_db(db)
    for db in adj_p:
        pls.update_adjacency_db(db)
    names = pls.to_csr().node_names
    costs = np.array([[3, INF], [5, INF]], np.int32)
    paths = np.full((2, 2, 6), -1, np.int32)
    ids = {n: i for i, n in enumerate(names)}
    paths[0, 0, :4] = [ids[n] for n in ("node-3", "node-2", "node-1", "node-0")]
    paths[1, 0, :4] = [ids[n] for n in ("node-3", "node-4", "node-5", "node-0")]
    got = ksp.paths_to_host(costs, paths, names, 0)
    assert got == jksp.paths_to_host(costs, paths, names, 0)
    assert ksp.paths_to_host(costs, paths, names, 1) == []
    for min_nh in (0, 2, 3):
        pe = pt.PrefixEntry(
            prefix=PIp.make("10.9.0.0/16"),
            forwarding_type=pt.ForwardingType.SR_MPLS,
            forwarding_algorithm=pt.ForwardingAlgorithm.KSP2_ED_ECMP,
            min_nexthop=min_nh,
        )
        je = jt.PrefixEntry(
            prefix=JIp.make("10.9.0.0/16"),
            forwarding_type=jt.ForwardingType.SR_MPLS,
            forwarding_algorithm=jt.ForwardingAlgorithm.KSP2_ED_ECMP,
            min_nexthop=min_nh,
        )
        a = ksp_route_from_paths(pls, "node-0", pe.prefix, {"node-3": pe},
                                 ["node-3"], got)
        b = jax_route(jls, "node-0", je.prefix, {"node-3": je}, ["node-3"],
                      got)
        assert (a is None) == (b is None) == (min_nh == 3)
        if a is not None:
            assert _plain(dataclasses.asdict(a)) == _plain(dataclasses.asdict(b))
            assert len(a.nexthops) == 2


def test_dense_wgt_after_patch_scatter_equals_fresh_tables():
    """Metric-only churn: the solver's cached dense set, patched by the
    journal suffix (duplicate slots included), equals the dense tables of
    the patched CSR built from scratch; so does the CSR's own copy."""
    from openr_tpu_torch.utils import topogen as ptopo

    adj, _ = ptopo.wan_like(40, 3)
    ls = LinkState()
    for db in adj:
        ls.update_adjacency_db(db)
    solver = TorchSpfSolver(device="cpu")
    base = ls.to_csr()
    base.dense_tables()  # the base carries its tables into patched views
    solver._device_arrays(base, "dense")
    rng = np.random.default_rng(4)
    for rnd in range(3):
        for _ in range(3):
            node = ls.nodes[int(rng.integers(len(ls.nodes)))]
            db = ls.adjacency_db(node)
            adjs = list(db.adjacencies)
            i = int(rng.integers(len(adjs)))
            adjs[i] = replace(
                adjs[i], metric=adjs[i].metric + int(rng.integers(1, 20)))
            changed, _pairs = ls.update_adjacency_db_delta(
                replace(db, adjacencies=tuple(adjs)))
            assert changed
        csr = ls.to_csr()
        assert csr.base_version == base.version and len(csr.patches) > 0
        dev = solver._device_arrays(csr, "dense")
        fresh = build_dense_tables(csr.edge_src, csr.edge_dst,
                                   csr.edge_metric, csr.padded_nodes)
        np.testing.assert_array_equal(dev["nbr"].numpy(), fresh[0])
        np.testing.assert_array_equal(dev["wgt"].numpy(), fresh[1])
        np.testing.assert_array_equal(csr.dense_tables()[1], fresh[1])
    assert solver.dev_cache_stats["uploads"] == 1
    assert solver.dev_cache_stats["patches"] == 3


@pytest.mark.parametrize("topo", ["grid", "fat_tree"])
def test_jax_csr_dense_tables_carried_across(topo):
    """A JAX CsrGraph's dense tables, carried into the port's CsrGraph,
    are the arrays both packages' KSP read, and the two KSPs agree on
    them (overloads included)."""
    from openr_tpu.decision.linkstate import LinkState as JaxLinkState
    from openr_tpu.utils import topogen as jtopo
    from openr_tpu_torch.convert import csr_from_numpy

    adj, _ = getattr(jtopo, topo)(*((4, 4) if topo == "grid" else (4,)))
    jls = JaxLinkState()
    for i, db in enumerate(adj):
        jls.update_adjacency_db(replace(db, is_overloaded=i == 5))
    jcsr = jls.to_csr()
    jnbr, jwgt = jcsr.dense_tables()
    pcsr = csr_from_numpy(
        num_nodes=jcsr.num_nodes, num_edges=jcsr.num_edges,
        edge_src=jcsr.edge_src, edge_dst=jcsr.edge_dst,
        edge_metric=jcsr.edge_metric, node_overloaded=jcsr.node_overloaded,
        node_mask=jcsr.node_mask, node_names=jcsr.node_names,
        adj_details=jcsr.adj_details, dense_tables=(jnbr, jwgt),
    )
    nbr, wgt = pcsr.dense_tables()
    np.testing.assert_array_equal(nbr, jnbr)
    np.testing.assert_array_equal(wgt, jwgt)
    fresh = build_dense_tables(pcsr.edge_src, pcsr.edge_dst,
                               pcsr.edge_metric, pcsr.padded_nodes)
    np.testing.assert_array_equal(fresh[1], wgt)
    blocked = ksp.build_ksp_blocked(nbr, pcsr.node_overloaded, 0)
    dests = pad_dests(np.arange(1, jcsr.num_nodes, 3, dtype=np.int32), 0)
    max_hops = jcsr.padded_nodes - 1
    ref = jksp.ksp_edge_disjoint_dense(
        jnbr, jwgt, jksp.build_ksp_blocked(jnbr, jcsr.node_overloaded, 0),
        np.int32(0), dests, k=4, max_hops=max_hops,
    )
    got = ksp.ksp_edge_disjoint_dense(
        nbr, wgt, blocked, 0, dests, k=4, max_hops=max_hops, device="cpu"
    )
    _assert_equal(got, ref)


# ------------------------------------------------- the SSSP to fixpoint


def _host_read_sssp(dist, nbr, wgt, blocked, bans, cap):
    """The host-driven loop the device fixpoint replaces: one plain sweep
    per step, one read of its changed flag; (fixpoint, sweeps)."""
    other = torch.empty_like(dist)
    changed = torch.zeros(1, dtype=torch.int32)
    sweeps = 0
    for _ in range(cap):
        ksp.ksp_relax_ref(dist, other, nbr, wgt, blocked, bans, changed)
        dist, other = other, dist
        sweeps += 1
        if not int(changed.item()):
            break
    return dist, sweeps


def _scipy_masked(nbr, wgt, blocked, banned, root):
    """scipy's Dijkstra from `root` per job on the graph of the slots
    usable for that job (parallel slots: the lightest): [V, B] int."""
    from scipy.sparse import csr_matrix
    from scipy.sparse.csgraph import dijkstra

    v, d = nbr.shape
    out = np.empty((v, banned.shape[2]), np.int64)
    for b in range(banned.shape[2]):
        usable = (wgt < INF) & ~blocked & ~banned[:, :, b]
        best = {}
        for row, slot in zip(*np.nonzero(usable)):
            key = (int(nbr[row, slot]), int(row))
            best[key] = min(best.get(key, INF), int(wgt[row, slot]))
        src = np.array([k[0] for k in best], np.int64)
        dst = np.array([k[1] for k in best], np.int64)
        w = np.array(list(best.values()), np.float64)
        g = csr_matrix((w, (src, dst)), shape=(v, v))
        dd = dijkstra(g, directed=True, indices=[root])[0]
        out[:, b] = np.where(np.isinf(dd), INF, dd)
    return out


@pytest.mark.parametrize("d", [8, 40])
@pytest.mark.parametrize("b", [8, 40, 64])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_sssp_fixpoint_equals_host_loop_and_dijkstra(seed, b, d):
    nbr, wgt, blocked, banned, _dist = _step_case(seed, v=64, d=d, b=b)
    t = torch.from_numpy
    tab = (t(nbr), t(wgt), t(blocked), ksp.pack_bans(t(banned)))
    root = seed + 3
    start = torch.full((64, b), INF, dtype=torch.int32)
    start[root] = 0
    want, want_sweeps = _host_read_sssp(start, *tab, cap=64)
    counters = torch.zeros(2, dtype=torch.int32)
    got = ksp.ksp_sssp(None, *tab, root, b, max_sweeps=64,
                       live=torch.ones(1, dtype=torch.int32),
                       counters=counters)
    np.testing.assert_array_equal(got.numpy(), want.numpy())
    assert counters.tolist() == [0, want_sweeps] and want_sweeps >= 2
    np.testing.assert_array_equal(
        got.numpy(), _scipy_masked(nbr, wgt, blocked, banned, root))


@pytest.mark.parametrize("d", [512, 2048])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_sssp_fixpoint_hub_rows_equals_host_loop_and_dijkstra(seed, d):
    """Rows far wider than a warp's staging on the card (hubs of D 512
    and 2048 slots, every 8th row; the others keep 8 slots): the
    fixpoint equals the host-read loop, sweep count included, and
    scipy's Dijkstra."""
    b, v = 8, 64
    nbr, wgt, blocked, banned, _dist = _step_case(seed, v=v, d=d, b=b)
    wgt[(np.arange(v) % 8 != 0)[:, None] & (np.arange(d) >= 8)[None, :]] = INF
    t = torch.from_numpy
    tab = (t(nbr), t(wgt), t(blocked), ksp.pack_bans(t(banned)))
    root = 2 * seed + 1
    start = torch.full((v, b), INF, dtype=torch.int32)
    start[root] = 0
    want, want_sweeps = _host_read_sssp(start, *tab, cap=v)
    counters = torch.zeros(2, dtype=torch.int32)
    got = ksp.ksp_sssp(None, *tab, root, b, max_sweeps=v, counters=counters)
    np.testing.assert_array_equal(got.numpy(), want.numpy())
    assert counters.tolist() == [0, want_sweeps] and want_sweeps >= 2
    np.testing.assert_array_equal(
        got.numpy(), _scipy_masked(nbr, wgt, blocked, banned, root))


@pytest.mark.parametrize("k", [2, 16])
def test_ksp_hub_rows_equal_jax(k):
    """`hub_and_spoke(2, 300)`: each hub's row has 301 slots (D 512), wider
    than a warp's staging on the card at 40 jobs; from a spoke to 40
    spokes, k rounds (2 edge-disjoint paths, so round 3 ends a k = 16
    call), equal to the JAX package's."""
    from openr_tpu.decision.linkstate import LinkState as JaxLinkState
    from openr_tpu.utils import topogen as jtopo

    adj, _ = jtopo.hub_and_spoke(2, 300)
    jls = JaxLinkState()
    for db in adj:
        jls.update_adjacency_db(db)
    csr = jls.to_csr()
    nbr, wgt = csr.dense_tables()
    assert nbr.shape[1] == 512
    root = csr.name_to_id[adj[5].this_node_name]
    blocked = ksp.build_ksp_blocked(nbr, csr.node_overloaded, root)
    dests = pad_dests(np.arange(10, 290, 7, dtype=np.int32), root)
    max_hops = csr.padded_nodes - 1
    ref = jksp.ksp_edge_disjoint_dense(nbr, wgt, blocked, np.int32(root),
                                       dests, k=k, max_hops=max_hops)
    stats: dict = {}
    got = ksp.ksp_edge_disjoint_dense(nbr, wgt, blocked, root, dests, k=k,
                                      max_hops=max_hops, device="cpu",
                                      stats=stats)
    _assert_equal(got, ref)
    assert stats["rounds"] == min(k, 3)
    assert int((got[0][1] < INF).sum()) == 40


def _line(n):
    """A line 0 - 1 - ... - n-1 of unit metrics as dense tables."""
    edges = []
    for i in range(n - 1):
        edges += [(i, i + 1, 1), (i + 1, i, 1)]
    return _line_tables(n, edges)


@pytest.mark.parametrize("from_dist0", [False, True])
@pytest.mark.parametrize("max_sweeps", [1, 2, 3])
def test_sssp_max_sweeps_runs_exactly_that_many(max_sweeps, from_dist0):
    """A cap below the fixpoint's sweep count: exactly `max_sweeps`
    Jacobi sweeps of `ksp_relax_ref`, counted."""
    nbr, wgt = _line(12)
    t = torch.from_numpy
    blocked = torch.zeros(nbr.shape, dtype=torch.bool)
    bans = torch.zeros((*nbr.shape, 1), dtype=torch.int32)
    tab = (t(nbr), t(wgt), blocked, bans)
    dist = torch.full((12, 8), INF, dtype=torch.int32)
    dist[0] = 0
    dist0 = None
    if from_dist0:  # one sweep in already, a job that started elsewhere
        dist[1] = 1
        dist[5, 3] = 0
        dist0 = dist.clone()
    want = dist.clone()
    changed = torch.zeros(1, dtype=torch.int32)
    for _ in range(max_sweeps):
        out = torch.empty_like(want)
        ksp.ksp_relax_ref(want, out, *tab, changed)
        assert int(changed.item()) == 1
        want = out
    counters = torch.zeros(2, dtype=torch.int32)
    got = ksp.ksp_sssp(dist0, *tab, 0, 8, max_sweeps=max_sweeps,
                       counters=counters)
    assert torch.equal(got, want) and int(counters[1]) == max_sweeps
    if dist0 is not None:
        assert torch.equal(dist0, dist)  # the start is left as it is


def _host_read_rounds(nbr, wgt, blocked, root, dests, k, max_hops, dist0):
    """The host-driven round loop: each SSSP by `_host_read_sssp`, one
    read of the walk's flag per round; (costs, paths, hops, rounds,
    sweeps)."""
    t = torch.from_numpy
    nbr, wgt, blocked, dests = t(nbr), t(wgt), t(blocked), t(dests)
    v, b = nbr.shape[0], dests.shape[0]
    bans = torch.zeros((v, nbr.shape[1], ksp.ban_words(b)), dtype=torch.int32)
    costs = torch.full((k, b), INF, dtype=torch.int32)
    paths = torch.full((k, b, max_hops + 1), -1, dtype=torch.int32)
    hops = torch.zeros((k, b), dtype=torch.int32)
    ok = torch.zeros(1, dtype=torch.int32)
    rounds = sweeps = 0
    for i in range(k):
        if i == 0 and dist0 is not None:
            dist = t(dist0)[:, None].expand(v, b).contiguous()
        else:
            start = torch.full((v, b), INF, dtype=torch.int32)
            start[root] = 0
            dist, n = _host_read_sssp(start, nbr, wgt, blocked, bans, v)
            sweeps += n
        ksp.ksp_walk_ref(dist, nbr, wgt, blocked, bans, dests, root,
                         max_hops, costs[i], paths[i], hops[i], ok)
        rounds += 1
        if not int(ok.item()):
            break
    return costs, paths, hops, rounds, sweeps


@pytest.mark.parametrize("dist0", [False, True])
@pytest.mark.parametrize("case", ["line", "ladder"])
def test_round_words_skip_every_round_after_an_empty_one(case, dist0,
                                                         monkeypatch):
    """k = 16 on graphs with 1 (a line: round 2 finds nothing) and 2 (the
    parallel-capacity ladder: round 3 finds nothing) edge-disjoint paths:
    no sweep runs after the empty round, the device counters equal the
    host-read loop's rounds and sweeps, and the outputs equal it and the
    JAX package's."""
    if case == "line":
        nbr, wgt = _line(5)
        dests, n_paths = np.array([4, 2], np.int32), 1
    else:
        nbr, wgt = _line_tables(4, [
            (0, 1, 1), (0, 2, 1), (1, 0, 1), (1, 3, 1), (2, 0, 1),
            (2, 3, 1), (3, 1, 1), (3, 2, 1)])
        dests, n_paths = np.array([3], np.int32), 2
    v = nbr.shape[0]
    blocked = ksp.build_ksp_blocked(nbr, np.zeros(v, bool), 0)
    d0 = None
    if dist0:
        start = torch.full((v, 1), INF, dtype=torch.int32)
        start[0] = 0
        fix, _n = _host_read_sssp(start, torch.from_numpy(nbr),
                                  torch.from_numpy(wgt),
                                  torch.from_numpy(blocked),
                                  torch.zeros((*nbr.shape, 1),
                                              dtype=torch.int32), v)
        d0 = fix[:, 0].numpy().copy()
    args = (nbr, wgt, blocked, np.int32(0), dests)
    want = _host_read_rounds(*args[:3], 0, dests, 16, v - 1, d0)
    assert want[3] == n_paths + 1  # the empty round ends the loop
    sweeps_run = []
    plain = ksp.ksp_relax_ref

    def counted(*a):
        sweeps_run.append(1)
        return plain(*a)

    monkeypatch.setattr(ksp, "ksp_relax_ref", counted)
    stats: dict = {}
    got = ksp.ksp_edge_disjoint_dense(*args, k=16, max_hops=v - 1,
                                      dist0=d0, device="cpu", stats=stats)
    assert stats == {"rounds": want[3], "sweeps": want[4], "host_reads": 1}
    assert len(sweeps_run) == want[4]
    _assert_equal(got, want[:3])
    _assert_equal(got, jksp.ksp_edge_disjoint_dense(
        *args, k=16, max_hops=v - 1, dist0=d0))


def test_host_reads_one_per_call_and_to_host():
    _adj, _names, nbr, wgt, blocked, _over, dests, _real = _case(0)
    kw = dict(k=4, max_hops=N - 1, device="cpu")
    stats: dict = {}
    dev = ksp.ksp_edge_disjoint_dense(nbr, wgt, blocked, 0, dests,
                                      stats=stats, **kw)
    assert stats["host_reads"] == 1
    host = ksp.ksp_edge_disjoint_dense(nbr, wgt, blocked, 0, dests,
                                       stats=stats, to_host=True, **kw)
    assert stats["host_reads"] == 2 and stats["rounds"] >= 2
    for g, h in zip(dev, host):
        assert isinstance(h, np.ndarray) and h.dtype == np.int32
        np.testing.assert_array_equal(g.numpy(), h)
    none: dict = {}
    ksp.ksp_edge_disjoint_dense(nbr, wgt, blocked, 0, dests, **kw)
    assert none == {}


def test_walk_ref_honours_its_round_word():
    nbr, wgt, blocked, banned, _dist = _step_case(3, b=8)
    t = torch.from_numpy
    bans = ksp.pack_bans(t(banned))
    dist, _n = _host_read_sssp(
        torch.where(torch.arange(64)[:, None] == 2, 0, INF).to(torch.int32)
        .expand(64, 8).contiguous(), t(nbr), t(wgt), t(blocked), bans, 64)
    dests = torch.arange(8, dtype=torch.int32) + 10
    outs = [torch.full((8,), 5, dtype=torch.int32),
            torch.full((8, 64), -1, dtype=torch.int32),
            torch.full((8,), 5, dtype=torch.int32)]
    counters = torch.zeros(2, dtype=torch.int32)
    ok = torch.ones(1, dtype=torch.int32)
    before = bans.clone()
    ksp.ksp_walk(dist, t(nbr), t(wgt), t(blocked), bans, dests, 2, 63, *outs,
                 ok, live=torch.zeros(1, dtype=torch.int32), counters=counters)
    assert int(ok) == 0 and counters.tolist() == [0, 0]
    assert torch.equal(bans, before) and int(outs[0][0]) == 5
    ksp.ksp_walk(dist, t(nbr), t(wgt), t(blocked), bans, dests, 2, 63, *outs,
                 ok, live=torch.ones(1, dtype=torch.int32), counters=counters)
    assert int(ok) == 1 and counters.tolist() == [1, 0]
    assert not torch.equal(bans, before) and (outs[0] < INF).any()


def test_sssp_wrapper_checks_inputs():
    nbr, wgt, blocked, banned, dist = _step_case(0, b=8)
    t = torch.from_numpy
    tab = (t(nbr), t(wgt), t(blocked), ksp.pack_bans(t(banned)))
    with pytest.raises(ValueError):  # dist0 of the wrong width
        ksp.ksp_sssp(t(dist)[:, :4].contiguous(), *tab, 0, 8, max_sweeps=3)
    with pytest.raises(ValueError):
        ksp.ksp_sssp(None, *tab, 64, 8, max_sweeps=3)  # root outside V
    with pytest.raises(ValueError):
        ksp.ksp_sssp(None, *tab, 0, 8, max_sweeps=0)
    with pytest.raises(ValueError):  # counters must be [rounds, sweeps]
        ksp.ksp_sssp(None, *tab, 0, 8, max_sweeps=3,
                     counters=torch.zeros(3, dtype=torch.int32))
    with pytest.raises(TypeError):
        ksp.ksp_sssp(None, *tab, 0, 8, max_sweeps=3,
                     live=torch.ones(1, dtype=torch.int64))
    before = dict(ksp.LAUNCHES)
    ksp.ksp_sssp(None, *tab, 0, 8, max_sweeps=3)
    assert ksp.LAUNCHES == before  # CPU: the plain version, no kernel


# ------------------------------------- the kernel's schedule, on the CPU


def _model_case(seed, v=96, d=8, b=40):
    """Random tables with ~5% bans, overloads (blocked slots), rows with
    no usable slot (unreachable), and hub rows (every 16th row with all
    of its slots): (nbr, wgt, blocked, banned) as arrays."""
    rng = np.random.default_rng(100 + seed)
    nbr = rng.integers(0, v, (v, d)).astype(np.int32)
    wgt = rng.integers(1, 9, (v, d)).astype(np.int32)
    hub = np.arange(v) % 16 == 5
    wgt[~hub[:, None] & (rng.random((v, d)) < 0.4)] = INF
    wgt[v - 3:] = INF  # no in-neighbour: unreachable
    over = rng.random(v) < 0.05
    over[1] = True  # an overloaded root keeps its out-edges
    blocked = over[nbr] & (nbr != 1)
    banned = rng.random((v, d, b)) < 0.05
    return nbr, wgt, blocked, banned


def _model_tables(seed, b, v=96):
    nbr, wgt, blocked, banned = _model_case(seed, v=v, b=b)
    t = torch.from_numpy
    return (nbr, wgt, blocked, banned,
            (t(nbr), t(wgt), t(blocked), ksp.pack_bans(t(banned))))


@pytest.mark.parametrize("b", [8, 40, 100])
@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_pass_model_equals_jacobi_and_dijkstra(seed, b):
    """`ksp_sssp_passes_ref` (in-place passes relaxing only the job words
    with an in-neighbour stamped in the last pass or later) reaches the
    plain Jacobi fixpoint and scipy's Dijkstra on the masked graph, at one,
    two and four ban words, in as many passes as the plain loop's sweeps:
    each pass gives the Jacobi sweep's values."""
    nbr, wgt, blocked, banned, tab = _model_tables(seed, b)
    v = nbr.shape[0]
    root = 1
    c_ref = torch.zeros(2, dtype=torch.int32)
    want = ksp.ksp_sssp_ref(None, *tab, root, b, max_sweeps=v,
                            counters=c_ref)
    c_got = torch.zeros(2, dtype=torch.int32)
    got = ksp.ksp_sssp_passes_ref(None, *tab, root, b, max_sweeps=v,
                                  counters=c_got)
    assert torch.equal(got, want)
    np.testing.assert_array_equal(
        got.numpy(), _scipy_masked(nbr, wgt, blocked, banned, root))
    assert (got[v - 3:, :] == INF).all()
    assert int(c_got[1]) == int(c_ref[1]) >= 3


@pytest.mark.parametrize("cap", [1, 2, 3, 5])
@pytest.mark.parametrize("b", [8, 40])
def test_pass_model_capped_equals_capped_jacobi(b, cap):
    """Capped below the fixpoint, from `root` and from a start that is
    already lower in places, the model equals the plain loop capped at as
    many sweeps (so it lies between the fixpoint and that result, as the
    card's passes must), after `cap` passes."""
    _nbr, _wgt, _blocked, _banned, tab = _model_tables(3, b, v=64)
    v = tab[0].shape[0]
    fix = ksp.ksp_sssp_ref(None, *tab, 1, b, max_sweeps=v)
    start = torch.full((v, b), INF, dtype=torch.int32)
    start[1] = 0
    start[7, :5] = fix[7, :5]
    for dist0 in (None, start):
        jac = ksp.ksp_sssp_ref(dist0, *tab, 1, b, max_sweeps=cap)
        counters = torch.zeros(2, dtype=torch.int32)
        got = ksp.ksp_sssp_passes_ref(dist0, *tab, 1, b, max_sweeps=cap,
                                      counters=counters)
        assert torch.equal(got, jac)
        assert bool((got >= fix).all()) and not torch.equal(got, fix)
        assert int(counters[1]) == cap


@pytest.mark.parametrize("k", [2, 4])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_pass_model_in_ksp_equals_jax(seed, k, monkeypatch):
    """The whole KSP call with every SSSP on the kernel's schedule (the
    model in place of the plain fixpoint, so the bans of each round
    change which words the passes relax) equals the JAX package's costs,
    paths and hops, in as many passes as the plain call's sweeps."""
    _adj, _names, nbr, wgt, blocked, _over, dests, _real = _case(seed)
    ref = jksp.ksp_edge_disjoint_dense(nbr, wgt, blocked, np.int32(0), dests,
                                       k=k, max_hops=N - 1)
    plain: dict = {}
    ksp.ksp_edge_disjoint_dense(nbr, wgt, blocked, 0, dests, k=k,
                                max_hops=N - 1, device="cpu", stats=plain)
    monkeypatch.setattr(ksp, "ksp_sssp_ref", ksp.ksp_sssp_passes_ref)
    stats: dict = {}
    got = ksp.ksp_edge_disjoint_dense(nbr, wgt, blocked, 0, dests, k=k,
                                      max_hops=N - 1, device="cpu",
                                      stats=stats)
    _assert_equal(got, ref)
    assert stats["rounds"] == plain["rounds"]
    assert stats["sweeps"] == plain["sweeps"]


@pytest.mark.parametrize("sites", [8, 24])
def test_pass_model_on_a_backbone(sites):
    """Config 4's shape (a ring of site rings, `backbone(sites, 16)`),
    from bb1, where a change crosses one hop a pass and most words are
    settled long before the last pass: the model reaches the plain
    fixpoint in as many passes as the plain loop's sweeps."""
    from openr_tpu_torch.utils.topogen import backbone

    pls = LinkState()
    for db in backbone(sites, 16):
        pls.update_adjacency_db(db)
    csr = pls.to_csr()
    nbr, wgt = csr.dense_tables()
    v, b = nbr.shape[0], 8
    t = torch.from_numpy
    root = csr.name_to_id["bb1"]
    blocked = t(ksp.build_ksp_blocked(nbr, csr.node_overloaded, root))
    bans = torch.zeros((*nbr.shape, 1), dtype=torch.int32)
    tab = (t(nbr), t(wgt), blocked, bans)
    c_ref = torch.zeros(2, dtype=torch.int32)
    want = ksp.ksp_sssp_ref(None, *tab, root, b, max_sweeps=v,
                            counters=c_ref)
    c_got = torch.zeros(2, dtype=torch.int32)
    got = ksp.ksp_sssp_passes_ref(None, *tab, root, b, max_sweeps=v,
                                  counters=c_got)
    assert torch.equal(got, want)
    assert int(c_got[1]) == int(c_ref[1]) >= sites // 2


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_stamp_rule_needs_the_last_pass(seed, monkeypatch):
    """The kernel's rule reads again the words stamped in pass s - 1: a
    fall of the last pass may land after a row's read in it. With only
    the stamps of the current pass (`>= s`), the model stops short of the
    fixpoint."""
    _nbr, _wgt, _blocked, _banned, tab = _model_tables(seed, 40)
    v = tab[0].shape[0]
    want = ksp.ksp_sssp_ref(None, *tab, 1, 40, max_sweeps=v)
    monkeypatch.setattr(ksp, "_stamped", lambda stamp, s: stamp >= s)
    got = ksp.ksp_sssp_passes_ref(None, *tab, 1, 40, max_sweeps=v)
    assert bool((got >= want).all()) and not torch.equal(got, want)


def test_relax_refuses_one_buffer():
    """A Jacobi sweep reads one buffer and writes another: `dist_out`
    aliasing `dist_in` is refused."""
    nbr, wgt, blocked, banned, dist = _step_case(0, b=8)
    t = torch.from_numpy
    d = t(dist)
    with pytest.raises(ValueError):
        ksp.ksp_relax(d, d, t(nbr), t(wgt), t(blocked),
                      ksp.pack_bans(t(banned)),
                      torch.zeros(1, dtype=torch.int32))


@pytest.mark.parametrize("how", ["reversed", "random"])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_pass_model_in_any_row_order_equals_jacobi(seed, how):
    """The same tables with their rows relabelled: the model reaches the
    plain fixpoint, relabelled, in as many passes as the plain loop's
    sweeps."""
    nbr, wgt, blocked, banned, tab = _model_tables(seed, 40)
    v, b = nbr.shape[0], banned.shape[2]
    perm = (np.arange(v)[::-1].copy() if how == "reversed"
            else np.random.default_rng(seed).permutation(v))
    pos = np.empty(v, np.int64)
    pos[perm] = np.arange(v)
    t = torch.from_numpy
    relabelled = (t(pos[nbr[perm]].astype(np.int32)),
                  t(np.ascontiguousarray(wgt[perm])),
                  t(np.ascontiguousarray(blocked[perm])),
                  ksp.pack_bans(t(np.ascontiguousarray(banned[perm]))))
    c_ref = torch.zeros(2, dtype=torch.int32)
    want = ksp.ksp_sssp_ref(None, *tab, 1, b, max_sweeps=v, counters=c_ref)
    c_got = torch.zeros(2, dtype=torch.int32)
    got = ksp.ksp_sssp_passes_ref(None, *relabelled, int(pos[1]), b,
                                  max_sweeps=v, counters=c_got)
    assert torch.equal(got, want[t(perm)])
    assert int(c_got[1]) == int(c_ref[1])

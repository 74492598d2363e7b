"""`TorchSpfSolver`'s table knobs and batched solve paths equal
`TpuSpfSolver`'s: `_pick_table` for every knob combination, `dense_width`,
`_solve_dist` on the split, dense and edge tables, `compute_routes` with
the same knobs (overloads, LFA, anycast), `spf_kernel_stats`, the warm
path's table gate, the edge set's patch scatter, `mesh` and
`trim_caches`."""

import dataclasses
import itertools

import numpy as np
import pytest
import torch

from openr_tpu import types as jtypes
from openr_tpu.decision.linkstate import LinkState as JaxLinkState
from openr_tpu.decision.linkstate import PrefixState as JaxPrefixState
from openr_tpu.decision.spf_backend import TpuSpfSolver
from openr_tpu.utils import topogen as jtopo
from openr_tpu_torch import LinkState, PrefixState, TorchSpfSolver
from openr_tpu_torch import types as ptypes
from openr_tpu_torch.decision.spf_backend import LazyDist
from openr_tpu_torch.utils import topogen as ptopo
from test_torch_solver import _states, canon

# one intra-op thread: the suite runs several test workers at once
torch.set_num_threads(1)

GRAPHS = {
    "hub": ("hub_and_spoke", (2, 100), {}),  # the waste check's edge case
    "grid": ("grid", (5, 4), {}),
    "wan_over": ("wan_like", (40, 2),
                 dict(overloaded=("node-1", "node-5", "node-20"))),
}

#: (use_dense, use_pallas, kernel_impl, dense_waste_limit)
KNOBS = list(itertools.product(
    (None, True, False), (False, True), ("split", "dense"), (8, 1000),
))


def _both(name):
    gen, args, kw = GRAPHS[name]
    return (_states(jtopo, JaxLinkState, JaxPrefixState, gen, args, **kw),
            _states(ptopo, LinkState, PrefixState, gen, args, **kw))


def _solvers(use_dense, use_pallas, kernel_impl, waste, lfa=False):
    kw = dict(use_dense=use_dense, use_pallas=use_pallas,
              kernel_impl=kernel_impl, dense_waste_limit=waste,
              enable_lfa=lfa)
    return (TpuSpfSolver(native_rib="off", **kw),
            TorchSpfSolver(device="cpu", **kw))


@pytest.mark.parametrize("name", sorted(GRAPHS))
def test_pick_table_and_dense_width_equal(name):
    (jls, _), (pls, _) = _both(name)
    jcsr, pcsr = jls.to_csr(), pls.to_csr()
    assert pcsr.dense_width() == jcsr.dense_width()
    picked = set()
    for knobs in KNOBS:
        js, ps_ = _solvers(*knobs)
        got = ps_._pick_table(pcsr)
        assert got == js._pick_table(jcsr), knobs
        assert ps_.solve_vp(pcsr) == js.solve_vp(jcsr), knobs
        picked.add(got)
    assert picked == {"split", "dense", "edge"}
    if name == "hub":  # the waste check sends kernel_impl="dense" to edge
        assert _solvers(None, False, "dense", 8)[1]._pick_table(pcsr) == "edge"


#: one knob set per table kind: split, dense, dense via use_pallas, edge,
#: and the waste check's choice
KINDS = [
    (None, False, "split", 8),
    (True, False, "split", 8),
    (None, True, "split", 8),
    (False, False, "split", 8),
    (None, False, "dense", 8),
]


@pytest.mark.parametrize("knobs", KINDS)
@pytest.mark.parametrize("name", ["wan_over", "hub"])
def test_solve_dist_equal(name, knobs):
    (jls, _), (pls, _) = _both(name)
    jcsr, pcsr = jls.to_csr(), pls.to_csr()
    js, ps_ = _solvers(*knobs)
    rng = np.random.default_rng(3)
    roots = rng.integers(0, pcsr.num_nodes, 19).astype(np.int32)
    roots[1] = roots[0]  # repeated roots keep their own columns
    want = np.asarray(js._solve_dist(jcsr, roots))
    got = ps_._solve_dist(pcsr, roots)
    assert isinstance(got, torch.Tensor) and got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    table = ps_._pick_table(pcsr)
    st = ps_.last_solve_stats
    assert st["table"] == table
    assert st["relax_launches"] == st["edge_launches"] == 0  # CPU
    if table == "edge":
        assert st["rounds"] == st["host_reads"] >= 1
    elif table == "dense":
        assert st["sweeps"] == st["host_reads"] >= 1
    else:
        assert st["sweeps"] >= 1


def _anycast(types, mod, ps):
    """A second advertiser of node-4's loopback: the multi election."""
    ps.update_prefix_db(types.PrefixDatabase(
        this_node_name="node-8",
        prefix_entries=(types.PrefixEntry(prefix=mod.loopback(4)),),
    ))


@pytest.mark.parametrize("lfa", [False, True])
@pytest.mark.parametrize("knobs", KINDS)
def test_compute_routes_equal_per_table(knobs, lfa):
    (jls, jps), (pls, pps) = _both("wan_over")
    _anycast(jtypes, jtopo, jps)
    _anycast(ptypes, ptopo, pps)
    js, ps_ = _solvers(*knobs, lfa=lfa)
    for me in ("node-0", "node-5"):  # node-5 is overloaded
        ref = js.compute_routes(jls, jps, me)
        got = ps_.compute_routes(pls, pps, me)
        assert len(got.unicast_routes) > 0
        assert canon(got) == canon(ref), (me, knobs)
    dist = ps_.solve(pls, "node-0")[1]
    # every table's RIB comes through kernel C's packed buffer: the
    # matrix stays on the device, read on demand, equal to the reference's
    assert isinstance(dist, LazyDist)
    np.testing.assert_array_equal(np.asarray(dist),
                                  np.asarray(js.solve(jls, "node-0")[1]))


def test_spf_kernel_stats_equal():
    js, ps_ = _solvers(None, False, "split", 8)
    for name in ("grid", "wan_over", "hub"):  # grid: uniform metric
        (jls, jps), (pls, pps) = _both(name)
        js.compute_routes(jls, jps, "node-0")
        ps_.compute_routes(pls, pps, "node-0")
        roots = np.arange(9, dtype=np.int32)
        js._solve_dist(jls.to_csr(), roots)
        ps_._solve_dist(pls.to_csr(), roots)
    assert ps_.spf_kernel_stats == js.spf_kernel_stats
    assert ps_.spf_kernel_stats["uniform_metric"] > 0
    # the dense and edge tables count nothing
    js2, ps2 = _solvers(True, False, "split", 8)
    (jls, jps), (pls, pps) = _both("grid")
    js2.compute_routes(jls, jps, "node-0")
    ps2.compute_routes(pls, pps, "node-0")
    assert ps2.spf_kernel_stats == js2.spf_kernel_stats


def _set_metric(ls, node, k, metric):
    db = ls.adjacency_db(node)
    adjs = list(db.adjacencies)
    adjs[k] = dataclasses.replace(adjs[k], metric=metric)
    return ls.update_adjacency_db_delta(
        dataclasses.replace(db, adjacencies=tuple(adjs))
    )


@pytest.mark.parametrize("use_dense", [True, False])
def test_warm_gate_refuses_other_tables(use_dense):
    (jls, jps), (pls, pps) = _both("wan_over")
    js, ps_ = _solvers(use_dense, False, "split", 8)
    jr, ja = js.compute_routes(jls, jps, "node-0", return_artifact=True)
    pr, pa = ps_.compute_routes(pls, pps, "node-0", return_artifact=True)
    jres = _set_metric(jls, "node-7", 0, 33)
    pres = _set_metric(pls, "node-7", 0, 33)
    assert jres == pres and pres[0]
    jw = js.warm_compute_routes(ja, jls, jps, "node-0", set(jres[1]), set(),
                                jr, 0.5)
    pw = ps_.warm_compute_routes(pa, pls, pps, "node-0", set(pres[1]),
                                 set(), pr, 0.5)
    assert jw is None and pw is None
    # the epilogue's lazy matrix has the CSR's rows, not the split
    # tables': the gate's row check refuses it too
    assert isinstance(pa.solved[1], LazyDist)
    csr = pls.to_csr()
    assert pa.solved[1].shape[0] == csr.padded_nodes != TorchSpfSolver(
        device="cpu").solve_vp(csr)
    # a split-table artifact (device columns) meets the table gate
    jr, ja = TpuSpfSolver(native_rib="off").compute_routes(
        jls, jps, "node-0", return_artifact=True)
    pr, pa = TorchSpfSolver(device="cpu").compute_routes(
        pls, pps, "node-0", return_artifact=True)
    jres = _set_metric(jls, "node-7", 0, 34)
    pres = _set_metric(pls, "node-7", 0, 34)
    assert js.warm_compute_routes(ja, jls, jps, "node-0", set(jres[1]),
                                  set(), jr, 0.5) is None
    assert ps_.warm_compute_routes(pa, pls, pps, "node-0", set(pres[1]),
                                   set(), pr, 0.5) is None
    assert ps_.warm_solves == 0


@pytest.mark.parametrize("knobs", [(False, False, "split", 8),
                                   (True, False, "split", 8)])
def test_patched_tables_equal_a_fresh_solver(knobs):
    (jls, jps), (pls, pps) = _both("wan_over")
    _js, ps_ = _solvers(*knobs)
    ps_.compute_routes(pls, pps, "node-0")
    rng = np.random.default_rng(4)
    names = sorted(x for x in pls.nodes if x != "node-0")
    for rnd in range(3):
        for _ in range(4):
            node = names[int(rng.integers(len(names)))]
            k = int(rng.integers(len(pls.adjacency_db(node).adjacencies)))
            m = int(rng.integers(1, 60))
            assert _set_metric(pls, node, k, m) == _set_metric(jls, node, k, m)
        got = ps_.compute_routes(pls, pps, "node-0")
        fresh = _solvers(*knobs)[1].compute_routes(pls, pps, "node-0")
        ref = TpuSpfSolver(
            native_rib="off", use_dense=knobs[0]
        ).compute_routes(jls, jps, "node-0")
        assert canon(got) == canon(fresh) == canon(ref), rnd
        roots = np.arange(12, dtype=np.int32)
        np.testing.assert_array_equal(
            ps_._solve_dist(pls.to_csr(), roots).numpy(),
            _solvers(*knobs)[1]._solve_dist(pls.to_csr(), roots).numpy(),
        )
    # one upload for the table set, one journal scatter a round
    assert ps_.dev_cache_stats["uploads"] == 1
    assert ps_.dev_cache_stats["patches"] == 3


def test_edge_patch_writes_each_slot_once():
    """Two flaps of one link in one journal suffix: the last metric wins
    in the edge set, as in a fresh upload."""
    _, (pls, pps) = _both("wan_over")
    ps_ = TorchSpfSolver(device="cpu", use_dense=False)
    ps_.compute_routes(pls, pps, "node-0")
    _set_metric(pls, "node-9", 0, 40)
    _set_metric(pls, "node-9", 0, 3)
    csr = pls.to_csr()
    got = ps_._device_arrays(csr, "edge")["metric"].numpy()
    np.testing.assert_array_equal(got, csr.edge_metric)
    assert ps_.dev_cache_stats["patches"] == 1


def test_mesh_raises():
    """The mesh knob takes a mesh; one larger than its devices raises
    ValueError, as the reference's `make_mesh` does."""
    from openr_tpu_torch.parallel import make_mesh

    cpu8 = [torch.device("cpu")] * 8
    mesh = make_mesh(4, 2, devices=cpu8)
    assert TorchSpfSolver(device="cpu", mesh=mesh).mesh is mesh
    with pytest.raises(ValueError, match="needs 16 devices"):
        make_mesh(8, 2, devices=cpu8)


def test_trim_caches_clears_warm_index_and_elections():
    (_jls, _jps), (pls, pps) = _both("wan_over")
    _anycast(ptypes, ptopo, pps)
    ps_ = TorchSpfSolver(device="cpu")
    ps_.elect_device_min = 0  # the device election's cache fills
    ps_.compute_routes(pls, pps, "node-0")
    ps_._warm_out_index(pls.to_csr())
    assert ps_._elect_dev and ps_._warm_out
    ps_.trim_caches()
    assert not ps_._elect_dev and not ps_._warm_out

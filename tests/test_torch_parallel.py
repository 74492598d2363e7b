"""The port's sharded solve (`openr_tpu_torch/parallel/`) against the JAX
package's (`openr_tpu/parallel/`): every case of tests/test_parallel.py
on a mesh of eight CPU positions beside the JAX functions on conftest's
eight virtual devices, with exact int32 equality; the meshed solver after
a metric flap, its shard rows, its fallbacks and a meshed Decision; and
two processes joined by gloo whose graph rows span both."""

import dataclasses
import logging
import socket
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import openr_tpu.types.network as ref_network
import openr_tpu.types.routes as ref_routes
from openr_tpu.config import Config, DecisionConfig, NodeConfig
from openr_tpu.decision.decision import Decision
from openr_tpu.decision.fleet import compute_fleet_ribs as jax_fleet
from openr_tpu.decision.linkstate import LinkState as JaxLinkState
from openr_tpu.decision.spf_backend import TpuSpfSolver
from openr_tpu.messaging import ReplicateQueue
from openr_tpu.monitor import Counters
from openr_tpu.ops.spf import build_blocked
from openr_tpu.ops.spf_split import build_split_tables
from openr_tpu.parallel import make_mesh as jax_mesh
from openr_tpu.parallel import sharded_sssp as jax_sharded
from openr_tpu.parallel import sharded_sssp_padded as jax_padded
from openr_tpu.parallel import sharded_sssp_split as jax_split
from openr_tpu.utils import topogen as jtopo
from openr_tpu_torch import TorchSpfSolver
from openr_tpu_torch.decision import hook
from openr_tpu_torch.decision.fleet import compute_fleet_ribs
from openr_tpu_torch.monitor import compile_ledger
from openr_tpu_torch.ops import relax
from openr_tpu_torch.ops.spf import all_sources_sssp
from openr_tpu_torch.parallel import (
    distributed,
    make_mesh,
    sharded_sssp,
    sharded_sssp_padded,
    sharded_sssp_split,
)
from openr_tpu_torch.parallel.mesh import GRAPH_AXIS, SOURCES_AXIS
from openr_tpu_torch.utils import topogen as ptopo
from tests.test_torch_decision import churn
from tests.test_torch_routes import JAX, PORT, canon

# one intra-op thread: the suite runs several test workers at once
torch.set_num_threads(1)

REPO = Path(__file__).resolve().parent.parent
CPU8 = [torch.device("cpu")] * 8


def _csr(adj_dbs):
    ls = JaxLinkState()
    for db in adj_dbs:
        ls.update_adjacency_db(db)
    return ls.to_csr()


def _edge_args(csr):
    blocked = build_blocked(csr.edge_metric, csr.edge_src,
                            csr.node_overloaded)
    return csr.edge_src, csr.edge_dst, csr.edge_metric, blocked


def _both_edge(csr, roots, shape, padded=False):
    """(JAX, port) distances of the edge-list sharded solve."""
    s, g = shape
    args = _edge_args(csr)
    jfn, pfn = (jax_padded, sharded_sssp_padded) if padded else (
        jax_sharded, sharded_sssp)
    want = np.asarray(jfn(*map(jnp.asarray, args), jnp.asarray(roots),
                          jax_mesh(n_sources=s, n_graph=g), csr.padded_nodes))
    got = pfn(*args, roots, make_mesh(s, g, devices=CPU8), csr.padded_nodes)
    return want, got.full("cpu").numpy()


def _overloaded(adj_dbs, ids):
    from tests.test_spf_kernel import _overload

    for i in ids:
        adj_dbs[i] = _overload(adj_dbs[i])
    return adj_dbs


# ----------------------------------------------- tests/test_parallel.py a-f


@pytest.mark.parametrize("shape", [(8, 1), (4, 2), (2, 4), (1, 8)])
def test_sharded_equals_jax(shape):
    adj, _ = jtopo.erdos_renyi(64, avg_degree=4, seed=1, max_metric=50)
    want, got = _both_edge(_csr(adj), np.arange(64, dtype=np.int32), shape)
    np.testing.assert_array_equal(got, want)


def test_sharded_with_overload_equals_jax():
    adj, _ = jtopo.grid(8, 8)
    csr = _csr(_overloaded(adj, (9, 27, 45)))
    want, got = _both_edge(csr, np.arange(64, dtype=np.int32), (2, 4))
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("n_roots", [1, 5, 13])
def test_sharded_padded_uneven_roots_equal_jax(n_roots):
    adj, _ = jtopo.erdos_renyi(40, avg_degree=5, seed=3, max_metric=20)
    csr = _csr(adj)
    roots = np.linspace(0, 39, n_roots).astype(np.int32)
    want, got = _both_edge(csr, roots, (4, 2), padded=True)
    assert got.shape == (csr.padded_nodes, n_roots)
    np.testing.assert_array_equal(got, want)


def test_sharded_512_nodes_with_overload_equals_jax():
    adj, _ = jtopo.erdos_renyi(512, avg_degree=6, seed=9, max_metric=40)
    csr = _csr(_overloaded(adj, (50, 200, 350)))
    stats = {}
    args = _edge_args(csr)
    got = sharded_sssp(*args, np.arange(512, dtype=np.int32),
                       make_mesh(4, 2, devices=CPU8), csr.padded_nodes,
                       stats=stats).full("cpu").numpy()
    want = np.asarray(jax_sharded(
        *map(jnp.asarray, args), jnp.arange(512, dtype=jnp.int32),
        jax_mesh(n_sources=4, n_graph=2), csr.padded_nodes))
    np.testing.assert_array_equal(got, want)
    assert 1 <= stats["rounds"] <= csr.padded_nodes
    # one host read a block of rounds (the loop runs on the device)
    assert stats["host_syncs"] == stats["replays"] == -(
        -stats["rounds"] // stats["block"])


def test_all_sources_matches_sharded():
    """The port's `all_sources_sssp` (chunks and a ragged tail) agrees with
    its sharded solve column for column, which equals the JAX one's."""
    adj, _ = jtopo.erdos_renyi(96, avg_degree=5, seed=5, max_metric=30)
    csr = _csr(adj)
    args = _edge_args(csr)
    full = all_sources_sssp(
        *(torch.from_numpy(np.asarray(a)) for a in args),
        csr.padded_nodes, chunk=32)
    want, got = _both_edge(csr, np.arange(96, dtype=np.int32), (8, 1))
    np.testing.assert_array_equal(full[:96, :96], got[:96, :96].T)
    np.testing.assert_array_equal(got, want)


def _split_case():
    es, ed, em, _vp, nn, _e = jtopo.erdos_renyi_csr(
        700, avg_degree=6, seed=21, max_metric=32)
    t = build_split_tables(es, ed, em, nn)
    over = np.zeros(t["vp"], bool)
    over[[5, 17, 40]] = True
    roots = np.random.default_rng(3).integers(0, nn, 16).astype(np.int32)
    roots[0] = 5  # overloaded root: exemption path
    args = [t[k] for k in ("base_nbr", "base_wgt", "ov_ids", "ov_nbr",
                           "ov_wgt")]
    return args, over, roots


@pytest.mark.parametrize("shape", [(4, 2), (2, 4), (1, 8)])
def test_sharded_split_equals_jax(shape):
    """The split tables under sources x graph sharding: kernel A on each
    position's rows and the overflow rows, equal to the JAX function."""
    args, over, roots = _split_case()
    s, g = shape
    want = np.asarray(jax_split(
        *map(jnp.asarray, args), jnp.asarray(over), jnp.asarray(roots),
        jax_mesh(n_sources=s, n_graph=g, devices=jax.devices()[:8]),
        has_overloads=True))
    stats = {}
    launches = relax.LAUNCHES
    syncs = compile_ledger.ledger().host_syncs
    got = sharded_sssp_split(*args, over, roots,
                             make_mesh(s, g, devices=CPU8),
                             has_overloads=True, stats=stats)
    np.testing.assert_array_equal(got.full("cpu").numpy(), want)
    assert stats["sweeps"] >= 1
    # one host read a block of sweeps (the loop runs on the device)
    assert stats["host_syncs"] == stats["replays"] == -(
        -stats["sweeps"] // stats["block"])
    assert compile_ledger.ledger().host_syncs - syncs == stats["replays"]
    assert relax.LAUNCHES == launches  # the CPU runs the plain version


# --------------------------------------------------------- the mesh itself


def test_make_mesh_layout_and_value_error():
    m = make_mesh(4, 2, devices=CPU8)
    assert m.shape == {SOURCES_AXIS: 4, GRAPH_AXIS: 2}
    assert [m.flat(s, g) for s in range(4) for g in range(2)] == list(range(8))
    assert make_mesh(n_graph=4, devices=CPU8).shape[SOURCES_AXIS] == 2
    with pytest.raises(ValueError, match="needs 16 devices, have 8"):
        make_mesh(n_sources=4, n_graph=4, devices=CPU8)
    with pytest.raises(ValueError):
        make_mesh(n_sources=1, devices=[])
    with pytest.raises(ValueError, match="must divide"):
        args, over, roots = _split_case()
        sharded_sssp_split(*args, over, roots[:15],
                           make_mesh(4, 2, devices=CPU8))


def test_initialize_without_the_environment(monkeypatch):
    for k in ("OPENR_COORDINATOR", "OPENR_NUM_PROCESSES", "OPENR_PROCESS_ID"):
        monkeypatch.delenv(k, raising=False)
    assert distributed.initialize() is False
    mesh = distributed.global_mesh(n_graph=2, local_devices=CPU8)
    assert mesh.groups is None and mesh.shape[SOURCES_AXIS] == 4


# ------------------------------------------------------- the meshed solver


def _meshed_solvers(shape=(4, 2), devices=CPU8):
    s, g = shape
    jm = jax_mesh(n_sources=s, n_graph=g, devices=jax.devices()[:8])
    return (TpuSpfSolver(native_rib="off", mesh=jm),
            TorchSpfSolver(device="cpu",
                           mesh=make_mesh(s, g, devices=devices)))


def test_mesh_configured_solver_equals_jax():
    """tests/test_parallel.py g: `_solve_dist`, the single-root rebuild
    and the fleet RIBs of a meshed solver equal the meshed
    `TpuSpfSolver(native_rib="off")`'s."""
    jls, jps, jcsr = jtopo.erdos_renyi_lsdb(300, avg_degree=5, seed=9,
                                            max_metric=16)
    pls, pps, pcsr = ptopo.erdos_renyi_lsdb(300, avg_degree=5, seed=9,
                                            max_metric=16)
    ref, port = _meshed_solvers()
    roots = np.arange(64, dtype=np.int32) % pcsr.num_nodes
    got = port._solve_dist(pcsr, roots).numpy()
    np.testing.assert_array_equal(got,
                                  np.asarray(ref._solve_dist(jcsr, roots)))
    assert port.last_solve_stats["relax_launches"] == 0  # CPU: the twin
    assert canon(port.compute_routes(pls, pps, "node-0")) == canon(
        ref.compute_routes(jls, jps, "node-0"))
    some = [f"node-{i}" for i in range(0, 30, 3)]
    fa = compute_fleet_ribs(pls, pps, nodes=some, solver=port)
    fb = jax_fleet(jls, jps, nodes=some, solver=ref)
    assert len(fa) == len(some)
    assert {n: canon(r) for n, r in fa.items()} == {
        n: canon(r) for n, r in fb.items()}


def test_shard_rows_equal_the_reference():
    _jls, _jps, jcsr = jtopo.erdos_renyi_lsdb(120, avg_degree=4, seed=2,
                                              max_metric=9)
    _pls, _pps, pcsr = ptopo.erdos_renyi_lsdb(120, avg_degree=4, seed=2,
                                              max_metric=9)
    ref, port = _meshed_solvers()
    roots = np.arange(16, dtype=np.int32)
    ref._solve_dist(jcsr, roots)
    port._solve_dist(pcsr, roots)
    assert port.last_shard_rows and len(port.last_shard_rows) == 8
    assert port.last_shard_rows == ref.last_shard_rows


def _flap(pkg, ls, rng_seed, n=32):
    """`n` seeded metric changes through `update_adjacency_db_delta`;
    returns the old adjacency databases, for the revert."""
    rng = np.random.default_rng(rng_seed)
    names = sorted(ls.nodes)
    old = {}
    for _ in range(n):
        node = names[int(rng.integers(1, len(names)))]
        db = ls.adjacency_db(node)
        old.setdefault(node, db)
        adjs = list(db.adjacencies)
        k = int(rng.integers(len(adjs)))
        adjs[k] = dataclasses.replace(adjs[k], metric=int(rng.integers(1, 40)))
        ls.update_adjacency_db_delta(
            dataclasses.replace(db, adjacencies=tuple(adjs)))
    return old


@pytest.mark.parametrize("positions", ["views", "copies"])
def test_meshed_solver_after_a_flap_and_its_revert(positions):
    """The tables' patch scatter reaches the mesh's parts: views share
    it, and copies (positions on a device other than the tables') are cut
    again at the table set's next revision."""
    devices = CPU8 if positions == "views" else [torch.device("cpu", 0)] * 8
    jls, pls = JAX.ls(), PORT.ls()
    for pkg, ls in ((JAX, jls), (PORT, pls)):
        for db in pkg.topo.erdos_renyi(200, avg_degree=5, seed=4,
                                       max_metric=16)[0]:
            ls.update_adjacency_db(db)
    ref, port = _meshed_solvers(devices=devices)
    roots = np.arange(32, dtype=np.int32)

    def check():
        jcsr, pcsr = jls.to_csr(), pls.to_csr()
        got = port._solve_dist(pcsr, roots).numpy()
        np.testing.assert_array_equal(
            got, np.asarray(ref._solve_dist(jcsr, roots)))
        return pcsr

    base = check().base_version
    olds = [_flap(pkg, ls, 11) for pkg, ls in ((JAX, jls), (PORT, pls))]
    assert check().base_version == base  # the journal, not a rebuild
    assert port.dev_cache_stats["patches"] == 1
    for ls, old in zip((jls, pls), olds):
        for db in old.values():
            ls.update_adjacency_db_delta(db)
    assert check().base_version == base
    assert port.dev_cache_stats["patches"] == 2


def test_mesh_fallbacks_warn_once(caplog):
    """A shape the mesh does not divide, and a dense table, solve on the
    solver's device, with one warning in all."""
    _jls, _jps, jcsr = jtopo.erdos_renyi_lsdb(100, avg_degree=4, seed=6,
                                              max_metric=9)
    _pls, _pps, pcsr = ptopo.erdos_renyi_lsdb(100, avg_degree=4, seed=6,
                                              max_metric=9)
    plain = TpuSpfSolver(native_rib="off")
    port = TorchSpfSolver(device="cpu", mesh=make_mesh(3, 1, devices=CPU8))
    roots = np.arange(8, dtype=np.int32)
    want = np.asarray(plain._solve_dist(jcsr, roots))
    with caplog.at_level(logging.WARNING):
        for _ in range(2):
            got = port._solve_dist(pcsr, roots).numpy()
            np.testing.assert_array_equal(got, want)
        port.use_dense = True
        got = port._solve_dist(pcsr, roots).numpy()
    warned = [r for r in caplog.records if "mesh" in r.getMessage()]
    assert len(warned) == 1 and "does not divide" in warned[0].getMessage()
    assert port.last_shard_rows == []
    dense = TpuSpfSolver(native_rib="off", use_dense=True)
    np.testing.assert_array_equal(got, np.asarray(dense._solve_dist(jcsr,
                                                                    roots)))


def test_meshed_decision_equals_jax():
    """`hook.attach` on a Decision configured with a 4 x 2 mesh builds a
    meshed solver; its RIBs and RouteUpdates equal a JAX Decision's with
    the same config."""
    def mk(backend):
        cfg = Config(NodeConfig(node_name="node-0", decision=DecisionConfig(
            mesh_sources=4, mesh_graph=2, native_rib="off")))
        routes = ReplicateQueue(name="routes")
        reader = routes.get_reader()
        d = Decision(cfg, ReplicateQueue(name="pubs").get_reader(), routes,
                     solver=backend, counters=Counters())
        return d, reader

    d_ref, r_ref = mk("tpu")
    d_port, r_port = mk("cpu")
    adapter = hook.attach(d_port, ref_routes, ref_network, device="cpu",
                          mesh_devices=CPU8)
    assert adapter.solver.mesh.shape == {SOURCES_AXIS: 4, GRAPH_AXIS: 2}
    assert d_ref._tpu.mesh is not None
    churn(d_ref, d_port, r_ref, r_port, 8, 3, jtopo.fat_tree(4))
    with pytest.raises(ValueError, match="needs 8 devices"):
        hook.attach(mk("cpu")[0], ref_routes, ref_network, device="cpu",
                    mesh_devices=CPU8[:4])


# ------------------------------------------------------- two processes


WORKER = r"""
import os, sys
sys.path.insert(0, os.environ["OPENR_REPO"])
import numpy as np
import torch

torch.set_num_threads(1)
from openr_tpu_torch.parallel import distributed
from openr_tpu_torch.parallel import sharded_sssp_padded, sharded_sssp_split
from openr_tpu_torch.parallel.mesh import GRAPH_AXIS, SOURCES_AXIS

assert distributed.initialize(), "coordinator env missing"
mesh = distributed.global_mesh(n_graph=2,
                               local_devices=[torch.device("cpu")] * 4)
assert mesh.shape == {SOURCES_AXIS: 4, GRAPH_AXIS: 2}, mesh.shape
spans = all(set(mesh.ranks[s].tolist()) == {0, 1} for s in range(4))
d = np.load(os.environ["OPENR_INPUTS"])
P = distributed.shard_host_array
edge = sharded_sssp_padded(
    *(P(d[k], mesh, (GRAPH_AXIS,)) for k in ("es", "ed", "em", "blocked")),
    P(d["roots_e"], mesh, (SOURCES_AXIS,)), mesh, int(d["vp"]))
split = sharded_sssp_split(
    P(d["base_nbr"], mesh, (GRAPH_AXIS, None)),
    P(d["base_wgt"], mesh, (GRAPH_AXIS, None)),
    *(P(d[k], mesh, ()) for k in ("ov_ids", "ov_nbr", "ov_wgt", "over")),
    P(d["roots_s"], mesh, (SOURCES_AXIS,)), mesh)
out = {}
for name, arr in (("edge", edge), ("split", split)):
    for _p, idx, piece in arr.local():
        (r0, r1), (c0, c1) = idx
        out[f"{name}:{c0}:{c1}"] = piece.numpy()
np.savez(os.environ["OPENR_OUT"], **out)
distributed.shutdown()
print(f"WORKER_OK rank={mesh.rank} pieces={len(out)} spans={int(spans)}")
"""


def _free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def test_two_process_global_mesh(tmp_path):
    """The port of tests/test_multihost.py's two-process mesh: two gloo
    ranks of 4 CPU positions each form a (4, 2) mesh whose graph rows
    span both processes; each rank's pieces of the edge-list and split
    solves equal scipy's Dijkstra and the JAX sharded solves on the
    virtual devices."""
    from scipy.sparse import csr_matrix
    from scipy.sparse.csgraph import dijkstra

    from openr_tpu.ops.spf import INF_DIST, pad_batch

    es, ed, em, vp, n, _e = jtopo.erdos_renyi_csr(600, avg_degree=6, seed=21,
                                                  max_metric=32)
    blocked = build_blocked(em, es, np.zeros(vp, bool))
    roots_e = np.arange(pad_batch(8), dtype=np.int32) % n
    t = build_split_tables(es, ed, em, n)
    roots_s = np.arange(16, dtype=np.int32) * 37 % n
    inputs = dict(es=es, ed=ed, em=em, blocked=blocked, vp=vp,
                  roots_e=roots_e, roots_s=roots_s,
                  over=np.zeros(t["vp"], bool),
                  **{k: t[k] for k in ("base_nbr", "base_wgt", "ov_ids",
                                        "ov_nbr", "ov_wgt")})
    np.savez(tmp_path / "inputs.npz", **inputs)
    port = _free_port()
    procs = []
    for pid in (0, 1):
        env = dict(**__import__("os").environ,
                   OPENR_COORDINATOR=f"127.0.0.1:{port}",
                   OPENR_NUM_PROCESSES="2", OPENR_PROCESS_ID=str(pid),
                   OPENR_REPO=str(REPO),
                   OPENR_INPUTS=str(tmp_path / "inputs.npz"),
                   OPENR_OUT=str(tmp_path / f"out{pid}.npz"))
        procs.append(subprocess.Popen(
            [sys.executable, "-c", WORKER], env=env, stdout=subprocess.PIPE,
            stderr=subprocess.PIPE, text=True))
    outs = []
    try:
        for p in procs:
            outs.append((p.returncode, *p.communicate(timeout=120)))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    for (_rc, out, err), p in zip(outs, procs):
        assert p.returncode == 0, f"worker failed\n{out}\n{err[-3000:]}"
        assert "WORKER_OK" in out and "spans=1" in out, out

    valid = em < INF_DIST
    g = csr_matrix((em[valid], (es[valid], ed[valid])), shape=(vp, vp))
    jm = jax_mesh(n_sources=4, n_graph=2, devices=jax.devices()[:8])
    want = {
        "edge": np.asarray(jax_padded(
            *map(jnp.asarray, (es, ed, em, blocked)), jnp.asarray(roots_e),
            jm, vp)),
        "split": np.asarray(jax_split(
            *(jnp.asarray(inputs[k]) for k in (
                "base_nbr", "base_wgt", "ov_ids", "ov_nbr", "ov_wgt",
                "over", "roots_s")), jm)),
    }
    oracle = {}
    for name, roots in (("edge", roots_e), ("split", roots_s)):
        d = dijkstra(g, indices=roots)
        d[np.isinf(d)] = INF_DIST
        oracle[name] = d.T.astype(np.int64)  # [node, root]
    cols = {"edge": set(), "split": set()}
    for pid in (0, 1):
        with np.load(tmp_path / f"out{pid}.npz") as got:
            for key in got.files:
                name, c0, c1 = key.split(":")
                c0, c1 = int(c0), int(c1)
                piece = got[key]
                np.testing.assert_array_equal(piece, want[name][:, c0:c1])
                np.testing.assert_array_equal(
                    piece[:n].astype(np.int64), oracle[name][:n, c0:c1])
                cols[name].add((c0, c1))
    assert len(cols["edge"]) == len(cols["split"]) == 4

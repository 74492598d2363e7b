"""The sharded solves' loops on the device (`parallel/sharded_spf.py`):
blocks of K guarded sweeps or rounds with one host read a block, equal
to the JAX package's `sharded_sssp_split` / `sharded_sssp` on eight CPU
positions for every mesh and K; rows that converge at different sweeps;
overloads and uneven roots through `sharded_sssp_padded`; two gloo
processes running the same blocks; and the guards' CPU twins
(`edge_relax.edge_round`, `split_loop.row_exit`)."""

import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from openr_tpu.ops.spf import build_blocked
from openr_tpu.ops.spf_split import build_split_tables
from openr_tpu.parallel import make_mesh as jax_mesh
from openr_tpu.parallel import sharded_sssp as jax_sharded
from openr_tpu.parallel import sharded_sssp_padded as jax_padded
from openr_tpu.parallel import sharded_sssp_split as jax_split
from openr_tpu.utils import topogen as jtopo
from openr_tpu_torch.monitor import compile_ledger
from openr_tpu_torch.monitor import device as telemetry
from openr_tpu_torch.ops import edge_relax, relax, split_loop
from openr_tpu_torch.parallel import (
    make_mesh,
    sharded_spf,
    sharded_sssp,
    sharded_sssp_padded,
    sharded_sssp_split,
)
from tests.test_torch_parallel import (
    CPU8,
    REPO,
    _csr,
    _edge_args,
    _free_port,
    _overloaded,
    _split_case,
)

# one intra-op thread: the suite runs several test workers at once
torch.set_num_threads(1)

MESHES = [(8, 1), (4, 2), (2, 4), (1, 8)]
BLOCKS = [1, 3, 32]


@pytest.fixture
def block(monkeypatch):
    """Sets the sharded loops' K (`sharded_spf.BLOCK`) for the test."""
    def set_k(k: int) -> int:
        monkeypatch.setattr(sharded_spf, "BLOCK", k)
        return k
    return set_k


def _blocks(trips: int, k: int) -> int:
    return -(-trips // k)


def _check_stats(st: dict, trips_key: str, k: int, syncs: int) -> None:
    """One host read a block: host_syncs == replays == ceil(trips / K),
    and the ledger counted each."""
    assert st["block"] == k
    assert st["host_syncs"] == st["replays"] == _blocks(st[trips_key], k)
    assert compile_ledger.ledger().host_syncs - syncs == st["replays"]


@pytest.mark.parametrize("k", BLOCKS)
@pytest.mark.parametrize("shape", MESHES)
def test_split_loop_equals_jax(shape, k, block):
    block(k)
    args, over, roots = _split_case()
    s, g = shape
    want = np.asarray(jax_split(
        *map(jnp.asarray, args), jnp.asarray(over), jnp.asarray(roots),
        jax_mesh(n_sources=s, n_graph=g, devices=jax.devices()[:8]),
        has_overloads=True))
    st: dict = {}
    syncs = compile_ledger.ledger().host_syncs
    got = sharded_sssp_split(*args, over, roots,
                             make_mesh(s, g, devices=CPU8),
                             has_overloads=True, stats=st)
    np.testing.assert_array_equal(got.full("cpu").numpy(), want)
    assert st["sweeps"] >= 2
    _check_stats(st, "sweeps", k, syncs)


@pytest.mark.parametrize("k", BLOCKS)
@pytest.mark.parametrize("shape", MESHES)
def test_edge_loop_equals_jax(shape, k, block):
    block(k)
    adj, _ = jtopo.erdos_renyi(96, avg_degree=4, seed=2, max_metric=30)
    csr = _csr(_overloaded(adj, (7, 40)))
    args = _edge_args(csr)
    roots = (np.arange(32) * 5 % 96).astype(np.int32)
    s, g = shape
    want = np.asarray(jax_sharded(
        *map(jnp.asarray, args), jnp.asarray(roots),
        jax_mesh(n_sources=s, n_graph=g), csr.padded_nodes))
    st: dict = {}
    syncs = compile_ledger.ledger().host_syncs
    got = sharded_sssp(*args, roots, make_mesh(s, g, devices=CPU8),
                       csr.padded_nodes, stats=st)
    np.testing.assert_array_equal(got.full("cpu").numpy(), want)
    _check_stats(st, "rounds", k, syncs)
    # Jacobi rounds, as the reference's: the unsharded solve's count
    ref: dict = {}
    edge_relax.batched_sssp(*(torch.from_numpy(np.asarray(a)) for a in args),
                            torch.from_numpy(roots), csr.padded_nodes,
                            stats=ref)
    assert st["rounds"] == ref["rounds"] >= 2


def _chain_and_star(n_chain=40, n_star=24):
    """A chain (a root at its head needs n_chain sweeps or rounds) and a
    separate star (a root at a leaf is done in two)."""
    from openr_tpu.types.topology import Adjacency, AdjacencyDatabase

    links = [(i, i + 1) for i in range(n_chain - 1)]
    hub = n_chain
    links += [(hub, hub + 1 + j) for j in range(n_star)]
    nbrs: dict = {}
    for a, b in links:
        nbrs.setdefault(a, []).append(b)
        nbrs.setdefault(b, []).append(a)
    dbs = []
    for u in range(n_chain + 1 + n_star):
        adjs = tuple(Adjacency(
            other_node_name=f"node-{v}", if_name=f"if-{u}-{v}",
            other_if_name=f"if-{v}-{u}", metric=1 + (u + v) % 3)
            for v in sorted(nbrs.get(u, ())))
        dbs.append(AdjacencyDatabase(this_node_name=f"node-{u}",
                                     adjacencies=adjs))
    return _csr(dbs), n_chain


@pytest.mark.parametrize("kind", ["split", "edge"])
def test_rows_converge_at_different_sweeps(kind, block):
    """Row 0's roots sit on the chain's head, row 1's on the star's
    leaves: row 1 is done blocks before row 0, its launches then no-ops,
    and both rows stay equal to the JAX solve."""
    block(2)
    csr, n_chain = _chain_and_star()
    n = csr.num_nodes
    ids = csr.name_to_id
    roots = np.array([ids[f"node-{i}"] for i in (0, 1, 2, 3)]
                     + [ids[f"node-{n - 1 - i}"] for i in range(4)],
                     np.int32)
    st: dict = {}
    mesh = make_mesh(2, 4, devices=CPU8)
    jm = jax_mesh(n_sources=2, n_graph=4, devices=jax.devices()[:8])
    if kind == "split":
        t = build_split_tables(csr.edge_src, csr.edge_dst, csr.edge_metric,
                               n)
        args = [t[k] for k in ("base_nbr", "base_wgt", "ov_ids", "ov_nbr",
                               "ov_wgt")]
        over = np.zeros(t["vp"], bool)
        want = np.asarray(jax_split(*map(jnp.asarray, args),
                                    jnp.asarray(over), jnp.asarray(roots),
                                    jm))
        got = sharded_sssp_split(*args, over, roots, mesh, stats=st)
        trips = st["sweeps"]
    else:
        args = _edge_args(csr)
        want = np.asarray(jax_sharded(*map(jnp.asarray, args),
                                      jnp.asarray(roots), jm,
                                      csr.padded_nodes))
        got = sharded_sssp(*args, roots, mesh, csr.padded_nodes, stats=st)
        trips = st["rounds"]
    np.testing.assert_array_equal(got.full("cpu").numpy(), want)
    row_trips = st["row_trips"]
    assert len(row_trips) == 2 and max(row_trips) == trips
    assert row_trips[1] <= 3 < row_trips[0]  # the star's row, the chain's
    assert st["replays"] == _blocks(trips, 2)


@pytest.mark.parametrize("k", [1, 3])
@pytest.mark.parametrize("n_roots", [1, 5, 13])
def test_padded_overloads_and_uneven_roots(n_roots, k, block):
    block(k)
    adj, _ = jtopo.erdos_renyi(40, avg_degree=5, seed=3, max_metric=20)
    csr = _csr(_overloaded(adj, (4, 17, 30)))
    args = _edge_args(csr)
    roots = np.linspace(0, 39, n_roots).astype(np.int32)
    roots[0] = 17  # an overloaded root: the init's exemption
    want = np.asarray(jax_padded(
        *map(jnp.asarray, args), jnp.asarray(roots),
        jax_mesh(n_sources=4, n_graph=2), csr.padded_nodes))
    st: dict = {}
    got = sharded_sssp_padded(*args, roots, make_mesh(4, 2, devices=CPU8),
                              csr.padded_nodes, stats=st)
    assert got.shape == (csr.padded_nodes, n_roots)
    np.testing.assert_array_equal(got.full("cpu").numpy(), want)
    assert st["host_syncs"] == st["replays"] == _blocks(st["rounds"], k)


@pytest.mark.parametrize("kind", ["split", "edge"])
def test_capture_reads_once_a_block(kind, block, monkeypatch):
    """On a call a capture counts (the first at its key), no guarded
    launch of the loop runs with a sink live, so no wrapper reads the
    phase to count its work: the ledger's host syncs equal the blocks
    run, and the cost row counts each row's launches once for each live
    sweep or round its control block ran, as an uncaptured call runs
    them."""
    k = block(3)
    launched = []

    def no_sink(fn):
        def call(*a, **kw):
            assert telemetry.sink() is None, f"{fn.__name__} with a sink"
            launched.append(fn.__name__)
            return fn(*a, **kw)
        return call

    for mod, name in ((relax, "relax_rows"), (split_loop, "row_exit"),
                      (edge_relax, "edge_round")):
        monkeypatch.setattr(mod, name, no_sink(getattr(mod, name)))
    mesh = make_mesh(4, 2, devices=CPU8)
    tel = telemetry.DeviceTelemetry()
    st: dict = {}
    led = compile_ledger.ledger()
    syncs, reads = led.host_syncs, led.host_reads
    if kind == "split":
        args, over, roots = _split_case()
        with tel.observe("sharded_sssp_split", 0) as cap:
            got = sharded_sssp_split(*args, over, roots, mesh,
                                     has_overloads=True, stats=st)
        trips = st["sweeps"]
        # a position's own rows and the overflow rows (kernel A), the
        # exit: per device of a row (one here) 2 relaxes and 1 exit
        per_trip = {"relax": 2 + 1, "split_loop": 1}
        want = np.asarray(jax_split(
            *map(jnp.asarray, args), jnp.asarray(over), jnp.asarray(roots),
            jax_mesh(n_sources=4, n_graph=2, devices=jax.devices()[:8]),
            has_overloads=True))
    else:
        adj, _ = jtopo.erdos_renyi(96, avg_degree=4, seed=2, max_metric=30)
        csr = _csr(_overloaded(adj, (7, 40)))
        args = _edge_args(csr)
        roots = (np.arange(32) * 5 % 96).astype(np.int32)
        with tel.observe("sharded_sssp", 0) as cap:
            got = sharded_sssp(*args, roots, mesh, csr.padded_nodes,
                               stats=st)
        trips = st["rounds"]
        per_trip = {"edge_relax": 2, "split_loop": 1}
        want = np.asarray(jax_sharded(
            *map(jnp.asarray, args), jnp.asarray(roots),
            jax_mesh(n_sources=4, n_graph=2), csr.padded_nodes))
    np.testing.assert_array_equal(got.full("cpu").numpy(), want)
    assert launched  # the loop ran its launches through the wrappers
    assert st["host_syncs"] == st["replays"] == _blocks(trips, k)
    assert led.host_syncs - syncs == st["replays"]
    # the edge solve's index builds read once a slice (2 slices), the
    # split solve reads nothing else
    assert led.host_reads - reads == (0 if kind == "split" else 2)
    live = sum(st["row_trips"])
    inits = 2 * 4 if kind == "edge" else 0  # kernel H's init a slice
    assert cap.work.launches == inits + live * sum(per_trip.values())
    assert set(cap.work.sources) == set(per_trip)


# ------------------------------------------------------------ the guards


def _round_case(seed=1):
    rng = np.random.default_rng(seed)
    adj, _ = jtopo.erdos_renyi(60, avg_degree=4, seed=seed, max_metric=9)
    csr = _csr(adj)
    t = [torch.from_numpy(np.asarray(a)) for a in _edge_args(csr)]
    v = csr.padded_nodes
    dist = torch.from_numpy(rng.integers(0, 40, (v, 8)).astype(np.int32))
    dist[rng.random((v, 8)) < 0.5] = edge_relax.INF_DIST
    return t, v, dist


@pytest.mark.parametrize("phase", ["live", "done"])
def test_edge_round_twin_under_the_guard(phase):
    """A done control block leaves `out` and `changed` as they were; a
    live one gives `edge_round_ref`'s round."""
    (src, dst, met, blk), v, dist = _round_case()
    ctl = split_loop.new_ctl(split_loop.NET, 0, 0, v, "cpu")
    if phase == "done":
        ctl[split_loop.PHASE] = split_loop.DONE
    out = torch.full_like(dist, -7)
    changed = torch.full((1,), -3, dtype=torch.int32)
    rs = torch.from_numpy(edge_relax.edge_row_start(dst.numpy(), v,
                                                    met.numpy()))
    edge_relax.edge_round(dist, out, src, dst, met, blk, rs, changed,
                          ctl=ctl, phase_mask=1 << split_loop.NET)
    if phase == "done":
        assert bool((out == -7).all()) and int(changed) == -3
    else:
        want = torch.empty_like(dist)
        want_changed = torch.zeros(1, dtype=torch.int32)
        edge_relax.edge_round_ref(dist, want, src, dst, met, blk,
                                  want_changed)
        assert torch.equal(out, want)
        assert int(changed) == int(want_changed) == 1
    # an unguarded round must keep its flag
    with pytest.raises(ValueError, match="keeps changed"):
        edge_relax.edge_round(dist, out, src, dst, met, blk, rs, None)


@pytest.mark.parametrize("copy", [False, True])
@pytest.mark.parametrize("case", ["fell", "still", "cap", "done"])
def test_row_exit_twin(case, copy):
    g = torch.Generator().manual_seed(5)
    prev = torch.randint(0, 50, (64, 8), generator=g, dtype=torch.int32)
    cur = prev.clone()
    if case in ("fell", "cap", "done"):
        cur[3, 5] -= 1
    ctl = split_loop.new_ctl(split_loop.NET, 0, 0, 10, "cpu")
    ctl[split_loop.IT] = 9 if case == "cap" else 4
    if case == "done":
        ctl[split_loop.PHASE] = split_loop.DONE
    before_prev, before_ctl = prev.clone(), ctl.clone()
    split_loop.row_exit(cur, prev, ctl, 1 << split_loop.NET, copy=copy)
    if case == "done":
        assert torch.equal(ctl, before_ctl) and torch.equal(prev, before_prev)
        return
    assert torch.equal(prev, cur if copy else before_prev)
    assert int(ctl[split_loop.IT]) == int(before_ctl[split_loop.IT]) + 1
    assert int(ctl[split_loop.SWEEPS]) == 1 and int(ctl[split_loop.STEPS]) == 1
    done = case in ("still", "cap")
    assert int(ctl[split_loop.PHASE]) == (split_loop.DONE if done
                                          else split_loop.NET)


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
d = np.load(os.environ["OPENR_INPUTS"])
P = distributed.shard_host_array
se, ss = {}, {}
edge = sharded_sssp_padded(
    *(P(d[k], mesh, (GRAPH_AXIS,)) for k in ("es", "ed", "em", "blocked")),
    P(d["roots_e"], mesh, (SOURCES_AXIS,)), mesh, int(d["vp"]), stats=se)
split = sharded_sssp_split(
    P(d["base_nbr"], mesh, (GRAPH_AXIS, None)),
    P(d["base_wgt"], mesh, (GRAPH_AXIS, None)),
    *(P(d[k], mesh, ()) for k in ("ov_ids", "ov_nbr", "ov_wgt", "over")),
    P(d["roots_s"], mesh, (SOURCES_AXIS,)), mesh, stats=ss)
out = {"edge_stats": np.array([se["replays"], se["host_syncs"],
                               se["rounds"], se["block"]]),
       "split_stats": np.array([ss["replays"], ss["host_syncs"],
                                ss["sweeps"], ss["block"]])}
for name, arr in (("edge", edge), ("split", split)):
    for _p, idx, piece in arr.local():
        (r0, r1), (c0, c1) = idx
        out[f"{name}:{c0}:{c1}"] = piece.numpy()
np.savez(os.environ["OPENR_OUT"], **out)
distributed.shutdown()
print(f"WORKER_OK rank={mesh.rank}")
"""


def test_two_processes_run_the_same_blocks(tmp_path):
    """Two gloo ranks form a (4, 2) mesh whose graph rows span both; at
    K = 4 both run the same blocks (the exit needs no collective of its
    own), with one host read each, and their pieces equal the JAX
    solves."""
    from openr_tpu.ops.spf import pad_batch

    es, ed, em, vp, n, _e = jtopo.erdos_renyi_csr(500, avg_degree=5,
                                                  seed=13, max_metric=32)
    blocked = build_blocked(em, es, np.zeros(vp, bool))
    roots_e = np.arange(pad_batch(8), dtype=np.int32) * 11 % n
    t = build_split_tables(es, ed, em, n)
    roots_s = np.arange(16, dtype=np.int32) * 29 % n
    inputs = dict(es=es, ed=ed, em=em, blocked=blocked, vp=vp,
                  roots_e=roots_e, roots_s=roots_s,
                  over=np.zeros(t["vp"], bool),
                  **{k: t[k] for k in ("base_nbr", "base_wgt", "ov_ids",
                                        "ov_nbr", "ov_wgt")})
    np.savez(tmp_path / "inputs.npz", **inputs)
    port = _free_port()
    procs = []
    for pid in (0, 1):
        env = dict(os.environ, OPENR_COORDINATOR=f"127.0.0.1:{port}",
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
            outs.append(p.communicate(timeout=120))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    for (out, err), p in zip(outs, procs):
        assert p.returncode == 0, f"worker failed\n{out}\n{err[-3000:]}"
        assert "WORKER_OK" in out, out

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
    stats = []
    for pid in (0, 1):
        with np.load(tmp_path / f"out{pid}.npz") as got:
            stats.append({k: got[k].tolist() for k in ("edge_stats",
                                                       "split_stats")})
            for key in got.files:
                if key.endswith("_stats"):
                    continue
                name, c0, c1 = key.split(":")
                np.testing.assert_array_equal(
                    got[key], want[name][:, int(c0):int(c1)])
    assert stats[0] == stats[1]  # the same blocks in both processes
    for key in ("edge_stats", "split_stats"):
        replays, syncs, trips, k = stats[0][key]
        assert k == sharded_spf.BLOCK == 4  # the default K
        assert replays == syncs == _blocks(trips, 4) >= 1

"""The port's telemetry plane against the JAX package's: `Counters`, the
work ledger and the efficiency join equal the reference's on the same
inputs; the solver commits the same `election` rounds as `TpuSpfSolver`;
the HBM gauges latch off without CUDA; the kernel cost rows equal a hand
count and are captured once per shape; host transfers and builds are
counted; and a node whose Decision runs on the port answers ctrl
`get_device_telemetry`."""

import dataclasses
import sys

import numpy as np
import pytest
import torch

import openr_tpu.monitor.work_ledger as ref_work_ledger
import openr_tpu.types.network as ref_network
import openr_tpu.types.routes as ref_routes
from openr_tpu.config import Config, DecisionConfig, NodeConfig
from openr_tpu.decision.decision import Decision
from openr_tpu.decision.spf_backend import TpuSpfSolver
from openr_tpu.messaging import ReplicateQueue
from openr_tpu.monitor import counters as ref_counters
from openr_tpu.monitor import device as ref_device
from openr_tpu.utils import topogen
from openr_tpu_torch import TorchSpfSolver
from openr_tpu_torch.decision import hook
from openr_tpu_torch.monitor import compile_ledger, device, work_ledger
from openr_tpu_torch.monitor.counters import Counters
from openr_tpu_torch.monitor.profiling import annotate
from openr_tpu_torch.ops import (
    cuda_build, election, ksp, relax, rib_epilogue, split_loop,
)
from openr_tpu_torch.ops.spf import all_sources_sssp, build_dense_tables
from openr_tpu_torch.utils.topogen import erdos_renyi_lsdb
from tests.test_rebuild_scoped import adj_pub, one_prefix_pub, prefix_pub, run
from tests.test_torch_caches import JAX, PORT, build
from tests.test_torch_decision import anycast_pub

# one intra-op thread: the suite runs several test workers at once
torch.set_num_threads(1)

INF = 1 << 30
#: counter names the sequences write (the solver's span and gauge names)
NAMES = ("profile.spf:batched_solve_ms", "profile.spf:rib_assembly_ms",
         "decision.spf.solves", "device.0.hbm_bytes_in_use",
         "work.election.touched")


# ------------------------------------------------------------ (a) Counters


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_counters_snapshot_equals_reference(seed):
    rng = np.random.default_rng(seed)
    mine, ref = Counters(), ref_counters.Counters()
    t = 1000.0
    for _ in range(400):
        op = int(rng.integers(0, 3))
        name = NAMES[int(rng.integers(0, len(NAMES)))]
        value = float(rng.lognormal(0.0, 2.0))
        t += float(rng.exponential(3.0))
        for c in (mine, ref):
            if op == 0:
                c.set(name, value)
            elif op == 1:
                c.increment(name, value)
            else:
                c.add_value(name, value, now=t)
    for now in (t, t + 30.0, t + 300.0, t + 3000.0):
        assert mine.snapshot(now=now) == ref.snapshot(now=now)
    for name in NAMES:
        assert mine.get(name, -1.0) == ref.get(name, -1.0)


# --------------------------------------------------------- (b) work ledger


def _ledger_ops(seed):
    """A seeded sequence of ledger calls: commits, scopes, warm marks."""
    rng = np.random.default_rng(seed)
    stages = ("election", "dirt", "fib", "merge", "spf_full")
    ops = []
    for i in range(200):
        stage = stages[int(rng.integers(0, len(stages)))]
        delta = int(rng.integers(0, 50))
        touched = int(delta * rng.integers(1, 20) + rng.integers(0, 80))
        kind = int(rng.integers(0, 10))
        if i == 60 or kind == 9 and i > 100:
            ops.append(("mark_warm",))
        elif kind < 5:
            ops.append(("commit", stage, touched, delta))
        else:
            ops.append(("scope", stage, touched, delta))
    return ops


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_work_ledger_rows_equal_reference(seed):
    mine, ref = work_ledger.WorkLedger(), ref_work_ledger.WorkLedger()
    for op in _ledger_ops(seed):
        for led in (mine, ref):
            if op[0] == "mark_warm":
                led.mark_warm()
            elif op[0] == "commit":
                led.commit(*op[1:])
            else:
                with led.scope(op[1], op[3]) as ws:
                    ws.add(op[2])
    assert mine.rows() == ref.rows()
    assert mine.since_warm() == ref.since_warm()
    for k, floor in ((8.0, 64), (2.0, 0)):
        assert mine.steady_violations(k=k, floor=floor) == \
            ref.steady_violations(k=k, floor=floor)
    assert mine.top_offender() == ref.top_offender()
    got, want = Counters(), ref_counters.Counters()
    mine.export_to(got)
    ref.export_to(want)
    assert got.snapshot() == want.snapshot()
    assert work_ledger.STAGES == ref_work_ledger.STAGES


# ------------------------------------------------ (c) election commits


def _election_row(rows):
    return next(((r["touched"], r["delta"], r["rounds"]) for r in rows
                 if r["stage"] == "election"), None)


@pytest.mark.parametrize("topo", ["fat_tree4", "er40"])
@pytest.mark.parametrize("lfa", [False, True])
def test_election_commits_equal_tpu_solver(topo, lfa):
    """Plain, anycast (on the device election's twin), UCMP and KSP
    prefixes: a full `compute_routes` and an `assemble_prefix_routes`
    commit equal touched / delta in both packages."""
    jls, jps = build(JAX, topo)
    pls, pps = build(PORT, topo)
    ref_solver = TpuSpfSolver(native_rib="off", enable_lfa=lfa, ksp_k=2)
    ref_solver.elect_device_min = 0
    mine = work_ledger.WorkLedger()
    solver = TorchSpfSolver(device="cpu", enable_lfa=lfa, ksp_k=2,
                            work_ledger=mine)
    solver.elect_device_min = 0
    ref_work_ledger.reset()
    try:
        _rdb, jart = ref_solver.compute_routes(jls, jps, "node-0",
                                               return_artifact=True)
        _rdb, part = solver.compute_routes(pls, pps, "node-0",
                                           return_artifact=True)
        full = _election_row(ref_work_ledger.rows())
        assert full is not None and full[2] == 1
        assert _election_row(mine.rows()) == full
        scope_j = sorted(jps.prefixes)[::3]
        scope_p = sorted(pps.prefixes)[::3]
        assert [p.prefix for p in scope_j] == [p.prefix for p in scope_p]
        ref_solver.assemble_prefix_routes(jart, jps, scope_j)
        solver.assemble_prefix_routes(part, pps, scope_p)
        both = _election_row(ref_work_ledger.rows())
        assert both[2] == 2 and both[1] > full[1]
        assert _election_row(mine.rows()) == both
    finally:
        ref_work_ledger.reset()


def test_solver_defaults_to_the_process_ledger():
    work_ledger.reset()
    ls, ps, _csr = erdos_renyi_lsdb(60, avg_degree=4, seed=2, max_metric=8)
    TorchSpfSolver(device="cpu").compute_routes(ls, ps, "node-0")
    assert _election_row(work_ledger.rows()) == (60, 60, 1)
    work_ledger.reset()


# ------------------------------------------------- (d) efficiency join


def _row_pair(fn, span, complete, flops, nbytes, captures=1):
    kw = dict(fn=fn, span=span, span_complete=complete, flops=flops,
              bytes_accessed=nbytes, arg_bytes=100, out_bytes=40,
              temp_bytes=8, code_bytes=1 << 20, captures=captures,
              shapes="(4, 8)")
    return device.KernelCostRow(**kw, launches=3, sources=("relax",)), \
        ref_device.KernelCostRow(**kw)


def test_efficiency_rows_equal_reference():
    pairs = {
        "batched_sssp_split_rib": _row_pair(
            "batched_sssp_split_rib", "spf:batched_solve", True, 4.0e6, 2.5e7),
        "_relax_once": _row_pair("_relax_once", "spf:batched_dist", False,
                                 1.0e5, 2.0e6),
        "_elect_seg": _row_pair("_elect_seg", "spf:election", True, 8.0e3,
                                1.7e4, captures=2),
        "no_span": _row_pair("no_span", None, True, 1.0, 2.0),
        "idle": _row_pair("idle", "spf:ksp", True, 3.0, 5.0),
    }
    snap_c = ref_counters.Counters()
    for i, span in enumerate(("spf:batched_solve", "spf:batched_dist",
                              "spf:election")):
        for v in (1.5, 2.5, 12.0 * (i + 1)):
            snap_c.add_value(f"profile.{span}_ms", v)
    snap = snap_c.snapshot()
    mine = device.efficiency_rows({k: a for k, (a, _b) in pairs.items()},
                                  snap)
    ref = ref_device.efficiency_rows({k: b for k, (_a, b) in pairs.items()},
                                     snap)
    assert len(mine) == len(ref) == len(pairs)
    for m, r in zip(mine, ref):
        assert set(m) - set(r) == {"launches", "sources"}
        assert {k: m[k] for k in r} == r
    by_fn = {m["fn"]: m for m in mine}
    assert by_fn["_relax_once"]["achieved_gbs"] is None  # dispatch only
    assert by_fn["batched_sssp_split_rib"]["achieved_gbs"] > 0
    assert by_fn["idle"]["span_count"] == 0


# --------------------------------------------------------- (e) HBM gauges


def test_sample_hbm_latches_off_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("the latch is for hosts without CUDA")
    tel = device.DeviceTelemetry()
    c = Counters()
    assert tel.hbm_available is None
    assert tel.sample_hbm(c) is None
    assert tel.hbm_available is False
    assert tel.sample_hbm(c) is None and tel.hbm_in_use_mb() is None
    assert c.snapshot() == {}
    # a span exit samples the process telemetry: nothing written either
    with annotate("spf:batched_solve", c):
        pass
    assert not [k for k in c.snapshot() if k.startswith("device.")]
    assert device.telemetry().hbm_available is False


# ------------------------------------------------ (f) kernel cost rows


class Launches:
    """The plain twins' calls (every CPU launch goes through them), with
    what a hand count needs, recorded through monkeypatch."""

    def __init__(self, monkeypatch):
        self.relax, self.elect, self.sssp, self.walk = [], [], [], []
        # the split loop's and the RIB epilogue's calls that did work,
        # counted by hand as they are made (the loop's state moves on)
        self.loop = []
        self._spy_loop(monkeypatch)
        rows_ref, elect_ref = relax.relax_rows_ref, election.elect_seg_ref
        sssp_ref, walk_ref = ksp.ksp_sssp_ref, ksp.ksp_walk_ref

        def relax_spy(dist_in, out, nbr, wgt, roots, over=None, **kw):
            # the row lists as they are now: the split loop reuses them
            self.relax.append((nbr, wgt, dist_in.shape[1], over, {
                k: v.clone() if torch.is_tensor(v) else v
                for k, v in kw.items()}))
            return rows_ref(dist_in, out, nbr, wgt, roots, over, **kw)

        def elect_spy(indptr, seg, adv, *a):
            self.elect.append((indptr.shape[0] - 1, adv.shape[0]))
            return elect_ref(indptr, seg, adv, *a)

        def sssp_spy(dist0, nbr, wgt, blocked, bans, root, b, **kw):
            live = kw.get("live")
            alive = live is None or bool(int(live[0]))
            out = sssp_ref(dist0, nbr, wgt, blocked, bans, root, b, **kw)
            self.sssp.append((nbr, wgt, blocked, out.clone(), alive))
            return out

        def walk_spy(dist, nbr, *a, live=None, counters=None):
            alive = live is None or bool(int(live[0]))
            res = walk_ref(dist, nbr, *a, live=live, counters=counters)
            self.walk.append((nbr.shape[1], a[8].clone(), alive))
            return res

        monkeypatch.setattr(relax, "relax_rows_ref", relax_spy)
        monkeypatch.setattr(election, "elect_seg_ref", elect_spy)
        monkeypatch.setattr(ksp, "ksp_sssp_ref", sssp_spy)
        monkeypatch.setattr(ksp, "ksp_walk_ref", walk_spy)

    def clear(self):
        for x in (self.relax, self.elect, self.sssp, self.walk, self.loop):
            x.clear()

    def _spy_loop(self, monkeypatch):
        sl = split_loop

        def spy(name, hand):
            ref = getattr(sl, name)

            def call(*a):
                ctl, mask = a[hand[0]], a[hand[1]]
                if (mask >> int(ctl[0])) & 1:
                    self.loop.append(hand[2](*a))
                return ref(*a)

            monkeypatch.setattr(sl, name, call)

        def snap_mark(dist, _snap, row_flag, frontier, out_nbr, _mark, ctl,
                      _m, with_frontier, dead):
            snap = 4 * dist.numel() + 4 * row_flag.numel() + 4
            if int(ctl[sl.PHASE]) != sl.TAIL:  # the mark is the tail's
                return snap, 0
            f = frontier[: int(ctl[sl.N_FRONT])].long()
            live = int((out_nbr[f] != dead).sum())
            n, w = f.shape[0], out_nbr.shape[1]
            return snap + 4 * (n + n * w + live + n * with_frontier), n * w

        def compact(flags, out, _ctl, _m, _c, _r, _d, clear, _decide):
            raw = int((flags != 0).sum())
            return (4 * flags.shape[0] + 4 * out.shape[0]
                    + 4 * raw * clear + 12, flags.shape[0])

        # (the places of ctl and phase_mask among the arguments, the count)
        spy("snap_mark_ref", (6, 7, snap_mark))
        spy("flag_compact_ref", (2, 3, compact))
        spy("split_ctl_ref", (0, 1, lambda *a: (128, 8)))
        buf_ref = rib_epilogue.rib_buffer_ref

        def epilogue(dist, metric, ids, over, my_id, with_lfa):
            vp, b = dist.shape
            n = ids.shape[0]
            assert b % 8 == 0  # rows start on a 32-byte sector
            rows = vp * 32 * -(-4 * (n + 1) // 32)  # columns 0..n's sectors
            bits = n * vp // 8 * (2 if with_lfa else 1)
            self.loop.append((rows + n * 9 + 4 * vp + bits
                              + (n * 4 if with_lfa else 0),
                              (12 if with_lfa else 5) * n * vp))
            return buf_ref(dist, metric, ids, over, my_id, with_lfa)

        monkeypatch.setattr(rib_epilogue, "rib_buffer_ref", epilogue)


def hand_relax(nbr, wgt, b, over, kw):
    """One relax call by hand: table rows, distinct gathered rows, the
    target rows in and out, flags, roots, index lists; 4 ops a finite
    slot and column."""
    n = kw["n"]
    if kw.get("src_rows") is not None:
        rows = kw["src_rows"][:n].long()
    else:
        rows = torch.arange(kw.get("row0", 0), kw.get("row0", 0) + n)
    w = wgt[rows]
    finite = w < INF
    gathered = len(set(nbr[rows][finite].tolist()))
    lists = sum(kw.get(k) is not None for k in ("src_rows", "dst_rows"))
    nbytes = (n * nbr.shape[1] * 8 + gathered * b * 4 + 2 * n * b * 4
              + b * 4 + n * 4 + 4 * n * lists
              + (n * nbr.shape[1] if over is not None else 0))
    return nbytes, int(finite.sum()) * b * 4


def hand_sssp(nbr, wgt, blocked, dist):
    v, d = wgt.shape
    b = dist.shape[1]
    usable = (wgt < INF) & ~blocked
    reached = (dist < INF).sum(dim=1)
    relaxations = sum(int(reached[int(u)]) for u in nbr[usable].tolist())
    finite = int((wgt < INF).sum())
    words = -(-b // 32)
    return (v * d * 4 + finite * (5 + 4 * words) + v * b * 4,
            4 * relaxations)


def hand_walk(d, hops):
    rows = int(hops.sum()) + hops.shape[0]
    return rows * d * 17 + hops.shape[0] * 16 + rows * 4, rows * d * 4


@pytest.mark.parametrize("overloaded", [False, True])
def test_cost_rows_equal_a_hand_count(monkeypatch, overloaded):
    """A CPU `compute_routes` with plain, anycast, UCMP and KSP prefixes
    (and an overloaded node, whose mask the relax reads): the split RIB
    solve's row is its relax calls by hand, the election's its M prefixes
    and S slots, KSP's its fixpoints and walks; a second identical call
    captures nothing."""
    device.telemetry().reset()
    spy = Launches(monkeypatch)
    ls, ps = build(PORT, "fat_tree4")
    if overloaded:
        db = ls.adjacency_db("node-5")
        ls.update_adjacency_db(dataclasses.replace(db, is_overloaded=True))
    solver = TorchSpfSolver(device="cpu", ksp_k=2)
    solver.elect_device_min = 0
    solver.compute_routes(ls, ps, "node-0")
    rows = device.kernel_rows()
    assert set(rows) == {"batched_sssp_split_rib", "_elect_seg",
                         "_ksp_edge_disjoint_dense_jit"}
    rib = rows["batched_sssp_split_rib"]
    want = [hand_relax(*c) for c in spy.relax] + spy.loop
    assert rib.launches == len(spy.relax) + len(spy.loop) > 0
    assert (rib.bytes_accessed, rib.flops) == tuple(map(sum, zip(*want)))
    assert all((c[3] is not None) == overloaded for c in spy.relax)
    assert rib.span == "spf:batched_solve" and rib.span_complete
    assert set(rib.sources) == {"relax", "split_loop", "rib_epilogue"}
    assert rib.code_bytes == 0
    assert rib.arg_bytes > 0 and rib.out_bytes > 0
    (m, s), = spy.elect
    el = rows["_elect_seg"]
    assert (el.bytes_accessed, el.flops) == (16 * s + 13 * m, 8 * s)
    want = [hand_sssp(*c[:4]) if c[4] else (0, 0) for c in spy.sssp]
    want += [hand_walk(d, h) if alive else (0, 0) for d, h, alive in spy.walk]
    k = rows["_ksp_edge_disjoint_dense_jit"]
    assert k.launches == len(spy.sssp) + len(spy.walk) > 0
    assert (k.bytes_accessed, k.flops) == tuple(map(sum, zip(*want)))
    assert k.temp_bytes > 0  # the ban words
    solver.compute_routes(ls, ps, "node-0")
    assert {n: r.captures for n, r in device.kernel_rows().items()} == \
        {n: 1 for n in rows}


def test_ksp_row_counts_no_work_in_skipped_rounds(monkeypatch):
    """On a line there is one edge-disjoint path to each job's dest, so
    round 2 finds none and rounds 3-4 return at once: they launch, and
    count no work."""
    device.telemetry().reset()
    spy = Launches(monkeypatch)
    src = np.array([1, 0, 2, 1, 3, 2], np.int32)  # 0-1-2-3, dst-sorted
    dst = np.array([0, 1, 1, 2, 2, 3], np.int32)
    nbr, wgt = build_dense_tables(src, dst, np.ones(6, np.int32), 8)
    ksp.ksp_edge_disjoint_dense(nbr, wgt, np.zeros(nbr.shape, bool), 0,
                                np.array([3, 2], np.int32), k=4,
                                max_hops=7, device="cpu", to_host=True)
    assert [c[4] for c in spy.sssp] == [True, True, False, False]
    assert [c[2] for c in spy.walk] == [True, True, False, False]
    want = [hand_sssp(*c[:4]) if c[4] else (0, 0) for c in spy.sssp]
    want += [hand_walk(d, h) if alive else (0, 0) for d, h, alive in spy.walk]
    row = device.kernel_rows()["_ksp_edge_disjoint_dense_jit"]
    assert row.launches == 8
    assert (row.bytes_accessed, row.flops) == tuple(map(sum, zip(*want)))


@pytest.mark.parametrize("kind", ["split", "dense", "pallas", "edge"])
def test_solve_dist_rows_per_table(monkeypatch, kind):
    """`_solve_dist` names its row by table kind, as the reference does;
    a new B recaptures, a B seen before does not."""
    device.telemetry().reset()
    spy = Launches(monkeypatch)
    _ls, _ps, csr = erdos_renyi_lsdb(200, avg_degree=4, seed=1, max_metric=9)
    kw = dict(split={}, dense=dict(use_dense=True),
              pallas=dict(use_pallas=True), edge=dict(use_dense=False))[kind]
    solver = TorchSpfSolver(device="cpu", **kw)
    name = dict(split="batched_sssp_split", dense="batched_sssp_dense",
                pallas="_relax_once", edge="batched_sssp")[kind]
    roots = np.arange(8, dtype=np.int32)
    dist = solver._solve_dist(csr, roots)
    row = device.kernel_rows()[name]
    assert row.span == "spf:batched_dist"
    assert row.span_complete == (kind != "pallas")
    if kind == "edge":
        t = solver._device_arrays(csr, "edge")
        v = csr.padded_nodes
        walked = int(t["index"].row_start[-1])
        usable = ~t["blocked"][:walked]
        out_deg = torch.bincount(t["src"][:walked][usable].long(),
                                 minlength=v)
        reached = (dist < INF).sum(dim=1)
        os_ = t["index"].out_start.long()
        deg = int((os_[roots + 1] - os_[roots]).sum())
        init = (v * 8 * 4 + v // 8 + 8 * 12 + deg * 12, deg + 8)
        fix = (2 * v * 8 * 4 + walked * 9 + (v + 1) * 4
               + int(t["index"].seg_node.shape[0]) * 8,
               4 * int((out_deg * reached).sum()))
        assert row.launches == 2
        assert (row.bytes_accessed, row.flops) == (init[0] + fix[0],
                                                   init[1] + fix[1])
    else:
        want = [hand_relax(*c) for c in spy.relax]
        if kind == "split":
            want += spy.loop
        if kind == "pallas":  # one sweep of equal sweeps
            assert row.launches == 1 and len(set(want)) == 1
            want = want[:1]
        else:
            assert row.launches == len(want)
        assert (row.bytes_accessed, row.flops) == tuple(map(sum, zip(*want)))
    solver._solve_dist(csr, roots)
    assert device.kernel_rows()[name].captures == 1
    solver._solve_dist(csr, np.arange(16, dtype=np.int32))
    solver._solve_dist(csr, roots)
    assert device.kernel_rows()[name].captures == 2


def test_first_hop_and_warm_rows(monkeypatch):
    device.telemetry().reset()
    ls, ps = build(PORT, "er40")
    dense = TorchSpfSolver(device="cpu", use_dense=True)
    csr, _dist, fh, _nbr, _lfa = dense.solve(ls, "node-0")
    row = device.kernel_rows()["first_hop_matrix"]
    vp, n = csr.padded_nodes, fh.shape[0]
    # kernel C's launch and its epilogue's count, as the split RIB's
    assert (row.bytes_accessed, row.flops, row.launches) == (
        *rib_epilogue.epilogue_work(vp, n + 1, n, False), 1)
    assert row.sources == ("rib_epilogue",)
    assert not row.span_complete
    solver = TorchSpfSolver(device="cpu")
    rdb, art = solver.compute_routes(ls, ps, "node-0", return_artifact=True)
    spy = Launches(monkeypatch)
    # a lowered metric off the root: its head re-pulls in the tail rounds
    node, i, a = next((n, i, a) for n in (f"node-{k}" for k in range(1, 40))
                      for i, a in enumerate(ls.adjacency_db(n).adjacencies)
                      if a.metric > 2 and a.other_node_name != "node-0")
    db = ls.adjacency_db(node)
    adjs = list(db.adjacencies)
    adjs[i] = dataclasses.replace(a, metric=1)
    ls.update_adjacency_db(dataclasses.replace(db, adjacencies=tuple(adjs)))
    got = solver.warm_compute_routes(art, ls, ps, "node-0",
                                     {(node, a.other_node_name)}, set(), rdb,
                                     0.5)
    assert got is not None
    row = device.kernel_rows()["batched_sssp_split_warm_rib"]
    assert row.span == "spf:warm_solve" and row.span_complete
    want = [hand_relax(*c) for c in spy.relax] + spy.loop
    assert row.launches == len(want) > 0
    assert (row.bytes_accessed, row.flops) == tuple(map(sum, zip(*want)))


def test_capture_off_when_disabled():
    tel = device.telemetry()
    tel.reset()
    tel.enabled = False
    try:
        _ls, _ps, csr = erdos_renyi_lsdb(80, avg_degree=4, seed=3,
                                         max_metric=9)
        TorchSpfSolver(device="cpu")._solve_dist(csr, np.arange(4))
        assert device.kernel_rows() == {}
    finally:
        tel.enabled = True
    c = Counters()
    tel.reset()
    TorchSpfSolver(device="cpu")._solve_dist(csr, np.arange(4))
    device.export_to(c)
    snap = c.snapshot()
    assert snap["cuda.kernel.batched_sssp_split.captures"] == 1
    assert snap["cuda.kernel.batched_sssp_split.bytes_accessed"] > 0


# ------------------------------------------------- (g) transfers, builds


def test_host_transfers_count_the_seams():
    led = compile_ledger.ledger()
    ls, ps, csr = erdos_renyi_lsdb(150, avg_degree=4, seed=4, max_metric=9)
    led.reset()
    solver = TorchSpfSolver(device="cpu")
    solved = solver.solve(ls, "node-0")
    vp, b = solved[1].shape
    packed = vp * 4 + (b - 1) * vp // 8
    assert led.transfers() == (1, packed)
    np.asarray(solved[1])  # the lazy matrix, once
    np.asarray(solved[1])
    assert led.transfers() == (2, packed + vp * b * 4)
    led.reset()
    TorchSpfSolver(device="cpu", use_dense=True, enable_lfa=True).solve(
        ls, "node-0")
    vp2 = csr.padded_nodes
    # kernel C's packed buffer: the root column, first hops and LFA bits
    assert led.transfers() == (1, rib_epilogue.buffer_bytes(vp2, b - 1,
                                                            True))
    led.reset()
    t = solver._device_arrays(csr, "edge")
    # the edge table set's index, built on the tensors' device: one read
    # of its checks and counts (4 int64)
    assert led.transfers() == (1, 32)
    all_sources_sssp(t["src"], t["dst"], t["metric"], t["blocked"],
                     csr.padded_nodes, chunk=64, index=t["index"])
    chunks = -(-csr.padded_nodes // 64)
    assert led.transfers() == (1 + chunks, 32 + csr.padded_nodes ** 2 * 4)


def test_host_syncs_count_the_split_loop():
    """`cuda.transfers.host_syncs` counts every read of the split loop's
    state: one solve moves it by that solve's `host_syncs`, on the RIB
    path and on the batched one; `host_reads` keeps counting only the
    transfers."""
    led = compile_ledger.ledger()
    ls, _ps, csr = erdos_renyi_lsdb(150, avg_degree=4, seed=4, max_metric=9)
    solver = TorchSpfSolver(device="cpu")
    for call in (lambda: solver.solve(ls, "node-0"),
                 lambda: solver._solve_dist(csr, np.arange(16) % 150)):
        led.reset()
        call()
        n = solver.last_solve_stats["host_syncs"]
        assert n == solver.last_solve_stats["replays"] >= 1
        assert led.host_syncs == n
        assert led.transfers()[0] <= 1
    c = Counters()
    led.export_to(c)
    assert c.get("cuda.transfers.host_syncs") == n


def test_election_and_ksp_transfers():
    led = compile_ledger.ledger()
    ls, ps = build(PORT, "fat_tree4")
    solver = TorchSpfSolver(device="cpu", ksp_k=2)
    solver.elect_device_min = 0
    solver.solve(ls, "node-0")
    led.reset()
    solver.compute_routes(ls, ps, "node-0")
    view = ps.election_view(ls.to_csr().name_to_id, ls.to_csr().base_version)
    m, s = len(view.multi.prefixes), len(view.multi.adv)
    reads, nbytes = led.transfers()
    # the packed buffer, the election's result buffer, one KSP chunk
    assert reads == 3 and nbytes > election.out_nbytes(m, s)


def test_builds_loads_and_warm(monkeypatch, tmp_path):
    """A build through a stand-in nvcc counts per source with its
    seconds; a library found from an earlier build is a load; no build
    after the warm mark is the steady state."""
    led = compile_ledger.ledger()
    led.reset()
    home = tmp_path / "cuda"
    (home / "bin").mkdir(parents=True)
    nvcc = home / "bin" / "nvcc"
    nvcc.write_text(
        f"#!{sys.executable}\nimport sys\n"
        "open(sys.argv[sys.argv.index('-o') + 1], 'wb').write(b'lib')\n")
    nvcc.chmod(0o755)
    monkeypatch.setenv("CUDA_HOME", str(home))
    monkeypatch.setattr(cuda_build, "BUILD_DIR", tmp_path / "_build")
    cuda_build.build("relax")
    cuda_build.build("election")
    assert led.builds() == {"relax": 1, "election": 1}
    assert set(led.build_seconds()) == {"relax", "election"}
    led.mark_warm()
    cuda_build.build("relax")  # built before: a load
    assert led.loads() == {"relax": 1} and led.builds_since_warm() == {}
    cuda_build.build("ksp")
    assert led.builds_since_warm() == {"ksp": 1}
    c = Counters()
    led.record_transfer(12)
    led.export_to(c)
    snap = c.snapshot()
    assert snap["cuda.builds.relax"] == 1 and snap["cuda.builds.total"] == 3
    assert (snap["cuda.transfers.host_reads"],
            snap["cuda.transfers.host_bytes"]) == (1, 12)
    assert not [k for k in snap if k.startswith("jax.")]
    led.reset()


def test_ledgers_and_captures_under_threads():
    """Threads record transfers, commit work and capture rows at once,
    with a short switch interval: every add lands, and each capture's
    sink holds only its own thread's launches."""
    import threading

    led, work = compile_ledger.CompileLedger(), work_ledger.WorkLedger()
    tel = device.DeviceTelemetry()
    n_threads, n = 16, 300
    errors = []

    def worker(i):
        try:
            for j in range(n):
                led.record_transfer(3)
                work.commit("election", 2, 1)
                with tel.observe(f"fn{i}", j % 4) as cap:
                    for _ in range(3):  # as a wrapper adds a launch
                        sink = device.sink()
                        if sink is not None:
                            sink.add("relax", i + 1, 1)
                if bool(cap) != (j < 4):
                    errors.append((i, j, "captured a seen key"))
        except Exception as e:  # noqa: BLE001 — reported below
            errors.append((i, repr(e)))

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=worker, args=(i,))
                   for i in range(n_threads)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
    finally:
        sys.setswitchinterval(old)
    assert not any(t.is_alive() for t in threads)
    assert errors == []
    assert led.transfers() == (n_threads * n, 3 * n_threads * n)
    assert _election_row(work.rows()) == (2 * n_threads * n,
                                          n_threads * n, n_threads * n)
    rows = tel.kernel_rows()
    for i in range(n_threads):
        r = rows[f"fn{i}"]
        assert (r.bytes_accessed, r.flops, r.launches, r.captures) == (
            3 * (i + 1), 3, 3, 4)
    assert device.sink() is None


# ----------------------------------------- (h) a port-backed Decision


def mk_decision(port):
    cfg = Config(NodeConfig(node_name="node-0", decision=DecisionConfig()))
    d = Decision(cfg, ReplicateQueue(name="pubs").get_reader(),
                 ReplicateQueue(name="routes"),
                 solver="cpu" if port else "tpu",
                 counters=ref_counters.Counters())
    if port:
        hook.attach(d, ref_routes, ref_network, device="cpu",
                    work_ledger=ref_work_ledger)
    return d


def rebuilds(d):
    """A full rebuild, then two prefix-only ones (an add, a withdrawal)."""
    async def body():
        adj_dbs, prefix_dbs = topogen.fat_tree(4)
        names = [db.this_node_name for db in adj_dbs]
        for pub in (adj_pub(adj_dbs), prefix_pub(prefix_dbs),
                    anycast_pub(names, 1)):
            d.process_publication(pub)
        await d._rebuild_routes()
        d.process_publication(one_prefix_pub(names[5], "10.77.0.0/24",
                                             version=3))
        await d._rebuild_routes()
        d.process_publication(one_prefix_pub(names[6], "10.77.0.0/24",
                                             version=3))
        await d._rebuild_routes()

    run(body())


def test_port_backed_decision_election_rows_equal_tpu():
    ref_work_ledger.reset()
    try:
        rebuilds(mk_decision(False))
        want = _election_row(ref_work_ledger.rows())
        ref_work_ledger.reset()
        d = mk_decision(True)
        rebuilds(d)
        got = _election_row(ref_work_ledger.rows())
        assert want is not None and want[2] >= 2
        assert got == want
        assert d.counters.get("decision.rebuild.prefix_only") > 0
        snap = d.counters.snapshot()
        assert snap["work.election.touched"] == want[0]
    finally:
        ref_work_ledger.reset()


def test_port_backed_decision_exports_before_the_reference():
    """The adapter's exports land at the rebuild edge, before the
    Decision's own `jax.*` ones; only `device.<i>.hbm_*` could share a
    name, and without CUDA neither side writes it."""
    d = mk_decision(True)
    order = []
    real_set = d.counters.set

    def spy(key, value):
        order.append(key)
        real_set(key, value)

    d.counters.set = spy
    rebuilds(d)
    assert d._tpu.last_shard_rows == []
    first_jax = next(i for i, k in enumerate(order) if k.startswith("jax."))
    cuda = [i for i, k in enumerate(order) if k.startswith("cuda.")]
    assert cuda and cuda[0] < first_jax
    snap = d.counters.snapshot()
    assert snap["cuda.transfers.host_reads"] > 0
    assert snap["cuda.kernel.batched_sssp_split_rib.bytes_accessed"] > 0
    assert "cuda.builds.total" in snap
    if not torch.cuda.is_available():
        assert not [k for k in snap if k.startswith("device.")]
    tele = d._tpu.device_telemetry()
    assert set(tele) == {"kernels", "devices", "hbm_available", "shards"}
    assert tele["shards"] == [] and "batched_sssp_split_rib" in {
        k["fn"] for k in tele["kernels"]}
    row = next(k for k in tele["kernels"]
               if k["fn"] == "batched_sssp_split_rib")
    assert row["span_count"] == 1 and row["achieved_gbs"] > 0


def test_ctrl_get_device_telemetry_on_a_port_backed_node():
    from openr_tpu.emulator import Cluster
    from openr_tpu.rpc import RpcClient

    async def body():
        c = Cluster.from_edges([("a", "b")], enable_ctrl=True)
        await c.start()
        try:
            await c.wait_converged(timeout=30)
            adapter = hook.attach(c.nodes["a"].decision, ref_routes,
                                  ref_network, device="cpu")
            cli = RpcClient(port=c.nodes["a"].ctrl.port)
            await cli.connect()
            try:
                return adapter, await cli.call("get_device_telemetry", {})
            finally:
                await cli.close()
        finally:
            await c.stop()

    adapter, res = run(body())
    assert res["node"] == "a"
    assert res["shards"] == []
    assert res["hbm_available"] is False
    assert adapter.last_shard_rows == []


def test_ctrl_get_device_telemetry_serves_the_port():
    """With `device_telemetry=` the reference module ctrl reads serves
    the port's planes: ctrl's kernels, devices, hbm_available and shards
    (of a meshed attach's sharded solve) equal the adapter's own answer,
    and `detach` gives the module its functions back."""
    from openr_tpu.emulator import Cluster
    from openr_tpu.rpc import RpcClient

    names = hook.DecisionAdapter.TELEMETRY_NAMES
    originals = {n: getattr(ref_device, n) for n in names}
    _ls, _ps, csr = erdos_renyi_lsdb(40, avg_degree=4, seed=3, max_metric=9)

    async def body():
        c = Cluster.from_edges([("a", "b")], enable_ctrl=True)
        await c.start()
        adapter = None
        try:
            await c.wait_converged(timeout=30)
            dec = c.nodes["a"].decision
            dcfg = dec.config.node.decision
            dcfg.mesh_sources, dcfg.mesh_graph = 4, 2
            adapter = hook.attach(dec, ref_routes, ref_network,
                                  device="cpu", device_telemetry=ref_device,
                                  mesh_devices=[torch.device("cpu")] * 8)
            assert all(getattr(ref_device, n) is not originals[n]
                       for n in names)
            adapter.solver._solve_dist(csr, np.arange(8, dtype=np.int32))
            cli = RpcClient(port=c.nodes["a"].ctrl.port)
            await cli.connect()
            try:
                res = await cli.call("get_device_telemetry", {})
            finally:
                await cli.close()
            return res, adapter.device_telemetry()
        finally:
            if adapter is not None:
                adapter.detach()
            await c.stop()

    try:
        res, want = run(body())
        detached = {n: getattr(ref_device, n) is originals[n] for n in names}
    finally:  # the workers share the module: never leave a stand-in
        for n, fn in originals.items():
            setattr(ref_device, n, fn)
    assert {k: res[k] for k in want} == want
    assert len(res["shards"]) == 8 and res["hbm_available"] is False
    assert "sharded_sssp_split" in {k["fn"] for k in res["kernels"]}
    assert all(detached.values()), detached


def test_hook_attach_default_ledger():
    d = Decision(Config(NodeConfig(node_name="node-0")),
                 ReplicateQueue(name="pubs").get_reader(),
                 ReplicateQueue(name="routes"), solver="cpu",
                 counters=ref_counters.Counters())
    adapter = hook.attach(d, ref_routes, ref_network, device="cpu")
    assert adapter.solver.work_ledger is work_ledger.ledger()

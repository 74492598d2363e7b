"""The split solve's loop as a program on the device (`SplitProgram`,
`ops/split_loop.py`) against the JAX package: the compaction twin
against `_compact_ids`, the mark and the decisions against hand models,
the whole program (cold, with the RIB buffer, and warm) against
`batched_sssp_split_rib` and `batched_sssp_split_warm_rib` at one step a
block and at blocks larger than the solve, a kept program reused from
other roots, and the solver's host syncs, one per block. Every
comparison is exact."""

import dataclasses
import pathlib
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from openr_tpu.ops import spf_split as jsplit
from openr_tpu_torch import LinkState, PrefixState, TorchSpfSolver
from openr_tpu_torch.convert import split_tables_from_numpy
from openr_tpu_torch.monitor import compile_ledger
from openr_tpu_torch.ops import relax, rib_epilogue, split_loop as sl
from openr_tpu_torch.ops import spf_split as psplit
from openr_tpu_torch.utils import topogen as ptopo
from test_torch_solver import _states
from test_torch_spf_split import CASES, _jax_args, _problem
from test_torch_warm import KERNEL_D

INF = 1 << 30
CSRC = pathlib.Path(__file__).resolve().parents[1] / "openr_tpu_torch" / "csrc"

# one intra-op thread: the suite runs several test workers at once
torch.set_num_threads(1)


def _ctl(phase, **words):
    ctl = sl.new_ctl(phase, 1024, 64, 1 << 20, "cpu")
    for k, v in words.items():
        ctl[getattr(sl, k)] = v
    return ctl


# ------------------------------------------------------------ compaction


MASKS = ("empty", "full", "over_cap", "at_cap", "one", "dead_slot",
         "random")


def _mask(kind, vp, cap, rng):
    m = np.zeros(vp, bool)
    if kind == "full":
        m[:] = True
    elif kind in ("over_cap", "at_cap"):
        m[rng.choice(vp, cap + (kind == "over_cap"), replace=False)] = True
    elif kind == "one":
        m[vp // 3] = True
    elif kind == "dead_slot":
        m[[0, 5, vp - 1]] = True
    elif kind == "random":
        m = rng.random(vp) < 0.2
    return m


@pytest.mark.parametrize("kind", MASKS)
@pytest.mark.parametrize("clear", [False, True])
def test_compaction_twin_equals_jax_compact_ids(kind, clear):
    vp, cap = 4096, 512
    rng = np.random.default_rng(MASKS.index(kind))
    mask = _mask(kind, vp, cap, rng)
    iota = jnp.arange(vp, dtype=jnp.int32)
    ref = np.asarray(jsplit._compact_ids(jnp.where(jnp.asarray(mask), iota,
                                                   vp), vp, cap, vp - 1))
    flags = torch.from_numpy(mask.astype(np.int32) * 3)
    out = torch.full((cap,), 7, dtype=torch.int32)
    ctl = _ctl(sl.TAIL)
    sl.flag_compact(flags, out, ctl, sl.M_TAIL, sl.N_FRONT, sl.RAW_FRONT,
                    vp - 1, clear)
    np.testing.assert_array_equal(out.numpy(), ref)
    raw = int(mask.sum())
    assert int(ctl[sl.RAW_FRONT]) == raw
    assert int(ctl[sl.N_FRONT]) == min(raw, cap)
    assert int(ctl[sl.SPILL]) == (raw > cap)
    assert bool((flags == 0).all()) if clear else int(flags.sum()) == 3 * raw
    # another phase's call touches nothing
    flags2, out2 = torch.from_numpy(mask.astype(np.int32)), out.clone()
    ctl2 = _ctl(sl.DENSE)
    sl.flag_compact(flags2, out2, ctl2, sl.M_TAIL, sl.N_FRONT, sl.RAW_FRONT,
                    vp - 1, True)
    assert torch.equal(out2, out) and torch.equal(ctl2, _ctl(sl.DENSE))
    assert int(flags2.sum()) == raw


@pytest.mark.parametrize("with_frontier", [False, True])
def test_mark_twin_marks_the_out_neighbors(with_frontier):
    es, ed, em, _vp, nn, e = ptopo.erdos_renyi_csr(900, avg_degree=6, seed=2,
                                                    max_metric=9)
    t = jsplit.build_split_tables(es, ed, em, nn)
    vp, dead = t["vp"], t["vp"] - 1
    rng = np.random.default_rng(4)
    front = np.sort(rng.choice(nn, 40, replace=False)).astype(np.int32)
    frontier = np.full(64, dead, np.int32)
    frontier[:40] = front
    mark = torch.zeros(vp, dtype=torch.int32)
    ctl = _ctl(sl.TAIL, N_FRONT=40)
    sl.frontier_mark(torch.from_numpy(frontier), torch.from_numpy(
        t["out_nbr"]), mark, ctl, sl.M_TAIL, with_frontier, dead)
    want = np.zeros(vp, bool)
    src, dst = es[:e], ed[:e]
    want[dst[np.isin(src, front) & (em[:e] < INF)]] = True
    if with_frontier:
        want[front] = True
    np.testing.assert_array_equal(mark.numpy() != 0, want)


# (phase, stage, words) -> (phase, it, sweeps, tail_rounds, steps)
DECISIONS = [
    ((sl.DENSE, 0, dict(ROWS_CHANGED=2000)), (sl.DENSE, 1, 1, 0, 1)),
    ((sl.DENSE, 0, dict(ROWS_CHANGED=1024)), (sl.TAIL, 0, 1, 0, 1)),
    ((sl.DENSE, 0, dict(ROWS_CHANGED=5000, IT=(1 << 20) - 1)),
     (sl.TAIL, 0, 1, 0, 1)),
    ((sl.TAIL, 0, dict(IT=3)), (sl.TAIL, 4, 0, 1, 1)),
    ((sl.NET, 0, dict(ROWS_CHANGED=4)), (sl.NET, 1, 1, 0, 1)),
    ((sl.NET, 0, dict(ROWS_CHANGED=0)), (sl.DONE, 1, 1, 0, 1)),
    ((sl.TAIL, 1, dict(RAW_FRONT=0)), (sl.DONE, 0, 0, 0, 0)),
    ((sl.TAIL, 1, dict(RAW_FRONT=3, IT=5)), (sl.TAIL, 5, 0, 0, 0)),
    ((sl.TAIL, 1, dict(RAW_FRONT=3, IT=64)), (sl.NET, 0, 0, 0, 0)),
    ((sl.TAIL, 1, dict(RAW_FRONT=0, SPILL=1, IT=2)), (sl.NET, 0, 0, 0, 0)),
    ((sl.DONE, 0, dict(IT=7)), (sl.DONE, 7, 0, 0, 0)),
]


def _decide_flags(raw, n=4096):
    """Crafted flags with `raw` set, spread over the array."""
    flags = torch.zeros(n, dtype=torch.int32)
    flags[torch.linspace(0, n - 2, raw).long()] = 1
    return flags


def _words(ctl):
    return tuple(int(ctl[k]) for k in (sl.PHASE, sl.IT, sl.SWEEPS,
                                       sl.TAIL_ROUNDS, sl.STEPS))


@pytest.mark.parametrize("case", range(len(DECISIONS)))
def test_decisions_follow_the_reference_conditions(case):
    """cond1 (`openr_tpu/ops/spf_split.py:383`) and cond3 (:455), stage 0,
    are `split_ctl_kernel`'s twin after a step's relaxes; cond2 (:407)
    and the net's entry, stage 1, are the frontier compaction's with
    `decide`: its RAW_FRONT comes from crafted flags, SPILL from before."""
    (phase, stage, words), want = DECISIONS[case]
    ctl = _ctl(phase, **words)
    if stage == 0:
        sl.split_ctl(ctl, sl.M_ALL)
    else:
        raw = words.pop("RAW_FRONT")
        ctl = _ctl(phase, **words)
        out = torch.empty(512, dtype=torch.int32)
        sl.flag_compact(_decide_flags(raw), out, ctl, sl.M_TAIL, sl.N_FRONT,
                        sl.RAW_FRONT, 4095, False, decide=True)
        assert int(ctl[sl.RAW_FRONT]) == int(ctl[sl.N_FRONT]) == raw
    assert _words(ctl) == want


@pytest.mark.parametrize("raw", [0, 3, 600])
def test_compaction_without_decide_leaves_phase_and_it(raw):
    """Without `decide` the compaction writes its counts (and a spill
    past the cap) but neither PHASE nor IT; with it, its own spill sends
    the tail to the net."""
    ctl = _ctl(sl.TAIL, IT=64)
    out = torch.empty(512, dtype=torch.int32)
    sl.flag_compact(_decide_flags(raw), out, ctl, sl.M_TAIL, sl.N_FRONT,
                    sl.RAW_FRONT, 4095, False)
    assert (int(ctl[sl.PHASE]), int(ctl[sl.IT])) == (sl.TAIL, 64)
    assert int(ctl[sl.RAW_FRONT]) == raw
    assert int(ctl[sl.SPILL]) == (raw > 512)
    ctl2 = _ctl(sl.TAIL, IT=1)
    sl.flag_compact(_decide_flags(raw), out, ctl2, sl.M_TAIL, sl.N_FRONT,
                    sl.RAW_FRONT, 4095, False, decide=True)
    want = sl.NET if raw > 512 else sl.DONE if raw == 0 else sl.TAIL
    assert int(ctl2[sl.PHASE]) == want


@pytest.mark.parametrize("phase", [sl.DENSE, sl.TAIL])
def test_guarded_relax_twin(phase):
    """Kernel A's twin under the loop guard: the listed rows up to the
    live count in its phase, nothing in another."""
    t, over, roots, *_ = _problem(n=1200, deg=6, mw=16, seed=3)
    tab = split_tables_from_numpy(t, over, "cpu")
    vp = t["vp"]
    rng = np.random.default_rng(5)
    dist = torch.from_numpy(rng.integers(0, 60, (vp, roots.shape[0]))
                            .astype(np.int32))
    rows = torch.from_numpy(np.concatenate([
        rng.choice(vp - 1, 300, replace=False), np.full(212, vp - 1)
    ]).astype(np.int32))
    r = torch.from_numpy(roots)
    want = dist.clone()
    relax.relax_rows_ref(dist, want, tab["base_nbr"], tab["base_wgt"], r,
                         src_rows=rows, dst_rows=rows, n=120)
    for fn in (relax.relax_rows, relax.relax_rows_ref):
        got = dist.clone()
        ctl = _ctl(phase, N_ROWS=120)
        fn(dist, got, tab["base_nbr"], tab["base_wgt"], r, src_rows=rows,
           dst_rows=rows, ctl=ctl, phase_mask=sl.M_TAIL,
           n_live=ctl[sl.N_ROWS:sl.N_ROWS + 1])
        assert torch.equal(got, want if phase == sl.TAIL else dist)


# ------------------------------------------------------- whole program


@pytest.mark.parametrize("steps", [1, None, 4096])
@pytest.mark.parametrize("case", sorted(CASES))
def test_program_equals_jax_split_rib(case, steps):
    pkw, skw, with_lfa = CASES[case]
    t, over, roots, nbr_metric, nbr_ids, nbr_over = _problem(**pkw)
    my_id = int(roots[0])
    ref_dist, ref_buf = jsplit.batched_sssp_split_rib(
        *_jax_args(t, over, roots),
        jnp.asarray(nbr_metric), jnp.asarray(nbr_ids),
        jnp.asarray(nbr_over), jnp.int32(my_id),
        with_lfa=with_lfa, **skw,
    )
    progs = psplit.ProgramCache(steps=steps)
    tables = split_tables_from_numpy(t, over, "cpu")
    for _ in range(2):  # a fresh program, then the kept one again
        stats = {}
        dist, buf = psplit.batched_sssp_split_rib(
            tables, torch.from_numpy(roots), torch.from_numpy(nbr_metric),
            torch.from_numpy(nbr_ids), torch.from_numpy(nbr_over), my_id,
            with_lfa=with_lfa, stats=stats, programs=progs, **skw,
        )
        np.testing.assert_array_equal(dist.numpy(), np.asarray(ref_dist))
        np.testing.assert_array_equal(buf.numpy(), np.asarray(ref_buf))
        assert len(progs) == 1
        k = steps or psplit.STEPS_COLD
        assert stats["host_syncs"] == stats["replays"] == -(-stats["steps"]
                                                            // k)
        assert stats["steps"] == stats["sweeps"] + stats["tail_rounds"]
        assert stats["graph_nodes"] == 0  # the CPU runs its blocks eagerly
    if case == "tail_spill":
        assert stats["spilled"]


@pytest.mark.parametrize("steps", [1, None])
@pytest.mark.parametrize("case", sorted(KERNEL_D))
def test_program_equals_jax_warm_rib(case, steps):
    prob, kw = KERNEL_D[case]
    t, over, roots, nbr_metric, nbr_ids, nbr_over = _problem(**prob)
    has_over = kw.get("has_overloads", False)
    cold = np.asarray(jsplit.batched_sssp_split(*_jax_args(t, over, roots),
                                                has_overloads=has_over))
    vp, b = cold.shape
    rng = np.random.default_rng(prob["seed"] + 11)
    t = dict(t)
    t["base_wgt"] = t["base_wgt"].copy()
    live = np.argwhere(t["base_wgt"] < INF)
    pick = live[rng.choice(len(live), 12, replace=False)]
    for r, c in pick:
        t["base_wgt"][r, c] = max(1, t["base_wgt"][r, c] // 3)
    seed = np.zeros(vp, bool)
    seed[pick[:, 0]] = True
    cone = rng.random((vp, b)) < 0.05
    cone[roots, np.arange(b)] = False
    cone[vp - 1] = False
    dist0 = np.where(cone, INF, cold).astype(np.int32)
    seed |= cone.any(axis=1)
    jd, jbuf = jsplit.batched_sssp_split_warm_rib(
        *_jax_args(t, over, roots), jnp.asarray(nbr_metric),
        jnp.asarray(nbr_ids), jnp.asarray(nbr_over), jnp.asarray(dist0),
        jnp.asarray(seed), **kw,
    )
    tables = split_tables_from_numpy(t, over, "cpu")
    progs = psplit.ProgramCache(steps=steps)
    d0 = torch.from_numpy(dist0.copy())
    for _ in range(2):
        stats = {}
        pd, pbuf = psplit.batched_sssp_split_warm_rib(
            tables, torch.from_numpy(roots), torch.from_numpy(nbr_metric),
            torch.from_numpy(nbr_ids), torch.from_numpy(nbr_over), d0,
            torch.from_numpy(seed), stats=stats, programs=progs, **kw,
        )
        np.testing.assert_array_equal(pd.numpy(), np.asarray(jd))
        np.testing.assert_array_equal(pbuf.numpy(), np.asarray(jbuf))
        assert torch.equal(d0, torch.from_numpy(dist0))  # read, not written
        k = steps or psplit.STEPS_WARM
        assert stats["replays"] == max(1, -(-stats["steps"] // k))
    if case == "entry_spill":
        assert stats["spilled"] and stats["tail_rounds"] == 0
    if case == "round_cap":
        assert stats["tail_rounds"] == 1 and stats["sweeps"] > 0


def test_kept_program_serves_other_roots_and_hands_out_copies():
    t, over, roots, *_ = _problem(n=1500, deg=8, mw=16, seed=0)
    tables = split_tables_from_numpy(t, over, "cpu")
    progs = psplit.ProgramCache(cap=2)
    r0 = torch.from_numpy(roots)
    r1 = torch.from_numpy(np.roll(roots, 3) + 1)
    d0 = psplit.batched_sssp_split(tables, r0, programs=progs)
    keep = d0.clone()
    d1 = psplit.batched_sssp_split(tables, r1, programs=progs)
    assert len(progs) == 1
    assert torch.equal(d0, keep)  # the first result is its own tensor
    for r, d in ((r0, d0), (r1, d1)):
        ref = jsplit.batched_sssp_split(*_jax_args(t, over, r.numpy()))
        np.testing.assert_array_equal(d.numpy(), np.asarray(ref))
    psplit.batched_sssp_split(tables, r0, programs=progs, tail_cap=256)
    psplit.batched_sssp_split(tables, r0[:8], programs=progs)
    assert len(progs) == 2  # least recently used first out
    progs.keep_tables([])
    assert len(progs) == 0


def test_solver_host_syncs_are_its_replays_and_results_do_not_alias():
    ls, ps = _states(ptopo, LinkState, PrefixState, "wan_like", (48, 7))
    solver = TorchSpfSolver(device="cpu")
    led = compile_ledger.ledger()
    rdb, art = solver.compute_routes(ls, ps, "node-0", return_artifact=True)
    first = art.solved[1].device_tensor
    keep = first.clone()
    for me in ("node-1", "node-0"):
        h0 = led.host_syncs
        solver.solve(ls, me)
        st = solver.last_solve_stats
        assert st["host_syncs"] == st["replays"] >= 1
        assert led.host_syncs - h0 == st["host_syncs"]
        assert st["relax_launches"] == 0 and st["graph_nodes"] == 0
    assert torch.equal(first, keep)  # later solves wrote their own buffers
    assert len(solver._programs) == 1  # one program, every root
    db = ls.adjacency_db("node-9")
    adjs = list(db.adjacencies)
    a = adjs[0]
    adjs[0] = dataclasses.replace(a, metric=a.metric + 5)
    ls.update_adjacency_db(dataclasses.replace(db, adjacencies=tuple(adjs)))
    got = solver.warm_compute_routes(art, ls, ps, "node-0",
                                     {("node-9", a.other_node_name)}, set(),
                                     rdb, 0.5)
    assert got is not None
    assert torch.equal(first, keep)  # the warm solve read a copy
    ws = solver.last_warm_stats
    assert ws["host_syncs"] == ws["replays"] >= 1
    assert len(solver._programs) == 2  # the cold and the warm program
    cold = TorchSpfSolver(device="cpu").compute_routes(ls, ps, "node-0")
    assert got[0].unicast_routes == cold.unicast_routes
    solver.trim_caches()
    assert len(solver._programs) == 0


def test_graph_nodes_are_a_blocks_launches(monkeypatch):
    """A step launches `gs + STEP_LAUNCHES` kernels (7 besides the
    chunks: the frontier compaction decides the tail, so one ctl launch),
    and a replayed block's `graph_nodes` is the count of kernels the
    wrappers recorded into its capture: 352 at the 100k benchmark's gs 4
    and 32 steps. On the CPU the wrappers' calls stand for the recorded
    kernels, and the replay is faked by graphs that run the init and the
    block."""
    t, over, roots, *_ = _problem(n=8000, deg=6, mw=16, seed=5)
    tables = split_tables_from_numpy(t, over, "cpu")
    prog = psplit.SplitProgram(
        tables, roots.shape[0], has_overloads=False, gs_chunks=None,
        tail_threshold=1024, tail_cap=8192, tail_rounds_cap=64, warm=False,
        steps=32)
    assert prog.gs == 4 and prog.STEP_LAUNCHES == 7
    calls = []
    for mod, name in ((sl, "snap"), (sl, "frontier_mark"),
                      (sl, "flag_compact"), (sl, "split_ctl"),
                      (relax, "relax_rows")):
        def counted(*a, _fn=getattr(mod, name), _name=name, _mod=mod,
                    **kw):
            calls.append(_name)
            _mod.CAPTURED += 1  # as a capture records the kernel on CUDA
            return _fn(*a, **kw)

        monkeypatch.setattr(mod, name, counted)
    monkeypatch.setattr(sl, "CAPTURED", 0)
    monkeypatch.setattr(relax, "CAPTURED", 0)
    prog.roots.copy_(torch.from_numpy(roots))
    prog._init()
    assert prog._recorded(prog._step) == prog.gs + prog.STEP_LAUNCHES
    assert len(calls) == prog.gs + prog.STEP_LAUNCHES
    assert calls.count("split_ctl") == 1 and calls.count("flag_compact") == 2

    class Graph:
        def __init__(self, body):
            self.replay = body

    # what `_capture` keeps: the two graphs and the block's recorded count
    prog._graphs = (Graph(prog._init), Graph(prog._block))
    prog._nodes = prog._recorded(prog._block)
    st = prog.run(torch.from_numpy(roots))
    assert st["graph_nodes"] == prog.steps * (prog.gs + 7) == 352
    ref = jsplit.batched_sssp_split(*_jax_args(t, over, roots))
    np.testing.assert_array_equal(prog.dist.numpy(), np.asarray(ref))


@pytest.mark.parametrize("name", ["split_loop", "rib_epilogue"])
def test_extern_c_signatures_match_argtypes(name):
    """Every C entry point of csrc/<name>.cu has as many parameters as
    the ctypes argtypes its wrapper module binds, and the module binds
    no other."""
    mod = {"split_loop": sl, "rib_epilogue": rib_epilogue}[name]
    src = (CSRC / f"{name}.cu").read_text()
    sigs = {
        m.group(1): m.group(2)
        for m in re.finditer(r'extern "C"[^(]*?\b(\w+)\s*\(([^)]*)\)', src)
    }
    assert set(sigs) == set(mod.ENTRY_POINTS)
    for fn, params in sigs.items():
        n_params = len([p for p in params.split(",") if p.strip()])
        assert n_params == len(mod.ENTRY_POINTS[fn][0]), fn
    if name == "split_loop":  # the compaction's decide and workspace
        names = [p.split()[-1].lstrip("*")
                 for p in sigs["openr_flag_compact"].split(",")]
        assert names[-4:] == ["clear", "decide", "ws", "stream"]
        assert [p.split()[-1] for p in sigs["openr_split_ctl"].split(",")
                ] == ["ctl", "phase_mask", "stream"]


def test_ctl_words_match_the_kernel_source():
    """The control block's word and phase numbers of `ops/split_loop.py`
    are the ones `csrc/split_loop.cu` names."""
    src = (CSRC / "split_loop.cu").read_text()
    words = dict(re.findall(r"\bk(\w+) = (\d+),", src))
    for py, c in (("PHASE", "Phase"), ("IT", "It"), ("SWEEPS", "Sweeps"),
                  ("TAIL_ROUNDS", "TailRounds"), ("STEPS", "Steps"),
                  ("ROWS_CHANGED", "RowsChanged"), ("N_ROWS", "NRows"),
                  ("N_FRONT", "NFront"), ("RAW_FRONT", "RawFront"),
                  ("SPILL", "Spill"), ("THRESHOLD", "Threshold"),
                  ("ROUNDS_CAP", "RoundsCap"), ("IT_CAP", "ItCap"),
                  ("RAW_ROWS", "RawRows")):
        assert int(words[c]) == getattr(sl, py), py
    phases = dict(re.findall(r"\bk(Done|Dense|Tail|Net) = (\d+)", src))
    assert {k: int(v) for k, v in phases.items()} == {
        "Done": sl.DONE, "Dense": sl.DENSE, "Tail": sl.TAIL, "Net": sl.NET}
    # the compaction's tile, by which the workspace is sized
    assert f"constexpr int kTile = {sl.COMPACT_TILE};" in src

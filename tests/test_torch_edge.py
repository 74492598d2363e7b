"""The port's edge-list Bellman-Ford (`ops/edge_relax.py`, the CPU path
of `csrc/edge_relax.cu`), `build_blocked` and `all_sources_sssp` equal
the JAX package's `batched_sssp`, `build_blocked` and `all_sources_sssp`
on the same numpy-seeded inputs, exactly (int32)."""

import importlib
import pathlib
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from openr_tpu.ops import spf as jspf
from openr_tpu_torch.ops import edge_relax
from openr_tpu_torch.ops import spf as pspf

# one intra-op thread: the suite runs several test workers at once
torch.set_num_threads(1)

INF = int(jspf.INF_DIST)
PKG = pathlib.Path(__file__).resolve().parents[1] / "openr_tpu_torch"


def random_edges(seed, n, avg_deg, vp, *, hub_in=0, isolated=3,
                 over_frac=0.1, max_metric=64):
    """Padded, dst-sorted edge arrays of a random directed graph on `n`
    nodes in `vp` > n slots: parallel edges, `isolated` unreachable
    nodes, overloaded nodes, a hub (node 0) with `hub_in` extra in-edges,
    and padding edges into the dead slot vp - 1. Returns (src, dst,
    metric, over)."""
    rng = np.random.default_rng(seed)
    live = n - isolated
    e = n * avg_deg
    src = rng.integers(0, live, e)
    dst = rng.integers(0, live, e)
    keep = src != dst
    src, dst = src[keep], dst[keep]
    dup = rng.random(len(src)) < 0.05  # parallel edges, other metrics
    src = np.concatenate([src, src[dup]])
    dst = np.concatenate([dst, dst[dup]])
    if hub_in:
        hs = rng.integers(1, live, hub_in)
        src = np.concatenate([src, hs])
        dst = np.concatenate([dst, np.zeros(hub_in, np.int64)])
    met = rng.integers(1, max_metric + 1, len(src))
    order = np.argsort(dst, kind="stable")
    src, dst, met = src[order], dst[order], met[order]
    ep = 128
    while ep < len(src) + 5:
        ep <<= 1
    es = np.zeros(ep, np.int32)
    ed = np.full(ep, vp - 1, np.int32)
    em = np.full(ep, INF, np.int32)
    es[: len(src)], ed[: len(src)], em[: len(src)] = src, dst, met
    over = np.zeros(vp, bool)
    over[rng.choice(live, max(1, int(over_frac * live)), replace=False)] = True
    return es, ed, em, over


def roots_for(seed, b, n, over):
    """`b` roots with repeats and at least one overloaded root."""
    rng = np.random.default_rng(seed + 1000)
    roots = rng.integers(0, n, b).astype(np.int32)
    if b >= 2:
        roots[1] = roots[0]  # a repeated root
    if b >= 3:
        roots[2] = np.flatnonzero(over)[0]  # an overloaded root
    return roots


def jax_dist(es, ed, em, over, roots, vp):
    blocked = jspf.build_blocked(em, es, over)
    return np.asarray(jspf.batched_sssp(
        jnp.asarray(es), jnp.asarray(ed), jnp.asarray(em),
        jnp.asarray(blocked), jnp.asarray(roots), vp,
    ))


def np_init(es, ed, em, roots, vp):
    """The reference's init in NumPy: each root's own out-edges (blocked
    too), at most INF, then 0 at the root."""
    b = len(roots)
    dist = np.full((vp, b), INF, np.int64)
    for j, r in enumerate(roots):
        m = es == r
        np.minimum.at(dist, (ed[m], j), em[m])
    dist = np.minimum(dist, INF)
    dist[roots, np.arange(b)] = 0
    return dist


def np_round(dist, es, ed, em, sel):
    """One Jacobi round over the slots `sel` (bool), from `dist`."""
    d = dist[es[sel]]
    cand = np.where(d < INF, np.minimum(d + em[sel][:, None], INF), INF)
    new = dist.copy()
    np.minimum.at(new, ed[sel], cand)
    return new


def np_reference(es, ed, em, over, roots, vp, cap=None):
    """The reference's while loop in NumPy, full rounds over every
    unblocked slot: (dist, rounds)."""
    usable = ~jspf.build_blocked(em, es, over)
    dist = np_init(es, ed, em, roots, vp)
    rounds = 0
    while rounds < (vp if cap is None else cap):
        new = np_round(dist, es, ed, em, usable)
        rounds += 1
        changed = bool((new < dist).any())
        dist = new
        if not changed:
            break
    return dist, rounds


def np_gathered(es, ed, em, over, roots, vp, tile):
    """The kernels' gathered-edge count in NumPy: per tile of `tile`
    columns, per round, the unblocked walked slots whose source row
    changed in the round before (the first round: was set finite by the
    init)."""
    walked = int(edge_relax.edge_row_start(ed, vp, em)[-1])
    es, ed, em = es[:walked], ed[:walked], em[:walked]
    usable = ~jspf.build_blocked(em, es, over)
    total = 0
    for c0 in range(0, len(roots), tile):
        dist = np_init(es, ed, em, roots[c0 : c0 + tile], vp)
        chg = (dist < INF).any(1)
        for _ in range(vp):
            sel = usable & chg[es]
            total += int(sel.sum())
            new = np_round(dist, es, ed, em, sel)
            chg = (new < dist).any(1)
            dist = new
            if not chg.any():
                break
    return total


def tensors(es, ed, em, over, roots):
    blocked = pspf.build_blocked(em, es, over)
    return [torch.from_numpy(x) for x in (es, ed, em, blocked, roots)]


CASES = [
    # (seed, n, avg_deg, hub_in)
    (0, 60, 3, 0),
    (1, 200, 4, 0),
    (2, 150, 2, 300),  # a hub run of ~300 in-edges: two segments
    (3, 9, 1, 0),  # sparse: many unreachable entries
]


@pytest.mark.parametrize("b", [1, 8, 33, 64, 300])
@pytest.mark.parametrize("seed,n,deg,hub", CASES)
def test_batched_sssp_equals_jax(seed, n, deg, hub, b):
    vp = pspf.pad_batch(n + 1)  # node slots and the dead slot
    es, ed, em, over = random_edges(seed, n, deg, vp, hub_in=hub)
    roots = roots_for(seed, b, n, over)
    want = jax_dist(es, ed, em, over, roots, vp)
    np_dist, np_rounds = np_reference(es, ed, em, over, roots, vp)
    np.testing.assert_array_equal(np_dist, want)
    stats = {}
    got = edge_relax.batched_sssp(*tensors(es, ed, em, over, roots), vp,
                                  stats=stats)
    assert got.dtype == torch.int32 and tuple(got.shape) == (vp, b)
    np.testing.assert_array_equal(got.numpy(), want)
    tile = edge_relax.tile_cols(b)
    assert stats["tile_cols"] == tile and stats["tiles"] == -(-b // tile)
    assert stats["rounds"] == np_rounds >= 1
    assert stats["gathered_edges"] == np_gathered(es, ed, em, over, roots,
                                                  vp, tile)
    assert (want == INF).any()  # unreachable entries are in the check


@pytest.mark.parametrize("tile", [4, 8, 32])
@pytest.mark.parametrize("b", [8, 33, 300])
@pytest.mark.parametrize("seed,n,deg,hub", [CASES[1], CASES[2]])
def test_tiled_skipping_fixpoint_equals_jax(seed, n, deg, hub, b, tile):
    """The plain version of the kernels' algorithm at explicit tile
    widths (ragged last tiles): byte-equal to the JAX package, with the
    reference loop's round count and the NumPy gathered-edge count."""
    vp = pspf.pad_batch(n + 1)
    es, ed, em, over = random_edges(seed, n, deg, vp, hub_in=hub)
    roots = roots_for(seed, b, n, over)
    want = jax_dist(es, ed, em, over, roots, vp)
    _d, np_rounds = np_reference(es, ed, em, over, roots, vp)
    walked = int(edge_relax.edge_row_start(ed, vp, em)[-1])
    st = {}
    got = edge_relax.batched_sssp_ref(*tensors(es, ed, em, over, roots), vp,
                                      tile, walked, stats=st)
    np.testing.assert_array_equal(got.numpy(), want)
    assert st["rounds"] == np_rounds
    assert st["gathered_edges"] == np_gathered(es, ed, em, over, roots, vp,
                                               tile)


@pytest.mark.parametrize("cap", [1, 2, 3])
def test_capped_fixpoint_equals_the_capped_loop(cap):
    """Capped at `cap` rounds, each tile holds the reference loop's
    state after `cap` rounds (a column depends only on itself)."""
    vp = 256
    es, ed, em, over = random_edges(1, 200, 4, vp)
    roots = roots_for(1, 40, 200, over)
    want, rounds = np_reference(es, ed, em, over, roots, vp, cap=cap)
    st = {}
    got = edge_relax.batched_sssp_ref(*tensors(es, ed, em, over, roots), vp,
                                      8, max_rounds=cap, stats=st)
    np.testing.assert_array_equal(got.numpy(), want)
    assert st["rounds"] == rounds == cap


@pytest.mark.parametrize("tile", [4, 16])
def test_gathered_edges_shrink_as_rows_settle(tile):
    """The skip: after the first rounds only the rows that fell are
    gathered from, so a solve gathers fewer slots than rounds x the
    usable slots of every tile, and the count matches NumPy's."""
    vp = 256
    es, ed, em, over = random_edges(4, 200, 5, vp)
    roots = roots_for(4, 32, 200, over)
    st = {}
    edge_relax.batched_sssp_ref(*tensors(es, ed, em, over, roots), vp, tile,
                                stats=st)
    usable = int((~pspf.build_blocked(em, es, over)).sum())
    assert st["gathered_edges"] == np_gathered(es, ed, em, over, roots, vp,
                                               tile)
    assert 0 < st["gathered_edges"] < st["host_reads"] * usable


def test_overloaded_root_keeps_its_out_edges_but_no_transit():
    # 0 -> 1 -> 2 with node 1 overloaded: from 1, node 2 is reachable
    # (its own out-edge, at init); from 0, node 2 is not (no transit)
    es = np.array([0, 1, 0], np.int32)
    ed = np.array([1, 2, 7], np.int32)
    em = np.array([5, 7, INF], np.int32)
    over = np.zeros(8, bool)
    over[1] = True
    roots = np.array([1, 0, 1], np.int32)
    want = jax_dist(es, ed, em, over, roots, 8)
    got = edge_relax.batched_sssp(
        torch.from_numpy(es), torch.from_numpy(ed), torch.from_numpy(em),
        torch.from_numpy(pspf.build_blocked(em, es, over)),
        torch.from_numpy(roots), 8,
    ).numpy()
    np.testing.assert_array_equal(got, want)
    assert got[2, 0] == 7 and got[2, 1] == INF and got[1, 1] == 5


@pytest.mark.parametrize("seed", [0, 5])
def test_build_blocked_equals_jax(seed):
    es, ed, em, over = random_edges(seed, 80, 3, 128)
    np.testing.assert_array_equal(
        pspf.build_blocked(em, es, over), jspf.build_blocked(em, es, over)
    )


@pytest.mark.parametrize("chunk", [16, 24, 256])
def test_all_sources_sssp_equals_jax(chunk):
    # 40 nodes in 64 slots: chunks of 16 and 24 leave a padded tail
    vp = 64
    es, ed, em, over = random_edges(7, 40, 3, vp)
    blocked = pspf.build_blocked(em, es, over)
    want = jspf.all_sources_sssp(
        jnp.asarray(es), jnp.asarray(ed), jnp.asarray(em),
        jnp.asarray(blocked), vp, chunk=chunk,
    )
    stats = {}
    got = pspf.all_sources_sssp(
        torch.from_numpy(es), torch.from_numpy(ed), torch.from_numpy(em),
        torch.from_numpy(blocked), vp, chunk=chunk, stats=stats,
    )
    assert got.shape == want.shape == (vp, vp)
    np.testing.assert_array_equal(got, want)
    assert stats["host_reads"] >= -(-vp // chunk)


def test_all_sources_sssp_takes_a_prebuilt_index(monkeypatch):
    """A given `EdgeIndex` serves every chunk, with no index built, and
    the result is the JAX package's."""
    vp = 64
    es, ed, em, over = random_edges(8, 40, 3, vp)
    blocked = pspf.build_blocked(em, es, over)
    t = [torch.from_numpy(x) for x in (es, ed, em, blocked)]
    index = edge_relax.device_edge_index(t[0], t[1], t[2], vp)

    def no_build(*a, **k):
        raise AssertionError("the index was built again")

    monkeypatch.setattr(edge_relax, "device_edge_index", no_build)
    monkeypatch.setattr(edge_relax, "edge_index", no_build)
    got = pspf.all_sources_sssp(*t, vp, chunk=24, index=index)
    want = jspf.all_sources_sssp(
        jnp.asarray(es), jnp.asarray(ed), jnp.asarray(em),
        jnp.asarray(blocked), vp, chunk=24,
    )
    np.testing.assert_array_equal(got, want)


def test_row_start_and_its_checks():
    ed = np.array([0, 0, 2, 2, 2, 5, 7], np.int32)
    np.testing.assert_array_equal(
        edge_relax.edge_row_start(ed, 8, np.ones(7, np.int32)),
        [0, 2, 2, 5, 5, 5, 6, 6, 7],
    )
    for bad in (np.array([1, 0], np.int32), np.array([0, 8], np.int32)):
        with pytest.raises(ValueError):
            edge_relax.edge_row_start(bad, 8, np.ones(2, np.int32))
    # the trailing INF padding leaves every run; an inner INF slot stays
    em = np.array([3, INF, 1, 1, 2, 4, INF], np.int32)
    np.testing.assert_array_equal(
        edge_relax.edge_row_start(ed, 8, em), [0, 2, 2, 5, 5, 5, 6, 6, 6]
    )
    np.testing.assert_array_equal(
        edge_relax.edge_row_start(ed, 8, np.full(7, INF, np.int32)),
        np.zeros(9),
    )


def test_runs_without_the_padding_give_the_same_fixpoint():
    vp = 128
    es, ed, em, over = random_edges(2, 90, 3, vp)
    blocked = pspf.build_blocked(em, es, over)
    roots = torch.from_numpy(roots_for(2, 8, 90, over))
    t = [torch.from_numpy(x) for x in (es, ed, em, blocked)]
    every_slot = np.searchsorted(ed, np.arange(vp + 1)).astype(np.int32)
    full = edge_relax.batched_sssp(
        *t, roots, vp, row_start=torch.from_numpy(every_slot))
    cut = edge_relax.batched_sssp(*t, roots, vp)
    assert (em[-5:] == INF).all()  # the case has trailing padding
    np.testing.assert_array_equal(cut.numpy(), full.numpy())


def test_round_needs_two_buffers_and_int32():
    vp = 32
    es, ed, em, over = random_edges(1, 20, 2, vp)
    t = [torch.from_numpy(x) for x in (es, ed, em)]
    blocked = torch.from_numpy(pspf.build_blocked(em, es, over))
    rs = torch.from_numpy(edge_relax.edge_row_start(ed, vp, em))
    d = torch.zeros((vp, 4), dtype=torch.int32)
    ch = torch.zeros(1, dtype=torch.int32)
    with pytest.raises(ValueError, match="two buffers"):
        edge_relax.edge_round(d, d, *t, blocked, rs, ch)
    with pytest.raises(TypeError):
        edge_relax.edge_round(d.long(), d.clone().long(), *t, blocked, rs, ch)
    assert edge_relax.LAUNCHES == {"init": 0, "round": 0}  # CPU: no kernel


def test_cols_per_thread_matches_the_kernel_rule():
    """A kernel lane carries 4 columns (one 16-byte load), q = the tile's
    width / 4 lanes a row; the wrapper's check holds exactly the widths
    and alignment the 16-byte loads need (batched_sssp pads B to a
    multiple of 4)."""
    src = (PKG / "csrc" / "edge_relax.cu").read_text()
    assert "const int q = min(a.Bt, a.Bp - c0) / 4;  // lanes an item" in src
    assert "reinterpret_cast<const int4*>" in src
    off = torch.zeros(17 * 4, dtype=torch.int32)[1:65].view(-1, 4)
    for b in (1, 4, 8, 33, 256, 300):
        d = torch.zeros((4, b), dtype=torch.int32)
        if b % 4:
            with pytest.raises(ValueError, match="multiple of 4"):
                edge_relax._check_cuda_width("t", d, (("dist", d),))
        else:
            edge_relax._check_cuda_width("t", d, (("dist", d),))
    with pytest.raises(ValueError, match="16-byte aligned"):
        edge_relax._check_cuda_width("t", off, (("dist", off),))


@pytest.mark.parametrize("b,want", [
    (1, 4), (4, 4), (5, 8), (8, 8), (33, 36), (64, 64), (100, 100),
    (128, 128), (256, 128), (300, 128),
])
def test_tile_cols_rule(b, want):
    """The widest tile the kernel takes (a warp a row at 128 columns),
    never wider than B rounded up to a multiple of 4; the tiles cover B
    with only the last one ragged."""
    bt = edge_relax.tile_cols(b)
    assert bt == want
    assert bt % 4 == 0 and 4 <= bt <= edge_relax.MAX_TILE
    bp = -(-b // 4) * 4
    widths = [min(bt, bp - c0) for c0 in range(0, bp, bt)]
    assert sum(widths) == bp and all(w % 4 == 0 for w in widths)
    assert all(w == bt for w in widths[:-1])


@pytest.mark.parametrize("seed", [0, 2])
def test_edge_out_index_against_argsort(seed):
    vp = 256
    es, ed, em, _over = random_edges(seed, 150, 3, vp, hub_in=40)
    rs = edge_relax.edge_row_start(ed, vp, em)
    start, slot = edge_relax.edge_out_index(es, rs)
    walked = int(rs[-1])
    want = np.argsort(es[:walked], kind="stable")
    np.testing.assert_array_equal(slot, want)
    assert start.dtype == slot.dtype == np.int32 and start.shape == (vp + 1,)
    for u in range(vp):  # each src's slots, in slot order
        got = slot[start[u] : start[u + 1]]
        np.testing.assert_array_equal(got, np.flatnonzero(es[:walked] == u))
    bad = es.copy()
    bad[0] = vp
    with pytest.raises(ValueError):
        edge_relax.edge_out_index(bad, rs)


def test_edge_segments_plan():
    rs = np.array([0, 3, 3, 13, 14, 24, 25], np.int32)  # runs 3,0,10,1,10,1
    node, lo = edge_relax.edge_segments(rs, seg_edges=4)
    np.testing.assert_array_equal(node, [2, 2, 2, 4, 4, 4])
    np.testing.assert_array_equal(lo, [3, 7, 11, 14, 18, 22])
    # every slot of a long run in exactly one segment, none of a short one
    covered = np.concatenate([np.arange(x, min(x + 4, rs[n + 1]))
                              for n, x in zip(node, lo)])
    np.testing.assert_array_equal(covered, np.r_[3:13, 14:24])
    node, lo = edge_relax.edge_segments(rs, seg_edges=10)
    assert len(node) == len(lo) == 0  # no run is longer than 10
    vp = 512
    es, ed, em, _over = random_edges(2, 150, 2, vp, hub_in=300)
    idx = edge_relax.edge_index(es, ed, em, vp)
    assert list(idx.seg_node) == [0, 0]  # the hub: 256 + the rest
    assert idx.seg_lo[1] - idx.seg_lo[0] == edge_relax.SEG_EDGES


def test_init_pads_columns_and_round_equals_numpy():
    """The CPU init into a padded [V, B'] buffer (INF past B) and one
    full round equal the NumPy reference's init and first round."""
    vp = 128
    es, ed, em, over = random_edges(5, 90, 3, vp)
    roots = roots_for(5, 6, 90, over)
    t = tensors(es, ed, em, over, roots)
    idx = edge_relax.device_edge_index(t[0], t[1], t[2], vp)
    out = torch.full((vp, 8), -1, dtype=torch.int32)
    edge_relax.edge_init(out, t[0], t[1], t[2], t[4], idx)
    want = np_init(es, ed, em, roots, vp)
    np.testing.assert_array_equal(out[:, :6].numpy(), want)
    assert (out[:, 6:] == INF).all()
    nxt = torch.empty_like(out)
    ch = torch.zeros(1, dtype=torch.int32)
    edge_relax.edge_round(out, nxt, *t[:4], idx.row_start, ch, index=idx)
    usable = ~jspf.build_blocked(em, es, over)
    np.testing.assert_array_equal(
        nxt[:, :6].numpy(), np_round(want, es, ed, em, usable))
    assert int(ch) == 1


def test_extern_c_signatures_match_argtypes():
    """Every C entry point of csrc/edge_relax.cu has as many parameters
    as the ctypes argtypes its wrapper binds, and no other is bound."""
    mod = importlib.import_module("openr_tpu_torch.ops.edge_relax")
    src = (PKG / "csrc" / "edge_relax.cu").read_text()
    sigs = {
        m.group(1): m.group(2)
        for m in re.finditer(r'extern "C"[^(]*?\b(\w+)\s*\(([^)]*)\)', src)
    }
    assert set(sigs) == set(mod.ENTRY_POINTS)
    for fn, params in sigs.items():
        n_params = len([p for p in params.split(",") if p.strip()])
        assert n_params == len(mod.ENTRY_POINTS[fn][0]), fn

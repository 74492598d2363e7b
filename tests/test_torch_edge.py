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


CASES = [
    # (seed, n, avg_deg, hub_in)
    (0, 60, 3, 0),
    (1, 200, 4, 0),
    (2, 150, 2, 300),  # a hub run of ~300 in-edges
    (3, 9, 1, 0),  # sparse: many unreachable entries
]


@pytest.mark.parametrize("b", [1, 8, 33])
@pytest.mark.parametrize("seed,n,deg,hub", CASES)
def test_batched_sssp_equals_jax(seed, n, deg, hub, b):
    vp = pspf.pad_batch(n + 1)  # node slots and the dead slot
    es, ed, em, over = random_edges(seed, n, deg, vp, hub_in=hub)
    roots = roots_for(seed, b, n, over)
    want = jax_dist(es, ed, em, over, roots, vp)
    blocked = pspf.build_blocked(em, es, over)
    stats = {}
    got = edge_relax.batched_sssp(
        torch.from_numpy(es), torch.from_numpy(ed), torch.from_numpy(em),
        torch.from_numpy(blocked), torch.from_numpy(roots), vp, stats=stats,
    )
    assert got.dtype == torch.int32 and tuple(got.shape) == (vp, b)
    np.testing.assert_array_equal(got.numpy(), want)
    assert stats["rounds"] == stats["host_reads"] >= 1
    assert (want == INF).any()  # unreachable entries are in the check


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
    """The kernel carries 4 columns a thread (16-byte loads) exactly
    where B is a multiple of 4, and the wrapper's alignment check holds
    exactly those widths."""
    src = (PKG / "csrc" / "edge_relax.cu").read_text()
    assert "return B % 4 == 0 ? 4 : 1;" in src
    off = torch.zeros(17, dtype=torch.int32)[1:]  # 4 bytes past 16
    for b in (1, 4, 8, 33, 256, 300):
        if b % 4:
            edge_relax._check_aligned("t", b, (("dist", off),))
        else:
            with pytest.raises(ValueError, match="16-byte aligned"):
                edge_relax._check_aligned("t", b, (("dist", off),))


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

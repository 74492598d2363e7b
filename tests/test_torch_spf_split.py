"""The port's split solve is byte-equal to the JAX package's:
`batched_sssp_split` distances and the `batched_sssp_split_rib` packed
buffer, across overloads, LFA, a forced tail spill, Gauss-Seidel
chunking and the uniform-metric regime; and the row flags of one dense
step or tail step of a `SplitProgram` are the JAX package's changed
rows."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from openr_tpu.ops import spf_split as jsplit
from openr_tpu_torch.convert import split_tables_from_numpy
from openr_tpu_torch.ops import spf_split as psplit
from openr_tpu_torch.ops import split_loop as sl
from openr_tpu_torch.utils import topogen as ptopo

INF = 1 << 30
METRIC_MAX = (1 << 30) - 1

# one intra-op thread: the suite runs several test workers at once
torch.set_num_threads(1)


def _problem(n, deg, mw, seed, frac_over=0.0, root=0):
    es, ed, em, _vp, nn, e = ptopo.erdos_renyi_csr(
        n, avg_degree=deg, seed=seed, max_metric=mw
    )
    t = jsplit.build_split_tables(es, ed, em, nn)
    vp = t["vp"]
    rng = np.random.default_rng(seed + 100)
    over = np.zeros(vp, dtype=bool)
    if frac_over:
        over[:nn] = rng.random(nn) < frac_over
        over[root] = True  # overloaded root keeps its own out-edges
    out = es[:e] == root
    nbrs = np.unique(ed[:e][out])
    met = np.array([em[:e][out & (ed[:e] == j)].min() for j in nbrs],
                   dtype=np.int32)
    b = 8
    while b < 1 + len(nbrs):
        b <<= 1
    roots = np.full(b, root, np.int32)
    roots[1 : 1 + len(nbrs)] = nbrs
    nbr_ids = np.full(b - 1, vp - 1, np.int32)
    nbr_ids[: len(nbrs)] = nbrs
    nbr_metric = np.full(b - 1, METRIC_MAX, np.int32)
    nbr_metric[: len(nbrs)] = met
    nbr_over = np.ones(b - 1, bool)
    nbr_over[: len(nbrs)] = over[nbrs]
    return t, over, roots, nbr_metric, nbr_ids, nbr_over


def _jax_args(t, over, roots):
    return [jnp.asarray(t[k]) for k in (
        "base_nbr", "base_wgt", "ov_ids", "ov_nbr", "ov_wgt", "out_nbr"
    )] + [jnp.asarray(over), jnp.asarray(roots)]


CASES = {
    # name: (problem kwargs, solve kwargs, with_lfa)
    "plain": (dict(n=1500, deg=8, mw=16, seed=0), {}, False),
    "plain_lfa": (dict(n=1500, deg=8, mw=16, seed=0), {}, True),
    "overloads_lfa": (dict(n=1500, deg=8, mw=16, seed=1, frac_over=0.1),
                      dict(has_overloads=True), True),
    "overloads": (dict(n=1500, deg=8, mw=16, seed=1, frac_over=0.1),
                  dict(has_overloads=True), False),
    "tail_spill": (dict(n=1200, deg=6, mw=32, seed=2),
                   dict(tail_threshold=1200, tail_cap=32, tail_rounds_cap=4),
                   False),
    "tail_long": (dict(n=1200, deg=6, mw=32, seed=2),
                  dict(tail_threshold=1200, tail_cap=2048,
                       tail_rounds_cap=512), True),
    "uniform": (dict(n=2000, deg=6, mw=1, seed=4), {}, False),
    "gs1": (dict(n=8000, deg=6, mw=16, seed=5), dict(gs_chunks=1), False),
    "gs4": (dict(n=8000, deg=6, mw=16, seed=5), dict(gs_chunks=4), True),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_split_distances_and_rib_buffer_equal(case):
    pkw, skw, with_lfa = CASES[case]
    t, over, roots, nbr_metric, nbr_ids, nbr_over = _problem(**pkw)
    my_id = int(roots[0])
    ref_dist, ref_buf = jsplit.batched_sssp_split_rib(
        *_jax_args(t, over, roots),
        jnp.asarray(nbr_metric), jnp.asarray(nbr_ids),
        jnp.asarray(nbr_over), jnp.int32(my_id),
        with_lfa=with_lfa, **skw,
    )
    stats = {}
    dist, buf = psplit.batched_sssp_split_rib(
        split_tables_from_numpy(t, over, "cpu"), torch.from_numpy(roots),
        torch.from_numpy(nbr_metric), torch.from_numpy(nbr_ids),
        torch.from_numpy(nbr_over), my_id, with_lfa=with_lfa, stats=stats,
        **skw,
    )
    np.testing.assert_array_equal(dist.numpy(), np.asarray(ref_dist))
    assert buf.dtype == torch.uint8
    np.testing.assert_array_equal(buf.numpy(), np.asarray(ref_buf))
    _d_root, fh, lfa = psplit.unpack_rib_buffer(
        buf.numpy(), t["vp"], roots.shape[0], with_lfa
    )
    assert fh.any() and (lfa is not None) == with_lfa
    assert stats["sweeps"] >= 1
    if case == "tail_spill":
        assert stats["spilled"]
    if case == "tail_long":
        assert stats["tail_rounds"] > 0 and not stats["spilled"]


def _mid_solve(frac_over, sweeps=2):
    """A problem and a dist part-way to its fixpoint: `sweeps` JAX dense
    sweeps from the roots, so the next round lowers some rows only."""
    t, over, roots, *_ = _problem(n=1500, deg=8, mw=16, seed=3,
                                  frac_over=frac_over)
    has_over = frac_over > 0
    j = {k: jnp.asarray(t[k]) for k in (
        "base_nbr", "base_wgt", "ov_ids", "ov_nbr", "ov_wgt"
    )}
    jo = jnp.asarray(over)
    over_base = jo[j["base_nbr"]] if has_over else None
    over_ov = jo[j["ov_nbr"]] if has_over else None
    vp, b = t["vp"], roots.shape[0]
    dist = jnp.full((vp, b), INF, jnp.int32)
    dist = dist.at[jnp.asarray(roots), jnp.arange(b)].set(0)
    sweep1 = jsplit._make_dense_sweep(
        j["base_nbr"], j["base_wgt"], j["ov_ids"], j["ov_nbr"], j["ov_wgt"],
        over_base, over_ov, jnp.asarray(roots), has_over, 1,
    )
    for _ in range(sweeps):
        dist = sweep1(dist)
    return t, over, roots, j, over_base, over_ov, dist


def _one_step(t, over, roots, has_over, dist, phase, gs=1, rows=None):
    """One step of a `SplitProgram` on the CPU (`steps=1`), from `dist`
    in `phase`: a dense step's sweep (a threshold of 0 keeps it dense),
    or a tail step whose listed rows are `rows` (marked, with an empty
    frontier, so the step's compaction lists exactly them). Stale row
    flags and count beforehand: the step's snapshot clears them. Returns
    the program after the step."""
    tables = split_tables_from_numpy(t, over, "cpu")
    prog = psplit.SplitProgram(
        tables, roots.shape[0], has_overloads=has_over, gs_chunks=gs,
        tail_threshold=0, tail_cap=512, tail_rounds_cap=64, warm=False,
        steps=1)
    prog.roots.copy_(torch.from_numpy(roots))
    prog.ctl.copy_(prog.ctl0)
    prog.ctl[sl.PHASE] = phase
    prog.ctl[sl.ROWS_CHANGED] = 5
    prog.row_flag.fill_(5)
    prog.dist.copy_(torch.from_numpy(np.array(dist)))
    if rows is not None:
        prog.mark[torch.from_numpy(rows).long()] = 1
    prog._block()
    return prog


@pytest.mark.parametrize("gs", [1, 4])
@pytest.mark.parametrize("frac_over", [0.0, 0.1])
def test_dense_sweep_flags_equal_jax_changed_rows(gs, frac_over):
    """One dense step of the program: JAX's dense sweep, and its row
    flags and changed-row count are JAX's changed rows."""
    t, over, roots, j, over_base, over_ov, dist = _mid_solve(frac_over)
    has_over = frac_over > 0
    ref = jsplit._make_dense_sweep(
        j["base_nbr"], j["base_wgt"], j["ov_ids"], j["ov_nbr"], j["ov_wgt"],
        over_base, over_ov, jnp.asarray(roots), has_over, gs,
    )(dist)
    ref_changed = np.asarray((ref < dist).any(axis=1))
    assert 0 < ref_changed.sum() < t["vp"]
    prog = _one_step(t, over, roots, has_over, dist, sl.DENSE, gs=gs)
    assert prog.gs == gs
    np.testing.assert_array_equal(prog.dist.numpy(), np.asarray(ref))
    np.testing.assert_array_equal(prog.row_flag.numpy() != 0, ref_changed)
    assert int(prog.ctl[sl.ROWS_CHANGED]) == int(ref_changed.sum())
    assert int(prog.ctl[sl.SWEEPS]) == 1
    assert int(prog.ctl[sl.PHASE]) == sl.DENSE


@pytest.mark.parametrize("frac_over", [0.0, 0.1])
def test_tail_round_flags_equal_jax_changed_rows(frac_over):
    """One tail step of the program on listed rows: JAX's tail relax of
    those rows and every overflow row, its flags JAX's changed rows."""
    t, over, roots, j, over_base, over_ov, dist = _mid_solve(frac_over)
    has_over = frac_over > 0
    vp = t["vp"]
    rng = np.random.default_rng(21)
    live = np.sort(rng.choice(vp - 1, 300, replace=False)).astype(np.int32)
    rows = np.concatenate([live, np.full(212, vp - 1, np.int32)])
    jr, jroots = jnp.asarray(rows), jnp.asarray(roots)
    sub = jsplit._relax_rows(
        dist, j["base_nbr"][jr], j["base_wgt"][jr],
        over_base[jr] if has_over else None, jroots, has_over,
    )
    ov = jsplit._relax_rows(
        dist, j["ov_nbr"], j["ov_wgt"], over_ov, jroots, has_over
    )
    ref = dist.at[jr].min(sub).at[j["ov_ids"]].min(ov)
    ref_changed = np.asarray((ref < dist).any(axis=1))
    assert ref_changed.sum() > 0
    prog = _one_step(t, over, roots, has_over, dist, sl.TAIL, rows=live)
    np.testing.assert_array_equal(prog.rows.numpy(), rows)
    np.testing.assert_array_equal(prog.dist.numpy(), np.asarray(ref))
    np.testing.assert_array_equal(prog.row_flag.numpy() != 0, ref_changed)
    assert int(prog.ctl[sl.ROWS_CHANGED]) == int(ref_changed.sum())
    assert int(prog.ctl[sl.TAIL_ROUNDS]) == 1

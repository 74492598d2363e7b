"""The RIB epilogue (`ops/rib_epilogue.py`, kernel C) against the JAX
package: the packed buffer `[d_root bytes | packbits(fh) | packbits(lfa)?]`
byte-equal to `first_hop_matrix` / `lfa_matrix` / `jnp.packbits` of
`openr_tpu/ops/spf.py` on INF rows and columns, overloaded neighbors
(also as destinations), padding neighbors on the dead slot, LFA on and
off and an asymmetric neighbor-to-root column, at B 8 to 128 with 0, 1
and B - 1 neighbors and on a vp whose packed rows are an odd number of
bytes; and its count."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from openr_tpu.ops import spf as jspf
from openr_tpu.ops import spf_split as jsplit
from openr_tpu_torch.ops import rib_epilogue
from openr_tpu_torch.ops.spf import first_hop_work

INF = 1 << 30
METRIC_MAX = (1 << 30) - 1

# one intra-op thread: the suite runs several test workers at once
torch.set_num_threads(1)


def _case(kind, seed, vp=2048, b=16, n=None, n_real=11):
    """dist [vp, b] whose root column is the min over the first n_real
    neighbors' columns plus their metrics on most rows (so first hops
    hold), with the holes and flags `kind` asks for; n neighbor arrays
    (b - 1 where None), those past n_real the dead slot's padding."""
    rng = np.random.default_rng(seed)
    n = b - 1 if n is None else n
    n_real = min(n_real, n)
    dead = vp - 1
    ids = np.full(n, dead, np.int32)
    ids[:n_real] = rng.choice(vp - 1, n_real, replace=False)
    met = np.full(n, METRIC_MAX, np.int32)
    met[:n_real] = rng.integers(1, 12, n_real)
    over = np.ones(n, bool)
    over[:n_real] = rng.random(n_real) < (0.4 if "over" in kind else 0.0)
    d = rng.integers(0, 60, (vp, b)).astype(np.int64)
    if n_real:
        cand = d[:, 1:1 + n_real] + met[None, :n_real]
        d[:, 0] = np.where(rng.random(vp) < 0.8, cand.min(axis=1),
                           rng.integers(0, 80, vp))
    my_id = int(rng.integers(0, vp - 1))
    d[my_id, 0] = 0
    d[ids[:n_real], 1 + np.arange(n_real)] = 0  # a neighbor reaches itself
    if "inf" in kind:
        d[rng.random(vp) < 0.1, 0] = INF                 # unreachable dests
        d[rng.random((vp, b)) < 0.05] = INF              # random holes
        d[:, 3] = INF                                    # a partitioned nbr
        d[rng.choice(vp, 30, replace=False)] = INF       # whole rows
    if "asym" in kind:  # the neighbors' way back differs from the way out
        d[my_id, 1:1 + n_real] = rng.integers(1, 40, n_real)
        d[my_id, 2] = INF
    if "over" in kind:  # overloaded neighbors' own rows as destinations
        d[ids[:n_real], 0] = met[:n_real]
    return d.astype(np.int32), met, ids, over, my_id


def _jax_buffer(dist, met, ids, over, my_id, with_lfa):
    dist, met, ids, over = map(jnp.asarray, (dist, met, ids, over))
    fh = jspf.first_hop_matrix(dist, met, ids, over)
    parts = [jax.lax.bitcast_convert_type(dist[:, 0], jnp.uint8).reshape(-1),
             jnp.packbits(fh, axis=1).reshape(-1)]
    if with_lfa:
        lfa = jspf.lfa_matrix(dist, jnp.int32(my_id), ids, over)
        parts.append(jnp.packbits(lfa, axis=1).reshape(-1))
    return np.asarray(jnp.concatenate(parts))


KINDS = ("plain", "inf", "over", "inf_over", "asym", "inf_over_asym")
#: (vp, B, N): the 100k benchmark's kind of shape at a small vp, then B 8
#: to 128 with 0, 1 and B - 1 neighbors on vp 1 032 (packed rows of 129
#: bytes: the kernel's last word of a row is partial and its words
#: unaligned)
SHAPES = [(2048, 16, 15)] + [(1032, b, n) for b in (8, 16, 32, 64, 128)
                             for n in sorted({0, 1, b - 1})]


@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "x".join(map(str, s)))
@pytest.mark.parametrize("with_lfa", [False, True])
@pytest.mark.parametrize("kind", KINDS)
def test_buffer_equals_jax(kind, with_lfa, shape):
    vp, b, n = shape
    seed = KINDS.index(kind) + (7 * b + n if shape != SHAPES[0] else 0)
    dist, met, ids, over, my_id = _case(kind, seed, vp, b, n)
    want = _jax_buffer(dist, met, ids, over, my_id, with_lfa)
    got = rib_epilogue.rib_buffer(
        torch.from_numpy(dist), torch.from_numpy(met), torch.from_numpy(ids),
        torch.from_numpy(over), my_id, with_lfa)
    assert got.dtype == torch.uint8
    assert got.shape[0] == rib_epilogue.buffer_bytes(*dist.shape[:1],
                                                     ids.shape[0], with_lfa)
    np.testing.assert_array_equal(got.numpy(), want)
    d_root, fh, lfa = jsplit.unpack_rib_buffer(got.numpy(), vp, n + 1,
                                               with_lfa)
    np.testing.assert_array_equal(d_root, dist[:, 0])
    assert fh.shape == (n, vp) and fh.any() == (n > 0)
    assert (lfa is not None) == with_lfa
    assert not fh[min(n, 11):].any()  # padding neighbors carry no bit
    # an overloaded neighbor on its own shortest path is still its own
    # first hop (the holes of the INF kinds may take that path away)
    own = [k for k in range(min(n, 11)) if over[k]
           and dist[ids[k], 0] < INF and dist[ids[k], 1 + k] < INF
           and met[k] + dist[ids[k], 1 + k] == dist[ids[k], 0]]
    assert all(fh[k, ids[k]] for k in own)
    if "over" in kind and shape == SHAPES[0]:
        assert own


def test_buffer_fewer_neighbors_than_columns():
    """N = B - 1 neighbor arrays are the solve's; a shorter list reads
    only its own columns, as `first_hop_matrix` does."""
    dist, met, ids, over, my_id = _case("inf_over", 9)
    want = _jax_buffer(dist, met[:7], ids[:7], over[:7], my_id, True)
    got = rib_epilogue.rib_buffer(
        torch.from_numpy(dist), torch.from_numpy(met[:7]),
        torch.from_numpy(ids[:7]), torch.from_numpy(over[:7]), my_id, True)
    np.testing.assert_array_equal(got.numpy(), want)


def test_buffer_checks_its_shapes():
    dist, met, ids, over, my_id = _case("plain", 1)
    t = [torch.from_numpy(x) for x in (dist, met, ids, over)]
    with pytest.raises(ValueError, match="multiple of 8"):
        rib_epilogue.rib_buffer(t[0][:-3], *t[1:], my_id, False)
    with pytest.raises(ValueError, match="neighbor"):
        rib_epilogue.rib_buffer(t[0], t[1][:4], *t[2:], my_id, False)


@pytest.mark.parametrize("with_lfa", [False, True])
def test_epilogue_work_counts_the_buffer(with_lfa):
    """The least bytes: of every row, the 32-byte sectors that hold
    columns 0..N (at the 100k benchmark's B 32 and N 31 the whole
    matrix), the neighbors' arrays read once, the packed buffer written
    once; the compares a bit. Fewer neighbors than columns read only
    their sectors."""
    vp, b = 106_496, 32
    n = b - 1
    nbytes, ops = rib_epilogue.epilogue_work(vp, b, n, with_lfa)
    assert nbytes == (vp * b * 4 + n * 9 + (n * 4 if with_lfa else 0)
                      + rib_epilogue.buffer_bytes(vp, n, with_lfa))
    assert ops == first_hop_work(vp, b)[1] + (7 * n * vp if with_lfa else 0)
    assert rib_epilogue.buffer_bytes(vp, n, False) == 838_656
    # config 2's B of 128 with 40 neighbors: 41 columns, 164 bytes, 6
    # sectors a row
    nbytes, ops = rib_epilogue.epilogue_work(10_240, 128, 40, with_lfa)
    assert nbytes == (10_240 * 6 * 32 + 40 * 9 + (40 * 4 if with_lfa else 0)
                      + rib_epilogue.buffer_bytes(10_240, 40, with_lfa))
    assert ops == (5 + (7 if with_lfa else 0)) * 40 * 10_240


@pytest.mark.parametrize("b", [1, 3, 6, 8, 12, 40])
def test_row_sectors_counts_each_sector_once(b):
    """`row_sectors` against a walk over every row's bytes, where rows
    share sectors or straddle them."""
    vp = 50
    for cols in sorted({1, 2, b}):
        if cols > b:
            continue
        want = {(r * b * 4 + c * 4) // 32 for r in range(vp)
                for c in range(cols)}
        assert rib_epilogue.row_sectors(vp, b, cols) == len(want)

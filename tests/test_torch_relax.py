"""The relax kernel's plain version (what the port runs on the CPU) is
equal to the JAX package's Pallas kernel run in interpret mode, and its
row-indirection modes are equal to `_relax_rows` on gathered rows
followed by `.at[rows].min`; its row flags are the rows it lowered; and
the Python bindings agree with the C entry points of `csrc/relax.cu`."""

import pathlib
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from openr_tpu.ops.spf_pallas import _relax_once, batched_sssp_pallas
from openr_tpu.ops.spf_split import _relax_rows
from openr_tpu_torch.ops import relax

INF = 1 << 30

# one intra-op thread: the suite runs several test workers at once
torch.set_num_threads(1)


def _tables(v, d, b, seed, frac_pad=0.3, frac_over=0.0):
    rng = np.random.default_rng(seed)
    nbr = rng.integers(0, v, size=(v, d)).astype(np.int32)
    wgt = rng.integers(1, 64, size=(v, d)).astype(np.int32)
    wgt[rng.random((v, d)) < frac_pad] = INF  # INF padding slots
    roots = rng.integers(0, v, size=b).astype(np.int32)
    over = rng.random(v) < frac_over
    if frac_over:
        over[roots[0]] = True  # an overloaded root: the exemption path
    dist = rng.integers(0, 500, size=(v, b)).astype(np.int32)
    dist[rng.random((v, b)) < 0.4] = INF
    dist[roots, np.arange(b)] = 0
    return nbr, wgt, roots, over, dist


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("frac_over", [0.0, 0.15])
def test_one_sweep_equals_pallas_interpret(seed, frac_over):
    v, d, b = 256, 8, 16
    nbr, wgt, roots, over, dist = _tables(v, d, b, seed, frac_over=frac_over)
    has_over = frac_over > 0
    over_t = over[nbr]
    ref, ref_changed = _relax_once(
        jnp.asarray(nbr), jnp.asarray(wgt), jnp.asarray(over_t),
        jnp.asarray(roots), jnp.asarray(dist), 64, has_over, True,
    )
    got, changed = relax.relax_sweep(
        _t(dist), _t(nbr), _t(wgt), _t(roots),
        _t(over_t) if has_over else None,
    )
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    assert int(changed.item()) == int(ref_changed)


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("frac_over", [0.0, 0.1])
def test_fixpoint_equals_batched_sssp_pallas(seed, frac_over):
    v, d, b = 256, 8, 8
    nbr, wgt, roots, over, _ = _tables(v, d, b, seed, frac_over=frac_over)
    has_over = frac_over > 0
    ref = batched_sssp_pallas(
        jnp.asarray(nbr), jnp.asarray(wgt), jnp.asarray(over),
        jnp.asarray(roots), has_overloads=has_over, tile=128,
        interpret=True,
    )
    got = relax.batched_sssp_relax(
        _t(nbr), _t(wgt), _t(over), _t(roots), has_overloads=has_over
    )
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


def _jax_rows(dist, nbr, wgt, over_t, roots, src, dst, has_over):
    """JAX reference: `_relax_rows` on the gathered rows, then a min
    scatter into the targets."""
    sub = _relax_rows(
        jnp.asarray(dist), jnp.asarray(nbr[src]), jnp.asarray(wgt[src]),
        jnp.asarray(over_t[src]) if has_over else None,
        jnp.asarray(roots), has_over,
    )
    return np.asarray(jnp.asarray(dist).at[jnp.asarray(dst)].min(sub))


@pytest.mark.parametrize("mode", ["row0", "dst_rows", "src_dst_rows"])
@pytest.mark.parametrize("frac_over", [0.0, 0.2])
def test_indirection_modes_equal_jax_relax_rows(mode, frac_over):
    v, d, b = 512, 16, 8
    nbr, wgt, roots, over, dist = _tables(v, d, b, 5, frac_over=frac_over)
    has_over = frac_over > 0
    over_t = over[nbr]
    rng = np.random.default_rng(9)
    if mode == "row0":  # one dense chunk
        src = np.arange(128, 384)
        dst = src
        kw = dict(row0=128, n=256)
        tab = (nbr, wgt, over_t)
    elif mode == "dst_rows":  # overflow table: own rows, targets repeat
        ro = 64
        dst = rng.integers(0, v, ro).astype(np.int32)
        dst[ro // 2 :] = v - 1  # dead-slot padding
        src = np.arange(ro)
        tab = (nbr[:ro], wgt[:ro], over_t[:ro])
        kw = dict(dst_rows=_t(dst))
    else:  # compacted tail: rows of the base table, padded with dead
        rows = np.sort(rng.choice(v - 1, 100, replace=False)).astype(np.int32)
        rows = np.concatenate([rows, np.full(28, v - 1, np.int32)])
        src = dst = rows
        tab = (nbr, wgt, over_t)
        kw = dict(src_rows=_t(rows), dst_rows=_t(rows))
    ref = _jax_rows(dist, tab[0], tab[1], tab[2], roots, src, dst, has_over)
    out = _t(dist).clone()
    relax.relax_rows(
        _t(dist), out, _t(tab[0]), _t(tab[1]), _t(roots),
        _t(tab[2]) if has_over else None, **kw,
    )
    np.testing.assert_array_equal(out.numpy(), ref)


def test_wrapper_checks_inputs():
    nbr, wgt, roots, _over, dist = _tables(64, 8, 8, 0)
    d, n, w, r = _t(dist), _t(nbr), _t(wgt), _t(roots)
    with pytest.raises(TypeError):
        relax.relax_rows(d.long(), d.long(), n, w, r)
    with pytest.raises(ValueError):
        relax.relax_rows(d, d, n.t(), w, r)  # not contiguous
    with pytest.raises(ValueError):
        relax.relax_rows(d, d, n, w, r[:4])
    with pytest.raises(ValueError):
        relax.relax_rows(d, d, n, w, r, row0=60, n=8)
    launches = relax.LAUNCHES
    relax.relax_rows(d, d.clone(), n, w, r)  # CPU: plain version
    assert relax.LAUNCHES == launches


def _flag_case(mode, frac_over):
    """(dist, table, kwargs) for one indirection form, as the solve calls
    it: a dense chunk, the overflow table into repeated targets, and the
    compacted tail rows."""
    v, d, b = 512, 16, 8
    nbr, wgt, roots, over, dist = _tables(v, d, b, 11, frac_over=frac_over)
    over_t = over[nbr] if frac_over else None
    rng = np.random.default_rng(12)
    if mode == "row0":
        kw = dict(row0=128, n=256)
        tab = (nbr, wgt, over_t)
    elif mode == "dst_rows":
        ro = 64
        dst = rng.integers(0, v, ro).astype(np.int32)
        dst[ro // 2 :] = v - 1  # dead-slot padding: repeated targets
        dst[:4] = dst[4]  # a live target repeated too
        tab = (nbr[:ro], wgt[:ro], None if over_t is None else over_t[:ro])
        kw = dict(dst_rows=_t(dst))
    else:
        rows = np.sort(rng.choice(v - 1, 100, replace=False)).astype(np.int32)
        rows = _t(np.concatenate([rows, np.full(28, v - 1, np.int32)]))
        tab = (nbr, wgt, over_t)
        kw = dict(src_rows=rows, dst_rows=rows)
    return dist, roots, tab, kw


@pytest.mark.parametrize("preset", [False, True])
@pytest.mark.parametrize("mode", ["row0", "dst_rows", "src_dst_rows"])
@pytest.mark.parametrize("frac_over", [0.0, 0.2])
def test_ref_row_flags_are_the_lowered_rows(mode, frac_over, preset):
    dist, roots, tab, kw = _flag_case(mode, frac_over)
    out = _t(dist).clone()
    before = out.clone()
    row_flag = torch.zeros(dist.shape[0], dtype=torch.int32)
    if preset:  # a flag an earlier launch of the round set
        row_flag[::7] = 1
    set_before = row_flag.clone()
    rows_changed = torch.zeros(1, dtype=torch.int32)
    relax.relax_rows_ref(
        _t(dist), out, _t(tab[0]), _t(tab[1]), _t(roots),
        None if tab[2] is None else _t(tab[2]),
        row_flag=row_flag, rows_changed=rows_changed, **kw,
    )
    lowered = (out < before).any(dim=1)
    assert lowered.any()
    np.testing.assert_array_equal(
        row_flag.numpy(), (lowered | (set_before != 0)).int().numpy()
    )
    assert int(rows_changed.item()) == int((lowered & (set_before == 0)).sum())


@pytest.mark.parametrize("w,b,design", [
    (8, 8, "vec"), (16, 32, "vec"), (32, 32, "vec"), (64, 8, "vec"),
    (64, 64, "vec"), (1, 32, "generic"), (4, 8, "generic"),
    (128, 32, "generic"), (32, 128, "generic"), (128, 128, "generic"),
    (24, 32, "generic"), (32, 48, "generic"),
])
def test_design_for_maps_shapes(w, b, design):
    assert relax.design_for(w, b) == design


CU_SRC = pathlib.Path(relax.__file__).resolve().parents[1] / "csrc/relax.cu"


def test_extern_c_signatures_match_argtypes():
    """Every C entry point of relax.cu has as many parameters as the
    ctypes argtypes bound to it (the only check before a card)."""
    src = CU_SRC.read_text()
    sigs = {
        m.group(1): m.group(2)
        for m in re.finditer(r'extern "C"[^(]*?\b(\w+)\s*\(([^)]*)\)', src)
    }
    assert set(sigs) == set(relax.ENTRY_POINTS)
    for name, params in sigs.items():
        n_params = len([p for p in params.split(",") if p.strip()])
        assert n_params == len(relax.ENTRY_POINTS[name][0]), name


def test_c_dispatch_widths_match_design_for():
    """The C dispatch specialises exactly the widths `design_for` names."""
    src = CU_SRC.read_text()
    body = src[src.index("int width_index(int x)"):]
    body = body[: body.index("}\n}")]
    cases = {int(x) for x in re.findall(r"case (\d+): return", body)}
    assert cases == set(relax.VEC_WIDTHS)


def test_wrapper_checks_flag_buffers():
    nbr, wgt, roots, _over, dist = _tables(64, 8, 8, 0)
    d, n, w, r = _t(dist), _t(nbr), _t(wgt), _t(roots)
    flag = torch.zeros(64, dtype=torch.int32)
    count = torch.zeros(1, dtype=torch.int32)
    with pytest.raises(ValueError):  # one flag per dist row
        relax.relax_rows(d, d.clone(), n, w, r, row_flag=flag[:32])
    with pytest.raises(TypeError):
        relax.relax_rows(d, d.clone(), n, w, r, row_flag=flag.long())
    with pytest.raises(ValueError):  # a count needs the flags it counts
        relax.relax_rows(d, d.clone(), n, w, r, rows_changed=count)
    relax.relax_rows(d, d.clone(), n, w, r, row_flag=flag, rows_changed=count)
    assert int(count.item()) == int(flag.sum()) > 0
    # the vectorised kernel's 16-byte vectors need aligned buffers
    with pytest.raises(ValueError):
        relax._check_aligned(d.reshape(-1)[1:], d, n, w, None)
    relax._check_aligned(d, d, n, w, None)


# ------------------------------------------------------- wide shapes


@pytest.mark.parametrize("w,b,design,np_", [
    (64, 128, "generic", 1), (32, 128, "generic", 1),
    (128, 256, "generic", 2), (512, 128, "generic", 1),
    (64, 512, "generic", 4), (256, 1024, "generic", 4),
    (64, 32, "vec", 1), (24, 48, "generic", 1), (4, 8, "generic", 1),
    (1, 32, "generic", 0), (6, 12, "generic", 0), (8, 10, "generic", 0),
])
def test_design_for_and_generic_path_at_wide_and_odd_shapes(w, b, design,
                                                             np_):
    """A fabric's shapes (B 128 and up, overflow tables of 32 to 512
    slots) take the generic kernel; its 16-byte strip path needs B and W
    multiples of 4, and takes 1, 2 or 4 strips a lane by B."""
    assert relax.design_for(w, b) == design
    assert relax.generic_np(w, b) == np_


@pytest.mark.parametrize("mode", ["row0", "dst_rows", "src_dst_rows"])
@pytest.mark.parametrize("frac_over", [0.0, 0.2])
@pytest.mark.parametrize("w,b", [(128, 128), (128, 256), (256, 128),
                                 (256, 256)])
def test_wide_shapes_equal_jax_relax_rows(mode, frac_over, w, b):
    """The plain version at the generic kernel's wide shapes (W and B of
    128 and 256) in every indirection form, overloads off and on, equals
    `_relax_rows` + `.at[rows].min`; its row flags are the rows it
    lowered."""
    v = 384
    nbr, wgt, roots, over, dist = _tables(v, w, b, 21, frac_over=frac_over)
    has_over = frac_over > 0
    over_t = over[nbr]
    rng = np.random.default_rng(22)
    tab = (nbr, wgt, over_t)
    if mode == "row0":
        src = dst = np.arange(96, 288)
        kw = dict(row0=96, n=192)
    elif mode == "dst_rows":
        ro = 48
        dst = rng.integers(0, v, ro).astype(np.int32)
        dst[ro // 2 :] = v - 1
        dst[:4] = dst[4]
        src = np.arange(ro)
        tab = tuple(x[:ro] for x in tab)
        kw = dict(dst_rows=_t(dst))
    else:
        rows = np.sort(rng.choice(v - 1, 80, replace=False)).astype(np.int32)
        rows = np.concatenate([rows, np.full(16, v - 1, np.int32)])
        src = dst = rows
        kw = dict(src_rows=_t(rows), dst_rows=_t(rows))
    ref = _jax_rows(dist, tab[0], tab[1], tab[2], roots, src, dst, has_over)
    out = _t(dist).clone()
    flag = torch.zeros(v, dtype=torch.int32)
    count = torch.zeros(1, dtype=torch.int32)
    relax.relax_rows(
        _t(dist), out, _t(tab[0]), _t(tab[1]), _t(roots),
        _t(tab[2]) if has_over else None, row_flag=flag,
        rows_changed=count, **kw,
    )
    np.testing.assert_array_equal(out.numpy(), ref)
    lowered = (ref < dist).any(axis=1)
    assert lowered.any()
    np.testing.assert_array_equal(flag.numpy(), lowered.astype(np.int32))
    assert int(count.item()) == int(lowered.sum())


@pytest.mark.parametrize("frac_over", [0.0, 0.15])
def test_wide_sweep_equals_pallas_interpret(frac_over):
    """One dense sweep at B = 128 over a table of 128 slots (a hub's
    shape on the generic kernel) equals the Pallas kernel in interpret
    mode, changed count included."""
    v, d, b = 128, 128, 128
    nbr, wgt, roots, over, dist = _tables(v, d, b, 3, frac_over=frac_over)
    has_over = frac_over > 0
    over_t = over[nbr]
    ref, ref_changed = _relax_once(
        jnp.asarray(nbr), jnp.asarray(wgt), jnp.asarray(over_t),
        jnp.asarray(roots), jnp.asarray(dist), 64, has_over, True,
    )
    got, changed = relax.relax_sweep(
        _t(dist), _t(nbr), _t(wgt), _t(roots),
        _t(over_t) if has_over else None,
    )
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    assert int(changed.item()) == int(ref_changed)


def test_c_generic_dispatch_matches_generic_np():
    """The C choice of the generic kernel's path (`generic_np` in
    relax.cu) is the one `relax.generic_np` mirrors, on a grid of
    shapes."""
    src = CU_SRC.read_text()
    body = src[src.index("int generic_np(int W, int B)"):]
    body = body[: body.index("\n}\n")]
    align = re.search(r"if \(B % (\d+) \|\| W % (\d+)\) return 0;", body)
    steps = re.search(r"q <= (\d+) \? (\d) : q <= (\d+) \? (\d) : (\d);",
                      body)
    assert align and steps and "const int q = B / 4;" in body
    am, aw = int(align.group(1)), int(align.group(2))
    q1, n1, q2, n2, n3 = (int(x) for x in steps.groups())

    def c_np(w, b):
        if b % am or w % aw:
            return 0
        q = b // 4
        return n1 if q <= q1 else n2 if q <= q2 else n3

    grid = (1, 2, 4, 6, 8, 10, 12, 16, 24, 32, 48, 64, 96, 128, 129, 256,
            384, 512, 1024)
    for w in grid:
        for b in grid:
            assert c_np(w, b) == relax.generic_np(w, b), (w, b)

"""The edge solve's index built on the tensors' device
(`ops/edge_relax.py` `device_edge_index`) against the NumPy builders,
field by field, and through the solve: the JAX package's `batched_sssp`
on the same edge arrays."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from openr_tpu.decision.linkstate import LinkState as JaxLinkState
from openr_tpu.ops.spf import batched_sssp as jax_batched_sssp
from openr_tpu.ops.spf import build_blocked
from openr_tpu.utils import topogen as jtopo
from openr_tpu_torch.monitor import compile_ledger
from openr_tpu_torch.ops import edge_relax

# one intra-op thread: the suite runs several test workers at once
torch.set_num_threads(1)

INF = edge_relax.INF_DIST


def _csr_arrays(n=300, seed=4):
    """A CsrGraph's edge arrays, its trailing INF padding included."""
    ls = JaxLinkState()
    for db in jtopo.erdos_renyi(n, avg_degree=5, seed=seed,
                                max_metric=20)[0]:
        ls.update_adjacency_db(db)
    csr = ls.to_csr()
    return (csr.edge_src, csr.edge_dst, csr.edge_metric, csr.padded_nodes,
            csr)


def _hub_arrays(v=64, seed=0):
    """Runs into nodes 5 and 9 longer than `SEG_EDGES` (one several
    segments long), nodes with no in-edge, and INF padding at the end."""
    rng = np.random.default_rng(seed)
    seg = edge_relax.SEG_EDGES
    dst = np.sort(np.concatenate([
        rng.integers(20, v - 1, 200), np.full(3 * seg + 17, 5),
        np.full(seg + 1, 9), np.full(40, v - 1)])).astype(np.int32)
    src = rng.integers(0, v - 1, len(dst)).astype(np.int32)
    met = rng.integers(1, 30, len(dst)).astype(np.int32)
    met[-40:] = INF  # the padding, all into the dead slot v - 1
    return src, dst, met, v


def _padding_only(v=32):
    e = 48
    return (np.zeros(e, np.int32), np.full(e, v - 1, np.int32),
            np.full(e, INF, np.int32), v)


CASES = {
    "csr": lambda: _csr_arrays()[:4],
    "hub": _hub_arrays,
    "padding_only": _padding_only,
    "empty": lambda: (np.zeros(0, np.int32),) * 3 + (16,),
}


def _t(*arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]


@pytest.mark.parametrize("case", sorted(CASES))
def test_device_index_equals_numpy(case):
    src, dst, met, v = CASES[case]()
    want = edge_relax.edge_index(src, dst, met, v)
    led = compile_ledger.ledger()
    reads = led.host_reads
    got = edge_relax.device_edge_index(*_t(src, dst, met), v)
    assert led.host_reads - reads == 1  # the build's one read
    for name, w, g in zip(edge_relax.EdgeIndex._fields, want, got):
        assert g.dtype == torch.int32, name
        np.testing.assert_array_equal(g.numpy(), w, err_msg=name)
    if case == "hub":
        assert len(want.seg_node) > 4  # the long runs are segmented
    if case == "padding_only":
        assert int(got.row_start[-1]) == 0


@pytest.mark.parametrize("case", sorted(CASES))
def test_each_torch_builder_equals_numpy(case, monkeypatch):
    """Each piece of the device build against its NumPy builder: the
    runs (`edge_row_start`), the out-edge index (`edge_out_index`) and
    the segments (`edge_segments`) at the kernels' segment length and at
    a short one, which cuts every run of the cases into segments."""
    src, dst, met, v = CASES[case]()
    rs = edge_relax.edge_row_start(dst, v, met)
    for seg in (edge_relax.SEG_EDGES, 5):
        monkeypatch.setattr(edge_relax, "SEG_EDGES", seg)
        got = edge_relax.device_edge_index(*_t(src, dst, met), v)
        np.testing.assert_array_equal(got.row_start.numpy(), rs)
        for w, g in zip(edge_relax.edge_out_index(src, rs),
                        (got.out_start, got.out_slot)):
            np.testing.assert_array_equal(g.numpy(), w)
        for w, g in zip(edge_relax.edge_segments(rs, seg),
                        (got.seg_node, got.seg_lo)):
            np.testing.assert_array_equal(g.numpy(), w)


def test_given_row_start_is_taken_as_it_is():
    src, dst, met, v = _hub_arrays()
    rs = edge_relax.edge_row_start(dst, v, np.zeros_like(met))  # no cut
    want = edge_relax.edge_index(src, dst, met, v, row_start=rs)
    got = edge_relax.device_edge_index(*_t(src, dst, met), v, row_start=rs)
    for w, g in zip(want, got):
        np.testing.assert_array_equal(g.numpy(), w)


@pytest.mark.parametrize("fault", ["unsorted_dst", "dst_out_of_range",
                                   "src_out_of_range", "src_negative"])
def test_bad_input_raises_like_numpy(fault):
    src, dst, met, v = _hub_arrays()
    src, dst = src.copy(), dst.copy()
    if fault == "unsorted_dst":
        dst[0] = v - 2  # above its successor
    elif fault == "dst_out_of_range":
        dst[-1] = v
    elif fault == "src_out_of_range":
        src[3] = v
    else:
        src[7] = -1
    with pytest.raises(ValueError) as np_err:
        edge_relax.edge_index(src, dst, met, v)
    with pytest.raises(ValueError) as t_err:
        edge_relax.device_edge_index(*_t(src, dst, met), v)
    assert str(t_err.value) == str(np_err.value)


def test_src_past_the_runs_is_not_checked():
    """A padding slot's src is never walked, so neither builder checks
    it."""
    src, dst, met, v = _hub_arrays()
    src = src.copy()
    src[-1] = 10 * v
    want = edge_relax.edge_index(src, dst, met, v)
    got = edge_relax.device_edge_index(*_t(src, dst, met), v)
    for w, g in zip(want, got):
        np.testing.assert_array_equal(g.numpy(), w)


@pytest.mark.parametrize("b", [1, 8, 13])
def test_solve_on_the_device_index_equals_jax(b):
    """`batched_sssp` on the index the torch builders made equals the JAX
    package's `batched_sssp` on the same CsrGraph edge arrays."""
    src, dst, met, v, csr = _csr_arrays(n=200, seed=7)
    blocked = build_blocked(met, src, csr.node_overloaded)
    roots = (np.arange(b) * 37 % csr.num_nodes).astype(np.int32)
    index = edge_relax.device_edge_index(*_t(src, dst, met), v)
    got = edge_relax.batched_sssp(*_t(src, dst, met, blocked),
                                  torch.from_numpy(roots), v, index=index)
    want = np.asarray(jax_batched_sssp(
        *map(jnp.asarray, (src, dst, met, blocked)), jnp.asarray(roots), v))
    np.testing.assert_array_equal(got.numpy(), want)

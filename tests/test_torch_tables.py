"""The port's NumPy host builders and buffer decoder are array-equal to
the JAX package's on the same inputs."""

import numpy as np
import pytest
import torch

from openr_tpu.decision.linkstate import LinkState as JaxLinkState
from openr_tpu.ops import spf_split as jsplit
from openr_tpu.utils import topogen as jtopo
from openr_tpu_torch.decision.linkstate import LinkState
from openr_tpu_torch.ops import spf_split as psplit
from openr_tpu_torch.utils import topogen as ptopo

# one intra-op thread: the suite runs several test workers at once
torch.set_num_threads(1)


def _csr_pair(gen, *args):
    """The same generator through both packages' LinkState.to_csr()."""
    out = []
    for mod, cls in ((jtopo, JaxLinkState), (ptopo, LinkState)):
        ls = cls()
        for db in getattr(mod, gen)(*args)[0]:
            ls.update_adjacency_db(db)
        out.append(ls.to_csr())
    return out


GRAPHS = [
    ("hub_and_spoke", (2, 300)),  # hub in-degree >> W: overflow rows
    ("hub_and_spoke", (3, 40)),
    ("grid", (6, 7)),  # metric-uniform
    ("fat_tree", (4,)),
    ("wan_like", (60, 1)),
]


@pytest.mark.parametrize("gen,args", GRAPHS)
def test_csr_and_split_tables_equal(gen, args):
    jc, pc = _csr_pair(gen, *args)
    for f in ("edge_src", "edge_dst", "edge_metric", "node_overloaded",
              "node_mask"):
        np.testing.assert_array_equal(getattr(pc, f), getattr(jc, f))
    assert pc.node_names == jc.node_names
    assert pc.adj_details == jc.adj_details
    jt = jsplit.build_split_tables(
        jc.edge_src, jc.edge_dst, jc.edge_metric, jc.num_nodes
    )
    pt = psplit.build_split_tables(
        pc.edge_src, pc.edge_dst, pc.edge_metric, pc.num_nodes
    )
    assert jt.keys() == pt.keys()
    for k in jt:
        np.testing.assert_array_equal(pt[k], jt[k], err_msg=k)
    if gen == "hub_and_spoke" and args[1] == 300:
        assert (pt["ov_ids"] != pt["vp"] - 1).any()  # overflow exists
    if gen == "grid":
        assert pt["uniform_metric"] == 1


@pytest.mark.parametrize("n,deg,mw,seed", [(3000, 8, 16, 0), (700, 20, 1, 3)])
def test_erdos_renyi_and_builders_equal(n, deg, mw, seed):
    ja = jtopo.erdos_renyi_csr(n, avg_degree=deg, seed=seed, max_metric=mw)
    pa = ptopo.erdos_renyi_csr(n, avg_degree=deg, seed=seed, max_metric=mw)
    for x, y in zip(ja, pa):
        np.testing.assert_array_equal(y, x)
    es, ed, em, _vp, nn, _e = pa
    for base_width in (None, 8):
        jt = jsplit.build_split_tables(es, ed, em, nn, base_width=base_width)
        pt = psplit.build_split_tables(es, ed, em, nn, base_width=base_width)
        for k in jt:
            np.testing.assert_array_equal(pt[k], jt[k], err_msg=k)
    indeg = np.bincount(ed[em < (1 << 30)], minlength=nn + 1)
    assert psplit.pick_base_width(indeg) == jsplit.pick_base_width(indeg)


def test_tight_nodes_and_gs_chunks_equal():
    for n in list(range(0, 5000, 37)) + [8191, 8192, 99_999, 100_000,
                                         250_000, 1 << 20]:
        vp = jsplit.tight_nodes(n)
        assert psplit.tight_nodes(n) == vp
        assert psplit.pick_gs_chunks(vp) == jsplit.pick_gs_chunks(vp)
    for vp in (512, 4096, 8192, 8200, 12_000, 106_496):
        assert psplit.pick_gs_chunks(vp) == jsplit.pick_gs_chunks(vp)


@pytest.mark.parametrize("with_lfa", [False, True])
def test_unpack_rib_buffer_equal(with_lfa):
    rng = np.random.default_rng(11)
    vp, b = 1024, 8
    parts = 4 * vp + (b - 1) * vp // 8 * (2 if with_lfa else 1)
    buf = rng.integers(0, 256, parts).astype(np.uint8)
    got = psplit.unpack_rib_buffer(buf, vp, b, with_lfa)
    ref = jsplit.unpack_rib_buffer(buf, vp, b, with_lfa)
    for g, r in zip(got, ref):
        if r is None:
            assert g is None
        else:
            np.testing.assert_array_equal(g, r)


def test_packbits_is_msb_first_like_numpy():
    rng = np.random.default_rng(2)
    bits = rng.random((5, 64)) < 0.4
    got = psplit.packbits_rows(torch.from_numpy(bits)).numpy()
    np.testing.assert_array_equal(got, np.packbits(bits, axis=1))
    psplit.check_byte_order("cpu")

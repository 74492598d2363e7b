"""The dense- and edge-table RIB branch of `TorchSpfSolver.solve` through
kernel C (`ops/rib_epilogue.py` `rib_buffer`): first hops, LFA bits and
distances equal `TpuSpfSolver`'s on a WAN-like graph with overloaded
nodes, LFA on and off; one `rib_epilogue` cost row under the
reference's name, and one host read of the packed buffer a RIB."""

import numpy as np
import pytest
import torch

from openr_tpu.decision.linkstate import LinkState as JaxLinkState
from openr_tpu.decision.linkstate import PrefixState as JaxPrefixState
from openr_tpu.decision.spf_backend import TpuSpfSolver
from openr_tpu.utils import topogen as jtopo
from openr_tpu_torch import LinkState, PrefixState, TorchSpfSolver
from openr_tpu_torch.decision.spf_backend import LazyDist
from openr_tpu_torch.monitor import compile_ledger, device
from openr_tpu_torch.ops import rib_epilogue
from openr_tpu_torch.utils import topogen as ptopo
from test_torch_solver import _states, canon

# one intra-op thread: the suite runs several test workers at once
torch.set_num_threads(1)

OVERLOADED = ("node-1", "node-5", "node-20")


def _both():
    kw = dict(overloaded=OVERLOADED)
    return (_states(jtopo, JaxLinkState, JaxPrefixState, "wan_like",
                    (40, 2), **kw),
            _states(ptopo, LinkState, PrefixState, "wan_like", (40, 2), **kw))


@pytest.mark.parametrize("me", ["node-0", "node-5"])  # node-5 overloaded
@pytest.mark.parametrize("lfa", [False, True])
@pytest.mark.parametrize("table", ["dense", "edge"])
def test_branch_equals_jax(table, lfa, me):
    (jls, jps), (pls, pps) = _both()
    knobs = dict(use_dense=table == "dense", enable_lfa=lfa)
    ref = TpuSpfSolver(native_rib="off", **knobs)
    port = TorchSpfSolver(device="cpu", **knobs)
    csr = pls.to_csr()
    assert port._pick_table(csr) == table
    port.solve(pls, me)  # the tables and the neighbour cache
    device.telemetry().reset()
    led = compile_ledger.ledger()
    reads, nbytes = led.host_reads, led.host_bytes
    got = port.solve(pls, me)
    want = ref.solve(jls, me)
    _csr, dist, fh, nbr_ids, lfa_bits = got
    b = dist.shape[1]
    assert (led.host_reads - reads, led.host_bytes - nbytes) == (
        1, rib_epilogue.buffer_bytes(csr.padded_nodes, b - 1, lfa))
    row = device.kernel_rows()["first_hop_matrix"]
    assert row.sources == ("rib_epilogue",) and row.launches == 1
    assert row.span == "spf:batched_dist" and not row.span_complete
    assert nbr_ids == list(want[3])
    np.testing.assert_array_equal(fh, np.asarray(want[2]))
    if lfa:
        np.testing.assert_array_equal(lfa_bits, np.asarray(want[4]))
        assert lfa_bits.any()
    else:
        assert lfa_bits is None and want[4] is None
    assert isinstance(dist, LazyDist)
    np.testing.assert_array_equal(dist[:, 0], np.asarray(want[1])[:, 0])
    assert led.host_reads - reads == 1  # the root column from the buffer
    np.testing.assert_array_equal(np.asarray(dist), np.asarray(want[1]))
    assert canon(port.compute_routes(pls, pps, me)) == canon(
        ref.compute_routes(jls, jps, me))


def test_branch_equals_the_split_rib():
    """The three tables' RIBs of one LSDB are one RIB."""
    (_j, _jp), (pls, pps) = _both()
    ribs = [canon(TorchSpfSolver(device="cpu", use_dense=d, enable_lfa=True)
                  .compute_routes(pls, pps, "node-0"))
            for d in (None, True, False)]
    assert ribs[0] == ribs[1] == ribs[2]

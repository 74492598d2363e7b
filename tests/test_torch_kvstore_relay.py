"""The port's KvStore relays a JAX node's sampled flood as the JAX
package's does (`openr_tpu/kvstore/kvstore.py` `_apply`, `relayed_span`).

A JAX node with `trace_sample_every > 0` originates publications that
carry a packed flood span (`PerfEvents.span_bin`). A store that relays
such a publication adds no KVSTORE_FLOODED marker: the span's hop record
stands for it. Every other publication is stamped: an untraced or
span-less relayed flood, and a local `set_key`.

The same `to_wire_bin` frame goes through both packages' stores'
`_apply(from_peer=...)`, and the markers each store publishes are
compared, name and node, in order.
"""

import numpy as np
import pytest

import openr_tpu.kvstore as rkvs
import openr_tpu.messaging as rmsg
import openr_tpu.monitor.perf as rperf
import openr_tpu.types.kvstore as rkv
import openr_tpu.types.serde as rs
from openr_tpu.config import Config as RefConfig
from openr_tpu_torch import kvstore as pkvs
from openr_tpu_torch import messaging as pmsg
from openr_tpu_torch.config import Config
from openr_tpu_torch.monitor import perf as pperf
from openr_tpu_torch.types import kvstore as pkv
from openr_tpu_torch.types import serde as ps

SEED = 20261020
ME = "relay"


def stores():
    """A JAX store and a port store, both named ME, each with a reader on
    its publications."""
    rq, pq = rmsg.ReplicateQueue(name="r"), pmsg.ReplicateQueue(name="p")
    ref = rkvs.KvStore(RefConfig.default(ME), rkvs.InProcKvTransport(), rq)
    port = pkvs.KvStore(Config.default(ME), pkvs.InProcKvTransport(), pq)
    return (ref, rq.get_reader()), (port, pq.get_reader())


def markers(reader) -> list:
    pub = reader.get_nowait()
    return [(e.event, e.node) for e in pub.perf_events.events]


def jax_frame(rng, traced: bool, sampled: bool) -> bytes:
    """A JAX origin's publication of a few adjacency keys, as its flood
    ships it: with a trace (ADJ_DB_UPDATED and KVSTORE_FLOODED at the
    origin) and, when `sampled`, a flood span begun there."""
    origin = f"node-{int(rng.integers(0, 100))}"
    kv = {f"adj:{origin}-{i}": rkv.Value(
        version=int(rng.integers(1, 1000)), originator_id=origin,
        value=bytes(rng.integers(0, 256, 32).astype(np.uint8))).with_hash()
        for i in range(int(rng.integers(1, 4)))}
    pe = None
    if traced:
        pe = rperf.PerfEvents.start(rperf.ADJ_DB_UPDATED, node=origin)
        if sampled:
            pe.begin_flood_trace(origin,
                                 trace_id=int(rng.integers(1, 1 << 60)) | 1)
            assert pe.span_bin
        pe.add_perf_event(rperf.KVSTORE_FLOODED, node=origin)
    return rs.to_wire_bin(rkv.Publication(
        area="0", key_vals=kv, node_ids=[origin], perf_events=pe))


@pytest.mark.parametrize("seed", range(4))
@pytest.mark.parametrize("kind", ["sampled", "traced", "untraced"])
def test_a_relayed_frame_publishes_the_same_markers(kind, seed):
    rng = np.random.default_rng(SEED + seed)
    blob = jax_frame(rng, traced=kind != "untraced",
                     sampled=kind == "sampled")
    (ref, r_rd), (port, p_rd) = stores()
    ref._apply("0", rs.from_wire_bin(blob, rkv.Publication), "node-up")
    port._apply("0", ps.from_wire_bin(blob, pkv.Publication), "node-up")
    if kind == "untraced":
        assert r_rd.get_nowait().perf_events is None
        assert p_rd.get_nowait().perf_events is None
        return
    got_ref, got_port = markers(r_rd), markers(p_rd)
    assert got_port == got_ref
    stamped = (rperf.KVSTORE_FLOODED, ME) in got_port
    assert stamped == (kind == "traced")


def test_a_local_write_is_stamped_on_both_sides():
    (ref, r_rd), (port, p_rd) = stores()
    ref.set_key("0", "k", rkv.Value(1, ME, b"v").with_hash(),
                perf_events=rperf.PerfEvents.start(rperf.ADJ_DB_UPDATED,
                                                   node=ME))
    port.set_key("0", "k", pkv.Value(1, ME, b"v").with_hash(),
                 perf_events=pperf.PerfEvents.start(pperf.ADJ_DB_UPDATED,
                                                    node=ME))
    got_ref, got_port = markers(r_rd), markers(p_rd)
    assert got_port == got_ref
    assert got_port[-1] == (pperf.KVSTORE_FLOODED, ME)

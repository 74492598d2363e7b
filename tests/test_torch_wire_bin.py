"""The port's binary wire codec (`openr_tpu_torch.types.serde`) held byte
for byte against the JAX package's: the same objects encode to the same
bytes in both packages, each package decodes the other's frames to equal
objects, malformed and mutated frames get the same answer from both, and
the type registries' schemas agree. Also the `PerfEvents.span_bin`
repair: the port carries the JAX package's appended wire field, so a
Publication with perf events encodes as the JAX package's does.

Every object is built once and reaches each package through the same
canonical JSON bytes (equal objects, the same dict order), so a byte
difference is the binary codec's."""

import dataclasses
import typing

import numpy as np
import pytest

import openr_tpu.monitor.perf as rperf
import openr_tpu.prefixmgr.ranges  # noqa: F401 — registers PrefixRange
import openr_tpu.types.events  # noqa: F401 — registers the events
import openr_tpu.types.kvstore as rkv
import openr_tpu.types.routes as rroutes
import openr_tpu.types.serde as rs
import openr_tpu.types.topology as rtopo
from openr_tpu.decision.linkstate import LinkState, PrefixState
from openr_tpu.decision.oracle import compute_routes
from openr_tpu.utils import topogen
import openr_tpu_torch.prefixmgr.ranges  # noqa: F401
import openr_tpu_torch.types.events  # noqa: F401
from openr_tpu_torch.monitor import perf as pperf
from openr_tpu_torch.types import kvstore as pkv
from openr_tpu_torch.types import routes as proutes
from openr_tpu_torch.types import serde as ps
from openr_tpu_torch.types import topology as ptopo

SEED = 20260519

# (JAX class, port class) of every shared schema type under test
PAIRS = {
    "Value": (rkv.Value, pkv.Value),
    "Publication": (rkv.Publication, pkv.Publication),
    "KeyDumpParams": (rkv.KeyDumpParams, pkv.KeyDumpParams),
    "PerfEvents": (rperf.PerfEvents, pperf.PerfEvents),
    "AdjacencyDatabase": (rtopo.AdjacencyDatabase, ptopo.AdjacencyDatabase),
    "PrefixDatabase": (rtopo.PrefixDatabase, ptopo.PrefixDatabase),
    "RouteDatabase": (rroutes.RouteDatabase, proutes.RouteDatabase),
    "RouteUpdate": (rroutes.RouteUpdate, proutes.RouteUpdate),
}


def twin(obj, name):
    """(JAX object, port object), both decoded from `obj`'s canonical
    JSON bytes."""
    rcls, pcls = PAIRS[name]
    blob = rs.to_wire(obj)
    return rs.from_wire(blob, rcls), ps.from_wire(blob, pcls)


def same_bytes(obj, name):
    r, p = twin(obj, name)
    rb, pb = rs.to_wire_bin(r), ps.to_wire_bin(p)
    assert rb == pb
    rcls, pcls = PAIRS[name]
    # each package reads the other's frame back to an equal object
    assert ps.to_wire(ps.from_wire_bin(rb, pcls)) == ps.to_wire(p)
    assert rs.to_wire(rs.from_wire_bin(pb, rcls)) == rs.to_wire(r)
    assert ps.to_wire_bin(ps.from_wire_bin(rb, pcls)) == rb
    return rb


def rand_value(rng, with_hash=True):
    payload = (None if rng.random() < 0.2
               else rng.bytes(int(rng.integers(0, 40))))
    v = rkv.Value(
        version=int(rng.integers(1, 1 << 40)),
        originator_id=f"node-{int(rng.integers(0, 1000))}",
        value=payload,
        ttl=int(rng.choice([rkv.TTL_INFINITY, rng.integers(1, 1 << 31)])),
        ttl_version=int(rng.integers(0, 50)),
    )
    return v.with_hash() if with_hash else v


def rand_perf(rng, span: bool):
    pe = rperf.PerfEvents()
    for i in range(int(rng.integers(1, 6))):
        pe.add_perf_event(rperf.ALL_MARKERS[i], node=f"n{i}",
                          ts_ns=int(rng.integers(0, 1 << 62)))
    if span:
        pe.begin_flood_trace("n0", trace_id=int(rng.integers(1, 1 << 62)),
                             ts_ns=int(rng.integers(1, 1 << 60)))
        pe.stamp_hop_rx("n1", ts_ns=int(rng.integers(1, 1 << 60)))
    return pe


@pytest.mark.parametrize("trial", range(40))
def test_value_bytes_equal(trial):
    rng = np.random.default_rng(SEED + trial)
    same_bytes(rand_value(rng, with_hash=bool(trial % 2)), "Value")


@pytest.mark.parametrize("perf_kind", ["none", "markers", "span"])
@pytest.mark.parametrize("trial", range(8))
def test_publication_bytes_equal(trial, perf_kind):
    rng = np.random.default_rng(SEED + 100 + trial)
    pub = rkv.Publication(
        area=str(int(rng.integers(0, 3))),
        key_vals={f"adj:node-{i}": rand_value(rng)
                  for i in range(int(rng.integers(0, 12)))},
        expired_keys=[f"prefix:n:{i}" for i in range(int(rng.integers(0, 4)))],
        node_ids=[f"node-{i}" for i in range(int(rng.integers(0, 4)))],
        to_be_updated_keys=(None if trial % 2 else ["a", "b"]),
        perf_events=(None if perf_kind == "none"
                     else rand_perf(rng, perf_kind == "span")),
    )
    same_bytes(pub, "Publication")


def test_key_dump_params_bytes_equal():
    same_bytes(rkv.KeyDumpParams(prefix="adj:", originator_ids=["a"],
                                 keys=["k1", "k2"], ignore_ttl=False),
               "KeyDumpParams")


def _fabric(seed):
    """A small fat-tree with seeded metrics and prefix mix."""
    rng = np.random.default_rng(seed)
    adj, pfx = topogen.fat_tree(4, metric=10)
    adj = [dataclasses.replace(db, adjacencies=tuple(
        dataclasses.replace(a, metric=int(rng.integers(1, 64)))
        for a in db.adjacencies)) for db in adj]
    return adj, pfx


@pytest.mark.parametrize("seed", range(3))
def test_topology_dbs_bytes_equal(seed):
    adj, pfx = _fabric(seed)
    for db in adj:
        same_bytes(db, "AdjacencyDatabase")
    for db in pfx:
        same_bytes(db, "PrefixDatabase")


def _rib(seed):
    adj, pfx = _fabric(seed)
    ls, ps_ = LinkState(), PrefixState()
    for db in adj:
        ls.update_adjacency_db(db)
    for db in pfx:
        ps_.update_prefix_db(db)
    return compute_routes(ls, ps_, adj[0].this_node_name)


@pytest.mark.parametrize("seed", range(3))
def test_route_database_and_update_bytes_equal(seed):
    old, new = _rib(seed), _rib(seed + 10)
    assert old.unicast_routes and old.mpls_routes
    same_bytes(old, "RouteDatabase")
    upd = rroutes.diff_route_dbs(old, new)
    assert not upd.empty()
    upd.perf_events = [rand_perf(np.random.default_rng(seed), False)]
    same_bytes(upd, "RouteUpdate")


def rpc_trees(rng):
    blob = rs.to_wire_bin(rkv.Publication(key_vals={"k": rand_value(rng)}))
    return [
        {"method": "kv.flood", "params": {"pub_bin": blob}},
        {"id": int(rng.integers(1, 1 << 30)), "result": {
            "area": "0", "store_hash": int(rng.integers(0, 1 << 63)),
            "noop": True, "key_vals": {}, "to_be_updated_keys": None}},
        {"id": 7, "error": "ValueError: bad digest"},
        {"id": 3, "item": [1, -1, 0, 2**63 - 1, -(2**63), 2**76 - 1,
                           1.5, -0.0, float(rng.random()), "é", b"\x00\xff",
                           [], {}, [None, True, False]]},
        {"method": "kv.fullSync", "params": {
            "area": "0", "sender": "node-1", "store_hash": None,
            "digest": {f"k{i}": [int(rng.integers(1, 9)), "node-1",
                                 int(rng.integers(0, 1 << 63))]
                       for i in range(5)}}},
    ]


@pytest.mark.parametrize("trial", range(4))
def test_rpc_tree_bytes_equal(trial):
    for tree in rpc_trees(np.random.default_rng(SEED + 300 + trial)):
        rb, pb = rs.to_wire_bin(tree), ps.to_wire_bin(tree)
        assert rb == pb
        assert ps.from_wire_bin(rb) == rs.from_wire_bin(pb) == tree


def test_int_range_and_oversized_ints():
    for n in (0, 1, -1, 63, 64, -64, -65, 2**63 - 1, -(2**63), 2**76 - 1,
              -(2**76) + 1):
        assert rs.to_wire_bin(n) == ps.to_wire_bin(n)
        assert ps.from_wire_bin(rs.to_wire_bin(n)) == n
    for n in (2**77, -(2**77) - 1):
        with pytest.raises(TypeError):
            rs.to_wire_bin(n)
        with pytest.raises(TypeError):
            ps.to_wire_bin(n)


def outcome(mod, blob, cls):
    """("error",) on WireDecodeError, else ("ok", canonical JSON of the
    decoded object, or the decoded tree)."""
    try:
        obj = mod.from_wire_bin(blob, cls)
    except mod.WireDecodeError:
        return ("error",)
    if cls is None:
        return ("ok", obj)
    return ("ok", mod.to_wire(obj))


def valid_frames(rng):
    pub = rkv.Publication(area="0", key_vals={
        "adj:n": rand_value(rng), "prefix:n:0:[10.0.0.0/24]": rand_value(rng)},
        node_ids=["n1", "n2"], perf_events=rand_perf(rng, False))
    adj, _ = _fabric(1)
    return {
        "Value": rs.to_wire_bin(rand_value(rng)),
        "Publication": rs.to_wire_bin(pub),
        "AdjacencyDatabase": rs.to_wire_bin(adj[0]),
    }


def mutations(rng, wire: bytes, n: int = 150) -> list[bytes]:
    out = []
    for _ in range(n):
        b = bytearray(wire)
        kind = int(rng.integers(0, 3))
        if kind == 0 and b:  # flip a byte
            b[int(rng.integers(0, len(b)))] = int(rng.integers(0, 256))
        elif kind == 1:  # truncate
            b = b[: int(rng.integers(0, len(b)))]
        else:  # duplicate a slice
            i = int(rng.integers(0, max(1, len(b))))
            b = b[:i] + b[i:i + 20] + b[i:]
        out.append(bytes(b))
    return out


@pytest.mark.parametrize("name", ["Value", "Publication", "AdjacencyDatabase",
                                  None])
def test_random_and_mutated_frames_same_answer(name):
    rng = np.random.default_rng(SEED + 500)
    frames = valid_frames(rng)
    corpus = [rng.bytes(int(rng.integers(0, 120))) for _ in range(150)]
    corpus += [bytes([rs.WIRE_BIN_MAGIC, rs.WIRE_BIN_VERSION]) + b
               for b in corpus[:80]]
    for wire in frames.values() if name is None else [frames[name]]:
        corpus += mutations(rng, wire)
    pairs = (None, None) if name is None else PAIRS[name]
    answers = {"error": 0, "ok": 0}
    for blob in corpus:
        r, p = outcome(rs, blob, pairs[0]), outcome(ps, blob, pairs[1])
        assert r == p, blob
        answers[r[0]] += 1
    assert answers["error"] and answers["ok"], answers


@pytest.mark.parametrize("case", ["short", "empty", "bad magic",
                                  "future version", "truncated",
                                  "trailing", "endless varint",
                                  "oversized count", "oversized str",
                                  "unknown tag"])
def test_malformed_frames_raise_in_both(case):
    valid = rs.to_wire_bin(rkv.Publication(area="0", key_vals={
        "k": rkv.Value(version=3, originator_id="ab", value=b"\x00\xffp")}))
    m = rs.WIRE_BIN_MAGIC
    blob = {
        "short": valid[:1],
        "empty": b"",
        "bad magic": bytes([0xB2]) + valid[1:],
        "future version": bytes([m, 0x7F]) + valid[2:],
        "truncated": valid[:-3],
        "trailing": valid + b"\x00",
        "endless varint": bytes([m, 0x01, 0x03]) + b"\xff" * 16,
        "oversized count": (bytes([m, 0x01, 0x07])
                            + b"\x80\x80\x80\x80\x80\x40"),
        "oversized str": bytes([m, 0x01, 0x05, 0xFF, 0x7F]) + b"ab",
        "unknown tag": bytes([m, 0x01, 0x7E]),
    }[case]
    for mod, cls in ((rs, rkv.Publication), (ps, pkv.Publication),
                     (rs, None), (ps, None)):
        with pytest.raises(mod.WireDecodeError):
            mod.from_wire_bin(blob, cls)
    assert issubclass(ps.WireDecodeError, ValueError)


def test_from_wire_auto_reads_both_codecs():
    rng = np.random.default_rng(SEED + 600)
    pub = rkv.Publication(area="A", key_vals={"adj:x": rand_value(rng)},
                          expired_keys=["gone"], node_ids=["x", "y"])
    r, p = twin(pub, "Publication")
    for blob in (rs.to_wire(r), rs.to_wire_bin(r)):
        got = ps.from_wire_auto(blob, pkv.Publication)
        assert got == p and ps.to_wire(got) == rs.to_wire(r)


def test_wire_schemas_agree_for_every_shared_type():
    ref, port = rs.registered_wire_types(), ps.registered_wire_types()
    shared = sorted(ref.keys() & port.keys())
    # the port registers what it has; the JAX package's other wire types
    # (Spark, the journal) come with their modules
    assert set(port) <= set(ref)
    assert {"Value", "Publication", "KeyDumpParams", "PerfEvent",
            "PerfEvents", "Adjacency", "AdjacencyDatabase", "PrefixEntry",
            "PrefixDatabase", "RibEntry", "RouteDatabase", "RouteUpdate",
            "NextHop", "IpPrefix", "MplsAction", "UnicastRoute", "MplsRoute",
            "NeighborInfo", "NeighborEvent", "InterfaceInfo",
            "InterfaceEvent", "PrefixRange"} <= set(shared)
    for name in shared:
        a, b = rs.wire_schema_of(ref[name]), ps.wire_schema_of(port[name])
        assert a.pop("module").startswith("openr_tpu.")
        assert b.pop("module").startswith("openr_tpu_torch.")
        if name == "PerfEvents":
            # the JAX package's unpacked span: transient, never on the wire
            assert a.pop("transient") == ["_span"] and b.pop("transient") == []
        assert a == b, name


def test_span_bin_repair():
    """Before the repair the port's PerfEvents had no `span_bin`: the
    binary codec encodes fields by position, so a Publication with perf
    events encoded to other bytes than the JAX package's. With it, the
    bytes are equal, and a span a JAX node stamped rides through the
    port unchanged."""
    rng = np.random.default_rng(SEED + 700)
    # the pre-repair shapes: PerfEvents with `events` alone, and a
    # Publication whose perf_events field holds one
    old_perf = dataclasses.make_dataclass(
        "PerfEvents", [("events", list[pperf.PerfEvent],
                        dataclasses.field(default_factory=list))])
    old_pub = dataclasses.make_dataclass("Publication", [
        (f.name, old_perf | None if f.name == "perf_events"
         else typing.get_type_hints(pkv.Publication)[f.name],
         dataclasses.field(default=None)) for f in
        dataclasses.fields(pkv.Publication) if not f.name.startswith("_")])
    for span in (False, True):
        pe = rand_perf(rng, span)
        pub = rkv.Publication(key_vals={"k": rand_value(rng)},
                              perf_events=pe)
        rb = rs.to_wire_bin(pub)
        _r, p = twin(pub, "Publication")
        assert ps.to_wire_bin(p) == rb
        assert (p.perf_events.span_bin is not None) == span
        old = old_pub(**{f.name: getattr(p, f.name)
                         for f in dataclasses.fields(old_pub)})
        old.perf_events = old_perf(events=list(p.perf_events.events))
        assert ps.to_wire_bin(old) != rb
        # the JAX frame through the port: decode, re-encode, same bytes
        back = ps.from_wire_bin(rb, pkv.Publication)
        assert back.perf_events.span_bin == pe.span_bin
        assert ps.to_wire_bin(back) == rb
        # and the port's copy and merge keep the span bytes
        assert back.perf_events.copy().span_bin == pe.span_bin
        merged = pperf.PerfEvents().merge(back.perf_events)
        assert merged.span_bin == pe.span_bin


def test_merge_matches_reference():
    """`PerfEvents.merge` (coalesced floods) keeps the same markers as
    the JAX package's, capped traces included."""
    rng = np.random.default_rng(SEED + 800)
    for n_a, n_b in ((3, 4), (40, 40), (64, 64)):
        ra, rb = rperf.PerfEvents(), rperf.PerfEvents()
        for pe, n in ((ra, n_a), (rb, n_b)):
            for _ in range(n):
                pe.events.append(rperf.PerfEvent(
                    event=str(rng.choice(rperf.ALL_MARKERS)),
                    ts_ns=int(rng.integers(0, 1 << 40)),
                    node=f"n{int(rng.integers(0, 12))}"))
        pa, pb = (pperf.PerfEvents(events=[pperf.PerfEvent(
            e.event, e.ts_ns, e.node) for e in pe.events]) for pe in (ra, rb))
        want = [(e.event, e.ts_ns, e.node) for e in ra.merge(rb).events]
        got = [(e.event, e.ts_ns, e.node) for e in pa.merge(pb).events]
        assert got == want

"""The port's KvStore (`openr_tpu_torch.kvstore`) and DUAL
(`openr_tpu_torch.dual`) held against the JAX package's on the CPU.

* Every case of `tests/test_kvstore.py` and `tests/test_dual.py` runs on
  the port: the JAX test module's source, with each `openr_tpu` import
  pointed at `openr_tpu_torch`, is executed as a module of its own, and
  each of its test functions is a case here (line flooding, full sync and
  its legacy fallback, TTL expiry, client defence and refresh, the
  16-store grid, rate-limit coalescing, backpressure resync, the DUAL
  machines and the flood-optimised stores).
* `merge_key_values` and the store's digests agree with the JAX
  package's on seeded Value sets.
* A mixed cluster: a JAX store and a port store flood and full-sync each
  other through one in-process registry, each encoding with its own
  codec.
"""

import asyncio
import pathlib
import re
import types

import numpy as np
import pytest

import openr_tpu.kvstore as rkvs
import openr_tpu.kvstore.kvstore as rkvstore
import openr_tpu.types.kvstore as rkv
from openr_tpu.config import Config as RefConfig
from openr_tpu.messaging import ReplicateQueue as RefQueue
from openr_tpu.monitor import Counters as RefCounters
from openr_tpu_torch import kvstore as pkvs
from openr_tpu_torch.config import Config
from openr_tpu_torch.kvstore import kvstore as pkvstore
from openr_tpu_torch.messaging import ReplicateQueue
from openr_tpu_torch.monitor import Counters
from openr_tpu_torch.types import kvstore as pkv

TESTS = pathlib.Path(__file__).resolve().parent
SEED = 20260520


def on_port(name: str) -> types.ModuleType:
    """`tests/<name>.py` with every import of the JAX package pointed at
    the port, executed as a module of its own."""
    src = (TESTS / f"{name}.py").read_text()
    port_src = re.sub(r"\bopenr_tpu\b", "openr_tpu_torch", src)
    assert not re.search(r"\bopenr_tpu\b", port_src)
    mod = types.ModuleType(f"{name}_on_port")
    mod.__file__ = str(TESTS / f"{name}.py")
    exec(compile(port_src, f"{name}.py on the port", "exec"), mod.__dict__)
    return mod


KVSTORE_CASES = on_port("test_kvstore")
DUAL_CASES = on_port("test_dual")


def cases(mod):
    return sorted(n for n, f in vars(mod).items()
                  if n.startswith("test_") and callable(f))


@pytest.mark.parametrize("case", cases(KVSTORE_CASES))
def test_kvstore_case_on_port(case):
    getattr(KVSTORE_CASES, case)()


@pytest.mark.parametrize("case", cases(DUAL_CASES))
def test_dual_case_on_port(case):
    getattr(DUAL_CASES, case)()


def test_mirrored_modules_use_the_port():
    for mod in (KVSTORE_CASES, DUAL_CASES):
        for name in ("KvStore", "InProcKvTransport", "Config", "Counters",
                     "ReplicateQueue", "Value", "DualNode"):
            obj = vars(mod).get(name)
            if obj is not None:
                assert obj.__module__.startswith("openr_tpu_torch."), name
    assert len(cases(KVSTORE_CASES)) >= 13 and len(cases(DUAL_CASES)) >= 9


# ---- merge and digests against the JAX package ----------------------------


def value_pair(rng, versions=4, origins=3, payloads=4):
    """A seeded Value in both packages (one generation of a small space,
    so conflicts, ties and ttl refreshes all occur)."""
    payload = (None if rng.random() < 0.15
               else b"p%d" % int(rng.integers(0, payloads)))
    kw = dict(version=int(rng.integers(1, versions + 1)),
              originator_id=f"o{int(rng.integers(0, origins))}",
              value=payload,
              ttl=int(rng.choice([rkv.TTL_INFINITY, 1000, 60_000])),
              ttl_version=int(rng.integers(0, 3)))
    return rkv.Value(**kw), pkv.Value(**kw)


def as_rows(store):
    return {k: (v.version, v.originator_id, v.value, v.ttl, v.ttl_version,
                v.hash) for k, v in store.items()}


@pytest.mark.parametrize("trial", range(30))
def test_merge_key_values_agrees(trial):
    rng = np.random.default_rng(SEED + trial)
    keys = [f"k{i}" for i in range(12)]
    r_store, p_store = {}, {}
    for _batch in range(6):
        r_in, p_in = {}, {}
        for k in rng.choice(keys, size=int(rng.integers(1, 10)),
                            replace=False):
            r_in[str(k)], p_in[str(k)] = value_pair(rng)
        r_acc, r_stale = rkvs.merge_key_values(r_store, r_in)
        p_acc, p_stale = pkvs.merge_key_values(p_store, p_in)
        assert as_rows(p_acc) == as_rows(r_acc)
        assert p_stale == r_stale
        assert as_rows(p_store) == as_rows(r_store)


@pytest.mark.parametrize("trial", range(5))
def test_store_digests_agree(trial):
    rng = np.random.default_rng(SEED + 100 + trial)
    r_db, p_db = rkvs.KvStoreDb("0"), pkvs.KvStoreDb("0")
    r_in, p_in = {}, {}
    for i in range(40):
        r_in[f"k{i}"], p_in[f"k{i}"] = value_pair(rng, versions=9)
        if r_in[f"k{i}"].value is None:
            r_in[f"k{i}"].value = p_in[f"k{i}"].value = b"x"
    r_db.merge(r_in)
    p_db.merge(p_in)
    assert p_db.store_hash() == r_db.store_hash() != 0
    assert p_db.digest_triples() == r_db.digest_triples()
    assert as_rows(p_db.digest()) == as_rows(r_db.digest())
    params = (rkv.KeyDumpParams(prefix="k1"), pkv.KeyDumpParams(prefix="k1"))
    assert (sorted(p_db.dump(params[1])) == sorted(r_db.dump(params[0]))
            == sorted(k for k in p_in if k.startswith("k1")))


@pytest.mark.parametrize("trial", range(10))
def test_dump_filters_agree(trial):
    """`KvStoreDb.dump` filtered by keys, originators and a prefix (the
    3-way full sync's send-back names the keys) answers as the JAX
    package's: the port's filters are sets, the reference's lists."""
    rng = np.random.default_rng(SEED + 150 + trial)
    r_db, p_db = rkvs.KvStoreDb("0"), pkvs.KvStoreDb("0")
    r_in, p_in = {}, {}
    for i in range(60):
        r_in[f"k{i}"], p_in[f"k{i}"] = value_pair(rng, versions=9)
    r_db.merge(r_in)
    p_db.merge(p_in)
    for _ in range(8):
        keys = [f"k{int(i)}" for i in rng.integers(0, 80, 30)]
        origins = [f"o{int(i)}" for i in rng.integers(0, 3, 2)]
        prefix = str(rng.choice(["", "k1", "k2"]))
        kw = [dict(keys=keys), dict(originator_ids=origins),
              dict(keys=keys, originator_ids=origins, prefix=prefix)][
                  int(rng.integers(0, 3))]
        got = p_db.dump(pkv.KeyDumpParams(**kw))
        want = r_db.dump(rkv.KeyDumpParams(**kw))
        assert sorted(got) == sorted(want)
        assert {k: (v.version, v.originator_id, v.value, v.ttl_version,
                    v.hash) for k, v in got.items()} == \
            {k: (v.version, v.originator_id, v.value, v.ttl_version, v.hash)
             for k, v in want.items()}


def test_trace_sampling_refused():
    cfg = Config.default("a")
    cfg.node.kvstore.trace_sample_every = 4
    with pytest.raises(ValueError, match="spans"):
        pkvstore.KvStore(cfg, pkvs.InProcKvTransport(),
                         ReplicateQueue(name="pubs"))


def test_client_persist_refused():
    store = pkvstore.KvStore(Config.default("a"), pkvs.InProcKvTransport(),
                             ReplicateQueue(name="pubs"))
    with pytest.raises(ValueError, match="journal"):
        pkvs.KvStoreClient(store, "a", None, persist=object())


# ---- a mixed cluster: JAX and port stores peered --------------------------


@pytest.mark.parametrize("codec", ["bin", "json"])
def test_jax_and_port_stores_flood_and_sync_each_other(codec):
    """One registry, two transports: the JAX store's sessions encode with
    the JAX codec, the port store's with the port's, and each decodes the
    other's frames. Pre-existing keys converge by full sync both ways,
    then floods cross in both directions."""

    async def main():
        rt = rkvs.InProcKvTransport(codec=codec)
        pt = pkvs.InProcKvTransport(codec=codec)
        pt._stores = rt._stores  # one registry of both packages' stores
        rq, pq = RefQueue(name="r"), ReplicateQueue(name="p")
        rc, pc = RefCounters(), Counters()
        r_reader = rq.get_reader()
        r = rkvstore.KvStore(RefConfig.default("jax"), rt, rq, counters=rc)
        p = pkvstore.KvStore(Config.default("port"), pt, pq, counters=pc)
        rt.register("jax", r)
        rt.register("port", p)
        await r.start()
        await p.start()
        rng = np.random.default_rng(SEED + 200)
        for i in range(20):
            for store, mod, tag in ((r, rkv, "jax"), (p, pkv, "port")):
                store.set_key("0", f"from-{tag}-{i}", mod.Value(
                    version=int(rng.integers(1, 9)), originator_id=tag,
                    value=b"%s-%d" % (tag.encode(), i)).with_hash())
        r.add_peer_sync(rkvstore.PeerSpec(node_name="port"))
        p.add_peer_sync(pkvstore.PeerSpec(node_name="jax"))

        async def settle(cond, timeout=5.0):
            t0 = asyncio.get_running_loop().time()
            while not cond():
                assert asyncio.get_running_loop().time() - t0 < timeout
                await asyncio.sleep(0.01)

        await settle(lambda: len(p.dump("0")) == len(r.dump("0")) == 40)
        assert p.initial_sync_done.is_set() and r.initial_sync_done.is_set()
        assert as_rows(p.dbs["0"].kv) == as_rows(r.dbs["0"].kv)
        assert p.dbs["0"].store_hash() == r.dbs["0"].store_hash()
        # floods both ways, with a trace on the port's write
        from openr_tpu_torch.monitor import perf

        p.set_key("0", "later-port", pkv.Value(
            version=1, originator_id="port", value=b"P").with_hash(),
            perf_events=perf.PerfEvents.start(perf.NEIGHBOR_EVENT, "port"))
        r.set_key("0", "later-jax", rkv.Value(
            version=1, originator_id="jax", value=b"J").with_hash())
        await settle(lambda: r.get_key("0", "later-port") is not None
                     and p.get_key("0", "later-jax") is not None)
        assert r.get_key("0", "later-port").value == b"P"
        assert p.get_key("0", "later-jax").value == b"J"
        assert pc.get("kvstore.floods_sent") >= 1
        assert pc.get("kvstore.floods_received") >= 1
        # the JAX store published the port's trace with both stamps
        traced = [pub.perf_events for pub in iter(r_reader.try_get, None)
                  if "later-port" in pub.key_vals]
        assert [(e.event, e.node) for e in traced[0].events] == [
            (perf.NEIGHBOR_EVENT, "port"), (perf.KVSTORE_FLOODED, "port"),
            (perf.KVSTORE_FLOODED, "jax")]
        await r.stop()
        await p.stop()

    asyncio.run(main())


# ---- the config and backoff KvStore stands on ------------------------------


def test_kvstore_config_fields_and_defaults_equal():
    """Each field the port keeps has the reference's name, type and
    default, in the reference's order; the flood-span seed waits for the
    span stamping that reads it."""
    import dataclasses

    from openr_tpu.config.config import KvstoreConfig as RefKvstoreConfig
    from openr_tpu_torch.config import KvstoreConfig

    ref = {f.name: (str(f.type), f.default) for f in
           dataclasses.fields(RefKvstoreConfig)}
    got = [(f.name, (str(f.type), f.default)) for f in
           dataclasses.fields(KvstoreConfig)]
    assert got == [(n, ref.get(n)) for n, _ in got]
    assert [n for n, _ in got] == [n for n in ref if n != "trace_seed"]
    assert Config.default("a").node.kvstore == KvstoreConfig()
    with pytest.raises(ValueError):
        cfg = Config.default("a")
        cfg.node.kvstore.key_ttl_ms = 0
        Config(cfg.node)


@pytest.mark.parametrize("jitter", [False, True])
def test_backoff_agrees(jitter):
    from openr_tpu.common import backoff as rb
    from openr_tpu_torch.common import backoff as pb

    r = rb.ExponentialBackoff(100, 30_000, jitter=jitter,
                              rng=rb.stable_rng("a", "b", "kv-sync"))
    p = pb.ExponentialBackoff(100, 30_000, jitter=jitter,
                              rng=pb.stable_rng("a", "b", "kv-sync"))
    for step in range(12):
        if step == 9:
            r.report_success()
            p.report_success()
        else:
            r.report_error()
            p.report_error()
        assert (p.current_ms, p.delay_ms, p.has_error) == (
            r.current_ms, r.delay_ms, r.has_error)

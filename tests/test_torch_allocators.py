"""The port's allocators (`openr_tpu_torch.allocators`) held against the
JAX package's on the CPU.

* Every case of `tests/test_allocators.py` runs on the port: the JAX test
  module's source, with each `openr_tpu` import pointed at
  `openr_tpu_torch`, executed as a module of its own.
* `carve` and `RangeAllocator`'s candidate order agree with the JAX
  package's on seeded seeds, lengths, node names and ranges.
* A mixed election: JAX and port RangeAllocators on a full mesh of JAX
  and port KvStores (one in-process registry) end with distinct values,
  and each node's first claim is the JAX package's first candidate.
"""

import asyncio
import pathlib
import re
import types

import numpy as np
import pytest

import openr_tpu.allocators.prefix_allocator as rpa
import openr_tpu.allocators.range_allocator as rra
import openr_tpu.kvstore as rkvs
from openr_tpu.config import Config as RefConfig
from openr_tpu.kvstore.kvstore import PeerSpec as RefPeerSpec
from openr_tpu.messaging import ReplicateQueue as RefQueue
from openr_tpu.types.network import IpPrefix as RefIpPrefix
from openr_tpu_torch import kvstore as pkvs
from openr_tpu_torch.allocators import prefix_allocator as ppa
from openr_tpu_torch.allocators import range_allocator as pra
from openr_tpu_torch.config import Config, NodeConfig, PrefixAllocationConfig
from openr_tpu_torch.kvstore.kvstore import PeerSpec
from openr_tpu_torch.messaging import ReplicateQueue
from openr_tpu_torch.types.network import IpPrefix

TESTS = pathlib.Path(__file__).resolve().parent
SEED = 20260603


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


def cases(mod):
    return sorted(n for n, f in vars(mod).items()
                  if n.startswith("test_") and callable(f))


ALLOC_CASES = on_port("test_allocators")


@pytest.mark.parametrize("case", cases(ALLOC_CASES))
def test_allocators_case_on_port(case):
    getattr(ALLOC_CASES, case)()


def test_mirrored_modules_use_the_port():
    for name in ("PrefixAllocator", "RangeAllocator", "carve", "KvStore",
                 "Config", "IpPrefix", "ReplicateQueue"):
        obj = vars(ALLOC_CASES)[name]
        assert obj.__module__.startswith("openr_tpu_torch."), name
    assert len(cases(ALLOC_CASES)) >= 5


def test_store_raises():
    cfg = Config(NodeConfig(node_name="a", prefix_allocation=(
        PrefixAllocationConfig(seed_prefix="10.0.0.0/8",
                               alloc_prefix_len=24))))
    with pytest.raises(NotImplementedError, match="store"):
        ppa.PrefixAllocator(cfg, None, None, None, store=object())


@pytest.mark.parametrize("trial", range(40))
def test_carve_agrees(trial):
    rng = np.random.default_rng(SEED + trial)
    if trial % 2:
        seed_len = int(rng.integers(8, 24))
        addr = ".".join(str(int(x)) for x in rng.integers(0, 256, 4))
        seed = f"{addr}/{seed_len}"
        top = 32
    else:
        seed_len = int(rng.integers(16, 64))
        words = ":".join(f"{int(x):x}" for x in rng.integers(0, 1 << 16, 8))
        seed = f"{words}/{seed_len}"
        top = 128
    alloc = int(rng.integers(seed_len + 1, min(seed_len + 20, top) + 1))
    r_seed, p_seed = RefIpPrefix.make(seed), IpPrefix.make(seed)
    assert p_seed.prefix == r_seed.prefix
    for index in rng.integers(0, 1 << (alloc - seed_len), 8):
        got = ppa.carve(p_seed, alloc, int(index))
        want = rpa.carve(r_seed, alloc, int(index))
        assert got.prefix == want.prefix


class _Store:
    """The attributes RangeAllocator reads at construction."""

    def __init__(self):
        self.dbs = {"0": None}
        self.config = types.SimpleNamespace(node=types.SimpleNamespace(
            kvstore=types.SimpleNamespace(key_ttl_ms=1000)))


@pytest.mark.parametrize("trial", range(20))
def test_candidate_order_agrees(trial):
    rng = np.random.default_rng(SEED + 100 + trial)
    start = int(rng.integers(0, 1000))
    end = start + int(rng.integers(0, 300))
    for _ in range(5):
        name = f"node-{int(rng.integers(0, 100_000))}"
        r = rra.RangeAllocator(name, _Store(), None, "k:", start, end)
        p = pra.RangeAllocator(name, _Store(), None, "k:", start, end)
        n = end - start + 1
        got = [p._candidate(i) for i in range(n)]
        assert got == [r._candidate(i) for i in range(n)]
        assert sorted(got) == list(range(start, end + 1))


def test_mixed_election_ends_distinct():
    """Three JAX and three port stores in one registry, each with its
    package's RangeAllocator, over 8 values: distinct values, and a
    first claim that is the node's first candidate in both packages."""

    async def body():
        t = rkvs.InProcKvTransport()
        pt = pkvs.InProcKvTransport()
        pt._stores = t._stores  # one registry, each store its own codec
        names = [f"node-{i}" for i in range(6)]
        stores, allocs, firsts = {}, {}, {}
        for i, n in enumerate(names):
            ref = i % 2 == 0
            pubs = (RefQueue if ref else ReplicateQueue)(name=f"{n}.pubs")
            kvs, cfg = (rkvs, RefConfig) if ref else (pkvs, Config)
            stores[n] = kvs.KvStore(cfg.default(n), t if ref else pt, pubs)
            t.register(n, stores[n])
            await stores[n].start()
            ra = (rra if ref else pra).RangeAllocator(
                n, stores[n], pubs.get_reader(), key_prefix="alloc:",
                start=0, end=7)
            allocs[n] = ra
            firsts[n] = rra.RangeAllocator(
                n, _Store(), None, "alloc:", 0, 7)._candidate(0)
        for a in names:
            for b in names:
                if a != b:
                    spec = (RefPeerSpec if a in names[::2] else PeerSpec)
                    stores[a].add_peer_sync(spec(node_name=b))
        claims = {}
        for n in names:
            await allocs[n].start()
            claims[n] = allocs[n].my_value
        t0 = asyncio.get_event_loop().time()
        while True:
            vals = [a.my_value for a in allocs.values()]
            if None not in vals and len(set(vals)) == len(vals):
                break
            assert asyncio.get_event_loop().time() - t0 < 8.0, vals
            await asyncio.sleep(0.01)
        for a in allocs.values():
            await a.stop()
        for s in stores.values():
            await s.stop()
        return claims, firsts

    claims, firsts = asyncio.run(body())
    # the first node claims its first candidate; a later one its first
    # that the stores it has heard from do not hold
    assert claims["node-0"] == firsts["node-0"]
    assert any(claims[n] == firsts[n] for n in claims if n != "node-0")

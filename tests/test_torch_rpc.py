"""The port's RPC layer (`openr_tpu_torch.rpc`) and KvStore over TCP
(`kvstore.TcpKvTransport`, `KvStore.register_rpc`) held against the JAX
package's on the CPU.

* Every case of `tests/test_rpc.py` runs on the port (the JAX test
  module's source with each `openr_tpu` import pointed at
  `openr_tpu_torch`): call, notify and stream; two stores peering over
  TCP; TLS round trips and rejects, with a CA and certificates made by
  `openssl` as the JAX file's `tls_pki` fixture makes them.
* `bin_frame` and `pub_flood_frame` give the JAX package's bytes for
  seeded envelopes and publications, and each side's reader takes the
  other's frames.
* Mixed stores over TCP: a port KvStore full-syncs from a JAX KvStore's
  `RpcServer` and floods into it, and the other way round, in either
  framing (the server declining binary keeps a connection on JSON).
"""

import asyncio
import pathlib
import re
import subprocess
import types

import numpy as np
import pytest

import openr_tpu.kvstore as rkvs
import openr_tpu.kvstore.kvstore as rkvstore
import openr_tpu.kvstore.transport as rtr
import openr_tpu.rpc as rrpc
import openr_tpu.types.kvstore as rkv
from openr_tpu.config import Config as RefConfig
from openr_tpu.messaging import ReplicateQueue as RefQueue
from openr_tpu_torch import kvstore as pkvs
from openr_tpu_torch import rpc as prpc
from openr_tpu_torch.config import Config
from openr_tpu_torch.kvstore import kvstore as pkvstore
from openr_tpu_torch.kvstore import transport as ptr
from openr_tpu_torch.messaging import ReplicateQueue
from openr_tpu_torch.monitor import perf as pperf
from openr_tpu_torch.types import kvstore as pkv

TESTS = pathlib.Path(__file__).resolve().parent
SEED = 20261019


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


RPC_CASES = on_port("test_rpc")
PLAIN = sorted(n for n, f in vars(RPC_CASES).items()
               if n.startswith("test_") and callable(f)
               and "tls" not in n)
TLS = sorted(n for n, f in vars(RPC_CASES).items()
             if n.startswith("test_tls") and callable(f))


@pytest.fixture(scope="module")
def tls_pki(tmp_path_factory):
    """A self-signed CA and a server and a client certificate signed by
    it (the JAX file's fixture, made by `openssl`)."""
    d = tmp_path_factory.mktemp("pki")

    def sh(*args):
        subprocess.run(args, check=True, capture_output=True, timeout=60)

    ca_key, ca_crt = d / "ca.key", d / "ca.crt"
    sh("openssl", "req", "-x509", "-newkey", "rsa:2048", "-nodes",
       "-keyout", str(ca_key), "-out", str(ca_crt),
       "-days", "1", "-subj", "/CN=openr-test-ca")
    for name in ("server", "client"):
        key, csr, crt = d / f"{name}.key", d / f"{name}.csr", d / f"{name}.crt"
        sh("openssl", "req", "-newkey", "rsa:2048", "-nodes",
           "-keyout", str(key), "-out", str(csr), "-subj", f"/CN={name}")
        sh("openssl", "x509", "-req", "-in", str(csr), "-CA", str(ca_crt),
           "-CAkey", str(ca_key), "-CAcreateserial", "-days", "1",
           "-out", str(crt))
    return d


@pytest.mark.parametrize("case", PLAIN)
def test_rpc_case_on_port(case):
    getattr(RPC_CASES, case)()


@pytest.mark.parametrize("case", TLS)
def test_tls_case_on_port(case, tls_pki):
    getattr(RPC_CASES, case)(tls_pki)


def test_mirrored_module_uses_the_port():
    for name in ("RpcClient", "RpcServer", "KvStore", "TcpKvTransport"):
        assert vars(RPC_CASES)[name].__module__.startswith(
            "openr_tpu_torch."), name
    assert len(PLAIN) >= 2 and len(TLS) >= 3


# ---- frames, byte for byte --------------------------------------------------


def draw_envelopes(rng) -> list:
    """Seeded request, response, notification and stream envelopes with
    nested trees and raw-bytes leaves."""
    out = []
    for i in range(16):
        params = {f"k{j}": (int(rng.integers(-1 << 40, 1 << 40)) if j % 3 == 0
                            else bytes(rng.integers(0, 256, int(
                                rng.integers(0, 300))).astype(np.uint8))
                            if j % 3 == 1 else
                            [float(rng.random()), None, True, "x" * j])
                  for j in range(int(rng.integers(0, 6)))}
        kind = i % 4
        if kind == 0:
            out.append({"id": i, "method": "kv.fullSync", "params": params})
        elif kind == 1:
            out.append({"id": i, "result": params})
        elif kind == 2:
            out.append({"method": "kv.flood", "params": params})
        else:
            out.append({"id": i, "item": params})
    return out


def draw_pub(kv, perf, rng) -> object:
    key_vals = {
        f"prefix:node-{i}:0:[10.{i}.0.0/16]": kv.Value(
            version=int(rng.integers(1, 1 << 40)), originator_id=f"node-{i}",
            value=bytes(rng.integers(0, 256, 64).astype(np.uint8)),
            ttl=int(rng.integers(1, 1 << 30)),
            ttl_version=int(rng.integers(0, 9))).with_hash()
        for i in range(int(rng.integers(1, 6)))}
    pe = perf.PerfEvents()
    for j in range(3):
        pe.add_perf_event(f"M{j}", node=f"node-{j}",
                          ts_ns=int(rng.integers(0, 1 << 60)))
    return kv.Publication(area="0", key_vals=key_vals,
                          expired_keys=["adj:gone"], node_ids=["a", "b"],
                          perf_events=pe)


@pytest.mark.parametrize("seed", range(3))
def test_frames_byte_equal(seed):
    import openr_tpu.monitor.perf as rperf

    rng = np.random.default_rng(SEED + seed)
    for env in draw_envelopes(rng):
        assert prpc.bin_frame(env) == rrpc.bin_frame(env)
    r_pub = draw_pub(rkv, rperf, np.random.default_rng(SEED + seed))
    p_pub = draw_pub(pkv, pperf, np.random.default_rng(SEED + seed))
    assert ptr.pub_flood_frame(p_pub) == rtr.pub_flood_frame(r_pub)
    # the frame is cached on the publication: a second fan-out encodes
    # nothing
    assert ptr.pub_flood_frame(p_pub) is ptr.pub_flood_frame(p_pub)

    async def read_back():
        """Each side's frame reader takes the other's frames: the binary
        frame's blob and a JSON line after it."""
        from openr_tpu.rpc.core import _read_frame as r_read
        from openr_tpu_torch.rpc.core import _read_frame as p_read

        import openr_tpu.types.serde as rs

        blob = rs.to_wire_bin({"method": "kv.flood", "params": {
            "pub_bin": rtr.pub_wire_bin(r_pub)}})
        for read, frame in ((p_read, rtr.pub_flood_frame(r_pub)),
                            (r_read, ptr.pub_flood_frame(p_pub))):
            sr = asyncio.StreamReader()
            sr.feed_data(frame + b'{"id":1,"result":2}\n')
            sr.feed_eof()
            assert await read(sr) == ("bin", blob)
            assert await read(sr) == ("json", b'{"id":1,"result":2}\n')

    asyncio.run(read_back())


# ---- a JAX store and a port store over TCP ----------------------------------


async def settle(cond, timeout=10.0):
    t0 = asyncio.get_event_loop().time()
    while not cond():
        if asyncio.get_event_loop().time() - t0 > timeout:
            return False
        await asyncio.sleep(0.01)
    return True


@pytest.mark.parametrize("binary", [True, False])
@pytest.mark.parametrize("listener", ["ref", "port"])
def test_mixed_stores_sync_and_flood_over_tcp(listener, binary):
    """The `listener` package's store serves on its RpcServer (which
    agrees to binary framing or declines it); the other's dials it with
    its TcpKvTransport, full-syncs the listener's keys, and both flood
    their later writes to each other over the one session each way."""

    async def main():
        ref = rkvs.KvStore(RefConfig.default("ref"), rkvs.TcpKvTransport(),
                           RefQueue(name="ref"))
        port = pkvs.KvStore(Config.default("port"), pkvs.TcpKvTransport(),
                            ReplicateQueue(name="port"))
        servers = {
            "ref": rrpc.RpcServer("ref.kv", binary=binary),
            "port": prpc.RpcServer("port.kv", binary=binary),
        }
        ref.register_rpc(servers["ref"])
        port.register_rpc(servers["port"])
        ports = {k: await s.start() for k, s in servers.items()}
        await ref.start()
        await port.start()
        try:
            for i in range(20):
                ref.set_key("0", f"ref-{i}", rkv.Value(
                    1, "ref", f"r{i}".encode()).with_hash())
                port.set_key("0", f"port-{i}", pkv.Value(
                    1, "port", f"p{i}".encode()).with_hash())
            ref.add_peer_sync(rkvstore.PeerSpec(
                node_name="port", endpoint=("127.0.0.1", ports["port"])))
            port.add_peer_sync(pkvstore.PeerSpec(
                node_name="ref", endpoint=("127.0.0.1", ports["ref"])))

            def same(n):
                return (len(ref.dbs["0"].kv) == len(port.dbs["0"].kv) == n
                        and ref.dbs["0"].store_hash()
                        == port.dbs["0"].store_hash())

            assert await settle(lambda: same(40)), \
                "the full syncs did not converge"
            dialer = port if listener == "ref" else ref
            assert dialer.peers["0", listener].session.codec == (
                "bin" if binary else "json")
            ref.set_key("0", "late-ref", rkv.Value(
                1, "ref", b"L").with_hash())
            port.set_key("0", "late-port", pkv.Value(
                1, "port", b"M").with_hash())
            assert await settle(
                lambda: port.get_key("0", "late-ref") is not None
                and ref.get_key("0", "late-port") is not None), \
                "the floods did not cross"
            assert port.get_key("0", "late-ref").value == b"L"
            assert ref.get_key("0", "late-port").value == b"M"
            assert await settle(lambda: same(42))
        finally:
            await ref.stop()
            await port.stop()
            for s in servers.values():
                await s.stop()

    asyncio.run(main())

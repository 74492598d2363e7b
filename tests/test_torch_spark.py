"""The port's Spark (`openr_tpu_torch.spark`) held against the JAX
package's on the CPU.

* Every case of `tests/test_spark_linkmonitor.py` runs on the port: the
  JAX test module's source, with each `openr_tpu` import pointed at
  `openr_tpu_torch`, is executed as a module of its own (discovery and
  the hold timer, restart detection through the heard map, the
  three-node star, area negotiation, discovery feeding the KvStore, the
  RTT from reflected timestamps, and LinkMonitor's flap damping and
  node overload).
* Each Spark message (hello with its heard map, handshake, heartbeat,
  in a `SparkPacket`) encodes to the JAX package's bytes in both codecs
  for seeded messages, and each side decodes the other's.
* A JAX `Spark` and a port `Spark`, each on its own `UdpIoProvider` on
  loopback, reach ESTABLISHED with each other and each emits the other's
  NEIGHBOR_UP with its transport endpoint.
"""

import asyncio
import pathlib
import re
import types

import numpy as np
import pytest

import openr_tpu.config as rcfg
import openr_tpu.messaging as rmsg
import openr_tpu.spark as rspark
import openr_tpu.spark.spark as rsm
import openr_tpu.types.serde as rs
from openr_tpu_torch import config as pcfg
from openr_tpu_torch import messaging as pmsg
from openr_tpu_torch import spark as pspark
from openr_tpu_torch.spark import spark as psm
from openr_tpu_torch.types import serde as ps

TESTS = pathlib.Path(__file__).resolve().parent
SEED = 20261018


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


SPARK_CASES = on_port("test_spark_linkmonitor")


def cases(mod):
    """Each test function of `mod`, with the marks it carries there."""
    return [pytest.param(n, marks=getattr(f, "pytestmark", []))
            for n, f in sorted(vars(mod).items())
            if n.startswith("test_") and callable(f)]


@pytest.mark.parametrize("case", cases(SPARK_CASES))
def test_spark_case_on_port(case):
    getattr(SPARK_CASES, case)()


def test_mirrored_module_uses_the_port():
    for name in ("Spark", "MockIoHub", "LinkMonitor", "KvStore", "Config"):
        assert vars(SPARK_CASES)[name].__module__.startswith(
            "openr_tpu_torch."), name
    assert len(cases(SPARK_CASES)) >= 8


# ---- the packets, byte for byte --------------------------------------------


def draw_packets(mod, rng) -> list:
    """Seeded hellos (heard maps, timestamps, flags), handshakes and
    heartbeats of one package's Spark."""
    out = []
    for i in range(12):
        name = f"node-{int(rng.integers(0, 1000))}"
        ifn = f"if_{int(rng.integers(0, 64))}"
        kind = i % 3
        if kind == 0:
            heard = {f"node-{int(rng.integers(0, 1000))}": (
                int(rng.integers(0, 1 << 31)), int(rng.integers(0, 1 << 50)),
                int(rng.integers(0, 1 << 20)))
                for _ in range(int(rng.integers(0, 5)))}
            out.append(mod.SparkPacket(hello=mod.HelloMsg(
                node_name=name, if_name=ifn, seq=int(rng.integers(0, 1 << 31)),
                heard=heard, sent_ts_us=int(rng.integers(0, 1 << 50)),
                restarting=bool(rng.integers(0, 2)),
                fastinit=bool(rng.integers(0, 2)))))
        elif kind == 1:
            out.append(mod.SparkPacket(handshake=mod.HandshakeMsg(
                node_name=name, if_name=ifn,
                area=str(int(rng.integers(0, 3))),
                hold_time_ms=int(rng.integers(100, 10_000)),
                gr_time_ms=int(rng.integers(100, 60_000)),
                kvstore_port=int(rng.integers(0, 65536)),
                ctrl_port=int(rng.integers(0, 65536)),
                endpoint_host=f"10.0.{int(rng.integers(0, 255))}.1",
                label=int(rng.integers(0, 1 << 20)),
                is_ack=bool(rng.integers(0, 2)))))
        else:
            out.append(mod.SparkPacket(heartbeat=mod.HeartbeatMsg(
                node_name=name, if_name=ifn,
                seq=int(rng.integers(0, 1 << 31)),
                hold_time_ms=int(rng.integers(100, 10_000)))))
    return out


@pytest.mark.parametrize("seed", range(3))
def test_packets_byte_equal_in_both_codecs(seed):
    ref = draw_packets(rsm, np.random.default_rng(SEED + seed))
    port = draw_packets(psm, np.random.default_rng(SEED + seed))
    for r, p in zip(ref, port):
        assert rs.to_wire(r) == ps.to_wire(p)
        assert rs.to_wire_bin(r) == ps.to_wire_bin(p)
        for blob in (rs.to_wire(r), rs.to_wire_bin(r)):
            assert ps.from_wire_auto(blob, psm.SparkPacket) == p
        for blob in (ps.to_wire(p), ps.to_wire_bin(p)):
            assert rs.from_wire_auto(blob, rsm.SparkPacket) == r


def test_spark_config_and_validation_agree():
    """The same SparkConfig is taken or refused by both packages."""
    for kw in ({}, dict(fastinit_hello_time_ms=0),
               dict(fastinit_hello_time_ms=600),
               dict(hold_time_ms=100, keepalive_time_ms=50),
               dict(wire_codec="xml"), dict(wire_codec="json")):
        outcomes = []
        for C in (rcfg, pcfg):
            try:
                C.Config(C.NodeConfig(node_name="n",
                                      spark=C.SparkConfig(**kw)))
                outcomes.append("ok")
            except C.ConfigError:
                outcomes.append("refused")
        assert outcomes[0] == outcomes[1], kw


# ---- a JAX Spark and a port Spark over real UDP ----------------------------


FAST = dict(hello_time_ms=60, fastinit_hello_time_ms=20, handshake_time_ms=20,
            keepalive_time_ms=40, hold_time_ms=400,
            graceful_restart_time_ms=600)


@pytest.mark.parametrize("codec", ["bin", "json"])
def test_jax_and_port_spark_establish_over_udp(codec):
    """Each on its own UdpIoProvider on loopback (the JAX side sending
    in `codec`, the port in binary): both reach ESTABLISHED and emit
    NEIGHBOR_UP carrying the other's KvStore port."""

    async def main():
        sides = {}
        for tag, C, msg, sp, kv_port, wc in (
                ("ref", rcfg, rmsg, rspark, 1111, codec),
                ("port", pcfg, pmsg, pspark, 2222, "bin")):
            name = f"{tag}-node"
            cfg = C.Config(C.NodeConfig(
                node_name=name,
                spark=C.SparkConfig(**FAST, wire_codec=wc)))
            q = msg.ReplicateQueue(name=f"{name}.nbr")
            io = sp.UdpIoProvider()
            port = await io.add_interface(f"if-{tag}", 0)
            s = sp.Spark(cfg, io, q, kvstore_port=kv_port)
            sides[tag] = dict(io=io, port=port, spark=s, reader=q.get_reader(),
                              ifn=f"if-{tag}", name=name)
        sides["ref"]["io"].set_peer("if-ref", ("127.0.0.1",
                                               sides["port"]["port"]))
        sides["port"]["io"].set_peer("if-port", ("127.0.0.1",
                                                 sides["ref"]["port"]))
        for s in sides.values():
            await s["spark"].start()
            s["spark"].add_interface(s["ifn"])
        try:
            for me, other, kv in (("ref", "port", 2222), ("port", "ref", 1111)):
                s = sides[me]
                ev = await asyncio.wait_for(s["reader"].get(), 10.0)
                assert ev.type.name == "NEIGHBOR_UP"
                assert ev.info.node_name == sides[other]["name"]
                assert ev.info.remote_if == sides[other]["ifn"]
                assert ev.info.kvstore_port == kv
                nb = s["spark"].neighbors[(s["ifn"], sides[other]["name"])]
                assert nb.state.name == "ESTABLISHED"
        finally:
            for s in sides.values():
                await s["spark"].stop()

    asyncio.run(main())


@pytest.mark.parametrize("lost", [1, 2, 3])
def test_a_lost_handshake_is_sent_again(lost):
    """The first `lost` handshakes b sends (its acks, and its own
    handshake if it sends one) are lost. a, left in NEGOTIATE while b is
    ESTABLISHED on a's handshake, sends its handshake again on b's next
    hello that hears it, handshake_time_ms after the last, until an ack
    arrives: both sides reach ESTABLISHED. (The JAX package's Spark
    sends one handshake on entering NEGOTIATE and none after, and stays
    there.)"""

    async def main():
        hub = pspark.MockIoHub()
        sa, _qa = SPARK_CASES.mk_spark(hub, "a")
        sb, _qb = SPARK_CASES.mk_spark(hub, "b")
        inner, dropped = sb._send_handshake, []

        async def lossy(nb, is_ack):
            if len(dropped) < lost:
                dropped.append(is_ack)
                return
            await inner(nb, is_ack)

        sb._send_handshake = lossy
        hub.link("a", "if-ab", "b", "if-ba")
        await sa.start()
        await sb.start()
        sa.add_interface("if-ab")
        sb.add_interface("if-ba")
        try:
            up = await SPARK_CASES.settle(lambda: all(
                s.neighbors.get(k) is not None and s.neighbors[k].state
                == psm.SparkNeighborState.ESTABLISHED
                for s, k in ((sa, ("if-ab", "b")), (sb, ("if-ba", "a")))),
                timeout=10.0)
            assert up, {k: v.state for s in (sa, sb)
                        for k, v in s.neighbors.items()}
            assert len(dropped) == lost
            if lost >= 2:
                # b's first ack to a was among the lost, whichever of
                # them sent first
                assert sa.counters.get("spark.handshake_sent") >= 2
        finally:
            await sa.stop()
            await sb.stop()

    asyncio.run(main())

"""The port's OpenrNode (`openr_tpu_torch.node`) held against the JAX
package's on the CPU.

* The same config gives the same queues (names, bounds, overflow
  policies, coalesce functions) and the same modules in the same start
  order in both packages.
* A port node and a JAX node in one event loop, over real sockets: each
  with its own `UdpIoProvider` (Spark's hellos on loopback UDP), its own
  KvStore listener (`RpcServer` + `register_rpc`) and `TcpKvTransport`.
  They find each other, peer their stores over TCP, and each programs
  the other's loopback; the port's Decision solves with `device="cpu"`.
* Three port nodes on a `MockIoHub` program tables equal, byte for byte,
  to three JAX nodes' on the same `topogen.ring(3)`, with seeded link
  metrics set through each LinkMonitor's metric override.
* Every option whose module the port does not have yet raises, naming
  it; `device=None` without CUDA raises.
"""

import asyncio
import dataclasses
import types

import numpy as np
import pytest
import torch

import openr_tpu.config as rcfg
import openr_tpu.fib.fib as rfibm
import openr_tpu.kvstore as rkvs
import openr_tpu.node as rnode
import openr_tpu.rpc as rrpc
import openr_tpu.spark as rspark
import openr_tpu.types.serde as rs
from openr_tpu.utils import topogen as rtopogen
from openr_tpu_torch import config as pcfg
from openr_tpu_torch import fib as pfib
from openr_tpu_torch import kvstore as pkvs
from openr_tpu_torch import node as pnode
from openr_tpu_torch import rpc as prpc
from openr_tpu_torch import spark as pspark
from openr_tpu_torch.types import serde as ps
from openr_tpu_torch.utils import topogen as ptopogen

SEED = 20261021

PKGS = {
    "ref": types.SimpleNamespace(cfg=rcfg, fib=rfibm, kvs=rkvs, node=rnode,
                                 rpc=rrpc, spark=rspark, serde=rs,
                                 solver={"solver": "cpu"}),
    "port": types.SimpleNamespace(cfg=pcfg, fib=pfib, kvs=pkvs, node=pnode,
                                  rpc=prpc, spark=pspark, serde=ps,
                                  solver={"device": "cpu"}),
}


def node_cfg(pkg, name: str, prefixes=(), **kw):
    C = pkg.cfg
    return C.Config(C.NodeConfig(
        node_name=name,
        spark=C.SparkConfig(hello_time_ms=60, fastinit_hello_time_ms=20,
                            handshake_time_ms=20, keepalive_time_ms=40,
                            hold_time_ms=400, graceful_restart_time_ms=600),
        kvstore=C.KvstoreConfig(initial_sync_grace_s=0.5),
        watchdog=C.WatchdogConfig(enable=False),
        originated_prefixes=tuple(C.OriginatedPrefix(prefix=p)
                                  for p in prefixes), **kw))


async def until(cond, what: str, timeout: float = 30.0) -> None:
    t0 = asyncio.get_event_loop().time()
    while not cond():
        if asyncio.get_event_loop().time() - t0 > timeout:
            raise AssertionError(f"{what}: not within {timeout} s")
        await asyncio.sleep(0.02)


def test_queues_and_start_order_equal_the_reference():
    async def main():
        built = {}
        for tag, pkg in PKGS.items():
            hub = pkg.spark.MockIoHub()
            cfg = node_cfg(pkg, "n", prefix_allocation=pkg.cfg.
                           PrefixAllocationConfig(seed_prefix="10.0.0.0/8",
                                                  alloc_prefix_len=24),
                           areas=(pkg.cfg.AreaConfig(area_id="a"),
                                  pkg.cfg.AreaConfig(area_id="b")))
            n = pkg.node.OpenrNode(cfg, hub.io_for("n"),
                                   pkg.kvs.InProcKvTransport(), **pkg.solver)
            built[tag] = n
        ref, port = built["ref"], built["port"]
        assert list(port.queues) == list(ref.queues)
        for k, q in port.queues.items():
            r = ref.queues[k]
            assert (q.name, q.maxsize, q.policy) == (r.name, r.maxsize,
                                                     r.policy), k
            assert getattr(q.coalesce_fn, "__name__", None) == getattr(
                r.coalesce_fn, "__name__", None), k
            assert [x.maxsize for x in q.readers] == \
                [x.maxsize for x in r.readers], k
        assert [type(m).__name__ for m in port._modules] == \
            [type(m).__name__ for m in ref._modules]
        assert port.counters.get("wire.schema_lock_version") == \
            ref.counters.get("wire.schema_lock_version") > 0
        assert port.counters.flight is port.flight
        port.counters.flight_record("test.kind", x=1)
        assert port.flight.dump()[-1]["kind"] == "test.kind"

    asyncio.run(main())


def test_left_out_options_raise():
    hub = pspark.MockIoHub()

    def mk(cfg=None, **kw):
        return pnode.OpenrNode(cfg or node_cfg(PKGS["port"], "n"),
                               hub.io_for("n"), pkvs.InProcKvTransport(),
                               **{"device": "cpu", **kw})

    for kw, module in ((dict(store_path="/nonexistent/s"), "configstore"),
                       (dict(persist_dir="/nonexistent/p"), "persist"),
                       (dict(persist=object()), "persist")):
        with pytest.raises(NotImplementedError, match=module):
            mk(**kw)
    C = pcfg
    on = C.Config(dataclasses.replace(node_cfg(PKGS["port"], "n").node,
                                      watchdog=C.WatchdogConfig(enable=True)))
    with pytest.raises(NotImplementedError, match="watchdog"):
        mk(on)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            mk(device=None)
    mk()  # the CPU twins, every module built


@pytest.mark.parametrize("kw", [dict(watchdog_abort_fn=lambda: None)],
                         ids=["watchdog_abort_fn"])
def test_ctrl_and_watchdog_arguments_are_not_taken(kw):
    """The JAX node takes this; the port has no watchdog, so a caller who
    passes one is refused, not ignored. (`ctrl_port` is taken since the
    port serves ctrl: `test_enable_ctrl_starts_ctrl_last`.)"""
    rnode.OpenrNode(node_cfg(PKGS["ref"], "n"),
                    rspark.MockIoHub().io_for("n"),
                    rkvs.InProcKvTransport(), solver="cpu", **kw)
    with pytest.raises(TypeError, match=next(iter(kw))):
        pnode.OpenrNode(node_cfg(PKGS["port"], "n"),
                        pspark.MockIoHub().io_for("n"),
                        pkvs.InProcKvTransport(), device="cpu", **kw)


def test_enable_ctrl_starts_ctrl_last():
    """`enable_ctrl=True` builds a `CtrlServer`, last in the start order as
    in the JAX node, serving on `ctrl_port` (0: ephemeral) until stop."""
    async def main():
        built = {}
        for tag, pkg in PKGS.items():
            hub = pkg.spark.MockIoHub()
            built[tag] = pkg.node.OpenrNode(
                node_cfg(pkg, "n", prefixes=("10.9.0.1/32",)),
                hub.io_for("n"), pkg.kvs.InProcKvTransport(),
                enable_ctrl=True, ctrl_port=0, **pkg.solver)
        ref, port = built["ref"], built["port"]
        assert [type(m).__name__ for m in port._modules] == \
            [type(m).__name__ for m in ref._modules]
        assert port._modules[-1] is port.ctrl
        assert type(port.ctrl).__module__ == "openr_tpu_torch.ctrl.server"
        await port.start()
        try:
            assert port.ctrl.port > 0
            cli = prpc.RpcClient(port=port.ctrl.port)
            await cli.connect()
            assert await cli.call("get_my_node_name") == "n"
            await until(lambda: port.initialized, "node initialized")
            st = await cli.call("get_initialization_status")
            assert st["INITIALIZED"]
            adv = await cli.call("get_advertised_prefixes")
            assert "10.9.0.1/32" in adv
            await cli.close()
        finally:
            await port.stop()
        with pytest.raises(OSError):
            probe = prpc.RpcClient(port=port.ctrl.port)
            await probe.connect()

    asyncio.run(main())


def test_wire_schema_lock_is_the_reference_lock():
    """The port speaks the JAX package's wire, so its copy of the schema
    lock is that lock, byte for byte, and both readers give one version."""
    from openr_tpu.types import wirelock as rlock
    from openr_tpu_torch.types import wirelock as plock

    assert plock.LOCK_PATH.read_bytes() == rlock.LOCK_PATH.read_bytes()
    assert plock.load_lock() == rlock.load_lock()
    assert plock.locked_version() == rlock.locked_version() > 0


# ---- a JAX node and a port node over UDP and TCP ---------------------------


def test_jax_and_port_nodes_over_udp_and_tcp():
    """Spark over loopback UDP, the stores over TCP, each node programs
    the other's loopback (and the JAX node's table holds the port
    node's, and the other way round)."""

    async def main():
        sides = {}
        for tag, pkg, lo in (("ref", PKGS["ref"], "10.77.0.1/32"),
                             ("port", PKGS["port"], "10.77.0.2/32")):
            name = f"{tag}-node"
            io = pkg.spark.UdpIoProvider()
            udp = await io.add_interface(f"if-{tag}", 0)
            server = pkg.rpc.RpcServer(f"{name}.kv")
            kv_port = await server.start("127.0.0.1", 0)
            node = pkg.node.OpenrNode(node_cfg(pkg, name, (lo,)), io,
                                      pkg.kvs.TcpKvTransport(),
                                      kvstore_port=kv_port, **pkg.solver)
            node.kvstore.register_rpc(server)
            sides[tag] = dict(io=io, udp=udp, server=server, node=node,
                              lo=lo, ifn=f"if-{tag}")
        sides["ref"]["io"].set_peer("if-ref", ("127.0.0.1",
                                               sides["port"]["udp"]))
        sides["port"]["io"].set_peer("if-port", ("127.0.0.1",
                                                 sides["ref"]["udp"]))
        try:
            for s in sides.values():
                await s["node"].start()
                s["node"].set_interface(s["ifn"])
            for me, other in (("ref", "port"), ("port", "ref")):
                n = sides[me]["node"]
                want = sides[other]["lo"]
                await until(lambda n=n, want=want: any(
                    str(r.dest) == want for r in n.get_programmed_routes()),
                    f"{me} programs {want}")
            for s in sides.values():
                await s["node"].wait_initialized(10.0)
            # one TCP session each way, binary framing negotiated
            port_peer = sides["port"]["node"].kvstore.peers["0", "ref-node"]
            ref_peer = sides["ref"]["node"].kvstore.peers["0", "port-node"]
            assert port_peer.session.codec == ref_peer.session.codec == "bin"
            assert port_peer.spec.endpoint == ("127.0.0.1",
                                               sides["ref"]["server"].port)
        finally:
            for s in sides.values():
                await s["node"].stop()
                await s["server"].stop()

    asyncio.run(main())


# ---- three port nodes and three JAX nodes on a MockIoHub -------------------


def ring_nodes(pkg, topo):
    adj, pfx = topo.ring(3)
    hub = pkg.spark.MockIoHub()
    t = pkg.kvs.InProcKvTransport()
    nodes = {}
    for db, p in zip(adj, pfx):
        name = db.this_node_name
        nodes[name] = pkg.node.OpenrNode(
            node_cfg(pkg, name, (str(p.prefix_entries[0].prefix),)),
            hub.io_for(name), t, **pkg.solver)
        t.register(name, nodes[name].kvstore)
        for a in db.adjacencies:
            if a.other_node_name > name:
                hub.link(name, a.if_name, a.other_node_name, a.other_if_name)
    return adj, nodes


def table(pkg, node) -> dict:
    S = pkg.serde
    h = node.fib_handler
    client = pkg.fib.CLIENT_ID_OPENR
    return dict(
        unicast={str(p): S.to_wire(r) for p, r in sorted(
            h.unicast.get(client, {}).items())},
        mpls={lb: S.to_wire(r) for lb, r in sorted(
            h.mpls.get(client, {}).items())})


@pytest.mark.parametrize("seed", range(2))
def test_three_port_nodes_equal_three_jax_nodes(seed):
    rng = np.random.default_rng(SEED + seed)
    metrics = {}
    for db in ptopogen.ring(3)[0]:
        for a in db.adjacencies:
            metrics[a.if_name] = int(rng.integers(1, 50))

    async def main():
        runs = {tag: ring_nodes(pkg, topo) for tag, pkg, topo in (
            ("ref", PKGS["ref"], rtopogen), ("port", PKGS["port"], ptopogen))}
        try:
            for adj, nodes in runs.values():
                for db in adj:
                    n = nodes[db.this_node_name]
                    for a in db.adjacencies:
                        n.linkmonitor.set_link_metric(a.if_name,
                                                      metrics[a.if_name])
                    await n.start()
                    for a in db.adjacencies:
                        n.set_interface(a.if_name)

            def done(tag):
                pkg, (_adj, nodes) = PKGS[tag], runs[tag]
                tabs = [table(pkg, n) for n in nodes.values()]
                return all(len(t["unicast"]) == 2 for t in tabs) and all(
                    n.initialized for n in nodes.values())

            for tag in runs:
                await until(lambda tag=tag: done(tag), f"{tag} converges")
            # and the tables stay put a beat: no late metric change
            await asyncio.sleep(0.3)
            for name in runs["port"][1]:
                got = table(PKGS["port"], runs["port"][1][name])
                want = table(PKGS["ref"], runs["ref"][1][name])
                assert got == want, name
                assert got["unicast"], name
            # the seeded metrics went into the advertised adjacencies
            n0 = runs["port"][1]["node-0"]
            own = n0.linkmonitor.build_adjacency_db("0")
            assert sorted(a.metric for a in own.adjacencies) == sorted(
                metrics[a.if_name] for a in own.adjacencies)
        finally:
            for _adj, nodes in runs.values():
                for n in nodes.values():
                    await n.stop()

    asyncio.run(main())

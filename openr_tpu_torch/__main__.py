"""Process entry point: one real Open/R node on the port (the port's copy
of `openr_tpu/__main__.py`).

    python -m openr_tpu_torch --config node.json [--device cuda|cpu]
                              [--ready-file PATH] [--log-level LEVEL]

The node runs in control-plane overlay mode: its interfaces are the
static point-to-point UDP links of `udp_interfaces` in the config (Spark
finds its neighbours over them), its KvStore peers over TCP on
`kvstore_port` at `endpoint_host` (bound first, so that Spark advertises
the bound port), its Decision solves on the card (`--device cuda`, the
default; `--device cpu` runs the CPU twins, for tests) and Fib programs
the in-memory `MockFibHandler`. Without CUDA, `--device cuda` exits
non-zero before it binds anything: nothing carries on on the CPU.

The node serves the ctrl API (`ctrl.CtrlServer`) on `endpoint_host` at
the config's `ctrl_port` (0: an ephemeral port); query it with
`rpc.RpcClient(host, ctrl_port)`, e.g. `await cli.call(
"get_route_db_programmed")`.

Once every listener is bound, the node prints one line
`OPENR_READY {"node", "pid", "ctrl_port", "kvstore_port", "udp_ports"}`
and writes the same JSON atomically to `--ready-file`; a bind failure
exits with 1 and the ready file carries `{"node", "error"}` instead.
SIGINT or SIGTERM stops the node and exits with 0.

Not part of the port yet, each refused with a clear error: `--dataplane
netlink` (the kernel FIB and interface source), `--store-path` (the
persistent config store) and `--persist-dir` (the durable journal). The
config's `watchdog.enable` must be False.
"""

from __future__ import annotations

import argparse
import asyncio
import json
import logging
import os
import signal
import sys

from openr_tpu_torch.config import Config
from openr_tpu_torch.fib import MockFibHandler
from openr_tpu_torch.kvstore import TcpKvTransport
from openr_tpu_torch.node import OpenrNode
from openr_tpu_torch.rpc import RpcServer
from openr_tpu_torch.rpc.tls import client_ssl_context, server_ssl_context
from openr_tpu_torch.spark.io import UdpIoProvider
from openr_tpu_torch.types.events import InterfaceEvent, InterfaceInfo

log = logging.getLogger("openr_tpu_torch.main")


def atomic_write_bytes(path: str, data: bytes) -> None:
    """fsync a temporary file, rename it over `path`, fsync the
    directory: a reader sees the old file or the whole new one."""
    tmp = f"{path}.tmp.{os.getpid()}"
    with open(tmp, "wb") as f:
        f.write(data)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)
    dirfd = os.open(os.path.dirname(os.path.abspath(path)), os.O_RDONLY)
    try:
        os.fsync(dirfd)
    finally:
        os.close(dirfd)


def _write_ready(path: str, payload: dict) -> None:
    """The readiness handshake a supervisor polls for: never partly
    written."""
    atomic_write_bytes(path, json.dumps(payload).encode())


async def run_node(config: Config, device, ready_file: str | None = None):
    io = UdpIoProvider()
    # with local_port 0 every interface binds a free port, and the
    # readiness line says where each one landed
    udp_ports: dict[str, int] = {}
    for u in config.node.udp_interfaces:
        peer = (u.peer_host, u.peer_port) if u.peer_port else None
        udp_ports[u.if_name] = await io.add_interface(
            u.if_name, u.local_port, peer
        )
    fib_handler = MockFibHandler()
    host = config.node.endpoint_host
    # the KvStore peering listener first: its bound port is what Spark
    # advertises to neighbours
    kv_rpc = RpcServer(f"{config.node_name}.kv")
    kv_port = await kv_rpc.start(
        host, config.node.kvstore_port,
        ssl=server_ssl_context(config.node.tls),
    )
    log.info(
        "kvstore peering on %s:%d%s", host, kv_port,
        " (tls)" if config.node.tls.enabled else "",
    )
    node = OpenrNode(
        config,
        io,
        TcpKvTransport(ssl=client_ssl_context(config.node.tls)),
        fib_handler=fib_handler,
        device=device,
        kvstore_port=kv_port,
        endpoint_host=host,
        enable_ctrl=True,
        ctrl_port=config.node.ctrl_port,
    )
    node.kvstore.register_rpc(kv_rpc)
    # wire byte accounting (rpc.bytes_tx / rx): the listener exists
    # before the node's Counters do; connections arrive only after start
    kv_rpc.counters = node.counters

    await node.start()
    if config.node.udp_interfaces:
        node.interface_events.push(
            InterfaceEvent(
                interfaces=[
                    InterfaceInfo(name=u.if_name, is_up=True)
                    for u in config.node.udp_interfaces
                ]
            )
        )
    log.info("node %s up (ctrl %s:%d, device %s)", node.name, host,
             node.ctrl.port, node.decision.device)
    ready = {
        "node": node.name,
        "pid": os.getpid(),
        "ctrl_port": node.ctrl.port,
        "kvstore_port": kv_port,
        "udp_ports": udp_ports,
    }
    print(f"OPENR_READY {json.dumps(ready, sort_keys=True)}", flush=True)
    if ready_file:
        _write_ready(ready_file, ready)

    stop_ev = asyncio.Event()
    loop = asyncio.get_event_loop()
    for sig in (signal.SIGINT, signal.SIGTERM):
        loop.add_signal_handler(sig, stop_ev.set)
    await stop_ev.wait()

    log.info("shutting down")
    await node.stop()
    await kv_rpc.stop()


def _refuse(args, config_name: str, msg: str) -> int:
    print(f"FATAL: {msg}", file=sys.stderr, flush=True)
    if args.ready_file:
        _write_ready(args.ready_file, {"node": config_name, "error": msg})
    return 2


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(prog="openr_tpu_torch")
    ap.add_argument("--config", required=True, help="node config JSON path")
    ap.add_argument(
        "--dataplane", choices=("none", "netlink"), default="none",
        help="'none': the UDP links of the config and an in-memory FIB;"
        " 'netlink' is not part of the port yet",
    )
    ap.add_argument(
        "--store-path", default=None,
        help="the persistent config store (not part of the port yet)",
    )
    ap.add_argument(
        "--persist-dir", default=None,
        help="the durable journal (not part of the port yet)",
    )
    ap.add_argument("--log-level", default="INFO")
    ap.add_argument(
        "--ready-file", default=None,
        help="write the readiness JSON (node, pid, bound ctrl/kvstore/udp"
        " ports) here once every listener is up; on a bind failure it"
        " carries {'error': ...} instead",
    )
    ap.add_argument(
        "--device", choices=("cuda", "cpu"), default="cuda",
        help="where the Decision solves: the current CUDA card (the"
        " default; exits non-zero without one) or the CPU twins",
    )
    args = ap.parse_args(argv)
    logging.basicConfig(
        level=getattr(logging, args.log_level.upper(), logging.INFO),
        format="%(asctime)s %(levelname).1s %(name)s: %(message)s",
    )
    config = Config.from_file(args.config)
    name = config.node_name
    if args.dataplane == "netlink":
        return _refuse(args, name, "--dataplane netlink needs the kernel "
                       "FIB and interface source, which are not part of "
                       "the port yet")
    if args.store_path is not None:
        return _refuse(args, name, "--store-path needs the persistent "
                       "config store, which is not part of the port yet")
    if args.persist_dir is not None:
        return _refuse(args, name, "--persist-dir needs the durable "
                       "journal, which is not part of the port yet")
    if config.node.watchdog.enable:
        return _refuse(args, name, "watchdog.enable needs the watchdog, "
                       "which is not part of the port yet: set it false in "
                       "the config")
    if args.device == "cuda":
        import torch

        if not torch.cuda.is_available():
            return _refuse(args, name, "--device cuda and no CUDA device "
                           "is available (--device cpu runs the CPU twins)")
    device = None if args.device == "cuda" else "cpu"
    try:
        asyncio.run(run_node(config, device, ready_file=args.ready_file))
    except OSError as e:
        # a pinned port taken by another process: fail fast, so that a
        # supervisor waiting on the ready file does not hang
        msg = (
            f"FATAL: node {name!r} could not bind its listeners: {e} —"
            " pinned kvstore_port/local_port values collide with another"
            " process; use port 0 for a free port"
        )
        print(msg, file=sys.stderr, flush=True)
        if args.ready_file:
            _write_ready(args.ready_file, {"node": name, "error": str(e)})
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""Two `python -m openr_tpu_torch --device cpu` daemons on localhost, as
`tests/test_main_process.py` runs two of the JAX package's: Spark over
UDP, the KvStores over TCP, the Decision on the CPU twins, Fib on the
in-memory handler.

Every port is 0: each daemon reports where it bound in its ready file,
so no port is guessed free. The two UDP links meet in a relay this test
binds first (its two sockets' ports go into the configs), which forwards
each daemon's datagrams to the other's reported port.

* Each daemon originates its loopback and an aggregate that covers the
  other's loopback alone (`minimum_supporting_routes=1`): the aggregate
  is advertised only once Fib has programmed the route the Decision
  solved. Each aggregate shows up in the other daemon's store, read by a
  TCP full sync against that daemon's KvStore listener.
* Each daemon serves ctrl on the port its ready line reports: over
  `RpcClient` it is INITIALIZED, and its programmed table equals the JAX
  package's oracle solved on the LSDB it reports over ctrl (adjacency
  DBs, and the prefix DBs of its store).
* SIGTERM ends each daemon with exit 0.
* A third daemon whose `kvstore_port` is pinned to a port the first one
  holds exits with 1, and its ready file carries `error`.
* `--device cuda` on a host without CUDA exits non-zero without binding
  anything, and so do the options not part of the port yet.

Every wait is bounded, and every process is killed in `finally`.
"""

import asyncio
import json
import signal
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from openr_tpu_torch.rpc import RpcClient

REPO = Path(__file__).resolve().parents[1]
LOOPBACKS = {"a": "10.98.1.1/32", "b": "10.98.2.1/32"}
# each aggregate covers the other daemon's loopback
AGGREGATES = {"a": "10.98.2.0/24", "b": "10.98.1.0/24"}


def node_cfg(name: str, relay_port: int, me: str, kv_port: int = 0) -> dict:
    return {
        "node_name": name,
        "ctrl_port": 0,
        "kvstore_port": kv_port,
        "endpoint_host": "127.0.0.1",
        "watchdog": {"enable": False},
        "spark": {
            "hello_time_ms": 200,
            "fastinit_hello_time_ms": 50,
            "handshake_time_ms": 50,
            "keepalive_time_ms": 100,
            "hold_time_ms": 1000,
            "graceful_restart_time_ms": 3000,
        },
        "kvstore": {"initial_sync_grace_s": 0.5},
        "udp_interfaces": [{
            "if_name": f"udp-{name}", "local_port": 0,
            "peer_host": "127.0.0.1", "peer_port": relay_port,
        }],
        "originated_prefixes": [
            {"prefix": LOOPBACKS[me]},
            {"prefix": AGGREGATES[me], "minimum_supporting_routes": 1},
        ],
    }


class Relay(asyncio.DatagramProtocol):
    """One UDP socket: what arrives is sent on to `to`, from `out`."""

    def __init__(self):
        self.to = None
        self.out = None

    def datagram_received(self, data, addr):
        if self.to is not None and self.out is not None:
            self.out.sendto(data, self.to)


async def spawn(cfg_path: Path, ready: Path, *extra: str):
    # a log file, not a pipe: an unread full pipe would stall the daemon
    lf = await asyncio.to_thread(open, cfg_path.with_suffix(".log"), "wb")
    try:
        return await asyncio.create_subprocess_exec(
            sys.executable, "-m", "openr_tpu_torch", "--config",
            str(cfg_path), "--ready-file", str(ready), "--log-level",
            "WARNING", *extra, cwd=str(REPO), stdout=lf, stderr=lf)
    finally:
        lf.close()


async def read_ready(path: Path, proc, timeout: float = 60.0) -> dict:
    loop = asyncio.get_event_loop()
    t0 = loop.time()
    while not path.exists():
        if proc.returncode is not None:
            raise AssertionError(f"daemon exited {proc.returncode} before "
                                 f"ready: {path.with_suffix('.log')}")
        if loop.time() - t0 > timeout:
            raise AssertionError(f"no ready file {path} in {timeout} s")
        await asyncio.sleep(0.05)
    return json.loads(await asyncio.to_thread(path.read_text))


async def store_keys(kv_port: int) -> set:
    """Every key of a daemon's store, by a full sync with an empty
    digest against its KvStore listener."""
    c = RpcClient("127.0.0.1", kv_port)
    await c.connect()
    try:
        r = await c.call("kv.fullSync", {"area": "0", "sender": "probe",
                                         "digest": {}}, timeout=10.0)
    finally:
        await c.close()
    return set(r.get("key_vals") or {})


async def table_equals_jax_oracle(name: str, ctrl_port: int) -> None:
    """Over ctrl: the daemon is INITIALIZED, and `get_route_db_programmed`
    equals the JAX oracle's table for the LSDB the daemon reports (its
    Decision's adjacency DBs and its store's prefix DBs). Once the other
    daemon's aggregate is in, the table has two routes (the other's
    loopback and aggregate; its own aggregate is local); it is read again
    until it holds them (bounded)."""
    from openr_tpu.common.constants import parse_prefix_key
    from openr_tpu.ctrl.server import _unicast_json
    from openr_tpu.decision.linkstate import LinkState, PrefixState
    from openr_tpu.decision.oracle import compute_routes
    from openr_tpu.kvstore.kvstore import value_from_json
    from openr_tpu.types.serde import from_jsonable, from_wire_auto
    from openr_tpu.types.topology import AdjacencyDatabase, PrefixDatabase

    c = RpcClient("127.0.0.1", ctrl_port)
    await c.connect()
    loop = asyncio.get_running_loop()
    t0 = loop.time()
    try:
        while True:
            st = await c.call("get_initialization_status", timeout=10.0)
            adj = await c.call("get_decision_adjacency_dbs", timeout=10.0)
            kv = await c.call("dump_kvstore", {"prefix": "prefix:"},
                              timeout=10.0)
            got = await c.call("get_route_db_programmed", timeout=10.0)
            ls, ps = LinkState(), PrefixState()
            for db in adj["0"]:
                ls.update_adjacency_db(from_jsonable(db, AdjacencyDatabase))
            for key, raw in kv["key_vals"].items():
                assert parse_prefix_key(key) is not None
                v = value_from_json(raw)
                ps.update_prefix_db(from_wire_auto(v.value, PrefixDatabase))
            want = compute_routes(ls, ps, name)
            want_u = sorted((_unicast_json(e.to_unicast_route())
                             for e in want.unicast_routes.values()),
                            key=lambda r: r["dest"])
            got_u = sorted(got["unicast_routes"], key=lambda r: r["dest"])
            if st["INITIALIZED"] and len(got_u) == 2 and got_u == want_u:
                return
            assert loop.time() - t0 < 60, (name, st, got_u, want_u)
            await asyncio.sleep(0.2)
    finally:
        await c.close()


def test_two_daemons_converge_and_stop(tmp_path):
    async def main():
        loop = asyncio.get_running_loop()
        relays, socks = {}, {}
        for k in "ab":
            relays[k] = Relay()
            socks[k], _ = await loop.create_datagram_endpoint(
                lambda k=k: relays[k], local_addr=("127.0.0.1", 0))
        procs = []
        try:
            ready = {}
            for k in "ab":
                cfg = tmp_path / f"{k}.json"
                await asyncio.to_thread(cfg.write_text, json.dumps(node_cfg(
                    f"proc-{k}", socks[k].get_extra_info("sockname")[1], k)))
                procs.append(await spawn(cfg, tmp_path / f"{k}.ready",
                                         "--device", "cpu"))
            for k, p in zip("ab", procs):
                ready[k] = await read_ready(tmp_path / f"{k}.ready", p)
                assert ready[k]["node"] == f"proc-{k}"
                assert ready[k]["pid"] == p.pid
                assert isinstance(ready[k]["ctrl_port"], int)
                assert ready[k]["ctrl_port"] > 0
            # a's datagrams go on to b's socket, b's to a's
            for k, other in (("a", "b"), ("b", "a")):
                relays[k].out = socks[k]
                relays[k].to = ("127.0.0.1",
                                ready[other]["udp_ports"][f"udp-proc-{other}"])
            for k, other in (("a", "b"), ("b", "a")):
                key = f"prefix:proc-{other}:0:[{AGGREGATES[other]}]"
                t0 = loop.time()
                while key not in await store_keys(ready[k]["kvstore_port"]):
                    assert loop.time() - t0 < 60, \
                        f"{key} never reached proc-{k}'s store"
                    await asyncio.sleep(0.1)
                keys = await store_keys(ready[k]["kvstore_port"])
                assert {"adj:proc-a", "adj:proc-b",
                        f"prefix:proc-{other}:0:[{LOOPBACKS[other]}]"} <= keys
            for k in "ab":
                await table_equals_jax_oracle(f"proc-{k}",
                                              ready[k]["ctrl_port"])
            # a third daemon pinned to a's KvStore port: exit 1, error
            cfg = tmp_path / "c.json"
            await asyncio.to_thread(cfg.write_text, json.dumps(node_cfg(
                "proc-c", socks["a"].get_extra_info("sockname")[1], "a",
                kv_port=ready["a"]["kvstore_port"])))
            c = await spawn(cfg, tmp_path / "c.ready", "--device", "cpu")
            procs.append(c)
            assert await asyncio.wait_for(c.wait(), 60) == 1
            err = await read_ready(tmp_path / "c.ready", c)
            assert err["node"] == "proc-c" and err["error"]
            for p in procs[:2]:
                p.send_signal(signal.SIGTERM)
            for p in procs[:2]:
                assert await asyncio.wait_for(p.wait(), 30) == 0
        finally:
            for p in procs:
                if p.returncode is None:
                    p.kill()
                    await p.wait()
            for s in socks.values():
                s.close()

    asyncio.run(main())


@pytest.mark.parametrize("extra", [
    ("--device", "cuda"), ("--device", "cpu", "--dataplane", "netlink"),
    ("--device", "cpu", "--store-path", "s"),
    ("--device", "cpu", "--persist-dir", "p"),
])
def test_left_out_options_exit_non_zero(tmp_path, extra):
    if extra[1] == "cuda" and torch.cuda.is_available():
        extra = ("--device", "cpu", "--dataplane", "netlink")
    cfg = tmp_path / "n.json"
    cfg.write_text(json.dumps(node_cfg("proc-n", 9, "a")))
    ready = tmp_path / "n.ready"
    res = subprocess.run(
        [sys.executable, "-m", "openr_tpu_torch", "--config", str(cfg),
         "--ready-file", str(ready), *extra],
        cwd=str(REPO), capture_output=True, text=True, timeout=120)
    assert res.returncode != 0
    assert res.stderr.startswith("FATAL: ")
    assert "OPENR_READY" not in res.stdout
    assert json.loads(ready.read_text())["error"]

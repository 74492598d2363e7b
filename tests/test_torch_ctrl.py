"""The port's ctrl API (`openr_tpu_torch.ctrl.CtrlServer`) on the CPU:
every case of `tests/test_ctrl.py` on a port cluster; the deterministic
answers of a port cluster equal a JAX cluster's over the same edges
(computed and programmed route DBs, adjacency DBs, SPF paths,
interfaces, KvStore keys, `check_fib_oracle`); every method the
reference registers is served; and the two handlers whose modules are
not ported answer with errors that name them."""

import asyncio

import pytest
import torch

import tests.test_ctrl as ref_ctrl
from openr_tpu.emulator import Cluster as JaxCluster
from openr_tpu.rpc import RpcClient as JaxRpcClient
from openr_tpu_torch.ctrl import CtrlServer
from openr_tpu_torch.rpc import RpcClient, RpcError
from openr_tpu_torch.utils import topogen as ptopo
from tests.test_torch_emulator import PortCluster, _settled
from tests.test_torch_oracle import rebind

pytestmark = pytest.mark.asyncio_debug_off

# one intra-op thread: the suite runs several test workers at once
torch.set_num_threads(1)

CTRL = rebind(ref_ctrl, Cluster=PortCluster, RpcClient=RpcClient)


def test_every_ctrl_case_is_run():
    names = {k for k in vars(ref_ctrl) if k.startswith("test_")}
    assert names == set(CTRL) and len(names) >= 9


@pytest.mark.parametrize("name", sorted(CTRL))
def test_ctrl_case_on_the_port(name):
    CTRL[name]()


def test_ctrl_cases_on_the_card_solver_twins():
    """The route-moving ctrl cases again with the nodes on the card
    solver's CPU twins in place of the oracle."""
    twins = rebind(
        ref_ctrl, RpcClient=RpcClient,
        Cluster=type("TwinCluster", (PortCluster,), {"from_edges": staticmethod(
            lambda edges, **kw: PortCluster.from_edges(edges, solver="tpu",
                                                       **kw))}))
    for name in ("test_set_interface_metric_changes_path",
                 "test_kvstore_ops_and_overload", "test_get_spf_path"):
        twins[name]()


def test_every_reference_method_is_registered():
    from openr_tpu.ctrl.server import CtrlServer as JaxCtrlServer

    async def body():
        jc = JaxCluster.from_edges([("a", "b")], enable_ctrl=True)
        pc = PortCluster.from_edges([("a", "b")], enable_ctrl=True)
        want = set(jc.nodes["a"].ctrl.server._methods)
        got = set(pc.nodes["a"].ctrl.server._methods)
        assert got == want and len(got) >= 44
        assert set(pc.nodes["a"].ctrl.server._streams) == \
            set(jc.nodes["a"].ctrl.server._streams) == \
            {"subscribe_kvstore", "subscribe_fib"}
        assert JaxCtrlServer.SUB_QUEUE_MAX == CtrlServer.SUB_QUEUE_MAX

    asyncio.run(body())


def _strip_volatile(x):
    """Drop the fields that follow timing: TTL clocks, measured RTTs, and
    the KvStore versions and value bytes (how often a node re-advertised
    its adjacencies, and their RTTs, while its neighbours came up). The
    adjacencies themselves are compared through
    `get_decision_adjacency_dbs`, RTTs stripped."""
    if isinstance(x, dict):
        return {k: _strip_volatile(v) for k, v in x.items()
                if k not in ("ttl", "hash", "version", "rtt_us", "value")}
    if isinstance(x, list):
        return [_strip_volatile(v) for v in x]
    return x


def _sorted_routes(db):
    for k in ("unicast_routes", "mpls_routes"):
        db[k] = sorted(db[k], key=lambda r: str(r.get("dest",
                                                      r.get("top_label"))))
    return db


@pytest.mark.parametrize("solver", ["cpu", "tpu"])
def test_deterministic_answers_equal_the_jax_cluster(solver):
    edges = ptopo.edges_of(ptopo.fat_tree_pod(4, 2)[0])

    async def body():
        jc = JaxCluster.from_edges(edges, solver=solver, enable_ctrl=True)
        pc = PortCluster.from_edges(edges, solver=solver, enable_ctrl=True)
        await jc.start()
        await pc.start()
        try:
            await _settled(jc)
            await _settled(pc)
            for name in ("node-0", "node-5", "node-9"):
                jcli = JaxRpcClient(port=jc.nodes[name].ctrl.port)
                pcli = RpcClient(port=pc.nodes[name].ctrl.port)
                await jcli.connect()
                await pcli.connect()
                try:
                    for method, params in (
                        ("get_my_node_name", {}),
                        ("get_initialization_status", {}),
                        ("get_route_db_computed", {}),
                        ("get_route_db_programmed", {}),
                        ("get_decision_adjacency_dbs", {}),
                        ("get_received_routes", {}),
                        ("get_spf_path", {"dst": "node-11"}),
                        ("get_spf_path", {"src": "node-3", "dst": "node-8"}),
                        ("get_interfaces", {}),
                        ("get_kvstore_peers", {}),
                        ("get_kvstore_areas", {}),
                        ("dump_kvstore", {"prefix": "adj:"}),
                        ("get_kvstore_keyvals",
                         {"keys": ["adj:node-1", "prefix:node-2"]}),
                        ("check_fib_oracle", {}),
                        ("get_rib_policy", {}),
                        ("get_advertised_prefixes", {}),
                        ("get_persist_status", {}),
                        ("persist_control", {"op": "sync"}),
                        ("fib_validate", {}),
                    ):
                        want = await jcli.call(method, params)
                        got = await pcli.call(method, params)
                        if "route_db" in method:
                            want, got = _sorted_routes(want), \
                                _sorted_routes(got)
                        assert _strip_volatile(got) == \
                            _strip_volatile(want), (name, method)
                    res = await pcli.call("check_fib_oracle", {})
                    assert res["pass"] and res["oracle_unicast"] == \
                        res["programmed_unicast"] == len(pc.nodes) - 1
                finally:
                    await jcli.close()
                    await pcli.close()
        finally:
            await jc.stop()
            await pc.stop()

    asyncio.run(body())


def test_unported_handlers_fail_loudly_and_the_rest_answer():
    async def body():
        c = PortCluster.from_edges([("a", "b")], enable_ctrl=True)
        await c.start()
        try:
            await c.wait_converged(timeout=20.0)
            cli = RpcClient(port=c.nodes["a"].ctrl.port)
            await cli.connect()
            with pytest.raises(RpcError, match="monitor/flood_trace.py"):
                await cli.call("get_flood_traces", {})
            with pytest.raises(RpcError, match="wirelock.py extract_schema"):
                await cli.call("get_wire_schema", {})
            tel = await cli.call("get_device_telemetry", {})
            assert tel["node"] == "a" and tel["shards"] == []
            led = await cli.call("get_work_ledger", {})
            assert led["stages"]
            prom = await cli.call("get_counters_prometheus", {})
            assert 'openr_counter{node="a",key="decision.spf_runs"}' in \
                prom["text"]
            conv = await cli.call("get_convergence_state", {})
            assert conv["initialized"] and conv["fib"]["converged"]
            dig = await cli.call("get_kvstore_digest", {})
            assert "adj:b" in dig["areas"]["0"]
            fr = await cli.call("get_flight_recorder", {"limit": 5})
            assert fr["node"] == "a" and len(fr["events"]) <= 5
            assert (await cli.call("work_ledger_control",
                                   {"op": "violations"}))["node"] == "a"
            assert not (await cli.call("chaos_set_drop", {}))["ok"]
            assert (await cli.call("persist_control", {"op": "sync"})) == {
                "ok": False, "error": "persistence disabled"}
            await cli.close()
        finally:
            await c.stop()

    asyncio.run(body())

"""The port's in-process emulator (`openr_tpu_torch.emulator`) on the CPU:
the cases of `tests/test_integration.py` and the emulator case of
`tests/test_aux.py` run on port clusters; a JAX cluster and a port
cluster over the same edges program equal FIBs on every node; the
`Cluster` solves on the card unless asked for the CPU; and
`python -m openr_tpu_torch.emulator --device cpu` converges while
`--soak` exits non-zero.

The reference tests build their clusters with `solver="cpu"` (its host
oracle, the default) or `solver="tpu"`. `PortCluster` maps the first
onto a port cluster whose nodes take the oracle backend
(`use_tpu_solver=False`) and the second onto the CPU twins of the card
solver (`device="cpu"`); both run with the watchdog off, which the port
does not have yet."""

import asyncio
import dataclasses
import enum
import os
import subprocess
import sys
from dataclasses import replace

import pytest
import torch

import tests.test_aux as ref_aux
import tests.test_integration as ref_integration
from openr_tpu.emulator import Cluster as JaxCluster
from openr_tpu_torch.config import WatchdogConfig
from openr_tpu_torch.emulator import cluster as pcluster
from openr_tpu_torch.types.network import IpPrefix
from openr_tpu_torch.utils import topogen as ptopo
from tests.test_torch_oracle import rebind

# multi-node cluster suites: asyncio debug mode's per-task traceback
# capture is a heavy tax at cluster scale
pytestmark = pytest.mark.asyncio_debug_off

# one intra-op thread: the suite runs several test workers at once
torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def port_transform(solver, user=None):
    """The node-config transform of a port cluster standing in for a
    reference cluster built with `solver`: the oracle backend for "cpu",
    and the watchdog off on every config (the port has none yet)."""
    def transform(ncfg):
        ncfg = replace(ncfg, watchdog=WatchdogConfig(enable=False))
        if solver == "cpu":
            ncfg = replace(ncfg, decision=replace(ncfg.decision,
                                                  use_tpu_solver=False))
        return user(ncfg) if user is not None else ncfg

    return transform


class PortCluster(pcluster.Cluster):
    """`emulator.Cluster` with the reference's `solver=` argument: "cpu"
    (the default, as in the reference) takes the port's oracle backend,
    "tpu" the card solver's CPU twins. Nothing here ever reaches CUDA."""

    @staticmethod
    def build(node_specs, link_specs, solver="cpu",
              node_config_transform=None, **kw):
        return pcluster.Cluster.build(
            node_specs, link_specs, device="cpu",
            node_config_transform=port_transform(solver,
                                                 node_config_transform),
            **kw)

    @staticmethod
    def from_edges(edges, solver="cpu", node_config_transform=None, **kw):
        return pcluster.Cluster.from_edges(
            edges, device="cpu",
            node_config_transform=port_transform(solver,
                                                 node_config_transform),
            **kw)


INTEGRATION = rebind(ref_integration, Cluster=PortCluster,
                     LinkSpec=pcluster.LinkSpec, IpPrefix=IpPrefix)


def test_every_integration_case_is_run():
    names = {k for k in vars(ref_integration) if k.startswith("test_")}
    assert names == set(INTEGRATION) and len(names) >= 6


@pytest.mark.parametrize("name", sorted(INTEGRATION))
def test_integration_case_on_the_port(name):
    INTEGRATION[name]()


def test_aux_emulator_case_on_the_port():
    from openr_tpu.emulator.cluster import scaled_spark

    rebind(ref_aux)["test_emulator_scaled_spark_timers"]()
    for n in (2, 64, 100, 125, 196):
        assert dataclasses.asdict(pcluster.scaled_spark(n)) == \
            dataclasses.asdict(scaled_spark(n))


def test_cluster_nodes_solve_where_asked(monkeypatch):
    """device=None is the card (and raises without CUDA); "cpu" the twins;
    the oracle only through the config."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        pcluster.Cluster.from_edges([("a", "b")])
    c = pcluster.Cluster.from_edges([("a", "b")], device="cpu")
    for node in c.nodes.values():
        assert node.decision.backend == "card"
        assert node.decision.solver.device.type == "cpu"
        assert not node.config.node.watchdog.enable
    c = PortCluster.from_edges([("a", "b")])
    assert all(n.decision.solver is None and n.decision.backend == "oracle"
               for n in c.nodes.values())


# ------------------------------------------- JAX cluster vs port cluster


def _plain(x):
    if isinstance(x, dict):
        return tuple(sorted((_plain(k), _plain(v)) for k, v in x.items()))
    if isinstance(x, (list, tuple)):
        return tuple(_plain(v) for v in x)
    if isinstance(x, enum.Enum):
        return int(x.value)
    if dataclasses.is_dataclass(x):
        return _plain(dataclasses.asdict(x))
    return x


def fib_canon(node):
    """A package-independent canonical form of a node's programmed FIB."""
    return (
        tuple(sorted((str(p), _plain(r))
                     for p, r in node.fib.programmed_unicast.items())),
        tuple(sorted((lbl, _plain(r))
                     for lbl, r in node.fib.programmed_mpls.items())),
    )


def _links_known(c) -> bool:
    """Every node's LSDB holds every link of the cluster, both ways: a
    cluster can program a route to every loopback while a link is still
    coming up, over other paths."""
    for n in c.nodes.values():
        ls = next(iter(n.decision.link_states.values()), None)
        if ls is None:
            return False
        for link in c.links:
            for u, v in ((link.a, link.b), (link.b, link.a)):
                db = ls.adjacency_db(u)
                if db is None or not any(a.other_node_name == v
                                         for a in db.adjacencies):
                    return False
    return True


async def _settled(c, timeout=30.0):
    await c.wait_converged(timeout=timeout)
    loop = asyncio.get_running_loop()
    deadline = loop.time() + timeout
    while True:
        if _links_known(c) and all(n.fib.pending_changes()["converged"]
               and not n.decision._pending_kvs
               and not n.decision.debounce.pending
               for n in c.nodes.values()):
            return
        assert loop.time() < deadline, "cluster did not settle"
        await asyncio.sleep(0.05)


@pytest.mark.parametrize("topo,solver", [
    ("fat_tree_pod", "tpu"),
    ("full_mesh", "cpu"),
    ("grid", "tpu"),
])
def test_jax_and_port_clusters_program_equal_fibs(topo, solver):
    """The same edges through a JAX cluster (its oracle, or TpuSpfSolver)
    and a port cluster (its oracle, or the card solver's CPU twins):
    every node's programmed FIB is equal, route for route."""
    args = {"fat_tree_pod": (4, 2), "full_mesh": (5,), "grid": (3, 3)}[topo]
    edges = ptopo.edges_of(getattr(ptopo, topo)(*args)[0])

    async def body():
        jc = JaxCluster.from_edges(edges, solver=solver)
        pc = PortCluster.from_edges(edges, solver=solver)
        await jc.start()
        await pc.start()
        try:
            await _settled(jc)
            await _settled(pc)
            n = len(pc.nodes)
            for name in sorted(pc.nodes):
                assert len(pc.nodes[name].fib.programmed_unicast) == n - 1
                assert fib_canon(pc.nodes[name]) == \
                    fib_canon(jc.nodes[name]), name
        finally:
            await jc.stop()
            await pc.stop()

    asyncio.run(body())


def test_fleet_counters_aggregate_every_node():
    async def body():
        c = PortCluster.from_edges([("a", "b"), ("b", "c")])
        await c.start()
        try:
            await c.wait_converged(timeout=20.0)
            agg = c.fleet_counters(prefix="decision.")
            assert agg["decision.spf_runs"]["nodes"] == 3
            assert agg["decision.spf_runs"]["min"] >= 1
        finally:
            await c.stop()

    asyncio.run(body())


# ----------------------------------------------------------------- CLI


def _cli(*args, timeout=120):
    env = dict(os.environ)
    env.pop("CUDA_VISIBLE_DEVICES", None)
    return subprocess.run(
        [sys.executable, "-m", "openr_tpu_torch.emulator", *args],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=timeout)


def test_cli_converges_on_the_cpu_and_refuses_the_soak():
    p = _cli("--nodes", "4", "--topo", "ring", "--device", "cpu", "--ctrl",
             "--churn", "1")
    assert p.returncode == 0, p.stderr
    assert "converged in" in p.stdout and "12 unicast routes" in p.stdout
    assert p.stdout.count("ctrl node-") == 4
    assert "churn 0: fail/heal" in p.stdout
    p = _cli("--nodes", "4", "--solver", "oracle")
    assert p.returncode == 0, p.stderr
    p = _cli("--soak")
    assert p.returncode != 0 and "emulator/soak.py" in p.stderr


def test_cli_without_cuda_exits_before_building_nodes():
    if torch.cuda.is_available():
        pytest.skip("a host with CUDA: the default device is there")
    p = _cli("--nodes", "4")
    assert p.returncode != 0 and "no CUDA device" in p.stderr
    assert "starting" not in p.stdout

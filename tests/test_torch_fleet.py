"""The port's fleet solve (`openr_tpu_torch/decision/fleet.py`) gives the
JAX package's `compute_fleet_ribs` RIBs and each node's own
`compute_routes`, exactly (mirrors tests/test_fleet.py)."""

import dataclasses

import pytest
import torch

from openr_tpu.decision.fleet import compute_fleet_ribs as jax_fleet
from openr_tpu.decision.linkstate import LinkState as JaxLinkState
from openr_tpu.decision.linkstate import PrefixState as JaxPrefixState
from openr_tpu.decision.spf_backend import TpuSpfSolver
from openr_tpu.utils import topogen as jtopo
from openr_tpu_torch import LinkState, PrefixState, TorchSpfSolver
from openr_tpu_torch.decision.fleet import compute_fleet_ribs
from openr_tpu_torch.utils import topogen as ptopo
from test_torch_solver import canon

# one intra-op thread: the suite runs several test workers at once
torch.set_num_threads(1)

TOPOS = {
    "grid": ("grid", (4, 4)),
    "fat_tree": ("fat_tree", (4,)),
    "er": ("erdos_renyi", (40,), dict(avg_degree=4, seed=9, max_metric=16)),
}


def _state(mod, ls_cls, ps_cls, gen, args, kw=None, overloaded=()):
    adj, pfx = getattr(mod, gen)(*args, **(kw or {}))
    ls, ps = ls_cls(), ps_cls()
    for db in adj:
        if db.this_node_name in overloaded:
            db = dataclasses.replace(db, is_overloaded=True)
        ls.update_adjacency_db(db)
    for db in pfx:
        ps.update_prefix_db(db)
    return ls, ps


def _both(gen, args, kw=None, overloaded=()):
    return (_state(jtopo, JaxLinkState, JaxPrefixState, gen, args, kw,
                   overloaded),
            _state(ptopo, LinkState, PrefixState, gen, args, kw, overloaded))


def _cpu():
    return TorchSpfSolver(device="cpu")


@pytest.mark.parametrize("topo", sorted(TOPOS))
def test_fleet_equals_jax_and_per_node(topo):
    (jls, jps), (pls, pps) = _both(*TOPOS[topo])
    want = jax_fleet(jls, jps)
    got = compute_fleet_ribs(pls, pps, solver=_cpu())
    assert set(got) == set(want) == set(pls.nodes)
    per_node = _cpu()
    for node in pls.nodes:
        assert canon(got[node]) == canon(want[node]), node
        assert canon(got[node]) == canon(
            per_node.compute_routes(pls, pps, node)), node


def test_fleet_with_overloads():
    over = ("node-5", "node-6")
    (jls, jps), (pls, pps) = _both("grid", (4, 4), overloaded=over)
    want = jax_fleet(jls, jps)
    got = compute_fleet_ribs(pls, pps, solver=_cpu())
    per_node = _cpu()
    for node in ("node-0", "node-5", "node-15"):
        assert canon(got[node]) == canon(want[node]), node
        assert canon(got[node]) == canon(
            per_node.compute_routes(pls, pps, node)), node


def test_fleet_subset_and_unknown():
    (jls, jps), (pls, pps) = _both("ring", (5,))
    want = jax_fleet(jls, jps, nodes=["node-1", "ghost"])
    got = compute_fleet_ribs(pls, pps, nodes=["node-1", "ghost"],
                             solver=_cpu())
    assert set(got) == set(want) == {"node-1"}
    assert canon(got["node-1"]) == canon(want["node-1"])


@pytest.mark.parametrize("chunk", [8, 16])
def test_fleet_chunked_with_repeated_roots(chunk):
    """Chunks smaller than the root count; the last chunk is filled by
    repeating roots (np.resize), each repeat in its own column."""
    (jls, jps), (pls, pps) = _both("grid", (5, 5))
    want = jax_fleet(jls, jps, chunk=chunk)
    got = compute_fleet_ribs(pls, pps, chunk=chunk, solver=_cpu())
    assert 25 % chunk  # the tail chunk repeats roots
    for node in pls.nodes:
        assert canon(got[node]) == canon(want[node]), node


@pytest.mark.parametrize("knobs", [dict(use_dense=True),
                                   dict(use_dense=False)])
def test_fleet_on_dense_and_edge_tables(knobs):
    (jls, jps), (pls, pps) = _both(*TOPOS["er"])
    want = jax_fleet(jls, jps,
                     solver=TpuSpfSolver(native_rib="off", **knobs))
    got = compute_fleet_ribs(pls, pps,
                             solver=TorchSpfSolver(device="cpu", **knobs))
    for node in pls.nodes:
        assert canon(got[node]) == canon(want[node]), node


def test_fleet_rejects_lfa_solver():
    _, (pls, pps) = _both("ring", (4,))
    with pytest.raises(ValueError, match="LFA"):
        compute_fleet_ribs(pls, pps,
                           solver=TorchSpfSolver(device="cpu",
                                                 enable_lfa=True))


def test_fleet_empty_and_all_unknown_targets():
    _, (pls, pps) = _both("ring", (4,))
    assert compute_fleet_ribs(pls, pps, nodes=[], solver=_cpu()) == {}
    assert compute_fleet_ribs(pls, pps, nodes=["no-such-node"],
                              solver=_cpu()) == {}


def test_fleet_default_solver_is_the_card(monkeypatch):
    _, (pls, pps) = _both("ring", (4,))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        compute_fleet_ribs(pls, pps)

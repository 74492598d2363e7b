"""The link-flap warm path of the port against the JAX package: the
metric-patch journal of `LinkState`, its scatter into the solver's
device tables, the warm solve `batched_sssp_split_warm_rib` and
`TorchSpfSolver.warm_compute_routes` with its fallbacks. Every
comparison is exact."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from openr_tpu.decision.linkstate import LinkState as JaxLinkState
from openr_tpu.decision.linkstate import PrefixState as JaxPrefixState
from openr_tpu import types as jtypes
from openr_tpu.decision.spf_backend import TpuSpfSolver
from openr_tpu.ops import spf_split as jsplit
from openr_tpu.utils import topogen as jtopo
from openr_tpu_torch import LinkState, PrefixState, TorchSpfSolver
from openr_tpu_torch import types as ptypes
from openr_tpu_torch.convert import csr_from_numpy, split_tables_from_numpy
from openr_tpu_torch.ops import spf_split as psplit
from openr_tpu_torch.utils import topogen as ptopo
from test_torch_solver import _states, canon
from test_torch_spf_split import _jax_args, _problem

INF = 1 << 30

# one intra-op thread: the suite runs several test workers at once
torch.set_num_threads(1)

TOPOS = {
    "grid": ("grid", (6, 5), {}),
    "wan_like": ("wan_like", (48, 7), {}),
    "overloaded": ("wan_like", (40, 2),
                   dict(overloaded=("node-1", "node-5", "node-20"))),
}


def _both(topo):
    gen, args, kw = TOPOS[topo]
    return (_states(jtopo, JaxLinkState, JaxPrefixState, gen, args, **kw),
            _states(ptopo, LinkState, PrefixState, gen, args, **kw))


def _set_metric(ls, node, k, metric):
    """Re-advertise `node`'s adjacency db with adjacency k at `metric`:
    returns update_adjacency_db_delta's (changed, pairs)."""
    db = ls.adjacency_db(node)
    adjs = list(db.adjacencies)
    adjs[k] = dataclasses.replace(adjs[k], metric=metric)
    return ls.update_adjacency_db_delta(
        dataclasses.replace(db, adjacencies=tuple(adjs))
    )


def _flaps(rng, ls, n, lo, hi, avoid=("node-0",)):
    """n random (node, adjacency index, new metric) flaps, none on a
    node in `avoid`."""
    names = sorted(x for x in ls.nodes if x not in avoid)
    out = []
    for _ in range(n):
        node = names[int(rng.integers(len(names)))]
        k = int(rng.integers(len(ls.adjacency_db(node).adjacencies)))
        out.append((node, k, int(rng.integers(lo, hi))))
    return out


def _apply(flaps, jls, pls):
    """The same flaps on both sides; returns the edge pairs of each."""
    jp, pp = set(), set()
    for node, k, m in flaps:
        jres = _set_metric(jls, node, k, m)
        pres = _set_metric(pls, node, k, m)
        assert jres == pres
        jp.update(jres[1] or ())
        pp.update(pres[1] or ())
    return jp, pp


def _csr_equal(jc, pc):
    np.testing.assert_array_equal(pc.edge_metric, jc.edge_metric)
    assert [tuple(dataclasses.astuple(p)) for p in pc.patches] == [
        tuple(dataclasses.astuple(p)) for p in jc.patches
    ]
    assert pc.edge_index == jc.edge_index
    for key in jc.edge_index:
        assert pc.details_get(*key) == jc.details_get(*key)
    assert pc.details_get(-1, -1, "none") == "none"


# --------------------------------------------------------- patch journal


@pytest.mark.parametrize("topo", sorted(TOPOS))
def test_patch_journal_equals_jax(topo):
    (jls, _), (pls, _) = _both(topo)
    rng = np.random.default_rng(3)
    jc0, pc0 = jls.to_csr(), pls.to_csr()
    _csr_equal(jc0, pc0)
    assert pc0.base_version == pc0.version and not pc0.patches
    snaps = []
    for rnd in range(4):
        _apply(_flaps(rng, pls, 3, 1, 120, avoid=()), jls, pls)
        jc, pc = jls.to_csr(), pls.to_csr()
        _csr_equal(jc, pc)
        # a metric-only change keeps the base and bumps the version
        assert pc.base_version == pc0.base_version
        assert pc.version > pc0.version
        assert (jc.base_version == jc0.base_version) is True
        assert jls.rev == pls.rev
        if rnd == 1:
            snaps.append((jls.snapshot(), pls.snapshot()))
    # a snapshot taken mid-churn keeps its own view
    js, ps_ = snaps[0]
    _csr_equal(js.to_csr(), ps_.to_csr())
    assert ps_.to_csr().base_version == pc0.base_version
    # the effective metric of every live edge is its CSR metric
    pc = pls.to_csr()
    for (u, v), idx in list(pc.edge_index.items())[:40]:
        nu, nv = pc.node_names[u], pc.node_names[v]
        assert pls.effective_metric(nu, nv) == jls.effective_metric(nu, nv)
        assert pls.effective_metric(nu, nv) == int(pc.edge_metric[idx])
    # a structural change drops the journal and mints a new base
    node = "node-3"
    for ls in (jls, pls):
        db = ls.adjacency_db(node)
        changed, pairs = ls.update_adjacency_db_delta(
            dataclasses.replace(db, is_overloaded=not db.is_overloaded)
        )
        assert changed and pairs is None
    jc, pc = jls.to_csr(), pls.to_csr()
    _csr_equal(jc, pc)
    assert pc.base_version != pc0.base_version and not pc.patches
    assert pls.delete_adjacency_db(node) and jls.delete_adjacency_db(node)
    assert not pls.delete_adjacency_db(node)
    _csr_equal(jls.to_csr(), pls.to_csr())


def test_unchanged_db_and_first_insert():
    (jls, _), (pls, _) = _both("grid")
    db = pls.adjacency_db("node-4")
    assert pls.update_adjacency_db_delta(db) == (False, [])
    assert pls.update_adjacency_db(db) is False
    ls = LinkState()
    assert ls.update_adjacency_db_delta(db) == (True, None)


# ------------------------------------------------------- patch scatter


def _fresh_tables(csr):
    return psplit.build_split_tables(
        csr.edge_src, csr.edge_dst, csr.edge_metric, csr.num_nodes
    )


def _tables_equal(dev, fresh):
    for k in ("base_nbr", "base_wgt", "ov_ids", "ov_nbr", "ov_wgt",
              "out_nbr"):
        np.testing.assert_array_equal(dev[k].numpy(), fresh[k], err_msg=k)
    assert dev["uniform_metric"] == fresh["uniform_metric"]


@pytest.mark.parametrize("topo", ["grid", "hub_and_spoke", "overloaded"])
def test_patch_scatter_equals_fresh_tables(topo):
    if topo == "hub_and_spoke":
        # hubs with more in-edges than the base width: overflow patches
        pls, _ = _states(ptopo, LinkState, PrefixState, "hub_and_spoke",
                         (3, 40))
    else:
        _, (pls, _) = _both(topo)
    solver = TorchSpfSolver(device="cpu")
    solver.solve(pls, "node-0")
    base = pls.to_csr()
    rng = np.random.default_rng(5)
    older = None
    for rnd in range(3):
        flaps = _flaps(rng, pls, 6, 1, 90, avoid=())
        if topo == "hub_and_spoke":
            # the last spoke's in-edge of its hub: an overflow column
            flaps.append(("node-42", 0, 50 + rnd))
        for flap in flaps:
            _set_metric(pls, *flap)
        csr = pls.to_csr()
        assert csr.base_version == base.base_version
        _tables_equal(solver._device_arrays(csr), _fresh_tables(csr))
        if rnd == 0:
            older = csr
    if topo == "hub_and_spoke":
        t = solver._device_arrays(pls.to_csr())
        w = t["host"]["base_w"]
        assert any(p.dense_col >= w for p in pls.to_csr().patches)
    assert solver.dev_cache_stats["uploads"] == 1
    assert solver.dev_cache_stats["patches"] == 3
    # an older snapshot than the cache cannot be patched backwards: it
    # uploads anew, and the newest one then patches forward again
    _tables_equal(solver._device_arrays(older), _fresh_tables(older))
    assert solver.dev_cache_stats["uploads"] == 2
    newest = pls.to_csr()
    _tables_equal(solver._device_arrays(newest), _fresh_tables(newest))
    assert solver.dev_cache_stats["uploads"] == 2


def test_patched_jax_csr_crosses_over_with_its_journal():
    jls, _ = _states(jtopo, JaxLinkState, JaxPrefixState, "wan_like",
                     (48, 7))

    def cross(c, base_version=None):
        return csr_from_numpy(
            num_nodes=c.num_nodes, num_edges=c.num_edges,
            edge_src=c.edge_src, edge_dst=c.edge_dst,
            edge_metric=c.edge_metric, node_overloaded=c.node_overloaded,
            node_mask=c.node_mask, node_names=c.node_names,
            adj_details=c.adj_details, adj_overrides=c.adj_overrides,
            edge_index=c.edge_index, patches=c.patches,
            base_version=base_version,
        )

    pbase = cross(jls.to_csr())
    solver = TorchSpfSolver(device="cpu")
    solver._device_arrays(pbase)
    rng = np.random.default_rng(9)
    for node, k, m in _flaps(rng, jls, 5, 1, 100):
        _set_metric(jls, node, k, m)
    jc = jls.to_csr()
    pc = cross(jc, base_version=pbase.base_version)
    _csr_equal(jc, pc)
    _tables_equal(solver._device_arrays(pc), _fresh_tables(pc))
    assert solver.dev_cache_stats == {"uploads": 1, "patches": 1, "hits": 1}


def test_split_tables_keep_host_patch_info():
    jls, _ = _states(jtopo, JaxLinkState, JaxPrefixState, "hub_and_spoke",
                     (3, 40))
    c = jls.to_csr()
    t = jsplit.build_split_tables(c.edge_src, c.edge_dst, c.edge_metric,
                                  c.num_nodes)
    dev = split_tables_from_numpy(t, c.node_overloaded, "cpu")
    assert dev["host"]["base_w"] == t["base_nbr"].shape[1]
    np.testing.assert_array_equal(dev["host"]["ov_pos"], t["ov_pos"])


# ------------------------------------------------------------ warm path


def _start(topo, enable_lfa=False):
    """Both sides of `topo` with a cold solve and its artifact each:
    [jls, jps, pls, pps, js, ps_, jr, ja, pr, pa]."""
    (jls, jps), (pls, pps) = _both(topo)
    js = TpuSpfSolver(native_rib="off")
    ps_ = TorchSpfSolver(device="cpu", enable_lfa=enable_lfa)
    jr, ja = js.compute_routes(jls, jps, "node-0", return_artifact=True)
    pr, pa = TorchSpfSolver(device="cpu").compute_routes(
        pls, pps, "node-0", return_artifact=True
    ) if enable_lfa else ps_.compute_routes(pls, pps, "node-0",
                                             return_artifact=True)
    assert canon(pr) == canon(jr)
    return [jls, jps, pls, pps, js, ps_, jr, ja, pr, pa]


def _warm_both(st, jp, pp, jdirt=(), pdirt=(), max_frac=0.5):
    jls, jps, pls, pps, js, ps_, jr, ja, pr, pa = st
    jw = js.warm_compute_routes(ja, jls, jps, "node-0", jp, set(jdirt), jr,
                                max_frac)
    pw = ps_.warm_compute_routes(pa, pls, pps, "node-0", pp, set(pdirt), pr,
                                 max_frac)
    return jw, pw


def _check_warm(jw, pw, pls, pps):
    assert jw is not None and pw is not None
    cold = TorchSpfSolver(device="cpu").compute_routes(pls, pps, "node-0")
    assert canon(pw[0]) == canon(jw[0]) == canon(cold)
    assert {p.prefix for p in pw[2]} == {p.prefix for p in jw[2]}
    assert pw[3] == jw[3]
    assert pw[4] == jw[4]
    _c, jd, jfh, jn, _ = jw[1].solved
    _c, pd, pfh, pn, _ = pw[1].solved
    np.testing.assert_array_equal(pd[:, 0], jd[:, 0])
    np.testing.assert_array_equal(pfh, jfh)
    np.testing.assert_array_equal(np.asarray(pd), np.asarray(jd))
    assert list(pn) == list(jn)


def _loopback_dirt(ps, types, node):
    """A new /16 from `node` in the same window: returns the dirt."""
    p = types.IpPrefix.make("10.99.0.0/16")
    ps.update_prefix_db(types.PrefixDatabase(
        this_node_name=node, prefix_entries=(types.PrefixEntry(prefix=p),),
    ))
    return {p}


@pytest.mark.parametrize("topo", sorted(TOPOS))
def test_warm_compute_routes_equals_jax_and_cold(topo):
    st = _start(topo)
    jls, jps, pls, pps, js, ps_ = st[:6]
    rng = np.random.default_rng(11)
    picks = [(n, k) for n, k, _m in _flaps(rng, pls, 4, 0, 1)]
    orig = {(n, k): pls.adjacency_db(n).adjacencies[k].metric
            for n, k in picks}
    rounds = {
        "raise": [(n, k, orig[(n, k)] + 25) for n, k in picks],
        "lower": [(n, k, 1) for n, k in picks],
        "revert": [(n, k, orig[(n, k)]) for n, k in picks],
        "mixed": _flaps(rng, pls, 3, 1, 60),
    }
    regions = []
    for kind in ("raise", "revert", "lower", "revert", "mixed"):
        jp, pp = _apply(rounds[kind], jls, pls)
        jdirt = pdirt = ()
        if kind == "mixed":
            jdirt = _loopback_dirt(jps, jtypes, "node-7")
            pdirt = _loopback_dirt(pps, ptypes, "node-7")
        pa = st[9]
        old_dist = pa.solved[1].device_tensor.clone()
        jw, pw = _warm_both(st, jp, pp, jdirt, pdirt)
        _check_warm(jw, pw, pls, pps)
        # aliasing: the old artifact's distances survive the warm call
        assert torch.equal(pa.solved[1].device_tensor, old_dist)
        regions.append(pw[4])
        st[6:] = [jw[0], jw[1], pw[0], pw[1]]
    # grid metrics are all 1: lowering to 1 and its revert change nothing
    assert ps_.warm_solves == js.warm_solves >= 3 and any(regions)
    assert ps_.solve_count == 1 + ps_.warm_solves
    assert ps_.dev_cache_stats["uploads"] == 1
    ws = ps_.last_warm_stats
    assert ws["host_syncs"] == ws["replays"] >= 1
    assert ws["relax_launches"] == 0  # CPU: the plain version
    assert ws["changes"] > 0
    assert min(ws["cone_walk_ms"], ws["solve_ms"], ws["assembly_ms"]) >= 0


def test_warm_reverted_within_one_window_reuses_the_solve():
    st = _start("wan_like")
    jls, jps, pls, pps, js, ps_ = st[:6]
    node, k = "node-9", 0
    m0 = pls.adjacency_db(node).adjacencies[k].metric
    jp, pp = _apply([(node, k, m0 + 7), (node, k, m0)], jls, pls)
    jdirt = _loopback_dirt(jps, jtypes, "node-7")
    pdirt = _loopback_dirt(pps, ptypes, "node-7")
    jw, pw = _warm_both(st, jp, pp, jdirt, pdirt)
    _check_warm(jw, pw, pls, pps)
    assert pw[4] == 0 and ps_.warm_solves == 0
    assert pw[1].solved[1] is st[9].solved[1]


@pytest.mark.parametrize("case", [
    "root_incident", "structural", "unknown_endpoint", "above_max_frac",
    "lfa",
])
def test_warm_fallbacks_return_none_on_both(case):
    st = _start("wan_like", enable_lfa=case == "lfa")
    jls, jps, pls, pps, js, ps_ = st[:6]
    rng = np.random.default_rng(2)
    max_frac = 0.5
    if case == "root_incident":
        jp, pp = _apply([("node-0", 0, 77)], jls, pls)
    elif case == "structural":
        jp, pp = _apply(_flaps(rng, pls, 2, 1, 60), jls, pls)
        for ls in (jls, pls):
            db = ls.adjacency_db("node-11")
            ls.update_adjacency_db(
                dataclasses.replace(db, is_overloaded=True)
            )
    elif case == "unknown_endpoint":
        jp, pp = _apply(_flaps(rng, pls, 2, 1, 60), jls, pls)
        jp = pp = set(pp) | {("node-999", "node-1")}
    elif case == "above_max_frac":
        # more distinct changed edges than max(16, max_frac * E)
        flaps = [(n, k, 200 + i) for i, (n, k, _m) in
                 enumerate(_flaps(rng, pls, 60, 0, 1))]
        jp, pp = _apply(flaps, jls, pls)
        assert len(pp) > 16
        max_frac = 0.0
    else:
        jp, pp = _apply(_flaps(rng, pls, 2, 1, 60), jls, pls)
        st[4] = TpuSpfSolver(native_rib="off", enable_lfa=True)
    jw, pw = _warm_both(st, jp, pp, max_frac=max_frac)
    assert jw is None and pw is None


def test_warm_cone_over_budget_returns_none_on_both():
    st = _start("grid")
    jls, jps, pls, pps, js, ps_, jr, ja, pr, pa = st
    jcsr, jdist = ja.solved[0], np.asarray(ja.solved[1])
    pcsr, pdist = pa.solved[0], np.asarray(pa.solved[1])
    # raise a tight edge next to the root's first neighbor
    nbr = pa.solved[3][0]
    nxt = next(v for (u, v) in pcsr.edge_index if u == nbr and v != 0)
    changes = [(nbr, nxt, 1, 9)]
    roots = [0, *pa.solved[3]]
    assert js._warm_cone(jcsr, jdist, changes, roots, 10**6) is not None
    assert ps_._warm_cone(pcsr, pdist, changes, roots, 10**6) is not None
    assert js._warm_cone(jcsr, jdist, changes, roots, 0) is None
    assert ps_._warm_cone(pcsr, pdist, changes, roots, 0) is None
    jc = js._warm_cone(jcsr, jdist, changes, roots, 10**6)
    pc = ps_._warm_cone(pcsr, pdist, changes, roots, 10**6)
    assert sorted(zip(jc[0], jc[1])) == sorted(zip(pc[0], pc[1]))
    np.testing.assert_array_equal(pc[2], jc[2])
    assert pc[3] == jc[3]


# ------------------------------------------------------------- kernel D


KERNEL_D = {
    # name: (problem kwargs, warm kwargs)
    "plain": (dict(n=1500, deg=8, mw=16, seed=0), {}),
    "overloads": (dict(n=1500, deg=8, mw=16, seed=1, frac_over=0.1),
                  dict(has_overloads=True)),
    "entry_spill": (dict(n=1200, deg=6, mw=32, seed=2), dict(tail_cap=16)),
    "round_cap": (dict(n=1200, deg=6, mw=32, seed=2),
                  dict(tail_rounds_cap=1)),
    "gs4": (dict(n=8000, deg=6, mw=16, seed=5), dict(gs_chunks=4)),
}


@pytest.mark.parametrize("case", sorted(KERNEL_D))
def test_warm_rib_kernel_equals_jax(case):
    prob, kw = KERNEL_D[case]
    t, over, roots, nbr_metric, nbr_ids, nbr_over = _problem(**prob)
    has_over = kw.get("has_overloads", False)
    jargs = _jax_args(t, over, roots)
    cold = np.asarray(jsplit.batched_sssp_split(*jargs,
                                                has_overloads=has_over))
    vp, b = cold.shape
    rng = np.random.default_rng(prob["seed"] + 7)
    # a hand-built cone: random cells set to INF (never a root's own
    # zero), plus lowered weights on a few table slots with their heads
    # seeded; everything else keeps its old, exact value
    t = dict(t)
    t["base_wgt"] = t["base_wgt"].copy()
    live = np.argwhere(t["base_wgt"] < INF)
    pick = live[rng.choice(len(live), 12, replace=False)]
    for r, c in pick:
        t["base_wgt"][r, c] = max(1, t["base_wgt"][r, c] // 3)
    seed = np.zeros(vp, bool)
    seed[pick[:, 0]] = True
    cone = rng.random((vp, b)) < 0.05
    cone[roots, np.arange(b)] = False
    cone[vp - 1] = False
    dist0 = np.where(cone, INF, cold).astype(np.int32)
    seed |= cone.any(axis=1)
    jargs = _jax_args(t, over, roots)
    jd, jbuf = jsplit.batched_sssp_split_warm_rib(
        *jargs, jnp.asarray(nbr_metric), jnp.asarray(nbr_ids),
        jnp.asarray(nbr_over), jnp.asarray(dist0), jnp.asarray(seed), **kw,
    )
    tables = split_tables_from_numpy(t, over, "cpu")
    stats = {}
    pd, pbuf = psplit.batched_sssp_split_warm_rib(
        tables, torch.from_numpy(roots), torch.from_numpy(nbr_metric),
        torch.from_numpy(nbr_ids), torch.from_numpy(nbr_over),
        torch.from_numpy(dist0.copy()), torch.from_numpy(seed),
        stats=stats, **kw,
    )
    np.testing.assert_array_equal(pd.numpy(), np.asarray(jd))
    np.testing.assert_array_equal(pbuf.numpy(), np.asarray(jbuf))
    # the same fixpoint as a cold solve on the new tables
    cold2 = psplit.batched_sssp_split(tables, torch.from_numpy(roots),
                                      has_overloads=has_over)
    np.testing.assert_array_equal(pd.numpy(), cold2.numpy())
    if case == "entry_spill":
        assert stats["spilled"] and stats["tail_rounds"] == 0
    if case == "round_cap":
        assert stats["tail_rounds"] == 1 and stats["sweeps"] > 0
    if case == "plain":
        assert stats["tail_rounds"] > 0 and not stats["spilled"]

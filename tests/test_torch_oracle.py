"""The port's host oracle (`openr_tpu_torch.decision.oracle`) held exact
against the JAX package's `openr_tpu.decision.oracle` on the CPU: every
case of `tests/test_oracle.py` run on the port's classes, and
`compute_routes` route for route on every topology family with and
without overloads, UCMP weights, anycast, SR-MPLS, KSP2_ED_ECMP with
`ksp_k` and LFA, in both the vectorised and the scalar election;
`warm_compute_routes` after seeded metric flaps and after
`drop_warm_state`; and the oracle against `TorchSpfSolver(device="cpu")`
on the same states."""

import builtins
import contextlib
import dataclasses
import functools
import types

import numpy as np
import pytest
import torch

import openr_tpu.decision.oracle as joracle
import openr_tpu_torch.types as ptypes
import tests.test_oracle as ref_oracle_tests
from openr_tpu_torch import LinkState, PrefixState, TorchSpfSolver
from openr_tpu_torch.decision import oracle as poracle
from openr_tpu_torch.utils import topogen as ptopo
from tests.test_torch_routes import (
    JAX,
    KSP_UCMP_CASES,
    PORT,
    SQUARE,
    _lfa_case,
    bench_case,
    canon,
    states,
)
from tests.test_torch_warm import _flaps, _set_metric

# one intra-op thread: the suite runs several test workers at once
torch.set_num_threads(1)


@contextlib.contextmanager
def port_imports():
    """While open, `import openr_tpu.x` / `from openr_tpu.x import y`
    statements (those inside a reference test's body) import the port's
    `openr_tpu_torch.x` instead."""
    real = builtins.__import__

    def imp(name, globals=None, locals=None, fromlist=(), level=0):
        if level == 0 and (name == "openr_tpu"
                           or name.startswith("openr_tpu.")):
            name = "openr_tpu_torch" + name[len("openr_tpu"):]
        return real(name, globals, locals, fromlist, level)

    builtins.__import__ = imp
    try:
        yield
    finally:
        builtins.__import__ = real


def rebind(module, **names):
    """The `test_*` functions of a reference test module, each with a copy
    of the module's globals in which `names` replace the reference's
    (the helpers of the module are rebound to the same copy), run under
    `port_imports`, so the same test body runs on the port's classes."""
    g = dict(vars(module))
    g.update(names)
    for k, v in list(g.items()):
        if (isinstance(v, types.FunctionType)
                and v.__module__ == module.__name__):
            f = types.FunctionType(v.__code__, g, v.__name__, v.__defaults__,
                                   v.__closure__)
            f.__kwdefaults__ = v.__kwdefaults__
            g[k] = f

    def under_port_imports(f):
        @functools.wraps(f)
        def run(*a, **k):
            with port_imports():
                return f(*a, **k)

        return run

    return {k: under_port_imports(v) for k, v in g.items()
            if k.startswith("test_") and isinstance(v, types.FunctionType)}


PORT_ORACLE_CASES = rebind(
    ref_oracle_tests,
    LinkState=LinkState, PrefixState=PrefixState,
    compute_routes=poracle.compute_routes, metric_key=poracle.metric_key,
    run_spf=poracle.run_spf, IpPrefix=ptypes.IpPrefix,
    MplsActionType=ptypes.MplsActionType, Adjacency=ptypes.Adjacency,
    AdjacencyDatabase=ptypes.AdjacencyDatabase,
    PrefixDatabase=ptypes.PrefixDatabase, PrefixEntry=ptypes.PrefixEntry,
    PrefixMetrics=ptypes.PrefixMetrics, topogen=ptopo,
)


def test_every_reference_oracle_case_is_run():
    names = {k for k in vars(ref_oracle_tests) if k.startswith("test_")}
    assert names == set(PORT_ORACLE_CASES) and len(names) >= 12


@pytest.mark.parametrize("name", sorted(PORT_ORACLE_CASES))
def test_reference_oracle_case_on_the_port(name):
    PORT_ORACLE_CASES[name]()


# ------------------------------------------------ compute_routes parity


def _family(gen, *args, overloaded=(), anycast=False, ucmp=False):
    """A case(pkg) of `gen(*args)`'s loopbacks, with `overloaded` nodes
    drained, and optionally an anycast /24 from three nodes (UCMP weights
    on with `ucmp`), so the election has multi-advertiser prefixes."""
    def case(pkg):
        adj, pfx = getattr(pkg.topo, gen)(*args)
        adj = [dataclasses.replace(db, is_overloaded=True)
               if db.this_node_name in overloaded else db for db in adj]
        pfx = list(pfx)
        if anycast:
            t = pkg.t
            p = t.IpPrefix.make("192.168.7.0/24")
            names = [db.this_node_name for db in adj]
            for i, n in enumerate((names[1], names[len(names) // 2],
                                   names[-1])):
                pfx.append(t.PrefixDatabase(
                    this_node_name=n,
                    prefix_entries=(t.PrefixEntry(
                        prefix=p, weight=(i + 1) * 2 if ucmp else 0),),
                ))
        return adj, pfx

    return case


FAMILIES = {
    "ring": (_family("ring", 9), ["node-0", "node-4"]),
    "grid": (_family("grid", 5, 4), ["node-0", "node-7"]),
    "fat_tree4": (_family("fat_tree", 4), ["node-0", "node-5", "node-19"]),
    "wan_like": (_family("wan_like", 40, 3), ["node-0", "node-3"]),
    "hub_and_spoke": (_family("hub_and_spoke", 3, 20), ["node-0", "node-9"]),
    "full_mesh": (_family("full_mesh", 7), ["node-0", "node-6"]),
    "backbone": (bench_case(rings=4, ring_size=6), ["bb0", "bb7"]),
    "overloaded": (_family("wan_like", 40, 2,
                           overloaded=("node-1", "node-5", "node-20")),
                   ["node-0", "node-5"]),
    "anycast": (_family("grid", 4, 4, anycast=True), ["node-0", "node-5"]),
    "ucmp_anycast": (_family("fat_tree", 4, anycast=True, ucmp=True),
                     ["node-0", "node-12"]),
}


def _both_oracles(case, roots, **kw):
    jls, jps = states(JAX, case)
    pls, pps = states(PORT, case)
    out = []
    for me in roots:
        ref = joracle.compute_routes(jls, jps, me, **kw)
        got = poracle.compute_routes(pls, pps, me, **kw)
        assert canon(got) == canon(ref), me
        # route for route, not only by counts: the nexthop order and the
        # backup choice are part of the entry
        for p, e in ref.unicast_routes.items():
            g = got.unicast_routes[ptypes.IpPrefix(prefix=p.prefix)]
            assert [nh.if_name for nh in g.nexthops] == \
                [nh.if_name for nh in e.nexthops], (me, p)
            assert g.best_nodes == e.best_nodes
        out.append((got, pls, pps))
    return out


@pytest.mark.parametrize("vectorize", [True, False])
@pytest.mark.parametrize("lfa", [False, True])
@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_compute_routes_equals_jax_oracle(family, lfa, vectorize):
    case, roots = FAMILIES[family]
    out = _both_oracles(case, roots, enable_lfa=lfa, vectorize=vectorize)
    assert all(len(got.unicast_routes) > 0 for got, _l, _p in out)
    if lfa and family in ("ring", "wan_like"):
        assert any(e.backup_nexthops for got, _l, _p in out
                   for e in got.unicast_routes.values())


@pytest.mark.parametrize("name", sorted(KSP_UCMP_CASES))
def test_ksp_ucmp_cases_equal_jax_oracle(name):
    case, roots, kw = KSP_UCMP_CASES[name]
    for lfa in (False, True):
        _both_oracles(case, roots, enable_lfa=lfa, **kw)


def test_ksp_backbone_with_k16_and_lfa_equals_jax_oracle():
    ((got, _l, _p),) = _both_oracles(bench_case(rings=4, ring_size=8),
                                     ["bb1"], enable_lfa=True, ksp_k=16)
    ksp = [e for e in got.unicast_routes.values()
           if e.best_entry.forwarding_algorithm
           == ptypes.ForwardingAlgorithm.KSP2_ED_ECMP]
    assert ksp and any(len(e.nexthops) > 1 for e in ksp)
    assert any(nh.mpls_action is not None for e in ksp for nh in e.nexthops)


@pytest.mark.parametrize("over", [None, "b", "a"])
def test_lfa_square_equals_jax_oracle(over):
    spec = [(n, a, n == over) for n, a, _o in SQUARE]
    ((got, _l, _p),) = _both_oracles(
        _lfa_case(spec, {"d": "10.0.0.4/32", "b": "10.0.0.2/32"}), ["s"],
        enable_lfa=True)
    if over is None:
        e = got.unicast_routes[ptypes.IpPrefix.make("10.0.0.4/32")]
        assert [(nh.address, nh.metric) for nh in e.backup_nexthops] == \
            [("b", 3)]


def test_ramp_anycast_equals_jax_oracle():
    """`ramp_prefix_state` anycast pairs through the vectorised election
    and the scalar loop on both packages."""
    from openr_tpu.utils import topogen as jtopo

    jls, _ = states(JAX, _family("grid", 5, 5))
    pls, _ = states(PORT, _family("grid", 5, 5))
    names = sorted(pls.nodes)
    jps = jtopo.ramp_prefix_state(names, 300, anycast_every=3)
    pps = ptopo.ramp_prefix_state(names, 300, anycast_every=3)
    for vectorize in (True, False):
        ref = joracle.compute_routes(jls, jps, "node-0", vectorize=vectorize)
        got = poracle.compute_routes(pls, pps, "node-0", vectorize=vectorize)
        assert len(got.unicast_routes) == 300
        assert canon(got) == canon(ref)
    assert sum(len(e.best_nodes) == 2 for e in got.unicast_routes.values()) \
        == 100


def test_vectorised_election_interns_groups_and_scalar_does_not():
    pls, pps = states(PORT, _family("fat_tree", 4, anycast=True))
    rv, av = poracle.compute_routes(pls, pps, "node-0", return_artifact=True)
    rs, as_ = poracle.compute_routes(pls, pps, "node-0", vectorize=False,
                                     return_artifact=True)
    assert canon(rv) == canon(rs)
    assert av.nh_intern is not None and len(av.nh_intern) > 0
    assert as_.nh_intern is None
    assert all(type(e.nexthops) is tuple for e in rs.unicast_routes.values())


def test_missing_root_returns_empty_and_no_artifact():
    pls, pps = states(PORT, _family("ring", 4))
    rdb, art = poracle.compute_routes(pls, pps, "nobody",
                                      return_artifact=True)
    assert art is None and not rdb.unicast_routes and not rdb.mpls_routes


@pytest.mark.parametrize("family", ["grid", "fat_tree4", "wan_like",
                                    "overloaded", "anycast", "backbone"])
def test_oracle_equals_card_solver_twins(family):
    """The two engines of the port on the same states: the oracle and
    `TorchSpfSolver(device="cpu")`, with and without LFA."""
    case, roots = FAMILIES[family]
    pls, pps = states(PORT, case)
    for lfa in (False, True):
        solver = TorchSpfSolver(device="cpu", enable_lfa=lfa)
        for me in roots:
            got = poracle.compute_routes(pls, pps, me, enable_lfa=lfa)
            assert canon(got) == canon(solver.compute_routes(pls, pps, me))


def test_assemble_prefix_routes_equals_jax_oracle():
    case, roots = FAMILIES["anycast"]
    jls, jps = states(JAX, case)
    pls, pps = states(PORT, case)
    _r, ja = joracle.compute_routes(jls, jps, "node-0", return_artifact=True)
    _r, pa = poracle.compute_routes(pls, pps, "node-0", return_artifact=True)
    jp = set(list(jps.prefixes)[::2])
    pp = {ptypes.IpPrefix(prefix=p.prefix) for p in jp}
    ref = joracle.assemble_prefix_routes(ja, jps, jp)
    got = poracle.assemble_prefix_routes(pa, pps, pp)
    assert canon(types.SimpleNamespace(unicast_routes=got, mpls_routes={})) \
        == canon(types.SimpleNamespace(unicast_routes=ref, mpls_routes={}))


# ------------------------------------------------------------ warm path


def _warm_start(family):
    case, _roots = FAMILIES[family]
    jls, jps = states(JAX, case)
    pls, pps = states(PORT, case)
    jr, ja = joracle.compute_routes(jls, jps, "node-0", return_artifact=True)
    pr, pa = poracle.compute_routes(pls, pps, "node-0", return_artifact=True)
    assert canon(pr) == canon(jr)
    return [jls, jps, pls, pps, jr, ja, pr, pa]


def _warm_round(st, flaps, max_frac=0.5):
    jls, jps, pls, pps, jr, ja, pr, pa = st
    jp, pp = set(), set()
    for node, k, m in flaps:
        jres = _set_metric(jls, node, k, m)
        pres = _set_metric(pls, node, k, m)
        assert jres == pres
        jp.update(jres[1] or ())
        pp.update(pres[1] or ())
    jw = joracle.warm_compute_routes(ja, jls, jps, "node-0", jp, set(), jr,
                                     max_frac)
    pw = poracle.warm_compute_routes(pa, pls, pps, "node-0", pp, set(), pr,
                                     max_frac)
    return jw, pw


@pytest.mark.parametrize("family", ["grid", "wan_like", "overloaded",
                                    "fat_tree4", "anycast"])
def test_warm_compute_routes_equals_jax_oracle_and_cold(family):
    st = _warm_start(family)
    pls = st[2]
    rng = np.random.default_rng(22)
    warm = 0
    for rnd in range(6):
        flaps = _flaps(rng, pls, 1 + rnd % 3, 1, 40)
        jw, pw = _warm_round(st, flaps)
        assert (jw is None) == (pw is None), rnd
        if pw is None:
            jr, ja = joracle.compute_routes(st[0], st[1], "node-0",
                                            return_artifact=True)
            pr, pa = poracle.compute_routes(st[2], st[3], "node-0",
                                            return_artifact=True)
            st[4:] = [jr, ja, pr, pa]
            continue
        warm += 1
        cold = poracle.compute_routes(st[2], st[3], "node-0")
        assert canon(pw[0]) == canon(jw[0]) == canon(cold), rnd
        assert {p.prefix for p in pw[2]} == {p.prefix for p in jw[2]}
        assert pw[3] == jw[3] and pw[4] == jw[4]
        assert pw[1].spf.dist == jw[1].spf.dist
        assert pw[1].spf.first_hops == jw[1].spf.first_hops
        assert pw[1].spf.preds == jw[1].spf.preds
        st[4:] = [jw[0], jw[1], pw[0], pw[1]]
    assert warm >= 3


def test_warm_after_drop_warm_state_falls_back_then_recovers():
    st = _warm_start("wan_like")
    rng = np.random.default_rng(5)
    jw, pw = _warm_round(st, _flaps(rng, st[2], 2, 1, 30))
    assert jw is not None and pw is not None
    st[4:] = [jw[0], jw[1], pw[0], pw[1]]
    assert pw[1].warm_state_bytes() > 0
    assert pw[1].warm_state_bytes() == jw[1].warm_state_bytes()
    st[5].drop_warm_state()
    st[7].drop_warm_state()
    assert st[7].radj is None and st[7].spf.preds is None
    assert st[7].warm_state_bytes() == 0 == st[5].warm_state_bytes()
    # preds gone: both demand the full solve
    jw, pw = _warm_round(st, _flaps(rng, st[2], 1, 1, 30))
    assert jw is None and pw is None
    # ... and the prefix-only path still runs off the trimmed artifact
    p = next(iter(st[3].prefixes))
    jp = next(q for q in st[1].prefixes if q.prefix == p.prefix)
    got = poracle.assemble_prefix_routes(st[7], st[3], {p})
    ref = joracle.assemble_prefix_routes(st[5], st[1], {jp})
    assert set(q.prefix for q in got) == set(q.prefix for q in ref)
    # a fresh full solve mints a warm-capable artifact again
    pr, pa = poracle.compute_routes(st[2], st[3], "node-0",
                                    return_artifact=True)
    jr, ja = joracle.compute_routes(st[0], st[1], "node-0",
                                    return_artifact=True)
    st[4:] = [jr, ja, pr, pa]
    jw, pw = _warm_round(st, _flaps(rng, st[2], 2, 1, 30))
    assert pw is not None and canon(pw[0]) == canon(jw[0])


def test_resolve_metric_changes_reads_the_adjacency_and_bails_on_structure():
    st = _warm_start("grid")
    pls, pa = st[2], st[7]
    _ch, pairs = _set_metric(pls, "node-6", 0, 9)
    _set_metric(st[0], "node-6", 0, 9)
    got = poracle.resolve_metric_changes(pa, pls, pairs)
    ref = joracle.resolve_metric_changes(st[5], st[0], pairs)
    assert got == ref and len(got) >= 1 and all(c[3] == 9 for c in got)
    # an overloaded adjacency makes the edge vanish: not metric-only
    db = pls.adjacency_db("node-6")
    a0 = dataclasses.replace(db.adjacencies[0], is_overloaded=True)
    _ch, pairs2 = pls.update_adjacency_db_delta(dataclasses.replace(
        db, adjacencies=(a0,) + tuple(db.adjacencies[1:])))
    assert poracle.resolve_metric_changes(pa, pls, pairs) is None


def test_warm_declines_like_the_reference():
    """LFA artifacts, root-incident flaps and oversize delta sets take the
    full path on both packages."""
    case, _ = FAMILIES["grid"]
    for kw, node, k in (({"enable_lfa": True}, "node-7", 0),
                        ({}, "node-0", 0)):
        jls, jps = states(JAX, case)
        pls, pps = states(PORT, case)
        jr, ja = joracle.compute_routes(jls, jps, "node-0",
                                        return_artifact=True, **kw)
        pr, pa = poracle.compute_routes(pls, pps, "node-0",
                                        return_artifact=True, **kw)
        jp = _set_metric(jls, node, k, 7)[1]
        pp = _set_metric(pls, node, k, 7)[1]
        assert joracle.warm_compute_routes(ja, jls, jps, "node-0", jp,
                                           set(), jr, 0.5) is None
        assert poracle.warm_compute_routes(pa, pls, pps, "node-0", pp,
                                           set(), pr, 0.5) is None

"""The port's multi-advertiser election equals the JAX package's: the
NumPy half (`elect_multi_np`, `iter_multi_winners`, `multi_items`) on
random tables with empty and all-ineligible segments, the plain version
of `elect_seg_kernel` (`elect_seg_ref`) and the port's
`elect_multi_device` on the CPU against JAX's `_elect_seg` /
`elect_multi_device`, and a solver that routes the election through the
device path against `TpuSpfSolver(native_rib="off")`."""

import dataclasses
import enum

import numpy as np
import pytest
import torch

from openr_tpu.decision import election as jel
from openr_tpu.decision.linkstate import LinkState as JaxLinkState
from openr_tpu.decision.linkstate import PrefixState as JaxPrefixState
from openr_tpu.decision.spf_backend import TpuSpfSolver
from openr_tpu.ops.election import _elect_seg
from openr_tpu.ops.election import elect_multi_device as jax_elect_device
from openr_tpu.utils import topogen as jtopo
from openr_tpu_torch import LinkState, PrefixState, TorchSpfSolver
from openr_tpu_torch.decision import election as pel
from openr_tpu_torch.ops import election as pops
from openr_tpu_torch.utils import topogen as ptopo

INF = 1 << 30
MAX_SEGMENTS = 64  # above the prefix count of every random table

# one intra-op thread: the suite runs several test workers at once
torch.set_num_threads(1)


def _tables(rng, trial, empty=False, inelig=False):
    """One random multi table in both packages' classes (the generator of
    `tests/test_prefix_scale.py`), and d_vec, reach, my_id."""
    m = int(rng.integers(1, 40))
    counts = rng.integers(1, 6, m)
    if empty:  # empty segments, never the last one
        counts[rng.random(m) < 0.3] = 0
        counts[-1] = max(counts[-1], 1)
    indptr = np.concatenate(([0], np.cumsum(counts))).astype(np.int64)
    s = int(indptr[-1])
    fields = dict(
        prefixes=[f"p{i}" for i in range(m)],
        indptr=indptr,
        seg=np.repeat(np.arange(m, dtype=np.int64), counts),
        adv=rng.integers(0, 30, s).astype(np.int64),
        known=rng.random(s) < 0.9,
        rank=rng.integers(0, 8, s).astype(np.int64),
        entries=[f"e{i}" for i in range(s)],
        names=[f"n{i}" for i in range(s)],
    )
    d_vec = np.where(
        rng.random(32) < 0.8, rng.integers(1, 100, 32), INF
    ).astype(np.int64)
    reach = (d_vec < INF) & (rng.random(32) < 0.9)
    if inelig:
        reach[:] = False
    my_id = int(rng.integers(0, 30))
    if inelig:
        my_id = 31  # advertises nothing: every slot ineligible
    return (jel.MultiTable(**fields), pel.MultiTable(**fields), d_vec, reach,
            my_id)


CASES = [(t, False, False) for t in range(5)] + [
    (5, True, False), (6, True, False), (7, False, True), (8, True, True),
]


def _fields_equal(a, b, tag):
    for f in ("survive", "local", "is_best", "chosen"):
        np.testing.assert_array_equal(getattr(a, f), getattr(b, f), err_msg=f"{tag} {f}")
    sel = a.survive
    np.testing.assert_array_equal(a.min_igp[sel], b.min_igp[sel], err_msg=tag)


@pytest.mark.parametrize("trial,empty,inelig", CASES)
def test_numpy_election_equals_jax(trial, empty, inelig):
    rng = np.random.default_rng(3 + 100 * trial)
    jt, pt, d_vec, reach, my_id = _tables(rng, trial, empty, inelig)
    ja = jel.elect_multi_np(jt, d_vec, reach, my_id)
    pa = pel.elect_multi_np(pt, d_vec, reach, my_id)
    for f in ("survive", "local", "is_best", "chosen", "min_igp"):
        np.testing.assert_array_equal(getattr(pa, f), getattr(ja, f))
    if inelig:
        assert not pa.survive.any()

    def rows(it):
        return [(p, b, [int(x) for x in c], cn, i, e)
                for p, b, c, cn, i, e in it]

    assert rows(pel.iter_multi_winners(pt, pa)) == rows(
        jel.iter_multi_winners(jt, ja)
    )
    assert pel.multi_items(pt) == jel.multi_items(jt)


def _t(a, dt):
    return torch.from_numpy(np.ascontiguousarray(a, dtype=dt))


@pytest.mark.parametrize("trial,empty,inelig", CASES)
def test_elect_seg_ref_equals_jax_elect_seg(trial, empty, inelig):
    """Every output of the kernel's plain version, empty segments'
    identities included, equals JAX's `_elect_seg`."""
    rng = np.random.default_rng(3 + 100 * trial)
    jt, pt, d_vec, reach, my_id = _tables(rng, trial, empty, inelig)
    m = len(pt.prefixes)
    # one segment count for every table (one XLA compile): segments past
    # m are empty and are cut off below
    ref = _elect_seg(
        jt.seg.astype(np.int32), jt.adv.astype(np.int32), jt.known,
        jt.rank.astype(np.int32), d_vec.astype(np.int32), reach,
        np.int32(my_id), num_segments=MAX_SEGMENTS,
    )
    got = pops.elect_seg(
        _t(pt.indptr, np.int32), _t(pt.seg, np.int32), _t(pt.adv, np.int32),
        _t(pt.known, bool), _t(pt.rank, np.int32), _t(d_vec, np.int32),
        _t(reach, bool), my_id,
    )
    for name, g, r, cut in zip(
        ("best_r", "min_igp", "is_best", "chosen", "local"), got, ref,
        (m, m, None, None, m),
    ):
        np.testing.assert_array_equal(g.numpy(), np.asarray(r)[:cut],
                                      err_msg=name)


@pytest.mark.parametrize("inelig", [False, True])
def test_elect_seg_ref_equals_jax_on_long_and_empty_segments(inelig):
    """Segments of 0, 1, 2, 31, 32, 33 and 300 slots mixed in one table
    (the lengths on each side of a warp, and a prefix with hundreds of
    advertisers): the plain version equals JAX's `_elect_seg`."""
    rng = np.random.default_rng(77 + inelig)
    lengths = np.array([0, 1, 2, 31, 32, 33, 300, 2, 0, 33, 1, 300, 2, 0])
    m, s = len(lengths), int(lengths.sum())
    indptr = np.concatenate(([0], np.cumsum(lengths))).astype(np.int32)
    seg = np.repeat(np.arange(m), lengths).astype(np.int32)
    n_nodes = 64
    adv = rng.integers(0, n_nodes, s).astype(np.int32)
    known = rng.random(s) < 0.9
    rank = rng.integers(0, 4, s).astype(np.int32)  # many rank ties
    d_vec = np.where(rng.random(n_nodes) < 0.8,
                     rng.integers(1, 20, n_nodes), INF).astype(np.int32)
    reach = (d_vec < INF) & (rng.random(n_nodes) < 0.9)
    if inelig:
        reach[:] = False
    my_id = int(adv[indptr[6]])  # an advertiser of the 300-slot segment
    ref = _elect_seg(seg, adv, known, rank, d_vec, reach, np.int32(my_id),
                     num_segments=MAX_SEGMENTS)
    got = pops.elect_seg(
        _t(indptr, np.int32), _t(seg, np.int32), _t(adv, np.int32),
        _t(known, bool), _t(rank, np.int32), _t(d_vec, np.int32),
        _t(reach, bool), my_id,
    )
    for name, g, r, cut in zip(
        ("best_r", "min_igp", "is_best", "chosen", "local"), got, ref,
        (m, m, None, None, m),
    ):
        np.testing.assert_array_equal(g.numpy(), np.asarray(r)[:cut],
                                      err_msg=name)
    assert bool(got[4].any())  # this node's own slot wins somewhere
    assert int(got[0][0]) == -(1 << 31) and int(got[1][0]) == (1 << 31) - 1


@pytest.mark.parametrize("trial", range(5))
def test_elect_multi_device_equals_jax(trial):
    rng = np.random.default_rng(3 + 100 * trial)
    jt, pt, d_vec, reach, my_id = _tables(rng, trial)
    ref = jax_elect_device(jt, d_vec, reach, my_id, dev_cache={},
                           gen=("t", trial))
    cache: dict = {}
    launches = pops.LAUNCHES
    got = pops.elect_multi_device(pt, d_vec, reach, my_id, cache,
                                  ("t", trial), torch.device("cpu"))
    _fields_equal(ref, got, f"trial {trial}")
    assert got.min_igp.dtype == np.int64
    assert list(cache) == [("t", trial)]
    assert pops.LAUNCHES == launches  # CPU: the plain version, no kernel
    # and the NumPy path
    _fields_equal(pel.elect_multi_np(pt, d_vec, reach, my_id), got, "np")


@pytest.mark.parametrize("trial", range(3))
def test_elect_multi_device_takes_device_vectors(trial):
    """Distance and reach vectors already on the device give the NumPy
    inputs' election; a result buffer of the wrong size is refused."""
    rng = np.random.default_rng(7 + 100 * trial)
    _jt, pt, d_vec, reach, my_id = _tables(rng, trial, empty=trial == 2)
    want = pel.elect_multi_np(pt, d_vec, reach, my_id)
    got = pops.elect_multi_device(pt, _t(d_vec, np.int32), _t(reach, bool),
                                  my_id, {}, ("v", trial), torch.device("cpu"))
    _fields_equal(want, got, f"trial {trial}")
    args = (_t(pt.indptr, np.int32), _t(pt.seg, np.int32),
            _t(pt.adv, np.int32), _t(pt.known, bool), _t(pt.rank, np.int32),
            _t(d_vec, np.int32), _t(reach, bool), my_id)
    m, s = len(pt.prefixes), len(pt.adv)
    assert pops.out_nbytes(m, s) == 9 * m + 2 * s
    with pytest.raises(ValueError, match="out must be"):
        pops.elect_seg(*args, out=torch.empty(pops.out_nbytes(m, s) + 1,
                                              dtype=torch.uint8))


def _plain(x):
    if isinstance(x, dict):
        return tuple(sorted((_plain(k), _plain(v)) for k, v in x.items()))
    if isinstance(x, (list, tuple)):
        return tuple(_plain(v) for v in x)
    if isinstance(x, enum.Enum):
        return int(x.value)
    return x


def _canon(rdb):
    return (
        tuple(sorted((p.prefix, _plain(dataclasses.asdict(e)))
                     for p, e in rdb.unicast_routes.items())),
        tuple(sorted((lbl, _plain(dataclasses.asdict(e)))
                     for lbl, e in rdb.mpls_routes.items())),
    )


def _anycast_states(mod, types, ls_cls, ps_cls):
    """grid(3,3) with six anycast /24s of two advertisers each (the
    states of `tests/test_prefix_scale.py`'s device-threshold test)."""
    adj, pfx = mod.grid(3, 3)
    ls, ps = ls_cls(), ps_cls()
    for db in adj:
        ls.update_adjacency_db(db)
    for db in pfx:
        ps.update_prefix_db(db)
    names = [db.this_node_name for db in adj]
    for k in range(6):
        e = types.PrefixEntry(
            prefix=types.IpPrefix(prefix=f"10.50.{k}.0/24"),
            metrics=types.PrefixMetrics(
                path_preference=1000, source_preference=100, distance=k % 2
            ),
        )
        for a in (names[(k + 1) % 9], names[(k + 3) % 9]):
            ps.update_prefix_db(
                types.PrefixDatabase(this_node_name=a, prefix_entries=(e,))
            )
    return ls, ps


@pytest.mark.parametrize("me", ["node-0", "node-4"])
def test_solver_device_election_equals_jax(me):
    from openr_tpu import types as jtypes
    from openr_tpu_torch import types as ptypes

    jls, jps = _anycast_states(jtopo, jtypes, JaxLinkState, JaxPrefixState)
    pls, pps = _anycast_states(ptopo, ptypes, LinkState, PrefixState)
    ref_solver = TpuSpfSolver(native_rib="off")
    ref_solver.elect_device_min = 1
    ref = ref_solver.compute_routes(jls, jps, me)
    solver = TorchSpfSolver(device="cpu")
    solver.elect_device_min = 1
    got = solver.compute_routes(pls, pps, me)
    assert _canon(got) == _canon(ref)
    assert solver.elect_stats["device_elections"] > 0
    assert solver.elect_stats["multi"] == 6
    assert set(solver.last_phase_ms) == {"election", "assembly", "mpls"}
    # a second election of the same view reuses the cached matrix
    (gen, matrix), = solver._elect_dev.items()
    assert _canon(solver.compute_routes(pls, pps, me)) == _canon(got)
    assert solver._elect_dev[gen] is matrix
    # the NumPy path of the same solver gives the same RIB
    solver.elect_device_min = 1 << 15
    assert _canon(solver.compute_routes(pls, pps, me)) == _canon(got)
    assert solver.elect_stats["device_elections"] == 2


@pytest.mark.parametrize("every", [0, 4])
def test_ramp_prefix_state_equals_jax(every):
    """The port's ramp mints the JAX ramp's prefixes, advertisers and
    entries, anycast pairs included."""
    names = [f"node-{i}" for i in range(7)]
    ref = jtopo.ramp_prefix_state(names, 300, anycast_every=every,
                                  base="16.0.0.0")
    got = ptopo.ramp_prefix_state(names, 300, anycast_every=every)

    def rows(ps):
        return sorted(
            (p.prefix, tuple(sorted((n, _plain(dataclasses.asdict(e)))
                                    for n, e in per.items())))
            for p, per in ps.prefixes.items()
        )

    assert rows(got) == rows(ref)
    assert sum(len(per) == 2 for per in got.prefixes.values()) == (
        75 if every else 0)

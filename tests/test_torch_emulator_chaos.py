"""The port's chaos layer and invariant checker
(`openr_tpu_torch.emulator.chaos`, `.invariants`) on the CPU: every
in-process case of `tests/test_chaos.py` on port clusters (the seeded
storms on both node backends: the oracle, and the card solver's CPU
twins); `schedule_hash` equal to the JAX package's for the same seed and
arguments; `check_cluster` clean after the seeded storm that
`chip_smoke.py` [18] runs, here on a small fat tree; and the disk faults,
which need `persist/`, refused."""

import asyncio

import pytest
import torch

import openr_tpu.emulator.chaos as jchaos
import tests.test_chaos as ref_chaos
from openr_tpu_torch.emulator import chaos as pchaos
from openr_tpu_torch.emulator import invariants as pinv
from openr_tpu_torch.emulator.cluster import Cluster
from openr_tpu_torch.fib.fib import FibProgramError, MockFibHandler
from openr_tpu_torch.utils import topogen as ptopo
from tests.test_torch_emulator import PortCluster
from tests.test_torch_oracle import rebind

pytestmark = pytest.mark.asyncio_debug_off

# one intra-op thread: the suite runs several test workers at once
torch.set_num_threads(1)

CHAOS = rebind(
    ref_chaos, Cluster=PortCluster, ChaosPlan=pchaos.ChaosPlan,
    FibFaults=pchaos.FibFaults, KvFaults=pchaos.KvFaults,
    LinkFaults=pchaos.LinkFaults, run_schedule=pchaos.run_schedule,
    assert_invariants=pinv.assert_invariants,
    wait_quiescent=pinv.wait_quiescent, FibProgramError=FibProgramError,
    MockFibHandler=MockFibHandler,
)
PLAIN = sorted(k for k in CHAOS
               if k not in ("test_chaos_soak",
                            "test_fib_backoff_saturation_visibility"))


def test_every_chaos_case_is_run():
    names = {k for k in vars(ref_chaos) if k.startswith("test_")}
    assert names == set(CHAOS) and len(names) >= 11


@pytest.mark.parametrize("name", PLAIN)
def test_chaos_case_on_the_port(name):
    CHAOS[name]()


def test_fib_backoff_saturation_visibility_on_the_port(caplog):
    CHAOS["test_fib_backoff_saturation_visibility"](caplog)


@pytest.mark.parametrize("solver", ["cpu", "tpu"])
@pytest.mark.parametrize("scenario", sorted(ref_chaos.SCENARIOS))
def test_chaos_soak_on_the_port(scenario, solver):
    CHAOS["test_chaos_soak"](scenario, solver)


# ------------------------------------------------------ schedule parity


def _plans(seed, mod, **kw):
    p = mod.ChaosPlan(
        seed,
        link_faults=mod.LinkFaults(drop=0.1, reorder=0.1, jitter_ms=30.0),
        kv_faults=mod.KvFaults(fail_flood=0.1),
        fib_faults=mod.FibFaults(fail_rate=0.05),
        link_overrides={frozenset(("node-1", "node-2")):
                        mod.LinkFaults(drop=0.5)},
    )
    return p


@pytest.mark.parametrize("seed", [22, 7, 2026])
def test_schedule_hash_equals_the_jax_package(seed):
    adj = ptopo.fat_tree(4)[0]
    links = ptopo.edges_of(adj)
    nodes = [db.this_node_name for db in adj]
    for kw in (dict(duration_s=3.0, n_flaps=8, n_crashes=2, n_partitions=1,
                    graceful_crashes=None),
               dict(duration_s=2.0, n_flaps=4, heal_after_s=0.5),
               dict(n_crashes=3, graceful_crashes=False)):
        jp, pp = _plans(seed, jchaos), _plans(seed, pchaos)
        jev = jp.build_storm(links, nodes, **kw)
        pev = pp.build_storm(links, nodes, **kw)
        assert [(e.at_s, e.kind, e.target) for e in pev] == \
            [(e.at_s, e.kind, e.target) for e in jev]
        assert pp.schedule_hash() == jp.schedule_hash()
        assert pp.replay_hint() == jp.replay_hint()
    for stream in ("io", "kv", "fib/node-3"):
        assert pp.rng(stream).random() == jp.rng(stream).random()


def test_disk_faults_need_persist():
    p = pchaos.ChaosPlan(1)
    with pytest.raises(NotImplementedError, match="persist/"):
        p.build_storm([("a", "b")], ["a", "b"], n_crashes=1,
                      n_disk_faults=1)
    with pytest.raises(NotImplementedError, match="persist/"):
        p.disk_injector("a")


# ------------------------------------------ [18]'s storm, small and on CPU


def test_seeded_storm_leaves_a_clean_cluster_on_the_card_twins():
    """[18]'s recipe on `fat_tree_pod(4, 2)` (12 nodes) with every node on
    the card solver's CPU twins: converge, `check_cluster` clean, the
    seed-22 storm with two crashes and a partition, quiescence, and
    `check_cluster` clean again; a restarted node has a new solver."""
    edges = ptopo.edges_of(ptopo.fat_tree_pod(4, 2)[0])

    async def body():
        c = Cluster.from_edges(edges, device="cpu")
        solvers = {n: node.decision.solver for n, node in c.nodes.items()}
        await c.start()
        try:
            await c.wait_converged(timeout=60.0)
            await pinv.wait_quiescent(c, timeout_s=60.0)
            assert pinv.check_cluster(c) == []
            plan = pchaos.ChaosPlan(22)
            events = plan.build_storm(
                edges, sorted(c.nodes), duration_s=3.0, n_flaps=8,
                n_crashes=2, n_partitions=1, graceful_crashes=None)
            assert sum(e.kind == "crash" for e in events) == 2
            await pchaos.run_schedule(c, plan)
            await pinv.wait_quiescent(c, timeout_s=120.0,
                                      context=plan.replay_hint())
            assert pinv.check_cluster(c) == []
            crashed = {e.target[0] for e in events if e.kind == "crash"}
            for n in crashed:
                assert c.nodes[n].decision.solver is not solvers[n]
                assert c.nodes[n].decision.solver.device.type == "cpu"
            for node in c.nodes.values():
                assert node.decision.backend == "card"
                assert len(node.fib.programmed_unicast) == len(c.nodes) - 1
        finally:
            await c.stop()

    asyncio.run(body())


def test_check_cluster_catches_a_wrong_fib():
    """The oracle-parity class finds a programmed route that differs from
    the oracle's, and names the node."""
    async def body():
        c = Cluster.from_edges([("a", "b"), ("b", "c")], device="cpu")
        await c.start()
        try:
            await c.wait_converged(timeout=20.0)
            await pinv.wait_quiescent(c, timeout_s=20.0)
            fib = c.nodes["a"].fib
            p = next(iter(fib.programmed_unicast))
            fib.programmed_unicast.pop(p)
            got = pinv.check_fib_oracle_parity(c)
            assert [(v.kind, v.node) for v in got] == \
                [("fib.oracle_mismatch", "a")]
        finally:
            await c.stop()

    asyncio.run(body())


# ----------------------------- launch and capture counts across threads


def test_capture_and_launch_counts_hold_under_concurrent_rebuilds(
        monkeypatch):
    """Many nodes' Decisions rebuild in worker threads of one process:
    some capture their split programs while others launch eagerly. Each
    capture's `_recorded` count is its own block's kernels, whatever the
    other threads do, and the module-wide counts lose no increment. The
    wrappers' CUDA-path counting (`relax._counted`, `split_loop._counted`)
    runs after each plain call, with capture mode set per thread."""
    import threading

    from openr_tpu_torch.convert import split_tables_from_numpy
    from openr_tpu_torch.ops import relax, split_loop as sl
    from openr_tpu_torch.ops import spf_split as psplit
    from tests.test_torch_spf_split import _problem

    tls = threading.local()
    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing",
                        lambda: getattr(tls, "capturing", False))
    for mod, name, count in ((sl, "snap_mark", lambda: sl._counted("snap_mark")),
                             (sl, "flag_compact",
                              lambda: sl._counted("compact")),
                             (sl, "split_ctl", lambda: sl._counted("ctl")),
                             (relax, "relax_rows",
                              lambda: relax._counted("vec"))):
        def counted(*a, _fn=getattr(mod, name), _count=count, **kw):
            out = _fn(*a, **kw)
            _count()
            return out

        monkeypatch.setattr(mod, name, counted)

    t, over, roots, *_ = _problem(n=2000, deg=6, mw=16, seed=3)
    n_threads, rounds = 8, 3
    start = threading.Barrier(n_threads)
    results: dict[int, dict] = {}
    errors: list = []

    def here():
        return (relax.launches_here(), relax.captured_here(),
                sl.captured_here())

    def node(i: int) -> None:
        try:
            tls.capturing = i % 2 == 0
            h0 = here()
            prog = psplit.SplitProgram(
                split_tables_from_numpy(t, over, "cpu"), roots.shape[0],
                has_overloads=False, gs_chunks=None, tail_threshold=1024,
                tail_cap=8192, tail_rounds_cap=64, warm=False, steps=2)
            prog.roots.copy_(torch.from_numpy(roots))
            start.wait()
            prog._init()
            got = [prog._recorded(prog._block) for _ in range(rounds)]
            results[i] = dict(got=got, gs=prog.gs, delta=[
                b - a for a, b in zip(h0, here())])
        except Exception as e:  # noqa: BLE001 - re-raised below
            errors.append(e)

    c0, l0 = (relax.CAPTURED, sl.CAPTURED), relax.LAUNCHES
    s0 = sum(sl.LAUNCHES.values())
    threads = [threading.Thread(target=node, args=(i,))
               for i in range(n_threads)]
    for th in threads:
        th.start()
    for th in threads:
        th.join(timeout=120)
    assert not errors, errors
    assert len(results) == n_threads
    for i, r in results.items():
        gs = r["gs"]
        # a step: gs chunks, the tail rows and the overflow on kernel A,
        # and the snapshot, two compactions and ctl of the split loop
        block = 2 * (gs + psplit.SplitProgram.STEP_LAUNCHES)
        if i % 2 == 0:
            # a capture counts its own block, never another thread's
            assert r["got"] == [block] * rounds, (i, r)
            assert r["delta"][0] == 0
            assert r["delta"][1] == rounds * 2 * (gs + 2)
        else:
            # an eager thread records nothing and launches its kernels
            assert r["got"] == [0] * rounds, (i, r)
            assert r["delta"][1] == r["delta"][2] == 0
            assert r["delta"][0] == rounds * 2 * (gs + 2)
    # the module-wide counts are the sums of the threads' own
    assert relax.LAUNCHES - l0 == sum(r["delta"][0] for r in results.values())
    assert relax.CAPTURED - c0[0] == \
        sum(r["delta"][1] for r in results.values())
    assert sl.CAPTURED - c0[1] == sum(r["delta"][2] for r in results.values())
    # the eager threads' split-loop launches: 4 a step
    loop_step = psplit.SplitProgram.STEP_LAUNCHES - 2
    assert sum(sl.LAUNCHES.values()) - s0 == \
        (n_threads // 2) * rounds * 2 * loop_step


def test_a_dropped_program_never_waits_on_the_card():
    """Dropping a split program only queues its CUDA graphs, whichever
    thread drops it and whoever holds the card's lock (an event loop that
    trims a solver's caches must not wait for another node's solve); the
    next run on that card destroys them under the lock."""
    import threading

    from openr_tpu_torch.convert import split_tables_from_numpy
    from openr_tpu_torch.ops import spf_split as psplit
    from tests.test_torch_spf_split import _problem

    t, over, roots, *_ = _problem(n=200, deg=4, mw=8, seed=5)
    card = torch.device("cuda", 0)
    held, release = threading.Event(), threading.Event()

    def holder():
        with psplit.card_lock(card):
            held.set()
            release.wait(30)

    th = threading.Thread(target=holder)
    th.start()
    try:
        assert held.wait(30)
        queued = psplit._DROPPED.setdefault(0, psplit.collections.deque())
        n0 = len(queued)
        for _ in range(3):
            prog = psplit.SplitProgram(
                split_tables_from_numpy(t, over, "cpu"), roots.shape[0],
                has_overloads=False, gs_chunks=None, tail_threshold=1024,
                tail_cap=8192, tail_rounds_cap=64, warm=False)
            # a program as a card solve leaves it: graphs captured
            prog.dev, prog._graphs = card, [object(), object()]
            del prog  # returns while the lock is held elsewhere
        assert len(queued) == n0 + 3
    finally:
        release.set()
        th.join(30)
    with psplit.card_lock(card):
        assert psplit._destroy_dropped(0) == n0 + 3
    assert not queued


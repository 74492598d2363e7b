"""The port's Fib (`openr_tpu_torch.fib`) held against the JAX package's
on the CPU.

* Every case of `tests/test_fib.py` runs on the port: the JAX test
  module's source, with each `openr_tpu` import pointed at
  `openr_tpu_torch`, executed as a module of its own.
* The Fib cases of `tests/test_prefix_scale.py` (the idle pass, the
  delta batching, a failure mid-delta) run on the port the same way,
  each function taken from that file's source.
* Parity: one seeded sequence of RouteUpdates (full syncs, deltas with
  MPLS routes, identical rebindings, deletes of unknown prefixes,
  convergence traces) goes into a JAX and a port Fib, each started on
  its own `MockFibHandler` with the same `fail_next_n` schedule. After
  every update the handler calls (method, client, routes), the
  handlers' tables, `programmed_*`, the programmed stream and the
  completed traces are equal, byte for byte.
"""

import asyncio
import ast
import pathlib
import re
import types

import numpy as np
import pytest

import openr_tpu.fib as rfib
import openr_tpu.monitor.perf as rperf
import openr_tpu.types.network as rnet
import openr_tpu.types.routes as rroutes
import openr_tpu.types.serde as rs
from openr_tpu.config import Config as RefConfig
from openr_tpu.messaging import ReplicateQueue as RefQueue
from openr_tpu.monitor import Counters as RefCounters
from openr_tpu_torch import fib as pfib
from openr_tpu_torch.config import Config
from openr_tpu_torch.messaging import ReplicateQueue
from openr_tpu_torch.monitor import Counters
from openr_tpu_torch.monitor import perf as pperf
from openr_tpu_torch.types import network as pnet
from openr_tpu_torch.types import routes as proutes
from openr_tpu_torch.types import serde as ps

TESTS = pathlib.Path(__file__).resolve().parent
SEED = 20260601


def port_source(name: str) -> str:
    src = (TESTS / f"{name}.py").read_text()
    port_src = re.sub(r"\bopenr_tpu\b", "openr_tpu_torch", src)
    assert not re.search(r"\bopenr_tpu\b", port_src)
    return port_src


def on_port(name: str) -> types.ModuleType:
    """`tests/<name>.py` with every import of the JAX package pointed at
    the port, executed as a module of its own."""
    mod = types.ModuleType(f"{name}_on_port")
    mod.__file__ = str(TESTS / f"{name}.py")
    exec(compile(port_source(name), f"{name}.py on the port", "exec"),
         mod.__dict__)
    return mod


def port_functions(name: str, wanted, **overrides) -> dict:
    """The top-level functions `wanted` of `tests/<name>.py`, pointed at
    the port, in a namespace with that file's imports (each on its own:
    an import of a module the port has not got is left out, and a case
    that needs it fails by name) and `overrides`."""
    tree = ast.parse(port_source(name))
    ns = {"__name__": f"{name}_on_port"}
    for node in tree.body:
        if isinstance(node, (ast.Import, ast.ImportFrom)):
            try:
                exec(compile(ast.Module([node], []), name, "exec"), ns)
            except ImportError:
                pass
    found = set()
    for node in tree.body:
        if isinstance(node, (ast.FunctionDef, ast.ClassDef)) \
                and node.name in wanted:
            exec(compile(ast.Module([node], []), f"{name}.py on the port",
                         "exec"), ns)
            found.add(node.name)
    assert found == set(wanted), set(wanted) - found
    ns.update(overrides)
    return ns


def cases(mod):
    return sorted(n for n, f in vars(mod).items()
                  if n.startswith("test_") and callable(f))


FIB_CASES = on_port("test_fib")
SCALE_FIB = ("test_fib_idle_cycle_is_o1", "test_fib_delta_batching",
             "test_fib_failure_mid_delta_full_resyncs")
SCALE = port_functions("test_prefix_scale",
                       SCALE_FIB + ("run", "mk_fib", "rib_entry"))


@pytest.mark.parametrize("case", cases(FIB_CASES))
def test_fib_case_on_port(case):
    getattr(FIB_CASES, case)()


@pytest.mark.parametrize("case", SCALE_FIB)
def test_prefix_scale_fib_case_on_port(case):
    SCALE[case]()


def test_mirrored_modules_use_the_port():
    for ns in (vars(FIB_CASES), SCALE):
        for name in ("Fib", "MockFibHandler", "Config", "Counters",
                     "ReplicateQueue", "RibEntry", "IpPrefix"):
            obj = ns.get(name)
            assert obj is not None, name
            assert obj.__module__.startswith("openr_tpu_torch."), name
    assert len(cases(FIB_CASES)) >= 9


def test_persist_raises():
    with pytest.raises(NotImplementedError, match="persist"):
        pfib.Fib(Config.default("node-0"), ReplicateQueue().get_reader(),
                 pfib.MockFibHandler(), persist=object())


# ---- parity with the JAX package's Fib --------------------------------------

PKGS = {
    "ref": types.SimpleNamespace(
        fib=rfib, net=rnet, routes=rroutes, serde=rs, perf=rperf,
        Config=RefConfig, Queue=RefQueue, Counters=RefCounters),
    "port": types.SimpleNamespace(
        fib=pfib, net=pnet, routes=proutes, serde=ps, perf=pperf,
        Config=Config, Queue=ReplicateQueue, Counters=Counters),
}
NBRS = [f"n{i}" for i in range(6)]
HANDLER_CALLS = ("add_unicast_routes", "delete_unicast_routes",
                 "add_mpls_routes", "delete_mpls_routes", "sync_fib",
                 "sync_mpls_fib")


def recording(mock_cls):
    """A MockFibHandler class that records every call it is made, before
    it may fail: (method, client id, the argument list)."""

    class Recording(mock_cls):
        def __init__(self):
            super().__init__()
            self.calls = []

    for m in HANDLER_CALLS:
        async def call(self, client_id, arg, _m=m):
            self.calls.append((_m, client_id, list(arg)))
            await getattr(mock_cls, _m)(self, client_id, arg)

        setattr(Recording, m, call)
    return Recording


def draw_nexthops(rng) -> list:
    out = []
    for n in sorted(rng.choice(NBRS, int(rng.integers(1, 4)),
                               replace=False)):
        r = rng.random()
        act = (("PUSH", None, (int(rng.integers(16, 900)),)) if r < 0.2
               else ("SWAP", int(rng.integers(16, 900)), ()) if r < 0.3
               else None)
        out.append(dict(address=str(n), if_name=f"if-{n}",
                        metric=int(rng.integers(1, 20)),
                        weight=int(rng.integers(0, 3)), action=act,
                        area="0", neighbor_node=str(n)))
    return out


def make_nexthops(pkg, specs) -> tuple:
    out = []
    for s in specs:
        a = s["action"]
        act = None if a is None else pkg.net.MplsAction(
            pkg.net.MplsActionType[a[0]], swap_label=a[1], push_labels=a[2])
        out.append(pkg.net.NextHop(
            address=s["address"], if_name=s["if_name"], metric=s["metric"],
            weight=s["weight"], mpls_action=act, area=s["area"],
            neighbor_node=s["neighbor_node"]))
    return pkg.net.sorted_nexthops(out)


def draw_updates(seed: int, rounds: int = 24) -> list:
    """A seeded RouteUpdate sequence as plain specs: a full sync, then
    deltas of updates (new, changed, or the same binding again), deletes
    (known and unknown) and MPLS changes; a second full sync halfway; a
    trace on some."""
    rng = np.random.default_rng(seed)
    prefixes = [f"10.{i >> 8}.{i & 0xFF}.0/24" for i in range(60)]
    labels = list(range(100, 130))
    live_u, live_m = {}, {}
    out = []
    for r in range(rounds):
        full = r in (0, rounds // 2)
        upd = dict(full=full, u={}, u_del=[], m={}, m_del=[],
                   traced=bool(rng.random() < 0.5), fail=0)
        if full:
            live_u = {p: ("new", draw_nexthops(rng))
                      for p in rng.choice(prefixes, 40, replace=False)}
            live_m = {int(lb): ("new", draw_nexthops(rng))
                      for lb in rng.choice(labels, 10, replace=False)}
            upd["u"], upd["m"] = dict(live_u), dict(live_m)
        else:
            for p in rng.choice(prefixes, int(rng.integers(0, 12)),
                                replace=False):
                p = str(p)
                if p in live_u and rng.random() < 0.3:
                    upd["u"][p] = ("same", None)  # the binding again
                else:
                    live_u[p] = upd["u"][p] = ("new", draw_nexthops(rng))
            for p in rng.choice(prefixes, int(rng.integers(0, 5)),
                                replace=False):
                p = str(p)
                if p not in upd["u"]:
                    upd["u_del"].append(p)  # known or never programmed
                    live_u.pop(p, None)
            for lb in rng.choice(labels, int(rng.integers(0, 4)),
                                 replace=False):
                live_m[int(lb)] = upd["m"][int(lb)] = ("new",
                                                       draw_nexthops(rng))
            for lb in rng.choice(labels, int(rng.integers(0, 2)),
                                 replace=False):
                if int(lb) not in upd["m"]:
                    upd["m_del"].append(int(lb))
                    live_m.pop(int(lb), None)
            upd["fail"] = int(rng.choice([0, 0, 0, 1, 2]))
        out.append(upd)
    return out


class FibRun:
    """One package's Fib started on a recording handler (batches of 8,
    fast retries), fed from a spec sequence."""

    def __init__(self, pkg):
        self.pkg = pkg
        cfg = pkg.Config.default("node-0")
        cfg.node.fib.program_batch_size = 8
        cfg.node.fib.initial_retry_ms = 1
        cfg.node.fib.max_retry_ms = 4
        self.routes = pkg.Queue(name="routes")
        self.stream = pkg.Queue(name="fib_updates")
        self.perf_q = pkg.Queue(name="perf")
        self.stream_r = self.stream.get_reader()
        self.perf_r = self.perf_q.get_reader()
        self.handler = recording(pkg.fib.MockFibHandler)()
        self.fib = pkg.fib.Fib(
            cfg, self.routes.get_reader(), self.handler,
            fib_updates_queue=self.stream, perf_events_queue=self.perf_q,
            counters=pkg.Counters())
        self.entries_u, self.entries_m = {}, {}

    def update(self, spec) -> None:
        R, N = self.pkg.routes, self.pkg.net
        upd = R.RouteUpdate(type=(R.RouteUpdateType.FULL_SYNC
                                  if spec["full"]
                                  else R.RouteUpdateType.INCREMENTAL))
        for p, (kind, nh) in spec["u"].items():
            if kind == "new":
                self.entries_u[p] = R.RibEntry(
                    prefix=N.IpPrefix.make(p),
                    nexthops=make_nexthops(self.pkg, nh), best_node="n0")
            upd.unicast_to_update[self.entries_u[p].prefix] = \
                self.entries_u[p]
        upd.unicast_to_delete = [N.IpPrefix.make(p) for p in spec["u_del"]]
        for lb, (_kind, nh) in spec["m"].items():
            self.entries_m[lb] = R.RibMplsEntry(
                label=lb, nexthops=make_nexthops(self.pkg, nh))
            upd.mpls_to_update[lb] = self.entries_m[lb]
        upd.mpls_to_delete = list(spec["m_del"])
        if spec["traced"]:
            upd.perf_events = [self.pkg.perf.PerfEvents.start(
                self.pkg.perf.ROUTE_UPDATE_SENT, node="node-0")]
        self.handler.fail_next_n = spec["fail"]
        self.routes.push(upd)

    async def settled(self) -> None:
        fib = self.fib
        for _ in range(5000):
            if (not fib.reader.qsize() and not fib._dirty.is_set()
                    and fib._have_rib and fib.pending_changes()["converged"]):
                return
            await asyncio.sleep(0.001)
        raise AssertionError(f"fib did not settle: {fib.pending_changes()}")

    def wire(self, obj) -> bytes:
        return self.pkg.serde.to_wire(obj)

    def observed(self) -> dict:
        """Everything the round made visible, as bytes."""
        fib, h = self.fib, self.handler
        calls, h.calls = h.calls, []
        stream = []
        while self.stream_r.qsize():
            stream.append(self.wire(self.stream_r.get_nowait()))
        traces = []
        while self.perf_r.qsize():
            traces.append([e.event for e in self.perf_r.get_nowait().events])
        client = self.pkg.fib.fib.CLIENT_ID_OPENR
        return dict(
            calls=[(m, c, self.wire(a)) for m, c, a in calls],
            table=self.wire(sorted(h.unicast.get(client, {}).values(),
                                   key=lambda r: r.dest)),
            mpls=self.wire(sorted(h.mpls.get(client, {}).values(),
                                  key=lambda r: r.top_label)),
            programmed=self.wire(fib.get_programmed_unicast()),
            programmed_mpls=self.wire(fib.get_programmed_mpls()),
            stream=stream, traces=traces,
            counters={k: fib.counters.get(k) for k in (
                "fib.program_ok", "fib.program_fail", "fib.program_batches",
                "fib.routes_programmed", "fib.program_scan_routes",
                "fib.perf_traces_completed")},
            synced=fib.synced.is_set(), failures=h.fail_count)


@pytest.mark.parametrize("seed", range(3))
def test_fib_parity_with_the_jax_package(seed):
    specs = draw_updates(SEED + seed)

    async def body():
        runs = [FibRun(PKGS["ref"]), FibRun(PKGS["port"])]
        for r in runs:
            await r.fib.start()
        try:
            for i, spec in enumerate(specs):
                for r in runs:
                    r.update(spec)
                for r in runs:
                    await r.settled()
                ref, port = (r.observed() for r in runs)
                assert port == ref, (i, spec)
                assert ref["synced"]
                if spec["traced"]:
                    # the trace completes once, after the pass that
                    # programmed it (a failed pass keeps it pending)
                    assert ref["traces"] == [["ROUTE_UPDATE_SENT",
                                              "FIB_PROGRAMMED"]]
            assert runs[1].handler.fail_count > 0
        finally:
            for r in runs:
                await r.fib.stop()

    asyncio.run(body())

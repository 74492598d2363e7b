"""The port's `profiling.trace` (the counterpart of the JAX package's
`openr_tpu/monitor/profiling.py` `trace`): a Chrome trace written into
the directory that holds the `annotate` spans, and a no-op without one."""

import json

import torch

from openr_tpu_torch import LinkState, PrefixState, TorchSpfSolver
from openr_tpu_torch.monitor.profiling import annotate, trace
from openr_tpu_torch.utils import topogen as ptopo
from test_torch_solver import _states

# one intra-op thread: the suite runs several test workers at once
torch.set_num_threads(1)


def _events(path):
    return json.loads(path.read_text())["traceEvents"]


def test_trace_writes_a_chrome_trace_with_the_spans(tmp_path):
    out = tmp_path / "traces"
    with trace(str(out)):
        with annotate("spf:test_outer"):
            with annotate("spf:test_inner"):
                torch.ones(64).cumsum(0)
    files = sorted(out.glob("*.json"))
    assert len(files) == 1
    names = {e.get("name") for e in _events(files[0])}
    assert {"spf:test_outer", "spf:test_inner"} <= names
    with trace(out):  # a second trace, a second file
        pass
    assert len(list(out.glob("*.json"))) == 2


def test_trace_holds_the_solver_spans(tmp_path):
    ls, _ps = _states(ptopo, LinkState, PrefixState, "wan_like", (30, 3))
    solver = TorchSpfSolver(device="cpu")
    with trace(tmp_path):
        solver.solve(ls, "node-0")
    (path,) = tmp_path.glob("*.json")
    names = {e.get("name") for e in _events(path)}
    assert "spf:batched_solve" in names


def test_trace_without_a_directory_is_a_no_op(tmp_path, monkeypatch):
    import torch.profiler as tp

    def refuse(*a, **k):
        raise AssertionError("no profiler without a directory")

    monkeypatch.setattr(tp, "profile", refuse)
    for d in (None, ""):
        with trace(d):
            torch.ones(3).sum()
    assert not list(tmp_path.iterdir())


def test_trace_that_cannot_start_is_a_no_op(tmp_path, monkeypatch):
    import torch.profiler as tp

    def broken(*a, **k):
        raise RuntimeError("profiler busy")

    monkeypatch.setattr(tp, "profile", broken)
    with trace(tmp_path / "t"):
        x = torch.ones(3).sum()
    assert float(x) == 3.0

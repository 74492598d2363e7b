"""The port's `profiling.trace` (the counterpart of the JAX package's
`openr_tpu/monitor/profiling.py` `trace`): a Chrome trace written into
the directory that holds the `annotate` spans, and a no-op without one;
and `solve_turns.py`'s comparison of two checkouts' traces by kernel
name."""

import json

import torch

from openr_tpu_torch import LinkState, PrefixState, TorchSpfSolver
from openr_tpu_torch import solve_turns
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


def _turn(label, kernels):
    return {"label": label, "card": "a card",
            "solve": {"p50_ms": 3.5, "noop_step_us": 18.0,
                      "device_us": sum(k["us"] for k in kernels.values()),
                      "kernels": kernels},
            "config3_split": {"p50_ms": 15.0},
            "warm": {"p50_ms": 60.0, "device_us": 0.0, "kernels": {}}}


def test_solve_turns_compares_turns_by_kernel_name(tmp_path, capsys):
    """A kernel one checkout has and the other lacks (the mark folded
    into the snapshot's launch) shows 0 launches in the turns without
    it; the kernels go longest first, the totals turn by turn."""
    parent = _turn("parent", {
        "split_snap_kernel": {"us": 190.0, "launches": 96},
        "frontier_mark_kernel": {"us": 130.0, "launches": 96}})
    change = _turn("change", {
        "split_snap_mark_kernel": {"us": 170.0, "launches": 96}})
    cmp = solve_turns.compare([parent, change, change, parent])
    assert list(cmp["solve"]) == ["split_snap_kernel",
                                  "split_snap_mark_kernel",
                                  "frontier_mark_kernel"]
    assert cmp["solve"]["frontier_mark_kernel"] == [
        (96, 130.0), (0, 0.0), (0, 0.0), (96, 130.0)]
    assert cmp["solve"]["split_snap_mark_kernel"][1] == (96, 170.0)
    assert cmp["warm"] == {}
    assert [t["solve_device_us"] for t in cmp["totals"]] == [
        320.0, 170.0, 170.0, 320.0]
    runs = tmp_path / "turns.jsonl"
    runs.write_text("\n".join(json.dumps(t) for t in (parent, change))
                    + "\n")
    solve_turns.main(["--compare", str(runs)])
    out = capsys.readouterr().out
    assert "frontier_mark_kernel" in out and "label change" in out

"""Times the split solve of one checkout of the port on the card: the
er100k cold RIB solve (`TorchSpfSolver.solve`, as `chip_smoke.py` [4]
drives it), BASELINE config 3's split call (`_solve_dist(csr,
arange(256) % V)`, as [10b] drives it), with each call's host syncs,
and the link-flap warm path on the same graph as a real LinkState
(`warm_compute_routes`, as [5] drives it, with [5]'s flaps).

    python3 openr_tpu_torch/solve_turns.py --tree DIR [--label NAME]

imports `openr_tpu_torch` from the checkout at DIR (this checkout: `.`;
another one, such as a parent commit unpacked with `git archive` into a
gitignored directory, to compare the two on one card), so only the
API both have is used. Prints one JSON line: the card's name and power
limit, p50 / min / max ms of 20 solves and 5 config 3 calls after their
warm-ups, the stats of the last call, the device µs of a no-op step
(the solve's replayed block once more with the loop done, between CUDA
events, over its steps), the device time of 3 replayed solves by
kernel (CUPTI, through torch.profiler), and the warm path's wall p50
over [5]'s 10 flap and revert calls, then its traced flap (12 tail
rounds): the stats and the device time by kernel; it fails unless that
RIB equals a fresh solver's cold one. Run the two checkouts in turns (A, B,
B, A), each in its own process; the LinkState takes about a minute of
host set-up and a few GB of host memory.

    python3 openr_tpu_torch/solve_turns.py --compare FILE [FILE ...]

reads such lines (one a turn, in the files' order) and prints, for the
replayed solves and the traced flap, each kernel's launches and µs in
every turn by name: a kernel that one checkout has and the other lacks
(a kernel folded into another) shows 0 launches in the turns without it.
Then the p50s, the no-op step and the device totals, turn by turn.
"""

from __future__ import annotations

import argparse
import json
import re
import shutil
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

SOLVES = 20
CONFIG3_CALLS = 5
PROFILED_SOLVES = 3
#: flap and revert pairs before the traced flap, and the seed of their
#: picks: `chip_smoke.py` [5]'s
WARM_ROUNDS = 5
WARM_SEED = 20261017


def _ms(fn, n: int, sync) -> tuple[list[float], list[dict]]:
    times, stats = [], []
    for _ in range(n):
        t0 = time.perf_counter()
        st = fn()
        sync()
        times.append((time.perf_counter() - t0) * 1e3)
        stats.append(st)
    return times, stats


def _summary(times: list[float]) -> dict:
    return {"p50_ms": statistics.median(times), "min_ms": min(times),
            "max_ms": max(times), "samples": [round(t, 3) for t in times]}


def _noop_step_us(solver, torch, reps: int = 10) -> float:
    """µs a step of the cold program's replayed block costs once the
    loop is done (its control block says so after the last solve)."""
    prog = next(p for p in solver._programs._progs.values() if not p.warm)
    block = prog._graphs[1]
    block.replay()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(reps):
        block.replay()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) * 1e3 / reps / prog.steps


def device_kernels(fn) -> dict:
    """Runs `fn` under torch.profiler; returns, from its Chrome trace,
    each device kernel, copy and fill by name (templates, namespaces and
    arguments dropped) with its launches and their µs, longest first, as
    CUPTI saw them, and the total µs. A span's annotation on the device
    timeline is not a kernel and is not counted."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    out = Path(tempfile.mkdtemp(prefix="solve_turns_"))
    try:
        prof.export_chrome_trace(str(out / "trace.json"))
        events = json.loads((out / "trace.json").read_text())
    finally:
        shutil.rmtree(out, ignore_errors=True)
    by_name: dict = {}
    for e in events.get("traceEvents", []):
        if e.get("cat") not in ("kernel", "gpu_memcpy", "gpu_memset"):
            continue
        m = re.search(r"\w+_kernel\b", e["name"])
        name = m.group(0) if m else e["name"][:60]
        by_name.setdefault(name, []).append(float(e["dur"]))
    kernels = {k: {"us": sum(d), "launches": len(d),
                   "each_us": sorted(d, reverse=True)}
               for k, d in sorted(by_name.items(), key=lambda kv: -sum(kv[1]))}
    return {"device_us": sum(k["us"] for k in kernels.values()),
            "kernels": kernels}


def er_linkstate(n: int, avg_degree: int, seed: int, max_metric: int):
    """A real LinkState + PrefixState of `erdos_renyi_csr`'s directed
    edges, through the topology generator's `_mk_dbs`: the names, node
    labels and interface names of `erdos_renyi_lsdb`'s view. Returns
    them and the edge count."""
    from openr_tpu_torch.decision.linkstate import LinkState, PrefixState
    from openr_tpu_torch.utils.topogen import _mk_dbs, erdos_renyi_csr

    src, dst, met, _vp, nn, e = erdos_renyi_csr(
        n, avg_degree=avg_degree, seed=seed, max_metric=max_metric
    )
    adj, pfx = _mk_dbs(nn, list(zip(src[:e].tolist(), dst[:e].tolist(),
                                    met[:e].tolist())))
    ls, ps = LinkState(), PrefixState()
    for db in adj:
        ls.update_adjacency_db(db)
    for db in pfx:
        ps.update_prefix_db(db)
    return ls, ps, e


def flap_round(ls, rng, n_up: int, n_down: int):
    """Metric changes on n_up + n_down directed adjacencies of distinct
    nodes, none touching node-0: n_up raised by +20, n_down lowered to 1.
    Returns (edge pairs, the replaced AdjacencyDatabases)."""
    from dataclasses import replace

    names = ls.nodes
    picked: dict[str, tuple[int, int]] = {}
    while len(picked) < n_up + n_down:
        node = names[int(rng.integers(1, len(names)))]
        if node == "node-0" or node in picked:
            continue
        adjs = ls.adjacency_db(node).adjacencies
        k = int(rng.integers(len(adjs)))
        if adjs[k].other_node_name == "node-0":
            continue
        new = adjs[k].metric + 20 if len(picked) < n_up else 1
        if new == adjs[k].metric:
            continue
        picked[node] = (k, new)
    pairs: set = set()
    old_dbs = []
    for node, (k, m) in picked.items():
        db = ls.adjacency_db(node)
        old_dbs.append(db)
        adjs = list(db.adjacencies)
        adjs[k] = replace(adjs[k], metric=m)
        changed, got = ls.update_adjacency_db_delta(
            replace(db, adjacencies=tuple(adjs)))
        if not changed or got is None:
            raise RuntimeError(f"warm: the flap on {node} was not "
                               "metric-only")
        pairs.update(got)
    return pairs, old_dbs


def revert_round(ls, old_dbs):
    """Puts back the AdjacencyDatabases a `flap_round` replaced; returns
    the edge pairs."""
    pairs: set = set()
    for db in old_dbs:
        changed, got = ls.update_adjacency_db_delta(db)
        if not changed or got is None:
            raise RuntimeError(f"warm: the revert of {db.this_node_name} "
                               "was not metric-only")
        pairs.update(got)
    return pairs


def _warm(solver_cls, np, sync) -> dict:
    """[5]'s warm calls on a fresh solver: `WARM_ROUNDS` flap and revert
    pairs timed, then one flap traced."""
    ls, ps, _e = er_linkstate(100_000, avg_degree=20, seed=0, max_metric=64)
    solver = solver_cls(device="cuda")
    rdb, art = solver.compute_routes(ls, ps, "node-0", return_artifact=True)
    rng = np.random.default_rng(WARM_SEED)
    walls = []

    def warm(pairs):
        nonlocal rdb, art
        t0 = time.perf_counter()
        got = solver.warm_compute_routes(art, ls, ps, "node-0", pairs,
                                         set(), rdb, 0.25)
        sync()
        walls.append((time.perf_counter() - t0) * 1e3)
        if got is None:
            raise RuntimeError("warm_compute_routes returned None")
        rdb, art = got[0], got[1]

    for _ in range(WARM_ROUNDS):
        pairs, old_dbs = flap_round(ls, rng, 16, 16)
        warm(pairs)
        warm(revert_round(ls, old_dbs))
    pairs, _old = flap_round(ls, rng, 16, 16)
    traced = device_kernels(lambda: warm(pairs))
    fresh = solver_cls(device="cuda").compute_routes(ls, ps, "node-0")
    if (rdb.unicast_routes != fresh.unicast_routes
            or rdb.mpls_routes != fresh.mpls_routes):
        raise RuntimeError("the traced warm RIB differs from a fresh "
                           "solver's cold one")
    return {**_summary(walls[:-1]), "traced_wall_ms": walls[-1],
            "traced_stats": dict(solver.last_warm_stats), **traced}


def compare(runs: list[dict]) -> dict:
    """Turn by turn, from `main`'s lines: for "solve" and "warm", each
    kernel name any turn saw -> [(launches, µs)] a turn (0, 0.0 where a
    turn saw none), and "totals": label, solve / config 3 / warm p50 ms,
    no-op step µs, device µs of the replayed solves and of the flap."""
    out = {}
    for sec in ("solve", "warm"):
        names = sorted({k for r in runs for k in r[sec]["kernels"]},
                       key=lambda k: -max(r[sec]["kernels"].get(k, {})
                                          .get("us", 0.0) for r in runs))
        out[sec] = {k: [(r[sec]["kernels"].get(k, {}).get("launches", 0),
                         r[sec]["kernels"].get(k, {}).get("us", 0.0))
                        for r in runs] for k in names}
    out["totals"] = [dict(
        label=r["label"], solve_p50_ms=r["solve"]["p50_ms"],
        config3_p50_ms=r["config3_split"]["p50_ms"],
        warm_p50_ms=r["warm"]["p50_ms"],
        noop_step_us=r["solve"]["noop_step_us"],
        solve_device_us=r["solve"]["device_us"],
        flap_device_us=r["warm"]["device_us"]) for r in runs]
    return out


def _print_compare(files: list[str]) -> None:
    runs = [json.loads(line) for f in files
            for line in Path(f).read_text().splitlines()
            if line.startswith("{")]
    cmp = compare(runs)
    print("turns: " + " | ".join(f"{r['label']} ({r['card']})"
                                 for r in runs))
    for sec, head in (("solve", f"{PROFILED_SOLVES} replayed solves"),
                      ("warm", "the traced flap")):
        print(f"{head}, by kernel: launches / µs a turn")
        for name, cells in cmp[sec].items():
            print(f"  {name:<40} " + "  ".join(
                f"{n:>5} / {us:>9.1f}" for n, us in cells))
    for row in cmp["totals"]:
        print("  " + ", ".join(f"{k} {v:.3f}" if isinstance(v, float)
                               else f"{k} {v}" for k, v in row.items()))


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--tree", help="root of the checkout whose port is "
                    "timed")
    ap.add_argument("--label", default=None)
    ap.add_argument("--compare", nargs="+", metavar="FILE",
                    help="print the turns in these files' lines side by "
                    "side, by kernel name")
    args = ap.parse_args(argv)
    if args.compare:
        return _print_compare(args.compare)
    if not args.tree:
        ap.error("--tree or --compare is required")
    sys.path.insert(0, args.tree)
    import numpy as np
    import torch

    from openr_tpu_torch.decision.spf_backend import TorchSpfSolver
    from openr_tpu_torch.monitor import compile_ledger
    from openr_tpu_torch.utils.topogen import erdos_renyi_lsdb

    if not torch.cuda.is_available():
        sys.exit("solve_turns: no CUDA device")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
    ).stdout.strip().splitlines()[0]
    ls, _ps, csr = erdos_renyi_lsdb(100_000, avg_degree=20, seed=0,
                                    max_metric=64)
    solver = TorchSpfSolver(device="cuda")
    sync = torch.cuda.synchronize
    led = compile_ledger.ledger()

    def solve():
        h0 = led.host_syncs
        solver.solve(ls, "node-0")
        return dict(solver.last_solve_stats, ledger_syncs=led.host_syncs - h0)

    for _ in range(2):  # warm-up: the build, the tables, the first solves
        solve()
    sync()
    t_solve, st_solve = _ms(solve, SOLVES, sync)
    noop_us = _noop_step_us(solver, torch)
    prof = device_kernels(lambda: [solve() for _ in range(PROFILED_SOLVES)])
    roots = (np.arange(256) % csr.num_nodes).astype(np.int32)

    def config3():
        h0 = led.host_syncs
        solver._solve_dist(csr, roots)
        return dict(solver.last_solve_stats, ledger_syncs=led.host_syncs - h0)

    config3()
    sync()
    t_c3, st_c3 = _ms(config3, CONFIG3_CALLS, sync)
    warm = _warm(TorchSpfSolver, np, sync)
    print(json.dumps({
        "label": args.label or args.tree, "card": card,
        "torch": torch.__version__,
        "solve": {**_summary(t_solve),
                  "host_syncs": [s.get("host_syncs") for s in st_solve],
                  "ledger_syncs": [s["ledger_syncs"] for s in st_solve],
                  "last": st_solve[-1], "noop_step_us": noop_us,
                  "profiled_solves": PROFILED_SOLVES, **prof},
        "config3_split": {**_summary(t_c3),
                          "host_syncs": [s.get("host_syncs") for s in st_c3],
                          "ledger_syncs": [s["ledger_syncs"] for s in st_c3],
                          "last": st_c3[-1]},
        "warm": warm,
    }, default=str), flush=True)


if __name__ == "__main__":
    main()

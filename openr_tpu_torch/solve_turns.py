"""Times the split solve of one checkout of the port on the card: the
er100k cold RIB solve (`TorchSpfSolver.solve`, as `chip_smoke.py` [4]
drives it) and BASELINE config 3's split call (`_solve_dist(csr,
arange(256) % V)`, as [10b] drives it), with each call's host syncs.

    python3 openr_tpu_torch/solve_turns.py --tree DIR [--label NAME]

imports `openr_tpu_torch` from the checkout at DIR (this checkout: `.`;
another one, such as a parent commit unpacked with `git archive` into a
gitignored directory, to compare the two on one card), so only the
API both have is used. Prints one JSON line: the card's name and power
limit, p50 / min / max ms of 20 solves and 5 config 3 calls after their
warm-ups, and the stats of the last call. Run the two checkouts in
turns (A, B, B, A), each in its own process.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time

SOLVES = 20
CONFIG3_CALLS = 5


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


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--tree", required=True,
                    help="root of the checkout whose port is timed")
    ap.add_argument("--label", default=None)
    args = ap.parse_args(argv)
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
    roots = (np.arange(256) % csr.num_nodes).astype(np.int32)

    def config3():
        h0 = led.host_syncs
        solver._solve_dist(csr, roots)
        return dict(solver.last_solve_stats, ledger_syncs=led.host_syncs - h0)

    config3()
    sync()
    t_c3, st_c3 = _ms(config3, CONFIG3_CALLS, sync)
    print(json.dumps({
        "label": args.label or args.tree, "card": card,
        "torch": torch.__version__,
        "solve": {**_summary(t_solve),
                  "host_syncs": [s.get("host_syncs") for s in st_solve],
                  "ledger_syncs": [s["ledger_syncs"] for s in st_solve],
                  "last": st_solve[-1]},
        "config3_split": {**_summary(t_c3),
                          "host_syncs": [s.get("host_syncs") for s in st_c3],
                          "ledger_syncs": [s["ledger_syncs"] for s in st_c3],
                          "last": st_c3[-1]},
    }, default=str), flush=True)


if __name__ == "__main__":
    main()

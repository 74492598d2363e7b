"""Times the port's cold er100k solve and full RIB on the card, from one
checkout of the repo, so that two checkouts can be compared in turns.

    python tools/ab_solve.py --root PARENT_CHECKOUT --tag parent
    python tools/ab_solve.py --root . --tag change

It imports `openr_tpu_torch` from `--root` (building that checkout's
kernels there) and, on `erdos_renyi_lsdb(100_000, avg_degree=20, seed=0,
max_metric=64)` from node-0 (`chip_smoke.py` [4]'s inputs), times:

- `solve`: `TorchSpfSolver.solve`, `--solves` times after one warm-up,
  in the main thread;
- `solve_busy`: the same solves in a worker thread while the main thread
  runs pure-Python work, as a Decision's rebuild runs beside its node's
  event loop: there every launch that gives up the GIL waits to take it
  back;
- `rib`: `compute_routes`, `--ribs` times after one warm-up.

It prints one JSON object with each p50 and its samples in ms, and the
card's name and power limit.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import threading
import time


def _times(fn, n: int) -> list[float]:
    out = []
    for _ in range(n):
        t0 = time.perf_counter()
        fn()
        out.append((time.perf_counter() - t0) * 1e3)
    return out


def main() -> None:
    ap = argparse.ArgumentParser(prog="tools/ab_solve.py")
    ap.add_argument("--root", required=True)
    ap.add_argument("--tag", default="")
    ap.add_argument("--solves", type=int, default=20)
    ap.add_argument("--ribs", type=int, default=5)
    args = ap.parse_args()
    root = os.path.abspath(args.root)
    sys.path.insert(0, root)
    import torch

    from openr_tpu_torch.decision.spf_backend import TorchSpfSolver
    from openr_tpu_torch.utils.topogen import erdos_renyi_lsdb

    import openr_tpu_torch

    if not os.path.abspath(openr_tpu_torch.__file__).startswith(root + os.sep):
        raise SystemExit(f"imported {openr_tpu_torch.__file__}, not {root}'s")
    if not torch.cuda.is_available():
        raise SystemExit("no CUDA device")
    ls, ps, _csr = erdos_renyi_lsdb(100_000, avg_degree=20, seed=0,
                                    max_metric=64)
    solver = TorchSpfSolver(device="cuda")

    def solve():
        solver.solve(ls, "node-0")
        torch.cuda.synchronize()

    solve()  # builds the kernels, captures the program
    t_solve = _times(solve, args.solves)

    got: list = []
    stop = threading.Event()

    def worker():
        got.extend(_times(solve, args.solves))
        stop.set()

    th = threading.Thread(target=worker)
    th.start()
    spins = 0
    while not stop.is_set():
        sum(i * i for i in range(2000))  # the loop's Python work
        spins += 1
    th.join()

    solver.compute_routes(ls, ps, "node-0")
    t_rib = _times(lambda: solver.compute_routes(ls, ps, "node-0"), args.ribs)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True
    ).stdout.strip()

    def row(xs):
        return {"p50_ms": statistics.median(xs),
                "samples_ms": [round(x, 3) for x in xs]}

    print(json.dumps({"tag": args.tag, "root": root, "card": card,
                      "solve": row(t_solve), "solve_busy": row(got),
                      "busy_spins": spins, "rib": row(t_rib)}), flush=True)


if __name__ == "__main__":
    main()

"""Where the time of one cold single-root RIB solve goes, on the card.

    python3 -m openr_tpu_torch.profile_solve [--nodes 100000] [--solves 3]
        [--timed 10]

Builds `erdos_renyi_lsdb(nodes, avg_degree=20, seed=0, max_metric=64)`,
warms `TorchSpfSolver(device="cuda")` up, times `--timed` solves without
the profiler (host wall, p50), then traces `--solves` solves with
`torch.profiler` and prints the device time by kernel, the device busy
share of the traced wall time, the relax kernel's launches and time,
and the per-solve counters. The last line is one JSON object with the
same numbers. It reads the package only through `TorchSpfSolver`, so the
same script can measure an older checkout of the package.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import time

import torch


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--nodes", type=int, default=100_000)
    ap.add_argument("--solves", type=int, default=3)
    ap.add_argument("--timed", type=int, default=10)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("profile_solve needs a CUDA device")
    from torch.profiler import ProfilerActivity, profile

    from openr_tpu_torch.decision.spf_backend import TorchSpfSolver
    from openr_tpu_torch.utils.topogen import erdos_renyi_lsdb

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    ).stdout.strip()
    ls, _ps, _csr = erdos_renyi_lsdb(
        args.nodes, avg_degree=20, seed=0, max_metric=64
    )
    solver = TorchSpfSolver(device="cuda")
    for _ in range(2):
        solver.solve(ls, "node-0")
    torch.cuda.synchronize()
    solve_ms = []
    for _ in range(args.timed):
        t0 = time.perf_counter()
        solver.solve(ls, "node-0")
        solve_ms.append((time.perf_counter() - t0) * 1e3)
    stats = []
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(args.solves):
            solver.solve(ls, "node-0")
            stats.append(dict(solver.last_solve_stats))
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    rows = []
    for ev in prof.key_averages():
        # device-side events only (kernels, copies, sets): the aten ops
        # that launched them carry the same time again, and a span's
        # annotation on the device timeline spans their gaps too
        if (str(getattr(ev, "device_type", "")).endswith("CPU")
                or getattr(ev, "is_user_annotation", False)):
            continue
        dev_us = getattr(ev, "self_device_time_total", None)
        if dev_us is None:
            dev_us = getattr(ev, "self_cuda_time_total", 0.0)
        if dev_us > 0:
            rows.append((ev.key, dev_us, ev.count))
    rows.sort(key=lambda r: -r[1])
    device_ms = sum(r[1] for r in rows) / 1e3
    relax_rows = [r for r in rows
                  if "relax_" in r[0] and "_kernel" in r[0]]
    relax_us = sum(r[1] for r in relax_rows)
    relax_n = sum(r[2] for r in relax_rows)
    print(f"card: {card}")
    p50 = statistics.median(solve_ms) if solve_ms else None
    print(f"untraced solve p50 {p50} ms (samples "
          f"{[round(x, 3) for x in solve_ms]})")
    print(f"{args.solves} solves, traced wall {wall_ms:.3f} ms")
    for key, us, cnt in rows[:15]:
        print(f"  {us / 1e3:9.3f} ms  {cnt:6d}x  {key[:90]}")
    busy = device_ms / wall_ms if rows else None
    print(f"device time {device_ms:.3f} ms; busy share "
          f"{'not measured' if busy is None else f'{busy:.3f}'}")
    if relax_n:
        print(f"relax kernel: {relax_n} launches, {relax_us / 1e3:.3f} ms, "
              f"{relax_us / relax_n:.2f} us per launch")
    print(json.dumps({
        "card": card,
        "solves": args.solves,
        "solve_p50_ms": p50,
        "solve_ms": solve_ms,
        "wall_ms": wall_ms,
        "device_ms": device_ms if rows else None,
        "busy_share": busy,
        "relax_launches": relax_n,
        "relax_ms": relax_us / 1e3,
        "top": [{"kernel": k[:120], "ms": us / 1e3, "count": c}
                for k, us, c in rows[:15]],
        "per_solve": stats,
    }))


if __name__ == "__main__":
    main()

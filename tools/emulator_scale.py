"""Cold-start convergence of an in-process emulated fat tree, in either
package, with the event loop's lag measured beside it.

    python tools/emulator_scale.py --package openr_tpu --k 10
    python tools/emulator_scale.py --package openr_tpu_torch --k 10 --backend oracle
    python tools/emulator_scale.py --package openr_tpu_torch --k 10 --backend card

`--package openr_tpu` runs the JAX package's emulator with its host
oracle (`solver="cpu"`); `openr_tpu_torch` runs the port's, with the
oracle backend (`use_tpu_solver=False`), the card (`--backend card`) or
the card solver's CPU twins (`--backend twins`). Both build
`Cluster.from_edges(edges_of(fat_tree(k)))` with the emulator's own
scaled Spark timers and debounce, and wait up to `--timeout` seconds
(default: the emulator CLI's `max(60, 36 x hold)`) for every node to be
INITIALIZED with a route to every other loopback. Every 5 s it prints
the nodes initialized, the spread of programmed routes, the fleet's
`spark.neighbor_down` and `decision.spf_runs`, and the loop's
lag: how late a 50 ms `asyncio.sleep` wakes, max and p99 over the
window. Then one JSON object with the result, printed before the
cluster is stopped.
"""

from __future__ import annotations

import argparse
import asyncio
import importlib
import json
import os
import sys
import threading
import time
from dataclasses import replace

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def _pct(xs, q):
    xs = sorted(xs)
    return xs[min(len(xs) - 1, int(q * len(xs)))] if xs else 0.0


async def _lag_probe(samples: list, period: float = 0.05) -> None:
    loop = asyncio.get_running_loop()
    while True:
        t = loop.time()
        await asyncio.sleep(period)
        samples.append(loop.time() - t - period)


def _fleet_sum(cluster, key: str) -> float:
    return sum(n.counters.counters.get(key, 0) for n in cluster.nodes.values())


async def run(args) -> None:
    pkg = args.package
    emu = importlib.import_module(f"{pkg}.emulator.cluster")
    topo = importlib.import_module(f"{pkg}.utils.topogen")
    edges = topo.edges_of(topo.fat_tree(args.k)[0])
    if pkg == "openr_tpu":
        if args.backend != "oracle":
            raise SystemExit("the JAX package runs here on its oracle only")
        cluster = emu.Cluster.from_edges(edges, solver="cpu")
    else:
        def oracle(ncfg):
            return replace(ncfg, decision=replace(ncfg.decision,
                                                  use_tpu_solver=False))
        device = {"card": None, "twins": "cpu", "oracle": "cpu"}[args.backend]
        cluster = emu.Cluster.from_edges(
            edges, device=device,
            node_config_transform=oracle if args.backend == "oracle" else None)
    n = len(cluster.nodes)
    hold_s = emu.scaled_spark(n).hold_time_ms / 1000.0
    timeout = args.timeout or max(60.0, 36 * hold_s)
    print(f"{pkg} fat_tree({args.k}): {n} nodes, {len(edges)} links, "
          f"backend {args.backend}, hold {hold_s:.3f} s, timeout {timeout:.0f} s",
          flush=True)
    lags: list[float] = []
    probe = asyncio.ensure_future(_lag_probe(lags))
    t0 = time.perf_counter()
    await cluster.start()
    last, seen = t0, 0
    converged_at = None
    while True:
        if cluster.converged():
            converged_at = time.perf_counter() - t0
            break
        now = time.perf_counter()
        if now - t0 > timeout:
            break
        if now - last >= 5.0:
            window = lags[seen:]
            seen = len(lags)
            last = now
            routes = sorted(len(x.fib.programmed_unicast)
                            for x in cluster.nodes.values())
            print(f"+{now - t0:.1f} s: {sum(x.initialized for x in cluster.nodes.values())}"
                  f" of {n} initialized, routes min {routes[0]} p50 "
                  f"{routes[len(routes) // 2]}, neighbor_down "
                  f"{_fleet_sum(cluster, 'spark.neighbor_down'):.0f}, rebuilds "
                  f"{_fleet_sum(cluster, 'decision.spf_runs'):.0f}, loop lag "
                  f"max {1e3 * max(window, default=0):.0f} ms p99 "
                  f"{1e3 * _pct(window, 0.99):.0f} ms", flush=True)
        await asyncio.sleep(0.1)
    wall = time.perf_counter() - t0
    short = {name: (x.initialized, len(x.fib.programmed_unicast))
             for name, x in cluster.nodes.items()
             if not x.initialized or len(x.fib.programmed_unicast) < n - 1}
    out = {
        "package": pkg, "k": args.k, "nodes": n, "links": len(edges),
        "backend": args.backend, "hold_s": hold_s, "timeout_s": timeout,
        "converged": converged_at is not None,
        "converged_s": converged_at, "wall_s": wall,
        "neighbor_down": _fleet_sum(cluster, "spark.neighbor_down"),
        "rebuilds": _fleet_sum(cluster, "decision.spf_runs"),
        "loop_lag_ms": {"p50": 1e3 * _pct(lags, 0.5), "p99": 1e3 * _pct(lags, 0.99),
                        "max": 1e3 * max(lags, default=0)},
        "not_converged": {k: list(v) for k, v in sorted(short.items())[:20]},
        "n_not_converged": len(short),
    }
    probe.cancel()
    print(json.dumps(out), flush=True)
    # a saturated loop can take minutes to stop 125 nodes (and to cancel
    # the stop): the result is out, so a timer thread bounds the stop
    timer = threading.Timer(args.stop_timeout, os._exit, (0,))
    timer.daemon = True
    timer.start()
    await cluster.stop()
    timer.cancel()


def main() -> None:
    ap = argparse.ArgumentParser(prog="tools/emulator_scale.py")
    ap.add_argument("--package", choices=["openr_tpu", "openr_tpu_torch"],
                    default="openr_tpu_torch")
    ap.add_argument("--k", type=int, default=10)
    ap.add_argument("--backend", choices=["oracle", "twins", "card"],
                    default="oracle")
    ap.add_argument("--timeout", type=float, default=0.0)
    ap.add_argument("--stop-timeout", type=float, default=60.0)
    asyncio.run(run(ap.parse_args()))


if __name__ == "__main__":
    main()

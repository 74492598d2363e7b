"""Run an in-process emulated cluster of port nodes and report
convergence (the port's copy of `openr_tpu/emulator/__main__.py`).

    python -m openr_tpu_torch.emulator --nodes 9 --topo grid
    python -m openr_tpu_torch.emulator --topo ring --nodes 6 --churn 3
    python -m openr_tpu_torch.emulator --nodes 4 --device cpu

Every node's Decision solves on the current CUDA card (`--device cuda`,
the default; without CUDA it exits non-zero before building a node),
on the CPU twins with `--device cpu`, or in the host oracle with
`--solver oracle` (the JAX package's `--solver cpu`). `--soak` (the
seeded multi-round soak) needs `emulator/soak.py`, which is not part of
the port yet, and exits non-zero.
"""

from __future__ import annotations

import argparse
import asyncio
import sys
import time


def topo_edges(topo: str, n: int) -> list[tuple[str, str]]:
    names = [f"node-{i}" for i in range(n)]
    edges: list[tuple[str, str]] = []
    if topo == "line":
        edges = [(names[i], names[i + 1]) for i in range(n - 1)]
    elif topo == "ring":
        edges = [(names[i], names[(i + 1) % n]) for i in range(n)]
    elif topo == "grid":
        side = int(n**0.5)
        assert side * side == n, f"--nodes must be a square for grid (got {n})"
        for r in range(side):
            for c_ in range(side):
                i = r * side + c_
                if c_ + 1 < side:
                    edges.append((names[i], names[i + 1]))
                if r + 1 < side:
                    edges.append((names[i], names[i + side]))
    elif topo == "mesh":
        edges = [
            (names[i], names[j]) for i in range(n) for j in range(i + 1, n)
        ]
    else:
        raise SystemExit(f"unknown topo {topo!r}")
    return edges


def parse_args(argv=None):
    ap = argparse.ArgumentParser(prog="openr_tpu_torch.emulator")
    ap.add_argument("--nodes", type=int, default=4)
    ap.add_argument(
        "--topo", choices=["line", "ring", "grid", "mesh"], default="ring"
    )
    ap.add_argument(
        "--device", choices=["cuda", "cpu"], default="cuda",
        help="where each node's Decision solves: the current CUDA card"
        " (the default) or the CPU twins",
    )
    ap.add_argument(
        "--solver", choices=["card", "oracle"], default="card",
        help="'oracle' solves in the host oracle (use_tpu_solver=False)"
        " and never touches the card",
    )
    ap.add_argument(
        "--churn", type=int, default=0,
        help="after convergence, fail/heal this many links and re-measure",
    )
    ap.add_argument(
        "--ctrl", action="store_true",
        help="start a ctrl server per node and print its port",
    )
    ap.add_argument(
        "--hold", type=float, default=0.0,
        help="keep the cluster running this many seconds after convergence",
    )
    ap.add_argument(
        "--soak", action="store_true",
        help="the seeded multi-round soak (needs emulator/soak.py, not"
        " part of the port yet: exits non-zero)",
    )
    ap.add_argument("--seed", type=int, default=7, help="soak chaos seed")
    ap.add_argument("--rounds", type=int, default=3, help="soak rounds")
    ap.add_argument("--flaps", type=int, default=3)
    ap.add_argument("--crashes", type=int, default=1)
    ap.add_argument("--partitions", type=int, default=0)
    ap.add_argument("--unbounded-control", action="store_true")
    return ap.parse_args(argv)


async def run(args) -> None:
    from dataclasses import replace

    from openr_tpu_torch.emulator import Cluster, scaled_spark

    transform = None
    if args.solver == "oracle":
        def transform(ncfg):
            return replace(ncfg, decision=replace(ncfg.decision,
                                                  use_tpu_solver=False))

    edges = topo_edges(args.topo, args.nodes)
    cluster = Cluster.from_edges(
        edges, device=None if args.device == "cuda" else "cpu",
        enable_ctrl=args.ctrl, node_config_transform=transform,
    )
    print(f"starting {args.nodes} nodes, {len(edges)} links ({args.topo})")
    t0 = time.perf_counter()
    await cluster.start()
    # the convergence wall scales with the Spark timers: a 196-node grid
    # converges in ~12 hold periods on one core; 36 gives 3x headroom
    conv_timeout = max(
        60.0, 36 * scaled_spark(args.nodes).hold_time_ms / 1000.0
    )
    await cluster.wait_converged(timeout=conv_timeout)
    t_conv = time.perf_counter() - t0
    total_routes = sum(
        len(n.fib.programmed_unicast) for n in cluster.nodes.values()
    )
    print(
        f"converged in {t_conv * 1e3:.1f} ms: "
        f"{total_routes} unicast routes programmed across the cluster",
        flush=True,
    )

    if args.ctrl:
        for name, node in cluster.nodes.items():
            print(f"ctrl {name} 127.0.0.1:{node.ctrl.port}", flush=True)

    for k in range(args.churn):
        a, b = edges[k % len(edges)]
        t0 = time.perf_counter()
        cluster.fail_link(a, b)
        # hold the failure for a second, then heal
        await asyncio.sleep(1.0)
        cluster.heal_link(a, b)
        await cluster.wait_converged(timeout=conv_timeout)
        print(
            f"churn {k}: fail/heal {a}-{b}, reconverged in "
            f"{(time.perf_counter() - t0) * 1e3:.1f} ms (incl. 1s hold)",
            flush=True,
        )

    if args.hold:
        print(f"holding for {args.hold}s", flush=True)
        await asyncio.sleep(args.hold)

    await cluster.stop()


def main(argv=None) -> int:
    args = parse_args(argv)
    if args.soak:
        print("FATAL: --soak needs emulator/soak.py (the seeded multi-round"
              " soak), which is not part of the port yet", file=sys.stderr)
        return 2
    if args.device == "cuda" and args.solver == "card":
        import torch

        if not torch.cuda.is_available():
            print("FATAL: --device cuda and no CUDA device is available"
                  " (--device cpu runs the CPU twins)", file=sys.stderr)
            return 2
    asyncio.run(run(args))
    return 0


if __name__ == "__main__":
    sys.exit(main())

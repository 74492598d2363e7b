"""Fleet metric aggregation (the port's copy of
`openr_tpu/monitor/fleet.py`): N per-node ``Counters.snapshot()`` dicts
become per-key cross-node distributions (min/p50/p99/max/mean and the
argmax node). ``Cluster.fleet_counters()`` reads it.

Percentiles here are exact over the per-node values, unlike the
log-bucketed within-node stat histograms (monitor/counters.py).
"""

from __future__ import annotations


def percentile(vals: list[float], q: float) -> float:
    """Exact nearest-rank percentile over raw values."""
    vs = sorted(vals)
    return vs[min(len(vs) - 1, int(len(vs) * q))]


_percentile = percentile  # module-internal alias


def aggregate_counters(
    snapshots: dict[str, dict[str, float]], prefix: str = ""
) -> dict[str, dict]:
    """``{node: snapshot}`` → ``{key: distribution}``.

    Each distribution: ``{"nodes", "min", "p50", "p99", "max", "mean",
    "sum", "max_node"}``. Keys missing on a node simply don't
    contribute (a key present on 3 of 64 nodes aggregates over 3 —
    ``nodes`` says so).

    Ratio-type gauges (any ``*.ratio`` key, e.g. the work ledger's
    ``work.<stage>.ratio``) aggregate by distribution ONLY: a sum of
    per-node ratios is dimensionally meaningless, so their ``sum`` is
    ``None`` rather than a number a dashboard might graph."""
    per_key: dict[str, list[tuple[float, str]]] = {}
    for node, snap in snapshots.items():
        for k, v in snap.items():
            if prefix and not k.startswith(prefix):
                continue
            per_key.setdefault(k, []).append((float(v), node))
    out: dict[str, dict] = {}
    for k, pairs in per_key.items():
        vals = [v for v, _n in pairs]
        vmax, max_node = max(pairs, key=lambda p: p[0])
        out[k] = {
            "nodes": len(vals),
            "min": min(vals),
            "p50": _percentile(vals, 0.5),
            "p99": _percentile(vals, 0.99),
            "max": vmax,
            "mean": sum(vals) / len(vals),
            "sum": None if k.endswith(".ratio") else sum(vals),
            "max_node": max_node,
        }
    return out


def fleet_rows(
    agg: dict[str, dict], limit: int = 0
) -> list[list[str]]:
    """Render-ready rows (key, nodes, min, p50, p99, max, max-node),
    sorted by key; ``limit`` > 0 keeps the first N."""
    def fmt(v: float) -> str:
        return f"{v:g}" if v == int(v) else f"{v:.3f}"

    rows = [
        [
            k,
            str(d["nodes"]),
            fmt(d["min"]),
            fmt(d["p50"]),
            fmt(d["p99"]),
            fmt(d["max"]),
            d["max_node"],
        ]
        for k, d in sorted(agg.items())
    ]
    return rows[:limit] if limit > 0 else rows


FLEET_HEADERS = ["counter", "nodes", "min", "p50", "p99", "max", "max-node"]

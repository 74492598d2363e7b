"""Host helpers of the JAX package's `openr_tpu/decision/oracle.py` that
the port's Decision reads: `metric_key` (the cross-area best-route key)
and `build_adjacency` (the directed graph `Decision.get_spf_path`
walks). The oracle's route computation, the JAX package's "cpu"
backend, is not part of the port.
"""

from __future__ import annotations

from openr_tpu_torch.common.constants import METRIC_MAX
from openr_tpu_torch.decision.artifact import metric_key  # noqa: F401


def build_adjacency(ls) -> dict[str, dict[str, int]]:
    """Directed min-metric adjacency of a LinkState, with the
    bidirectional check and the drain rules of its CSR: an overloaded
    adjacency drains both directions of its link."""
    nodes = set(ls.nodes)
    reported: set[tuple[str, str]] = set()
    drained: set[tuple[str, str]] = set()  # (advertiser, if_name)
    for u in nodes:
        for a in ls.adjacency_db(u).adjacencies:
            reported.add((u, a.other_node_name))
            if a.is_overloaded:
                drained.add((u, a.if_name))
    adj: dict[str, dict[str, int]] = {u: {} for u in nodes}
    for u in nodes:
        for a in ls.adjacency_db(u).adjacencies:
            v = a.other_node_name
            if v not in nodes or a.is_overloaded:
                continue
            if (v, a.other_if_name) in drained:
                continue
            if (v, u) not in reported:
                continue
            m = min(int(a.metric), METRIC_MAX)  # the CSR's clamp
            if v not in adj[u] or m < adj[u][v]:
                adj[u][v] = m
    return adj

"""KSP2_ED_ECMP route construction and UCMP weights: the port's copy of
the host helpers of `openr_tpu/decision/ksp.py` that the solver calls
(`nearest_dest`, `ksp2_nexthops`, `ksp_route_from_paths`,
`ucmp_weights`, `normalize_weights`).

The paths themselves come from the device (`ops/ksp.py`
`ksp_edge_disjoint_dense`); these turn them into SR-MPLS nexthops: the
first link of each path, PUSHing the node-segment labels of its
interior hops, top label first.
"""

from __future__ import annotations

import math
from typing import Iterable

from openr_tpu_torch.types.network import (
    MplsAction,
    MplsActionType,
    NextHop,
    sorted_nexthops,
)


def nearest_dest(dist: dict[str, int], dests: Iterable[str]) -> str | None:
    """The destination KSP pins all paths to: min distance, then name."""
    reachable = [d for d in dests if d in dist]
    if not reachable:
        return None
    best = min(dist[d] for d in reachable)
    return min(d for d in reachable if dist[d] == best)


def ksp2_nexthops(
    ls,  # LinkState
    my_node: str,
    paths: list[tuple[int, list[str]]],
) -> tuple[NextHop, ...]:
    """One SR-MPLS nexthop per path: the min-metric usable link to the
    path's first hop, PUSHing the labels of the later hops. A path with
    an unlabeled hop in its stack is skipped: a truncated stack would let
    traffic leave the edge-disjoint path."""
    my_db = ls.adjacency_db(my_node)
    if my_db is None:
        return ()
    nhs: list[NextHop] = []
    for cost, path in paths:
        v1 = path[1]
        cands = [
            a
            for a in my_db.adjacencies
            if a.other_node_name == v1
            and not a.is_overloaded
            and not ls.link_drained_by_peer(my_node, a)
        ]
        if not cands:
            continue
        link = min(cands, key=lambda a: (a.metric, a.if_name))
        stack = [ls.node_label(n) for n in path[2:]]
        if any(lbl <= 0 for lbl in stack):
            continue
        action = (
            MplsAction(
                action=MplsActionType.PUSH, push_labels=tuple(reversed(stack))
            )
            if stack
            else None
        )
        nhs.append(
            NextHop(
                address=v1,
                if_name=link.if_name,
                metric=cost,
                neighbor_node=v1,
                area=ls.area,
                mpls_action=action,
            )
        )
    return sorted_nexthops(nhs)


def ksp_route_from_paths(
    ls,  # LinkState
    my_node: str,
    prefix,
    reachable: dict,  # node -> PrefixEntry
    best_nodes: list[str],
    paths: list[tuple[int, list[str]]],
):
    """The RibEntry of a KSP prefix from its (cost, path) list, or None
    when no path gives a nexthop or the min_nexthop floor is not met.
    `igp_cost` is the cheapest path that produced a nexthop."""
    from openr_tpu_torch.types.routes import RibEntry

    nhs = ksp2_nexthops(ls, my_node, paths)
    if not nhs:
        return None
    dest = paths[0][1][-1]
    best_entry = reachable[dest]
    if (
        getattr(best_entry, "min_nexthop", 0)
        and len(nhs) < best_entry.min_nexthop
    ):
        return None
    return RibEntry(
        prefix=prefix,
        nexthops=nhs,
        best_node=dest,
        best_nodes=tuple(best_nodes),
        best_entry=best_entry,
        igp_cost=min(nh.metric for nh in nhs),
    )


def ucmp_weights(chosen_entries: dict) -> dict[str, int] | None:
    """node -> UCMP weight, or None when no advertiser set a weight (pure
    ECMP). Nodes without a weight count as 1."""
    if not any(getattr(e, "weight", 0) > 0 for e in chosen_entries.values()):
        return None
    return {
        n: max(getattr(e, "weight", 0), 1) for n, e in chosen_entries.items()
    }


def normalize_weights(
    weighted: dict[tuple[str, str], int],
) -> dict[tuple[str, str], int]:
    """Divide all (neighbor, if) weights by their gcd."""
    if not weighted:
        return weighted
    g = math.gcd(*weighted.values()) if len(weighted) > 1 else next(
        iter(weighted.values())
    )
    g = g or 1
    return {k: v // g for k, v in weighted.items()}

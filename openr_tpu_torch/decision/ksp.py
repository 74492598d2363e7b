"""KSP2_ED_ECMP route construction and UCMP weights: the port's copy of
`openr_tpu/decision/ksp.py`. The solver calls the route helpers
(`nearest_dest`, `ksp2_nexthops`, `ksp_route_from_paths`,
`ucmp_weights`, `normalize_weights`); `Decision.get_spf_path` answers
with `dijkstra` and `extract_path`; the host oracle computes its paths
with `k_edge_disjoint_paths` and builds the route with `ksp2_route`.

On the card the paths come from the device (`ops/ksp.py`
`ksp_edge_disjoint_dense`) by the same rule; either way they become
SR-MPLS nexthops: the first link of each path, PUSHing the node-segment
labels of its interior hops, top label first.
"""

from __future__ import annotations

import heapq
import math
from typing import Iterable

from openr_tpu_torch.types.network import (
    MplsAction,
    MplsActionType,
    NextHop,
    sorted_nexthops,
)


Link = tuple[str, str]  # directed (u, v)


def dijkstra(
    adj: dict[str, dict[str, int]],
    root: str,
    overloaded: set[str],
    banned: frozenset[Link] = frozenset(),
) -> dict[str, int]:
    """Plain SSSP on the host: overloaded nodes carry no transit, banned
    links are skipped."""
    dist = {root: 0}
    pq = [(0, root)]
    done: set[str] = set()
    while pq:
        d, u = heapq.heappop(pq)
        if u in done:
            continue
        done.add(u)
        if u != root and u in overloaded:
            continue
        for v, w in adj.get(u, {}).items():
            if (u, v) in banned:
                continue
            nd = d + w
            if v not in dist or nd < dist[v]:
                dist[v] = nd
                heapq.heappush(pq, (nd, v))
    return dist


def extract_path(
    adj: dict[str, dict[str, int]],
    dist: dict[str, int],
    root: str,
    dest: str,
    overloaded: set[str],
    banned: frozenset[Link] = frozenset(),
) -> list[str] | None:
    """The deterministic shortest path root -> dest: walking back from
    dest, the name-smallest predecessor p with dist[p] + w(p, v) ==
    dist[v] at each step. None when dest is unreached or the root."""
    if dest not in dist or dest == root:
        return None
    rev: dict[str, list[str]] = {}
    for u, nbrs in adj.items():
        for v in nbrs:
            rev.setdefault(v, []).append(u)
    path = [dest]
    v = dest
    seen = {dest}
    while v != root:
        best_p = None
        for p in sorted(rev.get(v, [])):
            if p in seen or (p, v) in banned or p not in dist:
                continue
            if p != root and p in overloaded:
                continue
            if dist[p] + adj[p][v] == dist[v]:
                best_p = p
                break
        if best_p is None:
            return None  # a torn DAG (stale dist): no path
        path.append(best_p)
        seen.add(best_p)
        v = best_p
    path.reverse()
    return path


def path_links(path: list[str]) -> frozenset[Link]:
    """Both directions of every link on the path: an edge-disjoint second
    path may not reuse a link in either direction."""
    links: set[Link] = set()
    for u, v in zip(path, path[1:]):
        links.add((u, v))
        links.add((v, u))
    return frozenset(links)


def nearest_dest(dist: dict[str, int], dests: Iterable[str]) -> str | None:
    """The destination KSP pins all paths to: min distance, then name."""
    reachable = [d for d in dests if d in dist]
    if not reachable:
        return None
    best = min(dist[d] for d in reachable)
    return min(d for d in reachable if dist[d] == best)


def k_edge_disjoint_paths(
    adj: dict[str, dict[str, int]],
    root: str,
    dests: Iterable[str],
    overloaded: set[str],
    k: int = 2,
) -> list[tuple[int, list[str]]]:
    """Up to k edge-disjoint shortest paths from root to the nearest of
    `dests`, by successive pruning: a shortest path, its links banned, a
    shortest path again. Returns [(cost, path), ...] sorted by (cost,
    path)."""
    dist = dijkstra(adj, root, overloaded)
    dest = nearest_dest(dist, dests)
    if dest is None:
        return []
    out: list[tuple[int, list[str]]] = []
    banned: frozenset[Link] = frozenset()
    for _ in range(k):
        if dest not in dist:
            break
        p = extract_path(adj, dist, root, dest, overloaded, banned=banned)
        if p is None:
            break
        out.append((dist[dest], p))
        banned = banned | path_links(p)
        dist = dijkstra(adj, root, overloaded, banned=banned)
    out.sort(key=lambda cp: (cp[0], cp[1]))
    return out


def two_edge_disjoint_paths(
    adj: dict[str, dict[str, int]],
    root: str,
    dests: Iterable[str],
    overloaded: set[str],
) -> list[tuple[int, list[str]]]:
    """KSP2: `k_edge_disjoint_paths` with k=2."""
    return k_edge_disjoint_paths(adj, root, dests, overloaded, k=2)


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


def ksp2_route(
    ls,  # LinkState
    my_node: str,
    prefix,
    reachable: dict,  # node -> PrefixEntry
    best_nodes: list[str],
    adjmap: dict[str, dict[str, int]],
    overloaded: set[str],
    k: int = 2,
):
    """The whole KSP RibEntry from host paths (the oracle's route; the
    card computes the same paths with `ops/ksp.ksp_edge_disjoint_dense`
    and calls `ksp_route_from_paths`)."""
    paths = k_edge_disjoint_paths(adjmap, my_node, best_nodes, overloaded, k=k)
    return ksp_route_from_paths(
        ls, my_node, prefix, reachable, best_nodes, paths
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

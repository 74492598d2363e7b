"""LSDB state: the graph (LinkState) and advertised prefixes (PrefixState).

The port's copy of `openr_tpu/decision/linkstate.py`. `LinkState` keeps
the authoritative graph keyed by names and materializes a padded CSR
edge list (`CsrGraph`) on demand. The JAX package's metric-patch
journal is not ported: any change drops the cached CSR, and the solver's
device cache keys on `(base_version, version)`, so it rebuilds.
"""

from __future__ import annotations

import itertools
from dataclasses import dataclass

import numpy as np

from openr_tpu_torch.common.constants import DEFAULT_AREA, DIST_INF, METRIC_MAX
from openr_tpu_torch.common.util import pad_bucket
from openr_tpu_torch.types.network import IpPrefix
from openr_tpu_torch.types.topology import (
    AdjacencyDatabase,
    PrefixDatabase,
    PrefixEntry,
)

INF_METRIC = DIST_INF

# process-wide monotonic CsrGraph version counter
_csr_version = itertools.count(1)
_PS_LINEAGE = itertools.count(1)


def next_csr_version() -> int:
    return next(_csr_version)


@dataclass
class CsrGraph:
    """Padded edge-list view of the LSDB, sorted by destination.

      edge_src[Ep]        i32  source node id (0 for padding)
      edge_dst[Ep]        i32  destination id (padding -> dead slot Vp-1)
      edge_metric[Ep]     i32  directed metric <= METRIC_MAX; INF padding
      node_overloaded[Vp] bool node overload (no-transit) bits
      node_mask[Vp]       bool live node slots
    """

    num_nodes: int
    num_edges: int
    edge_src: np.ndarray
    edge_dst: np.ndarray
    edge_metric: np.ndarray
    node_overloaded: np.ndarray
    node_mask: np.ndarray
    node_names: list[str]
    # (src_id, dst_id) -> [(if_name, metric, weight, adj_label, other_if)]
    adj_details: dict[tuple[int, int], list[tuple[str, int, int, int, str]]]
    name_to_id: dict[str, int]
    version: int = 0
    base_version: int = 0

    def details(self, u: int, v: int):
        """Adjacency details for edge (u, v)."""
        return self.adj_details[(u, v)]

    @property
    def padded_nodes(self) -> int:
        return len(self.node_mask)


class LinkState:
    """The per-area adjacency graph.

      * a directed edge u->v is usable only if v reports an adjacency
        back to u (bidirectional check);
      * an overloaded adjacency drains both directions of that link;
      * an overloaded node is never used for transit, but stays
        reachable as a destination.
    """

    def __init__(self, area: str = DEFAULT_AREA):
        self.area = area
        self._adj_dbs: dict[str, AdjacencyDatabase] = {}
        self._csr: CsrGraph | None = None

    def update_adjacency_db(self, db: AdjacencyDatabase) -> bool:
        """Insert/replace a node's adjacency database; True if the
        topology changed."""
        if self._adj_dbs.get(db.this_node_name) == db:
            return False
        self._adj_dbs[db.this_node_name] = db
        self._csr = None
        return True

    @property
    def nodes(self) -> list[str]:
        return sorted(self._adj_dbs)

    def adjacency_db(self, node: str) -> AdjacencyDatabase | None:
        return self._adj_dbs.get(node)

    def link_drained_by_peer(self, me: str, adj) -> bool:
        """Whether the far side of `me`'s adjacency soft-drained it."""
        db = self._adj_dbs.get(adj.other_node_name)
        if db is None:
            return False
        return any(
            x.if_name == adj.other_if_name
            and x.other_node_name == me
            and x.is_overloaded
            for x in db.adjacencies
        )

    def node_label(self, node: str) -> int:
        db = self._adj_dbs.get(node)
        return db.node_label if db else 0

    def to_csr(self) -> CsrGraph:
        """Build (or return the cached) padded CSR arrays."""
        if self._csr is None:
            self._csr = self._build_csr()
        return self._csr

    def _build_csr(self) -> CsrGraph:
        names = sorted(self._adj_dbs)  # deterministic interning
        name_to_id = {n: i for i, n in enumerate(names)}
        v = len(names)

        has_reverse: set[tuple[str, str]] = set()
        drained: set[tuple[str, str]] = set()
        for node, db in self._adj_dbs.items():
            for adj in db.adjacencies:
                has_reverse.add((node, adj.other_node_name))
                if adj.is_overloaded:
                    drained.add((node, adj.if_name))

        adj_details: dict[tuple[int, int], list] = {}
        edge_best: dict[tuple[int, int], int] = {}
        for node in names:
            u = name_to_id[node]
            for adj in self._adj_dbs[node].adjacencies:
                if adj.other_node_name not in name_to_id:
                    continue  # neighbor's adj db not yet received
                if (adj.other_node_name, node) not in has_reverse:
                    continue  # bidirectional check failed
                if adj.is_overloaded or (
                    adj.other_node_name, adj.other_if_name
                ) in drained:
                    continue  # drained link (either side, both dirs)
                key = (u, name_to_id[adj.other_node_name])
                adj_details.setdefault(key, []).append(
                    (
                        adj.if_name,
                        int(adj.metric),
                        int(adj.weight),
                        int(adj.adj_label),
                        adj.other_if_name,
                    )
                )
                # parallel links: SPF uses the min metric
                m = int(adj.metric)
                if key not in edge_best or m < edge_best[key]:
                    edge_best[key] = m
        e = len(edge_best)

        vp = pad_bucket(max(v, 1) + 1)  # +1 dead slot for padding edges
        ep = pad_bucket(max(e, 1), minimum=128)
        edge_src = np.zeros(ep, dtype=np.int32)
        edge_dst = np.full(ep, vp - 1, dtype=np.int32)
        edge_metric = np.full(ep, INF_METRIC, dtype=np.int32)
        items = sorted(edge_best.items(), key=lambda kv: (kv[0][1], kv[0][0]))
        for i, ((s, d), m) in enumerate(items):
            edge_src[i] = s
            edge_dst[i] = d
            edge_metric[i] = min(m, METRIC_MAX)

        node_overloaded = np.zeros(vp, dtype=bool)
        node_mask = np.zeros(vp, dtype=bool)
        for n, i in name_to_id.items():
            node_mask[i] = True
            node_overloaded[i] = self._adj_dbs[n].is_overloaded

        ver = next_csr_version()
        return CsrGraph(
            num_nodes=v,
            num_edges=e,
            edge_src=edge_src,
            edge_dst=edge_dst,
            edge_metric=edge_metric,
            node_overloaded=node_overloaded,
            node_mask=node_mask,
            node_names=names,
            adj_details=adj_details,
            name_to_id=name_to_id,
            version=ver,
            base_version=ver,
        )


class PrefixState:
    """prefix -> {advertising node -> PrefixEntry} for one area."""

    def __init__(self, area: str = DEFAULT_AREA):
        self.area = area
        self._entries: dict[IpPrefix, dict[str, PrefixEntry]] = {}
        self._rev = 0
        self._view: tuple | None = None
        # lineage id: keeps generation tokens of independent instances
        # apart even when their revision counters coincide
        self._lineage = next(_PS_LINEAGE)

    def update_prefix_db(self, db: PrefixDatabase) -> set[IpPrefix]:
        """Apply a node's prefix advertisement; returns changed prefixes."""
        changed: set[IpPrefix] = set()
        node = db.this_node_name
        if db.delete_prefix:
            for entry in db.prefix_entries:
                if self.withdraw(node, entry.prefix):
                    changed.add(entry.prefix)
            return changed
        for entry in db.prefix_entries:
            per_node = self._entries.setdefault(entry.prefix, {})
            if per_node.get(node) != entry:
                per_node[node] = entry
                changed.add(entry.prefix)
        if changed:
            self._rev += 1
        return changed

    def election_view(self, name_to_id: dict, base_version: int):
        """Cached election classification (`election.ElectView`), keyed
        on (lineage, prefix revision, topology base)."""
        key = (self._lineage, self._rev, base_version)
        if self._view is not None and self._view[0] == key:
            return self._view[1]
        from openr_tpu_torch.decision.election import build_elect_view

        view = build_elect_view(self._entries, name_to_id, key)
        self._view = (key, view)
        return view

    def withdraw(self, node: str, prefix: IpPrefix) -> bool:
        per_node = self._entries.get(prefix)
        if per_node and node in per_node:
            del per_node[node]
            if not per_node:
                del self._entries[prefix]
            self._rev += 1
            return True
        return False

    @property
    def prefixes(self) -> dict[IpPrefix, dict[str, PrefixEntry]]:
        return self._entries

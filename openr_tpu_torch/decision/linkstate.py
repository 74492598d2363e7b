"""LSDB state: the graph (LinkState) and advertised prefixes (PrefixState).

The port's copy of `openr_tpu/decision/linkstate.py`. `LinkState` keeps
the authoritative graph keyed by names and materializes a padded CSR
edge list (`CsrGraph`) on demand. A metric-only change does not rebuild
it: the change joins a pending list, and `to_csr()` returns a
copy-on-write patched view of the cached base that keeps the base's
`base_version` and carries the cumulative `MetricPatch` journal, which
the solver scatters into its device tables. A structural change
(adjacency set, overload bits, labels, weights) drops the base.
"""

from __future__ import annotations

import itertools
from dataclasses import dataclass, field, replace

import numpy as np

from openr_tpu_torch.common.constants import DEFAULT_AREA, DIST_INF, METRIC_MAX
from openr_tpu_torch.common.util import pad_bucket
from openr_tpu_torch.types.network import IpPrefix
from openr_tpu_torch.types.topology import (
    Adjacency,
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


@dataclass(frozen=True)
class MetricPatch:
    """One metric-only edge update in a CsrGraph patch journal: the slot
    in the edge-list arrays (`edge_idx`) and in the dense in-neighbor
    layout (`dense_row` = destination, `dense_col` = the edge's rank
    among the destination's in-edges), and the new clamped metric."""

    edge_idx: int
    dense_row: int
    dense_col: int
    metric: int


@dataclass
class CsrGraph:
    """Padded edge-list view of the LSDB, sorted by destination.

      edge_src[Ep]        i32  source node id (0 for padding)
      edge_dst[Ep]        i32  destination id (padding -> dead slot Vp-1)
      edge_metric[Ep]     i32  directed metric <= METRIC_MAX; INF padding
      node_overloaded[Vp] bool node overload (no-transit) bits
      node_mask[Vp]       bool live node slots

    A patched view shares its base's arrays except `edge_metric`, keeps
    its `base_version` and `edge_index`, and carries the cumulative
    journal of the patches that produced it in `patches`.
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
    # metric-patched details overriding adj_details (churned edges only;
    # the shared base dict stays untouched). Read through `details()`.
    adj_overrides: dict[tuple[int, int], list] = field(default_factory=dict)
    # (src_id, dst_id) -> edge-array slot (built once per base)
    edge_index: dict[tuple[int, int], int] = field(default_factory=dict)
    version: int = 0
    base_version: int = 0
    patches: tuple[MetricPatch, ...] = ()
    _row_start: np.ndarray | None = None
    # dense in-neighbor tables (nbr, wgt), built on first use; a patched
    # view carries its base's nbr and a patched copy of wgt
    _dense: tuple[np.ndarray, np.ndarray] | None = None
    # D of the dense tables, known before (or without) building them
    _dense_width: int | None = None

    def details(self, u: int, v: int):
        """Adjacency details for edge (u, v), override-aware."""
        got = self.adj_overrides.get((u, v))
        return got if got is not None else self.adj_details[(u, v)]

    def details_get(self, u: int, v: int, default=None):
        got = self.adj_overrides.get((u, v))
        if got is not None:
            return got
        return self.adj_details.get((u, v), default)

    @property
    def padded_nodes(self) -> int:
        return len(self.node_mask)

    def dense_width(self) -> int:
        """D of the dense tables without building them (an O(E) bincount,
        cached): the dense-or-edge-list choice is made before the tables'
        memory is spent. The valid edge set never changes within a
        CsrGraph's base (patches only move metrics below INF)."""
        if self._dense_width is None:
            valid = self.edge_metric < DIST_INF
            if not valid.any():
                self._dense_width = 8
            else:
                indeg = np.bincount(
                    self.edge_dst[valid].astype(np.int64),
                    minlength=self.padded_nodes,
                )
                self._dense_width = pad_bucket(int(indeg.max()), minimum=8)
        return self._dense_width

    def row_start(self) -> np.ndarray:
        """First dst-sorted edge slot per destination node (cached: the
        edge structure of a CsrGraph never changes)."""
        if self._row_start is None:
            counts = np.bincount(
                self.edge_dst[: self.num_edges].astype(np.int64),
                minlength=self.padded_nodes,
            )
            self._row_start = np.concatenate(
                ([0], np.cumsum(counts))
            ).astype(np.int64)
        return self._row_start

    def dense_col(self, edge_idx: int, dst: int) -> int:
        """Dense-table column of edge slot `edge_idx`: its rank within
        its destination's run of the dst-sorted edge list."""
        return edge_idx - int(self.row_start()[dst])

    def dense_tables(self) -> tuple[np.ndarray, np.ndarray]:
        """Cached dense in-neighbor tables (`ops.spf.build_dense_tables`)."""
        if self._dense is None:
            from openr_tpu_torch.ops.spf import build_dense_tables

            self._dense = build_dense_tables(
                self.edge_src, self.edge_dst, self.edge_metric,
                self.padded_nodes,
            )
        return self._dense


def _metric_only_delta(
    old: AdjacencyDatabase, new: AdjacencyDatabase
) -> list[Adjacency] | None:
    """The adjacencies whose metric (or rtt) changed, or None if anything
    structural differs (adjacency set, overload bits, labels, weights)."""
    if (
        old.this_node_name != new.this_node_name
        or old.is_overloaded != new.is_overloaded
        or old.node_label != new.node_label
        or len(old.adjacencies) != len(new.adjacencies)
    ):
        return None
    delta: list[Adjacency] = []
    for oa, na in zip(old.adjacencies, new.adjacencies):
        if oa is na:
            continue
        if (
            oa.other_node_name != na.other_node_name
            or oa.if_name != na.if_name
            or oa.other_if_name != na.other_if_name
            or oa.adj_label != na.adj_label
            or oa.is_overloaded != na.is_overloaded
            or oa.weight != na.weight
        ):
            return None
        if oa.metric != na.metric or oa.rtt_us != na.rtt_us:
            delta.append(na)
    return delta


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
        # bumped on every applied mutation, carried by snapshots
        self.rev = 0
        # CSR cache cell [base, patched view, pending entries applied],
        # shared with snapshots so that a CSR one of them builds serves
        # the others; a mutation replaces the cell, never clears it
        self._csr_cell: list = [None, None, 0]
        # metric-only changes since the cell's base, applied at to_csr()
        # time; rebound on append (never mutated in place), so snapshots
        # keep a consistent prefix of it
        self._pending: list[tuple[str, Adjacency]] = []

    def update_adjacency_db(self, db: AdjacencyDatabase) -> bool:
        """Insert/replace a node's adjacency database; True if the
        topology changed."""
        return self.update_adjacency_db_delta(db)[0]

    def update_adjacency_db_delta(
        self, db: AdjacencyDatabase
    ) -> tuple[bool, list[tuple[str, str]] | None]:
        """Insert/replace a node's adjacency database: (changed, pairs),
        `pairs` the directed (node, neighbor) edges whose metric (or
        rtt) changed when the update was metric-only, None for any
        structural change or a first insert."""
        old = self._adj_dbs.get(db.this_node_name)
        if old == db:
            return False, []
        self._adj_dbs[db.this_node_name] = db
        self.rev += 1
        delta = _metric_only_delta(old, db) if old is not None else None
        pairs = (
            [(db.this_node_name, a.other_node_name) for a in delta]
            if delta is not None
            else None
        )
        base = self._csr_cell[0]
        if base is not None and delta is not None:
            if (
                len(self._pending) + len(delta)
                <= max(64, base.num_edges // 8)  # compaction cap
            ):
                self._pending = self._pending + [
                    (db.this_node_name, a) for a in delta
                ]
                return True, pairs
        self._csr_cell = [None, None, 0]
        self._pending = []
        return True, pairs

    def delete_adjacency_db(self, node: str) -> bool:
        if node in self._adj_dbs:
            del self._adj_dbs[node]
            self.rev += 1
            self._csr_cell = [None, None, 0]
            self._pending = []
            return True
        return False

    def snapshot(self) -> "LinkState":
        """O(V) consistent copy sharing the CSR cache cell."""
        snap = LinkState(self.area)
        snap._adj_dbs = dict(self._adj_dbs)
        snap.rev = self.rev
        snap._csr_cell = self._csr_cell
        snap._pending = self._pending
        return snap

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

    def effective_metric(self, u: str, v: str) -> int | None:
        """Current directed SPF weight u->v (min clamped metric over the
        usable parallel adjacencies), or None without a usable edge; the
        same usability rules as `_build_csr`, for one pair."""
        db = self._adj_dbs.get(u)
        dbv = self._adj_dbs.get(v)
        if db is None or dbv is None:
            return None
        if not any(x.other_node_name == u for x in dbv.adjacencies):
            return None  # bidirectional check failed
        best: int | None = None
        for a in db.adjacencies:
            if a.other_node_name != v or a.is_overloaded:
                continue
            if self.link_drained_by_peer(u, a):
                continue
            m = min(int(a.metric), METRIC_MAX)
            if best is None or m < best:
                best = m
        return best

    def to_csr(self) -> CsrGraph:
        """Build (or return the cached) padded CSR arrays; with
        metric-only changes pending, a patched view of the cached base
        that carries the cumulative patch journal."""
        cell = self._csr_cell
        if cell[0] is None:
            cell[0] = self._build_csr()
            cell[1], cell[2] = None, 0
            self._pending = []
        base = cell[0]
        pending = self._pending
        if not pending:
            return base
        patched, upto = cell[1], cell[2]
        if patched is None:
            patched = self._apply_pending(base, pending)
        elif upto < len(pending):
            # patch only the suffix that arrived since the last view
            patched = self._apply_pending(patched, pending[upto:])
        elif upto > len(pending):
            # the shared cell is ahead of this snapshot: a consistent
            # view from the base, leaving the shared progress alone
            return self._apply_pending(base, pending)
        cell[1], cell[2] = patched, len(pending)
        return patched

    def _apply_pending(
        self, base: CsrGraph, pending: list[tuple[str, Adjacency]]
    ) -> CsrGraph:
        new_metric = base.edge_metric.copy()
        overrides = dict(base.adj_overrides)
        dense = base._dense
        wgt = dense[1].copy() if dense is not None else None
        touched: dict[tuple[int, int], list[list]] = {}
        for node, adj in pending:
            u = base.name_to_id.get(node)
            w = base.name_to_id.get(adj.other_node_name)
            if u is None or w is None:
                continue
            key = (u, w)
            if key not in base.edge_index:
                continue  # edge unusable in the base (one-sided/drained)
            lst = touched.get(key)
            if lst is None:
                lst = touched[key] = [list(d) for d in base.details(*key)]
            for d in lst:
                if d[0] == adj.if_name and d[4] == adj.other_if_name:
                    d[1] = int(adj.metric)
        journal = list(base.patches)
        for key, lst in touched.items():
            overrides[key] = [tuple(d) for d in lst]
            m = min(min(d[1] for d in lst), METRIC_MAX)
            idx = base.edge_index[key]
            new_metric[idx] = m
            col = base.dense_col(idx, key[1])
            if wgt is not None:
                wgt[key[1], col] = m
            journal.append(MetricPatch(idx, key[1], col, int(m)))
        return replace(
            base,
            edge_metric=new_metric,
            adj_overrides=overrides,
            _dense=(dense[0], wgt) if dense is not None else None,
            version=next_csr_version(),
            patches=tuple(journal),
        )

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
        edge_index: dict[tuple[int, int], int] = {}
        for i, ((s, d), m) in enumerate(items):
            edge_src[i] = s
            edge_dst[i] = d
            edge_metric[i] = min(m, METRIC_MAX)
            edge_index[(s, d)] = i

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
            edge_index=edge_index,
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

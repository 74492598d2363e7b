"""The port's SPF backend: the cold single-root RIB solve on the split
path and its warm rebuild after a metric-only delta (port of
`TpuSpfSolver` in `openr_tpu/decision/spf_backend.py`).

The SPF batch for one node's RIB is {self} ∪ neighbors(self): the root
column gives distances, the neighbor columns the ECMP first-hop matrix
(and LFA). One solve on the device returns one packed uint8 buffer; the
host decodes it and assembles the `RouteDatabase` for plain prefixes,
MPLS node segments and MPLS adjacency labels. The device tables are
cached per topology base and kept current under metric churn by
scattering the CSR's patch journal. `warm_compute_routes` re-solves from
the previous solve's distances after a link flap and re-assembles only
the routes whose (distance, first hop) changed, through the general
per-prefix path (`assemble_prefix_routes`).

What the port does not cover raises `NotImplementedError` naming its
ROADMAP item rather than returning partial routes: multi-advertiser
election in the cold assembly (item 6), and KSP, UCMP weights and
LFA-driven route assembly (item 7).
"""

from __future__ import annotations

import time

import numpy as np
import torch

from openr_tpu_torch.common.constants import MPLS_LABEL_MIN
from openr_tpu_torch.convert import split_tables_from_numpy
from openr_tpu_torch.decision.artifact import SolveArtifact, metric_key
from openr_tpu_torch.ops import relax
from openr_tpu_torch.ops.spf import INF_DIST, METRIC_MAX, pad_batch
from openr_tpu_torch.ops.spf_split import (
    batched_sssp_split_rib,
    batched_sssp_split_warm_rib,
    build_split_tables,
    check_byte_order,
    tight_nodes,
    unpack_rib_buffer,
)
from openr_tpu_torch.types.network import (
    MplsAction,
    MplsActionType,
    NextHop,
    sorted_nexthops,
)
from openr_tpu_torch.types.routes import (
    NexthopIntern,
    RibEntry,
    RibMplsEntry,
    RouteDatabase,
)
from openr_tpu_torch.types.topology import ForwardingAlgorithm


def _class_groups(cls_arr: np.ndarray):
    """Index groups of equal values in `cls_arr` (stable order)."""
    if not len(cls_arr):
        return ()
    order = np.argsort(cls_arr, kind="stable")
    bounds = np.nonzero(np.diff(cls_arr[order]))[0] + 1
    return np.split(order, bounds)


def _dest_classes(fh: np.ndarray, d_root: np.ndarray, n_live: int):
    """(class id per live node, token per class) for the (first-hop
    column, igp) equivalence relation."""
    packed = np.packbits(fh[:, :n_live], axis=0)  # [P, n_live]
    igp32 = np.ascontiguousarray(d_root[:n_live].astype(np.int32))
    p = packed.shape[0]
    width = p + 4
    key = np.zeros((n_live, 8 if width <= 8 else width), np.uint8)
    key[:, :p] = packed.T
    key[:, p : p + 4] = igp32.view(np.uint8).reshape(n_live, 4)
    if width <= 8:
        tokens, inv = np.unique(key.view(np.int64).ravel(), return_inverse=True)
        return inv, [int(t) for t in tokens]
    ucls, inv = np.unique(key, axis=0, return_inverse=True)
    return inv, [u.tobytes() for u in ucls]


class LazyDist:
    """Device-resident [vp, B] distance matrix, copied to the host only
    on demand; `[:, 0]` (any row slice of column 0) is served from the
    root column the packed buffer already brought over."""

    __slots__ = ("_dev", "_d_root", "_np")

    def __init__(self, dev: torch.Tensor, d_root: np.ndarray):
        self._dev = dev
        self._d_root = d_root
        self._np: np.ndarray | None = None

    @property
    def shape(self):
        return tuple(self._dev.shape)

    @property
    def dtype(self):
        return np.dtype(np.int32)

    @property
    def device_tensor(self) -> torch.Tensor:
        return self._dev

    def _materialize(self) -> np.ndarray:
        if self._np is None:
            self._np = self._dev.cpu().numpy()
        return self._np

    def __array__(self, dtype=None, copy=None):
        a = self._materialize()
        if dtype is not None and np.dtype(dtype) != a.dtype:
            return a.astype(dtype)
        return a

    def __getitem__(self, key):
        if (
            isinstance(key, tuple)
            and len(key) == 2
            and isinstance(key[0], slice)
            and not isinstance(key[1], slice)
            and np.ndim(key[1]) == 0
            and int(key[1]) == 0
        ):
            return self._d_root[key[0]]
        return self._materialize()[key]


def resolve_device(device) -> torch.device:
    """`None` means the card. Raises when CUDA is asked for and absent."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "TorchSpfSolver runs on CUDA by default and no CUDA device "
            "is available; pass device='cpu' to run the plain version"
        )
    return dev


class TorchSpfSolver:
    """Computes a node's RouteDatabase from the padded CSR LSDB, on
    `device` (default: the CUDA card)."""

    def __init__(self, device=None, enable_lfa: bool = False):
        self.device = resolve_device(device)
        self.enable_lfa = enable_lfa
        # base_version -> {"version", "journal_len", "tables"}: one device
        # table set per topology base (small LRU), kept current under
        # metric-only churn by scattering the CSR's patch journal
        self._dev: dict[int, dict] = {}
        self._dev_lru_cap = 4
        # table set uploads vs patch scatters vs plain hits
        self.dev_cache_stats = {"uploads": 0, "patches": 0, "hits": 0}
        self._nbr_cache: dict[tuple[int, int], list[int]] = {}
        self._labels_cache: dict[tuple, np.ndarray] = {}
        # base_version -> (src-sorted edge order, row starts) for the warm
        # start's host-side cone walk (structural, so churn keeps it)
        self._warm_out: dict[int, tuple] = {}
        self._nh_intern = NexthopIntern()
        # solves on the device (cold or warm), and of those the warm ones
        self.solve_count = 0
        self.warm_solves = 0
        # last solve: sweeps, tail_rounds, spilled, host_syncs,
        # relax_launches
        self.last_solve_stats: dict = {}
        # last warm rebuild: changes, cone_cells, seeds, sweeps,
        # tail_rounds, spilled, host_syncs, relax_launches, and host wall
        # ms of the cone walk (with the old distances' copy to the host),
        # the device solve (scatter to buffer decode) and the scoped
        # assembly
        self.last_warm_stats: dict = {}

    # ------------------------------------------------------------ device

    def _device_arrays(self, csr) -> dict:
        """Device split tables for `csr`. One cache entry per topology
        base: a newer CSR of a cached base scatters the journal suffix
        the entry has not applied; a CSR older than the entry (journals
        cannot be applied backwards) or of an uncached base uploads."""
        cache = self._dev.pop(csr.base_version, None)
        if cache is not None and csr.version >= cache["version"]:
            self._apply_patch_suffix(cache, csr)
            self.dev_cache_stats["hits"] += 1
        else:
            t = build_split_tables(
                csr.edge_src, csr.edge_dst, csr.edge_metric, csr.num_nodes
            )
            cache = {
                "version": csr.version,
                "journal_len": len(csr.patches),
                "tables": split_tables_from_numpy(
                    t, csr.node_overloaded, self.device
                ),
            }
            self.dev_cache_stats["uploads"] += 1
        self._dev[csr.base_version] = cache  # refresh the LRU position
        while len(self._dev) > self._dev_lru_cap:
            self._dev.pop(next(iter(self._dev)))
        return cache["tables"]

    def _apply_patch_suffix(self, cache: dict, csr) -> None:
        """Scatter the journal entries the cache has not applied into
        `base_wgt` (columns < W) and `ov_wgt` (row `ov_pos[row]`, column
        - W), one index write each; clear `uniform_metric` if a patch
        breaks it."""
        if cache["version"] == csr.version:
            return
        done = cache["journal_len"]
        if len(csr.patches) > done:
            self.dev_cache_stats["patches"] += 1
            # the last patch of a slot wins: one write per slot keeps the
            # index write free of duplicate targets
            last = {
                (p.dense_row, p.dense_col): p.metric
                for p in csr.patches[done:]
            }
            rows = np.fromiter((k[0] for k in last), np.int64, len(last))
            cols = np.fromiter((k[1] for k in last), np.int64, len(last))
            vals = np.fromiter(last.values(), np.int32, len(last))
            tab = cache["tables"]
            w, ov_pos = tab["host"]["base_w"], tab["host"]["ov_pos"]
            if tab["uniform_metric"] and bool(
                (vals != tab["uniform_metric"]).any()
            ):
                tab["uniform_metric"] = 0
            for name, sel, r, c in (
                ("base_wgt", cols < w, rows, cols),
                ("ov_wgt", cols >= w, ov_pos[rows], cols - w),
            ):
                if sel.any():
                    tab[name].index_put_(
                        (self._to_dev(r[sel]), self._to_dev(c[sel])),
                        self._to_dev(vals[sel]),
                    )
            cache["journal_len"] = len(csr.patches)
        cache["version"] = csr.version

    def _to_dev(self, a: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(a)).to(self.device)

    def solve_vp(self, csr) -> int:
        return tight_nodes(csr.num_nodes)

    def solve(self, ls, my_node: str):
        """Distances + the ECMP first-hop matrix for my_node's RIB:
        returns (csr, dist, fh, neighbor_ids, lfa) — dist a `LazyDist`,
        fh/lfa host bool [B-1, vp] (lfa None unless enable_lfa) — or
        None if my_node is not in the topology."""
        csr = ls.to_csr()
        my_id = csr.name_to_id.get(my_node)
        if my_id is None:
            return None
        nbr_key = (csr.base_version, my_id)
        nbr_ids = self._nbr_cache.get(nbr_key)
        if nbr_ids is None:
            nbr_ids = sorted(d for (s, d) in csr.adj_details if s == my_id)
            self._nbr_cache[nbr_key] = nbr_ids
            while len(self._nbr_cache) > 4 * self._dev_lru_cap:
                self._nbr_cache.pop(next(iter(self._nbr_cache)))
        n = len(nbr_ids)
        b = pad_batch(1 + n)
        nbr_metric_real = np.empty(n, dtype=np.int32)
        for i, d in enumerate(nbr_ids):
            # same METRIC_MAX clamp as the CSR builder
            nbr_metric_real[i] = min(
                min(det[1] for det in csr.details(my_id, d)), METRIC_MAX
            )
        roots, nbr_ids_p, nbr_metric, nbr_over = self._rib_pad_arrays(
            csr, my_id, nbr_ids, nbr_metric_real, b
        )

        dev = self._device_arrays(csr)
        vp = dev["vp"]
        has_over = bool(csr.node_overloaded.any())
        d = self.device
        self.solve_count += 1
        stats: dict = {}
        launches0 = relax.LAUNCHES
        dist_dev, packed = batched_sssp_split_rib(
            dev,
            torch.from_numpy(roots).to(d),
            torch.from_numpy(nbr_metric).to(d),
            torch.from_numpy(nbr_ids_p).to(d),
            torch.from_numpy(nbr_over).to(d),
            my_id,
            has_overloads=has_over,
            with_lfa=self.enable_lfa,
            stats=stats,
        )
        check_byte_order(d)
        buf = packed.cpu().numpy()
        stats["relax_launches"] = relax.LAUNCHES - launches0
        self.last_solve_stats = stats
        d_root, fh, lfa = unpack_rib_buffer(buf, vp, b, self.enable_lfa)
        return csr, LazyDist(dist_dev, d_root), fh, nbr_ids, lfa

    def _rib_pad_arrays(
        self, csr, my_id: int, nbr_ids: list[int], nbr_metric_real, b: int
    ):
        """Pad the neighbor-shaped arrays to the roots' bucket. Padding:
        dead-slot id, METRIC_MAX metric, overloaded=True — can never
        satisfy the first-hop identity."""
        n = len(nbr_ids)
        dead = self.solve_vp(csr) - 1
        nbr_ids_p = np.full(b - 1, dead, dtype=np.int32)
        nbr_ids_p[:n] = nbr_ids
        nbr_metric = np.full(b - 1, METRIC_MAX, dtype=np.int32)
        nbr_metric[:n] = nbr_metric_real
        nbr_over = np.ones(b - 1, dtype=bool)
        if n:
            nbr_over[:n] = csr.node_overloaded[np.array(nbr_ids, dtype=np.int64)]
        roots = np.full(b, my_id, dtype=np.int32)  # padding repeats root
        roots[1 : 1 + n] = nbr_ids
        return roots, nbr_ids_p, nbr_metric, nbr_over

    # --------------------------------------------------------------- RIB

    def compute_routes(self, ls, ps, my_node: str,
                       return_artifact: bool = False):
        """Full RIB of my_node. With `return_artifact=True`, returns
        (rdb, SolveArtifact | None): the artifact wraps the solve tuple
        for `assemble_prefix_routes` and `warm_compute_routes`."""
        rdb = RouteDatabase(this_node_name=my_node)
        if self.enable_lfa:
            raise NotImplementedError(
                "LFA-driven route assembly is not ported yet "
                "(ROADMAP item 7: KSP and the general per-prefix path)"
            )
        solved = self.solve(ls, my_node)
        if solved is None:
            return (rdb, None) if return_artifact else rdb
        rdb = self._assemble_routes(rdb, ls, ps, my_node, solved)
        if return_artifact:
            return rdb, self._artifact(my_node, ls, solved)
        return rdb

    def _artifact(self, my_node, ls, solved) -> SolveArtifact:
        return SolveArtifact(
            my_node=my_node, ls=ls, solved=solved, nh_intern=self._nh_intern
        )

    def assemble_prefix_routes(self, art: SolveArtifact, ps, prefixes) -> dict:
        """Routes for `prefixes` only, against a cached artifact, with no
        new solve: every prefix goes down the general per-prefix path. A
        prefix absent from the result has no route."""
        csr, dist, fh, nbr_ids, lfa = art.solved
        ls, my_node = art.ls, art.my_node
        my_id = csr.name_to_id[my_node]
        slot_cache = self._nbr_slot_cache(csr, my_id, nbr_ids)
        mk_nexthops_cached = self._mk_nexthops_cached_factory(
            fh, slot_cache, ls.area
        )
        items = []
        for p in sorted(prefixes):
            per_node = ps.prefixes.get(p)
            if per_node:
                items.append((p, dict(per_node)))
        out: dict = {}
        self._unicast_general(
            csr, my_node, dist[:, 0], fh.any(axis=0), lfa,
            mk_nexthops_cached, items, out,
        )
        return out

    def _unicast_general(
        self, csr, my_node, d_root, fh_any, lfa, mk_nexthops_cached, items,
        out: dict,
    ) -> None:
        """The general per-prefix unicast path for plain and ECMP
        (anycast) prefixes, min_nexthop included: writes routes into
        `out`. KSP, UCMP weights and LFA backups raise."""
        if lfa is not None:
            raise NotImplementedError(
                "LFA backup nexthops are not ported yet (ROADMAP item 7: "
                "KSP and the general per-prefix path)"
            )
        for prefix, per_node in items:
            reachable = {}
            for n, e in per_node.items():
                nid = csr.name_to_id.get(n)
                if n == my_node or (
                    nid is not None and d_root[nid] < INF_DIST and fh_any[nid]
                ):
                    reachable[n] = e
            if not reachable:
                continue
            best_key = max(metric_key(e) for e in reachable.values())
            best_nodes = sorted(
                n for n, e in reachable.items() if metric_key(e) == best_key
            )
            if my_node in best_nodes:
                continue  # local prefix
            if (
                reachable[best_nodes[0]].forwarding_algorithm
                == ForwardingAlgorithm.KSP2_ED_ECMP
            ):
                raise NotImplementedError(
                    f"{prefix}: KSP prefixes are not ported yet (ROADMAP "
                    "item 7: KSP and the general per-prefix path)"
                )
            ids = np.array(
                [csr.name_to_id[n] for n in best_nodes], dtype=np.int64
            )
            igps = d_root[ids]
            min_igp = int(igps.min())
            chosen = ids[igps == min_igp]
            chosen_names = sorted(csr.node_names[i] for i in chosen)
            if any(reachable[n].weight > 0 for n in chosen_names):
                raise NotImplementedError(
                    f"{prefix}: UCMP weights are not ported yet (ROADMAP "
                    "item 7: KSP and the general per-prefix path)"
                )
            nexthops = mk_nexthops_cached(chosen, min_igp)
            if not nexthops:
                continue
            best_entry = reachable[chosen_names[0]]
            if best_entry.min_nexthop and len(nexthops) < best_entry.min_nexthop:
                continue
            out[prefix] = RibEntry(
                prefix=prefix,
                nexthops=nexthops,
                best_node=chosen_names[0],
                best_nodes=tuple(best_nodes),
                best_entry=best_entry,
                igp_cost=min_igp,
            )

    # ------------------------------------------------ topology-delta warm

    def _warm_out_index(self, csr):
        """Src-sorted live-edge order + row starts for the cone walk,
        cached per topology base."""
        cached = self._warm_out.get(csr.base_version)
        if cached is None:
            src = csr.edge_src[: csr.num_edges].astype(np.int64)
            order = np.argsort(src, kind="stable")
            row_start = np.zeros(csr.padded_nodes + 1, np.int64)
            np.add.at(row_start, src + 1, 1)
            cached = (order, np.cumsum(row_start))
            self._warm_out[csr.base_version] = cached
            while len(self._warm_out) > self._dev_lru_cap:
                self._warm_out.pop(next(iter(self._warm_out)))
        return cached

    def _warm_cone(self, old_csr, old_mat, changes, roots_real,
                   cells_budget):
        """Per-column increase cones: the closure, over edges tight under
        the OLD weights, of each raised edge's head (every node whose
        distance can rise is inside). Returns (scatter rows, scatter
        cols, seed mask, union cone), or None once the cone cells summed
        over the columns exceed `cells_budget` (the walk is host Python;
        past the budget the cold solve is cheaper)."""
        order, row_start = self._warm_out_index(old_csr)
        dst = old_csr.edge_dst
        met = old_csr.edge_metric  # the previous solve's weights
        over = old_csr.node_overloaded
        inf = int(INF_DIST)
        vp, b = old_mat.shape
        seed = np.zeros(vp, bool)
        rows_all: list[int] = []
        cols_all: list[int] = []
        raised = [(u, v, wo) for (u, v, wo, wn) in changes if wn > wo]
        for u, v, wo, wn in changes:
            if wn < wo:
                seed[v] = True  # lowered edge: its head re-pulls
        cone_union: set[int] = set()
        col0_cone: set[int] = set()
        cells = 0
        for c, r in enumerate(roots_real):
            col = old_mat[:, c]
            cone: set[int] = set()
            stack: list[int] = []
            for u, v, wo in raised:
                du, dv = int(col[u]), int(col[v])
                if du >= inf or dv >= inf:
                    continue
                if u != r and over[u]:
                    continue  # u is never relaxed from in this column
                if du + wo == dv and v not in cone:
                    cone.add(v)
                    stack.append(v)
            while stack:
                x = stack.pop()
                if cells + len(cone) > cells_budget:
                    return None
                if x != r and over[x]:
                    continue
                dx = int(col[x])
                for i in order[row_start[x] : row_start[x + 1]]:
                    y = int(dst[i])
                    wo = int(met[i])
                    if wo >= inf:
                        continue
                    dy = int(col[y])
                    if dy < inf and dx + wo == dy and y not in cone:
                        cone.add(y)
                        stack.append(y)
            cells += len(cone)
            for x in cone:
                rows_all.append(x)
                cols_all.append(c)
                seed[x] = True
            if c == 0:
                col0_cone = cone
            cone_union |= cone
        # padding columns repeat the root: give them column 0's cone so
        # they stay upper bounds of the same fixpoint
        for c in range(len(roots_real), b):
            for x in col0_cone:
                rows_all.append(x)
                cols_all.append(c)
        return rows_all, cols_all, seed, cone_union

    def warm_compute_routes(
        self, art: SolveArtifact, ls, ps, my_node: str, edge_pairs,
        prefix_dirt, cached_rdb: RouteDatabase, max_frac: float,
    ):
        """Topology-delta warm rebuild: re-solve the {self} ∪ neighbors
        batch seeded from the artifact's solve, then re-assemble only the
        routes whose (distance, first-hop) class changed, plus
        `prefix_dirt`.

        Returns (rdb, new artifact, touched prefixes, touched MPLS
        labels, region size), or None to demand a cold solve: LFA on, an
        artifact without distance columns, a structural change (new CSR
        base), an unknown endpoint, a root-incident change, more changed
        edges than `max_frac` of the graph (at least 16), or a cone walk
        over its cell budget. The artifact's distances are left as they
        were: the warm solve relaxes a copy."""
        if self.enable_lfa or art.solved is None:
            return None
        old_csr, old_dist, old_fh, nbr_ids, lfa = art.solved
        if lfa is not None or not isinstance(old_dist, LazyDist):
            return None
        csr = ls.to_csr()
        if csr.base_version != old_csr.base_version:
            return None  # structural change: interning/base moved
        my_id = csr.name_to_id.get(my_node)
        if my_id is None:
            return None
        changes: list[tuple[int, int, int, int]] = []
        for u, v in sorted(edge_pairs):
            uid = csr.name_to_id.get(u)
            vid = csr.name_to_id.get(v)
            if uid is None or vid is None:
                return None  # unknown endpoint: not metric-only after all
            if uid == my_id:
                return None  # root-incident
            idx = csr.edge_index.get((uid, vid))
            if idx is None:
                continue  # edge unusable in this base: cannot matter
            w_old = int(old_csr.edge_metric[idx])
            w_new = int(csr.edge_metric[idx])
            if w_old != w_new:
                changes.append((uid, vid, w_old, w_new))
        if len(changes) > max(16, int(max_frac * max(csr.num_edges, 1))):
            return None
        cells_budget = max(100_000, 8 * csr.num_nodes)
        n_live = len(csr.node_names)
        if not changes:
            # the flap reverted within one window: reuse the solve,
            # reassemble only the prefix dirt
            art2 = self._artifact(
                my_node, ls, (csr, old_dist, old_fh, nbr_ids, None)
            )
            changed_ids = np.zeros(0, np.int64)
            region = 0
            self.last_warm_stats = {"changes": 0}
        else:
            t0 = time.perf_counter()
            cone = self._warm_cone(
                old_csr, np.asarray(old_dist), changes, [my_id, *nbr_ids],
                cells_budget,
            )
            cone_ms = (time.perf_counter() - t0) * 1e3
            if cone is None:
                return None
            t0 = time.perf_counter()
            rows_all, cols_all, seed, cone_union = cone
            dev = self._device_arrays(csr)
            vp = dev["vp"]
            bb = pad_batch(1 + len(nbr_ids))
            nbr_metric_real = np.empty(len(nbr_ids), dtype=np.int32)
            for i, d in enumerate(nbr_ids):
                nbr_metric_real[i] = min(
                    min(det[1] for det in csr.details(my_id, d)), METRIC_MAX
                )
            roots, nbr_ids_p, nbr_metric, nbr_over = self._rib_pad_arrays(
                csr, my_id, nbr_ids, nbr_metric_real, bb
            )
            # a copy: the caller's artifact keeps its distances
            dist0 = old_dist.device_tensor.clone()
            if rows_all:
                dist0[self._to_dev(np.asarray(rows_all, np.int64)),
                      self._to_dev(np.asarray(cols_all, np.int64))] = INF_DIST
            stats: dict = {}
            launches0 = relax.LAUNCHES
            dist2, packed = batched_sssp_split_warm_rib(
                dev, self._to_dev(roots), self._to_dev(nbr_metric),
                self._to_dev(nbr_ids_p), self._to_dev(nbr_over), dist0,
                self._to_dev(seed),
                has_overloads=bool(csr.node_overloaded.any()),
                stats=stats,
            )
            check_byte_order(self.device)
            buf = packed.cpu().numpy()
            stats["relax_launches"] = relax.LAUNCHES - launches0
            d_root, fh, _ = unpack_rib_buffer(buf, vp, bb, False)
            self.solve_count += 1
            self.warm_solves += 1
            old_d_root = old_dist[:, 0]
            changed = (d_root[:n_live] != old_d_root[:n_live]) | (
                fh[:, :n_live] != old_fh[:, :n_live]
            ).any(axis=0)
            changed_ids = np.nonzero(changed)[0]
            region = len(cone_union | set(changed_ids.tolist()))
            art2 = self._artifact(
                my_node, ls,
                (csr, LazyDist(dist2, d_root), fh, nbr_ids, None),
            )
            self.last_warm_stats = {
                "changes": len(changes), "cone_cells": len(rows_all),
                "seeds": int(seed.sum()), **stats, "cone_walk_ms": cone_ms,
                "solve_ms": (time.perf_counter() - t0) * 1e3,
            }

        # ---- scoped reassembly ---------------------------------------
        t0 = time.perf_counter()
        _c2, dist2, fh2, _n2, _l2 = art2.solved
        d_root2 = dist2[:, 0]
        changed_mask = np.zeros(csr.padded_nodes, bool)
        changed_mask[changed_ids] = True
        view = ps.election_view(csr.name_to_id, csr.base_version)
        touched = set(prefix_dirt)
        if len(view.plain_p):
            for i in np.nonzero(changed_mask[view.orig])[0]:
                touched.add(view.plain_p[int(i)])
        if view.multi is not None:
            # anycast: the election depends only on its advertisers'
            # (distance, first-hop) classes
            t = view.multi
            hit = t.known & changed_mask[t.adv]
            for i in np.unique(t.seg[hit]).tolist():
                touched.add(t.prefixes[i])
        for p, _per in view.complex_items:
            touched.add(p)  # cheap, always re-assembled (exact)
        entries = self.assemble_prefix_routes(art2, ps, touched)
        rdb = RouteDatabase(this_node_name=my_node)
        rdb.unicast_routes = dict(cached_rdb.unicast_routes)
        rdb.mpls_routes = dict(cached_rdb.mpls_routes)
        for p in touched:
            e = entries.get(p)
            if e is None:
                rdb.unicast_routes.pop(p, None)
            else:
                rdb.unicast_routes[p] = e
        touched_labels: set[int] = set()
        if len(changed_ids):
            labels_v = self._node_labels(ls, csr, n_live)
            slot_cache = self._nbr_slot_cache(csr, my_id, nbr_ids)
            mk = self._mk_nexthops_cached_factory(fh2, slot_cache, ls.area)
            for i in changed_ids.tolist():
                if i == my_id:
                    continue
                label = int(labels_v[i])
                if label < MPLS_LABEL_MIN:
                    continue
                touched_labels.add(label)
                if d_root2[i] >= INF_DIST or not fh2[:, i].any():
                    rdb.mpls_routes.pop(label, None)
                    continue
                nhs = self._mpls_wrap(
                    mk(np.array([i]), int(d_root2[i])), csr.node_names[i],
                    label,
                )
                if nhs:
                    rdb.mpls_routes[label] = RibMplsEntry(
                        label=label, nexthops=nhs
                    )
                else:
                    rdb.mpls_routes.pop(label, None)
        self.last_warm_stats["assembly_ms"] = (time.perf_counter() - t0) * 1e3
        return rdb, art2, touched, touched_labels, region

    def _assemble_routes(self, rdb, ls, ps, my_node, solved):
        csr, dist, fh, nbr_ids, lfa = solved
        view = ps.election_view(csr.name_to_id, csr.base_version)
        if view.multi is not None:
            raise NotImplementedError(
                "multi-advertiser (anycast) election is not ported yet "
                "(ROADMAP item 6: election, kernel E)"
            )
        if lfa is not None:
            raise NotImplementedError(
                "LFA-driven route assembly is not ported yet "
                "(ROADMAP item 7: KSP and the general per-prefix path)"
            )
        my_id = csr.name_to_id[my_node]
        d_root = dist[:, 0]
        fh_any = fh.any(axis=0)
        slot_cache = self._nbr_slot_cache(csr, my_id, nbr_ids)
        mk_nexthops_cached = self._mk_nexthops_cached_factory(
            fh, slot_cache, ls.area
        )
        n_live = len(csr.node_names)
        dest_cls, _tokens = _dest_classes(fh, d_root, n_live)

        # ---- unicast: plain prefixes, one NextHop set per class ----------
        plain_p, plain_n, plain_e = view.plain_p, view.plain_n, view.plain_e
        orig = view.orig
        if len(plain_p):
            reach = (d_root[orig] < INF_DIST) & fh_any[orig] & (orig != my_id)
            igp = d_root[orig].astype(np.int64)
            idxs = np.nonzero(reach)[0]
            cls = dest_cls[orig[idxs]]
            ucls, uidx = np.unique(cls, return_index=True)
            class_nhs = {}
            for c, u in zip(ucls.tolist(), uidx.tolist()):
                i = idxs[u]
                class_nhs[c] = self._mk_nexthops_union(
                    slot_cache, fh[:, orig[i]], int(igp[i]), ls.area
                )
            unicast = rdb.unicast_routes
            for g in _class_groups(cls):
                nhs = class_nhs[int(cls[g[0]])]
                if not nhs:
                    continue
                rows = idxs[g]
                igp_c = int(igp[rows[0]])
                for i in rows.tolist():
                    p = plain_p[i]
                    unicast[p] = RibEntry(
                        prefix=p,
                        nexthops=nhs,
                        best_node=plain_n[i],
                        best_nodes=(plain_n[i],),
                        best_entry=plain_e[i],
                        igp_cost=igp_c,
                    )

        # ---- unicast: the general path for the complex shapes ------------
        self._unicast_general(
            csr, my_node, d_root, fh_any, lfa, mk_nexthops_cached,
            view.complex_items, rdb.unicast_routes,
        )

        # ---- MPLS node segments ------------------------------------------
        names = csr.node_names
        ids = np.arange(n_live, dtype=np.int64)
        labels_v = self._node_labels(ls, csr, n_live)
        elig = (
            (labels_v >= MPLS_LABEL_MIN)
            & (ids != my_id)
            & (d_root[:n_live] < INF_DIST)
            & fh_any[:n_live]
        )
        sel = np.nonzero(elig)[0]
        mpls_routes = rdb.mpls_routes
        cls_sel = dest_cls[sel]
        for g in _class_groups(cls_sel):
            rows = sel[g]
            igp = int(d_root[rows[0]])
            for i in rows.tolist():
                label = int(labels_v[i])
                nhs = self._mpls_wrap(
                    mk_nexthops_cached(np.array([i]), igp), names[i], label
                )
                if nhs:
                    mpls_routes[label] = RibMplsEntry(label=label, nexthops=nhs)

        # ---- MPLS adjacency labels ---------------------------------------
        my_db = ls.adjacency_db(my_node)
        if my_db:
            for a in my_db.adjacencies:
                if a.adj_label < MPLS_LABEL_MIN:
                    continue
                if a.other_node_name not in csr.name_to_id or a.is_overloaded:
                    continue
                if ls.link_drained_by_peer(my_node, a):
                    continue  # far side soft-drained the link
                mpls_routes[a.adj_label] = RibMplsEntry(
                    label=a.adj_label,
                    nexthops=(
                        NextHop(
                            address=a.other_node_name,
                            if_name=a.if_name,
                            metric=int(a.metric),
                            neighbor_node=a.other_node_name,
                            area=ls.area,
                            mpls_action=MplsAction(action=MplsActionType.PHP),
                        ),
                    ),
                )
        return rdb

    # ----------------------------------------------------------- helpers

    @staticmethod
    def _mpls_wrap(base, node: str, label: int) -> tuple[NextHop, ...]:
        """SWAP to `label`, or PHP when the nexthop IS the target."""
        return tuple(
            NextHop(
                address=nh.address,
                if_name=nh.if_name,
                metric=nh.metric,
                neighbor_node=nh.neighbor_node,
                area=nh.area,
                mpls_action=(
                    MplsAction(action=MplsActionType.PHP)
                    if nh.neighbor_node == node
                    else MplsAction(
                        action=MplsActionType.SWAP, swap_label=label
                    )
                ),
            )
            for nh in base
        )

    def _node_labels(self, ls, csr, n_live: int) -> np.ndarray:
        """Per-node MPLS label vector, cached per topology base."""
        key = (ls.area, csr.base_version)
        labels_v = self._labels_cache.get(key)
        if labels_v is None:
            labels_v = np.fromiter(
                (ls.node_label(nm) for nm in csr.node_names), np.int64,
                count=n_live,
            )
            self._labels_cache[key] = labels_v
            while len(self._labels_cache) > self._dev_lru_cap:
                self._labels_cache.pop(next(iter(self._labels_cache)))
        return labels_v

    def _mk_nexthops_cached_factory(self, fh, slot_cache, area: str):
        """Nexthop construction memoized by the union first-hop column."""
        memo: dict[tuple, tuple[NextHop, ...]] = {}

        def mk_nexthops_cached(targets: np.ndarray, igp: int):
            if len(targets) == 1:
                col = fh[:, int(targets[0])]
            else:
                col = fh[:, targets].any(axis=1)
            key = (col.tobytes(), igp)
            got = memo.get(key)
            if got is None:
                got = memo[key] = self._mk_nexthops_union(
                    slot_cache, col, igp, area
                )
            return got

        return mk_nexthops_cached

    @staticmethod
    def _nbr_slot_cache(csr, my_id: int, nbr_ids: list[int]):
        """Per-neighbor (fh_name, if_name) slots at the neighbor's
        min-metric parallel links."""
        cache: list[list[tuple[str, str]]] = []
        for fh_id in nbr_ids:
            details = csr.details(my_id, fh_id)
            best = min(d[1] for d in details)
            fh_name = csr.node_names[fh_id]
            cache.append(
                [
                    (fh_name, if_name)
                    for if_name, m, _w, _lbl, _oif in details
                    if m == best
                ]
            )
        return cache

    def _mk_nexthops_union(self, slot_cache, valid_rows, igp: int, area: str):
        """Unweighted nexthops from a union first-hop column, interned
        into the solver's shared group table."""
        nhs = [
            NextHop(
                address=fh_name,
                if_name=if_name,
                metric=igp,
                neighbor_node=fh_name,
                area=area,
            )
            for n_idx in np.nonzero(valid_rows)[0]
            for (fh_name, if_name) in slot_cache[int(n_idx)]
        ]
        return self._nh_intern.intern(sorted_nexthops(nhs))

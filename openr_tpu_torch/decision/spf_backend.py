"""The port's SPF backend: the cold single-root RIB solve on the split
path (port of `TpuSpfSolver` in `openr_tpu/decision/spf_backend.py`).

The SPF batch for one node's RIB is {self} ∪ neighbors(self): the root
column gives distances, the neighbor columns the ECMP first-hop matrix
(and LFA). One solve on the device returns one packed uint8 buffer; the
host decodes it and assembles the `RouteDatabase` for plain prefixes,
MPLS node segments and MPLS adjacency labels.

What this slice does not cover raises `NotImplementedError` naming its
ROADMAP item rather than returning partial routes: multi-advertiser
election, the general per-prefix path (UCMP, min_nexthop, KSP, unknown
advertisers), and LFA-driven route assembly.
"""

from __future__ import annotations

import numpy as np
import torch

from openr_tpu_torch.common.constants import MPLS_LABEL_MIN
from openr_tpu_torch.convert import split_tables_from_numpy
from openr_tpu_torch.ops import relax
from openr_tpu_torch.ops.spf import INF_DIST, METRIC_MAX, pad_batch
from openr_tpu_torch.ops.spf_split import (
    batched_sssp_split_rib,
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
        # (base_version, version) -> device split-table set (small LRU)
        self._dev: dict[tuple[int, int], dict] = {}
        self._dev_lru_cap = 4
        self._nbr_cache: dict[tuple[int, int], list[int]] = {}
        self._labels_cache: dict[tuple, np.ndarray] = {}
        self._nh_intern = NexthopIntern()
        # last solve: sweeps, tail_rounds, spilled, host_syncs,
        # relax_launches
        self.last_solve_stats: dict = {}

    # ------------------------------------------------------------ device

    def _device_arrays(self, csr) -> dict:
        """Cached device split tables; any CSR change rebuilds them."""
        key = (csr.base_version, csr.version)
        got = self._dev.pop(key, None)
        if got is None:
            t = build_split_tables(
                csr.edge_src, csr.edge_dst, csr.edge_metric, csr.num_nodes
            )
            got = split_tables_from_numpy(t, csr.node_overloaded, self.device)
        self._dev[key] = got  # refresh the LRU position
        while len(self._dev) > self._dev_lru_cap:
            self._dev.pop(next(iter(self._dev)))
        return got

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

    def compute_routes(self, ls, ps, my_node: str) -> RouteDatabase:
        """Full RIB of my_node."""
        rdb = RouteDatabase(this_node_name=my_node)
        if self.enable_lfa:
            raise NotImplementedError(
                "LFA-driven route assembly is not ported yet "
                "(ROADMAP: the general per-prefix path)"
            )
        solved = self.solve(ls, my_node)
        if solved is None:
            return rdb
        return self._assemble_routes(rdb, ls, ps, my_node, solved)

    def _assemble_routes(self, rdb, ls, ps, my_node, solved):
        csr, dist, fh, nbr_ids, lfa = solved
        view = ps.election_view(csr.name_to_id, csr.base_version)
        if view.multi is not None:
            raise NotImplementedError(
                "multi-advertiser (anycast) election is not ported yet "
                "(ROADMAP: election, kernel E)"
            )
        if view.complex_items:
            raise NotImplementedError(
                "prefixes outside the plain shape (UCMP, min_nexthop, KSP, "
                "unknown advertiser) are not ported yet (ROADMAP: KSP, "
                "kernel F, and the general per-prefix path)"
            )
        if lfa is not None:
            raise NotImplementedError(
                "LFA-driven route assembly is not ported yet "
                "(ROADMAP: the general per-prefix path)"
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

"""The port's SPF backend: the cold single-root RIB solve, the batched
multi-root solve on each table kind, the RIB assembly for every prefix
shape, and the warm rebuild after a metric-only delta (port of
`TpuSpfSolver` in `openr_tpu/decision/spf_backend.py`).

Three device table sets serve the batched solve, chosen per topology by
`_pick_table` with the reference's knobs and precedence: "split" (the
default: `ops/spf_split.py`, relax kernel A), "dense" (the in-neighbor
tables swept to the fixpoint by kernel A, `ops/relax.py`
`batched_sssp_relax`, for `use_dense=True` and `use_pallas`) and "edge"
(the edge-list Bellman-Ford, `ops/edge_relax.py`, for `use_dense=False`
or where the dense tables' padding would exceed `dense_waste_limit` x
the edge count). `_solve_dist` runs one of them for any roots; the
single-root RIB solve takes a fused packed-buffer path on "split" and
the first-hop / LFA matrices over `_solve_dist`'s distances otherwise.

The SPF batch for one node's RIB is {self} ∪ neighbors(self): the root
column gives distances, the neighbor columns the ECMP first-hop matrix
(and LFA). One solve on the device returns one packed uint8 buffer; the
host decodes it and assembles the `RouteDatabase`: plain prefixes by
(first hop, distance) class, anycast prefixes through the
multi-advertiser election (`ops/election.py`, on the device past
`elect_device_min` advertiser slots), and UCMP, min_nexthop, LFA backup
and KSP2_ED_ECMP prefixes through the general per-prefix path, whose KSP
jobs run in one batch of k edge-disjoint path rounds on the device
(`ops/ksp.py`); then MPLS node segments and adjacency labels. With
`enable_lfa` every prefix takes the general path. The device tables are
cached per topology base and kept current under metric churn by
scattering the CSR's patch journal. `warm_compute_routes` re-solves from
the previous solve's distances after a link flap and re-assembles only
the routes whose (distance, first hop) changed, through the general
per-prefix path (`assemble_prefix_routes`).
"""

from __future__ import annotations

import logging
import time

import numpy as np
import torch

from openr_tpu_torch.common.constants import MPLS_LABEL_MIN
from openr_tpu_torch.convert import split_tables_from_numpy
from openr_tpu_torch.decision.artifact import SolveArtifact, metric_key
from openr_tpu_torch.decision.election import (
    elect_multi_np,
    iter_multi_winners,
    multi_items,
)
from openr_tpu_torch.decision.ksp import (
    ksp_route_from_paths,
    normalize_weights,
    ucmp_weights,
)
from openr_tpu_torch.monitor import compile_ledger
from openr_tpu_torch.monitor import device as telemetry
from openr_tpu_torch.monitor import work_ledger as _work_ledger
from openr_tpu_torch.monitor.profiling import annotate
from openr_tpu_torch.ops import edge_relax, relax, rib_epilogue
from openr_tpu_torch.ops.election import elect_multi_device
from openr_tpu_torch.ops.ksp import ksp_edge_disjoint_dense, paths_to_host
from openr_tpu_torch.ops.spf import (
    INF_DIST,
    METRIC_MAX,
    build_blocked,
    pad_batch,
)
from openr_tpu_torch.ops.spf_split import (
    ProgramCache,
    batched_sssp_split,
    batched_sssp_split_rib,
    batched_sssp_split_warm_rib,
    build_split_tables,
    check_byte_order,
    pick_gs_chunks,
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

log = logging.getLogger(__name__)


def _class_groups(cls_arr: np.ndarray):
    """Index groups of equal values in `cls_arr` (stable order)."""
    if not len(cls_arr):
        return ()
    order = np.argsort(cls_arr, kind="stable")
    bounds = np.nonzero(np.diff(cls_arr[order]))[0] + 1
    return np.split(order, bounds)


def _class_keys(fh: np.ndarray, d_root: np.ndarray, ids) -> np.ndarray:
    """One row per node of `ids` (a slice or an index array): its packed
    first-hop column, then its igp as int32 bytes, zero-padded to 8 bytes
    where that fits."""
    packed = np.packbits(fh[:, ids], axis=0)  # [P, n]
    n = packed.shape[1]
    igp32 = np.ascontiguousarray(np.asarray(d_root[ids]).astype(np.int32))
    p = packed.shape[0]
    width = p + 4
    key = np.zeros((n, 8 if width <= 8 else width), np.uint8)
    key[:, :p] = packed.T
    key[:, p : p + 4] = igp32.view(np.uint8).reshape(n, 4)
    return key


def _dest_classes(fh: np.ndarray, d_root: np.ndarray, n_live: int):
    """(class id per live node, token per class) for the (first-hop
    column, igp) equivalence relation. A token is the class's content
    (an int of its 8 key bytes, else the bytes), so it survives
    rebuilds and the cross-rebuild caches key on it."""
    key = _class_keys(fh, d_root, slice(0, n_live))
    if key.shape[1] == 8:
        tokens, inv = np.unique(key.view(np.int64).ravel(),
                                return_inverse=True)
        return inv, [int(t) for t in tokens]
    ucls, inv = np.unique(key, axis=0, return_inverse=True)
    return inv, [u.tobytes() for u in ucls]


def _node_tokens(fh: np.ndarray, d_root: np.ndarray, ids) -> list:
    """The `_dest_classes` token of each node in `ids`."""
    key = _class_keys(fh, d_root, np.asarray(ids, dtype=np.int64))
    if key.shape[1] == 8:
        return [int(t) for t in key.view(np.int64).ravel()]
    return [row.tobytes() for row in key]


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
            compile_ledger.record_transfer(self._np.nbytes)
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


def _tensors(table_set: dict) -> list:
    """The tensors of a device table set (and of its edge index)."""
    out = []
    for x in table_set.values():
        if isinstance(x, torch.Tensor):
            out.append(x)
        elif isinstance(x, tuple):
            out.extend(t for t in x if isinstance(t, torch.Tensor))
    return out


def _host(t: torch.Tensor) -> np.ndarray:
    """`t` copied to the host, counted as a transfer."""
    a = t.cpu().numpy()
    compile_ledger.record_transfer(a.nbytes)
    return a


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
    `device` (default: the CUDA card).

    The table knobs are the reference's, with its defaults:
    `use_dense=None` follows `kernel_impl` ("split", or any other value
    for the dense tables unless their padding exceeds `dense_waste_limit`
    x the edge count, where the edge list serves); `use_dense=True` or
    `use_pallas` force the dense tables, `use_dense=False` the edge list.
    On the port `use_pallas` is kernel A itself, so it runs on any
    device. `mesh` (a `parallel.mesh.Mesh`) shards the batched solves on
    the split tables over its positions (`parallel/sharded_spf.py`); the
    single-root RIB solve stays on the solver's device, and a dense or
    edge table, or a shape the mesh does not divide, solves there too,
    with a warning the first time.

    `native_rib` takes the reference's values: "auto" and "off" both
    solve on the solver's device, and "on" (the reference's host C++
    Dijkstra, which the port does not have) raises. `counters` (anything
    with `add_value` and `set`) receives the wall ms of the solver's named
    spans as `profile.<span>_ms` stats and the HBM gauges sampled at their
    ends. `work_ledger` (anything with `commit(stage, touched, delta)`;
    default the port's process ledger, `monitor/work_ledger.py`) receives
    the `election` stage's rounds.
    """

    def __init__(self, device=None, enable_lfa: bool = False,
                 ksp_k: int = 2, *, use_dense: bool | None = None,
                 dense_waste_limit: int = 8, use_pallas: bool = False,
                 kernel_impl: str = "split", native_rib: str = "auto",
                 mesh=None, counters=None, work_ledger=None):
        if native_rib not in ("auto", "off"):
            raise ValueError(
                f"TorchSpfSolver: native_rib={native_rib!r}: the host C++ "
                "SPF engine is not part of the port, which solves on its "
                "device; use 'auto' or 'off'"
            )
        self.native_rib = native_rib
        self.counters = counters
        self.work_ledger = (work_ledger if work_ledger is not None
                            else _work_ledger.ledger())
        self.mesh = mesh
        self._mesh_fallback_warned = False
        # per-position layout of the last sharded solve, which ctrl
        # `get_device_telemetry` reads (empty without a mesh)
        self.last_shard_rows: list[dict] = []
        self.device = resolve_device(device)
        self.enable_lfa = enable_lfa
        # edge-disjoint paths per KSP2_ED_ECMP prefix
        self.ksp_k = ksp_k
        self.use_dense = use_dense
        self.dense_waste_limit = dense_waste_limit
        self.use_pallas = use_pallas
        self.kernel_impl = kernel_impl
        # base_version -> {"version", "journal_len", "sets"}: the device
        # table sets of one topology base ("split", "dense" for the dense
        # solve and KSP, "edge"; small LRU), kept current under
        # metric-only churn by scattering the CSR's patch journal into
        # every set
        self._dev: dict[int, dict] = {}
        self._dev_lru_cap = 4
        # table set uploads vs patch scatters vs plain hits
        self.dev_cache_stats = {"uploads": 0, "patches": 0, "hits": 0}
        # split-path solves by Gauss-Seidel chunking (gs_active: chunked
        # dense sweeps, gs_disabled: one chunk) and in the uniform-metric
        # regime, counted as the reference counts them (Decision reads
        # them)
        self.spf_kernel_stats = {
            "gs_active": 0, "gs_disabled": 0, "uniform_metric": 0,
        }
        self._nbr_cache: dict[tuple[int, int], list[int]] = {}
        self._labels_cache: dict[tuple, np.ndarray] = {}
        # base_version -> (src-sorted edge order, row starts) for the warm
        # start's host-side cone walk (structural, so churn keeps it)
        self._warm_out: dict[int, tuple] = {}
        self._nh_intern = NexthopIntern()
        # cross-rebuild route caches, as the reference keeps them: each
        # maps a slot fingerprint (the area and my own adjacency slots,
        # which the first-hop bits alone cannot see) to a cell, in LRU
        # order over at most `_mpls_fingerprint_cap` fingerprints (one
        # root needs one; `compute_fleet_ribs` raises the cap to its root
        # count and `trim_caches` sets it back):
        #   _uni_cache: {"gen": view gen, "entries": (view row, class
        #     token) -> RibEntry, "classdicts": (token, member rows) ->
        #     {prefix: RibEntry}, "plain" / "multi": (content signature,
        #     the whole section)}
        #   _mpls_cache: (label, node, class token, igp) -> RibMplsEntry
        #   _mpls_cls_cache: {"groups": (base_version, token, member
        #     rows, labels) -> {label: RibMplsEntry}, "total"}
        # An unchanged route comes back as the same frozen object, so a
        # caller's RIB diff short-circuits on identity.
        self._uni_cache: dict = {}
        self._mpls_cache: dict = {}
        self._mpls_cls_cache: dict = {}
        self._mpls_fingerprint_cap = 8
        # solves on the device (cold or warm), and of those the warm ones
        self.solve_count = 0
        self.warm_solves = 0
        # last solve: on the split tables `SplitProgram.run`'s sweeps,
        # tail_rounds, spilled, host_syncs (= replays, one read of the
        # loop's state each), steps, relax_launches (those that did work)
        # and graph_nodes; on the dense or edge tables (`_solve_dist`) the
        # table kind with sweeps or rounds, host_reads and the launches of
        # relax_launches / edge_launches
        self.last_solve_stats: dict = {}
        # last warm rebuild: changes, cone_cells, seeds, the warm
        # program's stats, and host wall ms of the cone walk (with the old
        # distances' copy to the host), the device solve (scatter to
        # buffer decode) and the scoped assembly
        self.last_warm_stats: dict = {}
        # the split solve's programs (cold, warm, per B and knobs) of the
        # cached table sets, replayed as CUDA graphs on the card; dropped
        # with their table set and by `trim_caches`
        self._programs = ProgramCache(cap=4)
        # multi-advertiser election: on the device (`elect_seg_kernel`)
        # once the advertiser matrix has at least this many slots, NumPy
        # below; the two are equal (integer algebra). On an H100 the
        # device path is the faster from 8 192 slots and NumPy up to
        # 4 096 (`chip_smoke.py` [8c])
        self.elect_device_min = 1 << 13
        # election view gen -> the advertiser matrix on the device (LRU)
        self._elect_dev: dict = {}
        self.elect_stats = {
            "plain": 0, "multi": 0, "complex": 0, "device_elections": 0,
        }
        # last full assembly, host wall ms: "election" (the multi
        # election call), "assembly" (plain, anycast and general unicast
        # with KSP), "mpls"
        self.last_phase_ms: dict[str, float] = {}
        # base_version -> (out, in) distinct-neighbor counts for the KSP
        # k clamp (structural, so metric churn keeps them)
        self._ksp_nbr_counts: dict[int, tuple] = {}
        # last KSP batch: jobs, chunks, k_eff, rounds, sweeps, host_reads
        # (one host read per chunk), and host wall ms of the device calls
        # (paths_ms) and of the whole batch (ms)
        self.last_ksp_stats: dict = {}

    # ------------------------------------------------------------ device

    def _device_arrays(self, csr, want: str = "split") -> dict:
        """Device table set `want` for `csr`: "split" (the split solve's
        tables), "dense" (`nbr`, `wgt` in-neighbor tables and the node
        `over` bits, for the dense solve and KSP) or "edge" (the
        dst-sorted `src`, `dst`, `metric`, the `blocked` mask of
        `build_blocked` and the `edge_relax.EdgeIndex` of the node runs,
        the init's out-edge index and the long runs' segments, for the
        edge-list solve). One cache entry per topology base holds
        every set built so far: a newer CSR of a cached base scatters the
        journal suffix the entry has not applied into each set; a CSR
        older than the entry (journals cannot be applied backwards) or of
        an uncached base starts a new entry."""
        cache = self._dev.pop(csr.base_version, None)
        if cache is not None and csr.version >= cache["version"]:
            self._apply_patch_suffix(cache, csr)
        else:
            cache = {
                "version": csr.version,
                "journal_len": len(csr.patches),
                "sets": {},
            }
        self._dev[csr.base_version] = cache  # refresh the LRU position
        while len(self._dev) > self._dev_lru_cap:
            self._dev.pop(next(iter(self._dev)))
            self._keep_live_programs()
        got = cache["sets"].get(want)
        if got is not None:
            self.dev_cache_stats["hits"] += 1
            return got
        self.dev_cache_stats["uploads"] += 1
        if want == "split":
            t = build_split_tables(
                csr.edge_src, csr.edge_dst, csr.edge_metric, csr.num_nodes
            )
            got = split_tables_from_numpy(t, csr.node_overloaded, self.device)
        elif want == "dense":
            nbr, wgt = csr.dense_tables()
            got = {
                "nbr": self._to_dev(nbr),
                "wgt": self._to_dev(wgt),
                "over": self._to_dev(csr.node_overloaded),
            }
        elif want == "edge":
            blocked = build_blocked(
                csr.edge_metric, csr.edge_src, csr.node_overloaded
            )
            got = {
                "src": self._to_dev(csr.edge_src),
                "dst": self._to_dev(csr.edge_dst),
                "metric": self._to_dev(csr.edge_metric),
                "blocked": self._to_dev(blocked),
            }
            got["index"] = edge_relax.device_edge_index(
                got["src"], got["dst"], got["metric"], csr.padded_nodes)
        else:
            raise ValueError(f"unknown device table set {want!r}")
        cache["sets"][want] = got
        if want == "split":
            self._keep_live_programs()
        return got

    def _keep_live_programs(self) -> None:
        """Drops the split programs whose table set left the cache."""
        self._programs.keep_tables(
            c["sets"]["split"] for c in self._dev.values()
            if "split" in c["sets"])

    def _apply_patch_suffix(self, cache: dict, csr) -> None:
        """Scatter the journal entries the cache has not applied into
        every resident set: the dense `wgt` at (row, column), the edge
        `metric` at the edge slot, the split `base_wgt` (columns < W) and
        `ov_wgt` (row `ov_pos[row]`, column - W), one index write each;
        clear `uniform_metric` if a patch breaks it."""
        if cache["version"] == csr.version:
            return
        done = cache["journal_len"]
        if len(csr.patches) > done:
            self.dev_cache_stats["patches"] += 1
            # the last patch of a slot wins: one write per slot keeps the
            # index write free of duplicate targets (whose winner CUDA
            # leaves undefined)
            last = {
                (p.dense_row, p.dense_col): (p.edge_idx, p.metric)
                for p in csr.patches[done:]
            }
            rows = np.fromiter((k[0] for k in last), np.int64, len(last))
            cols = np.fromiter((k[1] for k in last), np.int64, len(last))
            idxs = np.fromiter((v[0] for v in last.values()), np.int64,
                               len(last))
            vals = np.fromiter((v[1] for v in last.values()), np.int32,
                               len(last))
            dense = cache["sets"].get("dense")
            if dense is not None:
                dense["wgt"].index_put_(
                    (self._to_dev(rows), self._to_dev(cols)),
                    self._to_dev(vals),
                )
            edge = cache["sets"].get("edge")
            if edge is not None:
                # (row, column) and the edge slot name one edge each way
                edge["metric"].index_put_(
                    (self._to_dev(idxs),), self._to_dev(vals)
                )
            tab = cache["sets"].get("split")
            if tab is not None:
                # a mesh's copies of these tables on other devices
                # (`_mesh_parts`) are cut again at the next revision
                tab["rev"] = tab.get("rev", 0) + 1
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

    def trim_caches(self, fingerprint_cap: int = 8) -> None:
        """Reclaim cache memory (Decision calls this when it trims its
        warm state; a caller may after a fleet pass on a shared solver):
        set the fingerprint cap of the route caches to `fingerprint_cap`
        and evict their least recently used fingerprints beyond it; drop
        the warm start's host index and the device advertiser matrices,
        both rebuilt on demand, and the split solve's programs (their
        buffers and CUDA graphs), captured again at the next solve."""
        self._mpls_fingerprint_cap = fingerprint_cap
        self._programs.clear()
        for cache in (self._mpls_cache, self._uni_cache,
                      self._mpls_cls_cache):
            while len(cache) > fingerprint_cap:
                cache.pop(next(iter(cache)))
        self._warm_out.clear()
        self._elect_dev.clear()

    def _fingerprint_cell(self, cache: dict, key, new):
        """The cell of fingerprint `key` in `cache`, made by `new()` if
        absent, moved to the LRU's newest end (pop, then set); then the
        oldest fingerprints beyond the cap are evicted. With a cap of 0
        the cell serves this call only."""
        cell = cache.pop(key, None)
        if cell is None:
            cell = new()
        cache[key] = cell
        while len(cache) > self._mpls_fingerprint_cap:
            cache.pop(next(iter(cache)))
        return cell

    def _pick_table(self, csr) -> str:
        """The table set the batched solve uses for `csr`. The explicit
        knobs outrank `kernel_impl`: use_dense=False is the edge list,
        use_dense=True or use_pallas the dense tables; with use_dense
        None, "split" is the split tables, and any other kernel_impl the
        dense tables unless their slots (padded nodes x `dense_width()`,
        checked before building them) exceed `dense_waste_limit` x the
        edge count, where the edge list serves."""
        if self.use_dense is False:
            return "edge"
        if self.use_pallas or self.use_dense is True:
            return "dense"
        if self.kernel_impl == "split":
            return "split"
        table_slots = csr.padded_nodes * csr.dense_width()
        if table_slots > self.dense_waste_limit * max(csr.num_edges, 1):
            return "edge"
        return "dense"

    def solve_vp(self, csr) -> int:
        """Rows of the distance matrix the solve returns: the split
        tables' tight padding, else the CSR's padded node count."""
        if self._pick_table(csr) == "split":
            return tight_nodes(csr.num_nodes)
        return csr.padded_nodes

    def _dispatch(self, csr) -> tuple[str, dict, bool]:
        """(table kind, its device set, whether any node is overloaded),
        shared by every batched-solve entry point."""
        table = self._pick_table(csr)
        dev = self._device_arrays(csr, table)
        return table, dev, bool(csr.node_overloaded.any())

    def _pick_gs_and_count(self, dev: dict) -> int:
        """The split solve's Gauss-Seidel chunk count, and the regime
        counters of `spf_kernel_stats`."""
        if dev.get("uniform_metric"):
            self.spf_kernel_stats["uniform_metric"] += 1
        gs = pick_gs_chunks(dev["vp"])
        self.spf_kernel_stats["gs_active" if gs > 1 else "gs_disabled"] += 1
        return gs

    def _solve_dist(self, csr, roots, _dispatched: tuple | None = None
                    ) -> torch.Tensor:
        """Distances [solve_vp(csr), B] int32 from each of `roots` (ids,
        repeats allowed), a tensor on the solver's device, on the table
        set `_pick_table` names: the split solve, the dense tables swept
        to the fixpoint by kernel A (with or without use_pallas: the
        reference's Pallas-or-XLA choice by `fits_vmem` is a TPU memory
        limit), or the edge-list solve. Sets `last_solve_stats`."""
        table, dev, has_over = _dispatched or self._dispatch(csr)
        roots_t = torch.from_numpy(
            np.ascontiguousarray(np.asarray(roots, dtype=np.int32))
        ).to(self.device)
        if self.mesh is not None:
            if table != "split":
                self._warn_mesh_once(
                    "configured mesh is only used by the split kernel; "
                    "%r-table solve runs on the solver's device (leave "
                    "use_dense unset with spf_kernel='split' to shard)",
                    table,
                )
            elif self._mesh_fits(dev, roots_t.shape[0]):
                return self._sharded_dist(dev, roots_t, has_over)
            else:
                self._warn_mesh_once(
                    "configured mesh %s does not divide the solve shape "
                    "(vp=%d, b=%d): solving on the solver's device (use "
                    "power-of-two axis sizes)",
                    dict(self.mesh.shape), dev["vp"], roots_t.shape[0],
                )
        stats: dict = {"table": table}
        relax0 = relax.LAUNCHES
        edge0 = sum(edge_relax.LAUNCHES.values())
        b = roots_t.shape[0]
        # every kind reads its loop's state back, so the solve is
        # complete when it returns; use_pallas keeps one sweep's row
        if table == "split":
            gs = self._pick_gs_and_count(dev)
            name = "batched_sssp_split"
            key = (dev["vp"], *dev["base_nbr"].shape[1:],
                   *dev["ov_nbr"].shape, b, gs, has_over)
        elif table == "dense":
            name = "_relax_once" if self.use_pallas else "batched_sssp_dense"
            key = (*dev["nbr"].shape, b, has_over)
        else:
            name = "batched_sssp"
            key = (csr.padded_nodes, dev["src"].shape[0], b)
        with telemetry.observe(name, key, span="spf:batched_dist",
                               span_complete=not self.use_pallas
                               or table != "dense",
                               first_launch_only=name == "_relax_once"
                               ) as cap:
            if table == "split":
                out = batched_sssp_split(
                    dev, roots_t, has_overloads=has_over, gs_chunks=gs,
                    stats=stats, programs=self._programs,
                )
            elif table == "dense":
                out = relax.batched_sssp_relax(
                    dev["nbr"], dev["wgt"], dev["over"], roots_t,
                    has_overloads=has_over, stats=stats,
                )
            else:
                out = edge_relax.batched_sssp(
                    dev["src"], dev["dst"], dev["metric"], dev["blocked"],
                    roots_t, csr.padded_nodes, stats=stats,
                    index=dev["index"],
                )
            if cap:
                cap.io(args=(*_tensors(dev), roots_t), outs=(out,))
        if table != "split":  # the split program counts its own
            stats["relax_launches"] = relax.LAUNCHES - relax0
        stats["edge_launches"] = sum(edge_relax.LAUNCHES.values()) - edge0
        self.last_solve_stats = stats
        return out

    def _warn_mesh_once(self, msg: str, *args) -> None:
        if not self._mesh_fallback_warned:
            self._mesh_fallback_warned = True
            log.warning(msg, *args)

    def _mesh_fits(self, dev: dict, b: int) -> bool:
        """Whether the split tables' rows divide by the mesh's graph axis
        and the `b` roots by its sources axis. `tight_nodes` pads to
        multiples of 512 and `pad_batch` to powers of two, so meshes of
        2, 4 or 8 a side always fit."""
        from openr_tpu_torch.parallel.mesh import GRAPH_AXIS, SOURCES_AXIS

        return (dev["vp"] % self.mesh.shape[GRAPH_AXIS] == 0
                and b % self.mesh.shape[SOURCES_AXIS] == 0)

    def _mesh_parts(self, dev: dict) -> dict:
        """The split tables cut over the mesh, kept with the table set:
        a position on the tables' device holds views, which the patch
        scatter updates in place; a copy on another device is cut again
        when the set's revision moves."""
        from openr_tpu_torch.parallel.mesh import GRAPH_AXIS, shard

        got = dev.get("mesh_parts")
        rev = dev.get("rev", 0)
        if got is None or got[0] is not self.mesh or got[1] != rev:
            rows = (GRAPH_AXIS, None)
            parts = {k: shard(dev[k], self.mesh, rows)
                     for k in ("base_nbr", "base_wgt")}
            for k in ("ov_ids", "ov_nbr", "ov_wgt", "over"):
                parts[k] = shard(dev[k], self.mesh, ())
            got = dev["mesh_parts"] = (self.mesh, rev, parts)
        return got[2]

    def _sharded_dist(self, dev: dict, roots_t: torch.Tensor,
                      has_over: bool) -> torch.Tensor:
        """`_solve_dist` on the mesh: `sharded_sssp_split` over the
        table parts, its per-position layout kept in `last_shard_rows`,
        the result assembled [vp, B] on the solver's device."""
        from openr_tpu_torch.parallel.sharded_spf import sharded_sssp_split

        parts = self._mesh_parts(dev)
        b = roots_t.shape[0]
        stats: dict = {"table": "split", "mesh": dict(self.mesh.shape)}
        relax0 = relax.LAUNCHES
        key = (dev["vp"], *dev["base_nbr"].shape[1:], *dev["ov_nbr"].shape,
               b, has_over, tuple(self.mesh.shape.values()))
        with annotate("spf:sharded_solve", self.counters), telemetry.observe(
            "sharded_sssp_split", key, span="spf:sharded_solve"
        ) as cap:
            out = sharded_sssp_split(
                parts["base_nbr"], parts["base_wgt"], parts["ov_ids"],
                parts["ov_nbr"], parts["ov_wgt"], parts["over"], roots_t,
                self.mesh, has_overloads=has_over, stats=stats,
            )
            full = out.full(self.device)
            if cap:
                cap.io(args=(*_tensors(dev), roots_t), outs=(full,))
        self.last_shard_rows = telemetry.shard_rows(out)
        stats["relax_launches"] = relax.LAUNCHES - relax0
        stats["edge_launches"] = 0
        self.last_solve_stats = stats
        return full

    def solve(self, ls, my_node: str):
        """Distances + the ECMP first-hop matrix for my_node's RIB:
        returns (csr, dist, fh, neighbor_ids, lfa), fh/lfa host bool
        [B-1, vp] (lfa None unless enable_lfa), or None if my_node is not
        in the topology. On the split tables, one fused solve returns a
        packed buffer; on the dense or edge tables, `_solve_dist` then
        the same epilogue (`rib_epilogue.rib_buffer`) on its matrix. dist
        is a `LazyDist` on every table."""
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

        table, dev, has_over = self._dispatch(csr)
        d = self.device
        self.solve_count += 1
        if table != "split":
            # the reference's span for this path ends where the solve's
            # call returns; the epilogue below runs after it has ended
            with annotate("spf:batched_dist", self.counters):
                dist = self._solve_dist(
                    csr, roots, _dispatched=(table, dev, has_over)
                )
            vp = int(dist.shape[0])
            args = (self._to_dev(nbr_metric), self._to_dev(nbr_ids_p),
                    self._to_dev(nbr_over))
            # kernel C (`rib_epilogue_kernel`) on the solved matrix, as
            # the split RIB runs it: one launch, one packed host copy; the
            # row keeps the reference's name for this branch
            with telemetry.observe(
                "first_hop_matrix", tuple(dist.shape),
                span="spf:batched_dist", span_complete=False,
            ) as cap:
                packed = rib_epilogue.rib_buffer(dist, *args, my_id,
                                                 self.enable_lfa)
                check_byte_order(d)
                buf = _host(packed)
                if cap:
                    cap.io(args=(dist, *args), outs=(packed,))
            d_root, fh, lfa = unpack_rib_buffer(buf, vp, b, self.enable_lfa)
            return csr, LazyDist(dist, d_root), fh, nbr_ids, lfa
        vp = dev["vp"]
        gs = self._pick_gs_and_count(dev)
        stats: dict = {}
        key = (vp, *dev["base_nbr"].shape[1:], *dev["ov_nbr"].shape, b, gs,
               has_over, self.enable_lfa)
        with annotate("spf:batched_solve", self.counters), telemetry.observe(
            "batched_sssp_split_rib", key, span="spf:batched_solve",
        ) as cap:
            args = (torch.from_numpy(roots).to(d),
                    torch.from_numpy(nbr_metric).to(d),
                    torch.from_numpy(nbr_ids_p).to(d),
                    torch.from_numpy(nbr_over).to(d))
            dist_dev, packed = batched_sssp_split_rib(
                dev, *args, my_id,
                has_overloads=has_over,
                with_lfa=self.enable_lfa,
                gs_chunks=gs,
                stats=stats,
                programs=self._programs,
            )
            check_byte_order(d)
            buf = _host(packed)
            if cap:
                cap.io(args=(*_tensors(dev), *args), outs=(dist_dev, packed))
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
        solved = self.solve(ls, my_node)
        if solved is None:
            return (rdb, None) if return_artifact else rdb
        with annotate("spf:rib_assembly", self.counters):
            rdb = self._assemble_routes(rdb, ls, ps, my_node, solved)
        if return_artifact:
            return rdb, self._artifact(my_node, ls, solved)
        return rdb

    def _artifact(self, my_node, ls, solved) -> SolveArtifact:
        return SolveArtifact(
            my_node=my_node, ls=ls, ksp_k=self.ksp_k, solved=solved,
            nh_intern=self._nh_intern,
        )

    def assemble_prefix_routes(self, art: SolveArtifact, ps, prefixes) -> dict:
        """Routes for `prefixes` only, against a cached artifact, with no
        new solve: every prefix goes down the general per-prefix path
        (KSP prefixes still batch into one device call). A prefix absent
        from the result has no route."""
        return self._assemble_scoped(art, ps, prefixes)

    def _assemble_scoped(self, art: SolveArtifact, ps, prefixes, view=None,
                         plain_rows=()) -> dict:
        """`assemble_prefix_routes`; the warm path also passes the
        election view and the view rows of the plain prefixes it touched.
        Where the unicast cache cell of this fingerprint belongs to that
        view's generation, those rows come from its (row, class token)
        entries, or go into them: the entry the full assembly builds for
        the same class, so a route a flap moved and the revert moved back
        is the object it was."""
        csr, dist, fh, nbr_ids, lfa = art.solved
        ls, my_node = art.ls, art.my_node
        # scoped election: the candidates of the scoped prefixes against
        # the prefixes, as the reference counts them
        self.work_ledger.commit(
            "election",
            sum(len(ps.prefixes.get(p) or ()) for p in prefixes),
            len(prefixes),
        )
        my_id = csr.name_to_id[my_node]
        d_root = dist[:, 0]
        fh_any = fh.any(axis=0)
        slot_cache = self._nbr_slot_cache(csr, my_id, nbr_ids)
        mk_nexthops_cached = self._mk_nexthops_cached_factory(
            fh, slot_cache, ls.area
        )
        out: dict = {}
        cell = None
        if view is not None and len(plain_rows):
            cell = self._uni_cache.get(self._slot_gen(ls, slot_cache))
        if cell is not None and cell.get("gen") == view.gen:
            prefixes = set(prefixes)
            entries = cell["entries"]
            nodes = np.asarray(view.orig)[np.asarray(plain_rows, np.int64)]
            tokens = _node_tokens(fh, d_root, nodes)
            for i, o, token in zip(np.asarray(plain_rows).tolist(),
                                   nodes.tolist(), tokens):
                p = view.plain_p[i]
                prefixes.discard(p)
                if o == my_id or d_root[o] >= INF_DIST or not fh_any[o]:
                    continue  # local or unreachable: no route
                e = entries.get((i, token))
                if e is None:
                    igp = int(d_root[o])
                    nhs = mk_nexthops_cached(np.array([o]), igp)
                    if not nhs:
                        continue
                    e = entries[(i, token)] = RibEntry(
                        prefix=p,
                        nexthops=nhs,
                        best_node=view.plain_n[i],
                        best_nodes=(view.plain_n[i],),
                        best_entry=view.plain_e[i],
                        igp_cost=igp,
                    )
                out[p] = e
        items = []
        for p in sorted(prefixes):
            per_node = ps.prefixes.get(p)
            if per_node:
                items.append((p, dict(per_node)))
        ksp_jobs = self._unicast_general(
            csr, ls, my_node, my_id, d_root, fh, fh_any, nbr_ids, lfa,
            dist, slot_cache, mk_nexthops_cached, items, out,
        )
        if ksp_jobs:
            self._ksp_batch(csr, ls, my_node, my_id, d_root, ksp_jobs, out)
        return out

    def _unicast_general(
        self, csr, ls, my_node, my_id, d_root, fh, fh_any, nbr_ids, lfa,
        dist, slot_cache, mk_nexthops_cached, items, out: dict,
    ) -> list[tuple]:
        """The general per-prefix unicast path: anycast, UCMP weights,
        min_nexthop, LFA backups, and plain prefixes on the scoped and
        LFA paths. Writes routes into `out`; returns the KSP prefixes as
        (prefix, reachable, best_nodes) jobs for one `_ksp_batch`."""
        ksp_jobs: list[tuple] = []
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
                ksp_jobs.append((prefix, reachable, best_nodes))
                continue
            ids = np.array(
                [csr.name_to_id[n] for n in best_nodes], dtype=np.int64
            )
            igps = d_root[ids]
            min_igp = int(igps.min())
            chosen = ids[igps == min_igp]
            chosen_names = sorted(csr.node_names[i] for i in chosen)
            weights = ucmp_weights({n: reachable[n] for n in chosen_names})
            if weights is None:
                nexthops = mk_nexthops_cached(chosen, min_igp)
            else:
                nexthops = self._mk_nexthops(
                    fh, chosen, min_igp, ls.area, weights, csr.node_names,
                    slot_cache,
                )
            if not nexthops:
                continue
            best_entry = reachable[chosen_names[0]]
            if best_entry.min_nexthop and len(nexthops) < best_entry.min_nexthop:
                continue
            backups: tuple[NextHop, ...] = ()
            if lfa is not None:
                backups = self._mk_backup_nexthops(
                    csr, my_id, nbr_ids, fh, lfa, dist, chosen, ls.area,
                    slot_cache,
                )
            out[prefix] = RibEntry(
                prefix=prefix,
                nexthops=nexthops,
                best_node=chosen_names[0],
                best_nodes=tuple(best_nodes),
                best_entry=best_entry,
                igp_cost=min_igp,
                backup_nexthops=backups,
            )
        return ksp_jobs

    def _ksp_batch(self, csr, ls, my_node, my_id, d_root, jobs,
                   out: dict) -> None:
        """Every KSP prefix's paths in one batch of k edge-disjoint path
        rounds on the device (`ops/ksp.py`), then its route.

        The dense tables come from the patched device cache and the
        blocked mask is derived on the device. Each job's destination is
        its nearest best node (ties by id, which is name order). k is
        clamped to the root's distinct out-neighbors and the most
        distinct in-neighbors of any destination (every edge-disjoint
        path leaves and enters through a different neighbor), rounded up
        to a power of two as the reference does, and round 1 takes the
        solve's own root distances. Jobs are chunked by a memory budget
        of 2 GiB over the bytes one job holds on the device: its packed
        ban bits, two [V] distance columns and its k_eff paths of V ids
        (the reference budgets 13 bytes per slot and job for its bool
        mask and temporaries); jobs are independent, so the chunking
        cannot change the routes. A chunk's costs, paths and KSP
        counters come back in one copy, its only read from the device.
        `last_ksp_stats["paths_ms"]` is the wall time of those calls
        (enqueue, device, copy); the rest of `ms` builds the routes."""
        t0 = time.perf_counter()
        dev = self._device_arrays(csr, "dense")
        d_nbr, d_wgt = dev["nbr"], dev["wgt"]
        blocked = (dev["over"][d_nbr.long()] & (d_nbr != my_id)).contiguous()
        dests = np.empty(len(jobs), dtype=np.int32)
        for j, (_prefix, _reachable, best_nodes) in enumerate(jobs):
            ids = np.array(
                [csr.name_to_id[n] for n in best_nodes], dtype=np.int64
            )
            dests[j] = ids[np.argmin(d_root[ids])]  # ids ascending: first min
        counts = self._ksp_nbr_counts.get(csr.base_version)
        if counts is None:
            valid = csr.edge_metric < INF_DIST
            counts = (
                np.bincount(csr.edge_src[valid], minlength=csr.padded_nodes),
                np.bincount(csr.edge_dst[valid], minlength=csr.padded_nodes),
            )
            self._ksp_nbr_counts[csr.base_version] = counts
            while len(self._ksp_nbr_counts) > self._dev_lru_cap:
                self._ksp_nbr_counts.pop(next(iter(self._ksp_nbr_counts)))
        out_counts, in_counts = counts
        bound = int(max(1, min(
            self.ksp_k,
            out_counts[my_id],
            int(in_counts[dests].max()) if len(dests) else 1,
        )))
        k_eff = min(self.ksp_k, 1 << (bound - 1).bit_length())
        vp, d_width = int(d_nbr.shape[0]), int(d_nbr.shape[1])
        max_hops = csr.padded_nodes - 1
        bytes_per_job = vp * d_width // 8 + 2 * vp * 4 + k_eff * vp * 4
        cap = max(8, min(256, (2 << 30) // bytes_per_job))
        chunk = 1 << (cap.bit_length() - 1)  # floor power of two
        dist0 = np.full(csr.padded_nodes, int(INF_DIST), np.int32)
        m = min(len(d_root), csr.num_nodes)
        dist0[:m] = np.minimum(
            np.asarray(d_root[:m], dtype=np.int64), int(INF_DIST)
        ).astype(np.int32)
        dist0_dev = self._to_dev(dist0)
        stats = {"jobs": len(jobs), "chunks": 0, "k_eff": k_eff,
                 "paths_ms": 0.0}
        # one span over the batch's device calls and route building
        with annotate("spf:ksp", self.counters):
            for start in range(0, len(jobs), chunk):
                sub = dests[start : start + chunk]
                b = pad_batch(len(sub))
                # padding: dest == root
                dsts = np.full(b, my_id, dtype=np.int32)
                dsts[: len(sub)] = sub
                t1 = time.perf_counter()
                costs, paths, _hops = ksp_edge_disjoint_dense(
                    d_nbr, d_wgt, blocked, my_id, self._to_dev(dsts),
                    k=k_eff, max_hops=max_hops, dist0=dist0_dev, stats=stats,
                    to_host=True,
                )
                stats["paths_ms"] += (time.perf_counter() - t1) * 1e3
                stats["chunks"] += 1
                for j in range(len(sub)):
                    prefix, reachable, best_nodes = jobs[start + j]
                    host_paths = paths_to_host(costs, paths, csr.node_names, j)
                    entry = ksp_route_from_paths(
                        ls, my_node, prefix, reachable, best_nodes, host_paths
                    )
                    if entry is not None:
                        out[prefix] = entry
        stats["ms"] = (time.perf_counter() - t0) * 1e3
        self.last_ksp_stats = stats

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
        artifact without distance columns or of a dense- or edge-table
        solve (rows other than the split tables'),
        a structural change (new CSR base), a table choice other than
        "split", an unknown endpoint, a root-incident change, more changed
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
        if self._pick_table(csr) != "split":
            return None  # the warm solve runs on the split tables only
        if old_dist.shape[0] != self.solve_vp(csr):
            return None  # a dense- or edge-table solve's rows
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
            # a copy with the cones set to INF: the caller's artifact
            # keeps its distances
            dist0 = old_dist.device_tensor.clone()
            if rows_all:
                dist0[self._to_dev(np.asarray(rows_all, np.int64)),
                      self._to_dev(np.asarray(cols_all, np.int64))] = INF_DIST
            stats: dict = {}
            has_over = bool(csr.node_overloaded.any())
            key = (vp, *dev["base_nbr"].shape[1:], *dev["ov_nbr"].shape, bb,
                   has_over)
            with annotate("spf:warm_solve", self.counters), \
                    telemetry.observe("batched_sssp_split_warm_rib", key,
                                      span="spf:warm_solve") as cap:
                args = (self._to_dev(roots), self._to_dev(nbr_metric),
                        self._to_dev(nbr_ids_p), self._to_dev(nbr_over))
                seed_t = self._to_dev(seed)
                dist2, packed = batched_sssp_split_warm_rib(
                    dev, *args, dist0, seed_t, has_overloads=has_over,
                    stats=stats, programs=self._programs,
                )
                check_byte_order(self.device)
                buf = _host(packed)
                if cap:
                    cap.io(args=(*_tensors(dev), *args, seed_t),
                           outs=(dist2, packed))
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
        plain_rows = ()
        if len(view.plain_p):
            plain_rows = np.nonzero(changed_mask[view.orig])[0]
            for i in plain_rows:
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
        entries = self._assemble_scoped(art2, ps, touched, view, plain_rows)
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
            # node segments through the full assembly's entry cache
            labels_v = self._node_labels(ls, csr, n_live)
            slot_cache = self._nbr_slot_cache(csr, my_id, nbr_ids)
            mk = self._mk_nexthops_cached_factory(fh2, slot_cache, ls.area)
            mpls_cache = self._mpls_entry_cache(
                self._slot_gen(ls, slot_cache), n_live
            )
            tokens = _node_tokens(fh2, d_root2, changed_ids)
            for i, token in zip(changed_ids.tolist(), tokens):
                if i == my_id:
                    continue
                label = int(labels_v[i])
                if label < MPLS_LABEL_MIN:
                    continue
                touched_labels.add(label)
                entry = None
                if d_root2[i] < INF_DIST and fh2[:, i].any():
                    entry = self._mpls_node_entry(
                        mpls_cache, label, csr.node_names[i], token,
                        int(d_root2[i]), i, mk,
                    )
                if entry is None:
                    rdb.mpls_routes.pop(label, None)
                else:
                    rdb.mpls_routes[label] = entry
        self.last_warm_stats["assembly_ms"] = (time.perf_counter() - t0) * 1e3
        return rdb, art2, touched, touched_labels, region

    def _assemble_routes(self, rdb, ls, ps, my_node, solved):
        csr, dist, fh, nbr_ids, lfa = solved
        view = ps.election_view(csr.name_to_id, csr.base_version)
        my_id = csr.name_to_id[my_node]
        d_root = dist[:, 0]
        fh_any = fh.any(axis=0)
        slot_cache = self._nbr_slot_cache(csr, my_id, nbr_ids)
        mk_nexthops_cached = self._mk_nexthops_cached_factory(
            fh, slot_cache, ls.area
        )
        n_live = len(csr.node_names)
        dest_cls, dest_tokens = _dest_classes(fh, d_root, n_live)
        slot_gen = self._slot_gen(ls, slot_cache)

        plain_p, plain_n, plain_e = view.plain_p, view.plain_n, view.plain_e
        orig, complex_items, multi = view.orig, view.complex_items, view.multi
        if lfa is not None:
            # LFA backups are per target, not per class: every prefix
            # takes the general per-prefix path
            merged = list(complex_items)
            merged += [
                (p, {plain_n[i]: plain_e[i]}) for i, p in enumerate(plain_p)
            ]
            if multi is not None:
                merged += multi_items(multi)
            complex_items = sorted(merged)
            multi = None
            plain_p = []
        self.elect_stats["plain"] = len(plain_p)
        self.elect_stats["multi"] = len(multi.prefixes) if multi else 0
        self.elect_stats["complex"] = len(complex_items)
        # the full election: candidate slots against electable prefixes
        self.work_ledger.commit(
            "election",
            len(plain_p) + (len(multi.adv) if multi is not None else 0)
            + sum(len(pn) for _p, pn in complex_items),
            len(plain_p) + self.elect_stats["multi"] + len(complex_items),
        )
        t0 = time.perf_counter()
        mel = None
        if multi is not None and len(multi.prefixes):
            mel = self._elect_multi(multi, dist, fh_any, my_id, view.gen)
        t_asm0 = time.perf_counter()
        self.last_phase_ms = {"election": (t_asm0 - t0) * 1e3}
        cell = None
        if len(plain_p) or mel is not None:
            # the unicast cell of this fingerprint, reset when the view
            # (whose rows its keys index) is a new generation
            cell = self._fingerprint_cell(self._uni_cache, slot_gen, dict)
            if cell.get("gen") != view.gen:
                cell.clear()
                cell.update(gen=view.gen, entries={}, classdicts={})

        # ---- unicast: plain prefixes, one NextHop set per class ----------
        if len(plain_p):
            reach = (d_root[orig] < INF_DIST) & fh_any[orig] & (orig != my_id)
            igp = d_root[orig].astype(np.int64)
            idxs = np.nonzero(reach)[0]
            cls = dest_cls[orig[idxs]]
            ucls = np.unique(cls)
            entries, classdicts = cell["entries"], cell["classdicts"]
            if len(entries) > max(8192, 4 * len(plain_p)):
                entries.clear()
                classdicts.clear()
                cell.pop("plain", None)
                cell["cd_total"] = 0
            # the whole section's content: its member rows, their classes
            # and each used class's token (first-hop bits and igp)
            sig = (
                idxs.tobytes(),
                cls.tobytes(),
                tuple(dest_tokens[int(c)] for c in ucls),
            )
            cached_plain = cell.get("plain")
            if cached_plain is not None and cached_plain[0] == sig:
                rdb.unicast_routes.update(cached_plain[1])
            else:
                plain_dict: dict = {}
                for g in _class_groups(cls):
                    rows = idxs[g]
                    token = dest_tokens[int(cls[g[0]])]
                    # members by their bytes, not a hash of them: a hash
                    # collision would install another class's routes
                    gkey = (token, rows.tobytes())
                    sub = classdicts.get(gkey)
                    if sub is None:
                        # one NextHop set per class; the token fixes it,
                        # so a cached sub-dict never needs it
                        igp_c = int(igp[rows[0]])
                        nhs = self._mk_nexthops_union(
                            slot_cache, fh[:, orig[rows[0]]], igp_c, ls.area
                        )
                        if not nhs:
                            continue
                        sub = {}
                        for i in rows.tolist():
                            e = entries.get((i, token))
                            if e is None:
                                e = entries[(i, token)] = RibEntry(
                                    prefix=plain_p[i],
                                    nexthops=nhs,
                                    best_node=plain_n[i],
                                    best_nodes=(plain_n[i],),
                                    best_entry=plain_e[i],
                                    igp_cost=igp_c,
                                )
                            sub[e.prefix] = e
                        # bounded by the routes the sub-dicts hold: every
                        # rebuild under churn mints new keys
                        cell["cd_total"] = cell.get("cd_total", 0) + len(sub)
                        if cell["cd_total"] > 4 * max(len(plain_p), 4096):
                            classdicts.clear()
                            cell["cd_total"] = len(sub)
                        classdicts[gkey] = sub
                    plain_dict.update(sub)
                cell["plain"] = (sig, plain_dict)
                rdb.unicast_routes.update(plain_dict)

        # ---- unicast: elected multi-advertiser (anycast ECMP) ------------
        if mel is not None:
            # the election's outcome and the advertisers' first-hop
            # columns: a remote change can drop one of two equal-cost
            # paths without moving d_root or the chosen set
            sig_m = (
                mel.is_best.tobytes(),
                mel.chosen.tobytes(),
                mel.min_igp.tobytes(),
                fh[:, multi.adv].tobytes(),
            )
            cached_m = cell.get("multi")
            if cached_m is not None and cached_m[0] == sig_m:
                rdb.unicast_routes.update(cached_m[1])
            else:
                mdict: dict = {}
                for p, best_names, chosen_ids, chosen_names, igp_c, best_e in (
                    iter_multi_winners(multi, mel)
                ):
                    nhs = mk_nexthops_cached(chosen_ids, igp_c)
                    if not nhs:
                        continue
                    mdict[p] = RibEntry(
                        prefix=p,
                        nexthops=nhs,
                        best_node=chosen_names[0],
                        best_nodes=best_names,
                        best_entry=best_e,
                        igp_cost=igp_c,
                    )
                cell["multi"] = (sig_m, mdict)
                rdb.unicast_routes.update(mdict)

        # ---- unicast: the general path for the complex shapes ------------
        ksp_jobs = self._unicast_general(
            csr, ls, my_node, my_id, d_root, fh, fh_any, nbr_ids, lfa,
            dist, slot_cache, mk_nexthops_cached, complex_items,
            rdb.unicast_routes,
        )
        if ksp_jobs:
            self._ksp_batch(
                csr, ls, my_node, my_id, d_root, ksp_jobs, rdb.unicast_routes
            )
        t_mpls0 = time.perf_counter()
        self.last_phase_ms["assembly"] = (t_mpls0 - t_asm0) * 1e3

        # ---- MPLS node segments ------------------------------------------
        mpls_cache = self._mpls_entry_cache(slot_gen, n_live)
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
        # class sub-dicts: a class whose members, labels and token are
        # unchanged is one dict update. base_version is in the key because
        # the rows are node ids, which a new topology base renumbers
        mcell = self._fingerprint_cell(
            self._mpls_cls_cache, slot_gen, lambda: {"groups": {}, "total": 0}
        )
        mcls = mcell["groups"]
        cls_sel = dest_cls[sel]
        for g in _class_groups(cls_sel):
            rows = sel[g]
            token = dest_tokens[int(cls_sel[g[0]])]
            gkey = (csr.base_version, token, rows.tobytes(),
                    labels_v[rows].tobytes())
            sub = mcls.get(gkey)
            if sub is None:
                sub = {}
                igp = int(d_root[rows[0]])
                for i in rows.tolist():
                    entry = self._mpls_node_entry(
                        mpls_cache, int(labels_v[i]), names[i], token, igp,
                        i, mk_nexthops_cached,
                    )
                    if entry is not None:
                        sub[entry.label] = entry
                mcell["total"] += len(sub)
                if mcell["total"] > 4 * max(n_live, 4096):
                    mcls.clear()
                    mcell["total"] = len(sub)
                mcls[gkey] = sub
            mpls_routes.update(sub)

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
        self.last_phase_ms["mpls"] = (time.perf_counter() - t_mpls0) * 1e3
        return rdb

    def _elect_multi(self, multi, dist, fh_any, my_id, view_gen):
        """The multi-advertiser election: `elect_seg` on the solver's
        device once the matrix has `elect_device_min` slots, NumPy below;
        the two are equal. The device election reads the solve's root
        column where it stays on the device."""
        d_root = np.asarray(dist[:, 0])
        reach = (d_root < INF_DIST) & fh_any
        if len(multi.adv) >= self.elect_device_min:
            self.elect_stats["device_elections"] += 1
            cached = self._elect_dev.pop(view_gen, None)
            if cached is not None:  # keep it, at the LRU's newest end
                self._elect_dev[view_gen] = cached
            d_vec = d_root
            if isinstance(dist, LazyDist):
                d_vec = dist.device_tensor[:, 0].contiguous()
            with annotate("spf:election", self.counters):
                out = elect_multi_device(
                    multi, d_vec, reach, my_id, dev_cache=self._elect_dev,
                    gen=view_gen, device=self.device,
                )
            while len(self._elect_dev) > self._dev_lru_cap:
                self._elect_dev.pop(next(iter(self._elect_dev)))
            return out
        return elect_multi_np(multi, d_root.astype(np.int64), reach, my_id)

    # ----------------------------------------------------------- helpers

    @staticmethod
    def _slot_gen(ls, slot_cache) -> tuple:
        """The route caches' fingerprint: the area and my own adjacency
        slots (neighbor and interface names of the min-metric parallel
        links), which the first-hop bits alone cannot see."""
        return (ls.area, tuple(tuple(s) for s in slot_cache))

    def _mpls_entry_cache(self, slot_gen, n_live: int) -> dict:
        """The MPLS node-segment entries of fingerprint `slot_gen`,
        cleared once it holds more than max(4096, 4 x the live nodes)."""
        cache = self._fingerprint_cell(self._mpls_cache, slot_gen, dict)
        if len(cache) > max(4096, 4 * n_live):
            cache.clear()
        return cache

    def _mpls_node_entry(self, cache: dict, label: int, node: str, token,
                         igp: int, i: int, mk_nexthops_cached):
        """The node segment's RibMplsEntry toward node id `i` (class
        `token` at distance `igp`) from `cache`, built and kept there on a
        miss; None where it has no next hop."""
        key = (label, node, token, igp)
        entry = cache.get(key)
        if entry is None:
            nhs = self._mpls_wrap(
                mk_nexthops_cached(np.array([i]), igp), node, label
            )
            if not nhs:
                return None
            entry = cache[key] = RibMplsEntry(label=label, nexthops=nhs)
        return entry

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

    @staticmethod
    def _mk_nexthops(fh, targets, igp: int, area: str, weights,
                     target_names, slot_cache) -> tuple[NextHop, ...]:
        """UCMP nexthops toward `targets` (all at distance `igp`): every
        min-metric parallel link of each valid first hop, weighted by the
        gcd-normalized sum of the weights of the targets it serves."""
        slots: dict[tuple[str, str], None] = {}
        wsum: dict[tuple[str, str], int] = {}
        for tgt in targets:
            for n_idx in np.nonzero(fh[:, int(tgt)])[0]:
                for key in slot_cache[int(n_idx)]:
                    slots[key] = None
                    wsum[key] = wsum.get(key, 0) + weights[
                        target_names[int(tgt)]
                    ]
        wsum = normalize_weights(wsum)
        return sorted_nexthops(
            NextHop(
                address=fh_name,
                if_name=if_name,
                metric=igp,
                weight=wsum.get((fh_name, if_name), 0),
                neighbor_node=fh_name,
                area=area,
            )
            for (fh_name, if_name) in slots
        )

    @staticmethod
    def _mk_backup_nexthops(csr, my_id, nbr_ids, fh, lfa, dist, targets,
                            area: str, slot_cache) -> tuple[NextHop, ...]:
        """LFA backups toward `targets`: loop-free neighbors that are not
        primary first hops of any target, each at metric(root->n) + the
        least dist_n(target) over the targets it is loop-free for."""
        n_real = len(nbr_ids)
        is_primary = fh[:n_real, targets].any(axis=1)
        is_lfa = lfa[:n_real, targets].any(axis=1)
        out: dict[tuple[str, str], int] = {}
        for n_idx in np.nonzero(is_lfa & ~is_primary)[0]:
            col = 1 + int(n_idx)
            via = min(
                int(dist[int(t), col])
                for t in targets
                if lfa[int(n_idx), int(t)]
            )
            link = min(d[1] for d in csr.details(my_id, nbr_ids[int(n_idx)]))
            m = link + via
            for key in slot_cache[int(n_idx)]:
                if key not in out or m < out[key]:
                    out[key] = m
        return sorted_nexthops(
            NextHop(
                address=fh_name,
                if_name=if_name,
                metric=m,
                neighbor_node=fh_name,
                area=area,
            )
            for (fh_name, if_name), m in out.items()
        )

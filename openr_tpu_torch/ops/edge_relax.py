"""Edge-list Bellman-Ford: the batched multi-root SSSP over the padded
CSR edge list, the port of `openr_tpu/ops/spf.py` `batched_sssp`.

`batched_sssp` starts from `edge_init` (each root's own out-edges relaxed
with no penalty, blocked ones included: the overloaded-root exemption;
then 0 at the root) and runs Jacobi rounds over the unblocked edges until
a round lowers nothing, at most `num_nodes` rounds. The columns are
independent SSSPs, cut into tiles of `tile_cols` columns that run one
after another to their own fixpoints, and a round gathers only from the
rows that changed in the round before (`csrc/edge_relax.cu` says why both
leave the distances and the round count as the reference's).

The edge arrays are sorted by destination, as `CsrGraph` keeps them.
`EdgeIndex` holds what the kernels walk: each node's run of the
dst-sorted slots (`edge_row_start`), the out-edge index of the init
(`edge_out_index`) and the segments of the long runs (`edge_segments`).
`device_edge_index` builds it on the tensors' device with one host read
(the solver's table cache, once per table set; the sharded edge solve,
per call); `edge_index` builds the same fields from host arrays with
NumPy, the reference the tests hold it to.

The wrappers pick by `tensor.device.type` alone: a CUDA tensor launches
`edge_init_kernel` / `edge_relax_kernel` (one cooperative launch each per
solve, one host read per solve for the stats; a build, launch or
cooperative-launch failure raises), a CPU tensor runs the plain PyTorch
version of the same algorithm, `batched_sssp_ref` (tiles, per-tile
fixpoint, the skip), on `edge_init_ref` and a chunked gather, add and
`scatter_reduce_` "amin" by destination; `edge_round_ref` is one full
round.
"""

from __future__ import annotations

import ctypes
import threading
from typing import NamedTuple

import numpy as np
import torch

from openr_tpu_torch.common.constants import DIST_INF
from openr_tpu_torch.monitor import device as _telemetry
from openr_tpu_torch.ops import counts

INF_DIST = DIST_INF
#: the kernel functions, as a profiler names them
KERNEL_NAMES = {"init": "edge_init_kernel", "round": "edge_relax_kernel"}
#: runs longer than this many slots are walked as segments of this many
#: slots by separate thread groups (`csrc/edge_relax.cu`)
SEG_EDGES = 256
#: the widest column tile: a warp of 32 lanes a row, 4 columns a lane
MAX_TILE = 128

_P = ctypes.c_void_p
_I = ctypes.c_int
#: the C entry points of `csrc/edge_relax.cu` and the ctypes types bound
#: to them
ENTRY_POINTS = {
    "openr_edge_init": (
        [
            _P, _P,  # dist, roots
            _P, _P,  # out_start, out_slot
            _P, _P, _P,  # dst, metric, marks
            _I, _I, _I, _I,  # V, B, Bp, Bt
            _P,  # stream
        ],
        _I,
    ),
    "openr_edge_fix": (
        [
            _P, _P,  # buf0, buf1
            _P, _P, _P, _P,  # row_start, src, metric, blocked
            _P, _P, _I, _I,  # seg_node, seg_lo, n_seg, seg_edges
            _P, _P, _P,  # marks, scratch, stats
            _I, _I, _I, _I,  # V, Bp, Bt, max_rounds
            _P,  # stream
        ],
        _I,
    ),
    "openr_edge_round_guarded": (
        [
            _P, _P,  # buf0, buf1
            _P, _P, _P, _P,  # row_start, src, metric, blocked
            _P, _P, _I, _I,  # seg_node, seg_lo, n_seg, seg_edges
            _P, _P,  # scratch, stats
            _I, _I, _I,  # V, Bp, Bt
            _P, _I, _P,  # ctl, phase_mask, changed
            _P,  # stream
        ],
        _I,
    ),
    "openr_edge_error_string": ([_I], ctypes.c_char_p),
}

#: kernel launches made by the wrappers (CUDA path only), by kernel,
#: bumped under a lock from every thread; `launches_here` is the calling
#: thread's own
LAUNCHES = {"init": 0, "round": 0}
#: launches of the guarded one-round kernel (`edge_round` with `ctl`, the
#: sharded loop's), apart: a profiler names it `edge_relax_kernel` too
LAUNCHES_GUARDED = 0
_LIB = None
_LIB_LOCK = threading.Lock()
#: elements of one [edges, B] candidate chunk of the plain version
_REF_CHUNK = 1 << 24


def reset_launches() -> None:
    global LAUNCHES_GUARDED
    for k in LAUNCHES:
        LAUNCHES[k] = 0
    LAUNCHES_GUARDED = 0


def launches_here() -> int:
    """`init` and `round` launches the wrappers made in the calling
    thread so far."""
    return counts.mine("edge_relax.launches")


def _counted(kernel: str) -> None:
    with counts.LOCK:
        LAUNCHES[kernel] += 1
    counts.add_mine("edge_relax.launches")


def _lib():
    global _LIB
    with _LIB_LOCK:
        if _LIB is None:
            from openr_tpu_torch.ops import cuda_build

            lib = cuda_build.load("edge_relax")
            for name, (argtypes, restype) in ENTRY_POINTS.items():
                fn = getattr(lib, name)
                fn.argtypes = argtypes
                fn.restype = restype
            _LIB = lib
    return _LIB


def build() -> None:
    """Build and load the kernels now (they are otherwise built at first
    launch)."""
    _lib()


def tile_cols(b: int) -> int:
    """Columns of one tile of the fixpoint: B rounded up to a multiple of
    4, up to `MAX_TILE`. Every tile walks every edge slot once a round,
    so the widest tile is the cheapest: on an H100 at BASELINE config 3
    a solve in tiles of 128 took half the time of one in tiles of 32,
    whose slabs (V x 32 x 4 bytes) stay in L2 (`chip_smoke.py` [10c]
    times both)."""
    return min(-(-b // 4) * 4, MAX_TILE)


_DST_ERROR = ("edge_dst must be ascending and within [0, num_nodes): the "
              "edge-list solve walks each node's run of dst-sorted edges")
_SRC_ERROR = "edge_src of a walked slot is outside [0, V)"


def edge_row_start(edge_dst: np.ndarray, num_nodes: int,
                   edge_metric: np.ndarray) -> np.ndarray:
    """int32 [num_nodes + 1]: the first slot of each node's run of the
    dst-sorted edge list. Raises unless `edge_dst` is ascending and in
    [0, num_nodes).

    The trailing slots of metric INF (the CsrGraph's padding, all into
    the dead slot) are left out of every run: an INF edge lowers nothing
    at the init or in a round, and the dead slot's run would otherwise
    hold every padding slot (~2 M at 100k nodes), walked by that one
    node's threads alone."""
    dst = np.asarray(edge_dst)
    if len(dst) and (
        int(dst.min()) < 0 or int(dst.max()) >= num_nodes
        or bool((dst[1:] < dst[:-1]).any())
    ):
        raise ValueError(_DST_ERROR)
    finite = np.flatnonzero(np.asarray(edge_metric) < INF_DIST)
    dst = dst[: int(finite[-1]) + 1 if len(finite) else 0]
    return np.searchsorted(dst, np.arange(num_nodes + 1)).astype(np.int32)


def edge_out_index(edge_src: np.ndarray, row_start: np.ndarray
                   ) -> tuple[np.ndarray, np.ndarray]:
    """The init's out-edge index: (out_start int32 [V + 1], out_slot
    int32 [walked]), the walked slots (those of `row_start`'s runs)
    sorted by src, stably, and where each src's slots start. Slot ids,
    not metrics, so metric patches stay visible. Raises if a walked
    slot's src is outside [0, V)."""
    v = len(row_start) - 1
    src = np.asarray(edge_src)[: int(row_start[-1])]
    if len(src) and (int(src.min()) < 0 or int(src.max()) >= v):
        raise ValueError(_SRC_ERROR)
    order = np.argsort(src, kind="stable")
    start = np.searchsorted(src[order], np.arange(v + 1))
    return start.astype(np.int32), order.astype(np.int32)


def edge_segments(row_start: np.ndarray, seg_edges: int = SEG_EDGES
                  ) -> tuple[np.ndarray, np.ndarray]:
    """The segments of the runs longer than `seg_edges` slots: (seg_node,
    seg_lo) int32, one entry per segment of `seg_edges` slots (the last
    of a run shorter), in node order; the kernel ends a segment at
    min(seg_lo + seg_edges, the run's end)."""
    rs = np.asarray(row_start, dtype=np.int64)
    lens = np.diff(rs)
    long = np.flatnonzero(lens > seg_edges)
    n = -(-lens[long] // seg_edges)
    node = np.repeat(long, n)
    k = np.arange(int(n.sum())) - np.repeat(np.cumsum(n) - n, n)
    return node.astype(np.int32), (rs[node] + k * seg_edges).astype(np.int32)


class EdgeIndex(NamedTuple):
    """What the kernels walk, per table set: the runs (`row_start`), the
    init's out-edge index and the long runs' segments."""

    row_start: object
    out_start: object
    out_slot: object
    seg_node: object
    seg_lo: object


def edge_index(edge_src, edge_dst, edge_metric, num_nodes: int,
               row_start=None) -> EdgeIndex:
    """`EdgeIndex` of host arrays (NumPy int32); `row_start` is built
    from the dst and the metrics unless given."""
    if row_start is None:
        row_start = edge_row_start(edge_dst, num_nodes, edge_metric)
    row_start = np.asarray(row_start, dtype=np.int32)
    return EdgeIndex(row_start, *edge_out_index(edge_src, row_start),
                     *edge_segments(row_start))


# ---- the index on the tensors' device ----------------------------------

def _row_start_t(edge_dst, num_nodes: int, edge_metric):
    """(row_start int32 [num_nodes + 1], a device bool: dst is not
    ascending or not within [0, num_nodes)). The runs end at the last
    finite slot: every run is clamped to it, which is `edge_row_start`'s
    cut of the sorted dst."""
    dev = edge_dst.device
    e = edge_dst.shape[0]
    if e:
        bad = ((edge_dst.amin() < 0) | (edge_dst.amax() >= num_nodes)
               | (edge_dst[1:] < edge_dst[:-1]).any())
        slots = torch.arange(1, e + 1, dtype=torch.int32, device=dev)
        walk = torch.where(edge_metric < INF_DIST, slots, 0).amax()
    else:
        bad = torch.zeros((), dtype=torch.bool, device=dev)
        walk = torch.zeros((), dtype=torch.int32, device=dev)
    nodes = torch.arange(num_nodes + 1, dtype=edge_dst.dtype, device=dev)
    rs = torch.searchsorted(edge_dst.contiguous(), nodes, out_int32=True)
    return torch.minimum(rs, walk.to(torch.int32)), bad


def _out_order_t(edge_src, row_start):
    """(out_start int32 [V + 1], every slot id sorted stably by src with
    the slots past the runs' end last (int64 [E]), a device bool: a
    walked slot's src is outside [0, V)). The first `row_start[-1]` ids
    are `edge_out_index`'s out_slot."""
    dev = edge_src.device
    v = row_start.shape[0] - 1
    e = edge_src.shape[0]
    live = torch.arange(e, device=dev) < row_start[-1]
    bad = (live & ((edge_src < 0) | (edge_src >= v))).any()
    key = torch.where(live, edge_src.to(torch.int32), v)
    keys, order = torch.sort(key, stable=True)
    nodes = torch.arange(v + 1, dtype=torch.int32, device=dev)
    return torch.searchsorted(keys, nodes, out_int32=True), order, bad


def _seg_counts_t(row_start, seg_edges: int):
    """(segments a node, int64 [V]; their total, a device scalar)."""
    lens = (row_start[1:] - row_start[:-1]).long()
    n = torch.where(lens > seg_edges, (lens + seg_edges - 1) // seg_edges,
                    0)
    return n, n.sum()


def _segments_t(row_start, n, n_seg: int, seg_edges: int):
    """`edge_segments` from the per-node counts `n` and their total."""
    dev = row_start.device
    v = row_start.shape[0] - 1
    node = torch.repeat_interleave(torch.arange(v, device=dev), n,
                                   output_size=n_seg)
    first = torch.repeat_interleave(torch.cumsum(n, 0) - n, n,
                                    output_size=n_seg)
    k = torch.arange(n_seg, device=dev) - first
    lo = row_start.long()[node] + k * seg_edges
    return node.to(torch.int32), lo.to(torch.int32)


def device_edge_index(edge_src: torch.Tensor, edge_dst: torch.Tensor,
                      edge_metric: torch.Tensor, num_nodes: int,
                      row_start=None) -> EdgeIndex:
    """`edge_index` of the edge tensors, built on their device with one
    host read: the two input checks, the walked
    count and the segment count, which size out_slot and the segments.
    Every sort, search and count is enqueued before that read; the cut of
    out_slot and the segments' few launches follow it. `row_start`, where
    given, is taken as it is (unchecked, as `edge_index` takes it)."""
    from openr_tpu_torch.monitor import compile_ledger

    dev = edge_src.device
    i32 = torch.int32
    if row_start is None:
        rs, bad_dst = _row_start_t(edge_dst.to(i32), num_nodes,
                                   edge_metric.to(i32))
    else:
        rs = torch.as_tensor(row_start).to(device=dev, dtype=i32)
        bad_dst = torch.zeros((), dtype=torch.bool, device=dev)
    start, order, bad_src = _out_order_t(edge_src, rs)
    n, total = _seg_counts_t(rs, SEG_EDGES)
    read = torch.stack([bad_dst.long(), bad_src.long(), rs[-1].long(),
                        total.long()])
    bad_d, bad_s, walked, n_seg = read.tolist()  # the build's host read
    compile_ledger.record_transfer(read.numel() * 8)
    if bad_d:
        raise ValueError(_DST_ERROR)
    if bad_s:
        raise ValueError(_SRC_ERROR)
    return EdgeIndex(rs, start, order[:walked].to(i32),
                     *_segments_t(rs, n, n_seg, SEG_EDGES))


def walked_slots(index: EdgeIndex) -> int:
    """The slots the runs walk (the padding past the last finite slot is
    never read)."""
    return int(index.row_start[-1].item())


def root_work(index: EdgeIndex, roots) -> tuple[int, int]:
    """(bytes, operations) of the init's reads past the dist it writes:
    the roots, two out_start words a root and the slot, metric and dst
    of each root's out-edges; one min per out-edge and root."""
    os_ = index.out_start.long()
    r = roots.long()
    deg = int((os_[r + 1] - os_[r]).sum().item())
    b = roots.shape[0]
    return b * 12 + deg * 12, deg + b


def init_work(index: EdgeIndex, v: int, b: int, tile: int,
              roots) -> tuple[int, int]:
    """(least DRAM bytes, integer operations) of the init of `b` roots
    over `v` rows: dist and its row marks (a bit per row and tile of
    `tile` columns) written, and `root_work`."""
    r_bytes, r_ops = root_work(index, roots)
    return v * b * 4 + -(-b // tile) * -(-v // 8) + r_bytes, r_ops


def round_work(src, blocked, index: EdgeIndex, v: int,
               b: int) -> tuple[int, int, int]:
    """(least DRAM bytes, integer operations, gathered bytes) of one
    full round over the slots the runs walk: dist read and written, src,
    metric and blocked of each walked slot and row_start read once, four
    operations per usable walked edge and column, whose B-wide source row
    it gathers."""
    e = walked_slots(index)
    usable = int((~blocked[:e]).sum().item())
    return (2 * v * b * 4 + e * 9 + (v + 1) * 4, usable * b * 4,
            usable * b * 4)


def fix_work(src, blocked, index: EdgeIndex, v: int,
             dist) -> tuple[int, int]:
    """(least DRAM bytes, integer operations) the fixpoint launch must
    spend to take the init's start [V, B] to its fixpoint `dist`: the
    start read once and the result written once; src, metric and blocked
    of each walked slot, row_start and the segments read once; one
    relaxation, four operations, of each usable walked edge out of each
    entry the result reaches, for that entry's column: each entry settled
    once, as a label-setting solve does. Jacobi rounds do more."""
    e = walked_slots(index)
    b = dist.shape[1]
    usable = ~blocked[:e]
    out_edges = torch.bincount(src[:e][usable].long(), minlength=v)
    reached = (dist[:v] < INF_DIST).sum(dim=1)
    relaxations = int((out_edges[:v].long() * reached.long()).sum().item())
    n_seg = int(index.seg_node.shape[0])
    return (2 * v * b * 4 + e * 9 + (v + 1) * 4 + n_seg * 8,
            4 * relaxations)


def bitmap_words(num_nodes: int) -> int:
    """Words of a row bitmap of the kernels: a bit a row, rounded up to
    16 bytes (`csrc/edge_relax.cu` `bitmap_words`)."""
    return -(-num_nodes // 128) * 4


def _check(name, tensors, ref_device):
    for nm, x, dt in tensors:
        if x.device != ref_device:
            raise ValueError(
                f"{name}: {nm} on {x.device}, dist on {ref_device}"
            )
        if x.dtype != dt:
            raise TypeError(f"{name}: {nm} is {x.dtype}, needs {dt}")
        if not x.is_contiguous():
            raise ValueError(f"{name}: {nm} is not contiguous")


def _check_index(name, index: EdgeIndex, v: int, dev) -> None:
    _check(name, [(nm, x, torch.int32)
                  for nm, x in zip(EdgeIndex._fields, index)], dev)
    if index.row_start.shape != (v + 1,) or index.out_start.shape != (v + 1,):
        raise ValueError(f"{name}: row_start and out_start must be [{v + 1}]")


def _check_edges(name, src, extra):
    e = src.shape[0]
    for nm, x in extra:
        if x.shape != (e,):
            raise ValueError(f"{name}: {nm} must be [{e}] like src")


def _check_cuda_width(name, dist, tensors):
    """The kernels carry 4 columns a lane in 16-byte loads: the row
    width must be a multiple of 4 and the buffers 16-byte aligned."""
    if dist.shape[1] % 4:
        raise ValueError(
            f"{name}: the kernel takes [V, B] with B a multiple of 4 "
            "(batched_sssp pads)"
        )
    for nm, x in tensors:
        if x.data_ptr() % 16:
            raise ValueError(
                f"{name}: {nm} must be 16-byte aligned for the kernel's "
                "16-byte loads"
            )


def _launch_error(lib, err: int, what: str):
    if err != 0:
        raise RuntimeError(
            f"{what} launch failed: "
            f"{lib.openr_edge_error_string(err).decode()} ({err})"
        )


def edge_init_ref(out, src, dst, metric, roots):
    """Plain PyTorch version of the init: `out` [V, B'] (B' >= B) = per
    column b < B the min of the metrics of roots[b]'s own out-edges into
    each node (blocked ones too), at most INF, and 0 at the root; INF in
    the columns past B."""
    b = roots.shape[0]
    out.fill_(INF_DIST)
    cols = out[:, :b]
    step = max(1, _REF_CHUNK // max(b, 1))
    for c0 in range(0, src.shape[0], step):
        s = src[c0 : c0 + step]
        cand = torch.where(
            s[:, None] == roots[None, :],
            metric[c0 : c0 + step, None],
            INF_DIST,
        )
        cols.scatter_reduce_(
            0, dst[c0 : c0 + step, None].long().expand_as(cand), cand,
            reduce="amin", include_self=True,
        )
    cols.clamp_max_(INF_DIST)
    cols[roots.long(), torch.arange(b, device=out.device)] = 0
    return out


def _round_ref(dist_in, out, src, dst, metric, sel):
    """`out` = min(dist_in, the guarded candidates of the slots `sel`
    (int64 ids), min-scattered by destination)."""
    out.copy_(dist_in)
    b = dist_in.shape[1]
    step = max(1, _REF_CHUNK // max(b, 1))
    for c0 in range(0, sel.shape[0], step):
        e = sel[c0 : c0 + step]
        d = dist_in[src[e].long()]
        cand = torch.where(
            d < INF_DIST,
            torch.clamp_max(d + metric[e, None], INF_DIST),
            INF_DIST,
        )
        out.scatter_reduce_(
            0, dst[e, None].long().expand_as(cand), cand,
            reduce="amin", include_self=True,
        )
    return out


def edge_round_ref(dist_in, out, src, dst, metric, blocked, changed,
                   ctl=None, phase_mask: int = 0):
    """Plain PyTorch version of one full round: `out` = min(dist_in, the
    unblocked edges' guarded candidates, min-scattered by destination),
    all taken from `dist_in`; `changed` [1] (None: not kept) set to 1 if
    an entry fell, else 0. With the loop's guard (`ctl`, `phase_mask`,
    as `edge_round`), does nothing unless bit `ctl[0]` of `phase_mask`
    is set."""
    if ctl is not None and not (phase_mask >> int(ctl[0])) & 1:
        return changed
    sel = torch.nonzero(~blocked).flatten()
    _round_ref(dist_in, out, src, dst, metric, sel)
    if changed is not None:
        changed.fill_(int(bool((out < dist_in).any())))
    return changed


def batched_sssp_ref(src, dst, metric, blocked, roots, num_nodes: int,
                     tile: int, walked: int | None = None,
                     max_rounds: int | None = None,
                     stats: dict | None = None):
    """Plain PyTorch version of the kernels' algorithm: the columns in
    tiles of `tile`, each from `edge_init_ref` to its own fixpoint (at
    most `max_rounds`, default `num_nodes`), a round relaxing only the
    unblocked slots below `walked` (the runs' end, `row_start[-1]`)
    whose source row changed in the round before (for the first round:
    was set finite by the init). Returns dist [num_nodes, B]; with
    `stats`, adds rounds (the maximum over the tiles), gathered_edges
    (the slots relaxed, summed over rounds and tiles) and host_reads
    (one read of the changed rows a round)."""
    dev = src.device
    b = roots.shape[0]
    walked = src.shape[0] if walked is None else walked
    cap = num_nodes if max_rounds is None else max_rounds
    s = src[:walked].long()
    usable = ~blocked[:walked]
    out = torch.empty((num_nodes, b), dtype=torch.int32, device=dev)
    rounds = gathered = reads = 0
    for c0 in range(0, b, tile):
        rt = roots[c0 : c0 + tile]
        cur = torch.empty((num_nodes, rt.shape[0]), dtype=torch.int32,
                          device=dev)
        edge_init_ref(cur, src, dst, metric, rt)
        chg = (cur < INF_DIST).any(1)
        n = 0
        while n < cap:
            sel = torch.nonzero(usable & chg[s]).flatten()
            gathered += int(sel.shape[0])
            nxt = _round_ref(cur, torch.empty_like(cur), src, dst, metric,
                             sel)
            n += 1
            chg = (nxt < cur).any(1)
            cur = nxt
            reads += 1
            if not bool(chg.any()):
                break
        out[:, c0 : c0 + rt.shape[0]] = cur
        rounds = max(rounds, n)
    if stats is not None:
        _add_stats(stats, rounds=rounds, host_reads=reads,
                   gathered_edges=gathered)
    return out


def _add_stats(stats, **counts) -> None:
    for k, x in counts.items():
        stats[k] = stats.get(k, 0) + x


def edge_init(out, src, dst, metric, roots, index: EdgeIndex,
              tile: int | None = None, marks=None):
    """The init into `out` [V, B'] int32 (B' >= B = len(roots); columns
    past B stay INF): `edge_init_kernel` on a CUDA tensor (B' a multiple
    of 4), `edge_init_ref` on a CPU one. On CUDA `marks` (int32
    [ceil(B' / tile) * bitmap_words(V)], default scratch) receives, per
    tile of `tile` columns (default B'), the rows set finite."""
    i32 = torch.int32
    _check("edge_init", (
        ("out", out, i32), ("src", src, i32), ("dst", dst, i32),
        ("metric", metric, i32), ("roots", roots, i32),
    ), out.device)
    v, bp = out.shape
    _check_edges("edge_init", src, (("dst", dst), ("metric", metric)))
    _check_index("edge_init", index, v, out.device)
    b = roots.shape[0]
    if b > bp:
        raise ValueError(f"edge_init: {b} roots, out has {bp} columns")
    if out.device.type == "cpu":
        return edge_init_ref(out, src, dst, metric, roots)
    if out.device.type != "cuda":
        raise ValueError(f"edge_init: no kernel for {out.device}")
    _check_cuda_width("edge_init", out, (("out", out),))
    tile = bp if tile is None else tile
    n_marks = -(-bp // tile) * bitmap_words(v)
    if marks is None:
        marks = torch.empty(n_marks, dtype=i32, device=out.device)
    _check("edge_init", (("marks", marks, i32),), out.device)
    if marks.numel() < n_marks:
        raise ValueError(f"edge_init: marks needs {n_marks} words")
    lib = _lib()
    with torch.cuda.device(out.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.openr_edge_init(
            out.data_ptr(), roots.data_ptr(), index.out_start.data_ptr(),
            index.out_slot.data_ptr(), dst.data_ptr(), metric.data_ptr(),
            marks.data_ptr(), v, b, bp, tile, stream,
        )
    _launch_error(lib, err, "edge_init_kernel")
    _counted("init")
    return out


def fix_scratch(num_nodes: int, device) -> tuple[torch.Tensor, torch.Tensor]:
    """(scratch, stats) of one fixpoint or round launch: the row bitmaps,
    flags and barrier count, and the device stats; the entry clears both
    on the stream before each launch."""
    return (torch.empty(3 * bitmap_words(num_nodes) + 4, dtype=torch.int32,
                        device=device),
            torch.empty(3, dtype=torch.int64, device=device))


def _fix(buf0, buf1, src, metric, blocked, index: EdgeIndex, tile: int,
         marks, max_rounds: int) -> torch.Tensor:
    """One launch of `edge_relax_kernel`: rounds from `buf0` to each
    tile's fixpoint (at most `max_rounds`), the result in `buf1`; `marks`
    the init's row marks or None (every row changed). Returns the device
    stats, int64 [3]: rounds (the maximum over the tiles), whether the
    last round of some tile lowered anything, gathered edges."""
    v, bp = buf0.shape
    dev = buf0.device
    scratch, stats = fix_scratch(v, dev)
    lib = _lib()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.openr_edge_fix(
            buf0.data_ptr(), buf1.data_ptr(), index.row_start.data_ptr(),
            src.data_ptr(), metric.data_ptr(), blocked.data_ptr(),
            index.seg_node.data_ptr(), index.seg_lo.data_ptr(),
            index.seg_node.shape[0], SEG_EDGES,
            0 if marks is None else marks.data_ptr(), scratch.data_ptr(),
            stats.data_ptr(), v, bp, tile, max_rounds, stream,
        )
    _launch_error(lib, err, "edge_relax_kernel")
    _counted("round")
    return stats


def edge_round(dist_in, out, src, dst, metric, blocked, row_start, changed,
               index: EdgeIndex | None = None, *, ctl=None,
               phase_mask: int = 0, scratch=None):
    """One full Jacobi round from `dist_in` into `out` (distinct [V, B]
    int32 buffers), `changed` [1] int32 (None: not kept) set to 1 if an
    entry fell, else 0: on a CUDA tensor `edge_relax_kernel` capped at
    one round with every row marked changed (B a multiple of 4; `index`,
    built from `row_start` when not given, brings the long runs'
    segments), on a CPU one `edge_round_ref`.

    The sharded loop's guard: with `ctl` (an int32 control block,
    `ops/split_loop.py`'s layout) the call does nothing unless bit
    `ctl[0]` of `phase_mask` is set, and then leaves `out` and `changed`
    as they were. On the card that is `edge_relax_kernel<true>`, which
    reads the phase itself (no host read), counted in
    `LAUNCHES_GUARDED`; `scratch` (`fix_scratch`, on dist's device)
    spares the launch its two allocations."""
    global LAUNCHES_GUARDED
    i32 = torch.int32
    _check("edge_round", (
        ("dist_in", dist_in, i32), ("out", out, i32), ("src", src, i32),
        ("dst", dst, i32), ("metric", metric, i32),
        ("blocked", blocked, torch.bool), ("row_start", row_start, i32),
    ) + tuple((nm, x, i32) for nm, x in (("changed", changed),
                                         ("ctl", ctl)) if x is not None),
        dist_in.device)
    v, b = dist_in.shape
    if row_start.shape != (v + 1,):
        raise ValueError(f"edge_round: row_start must be [{v + 1}]")
    _check_edges("edge_round", src,
                 (("dst", dst), ("metric", metric), ("blocked", blocked)))
    if out.shape != dist_in.shape:
        raise ValueError("edge_round: out must have dist_in's shape")
    if out.data_ptr() == dist_in.data_ptr():
        raise ValueError("edge_round: a Jacobi round needs two buffers")
    if changed is not None and changed.numel() < 1:
        raise ValueError("edge_round: changed needs one int32 slot")
    if changed is None and ctl is None:
        raise ValueError("edge_round: an unguarded round keeps changed")
    if dist_in.device.type == "cpu":
        return edge_round_ref(dist_in, out, src, dst, metric, blocked,
                              changed, ctl, phase_mask)
    if dist_in.device.type != "cuda":
        raise ValueError(f"edge_round: no kernel for {dist_in.device}")
    _check_cuda_width("edge_round", dist_in,
                      (("dist_in", dist_in), ("out", out)))
    if index is None:
        index = device_edge_index(src, dst, metric, v, row_start)
    _check_index("edge_round", index, v, dist_in.device)
    tile = tile_cols(b)
    if ctl is None:
        st = _fix(dist_in, out, src, metric, blocked, index, tile, None, 1)
        changed.view(-1)[:1].copy_(st[1:2])
        return changed
    scratch, stats = (fix_scratch(v, dist_in.device) if scratch is None
                      else scratch)
    lib = _lib()
    with torch.cuda.device(dist_in.device):
        err = lib.openr_edge_round_guarded(
            dist_in.data_ptr(), out.data_ptr(), index.row_start.data_ptr(),
            src.data_ptr(), metric.data_ptr(), blocked.data_ptr(),
            index.seg_node.data_ptr(), index.seg_lo.data_ptr(),
            index.seg_node.shape[0], SEG_EDGES, scratch.data_ptr(),
            stats.data_ptr(), v, b, tile, ctl.data_ptr(), int(phase_mask),
            None if changed is None else changed.data_ptr(),
            torch.cuda.current_stream().cuda_stream,
        )
    _launch_error(lib, err, "edge_relax_kernel (guarded)")
    with counts.LOCK:
        LAUNCHES_GUARDED += 1
    return changed


def _solve_cuda(src, dst, metric, blocked, roots, num_nodes, index, tile,
                max_rounds: int | None = None):
    """The init and the fixpoint launch at tile width `tile` (at most
    `max_rounds` a tile, default `num_nodes`): (dist [V, B], device stats
    int64 [3])."""
    b = roots.shape[0]
    bp = -(-b // 4) * 4
    buf0 = torch.empty((num_nodes, bp), dtype=torch.int32, device=src.device)
    buf1 = torch.empty_like(buf0)
    marks = torch.empty(-(-bp // tile) * bitmap_words(num_nodes),
                        dtype=torch.int32, device=src.device)
    edge_init(buf0, src, dst, metric, roots, index, tile, marks)
    st = _fix(buf0, buf1, src, metric, blocked, index, tile, marks,
              num_nodes if max_rounds is None else max_rounds)
    return (buf1 if bp == b else buf1[:, :b].contiguous()), st


def batched_sssp(edge_src, edge_dst, edge_metric, edge_blocked, roots,
                 num_nodes: int, row_start=None, stats: dict | None = None,
                 index: EdgeIndex | None = None):
    """Distances [num_nodes, B] int32 from each root (INF_DIST =
    unreachable), on the edge arrays' device.

    `edge_blocked` must already hold the overloaded-transit edges
    (`ops.spf.build_blocked`); the root exemption happens at init.
    `index` (`device_edge_index`, from `row_start` where that is given)
    is built here when not given. Repeated roots each get their own
    column. With `stats`, adds rounds (the reference loop's count),
    host_reads (1 a solve on CUDA: the stats), tiles and gathered_edges
    (source rows gathered, over rounds and tiles), and sets tile_cols.
    Without `stats`, a CUDA solve reads nothing back."""
    dev = edge_src.device
    if index is None:
        index = device_edge_index(edge_src, edge_dst, edge_metric,
                                  num_nodes, row_start)
    roots = roots.to(device=dev, dtype=torch.int32).contiguous()
    b = roots.shape[0]
    tile = tile_cols(b)
    if stats is not None:
        _add_stats(stats, tiles=-(-b // tile))
        stats["tile_cols"] = tile
    if dev.type == "cpu":
        dist = batched_sssp_ref(
            edge_src, edge_dst, edge_metric, edge_blocked, roots, num_nodes,
            tile, int(index.row_start[-1]), stats=stats,
        )
    elif dev.type != "cuda":
        raise ValueError(f"batched_sssp: no kernel for {dev}")
    else:
        _check("batched_sssp", (("blocked", edge_blocked, torch.bool),), dev)
        dist, st = _solve_cuda(edge_src, edge_dst, edge_metric, edge_blocked,
                               roots, num_nodes, index, tile)
        if stats is not None:
            rounds, _last, gathered = st.tolist()  # the solve's one host read
            _add_stats(stats, rounds=rounds, host_reads=1,
                       gathered_edges=gathered)
    sink = _telemetry.sink()
    if sink is not None:  # the init and the fixpoint launch
        sink.add("edge_relax", *init_work(index, num_nodes, b, tile, roots))
        sink.add("edge_relax", *fix_work(edge_src, edge_blocked, index,
                                         num_nodes, dist))
    return dist

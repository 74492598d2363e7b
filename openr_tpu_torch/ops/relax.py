"""The relax kernel: one pull-relax of a set of rows of an in-neighbor
table into a distance matrix.

Port of the JAX package's only Pallas kernel,
`openr_tpu/ops/spf_pallas.py` `_relax_kernel`, with row indirection added
so that one kernel serves every `_relax_rows` site of the split solve
(`openr_tpu/ops/spf_split.py`): the dense base table (`row0`), the
overflow table (`dst_rows=ov_ids`) and the compacted tail
(`src_rows=dst_rows=rows`). The kernel is `csrc/relax.cu`; see its
header for the semantics and the design.

`relax_rows` chooses by device and shape alone: a CUDA tensor launches a
hand kernel, the vectorised specialisation where `design_for(W, B)` says
"vec" and the generic kernel otherwise (a build or launch failure
raises); a CPU tensor runs the plain PyTorch version `relax_rows_ref`.
The generic kernel picks its path by shape too (`generic_np`): 16-byte
strips of column quads where B and W are multiples of 4, its scalar
edge path elsewhere.
Given a `row_flag` buffer, every version also reports the dist rows it
lowered, which the split solve reads as its change detection.
"""

from __future__ import annotations

import ctypes
import threading

import torch

from openr_tpu_torch.common.constants import DIST_INF
from openr_tpu_torch.monitor import device as _telemetry

INF_DIST = DIST_INF

#: widths (W table slots, B distance columns) with a vectorised
#: specialisation in `csrc/relax.cu`; any other shape takes the generic
#: kernel
VEC_WIDTHS = (8, 16, 32, 64)
#: the kernel function of each design, as a profiler names it
KERNEL_NAMES = {"vec": "relax_vec_kernel", "generic": "relax_generic_kernel"}

_ROWS_ARGTYPES = [
    ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,  # dist_in, out, B
    ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,  # nbr, wgt, over
    ctypes.c_int,  # W
    ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,  # roots, src, dst
    ctypes.c_int, ctypes.c_int,  # row0, n
    ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,  # changed, flags
    ctypes.c_void_p,  # stream
]
_GUARDED_ARGTYPES = _ROWS_ARGTYPES[:-1] + [
    ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p,  # ctl, mask, n_live
    ctypes.c_void_p,  # stream
]
#: the C entry points of `csrc/relax.cu` and the ctypes types bound to them
ENTRY_POINTS = {
    "openr_relax_rows": (_ROWS_ARGTYPES, ctypes.c_int),
    "openr_relax_rows_generic": (_ROWS_ARGTYPES, ctypes.c_int),
    "openr_relax_rows_guarded": (_GUARDED_ARGTYPES, ctypes.c_int),
    "openr_relax_vec_shape": ([ctypes.c_int, ctypes.c_int], ctypes.c_int),
    "openr_relax_generic_np": ([ctypes.c_int, ctypes.c_int], ctypes.c_int),
    "openr_cuda_error_string": ([ctypes.c_int], ctypes.c_char_p),
}

#: kernel launches made by the wrappers (CUDA path only): the total, and
#: by design. A call recorded into a CUDA graph capture launches nothing
#: and is not counted; the graph's replays run it without a call.
LAUNCHES = 0
LAUNCHES_BY_DESIGN = {"vec": 0, "generic": 0}
#: kernels the wrappers recorded into CUDA graph captures
CAPTURED = 0
_LIB = None
_LIB_LOCK = threading.Lock()


def reset_launches() -> None:
    global LAUNCHES
    LAUNCHES = 0
    for k in LAUNCHES_BY_DESIGN:
        LAUNCHES_BY_DESIGN[k] = 0


def design_for(w: int, b: int) -> str:
    """The kernel `relax_rows` launches for a table of width `w` and `b`
    distance columns: "vec" (the specialisation for that shape) or
    "generic". The C entry `openr_relax_rows` makes the same choice."""
    return "vec" if w in VEC_WIDTHS and b in VEC_WIDTHS else "generic"


def generic_np(w: int, b: int) -> int:
    """The generic kernel's path at (W, B), as `csrc/relax.cu`
    `generic_np` chooses it: 0 for the scalar edge path (B or W not a
    multiple of 4), else the 16-byte column strips each lane carries: 1
    up to B = 128, 2 up to B = 256, 4 beyond."""
    if b % 4 or w % 4:
        return 0
    q = b // 4
    return 1 if q <= 32 else 2 if q <= 64 else 4


def _lib():
    global _LIB
    with _LIB_LOCK:
        if _LIB is None:
            from openr_tpu_torch.ops import cuda_build

            lib = cuda_build.load("relax")
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


def _rows(row0, n, src_rows, dst_rows, device):
    """(table rows, target rows) as int64 index tensors."""
    if src_rows is None:
        r = torch.arange(row0, row0 + n, device=device)
    else:
        r = src_rows[:n].long()
    return r, (r if dst_rows is None else dst_rows[:n].long())


def live_rows(ctl, phase_mask: int, n_live, n: int) -> int:
    """The rows a guarded launch relaxes: 0 unless bit `ctl[0]` of
    `phase_mask` is set, else `n` capped at `n_live[0]`. Reads the
    tensors (a device sync on CUDA)."""
    if ctl is not None and not (phase_mask >> int(ctl[0])) & 1:
        return 0
    return n if n_live is None else min(n, int(n_live[0]))


def relax_rows_ref(
    dist_in, out, nbr, wgt, roots, over=None, *,
    row0=0, n=None, src_rows=None, dst_rows=None, changed=None,
    row_flag=None, rows_changed=None, ctl=None, phase_mask=0, n_live=None,
):
    """Plain PyTorch version of the relax kernel, same signature and
    result: min-scatters each listed row's candidate minimum into `out`,
    adds the count of entries below `dist_in` to `changed`, sets
    `row_flag[t]` for each target row the scatter lowered and adds the
    newly set ones to `rows_changed`. All candidates are computed from
    `dist_in` before `out` is written. With the loop guard (`ctl`,
    `phase_mask`, `n_live`), relaxes the rows `live_rows` names."""
    n = _count(nbr, row0, n, src_rows, dst_rows)
    if ctl is not None or n_live is not None:
        n = live_rows(ctl, phase_mask, n_live, n)
        if n == 0:
            return changed
    r, t = _rows(row0, n, src_rows, dst_rows, dist_in.device)
    b = dist_in.shape[1]
    nb = nbr[r]  # [n, W]
    wg = wgt[r]
    ov = over[r] if over is not None else None
    acc = torch.full((n, b), INF_DIST, dtype=torch.int32, device=dist_in.device)
    for d in range(nb.shape[1]):  # one [n, B] row gather per column
        g = dist_in[nb[:, d].long()]
        c = torch.where(
            g < INF_DIST,
            torch.clamp_max(g + wg[:, d, None], INF_DIST),
            INF_DIST,
        )
        if ov is not None:
            blocked = ov[:, d, None] & (nb[:, d, None] != roots[None, :])
            c = torch.where(blocked, INF_DIST, c)
        acc = torch.minimum(acc, c)
    if changed is not None:
        changed += (acc < dist_in[t]).sum().to(torch.int32)
    if row_flag is not None:
        targets = torch.unique(t)
        before = out[targets]  # a copy: advanced indexing gathers
    out.scatter_reduce_(
        0, t[:, None].expand(n, b), acc, reduce="amin", include_self=True
    )
    if row_flag is not None:
        lowered = (out[targets] < before).any(dim=1)
        fresh = targets[lowered & (row_flag[targets] == 0)]
        row_flag[fresh] = 1
        if rows_changed is not None:
            rows_changed += fresh.numel()
    return changed


def relax_bytes(w: int, kind: str, n: int, b: int, dist_rows_read: int,
                with_over: bool = False) -> int:
    """Least DRAM bytes of one relax call: the n table rows (nbr + wgt,
    and the overload mask where given), each distinct gathered dist row
    once, the n target rows read and written, their row flags written,
    the roots and the row-index lists (a "tail" call has two, an
    "overflow" call one, a "dense" call none)."""
    bytes_ = n * w * 8 + dist_rows_read * b * 4 + 2 * n * b * 4 + b * 4
    bytes_ += n * 4
    if with_over:
        bytes_ += n * w
    if kind != "dense":
        bytes_ += n * 4 * (2 if kind == "tail" else 1)
    return bytes_


def launch_work(nbr, wgt, b: int, *, over=None, row0=0, n=None,
                src_rows=None, dst_rows=None) -> tuple[int, int, int, int]:
    """(rows n, bytes, operations, gathered bytes) of one relax call at
    `b` distance columns: `relax_bytes` with each distinct gathered dist
    row counted once; four integer operations, and one gathered B-wide
    row, per finite slot. Reads the call's table rows (a device sync on
    CUDA): the kernel cost rows count it only while capturing."""
    w = nbr.shape[1]
    kind = ("tail" if src_rows is not None else
            "overflow" if dst_rows is not None else "dense")
    n = _count(nbr, row0, n, src_rows, dst_rows)
    if src_rows is not None:
        r = src_rows[:n].long()
        sel, swgt = nbr[r], wgt[r]
    else:
        sel, swgt = nbr[row0:row0 + n], wgt[row0:row0 + n]
    valid = swgt < INF_DIST
    distinct = int(torch.unique(sel[valid]).numel())
    n_valid = int(valid.sum().item())
    nbytes = relax_bytes(w, kind, n, b, distinct, over is not None)
    return n, nbytes, n_valid * b * 4, n_valid * b * 4


def _count(nbr, row0, n, src_rows, dst_rows) -> int:
    if n is not None:
        return int(n)
    if src_rows is not None:
        return src_rows.shape[0]
    if dst_rows is not None:
        return dst_rows.shape[0]
    return nbr.shape[0] - row0


def _check(dist_in, out, nbr, wgt, roots, over, row0, n, src_rows,
           dst_rows, changed, row_flag, rows_changed, ctl=None, n_live=None):
    # one launch per sweep chunk: keep these checks cheap on the host
    dev = dist_in.get_device()
    i32 = torch.int32
    for nm, x, dt in (
        ("dist_in", dist_in, i32), ("out", out, i32), ("nbr", nbr, i32),
        ("wgt", wgt, i32), ("roots", roots, i32), ("over", over, torch.bool),
        ("src_rows", src_rows, i32), ("dst_rows", dst_rows, i32),
        ("changed", changed, i32), ("row_flag", row_flag, i32),
        ("rows_changed", rows_changed, i32), ("ctl", ctl, i32),
        ("n_live", n_live, i32),
    ):
        if x is None:
            continue
        if x.get_device() != dev:
            raise ValueError(
                f"relax_rows: {nm} on {x.device}, dist on {dist_in.device}"
            )
        if x.dtype != dt:
            raise TypeError(f"relax_rows: {nm} is {x.dtype}, needs {dt}")
        if not x.is_contiguous():
            raise ValueError(f"relax_rows: {nm} is not contiguous")
    if dist_in.dim() != 2 or out.shape != dist_in.shape:
        raise ValueError(
            f"relax_rows: dist_in {tuple(dist_in.shape)} / out "
            f"{tuple(out.shape)} must be one [vp, B] shape"
        )
    b = dist_in.shape[1]
    if nbr.dim() != 2 or wgt.shape != nbr.shape or (
        over is not None and over.shape != nbr.shape
    ):
        raise ValueError("relax_rows: nbr/wgt/over must be one [R, W] shape")
    if roots.shape != (b,):
        raise ValueError(f"relax_rows: roots must be [{b}]")
    for nm, x in (("src_rows", src_rows), ("dst_rows", dst_rows)):
        if x is not None and (x.dim() != 1 or x.shape[0] < n):
            raise ValueError(f"relax_rows: {nm} must hold >= {n} rows")
    if src_rows is None and not 0 <= row0 <= row0 + n <= nbr.shape[0]:
        raise ValueError(
            f"relax_rows: rows [{row0}, {row0 + n}) outside the table "
            f"of {nbr.shape[0]}"
        )
    if changed is not None and changed.numel() < 1:
        raise ValueError("relax_rows: changed needs one int32 slot")
    if row_flag is not None and row_flag.shape != (dist_in.shape[0],):
        raise ValueError(
            f"relax_rows: row_flag must be [{dist_in.shape[0]}] (one per "
            "dist row)"
        )
    if rows_changed is not None and (
        row_flag is None or rows_changed.numel() < 1
    ):
        raise ValueError(
            "relax_rows: rows_changed needs one int32 slot and a row_flag"
        )


def _check_aligned(dist_in, out, nbr, wgt, over, over_align=8):
    """The vectorised kernel and the generic kernel's strip path read
    16-byte vectors of dist and copy the table in 16-byte pieces (over:
    8-byte pieces, 4-byte ones on the generic path)."""
    for nm, x, align in (("dist_in", dist_in, 16), ("out", out, 16),
                         ("nbr", nbr, 16), ("wgt", wgt, 16),
                         ("over", over, over_align)):
        if x is not None and x.data_ptr() % align:
            raise ValueError(
                f"relax_rows: {nm} must be {align}-byte aligned for the "
                "relax kernel's 16-byte loads"
            )


def _relax(entry, dist_in, out, nbr, wgt, roots, over, row0, n, src_rows,
           dst_rows, changed, row_flag, rows_changed, ctl=None, phase_mask=0,
           n_live=None):
    global LAUNCHES, CAPTURED
    n = _count(nbr, row0, n, src_rows, dst_rows)
    _check(dist_in, out, nbr, wgt, roots, over, row0, n, src_rows,
           dst_rows, changed, row_flag, rows_changed, ctl, n_live)
    guarded = ctl is not None or n_live is not None
    cpu = dist_in.device.type == "cpu"
    sink = _telemetry.sink()
    # the rows this call relaxes; a guarded launch on the card reads the
    # loop's state for it only while a capture counts the work
    live = live_rows(ctl, phase_mask, n_live, n) if guarded and (
        cpu or sink is not None) else n
    if sink is not None and live:
        _n, nbytes, ops, _g = launch_work(
            nbr, wgt, dist_in.shape[1], over=over, row0=row0, n=live,
            src_rows=src_rows, dst_rows=dst_rows)
        sink.add("relax", nbytes, ops)
    if cpu:
        if not live:
            return changed
        return relax_rows_ref(
            dist_in, out, nbr, wgt, roots, over, row0=row0, n=live,
            src_rows=src_rows, dst_rows=dst_rows, changed=changed,
            row_flag=row_flag, rows_changed=rows_changed,
        )
    if dist_in.device.type != "cuda":
        raise ValueError(f"relax_rows: no kernel for {dist_in.device}")
    if n == 0:
        return changed
    w, b = nbr.shape[1], dist_in.shape[1]
    design = "generic" if entry == "openr_relax_rows_generic" else (
        design_for(w, b)
    )
    if design == "vec":
        _check_aligned(dist_in, out, nbr, wgt, over)
    elif generic_np(w, b):
        _check_aligned(dist_in, out, nbr, wgt, over, over_align=4)
    lib = _lib()

    def ptr(x):
        return None if x is None else x.data_ptr()

    args = (ptr(dist_in), ptr(out), b, ptr(nbr), ptr(wgt), ptr(over), w,
            ptr(roots), ptr(src_rows), ptr(dst_rows), int(row0), n,
            ptr(changed), ptr(row_flag), ptr(rows_changed))
    if guarded:
        entry = "openr_relax_rows_guarded"
        args += (ptr(ctl), int(phase_mask), ptr(n_live))
    with torch.cuda.device(dist_in.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = getattr(lib, entry)(*args, stream)
    if err != 0:
        raise RuntimeError(
            f"relax kernel launch failed: "
            f"{lib.openr_cuda_error_string(err).decode()} ({err})"
        )
    if torch.cuda.is_current_stream_capturing():
        CAPTURED += 1
    else:
        LAUNCHES += 1
        LAUNCHES_BY_DESIGN[design] += 1
    return changed


def relax_rows(
    dist_in, out, nbr, wgt, roots, over=None, *,
    row0=0, n=None, src_rows=None, dst_rows=None, changed=None,
    row_flag=None, rows_changed=None, ctl=None, phase_mask=0, n_live=None,
):
    """Relax `n` rows of the table [R,W] (`nbr`, `wgt`, optional `over`
    bool mask of overloaded in-neighbors) against `dist_in` [vp,B],
    min-scattering into `out` [vp,B] (may be `dist_in` itself).

    Row i reads table row `src_rows[i]` (default `row0 + i`) and writes
    dist row `dst_rows[i]` (default: the table row). With `changed` (an
    int32 [1] tensor), adds the count of entries where the candidate
    beats `dist_in`. With `row_flag` (int32 [vp]), sets it to 1 for every
    dist row the call lowered and adds the rows it newly set to
    `rows_changed` (int32 [1]). Neighbor ids must lie in [0, vp) — the
    kernel does not check them. Returns `changed`.

    The split solve's loop guard: with `ctl` (the loop's int32 control
    block, `ops/split_loop.py`) the call does nothing unless bit `ctl[0]`
    of `phase_mask` is set, and with `n_live` (int32 [1]) it relaxes only
    the first `n_live[0]` of its `n` rows; on the card both are read by
    the kernel, so the launch can sit in a CUDA graph.

    A CUDA tensor launches the kernel that `design_for(W, B)` names; a
    CPU tensor runs `relax_rows_ref` (on the rows `live_rows` names).
    """
    return _relax(
        "openr_relax_rows", dist_in, out, nbr, wgt, roots, over, row0, n,
        src_rows, dst_rows, changed, row_flag, rows_changed, ctl,
        phase_mask, n_live,
    )


def relax_rows_generic(
    dist_in, out, nbr, wgt, roots, over=None, *,
    row0=0, n=None, src_rows=None, dst_rows=None, changed=None,
    row_flag=None, rows_changed=None,
):
    """`relax_rows` through the generic kernel at any shape, to measure
    the two designs side by side; the solve never calls it."""
    return _relax(
        "openr_relax_rows_generic", dist_in, out, nbr, wgt, roots, over,
        row0, n, src_rows, dst_rows, changed, row_flag, rows_changed,
    )


def relax_sweep(dist, nbr, wgt, roots, over=None):
    """One dense Jacobi sweep over all rows, as the Pallas kernel does:
    returns (new dist, changed count as an int32 [1] tensor)."""
    out = dist.clone()
    changed = torch.zeros(1, dtype=torch.int32, device=dist.device)
    relax_rows(dist, out, nbr, wgt, roots, over, row0=0, changed=changed)
    return out, changed


def batched_sssp_relax(nbr, wgt, node_overloaded, roots,
                       has_overloads=True, stats: dict | None = None):
    """Dense-table batched SSSP to fixpoint on the relax kernel: the
    port of `openr_tpu/ops/spf_pallas.py` `batched_sssp_pallas` and of
    `openr_tpu/ops/spf.py` `batched_sssp_dense` (the same function). One
    changed-count readback per sweep; with `stats`, adds sweeps and
    host_reads."""
    vp = nbr.shape[0]
    b = roots.shape[0]
    dist = torch.full((vp, b), INF_DIST, dtype=torch.int32, device=nbr.device)
    dist[roots.long(), torch.arange(b, device=nbr.device)] = 0
    over = node_overloaded[nbr.long()].contiguous() if has_overloads else None
    sweeps = 0
    for _ in range(vp):
        dist, changed = relax_sweep(dist, nbr, wgt, roots, over)
        sweeps += 1
        if int(changed.item()) == 0:
            break
    if stats is not None:
        stats["sweeps"] = stats.get("sweeps", 0) + sweeps
        stats["host_reads"] = stats.get("host_reads", 0) + sweeps
    return dist

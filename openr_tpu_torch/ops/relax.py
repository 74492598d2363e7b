"""The relax kernel: one pull-relax of a set of rows of an in-neighbor
table into a distance matrix.

Port of the JAX package's only Pallas kernel,
`openr_tpu/ops/spf_pallas.py` `_relax_kernel`, with row indirection added
so that one kernel serves every `_relax_rows` site of the split solve
(`openr_tpu/ops/spf_split.py`): the dense base table (`row0`), the
overflow table (`dst_rows=ov_ids`) and the compacted tail
(`src_rows=dst_rows=rows`). The kernel is `csrc/relax.cu`; see its
header for the semantics and the design.

`relax_rows` chooses by device alone: a CUDA tensor launches the hand
kernel (a build or launch failure raises), a CPU tensor runs the plain
PyTorch version `relax_rows_ref`.
"""

from __future__ import annotations

import ctypes
import threading
from contextlib import contextmanager

import torch

from openr_tpu_torch.common.constants import DIST_INF

INF_DIST = DIST_INF

#: kernel launches made by `relax_rows` (CUDA path only)
LAUNCHES = 0
_PROFILE: list | None = None
_FN = None
_FN_LOCK = threading.Lock()


def reset_launches() -> None:
    global LAUNCHES
    LAUNCHES = 0


@contextmanager
def profile_launches():
    """Record a pair of CUDA events around every kernel launch made in
    the block; yields the list of (start, end) pairs."""
    global _PROFILE
    events: list = []
    prev, _PROFILE = _PROFILE, events
    try:
        yield events
    finally:
        _PROFILE = prev


def _kernel():
    global _FN
    with _FN_LOCK:
        if _FN is None:
            from openr_tpu_torch.ops import cuda_build

            fn = cuda_build.load("relax").openr_relax_rows
            fn.argtypes = [
                ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
                ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
                ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
                ctypes.c_void_p, ctypes.c_void_p,
            ]
            fn.restype = ctypes.c_int
            _FN = fn
    return _FN


def build() -> None:
    """Build and load the kernel now (it is otherwise built at first
    launch)."""
    _kernel()


def _rows(row0, n, src_rows, dst_rows, device):
    """(table rows, target rows) as int64 index tensors."""
    if src_rows is None:
        r = torch.arange(row0, row0 + n, device=device)
    else:
        r = src_rows.long()
    return r, (r if dst_rows is None else dst_rows.long())


def relax_rows_ref(
    dist_in, out, nbr, wgt, roots, over=None, *,
    row0=0, n=None, src_rows=None, dst_rows=None, changed=None,
):
    """Plain PyTorch version of the relax kernel, same signature and
    result: min-scatters each listed row's candidate minimum into `out`
    and adds the count of entries below `dist_in` to `changed`. All
    candidates are computed from `dist_in` before `out` is written."""
    n = _count(nbr, row0, n, src_rows, dst_rows)
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
    out.scatter_reduce_(
        0, t[:, None].expand(n, b), acc, reduce="amin", include_self=True
    )
    return changed


def _count(nbr, row0, n, src_rows, dst_rows) -> int:
    if n is not None:
        return int(n)
    if src_rows is not None:
        return src_rows.shape[0]
    if dst_rows is not None:
        return dst_rows.shape[0]
    return nbr.shape[0] - row0


def _check(dist_in, out, nbr, wgt, roots, over, row0, n, src_rows,
           dst_rows, changed):
    dev = dist_in.device
    named = [("dist_in", dist_in, torch.int32), ("out", out, torch.int32),
             ("nbr", nbr, torch.int32), ("wgt", wgt, torch.int32),
             ("roots", roots, torch.int32)]
    if over is not None:
        named.append(("over", over, torch.bool))
    for nm, x in (("src_rows", src_rows), ("dst_rows", dst_rows)):
        if x is not None:
            named.append((nm, x, torch.int32))
    if changed is not None:
        named.append(("changed", changed, torch.int32))
    for nm, x, dt in named:
        if x.device != dev:
            raise ValueError(f"relax_rows: {nm} on {x.device}, dist on {dev}")
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


def relax_rows(
    dist_in, out, nbr, wgt, roots, over=None, *,
    row0=0, n=None, src_rows=None, dst_rows=None, changed=None,
):
    """Relax `n` rows of the table [R,W] (`nbr`, `wgt`, optional `over`
    bool mask of overloaded in-neighbors) against `dist_in` [vp,B],
    min-scattering into `out` [vp,B] (may be `dist_in` itself).

    Row i reads table row `src_rows[i]` (default `row0 + i`) and writes
    dist row `dst_rows[i]` (default: the table row). With `changed` (an
    int32 [1] tensor), adds the count of entries where the candidate
    beats `dist_in`. Neighbor ids must lie in [0, vp) — the kernel does
    not check them. Returns `changed`.
    """
    global LAUNCHES
    n = _count(nbr, row0, n, src_rows, dst_rows)
    _check(dist_in, out, nbr, wgt, roots, over, row0, n, src_rows,
           dst_rows, changed)
    if dist_in.device.type == "cpu":
        return relax_rows_ref(
            dist_in, out, nbr, wgt, roots, over, row0=row0, n=n,
            src_rows=src_rows, dst_rows=dst_rows, changed=changed,
        )
    if dist_in.device.type != "cuda":
        raise ValueError(f"relax_rows: no kernel for {dist_in.device}")
    if n == 0:
        return changed
    fn = _kernel()

    def ptr(x):
        return None if x is None else x.data_ptr()

    with torch.cuda.device(dist_in.device):
        stream = torch.cuda.current_stream().cuda_stream
        ev = None
        if _PROFILE is not None:
            ev = (torch.cuda.Event(enable_timing=True),
                  torch.cuda.Event(enable_timing=True))
            ev[0].record()
        err = fn(
            ptr(dist_in), ptr(out), dist_in.shape[1], ptr(nbr), ptr(wgt),
            ptr(over), nbr.shape[1], ptr(roots), ptr(src_rows),
            ptr(dst_rows), int(row0), n, ptr(changed), stream,
        )
        if err != 0:
            from openr_tpu_torch.ops import cuda_build

            msg = cuda_build.load("relax").openr_cuda_error_string
            msg.restype = ctypes.c_char_p
            msg.argtypes = [ctypes.c_int]
            raise RuntimeError(
                f"relax kernel launch failed: {msg(err).decode()} ({err})"
            )
        LAUNCHES += 1
        if ev is not None:
            ev[1].record()
            _PROFILE.append(ev)
    return changed


def relax_sweep(dist, nbr, wgt, roots, over=None):
    """One dense Jacobi sweep over all rows, as the Pallas kernel does:
    returns (new dist, changed count as an int32 [1] tensor)."""
    out = dist.clone()
    changed = torch.zeros(1, dtype=torch.int32, device=dist.device)
    relax_rows(dist, out, nbr, wgt, roots, over, row0=0, changed=changed)
    return out, changed


def batched_sssp_relax(nbr, wgt, node_overloaded, roots,
                       has_overloads=True):
    """Dense-table batched SSSP to fixpoint on the relax kernel: the
    port of `openr_tpu/ops/spf_pallas.py` `batched_sssp_pallas`. One
    changed-count readback per sweep."""
    vp = nbr.shape[0]
    b = roots.shape[0]
    dist = torch.full((vp, b), INF_DIST, dtype=torch.int32, device=nbr.device)
    dist[roots.long(), torch.arange(b, device=nbr.device)] = 0
    over = node_overloaded[nbr.long()].contiguous() if has_overloads else None
    for _ in range(vp):
        dist, changed = relax_sweep(dist, nbr, wgt, roots, over)
        if int(changed.item()) == 0:
            break
    return dist

"""The RIB epilogue of the split solve: the first-hop bits, the LFA bits
and the root's distance column packed into one uint8 buffer, the layout
`ops/spf_split.py` `unpack_rib_buffer` decodes:

    [ d_root as 4·vp bytes | packbits(fh) | packbits(lfa)? ]

The port of the epilogue the JAX package fuses into
`batched_sssp_split_rib` (`openr_tpu/ops/spf_split.py:524-532`:
`first_hop_matrix`, `lfa_matrix`, MSB-first `jnp.packbits`).

`rib_buffer` picks by `dist.device.type`: a CUDA tensor launches
`rib_epilogue_kernel` of `csrc/rib_epilogue.cu`, one launch for the
whole buffer (a build or launch failure raises); a CPU tensor runs the
plain version `rib_buffer_ref`, the composition of `ops/spf.py`'s
`first_hop_matrix` and `lfa_matrix` with `packbits_rows`.
"""

from __future__ import annotations

import ctypes
import threading

import numpy as np
import torch

from openr_tpu_torch.monitor import device as _telemetry
from openr_tpu_torch.ops import counts
from openr_tpu_torch.ops.spf import first_hop_matrix, first_hop_work, lfa_matrix

#: the kernel function, as a profiler names it
KERNEL_NAME = "rib_epilogue_kernel"

#: the C entry points of `csrc/rib_epilogue.cu` and their ctypes types
ENTRY_POINTS = {
    "openr_rib_epilogue": ([
        ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,  # dist, vp, B, N
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,  # metric, ids, over
        ctypes.c_int, ctypes.c_int, ctypes.c_void_p,  # my_id, with_lfa, out
        ctypes.c_void_p,  # stream
    ], ctypes.c_int),
    "openr_rib_error_string": ([ctypes.c_int], ctypes.c_char_p),
}

#: kernel launches made by `rib_buffer` (CUDA path only)
LAUNCHES = 0
_LIB = None
_LIB_LOCK = threading.Lock()


def reset_launches() -> None:
    global LAUNCHES
    LAUNCHES = 0


def _lib():
    global _LIB
    with _LIB_LOCK:
        if _LIB is None:
            from openr_tpu_torch.ops import cuda_build

            lib = cuda_build.load("rib_epilogue")
            for name, (argtypes, restype) in ENTRY_POINTS.items():
                fn = getattr(lib, name)
                fn.argtypes = argtypes
                fn.restype = restype
            _LIB = lib
    return _LIB


def build() -> None:
    """Build and load the kernel now (it is otherwise built at first
    launch)."""
    _lib()


def packbits_rows(bits):
    """MSB-first packbits along the last axis of a bool [R, V] tensor
    (V a multiple of 8): the layout of `jnp.packbits(..., axis=1)` and
    the inverse of `np.unpackbits` with its default bit order."""
    r, v = bits.shape
    weights = torch.tensor(
        [128, 64, 32, 16, 8, 4, 2, 1], dtype=torch.uint8, device=bits.device
    )
    return (bits.reshape(r, v // 8, 8).to(torch.uint8) * weights).sum(
        dim=2, dtype=torch.uint8
    )


def buffer_bytes(vp: int, n: int, with_lfa: bool) -> int:
    """Length of the packed buffer of `n` neighbors over `vp` rows."""
    return 4 * vp + (2 if with_lfa else 1) * n * (vp // 8)


def row_sectors(vp: int, b: int, cols: int) -> int:
    """32-byte sectors of a row-major int32 [vp, b] matrix (its base
    32-byte aligned) that hold columns 0 .. cols - 1 of some row: what
    any reader of those columns must fetch from DRAM."""
    if (4 * b) % 32 == 0:  # rows start on a sector
        return vp * -(-4 * cols // 32)
    start = np.arange(vp, dtype=np.int64) * (4 * b)
    first, last = start // 32, (start + 4 * cols - 1) // 32
    prev = np.concatenate([[-1], last[:-1]])  # a sector two rows share
    return int(np.clip(last - np.maximum(first, prev + 1) + 1, 0, None)
               .sum())


def epilogue_work(vp: int, b: int, n: int, with_lfa: bool
                  ) -> tuple[int, int]:
    """(least DRAM bytes, integer operations) of one epilogue of `n`
    neighbors on a [vp, b] distance matrix: the sectors that hold
    columns 0..n of every row (`row_sectors`: all of it where n = b - 1
    and b is a multiple of 8), the neighbors' metric, id and overload
    flag read, the bits written packed (vp / 8 bytes a neighbor row,
    twice with LFA) behind the root column's 4·vp bytes;
    `first_hop_work`'s operations. LFA adds the neighbors' columns of
    row `my_id` and an add, three compares and three ands per bit."""
    nbytes = (32 * row_sectors(vp, b, n + 1) + n * 9
              + buffer_bytes(vp, n, with_lfa))
    ops = first_hop_work(vp, n + 1)[1]
    if with_lfa:
        nbytes += n * 4
        ops += 7 * n * vp
    return nbytes, ops


def rib_buffer_ref(dist, nbr_metric, nbr_ids, nbr_over, my_id, with_lfa):
    """Plain version: `first_hop_matrix` (and `lfa_matrix`) packed with
    `packbits_rows` behind the root column's bytes."""
    fh = first_hop_matrix(dist, nbr_metric, nbr_ids, nbr_over)
    parts = [
        dist[:, 0].contiguous().view(torch.uint8),
        packbits_rows(fh).reshape(-1),
    ]
    if with_lfa:
        lfa = lfa_matrix(dist, my_id, nbr_ids, nbr_over)
        parts.append(packbits_rows(lfa).reshape(-1))
    return torch.cat(parts)


def rib_buffer(dist, nbr_metric, nbr_ids, nbr_over, my_id: int,
               with_lfa: bool):
    """The packed buffer (uint8 [`buffer_bytes`]) from the solved
    distances `dist` [vp, B] (column 0 the root, 1..N its neighbors):
    `nbr_metric` int32 [N], `nbr_ids` int32 [N] (padding: the dead slot),
    `nbr_over` bool [N] (padding: True), `my_id` the root's row (LFA
    only). vp must be a multiple of 8."""
    vp, b = dist.shape
    n = nbr_ids.shape[0]
    if vp % 8:
        raise ValueError(f"rib_buffer: vp {vp} is not a multiple of 8")
    if n > b - 1 or nbr_metric.shape != (n,) or nbr_over.shape != (n,):
        raise ValueError(
            f"rib_buffer: {n} neighbor ids, metrics {tuple(nbr_metric.shape)}"
            f" and flags {tuple(nbr_over.shape)} against {b} columns")
    sink = _telemetry.sink()
    if sink is not None:
        nbytes, ops = epilogue_work(vp, b, n, with_lfa)
        sink.add("rib_epilogue", nbytes, ops)
    if dist.device.type == "cpu":
        return rib_buffer_ref(dist, nbr_metric, nbr_ids, nbr_over, my_id,
                              with_lfa)
    for nm, x, dt in (("dist", dist, torch.int32),
                      ("nbr_metric", nbr_metric, torch.int32),
                      ("nbr_ids", nbr_ids, torch.int32),
                      ("nbr_over", nbr_over, torch.bool)):
        if x.device != dist.device:
            raise ValueError(f"rib_buffer: {nm} on {x.device}")
        if x.dtype != dt:
            raise TypeError(f"rib_buffer: {nm} is {x.dtype}, needs {dt}")
        if not x.is_contiguous():
            raise ValueError(f"rib_buffer: {nm} is not contiguous")
    if with_lfa and not 0 <= int(my_id) < vp:
        raise ValueError(f"rib_buffer: my_id {my_id} outside [0, {vp})")
    out = torch.empty(buffer_bytes(vp, n, with_lfa), dtype=torch.uint8,
                      device=dist.device)
    lib = _lib()
    with torch.cuda.device(dist.device):
        err = lib.openr_rib_epilogue(
            dist.data_ptr(), vp, b, n, nbr_metric.data_ptr(),
            nbr_ids.data_ptr(), nbr_over.data_ptr(), int(my_id),
            int(bool(with_lfa)), out.data_ptr(),
            torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(
            f"{KERNEL_NAME} launch failed: "
            f"{lib.openr_rib_error_string(err).decode()} ({err})")
    _counted()
    return out


def _counted() -> None:
    """One launch, counted under the shared lock (many threads launch)."""
    global LAUNCHES
    with counts.LOCK:
        LAUNCHES += 1

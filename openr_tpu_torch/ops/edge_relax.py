"""Edge-list Bellman-Ford: the batched multi-root SSSP over the padded
CSR edge list, the port of `openr_tpu/ops/spf.py` `batched_sssp`.

`batched_sssp` starts from `edge_init` (each root's own out-edges relaxed
with no penalty, blocked ones included: the overloaded-root exemption;
then 0 at the root) and runs `edge_round` (a Jacobi round over the
unblocked edges) until a round lowers nothing, at most `num_nodes`
rounds, reading the changed word back once a round. The edge arrays are
sorted by destination, as `CsrGraph` keeps them; `edge_row_start` gives
each node's run of them, which the kernels walk.

`edge_init` and `edge_round` pick by `tensor.device.type` alone: a CUDA
tensor launches `edge_init_kernel` / `edge_relax_kernel` of
`csrc/edge_relax.cu` (a build or launch failure raises), a CPU tensor
runs the plain PyTorch version, `edge_init_ref` / `edge_round_ref`: a
gather, an add and a `scatter_reduce_` "amin" by destination, in chunks
of edges so that no [E, B] tensor is built whole.
"""

from __future__ import annotations

import ctypes
import threading

import numpy as np
import torch

from openr_tpu_torch.common.constants import DIST_INF

INF_DIST = DIST_INF
#: the kernel functions, as a profiler names them
KERNEL_NAMES = {"init": "edge_init_kernel", "round": "edge_relax_kernel"}

#: the C entry points of `csrc/edge_relax.cu` and the ctypes types bound
#: to them
ENTRY_POINTS = {
    "openr_edge_init": (
        [
            ctypes.c_void_p, ctypes.c_void_p,  # dist_out, row_start
            ctypes.c_void_p, ctypes.c_void_p,  # src, metric
            ctypes.c_void_p, ctypes.c_int, ctypes.c_int,  # roots, V, B
            ctypes.c_void_p,  # stream
        ],
        ctypes.c_int,
    ),
    "openr_edge_relax": (
        [
            ctypes.c_void_p, ctypes.c_void_p,  # dist_in, dist_out
            ctypes.c_void_p, ctypes.c_void_p,  # row_start, src
            ctypes.c_void_p, ctypes.c_void_p,  # metric, blocked
            ctypes.c_int, ctypes.c_int,  # V, B
            ctypes.c_void_p, ctypes.c_void_p,  # changed, stream
        ],
        ctypes.c_int,
    ),
    "openr_edge_error_string": ([ctypes.c_int], ctypes.c_char_p),
}

#: kernel launches made by the wrappers (CUDA path only), by kernel
LAUNCHES = {"init": 0, "round": 0}
_LIB = None
_LIB_LOCK = threading.Lock()
#: elements of one [edges, B] candidate chunk of the plain version
_REF_CHUNK = 1 << 24


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


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
        raise ValueError(
            "edge_dst must be ascending and within [0, num_nodes): the "
            "edge-list solve walks each node's run of dst-sorted edges"
        )
    finite = np.flatnonzero(np.asarray(edge_metric) < INF_DIST)
    dst = dst[: int(finite[-1]) + 1 if len(finite) else 0]
    return np.searchsorted(dst, np.arange(num_nodes + 1)).astype(np.int32)


def device_row_start(edge_dst: torch.Tensor, num_nodes: int,
                     edge_metric: torch.Tensor) -> torch.Tensor:
    """`edge_row_start` of the edge tensors, on their device (one round
    trip to the host)."""
    return torch.from_numpy(edge_row_start(
        edge_dst.cpu().numpy(), num_nodes, edge_metric.cpu().numpy()
    )).to(edge_dst.device)


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


def _check_shapes(name, dist, row_start, src, metric, extra, b_cols):
    v = dist.shape[0]
    if dist.dim() != 2:
        raise ValueError(f"{name}: dist must be [V, B]")
    if row_start.shape != (v + 1,):
        raise ValueError(f"{name}: row_start must be [{v + 1}]")
    e = src.shape[0]
    for nm, x in (("metric", metric), *extra):
        if x.shape != (e,):
            raise ValueError(f"{name}: {nm} must be [{e}] like src")
    if b_cols is not None and b_cols != dist.shape[1]:
        raise ValueError(f"{name}: roots must be [{dist.shape[1]}]")


def _check_aligned(name, b, tensors):
    """Where `b` is a multiple of 4, a kernel thread carries 4 columns
    (`csrc/edge_relax.cu` `cols_per_thread`) and loads 16-byte vectors
    of dist (and of roots)."""
    if b % 4:
        return
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
    """Plain PyTorch version of the init: `out` [V, B] = the per-column
    min of the metrics of the root's own out-edges into each node
    (blocked ones too), at most INF, and 0 at the root."""
    v, b = out.shape
    out.fill_(INF_DIST)
    step = max(1, _REF_CHUNK // max(b, 1))
    for c0 in range(0, src.shape[0], step):
        s = src[c0 : c0 + step]
        cand = torch.where(
            s[:, None] == roots[None, :],
            metric[c0 : c0 + step, None],
            INF_DIST,
        )
        out.scatter_reduce_(
            0, dst[c0 : c0 + step, None].long().expand_as(cand), cand,
            reduce="amin", include_self=True,
        )
    out.clamp_max_(INF_DIST)
    out[roots.long(), torch.arange(b, device=out.device)] = 0
    return out


def edge_round_ref(dist_in, out, src, dst, metric, blocked, changed):
    """Plain PyTorch version of one round: `out` = min(dist_in, the
    unblocked edges' guarded candidates, min-scattered by destination),
    all taken from `dist_in`; `changed` [1] set to 1 if an entry fell,
    else 0."""
    out.copy_(dist_in)
    b = dist_in.shape[1]
    step = max(1, _REF_CHUNK // max(b, 1))
    for c0 in range(0, src.shape[0], step):
        d = dist_in[src[c0 : c0 + step].long()]
        ok = ~blocked[c0 : c0 + step, None] & (d < INF_DIST)
        cand = torch.where(
            ok,
            torch.clamp_max(d + metric[c0 : c0 + step, None], INF_DIST),
            INF_DIST,
        )
        out.scatter_reduce_(
            0, dst[c0 : c0 + step, None].long().expand_as(cand), cand,
            reduce="amin", include_self=True,
        )
    changed.fill_(int(bool((out < dist_in).any())))
    return changed


def edge_init(out, src, dst, metric, roots, row_start):
    """The init into `out` [V, B] int32: `edge_init_kernel` on a CUDA
    tensor, `edge_init_ref` on a CPU one. `row_start` [V+1] int32
    (`edge_row_start`) must describe `dst` (the runs may leave out
    trailing INF slots); ids in `src` of unblocked edges must lie in
    [0, V)."""
    i32 = torch.int32
    _check("edge_init", (
        ("out", out, i32), ("src", src, i32), ("dst", dst, i32),
        ("metric", metric, i32), ("roots", roots, i32),
        ("row_start", row_start, i32),
    ), out.device)
    _check_shapes("edge_init", out, row_start, src, metric,
                  (("dst", dst),), roots.shape[0])
    if out.device.type == "cpu":
        return edge_init_ref(out, src, dst, metric, roots)
    if out.device.type != "cuda":
        raise ValueError(f"edge_init: no kernel for {out.device}")
    v, b = out.shape
    _check_aligned("edge_init", b, (("out", out), ("roots", roots)))
    lib = _lib()
    with torch.cuda.device(out.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.openr_edge_init(
            out.data_ptr(), row_start.data_ptr(), src.data_ptr(),
            metric.data_ptr(), roots.data_ptr(), v, b, stream,
        )
    _launch_error(lib, err, "edge_init_kernel")
    LAUNCHES["init"] += 1
    return out


def edge_round(dist_in, out, src, dst, metric, blocked, row_start, changed):
    """One Jacobi round from `dist_in` into `out` (distinct [V, B] int32
    buffers), `changed` [1] int32 set to 1 if an entry fell, else 0:
    `edge_relax_kernel` on a CUDA tensor, `edge_round_ref` on a CPU
    one."""
    i32 = torch.int32
    _check("edge_round", (
        ("dist_in", dist_in, i32), ("out", out, i32), ("src", src, i32),
        ("dst", dst, i32), ("metric", metric, i32),
        ("blocked", blocked, torch.bool), ("row_start", row_start, i32),
        ("changed", changed, i32),
    ), dist_in.device)
    _check_shapes("edge_round", dist_in, row_start, src, metric,
                  (("dst", dst), ("blocked", blocked)), None)
    if out.shape != dist_in.shape:
        raise ValueError("edge_round: out must have dist_in's shape")
    if out.data_ptr() == dist_in.data_ptr():
        raise ValueError("edge_round: a Jacobi round needs two buffers")
    if changed.numel() < 1:
        raise ValueError("edge_round: changed needs one int32 slot")
    if dist_in.device.type == "cpu":
        return edge_round_ref(dist_in, out, src, dst, metric, blocked,
                              changed)
    if dist_in.device.type != "cuda":
        raise ValueError(f"edge_round: no kernel for {dist_in.device}")
    v, b = dist_in.shape
    _check_aligned("edge_round", b, (("dist_in", dist_in), ("out", out)))
    lib = _lib()
    with torch.cuda.device(dist_in.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.openr_edge_relax(
            dist_in.data_ptr(), out.data_ptr(), row_start.data_ptr(),
            src.data_ptr(), metric.data_ptr(), blocked.data_ptr(), v, b,
            changed.data_ptr(), stream,
        )
    _launch_error(lib, err, "edge_relax_kernel")
    LAUNCHES["round"] += 1
    return changed


def batched_sssp(edge_src, edge_dst, edge_metric, edge_blocked, roots,
                 num_nodes: int, row_start=None, stats: dict | None = None):
    """Distances [num_nodes, B] int32 from each root (INF_DIST =
    unreachable), on the edge arrays' device.

    `edge_blocked` must already hold the overloaded-transit edges
    (`ops.spf.build_blocked`); the root exemption happens at init.
    `row_start` (`device_row_start`) is built here when not given. Repeated roots each get their own column. With
    `stats`, adds rounds and host_reads (one changed-word read a
    round)."""
    dev = edge_src.device
    if row_start is None:
        row_start = device_row_start(edge_dst, num_nodes, edge_metric)
    roots = roots.to(device=dev, dtype=torch.int32).contiguous()
    b = roots.shape[0]
    cur = torch.empty((num_nodes, b), dtype=torch.int32, device=dev)
    nxt = torch.empty_like(cur)
    changed = torch.zeros(1, dtype=torch.int32, device=dev)
    edge_init(cur, edge_src, edge_dst, edge_metric, roots, row_start)
    rounds = 0
    for _ in range(num_nodes):
        edge_round(cur, nxt, edge_src, edge_dst, edge_metric, edge_blocked,
                   row_start, changed)
        rounds += 1
        cur, nxt = nxt, cur
        if int(changed.item()) == 0:
            break
    if stats is not None:
        stats["rounds"] = stats.get("rounds", 0) + rounds
        stats["host_reads"] = stats.get("host_reads", 0) + rounds
    return cur

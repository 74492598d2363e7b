"""Multi-advertiser election on the device: the port of
`openr_tpu/ops/election.py` (`_elect_seg`, `elect_multi_device`).

One call elects every multi-advertiser (anycast ECMP) prefix of the
election view against the solved root-distance vector: per prefix, the
best metric-key rank among the eligible advertisers, whether this node
is among the best, the least IGP distance among the best, and the
chosen (best and nearest) slots. The algebra is integer-exact, so the
result equals `decision/election.py` `elect_multi_np`.

`elect_seg` picks by `tensor.device.type` alone: a CUDA tensor launches
`elect_seg_kernel` of `csrc/election.cu` (a build or launch failure
raises), a CPU tensor runs the plain PyTorch version `elect_seg_ref`.

The advertiser matrix (indptr, seg, adv, known, rank) is fixed for an
election-view generation and cached on the device under its `gen`. The
distance vector may already lie on the device (the solve's root
column); the five results land in one byte buffer, brought back with
one copy. The JAX package pads both axes to power-of-two buckets so
that XLA compiles few shapes; the kernel takes any shape, so the port
does not pad.
"""

from __future__ import annotations

import ctypes
import threading

import numpy as np
import torch

from openr_tpu_torch.common.constants import DIST_INF
from openr_tpu_torch.decision.election import MultiElection, MultiTable
from openr_tpu_torch.monitor import compile_ledger
from openr_tpu_torch.monitor import device as _telemetry

INF_DIST = DIST_INF
I32_MIN = -(1 << 31)
I32_MAX = (1 << 31) - 1
#: the kernel function, as a profiler names it
KERNEL_NAME = "elect_seg_kernel"

#: the C entry points of `csrc/election.cu` and the ctypes types bound
#: to them
ENTRY_POINTS = {
    "openr_elect_seg": (
        [
            ctypes.c_void_p, ctypes.c_int,  # indptr, M
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,  # adv, known, rank
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,  # d_vec, reach, my_id
            ctypes.c_void_p, ctypes.c_void_p,  # best_r, min_igp
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,  # is_best, chosen, local
            ctypes.c_void_p,  # stream
        ],
        ctypes.c_int,
    ),
    "openr_election_error_string": ([ctypes.c_int], ctypes.c_char_p),
}

#: kernel launches made by `elect_seg` (CUDA path only)
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

            lib = cuda_build.load("election")
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


def elect_seg_ref(indptr, seg, adv, known, rank, d_vec, reach, my_id: int):
    """Plain PyTorch version of the kernel: returns (best_r [M] i32,
    min_igp [M] i32, is_best [S] bool, chosen [S] bool, local [M] bool).
    An empty segment keeps the identities (best_r INT32_MIN, min_igp
    INT32_MAX), as `jax.ops.segment_max` / `segment_min` give them."""
    m = indptr.shape[0] - 1
    dev = adv.device
    seg_l = seg.long()
    adv_l = adv.long()
    is_me = known & (adv == my_id)
    elig = (known & reach[adv_l]) | is_me
    r_eff = torch.where(elig, rank, -1)
    best_r = torch.full((m,), I32_MIN, dtype=torch.int32, device=dev)
    best_r.scatter_reduce_(0, seg_l, r_eff, reduce="amax")
    is_best = elig & (r_eff == best_r[seg_l])
    hit = (is_best & is_me).to(torch.int32)
    local = torch.zeros(m, dtype=torch.int32, device=dev)
    local.scatter_reduce_(0, seg_l, hit, reduce="amax")
    d_adv = torch.where(is_best, d_vec[adv_l], INF_DIST)
    min_igp = torch.full((m,), I32_MAX, dtype=torch.int32, device=dev)
    min_igp.scatter_reduce_(0, seg_l, d_adv, reduce="amin")
    chosen = is_best & (d_adv == min_igp[seg_l])
    return best_r, min_igp, is_best, chosen, local > 0


def _check(indptr, seg, adv, known, rank, d_vec, reach):
    dev = adv.get_device()
    i32, b8 = torch.int32, torch.bool
    for nm, x, dt in (
        ("indptr", indptr, i32), ("seg", seg, i32), ("adv", adv, i32),
        ("known", known, b8), ("rank", rank, i32), ("d_vec", d_vec, i32),
        ("reach", reach, b8),
    ):
        if x.get_device() != dev:
            raise ValueError(f"elect_seg: {nm} on {x.device}, adv on {adv.device}")
        if x.dtype != dt:
            raise TypeError(f"elect_seg: {nm} is {x.dtype}, needs {dt}")
        if x.dim() != 1 or not x.is_contiguous():
            raise ValueError(f"elect_seg: {nm} must be a contiguous vector")
    s = adv.shape[0]
    if seg.shape[0] != s or known.shape[0] != s or rank.shape[0] != s:
        raise ValueError("elect_seg: seg/adv/known/rank must be one [S] shape")
    if indptr.shape[0] < 1 or reach.shape != d_vec.shape:
        raise ValueError("elect_seg: indptr needs M+1 entries, reach d_vec's shape")


def elect_work(m: int, s: int) -> tuple[int, int]:
    """(least DRAM bytes, integer operations) of one election of M
    prefixes over S slots: each slot's seg, known, adv, reach byte and
    rank read and its two result bytes written; each prefix's indptr word
    read and its best rank, least IGP and local byte written; eight
    operations a slot."""
    return s * (4 + 1 + 4 + 1 + 4 + 1 + 1) + m * (4 + 4 + 4 + 1), s * 8


def out_nbytes(m: int, s: int) -> int:
    """Bytes of the packed result buffer for M prefixes and S slots:
    [best_r i32 M | min_igp i32 M | local u8 M | is_best u8 S | chosen u8 S]."""
    return 9 * m + 2 * s


def _out_views(buf, m: int, s: int):
    """(best_r, min_igp, is_best, chosen, local) as views of `buf`."""
    return (buf[: 4 * m].view(torch.int32),
            buf[4 * m : 8 * m].view(torch.int32),
            buf[9 * m : 9 * m + s].view(torch.bool),
            buf[9 * m + s :].view(torch.bool),
            buf[8 * m : 9 * m].view(torch.bool))


def elect_seg(indptr, seg, adv, known, rank, d_vec, reach, my_id: int,
              out=None):
    """Segmented election over the CSR slots of the multi table (slot s
    of prefix `seg[s]`, prefix m owning slots `indptr[m]:indptr[m+1]`):
    eligible = (known and reach[adv]) or (known and adv == my_id); best =
    the max rank among the eligible; local = my slot among the best;
    min_igp = the min `d_vec[adv]` among the best; chosen = best slots at
    min_igp. Returns what `elect_seg_ref` returns, as views of `out` (a
    uint8 buffer of `out_nbytes(M, S)` bytes on adv's device) when it is
    given. Advertiser ids must lie in [0, len(d_vec)): the kernel does
    not check them."""
    global LAUNCHES
    _check(indptr, seg, adv, known, rank, d_vec, reach)
    m, s = indptr.shape[0] - 1, adv.shape[0]
    dev = adv.device
    if out is None:
        out = torch.empty(out_nbytes(m, s), dtype=torch.uint8, device=dev)
    elif (out.dtype != torch.uint8 or out.shape != (out_nbytes(m, s),)
          or out.device != dev):
        raise ValueError(f"elect_seg: out must be uint8 [{out_nbytes(m, s)}] "
                         f"on {dev}")
    views = _out_views(out, m, s)
    sink = _telemetry.sink()
    if sink is not None and m:
        sink.add("election", *elect_work(m, s))
    if dev.type == "cpu":
        ref = elect_seg_ref(indptr, seg, adv, known, rank, d_vec, reach, my_id)
        for v, r in zip(views, ref):
            v.copy_(r)
        return views
    if dev.type != "cuda":
        raise ValueError(f"elect_seg: no kernel for {dev}")
    best_r, min_igp, is_best, chosen, local = views
    if m == 0:
        return views
    lib = _lib()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.openr_elect_seg(
            indptr.data_ptr(), m, adv.data_ptr(), known.data_ptr(),
            rank.data_ptr(), d_vec.data_ptr(), reach.data_ptr(), int(my_id),
            best_r.data_ptr(), min_igp.data_ptr(), is_best.data_ptr(),
            chosen.data_ptr(), local.data_ptr(), stream,
        )
    if err != 0:
        raise RuntimeError(
            "election kernel launch failed: "
            f"{lib.openr_election_error_string(err).decode()} ({err})"
        )
    LAUNCHES += 1
    return views


def elect_multi_device(
    t: MultiTable,
    d_vec,
    reach_vec,
    my_id: int,
    dev_cache: dict,
    gen,
    device,
) -> MultiElection:
    """The multi-table election through `elect_seg` on `device`; returns
    the same `MultiElection` as `elect_multi_np`. `d_vec` and
    `reach_vec` are NumPy vectors, or int32 / bool tensors already on
    `device`. The advertiser matrix is cached in `dev_cache` under
    `gen`; the results come back in one copy."""
    def up(a, dt):
        if isinstance(a, torch.Tensor):
            return a
        return torch.from_numpy(np.ascontiguousarray(a, dtype=dt)).to(device)

    cached = dev_cache.get(gen)
    if cached is None:
        cached = dev_cache[gen] = {
            "indptr": up(t.indptr, np.int32),
            "seg": up(t.seg, np.int32),
            "adv": up(t.adv, np.int32),
            "known": up(t.known, bool),
            "rank": up(t.rank, np.int32),  # dense ranks < S
        }
    m, s = len(t.indptr) - 1, len(t.adv)
    buf = torch.empty(out_nbytes(m, s), dtype=torch.uint8,
                      device=cached["adv"].device)
    d_t, reach_t = up(d_vec, np.int32), up(reach_vec, bool)
    with _telemetry.observe("_elect_seg", (m, s), span="spf:election") as cap:
        elect_seg(
            cached["indptr"], cached["seg"], cached["adv"], cached["known"],
            cached["rank"], d_t, reach_t, my_id, out=buf,
        )
        if cap:
            cap.io(args=(*cached.values(), d_t, reach_t), outs=(buf,))
    host = buf.cpu().numpy()
    compile_ledger.record_transfer(host.nbytes)
    best_r = host[: 4 * m].view(np.int32)
    local = host[8 * m : 9 * m].view(bool)
    return MultiElection(
        survive=(best_r >= 0) & ~local,
        local=local,
        is_best=host[9 * m : 9 * m + s].view(bool),
        chosen=host[9 * m + s :].view(bool),
        min_igp=host[4 * m : 8 * m].view(np.int32).astype(np.int64),
    )

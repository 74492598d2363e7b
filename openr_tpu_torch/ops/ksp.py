"""k edge-disjoint shortest paths (KSP) for a batch of jobs: the port of
`openr_tpu/ops/ksp.py` (`build_ksp_blocked`, `ksp_edge_disjoint_dense`,
`paths_to_host`).

One call computes, for every job b (root -> dests[b]), up to k
edge-disjoint shortest paths over the dense in-neighbor tables
(`ops/spf.py` `build_dense_tables`). Each round runs a masked batched
SSSP to fixpoint under the job's bans, then walks one path per job back
from its dest, at each hop to the smallest-id predecessor p with
dist[p] + w == dist[v] (ids are interned in name order, so this is the
oracle's lexicographic rule), and bans every parallel slot of each
walked link in both directions. A round in which no job finds a path
ends the call: bans only grow, so every later round would fail the same
way.

The host enqueues every round and reads nothing back until the end:
per round, `ksp_sssp` (the masked SSSP to fixpoint, one launch) and
`ksp_walk` (every job's walk). One int32 device word per round carries
the early exit: the walk of round i sets word i+1 when some job found
its path, and both steps of round i+1 return at once when it is clear,
so a skipped round keeps its INF / -1 / 0 outputs. The rounds and sweeps
are counted on the device and come back in the one copy that brings the
paths to the host. Each step picks by `tensor.device.type` alone: a CUDA
tensor launches `ksp_sssp_kernel` / `ksp_walk_kernel` of `csrc/ksp.cu`
(a build or launch failure raises), a CPU tensor runs the plain PyTorch
version (`ksp_sssp_ref`, `ksp_walk_ref`), which honours the same round
words and counters. The kernel updates the distances in place, relaxing
only the job words whose in-neighbours fell since it last read them, and
counts grid passes where the plain version counts Jacobi sweeps (never
more passes than sweeps; the fixpoint, so the paths, is the same);
`ksp_sssp_passes_ref` models its passes and skip on the CPU. The per-job bans are bits: int32 words [V, D,
ceil(B/32)], bit b % 32 of word b // 32 for job b (the JAX kernel keeps
[V, D, B] bools).
"""

from __future__ import annotations

import ctypes
import threading

import numpy as np
import torch

from openr_tpu_torch.common.constants import DIST_INF
from openr_tpu_torch.monitor import compile_ledger
from openr_tpu_torch.monitor import device as _telemetry

INF_DIST = DIST_INF
#: the kernel function of each step, as a profiler names it
KERNEL_NAMES = {"sssp": "ksp_sssp_kernel", "walk": "ksp_walk_kernel"}

_P, _I = ctypes.c_void_p, ctypes.c_int
#: the C entry points of `csrc/ksp.cu` and the ctypes types bound to them
ENTRY_POINTS = {
    "openr_ksp_sssp_plan": ([_I, _I, _I, _P], ctypes.c_int),  # V, D, B, out[4]
    "openr_ksp_sssp": (
        [_P, _P, _P, _P, _P, _P,  # dist_in, dist_out, nbr, wgt, blocked, bans
         _P, _P, _P, _P,  # live, counters, changed, flags and stamps
         _I, _I, _I, _I, _I, _P],  # root, V, D, B, max_sweeps, stream
        ctypes.c_int,
    ),
    "openr_ksp_walk": (
        [_P, _P, _P, _P, _P, _P, _I,  # dist, nbr, wgt, blocked, bans, dests, root
         _P, _P, _P, _P, _P, _P,  # cost, path, hops, any_ok, live, counters
         _I, _I, _I, _I, _P],  # V, D, B, max_hops, stream
        ctypes.c_int,
    ),
    "openr_ksp_error_string": ([ctypes.c_int], ctypes.c_char_p),
}

#: kernel launches made by the step wrappers (CUDA path only), by step
LAUNCHES = {"sssp": 0, "walk": 0}
_LIB = None
_LIB_LOCK = threading.Lock()


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _lib():
    global _LIB
    with _LIB_LOCK:
        if _LIB is None:
            from openr_tpu_torch.ops import cuda_build

            lib = cuda_build.load("ksp")
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


def build_ksp_blocked(
    nbr: np.ndarray, node_overloaded: np.ndarray, root_id: int
) -> np.ndarray:
    """Base mask [V, D]: slots whose in-neighbor may not carry transit
    (overloaded), except the root's own out-edges."""
    return node_overloaded[nbr] & (nbr != root_id)


def ban_words(b: int) -> int:
    """int32 words per (row, slot) of the packed ban mask for b jobs."""
    return (b + 31) // 32


def unpack_bans(bans: torch.Tensor, b: int) -> torch.Tensor:
    """[V, D, NW] int32 ban words -> [V, D, b] bool."""
    j = torch.arange(b, device=bans.device)
    return ((bans[:, :, j // 32] >> (j % 32).to(torch.int32)) & 1).bool()


def pack_bans(banned: torch.Tensor) -> torch.Tensor:
    """[V, D, b] bool -> [V, D, NW] int32 ban words (bit j % 32 of word
    j // 32 for job j)."""
    v, d, b = banned.shape
    nw = ban_words(b)
    bits = torch.zeros((v, d, nw * 32), dtype=torch.int64, device=banned.device)
    bits[:, :, :b] = banned.long()
    weights = torch.ones(32, dtype=torch.int64, device=banned.device) << torch.arange(
        32, device=banned.device
    )
    words = (bits.view(v, d, nw, 32) * weights).sum(dim=3)
    return torch.where(words >= 1 << 31, words - (1 << 32), words).to(torch.int32)


# ------------------------------------------------------------- the SSSP


def ksp_relax_ref(dist_in, dist_out, nbr, wgt, blocked, bans, changed):
    """One Jacobi sweep of the masked relax from `dist_in` into
    `dist_out` in plain PyTorch (a sweep of `ksp_sssp_kernel`); sets
    `changed` [1] to 1 if some entry fell, else 0."""
    v, d_width = nbr.shape
    b = dist_in.shape[1]
    j = torch.arange(b, device=dist_in.device)
    word, shift = j // 32, (j % 32).to(torch.int32)
    acc = torch.full((v, b), INF_DIST, dtype=torch.int32, device=dist_in.device)
    for d in range(d_width):  # one [V, B] row gather per slot column
        g = dist_in[nbr[:, d].long()]
        w = wgt[:, d, None]
        banned = ((bans[:, d, :][:, word] >> shift) & 1).bool()
        usable = (
            ~blocked[:, d, None] & ~banned & (w < INF_DIST) & (g < INF_DIST)
        )
        c = torch.where(usable, torch.clamp_max(g + w, INF_DIST), INF_DIST)
        acc = torch.minimum(acc, c)
    new = torch.minimum(acc, dist_in)
    dist_out.copy_(new)
    changed.fill_(int(bool((new < dist_in).any())))
    return changed


def _sssp_start(dist0, v: int, b: int, root: int, device):
    if dist0 is not None:
        return dist0.clone()
    dist = torch.full((v, b), INF_DIST, dtype=torch.int32, device=device)
    dist[root] = 0
    return dist


def ksp_sssp_ref(dist0, nbr, wgt, blocked, bans, root: int, b: int, *,
                 max_sweeps: int, live=None, counters=None):
    """Plain PyTorch version of `ksp_sssp_kernel`: `ksp_relax_ref` from
    `dist0` [V, b] (None: INF with row `root` at 0) until a sweep lowers
    nothing or `max_sweeps` have run; adds the sweeps to `counters[1]`.
    When `live` [1] is clear nothing runs and the result is unspecified."""
    v = nbr.shape[0]
    if live is not None and not int(live[0]):
        return torch.empty((v, b), dtype=torch.int32, device=nbr.device)
    dist = _sssp_start(dist0, v, b, root, nbr.device)
    other = torch.empty_like(dist)
    changed = torch.zeros(1, dtype=torch.int32, device=nbr.device)
    sweeps = 0
    for _ in range(max_sweeps):
        ksp_relax_ref(dist, other, nbr, wgt, blocked, bans, changed)
        dist, other = other, dist
        sweeps += 1
        if not int(changed[0]):
            break
    if counters is not None:
        counters[1] += sweeps
    return dist


def _stamped(stamp, s: int):
    """The (row, job word) stamps that pass s of `ksp_sssp_kernel` must
    read again: a fall in pass s - 1 or later (csrc/ksp.cu)."""
    return stamp >= s - 1


def ksp_sssp_passes_ref(dist0, nbr, wgt, blocked, bans, root: int, b: int,
                        *, max_sweeps: int, live=None, counters=None):
    """CPU model of `ksp_sssp_kernel`'s grid passes (`csrc/ksp.cu`): from
    `dist0` [V, b] (None: INF with row `root` at 0), each pass relaxes in
    place only the (row, job word) pairs with a usable in-neighbour word
    that `_stamped` names (every word in pass 0), and stamps the words
    that fell with the pass. Every read of a pass sees the distances as
    they stood at its start and the stamps are written at the barrier:
    the schedule in which no row sees another's fall before the barrier,
    the one that leans hardest on the stamps. Stops after a pass in which
    nothing fell or after `max_sweeps` passes; adds the passes to
    `counters[1]` and returns the distances. Under this schedule a pass
    gives the Jacobi sweep's values, so the skip is exact iff the model
    equals `ksp_sssp_ref` pass for pass."""
    v = nbr.shape[0]
    dev = nbr.device
    if live is not None and not int(live[0]):
        return torch.empty((v, b), dtype=torch.int32, device=dev)
    dist = _sssp_start(dist0, v, b, root, dev)
    nw = ban_words(b)
    word = torch.arange(b, device=dev) // 32
    usable = ((wgt < INF_DIST) & ~blocked)[:, :, None]
    stamp = torch.full((v, nw), -1, dtype=torch.int64, device=dev)
    sweep = torch.empty_like(dist)
    changed = torch.zeros(1, dtype=torch.int32, device=dev)
    passes = 0
    for s in range(max_sweeps):
        act = (_stamped(stamp, s)[nbr.long()] & usable).any(dim=1)  # [V, NW]
        ksp_relax_ref(dist, sweep, nbr, wgt, blocked, bans, changed)
        new = torch.where(act[:, word], sweep, dist)
        fell = torch.zeros((v, nw * 32), dtype=torch.bool, device=dev)
        fell[:, :b] = new < dist
        fell = fell.view(v, nw, 32).any(dim=2)
        stamp = torch.where(fell, s, stamp)
        dist = new
        passes += 1
        if not bool(fell.any()):
            break
    if counters is not None:
        counters[1] += passes
    return dist


def relax_work(wgt, b: int) -> tuple[int, int]:
    """(least DRAM bytes, integer operations) of one masked relax sweep
    of `b` jobs on dense tables `wgt` [V, D]: every weight read to find
    the usable slots; the neighbor id, blocked byte and ban words only of
    a slot with a finite weight; each distance row once in and once out.
    Four operations per usable slot and job."""
    v, d = wgt.shape
    valid = int((wgt < INF_DIST).sum().item())
    nw = ban_words(b)
    return (v * d * 4 + valid * (4 + 1 + 4 * nw) + 2 * v * b * 4,
            valid * b * 4)


def sssp_work(nbr, wgt, blocked, dist) -> tuple[int, int]:
    """(least DRAM bytes, integer operations) of the masked SSSP of b
    jobs that reached the fixpoint `dist` [V, b] on dense tables [V, D]:
    each table byte read once (as `relax_work` counts them) and the
    result written once (the start is made on the card); one
    relaxation, four operations, of each usable slot (finite weight, not
    blocked) out of each entry the result reaches, for that entry's job:
    each entry settled once, as a label-setting solve does. Jacobi sweeps
    do more: every slot of each job word that can change, sweep after
    sweep."""
    v, d = wgt.shape
    b = dist.shape[1]
    usable = (wgt < INF_DIST) & ~blocked
    out_slots = torch.bincount(nbr[usable].long(), minlength=v)
    reached = (dist < INF_DIST).sum(dim=1)
    relaxations = int((out_slots.long() * reached.long()).sum().item())
    valid = int((wgt < INF_DIST).sum().item())
    nw = ban_words(b)
    return (v * d * 4 + valid * (4 + 1 + 4 * nw) + v * b * 4,
            4 * relaxations)


def walk_work(d: int, hops) -> tuple[int, int]:
    """(least DRAM bytes, integer operations) of one walk round of
    `hops.shape[0]` jobs over tables of width `d`, `hops` [B] the path
    lengths it found: each visited row's neighbor ids, weights, blocked
    bytes, ban words and its predecessors' distances read once, a word of
    path written per visited row, and each job's dest, cost, hops and
    word; four operations a slot of a visited row."""
    rows = int((hops.long() + 1).sum().item())
    b = hops.shape[0]
    return rows * d * (4 + 4 + 1 + 4 + 4) + b * 16 + rows * 4, rows * d * 4


def _check(name, dev, tensors):
    for nm, x, dt in tensors:
        if x is None:
            continue
        if x.get_device() != dev:
            raise ValueError(f"{name}: {nm} on {x.device}")
        if x.dtype != dt:
            raise TypeError(f"{name}: {nm} is {x.dtype}, needs {dt}")
        if not x.is_contiguous():
            raise ValueError(f"{name}: {nm} is not contiguous")


def _check_tables(name, nbr, wgt, blocked, bans, b):
    if nbr.dim() != 2 or wgt.shape != nbr.shape or blocked.shape != nbr.shape:
        raise ValueError(f"{name}: nbr/wgt/blocked must be one [V, D] shape")
    if bans.shape != (*nbr.shape, ban_words(b)):
        raise ValueError(
            f"{name}: bans must be [V, D, {ban_words(b)}] words for {b} jobs"
        )


def _check_words(name, live, counters):
    if live is not None and live.shape != (1,):
        raise ValueError(f"{name}: live must be one int32 word")
    if counters is not None and counters.shape != (2,):
        raise ValueError(f"{name}: counters must be [rounds, sweeps]")


def _raise(lib, err, what):
    if err != 0:
        raise RuntimeError(
            f"{what} launch failed: "
            f"{lib.openr_ksp_error_string(err).decode()} ({err})"
        )


def _ptr(x) -> int | None:
    return None if x is None else x.data_ptr()


def sssp_plan(v: int, d: int, b: int) -> tuple[int, int, int, int]:
    """(rows per block, 0 when streamed; blocks; shared-memory bytes;
    slots a warp stages at a time, 0 when resident) of a
    `ksp_sssp_kernel` launch at this shape on the current card: the
    tables stay in shared memory ("resident") when one SM's share of the
    rows fits, else each pass stages a row ("streamed"), in chunks
    where D is wider than the staging."""
    lib = _lib()
    out = (ctypes.c_int * 4)()
    _raise(lib, lib.openr_ksp_sssp_plan(v, d, b, ctypes.addressof(out)),
           "ksp_sssp_kernel plan")
    return out[0], out[1], out[2], out[3]


def _sssp_launch(dist_in, dist_out, nbr, wgt, blocked, bans, root: int,
                 max_sweeps: int, live, counters, changed) -> None:
    lib = _lib()
    v, b = dist_in.shape
    with torch.cuda.device(dist_in.device):
        # 3 flag words and a pad, then the [V, NW] stamps (csrc/ksp.cu)
        flags = torch.empty(4 + v * ban_words(b), dtype=torch.int32,
                            device=dist_in.device)
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.openr_ksp_sssp(
            dist_in.data_ptr(), dist_out.data_ptr(), nbr.data_ptr(),
            wgt.data_ptr(), blocked.data_ptr(), bans.data_ptr(), _ptr(live),
            _ptr(counters), _ptr(changed), flags.data_ptr(), int(root), v,
            nbr.shape[1], b, int(max_sweeps), stream,
        )
    _raise(lib, err, "ksp_sssp_kernel")
    LAUNCHES["sssp"] += 1


def ksp_sssp(dist0, nbr, wgt, blocked, bans, root: int, b: int, *,
             max_sweeps: int, live=None, counters=None):
    """The masked batched SSSP of `b` jobs to fixpoint (see
    `ksp_sssp_ref`), from `dist0` [V, b] (left as it is) or, if None,
    from `root`; returns the distances [V, b]. `live` (int32 [1]), if
    given, is the round's word: clear, nothing runs. `counters` (int32
    [2], rounds and sweeps) gains the sweeps run: a CPU tensor runs
    `ksp_sssp_ref` (Jacobi sweeps); a CUDA tensor makes one cooperative
    launch of `ksp_sssp_kernel`, which updates one buffer in place and
    counts its grid passes (at most the Jacobi sweeps; `max_sweeps` caps
    them). Neighbor ids must lie in [0, V)."""
    i32 = torch.int32
    _check("ksp_sssp", nbr.get_device(), (
        ("dist0", dist0, i32), ("nbr", nbr, i32), ("wgt", wgt, i32),
        ("blocked", blocked, torch.bool), ("bans", bans, i32),
        ("live", live, i32), ("counters", counters, i32),
    ))
    v = nbr.shape[0]
    if dist0 is not None and dist0.shape != (v, b):
        raise ValueError(f"ksp_sssp: dist0 must be [{v}, {b}]")
    if not 0 <= int(root) < v or max_sweeps < 1:
        raise ValueError("ksp_sssp: root must lie in [0, V), max_sweeps >= 1")
    _check_tables("ksp_sssp", nbr, wgt, blocked, bans, b)
    _check_words("ksp_sssp", live, counters)
    sink = _telemetry.sink()
    alive = sink is not None and (live is None or bool(int(live[0])))
    if nbr.device.type == "cpu":
        out = ksp_sssp_ref(dist0, nbr, wgt, blocked, bans, root, b,
                           max_sweeps=max_sweeps, live=live,
                           counters=counters)
    elif nbr.device.type != "cuda":
        raise ValueError(f"ksp_sssp: no kernel for {nbr.device}")
    else:  # in place: the kernel writes the start from `root`
        out = (dist0.clone() if dist0 is not None
               else torch.empty((v, b), dtype=i32, device=nbr.device))
        _sssp_launch(out, out, nbr, wgt, blocked, bans,
                     -1 if dist0 is not None else int(root), max_sweeps,
                     live, counters, None)
    if sink is not None:
        # a round whose word is clear returns at once: no work
        sink.add("ksp", *(sssp_work(nbr, wgt, blocked, out) if alive
                          else (0, 0)))
    return out


def ksp_relax(dist_in, dist_out, nbr, wgt, blocked, bans, changed):
    """One Jacobi sweep of the masked relax over all rows (see
    `ksp_relax_ref`). A CUDA tensor launches `ksp_sssp_kernel` for one
    pass from one buffer into the other; a CPU tensor runs
    `ksp_relax_ref`. Returns `changed` (int32 [1]), set to 1 if some entry
    fell, else 0. `dist_out` must not alias `dist_in`. Neighbor ids must
    lie in [0, V)."""
    i32 = torch.int32
    _check("ksp_relax", dist_in.get_device(), (
        ("dist_in", dist_in, i32), ("dist_out", dist_out, i32),
        ("nbr", nbr, i32), ("wgt", wgt, i32), ("blocked", blocked, torch.bool),
        ("bans", bans, i32), ("changed", changed, i32),
    ))
    v, b = dist_in.shape
    if dist_out.shape != dist_in.shape or nbr.shape[0] != v:
        raise ValueError("ksp_relax: dist_in/dist_out must be [V, B] of the table's V")
    if dist_out.data_ptr() == dist_in.data_ptr():
        raise ValueError("ksp_relax: dist_out must not alias dist_in")
    _check_tables("ksp_relax", nbr, wgt, blocked, bans, b)
    sink = _telemetry.sink()
    if sink is not None:
        sink.add("ksp", *relax_work(wgt, b))
    if dist_in.device.type == "cpu":
        return ksp_relax_ref(dist_in, dist_out, nbr, wgt, blocked, bans, changed)
    if dist_in.device.type != "cuda":
        raise ValueError(f"ksp_relax: no kernel for {dist_in.device}")
    _sssp_launch(dist_in, dist_out, nbr, wgt, blocked, bans, -1, 1, None,
                 None, changed)
    return changed


# ------------------------------------------------------------- the walk


def ksp_walk_ref(dist, nbr, wgt, blocked, bans, dests, root: int,
                 max_hops: int, cost, path, hops, any_ok, *, live=None,
                 counters=None):
    """Plain PyTorch version of `ksp_walk_kernel`: the reference's
    lock-step walk of every job over this round's `dist` [V, B], writing
    cost [B], path [B, max_hops+1] (walk order, -1 padded), hops [B], the
    updated ban words, and `any_ok` [1] = 1 if some job found its path.
    When `live` [1] is clear it only clears `any_ok`; otherwise it adds 1
    to `counters[0]` (rounds)."""
    if live is not None and not int(live[0]):
        any_ok.fill_(0)
        return any_ok
    if counters is not None:
        counters[0] += 1
    v = nbr.shape[0]
    b = dests.shape[0]
    dev = dist.device
    banned = unpack_bans(bans, b)  # [V, D, B]
    j = torch.arange(b, device=dev)
    nbr_l = nbr.long()
    dests_l = dests.long()
    c0 = dist[dests_l, j]
    start_ok = (c0 < INF_DIST) & (dests_l != root)
    cur = torch.where(start_ok, dests_l, root)
    walk = torch.full((b, max_hops + 1), -1, dtype=torch.int32, device=dev)
    walk[:, 0] = torch.where(start_ok, dests, -1)
    alive = start_ok.clone()
    failed = torch.zeros_like(start_ok)
    h = 0
    while h < max_hops and bool(alive.any()):
        rows_n = nbr_l[cur]  # [B, D]
        rows_w = wgt[cur]
        d_cur = dist[cur, j]
        d_pre = dist[rows_n, j[:, None]]
        row_block = blocked[cur] | banned[cur, :, j]
        valid = (
            ~row_block
            & (rows_w < INF_DIST)
            & (d_pre < INF_DIST)
            & (d_pre + rows_w == d_cur[:, None])
            & alive[:, None]
        )
        pred = torch.where(valid, rows_n, v).min(dim=1).values
        found = (pred < v) & alive
        failed |= alive & ~found
        pred = torch.where(found, pred, cur)
        # ban pred->cur (row cur, slots nbr == pred) and cur->pred (row
        # pred, slots nbr == cur): every parallel slot, both directions
        banned[cur, :, j] = banned[cur, :, j] | (
            (rows_n == pred[:, None]) & found[:, None]
        )
        banned[pred, :, j] = banned[pred, :, j] | (
            (nbr_l[pred] == cur[:, None]) & found[:, None]
        )
        walk[:, h + 1] = torch.where(found, pred, -1).to(torch.int32)
        cur = torch.where(found, pred, cur)
        alive = found & (pred != root)
        h += 1
    failed |= alive  # ran out of max_hops mid-walk
    ok = start_ok & ~failed
    cost.copy_(torch.where(ok, c0, INF_DIST))
    path.copy_(torch.where(ok[:, None], walk, -1))
    hops.copy_(torch.where(ok, (walk >= 0).sum(dim=1) - 1, 0))
    bans.copy_(pack_bans(banned))
    any_ok.fill_(int(bool(ok.any())))
    return any_ok


def ksp_walk(dist, nbr, wgt, blocked, bans, dests, root: int, max_hops: int,
             cost, path, hops, any_ok, *, live=None, counters=None):
    """Every job's walk of one round (see `ksp_walk_ref`), a warp per job.
    A CUDA tensor launches `ksp_walk_kernel`, which expects `path` filled
    with -1; a CPU tensor runs `ksp_walk_ref`. `live` and `counters` as
    in `ksp_sssp`; `any_ok` is the next round's word. Returns `any_ok`
    (int32 [1])."""
    i32 = torch.int32
    _check("ksp_walk", dist.get_device(), (
        ("dist", dist, i32), ("nbr", nbr, i32), ("wgt", wgt, i32),
        ("blocked", blocked, torch.bool), ("bans", bans, i32),
        ("dests", dests, i32), ("cost", cost, i32), ("path", path, i32),
        ("hops", hops, i32), ("any_ok", any_ok, i32), ("live", live, i32),
        ("counters", counters, i32),
    ))
    v, b = dist.shape
    if nbr.shape[0] != v or dests.shape != (b,) or cost.shape != (b,) or (
        hops.shape != (b,) or path.shape != (b, max_hops + 1)
    ):
        raise ValueError("ksp_walk: shapes disagree with dist [V, B]")
    _check_tables("ksp_walk", nbr, wgt, blocked, bans, b)
    _check_words("ksp_walk", live, counters)
    sink = _telemetry.sink()
    alive = sink is not None and (live is None or bool(int(live[0])))
    _walk(dist, nbr, wgt, blocked, bans, dests, root, max_hops, cost, path,
          hops, any_ok, live, counters)
    if sink is not None:
        sink.add("ksp", *(walk_work(nbr.shape[1], hops) if alive
                          else (0, 0)))
    return any_ok


def _walk(dist, nbr, wgt, blocked, bans, dests, root, max_hops, cost, path,
          hops, any_ok, live, counters):
    v, b = dist.shape
    if dist.device.type == "cpu":
        return ksp_walk_ref(dist, nbr, wgt, blocked, bans, dests, root,
                            max_hops, cost, path, hops, any_ok, live=live,
                            counters=counters)
    if dist.device.type != "cuda":
        raise ValueError(f"ksp_walk: no kernel for {dist.device}")
    lib = _lib()
    with torch.cuda.device(dist.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.openr_ksp_walk(
            dist.data_ptr(), nbr.data_ptr(), wgt.data_ptr(),
            blocked.data_ptr(), bans.data_ptr(), dests.data_ptr(), int(root),
            cost.data_ptr(), path.data_ptr(), hops.data_ptr(),
            any_ok.data_ptr(), _ptr(live), _ptr(counters), v, nbr.shape[1],
            b, int(max_hops), stream,
        )
    _raise(lib, err, "ksp_walk_kernel")
    LAUNCHES["walk"] += 1
    return any_ok


# ------------------------------------------------------------ the rounds


def _as_tensor(x, dtype, device):
    if not isinstance(x, torch.Tensor):
        x = torch.from_numpy(np.ascontiguousarray(x))
    return x.to(device=device, dtype=dtype).contiguous()


def ksp_edge_disjoint_dense(
    nbr, wgt, blocked, root, dests, *, k: int, max_hops: int, dist0=None,
    device=None, stats: dict | None = None, to_host: bool = False,
):
    """Returns (costs [k, B] i32, paths [k, B, max_hops+1] i32, hops
    [k, B] i32) on the tables' device: `paths[i, b]` is job b's i-th
    edge-disjoint shortest path in walk order (dest first, root last), -1
    padded; `costs[i, b]` is INF_DIST when no i-th path exists.

    `nbr`, `wgt` [V, D] int32 and `blocked` [V, D] bool
    (`build_ksp_blocked`) may be tensors or arrays; `dests` [B] holds
    each job's destination (dest == root: no path). `dist0` [V], if
    given, is the unbanned distance vector from `root` under the same
    blocked semantics: round 1 has no bans, so it replaces that round's
    SSSP. The call runs on `device`: by default `nbr`'s if it is a
    tensor, else the CUDA card.

    All k rounds are enqueued with no read back between them. With
    `to_host`, the three results come back as NumPy arrays from one copy
    of the buffer that holds them and the device counters; with `stats`,
    adds `rounds` (walks run), `sweeps` (SSSP sweeps run; on the card
    the kernel's grid passes) and
    `host_reads` (1: that copy, or a copy of the counters alone)."""
    if device is None:
        device = nbr.device if isinstance(nbr, torch.Tensor) else "cuda"
    device = torch.device(device)
    nbr = _as_tensor(nbr, torch.int32, device)
    wgt = _as_tensor(wgt, torch.int32, device)
    blocked = _as_tensor(blocked, torch.bool, device)
    dests = _as_tensor(dests, torch.int32, device).reshape(-1)
    root = int(root)
    v, d_width = nbr.shape
    b = dests.shape[0]
    n_len = max_hops + 1
    # one buffer: paths | costs | hops | counters [rounds, sweeps] | the
    # round words (word 0 set, word i+1 set by round i's walk)
    n_paths, n_kb = k * b * n_len, k * b

    def split(buf):  # (costs, paths, hops, counters) of a tensor or array
        return (buf[n_paths : n_paths + n_kb].reshape(k, b),
                buf[:n_paths].reshape(k, b, n_len),
                buf[n_paths + n_kb : n_paths + 2 * n_kb].reshape(k, b),
                buf[n_paths + 2 * n_kb : n_paths + 2 * n_kb + 2])

    out = torch.full((n_paths + 2 * n_kb + 2 + k + 1,), -1, dtype=torch.int32,
                     device=device)
    out[n_paths : n_paths + n_kb].fill_(INF_DIST)
    out[n_paths + n_kb :].zero_()
    out[-(k + 1)].fill_(1)
    costs, paths, hops, counters = split(out)
    live = out[-(k + 1):]
    bans = torch.zeros((v, d_width, ban_words(b)), dtype=torch.int32, device=device)
    if dist0 is not None:
        dist0 = _as_tensor(dist0, torch.int32, device).reshape(v)
    key = (v, d_width, b, k, max_hops, dist0 is None)
    with _telemetry.observe("_ksp_edge_disjoint_dense_jit", key,
                            span="spf:ksp",
                            span_complete=to_host or stats is not None
                            ) as cap:
        for i in range(k):
            if i == 0 and dist0 is not None:
                dist = dist0[:, None].expand(v, b).contiguous()
            else:
                dist = ksp_sssp(None, nbr, wgt, blocked, bans, root, b,
                                max_sweeps=v, live=live[i : i + 1],
                                counters=counters)
            ksp_walk(dist, nbr, wgt, blocked, bans, dests, root, max_hops,
                     costs[i], paths[i], hops[i], live[i + 1 : i + 2],
                     live=live[i : i + 1], counters=counters)
        if to_host:
            host = out.cpu().numpy()
            compile_ledger.record_transfer(host.nbytes)
            *res, count = split(host)
        else:
            res = [costs, paths, hops]
            count = None
            if stats is not None:
                count = counters.cpu().numpy()
                compile_ledger.record_transfer(count.nbytes)
        if cap:
            cap.io(args=(nbr, wgt, blocked, dests, dist0), outs=(out,),
                   temps=(bans,))
    if stats is not None:
        for key, val in (("rounds", int(count[0])), ("sweeps", int(count[1])),
                         ("host_reads", 1)):
            stats[key] = stats.get(key, 0) + val
    return tuple(res)


def paths_to_host(
    costs: np.ndarray,  # [k, B]
    paths: np.ndarray,  # [k, B, L] walk order (dest..root), -1 padded
    node_names: list[str],
    job: int,
) -> list[tuple[int, list[str]]]:
    """Device output -> the oracle's [(cost, [root..dest names]), ...]
    sorted by (cost, path)."""
    out: list[tuple[int, list[str]]] = []
    for i in range(costs.shape[0]):
        c = int(costs[i, job])
        if c >= int(INF_DIST):
            continue
        row = paths[i, job]
        ids = row[row >= 0][::-1].tolist()  # walk order is dest -> root
        out.append((c, [node_names[n] for n in ids]))
    out.sort(key=lambda cp: (cp[0], cp[1]))
    return out

"""The split solve's loop on the device: the control block and the
kernels of `csrc/split_loop.cu` that carry the loop around kernel A.

The JAX package runs `batched_sssp_split`'s three `while_loop`s
(`openr_tpu/ops/spf_split.py:393,450,464`) inside one jitted dispatch.
The port keeps the loop's state in one int32 control block `ctl` on the
device, and every launch of a step reads the phase at entry and does
nothing unless the phase is its own (`phase_mask`), so one fixed
sequence of launches serves every phase and can be captured in a CUDA
graph (`ops/spf_split.py` `SplitProgram`). The host reads `ctl` once per
block of steps. The sharded solves (`parallel/sharded_spf.py`) keep a
control block per graph row and device in the same layout, in phase
`NET` until `row_exit` ends it.

Each wrapper picks by `tensor.device.type`: a CUDA tensor launches its
kernel (a build or launch failure raises), a CPU tensor runs the plain
PyTorch twin `*_ref`, which honours the same guard. Each counts the
kernels it launches in `LAUNCHES`, and those it records into a CUDA
graph capture (which launches nothing) in `CAPTURED`; while a
telemetry capture runs, it adds its
work (`*_work`, the counts `chip_smoke.py`'s bounds use) to the sink;
a guarded call that does nothing counts no work.
"""

from __future__ import annotations

import ctypes
import threading

import torch

from openr_tpu_torch.monitor import device as _telemetry

# ---- the control block: int32 [CTL_WORDS] ------------------------------
PHASE = 0        # DENSE, TAIL, NET or DONE
IT = 1           # iterations of the current phase
SWEEPS = 2       # dense sweeps so far (phase 1 and the net)
TAIL_ROUNDS = 3  # tail rounds so far
STEPS = 4        # steps that did work
ROWS_CHANGED = 5  # rows the step's relaxes lowered (kernel A's count)
N_ROWS = 6       # listed rows of this tail round (at most the cap)
N_FRONT = 7      # listed frontier rows (at most the cap)
RAW_FRONT = 8    # frontier rows before the cap
SPILL = 9        # a list would have exceeded the cap
THRESHOLD = 10   # phase 1 runs while more rows than this changed
ROUNDS_CAP = 11  # tail rounds at most
IT_CAP = 12      # dense sweeps of one phase at most (vp)
RAW_ROWS = 13    # tail round rows before the cap
FELL = 14        # the sharded exit: some block saw an entry fall
TICKET = 15      # the sharded exit: its blocks done
CTL_WORDS = 16

DONE, DENSE, TAIL, NET = 0, 1, 2, 3
#: phase masks: the dense sweeps (phase 1 and the net), the tail, both
M_DENSE = (1 << DENSE) | (1 << NET)
M_TAIL = 1 << TAIL
M_ALL = M_DENSE | M_TAIL

#: the kernel functions, as a profiler names them
KERNEL_NAMES = {
    "snap_mark": "split_snap_mark_kernel",
    "compact": "flag_compact_kernel",
    "ctl": "split_ctl_kernel",
    "exit": "row_exit_kernel",
}

#: the C entry points of `csrc/split_loop.cu` and their ctypes types
ENTRY_POINTS = {
    "openr_split_snap_mark": ([
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong,  # dist, snap, n
        ctypes.c_void_p, ctypes.c_int,  # row_flag, vp
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,  # frontier, out, wout
        ctypes.c_void_p, ctypes.c_int, ctypes.c_int,  # mark, dead, with_f
        ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p,  # ctl, mask, stream
    ], ctypes.c_int),
    "openr_flag_compact": ([
        ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p, ctypes.c_int,
        ctypes.c_int, ctypes.c_void_p, ctypes.c_int,  # dead, ctl, mask
        ctypes.c_int, ctypes.c_int, ctypes.c_int,  # slots, clear
        ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,  # decide, ws, stream
    ], ctypes.c_int),
    "openr_split_ctl": ([
        ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p,
    ], ctypes.c_int),
    "openr_row_exit": ([
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong,  # cur, prev, n
        ctypes.c_int, ctypes.c_void_p, ctypes.c_int,  # copy, ctl, mask
        ctypes.c_void_p,  # stream
    ], ctypes.c_int),
    "openr_split_error_string": ([ctypes.c_int], ctypes.c_char_p),
}

#: flags a block of `flag_compact_kernel` scans (`kTile` in the source)
COMPACT_TILE = 4096

#: kernel launches made by the wrappers (CUDA path only), by kernel; a
#: call recorded into a CUDA graph capture is not one
LAUNCHES = {k: 0 for k in KERNEL_NAMES}
#: kernels the wrappers recorded into CUDA graph captures
CAPTURED = 0
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

            lib = cuda_build.load("split_loop")
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


def new_ctl(phase: int, threshold: int, rounds_cap: int, it_cap: int,
            device) -> torch.Tensor:
    """A control block at the start of `phase` with the loop's limits."""
    ctl = torch.zeros(CTL_WORDS, dtype=torch.int32)
    ctl[PHASE], ctl[THRESHOLD] = phase, threshold
    ctl[ROUNDS_CAP], ctl[IT_CAP] = rounds_cap, it_cap
    return ctl.to(device)


def compact_ws(n: int, device) -> torch.Tensor:
    """The compaction's workspace for up to `n` flags: the
    tile ticket, the count of blocks done and a status word a tile, int64
    zeros. Every launch leaves it zero, so one workspace serves every
    compaction on a stream, captured or not."""
    return torch.zeros(_ws_words(n), dtype=torch.int64, device=device)


def _ws_words(n: int) -> int:
    return 2 + -(-max(n, 1) // COMPACT_TILE)


def runs(ctl, phase_mask: int) -> bool:
    """Whether a launch guarded by `phase_mask` does work in the loop's
    current phase. Reads `ctl` (a device sync on CUDA)."""
    return bool((phase_mask >> int(ctl[PHASE])) & 1)


# ------------------------------------------------------------- the twins


def snap_ref(dist, snap, row_flag, ctl, phase_mask) -> None:
    """The step's snapshot: `snap` = `dist`, the row flags and the
    changed-row count cleared."""
    if not runs(ctl, phase_mask):
        return
    snap.copy_(dist)
    row_flag.zero_()
    ctl[ROWS_CHANGED] = 0


def frontier_mark_ref(frontier, out_nbr, mark, ctl, phase_mask,
                      with_frontier: bool, dead: int) -> None:
    """Marks the out-neighbors of the first `ctl[N_FRONT]` frontier rows
    (and, `with_frontier`, those rows) in `mark` [vp], the dead slot
    never."""
    if not runs(ctl, phase_mask):
        return
    f = frontier[: int(ctl[N_FRONT])].long()
    v = out_nbr[f].reshape(-1).long()
    mark[v[v != dead]] = 1
    if with_frontier:
        mark[f[f != dead]] = 1


def snap_mark_ref(dist, snap, row_flag, frontier, out_nbr, mark, ctl,
                  phase_mask, with_frontier: bool, dead: int) -> None:
    """The step's first launch (`split_snap_mark_kernel`): `snap_ref`
    under `phase_mask`, then `frontier_mark_ref` where the phase is the
    tail."""
    snap_ref(dist, snap, row_flag, ctl, phase_mask)
    frontier_mark_ref(frontier, out_nbr, mark, ctl, phase_mask & M_TAIL,
                      with_frontier, dead)


def flag_compact_ref(flags, out, ctl, phase_mask, count_slot: int,
                     raw_slot: int, dead: int, clear: bool,
                     decide: bool = False) -> None:
    """The ids where `flags` [n] is non-zero, in order, into `out` [cap]
    (dead-padded past the first cap); their count capped at cap into
    `ctl[count_slot]`, uncapped into `ctl[raw_slot]`, and `ctl[SPILL]`
    set when it exceeds cap. `clear` zeroes the flags it read. `decide`
    then makes the tail's decision (`tail_decide_ref`)."""
    if not runs(ctl, phase_mask):
        return
    cap = out.shape[0]
    ids = torch.nonzero(flags).reshape(-1)
    raw = ids.shape[0]
    kept = min(raw, cap)
    out[:kept] = ids[:kept].to(torch.int32)
    out[kept:] = dead
    ctl[count_slot], ctl[raw_slot] = kept, raw
    if raw > cap:
        ctl[SPILL] = 1
    if clear:
        flags[ids] = 0
    if decide:
        tail_decide_ref(ctl)


def tail_decide_ref(ctl) -> None:
    """The tail's decision after a frontier's compaction (`csrc/
    split_loop.cu` tail_decide): the reference's cond2 and the net's
    entry, to the net on a spill, done on an empty frontier, to the net
    at `ROUNDS_CAP` rounds."""
    c = ctl.tolist()
    if c[SPILL]:
        c[PHASE], c[IT] = NET, 0
    elif c[RAW_FRONT] == 0:
        c[PHASE] = DONE
    elif c[IT] >= c[ROUNDS_CAP]:
        c[PHASE], c[IT] = NET, 0
    ctl.copy_(torch.tensor(c, dtype=torch.int32))


def row_exit_ref(cur, prev, ctl, phase_mask, copy: bool) -> None:
    """A sharded graph row's exit after a sweep or round (`csrc/
    split_loop.cu` row_exit_kernel): did an entry of `cur` fall below
    `prev`; with `copy`, `prev` = `cur`; the sweep counted (IT, SWEEPS,
    STEPS) and the row done when nothing fell or at `IT_CAP` sweeps."""
    if not runs(ctl, phase_mask):
        return
    fell = bool((cur < prev).any())
    if copy:
        prev.copy_(cur)
    c = ctl.tolist()
    c[IT] += 1
    c[SWEEPS] += 1
    c[STEPS] += 1
    if not fell or c[IT] >= c[IT_CAP]:
        c[PHASE] = DONE
    ctl.copy_(torch.tensor(c, dtype=torch.int32))


def split_ctl_ref(ctl, phase_mask) -> None:
    """The loop's decisions after a step's relaxes (`csrc/split_loop.cu`
    split_ctl_kernel): the step counted, phase 1 ended (cond1) or the
    net ended (cond3)."""
    if not runs(ctl, phase_mask):
        return
    c = ctl.tolist()
    phase = c[PHASE]
    c[STEPS] += 1
    c[IT] += 1
    if phase == TAIL:
        c[TAIL_ROUNDS] += 1
    else:
        c[SWEEPS] += 1
        if phase == DENSE:
            if not (c[ROWS_CHANGED] > c[THRESHOLD] and c[IT] < c[IT_CAP]):
                c[PHASE], c[IT] = TAIL, 0
        elif c[ROWS_CHANGED] == 0 or c[IT] >= c[IT_CAP]:
            c[PHASE] = DONE
    ctl.copy_(torch.tensor(c, dtype=torch.int32))


# ------------------------------------------------------------- the work


def snap_work(n: int, vp: int) -> tuple[int, int]:
    """(least DRAM bytes, integer operations) of one step's snapshot: the n
    distances written, the vp row flags and the count written. The n
    distances it reads need not come from DRAM: the step's own kernels
    wrote them just before, and at the 100k benchmark's 13.6 MB they sit
    in the 50 MB L2."""
    return n * 4 + vp * 4 + 4, 0


def mark_work(n_front: int, wout: int, live_slots: int,
              with_frontier: bool) -> tuple[int, int]:
    """One tail step's mark: the frontier's ids and out-neighbor rows
    read, a flag written per live slot (and per frontier row); a compare
    a slot. `split_snap_mark_kernel` adds it to `snap_work` in a tail
    step."""
    writes = live_slots + (n_front if with_frontier else 0)
    return n_front * 4 + n_front * wout * 4 + writes * 4, n_front * wout


def compact_work(n: int, cap: int, raw: int, clear: bool
                 ) -> tuple[int, int]:
    """One compaction: n flags read, the cap-long list written, the raw
    flags cleared where `clear`; a compare a flag."""
    return n * 4 + cap * 4 + (raw * 4 if clear else 0) + 12, n


def ctl_work() -> tuple[int, int]:
    """One decision: a few words of the block read and written."""
    return 2 * CTL_WORDS * 4, 8


def exit_work(n: int, copy: bool) -> tuple[int, int]:
    """One exit of n entries: both buffers read, `prev` written where
    `copy`, and the decision's words; a compare an entry."""
    return n * 4 * (3 if copy else 2) + 2 * CTL_WORDS * 4, n


# ------------------------------------------------------------ launching


def _check(nm: str, dev, **tensors) -> None:
    for k, x in tensors.items():
        if x.device != dev:
            raise ValueError(f"{nm}: {k} on {x.device}, ctl on {dev}")
        if x.dtype != torch.int32:
            raise TypeError(f"{nm}: {k} is {x.dtype}, needs torch.int32")
        if not x.is_contiguous():
            raise ValueError(f"{nm}: {k} is not contiguous")


def _launch(kernel: str, entry: str, dev, *args) -> None:
    global CAPTURED
    lib = _lib()
    with torch.cuda.device(dev):
        err = getattr(lib, entry)(*args,
                                  torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(
            f"{KERNEL_NAMES[kernel]} launch failed: "
            f"{lib.openr_split_error_string(err).decode()} ({err})")
    if torch.cuda.is_current_stream_capturing():
        CAPTURED += 1
    else:
        LAUNCHES[kernel] += 1


def _count(ctl, phase_mask, work) -> None:
    """Adds the call's work to the running capture, if the call does
    work in the loop's phase."""
    sink = _telemetry.sink()
    if sink is not None and runs(ctl, phase_mask):
        nbytes, ops = work()
        sink.add("split_loop", nbytes, ops)


def snap_mark(dist, snap_out, row_flag, frontier, out_nbr, mark, ctl,
              phase_mask: int, with_frontier: bool, dead: int) -> None:
    """`split_snap_mark_kernel`: see `snap_mark_ref`. `out_nbr` is
    [vp, wout] with wout a power of two, at least 4 on CUDA."""
    _check("snap_mark", ctl.device, dist=dist, snap=snap_out,
           row_flag=row_flag, frontier=frontier, out_nbr=out_nbr, mark=mark,
           ctl=ctl)
    if snap_out.shape != dist.shape:
        raise ValueError("snap_mark: dist and snap must be one shape")
    if mark.data_ptr() == row_flag.data_ptr():
        raise ValueError("snap_mark: mark and row_flag are one buffer")
    wout = out_nbr.shape[1]

    def work():
        nbytes, ops = snap_work(dist.numel(), row_flag.numel())
        if int(ctl[PHASE]) == TAIL:
            f = frontier[: int(ctl[N_FRONT])].long()
            live = int((out_nbr[f] != dead).sum())
            mb, mo = mark_work(f.shape[0], wout, live, with_frontier)
            nbytes, ops = nbytes + mb, ops + mo
        return nbytes, ops

    _count(ctl, phase_mask, work)
    if ctl.device.type == "cpu":
        return snap_mark_ref(dist, snap_out, row_flag, frontier, out_nbr,
                             mark, ctl, phase_mask, with_frontier, dead)
    for x in (dist, snap_out, out_nbr):
        if x.data_ptr() % 16:
            raise ValueError("snap_mark: dist, snap and out_nbr must be "
                             "16-byte aligned")
    if wout < 4 or wout & (wout - 1):
        raise ValueError(f"snap_mark: out_nbr width {wout} is not a power "
                         "of two of at least 4")
    _launch("snap_mark", "openr_split_snap_mark", ctl.device,
            dist.data_ptr(), snap_out.data_ptr(), dist.numel(),
            row_flag.data_ptr(), row_flag.numel(), frontier.data_ptr(),
            out_nbr.data_ptr(), wout, mark.data_ptr(), int(dead),
            int(bool(with_frontier)), ctl.data_ptr(), int(phase_mask))


def flag_compact(flags, out, ctl, phase_mask: int, count_slot: int,
                 raw_slot: int, dead: int, clear: bool, decide: bool = False,
                 ws=None) -> None:
    """`flag_compact_kernel`: see `flag_compact_ref`. On CUDA `ws` is the
    workspace (`compact_ws`, on ctl's device); the twin takes none."""
    _check("flag_compact", ctl.device, flags=flags, out=out, ctl=ctl)
    n, cap = flags.shape[0], out.shape[0]

    def work():
        return compact_work(n, cap, int((flags != 0).sum()), clear)

    _count(ctl, phase_mask, work)
    if ctl.device.type == "cpu":
        return flag_compact_ref(flags, out, ctl, phase_mask, count_slot,
                                raw_slot, dead, clear, decide)
    if (ws is None or ws.device != ctl.device or ws.dtype != torch.int64
            or not ws.is_contiguous()
            or ws.numel() < _ws_words(n)):
        raise ValueError("flag_compact: needs a workspace from compact_ws("
                         f"{n}) on {ctl.device}")
    _launch("compact", "openr_flag_compact", ctl.device, flags.data_ptr(),
            n, out.data_ptr(), cap, int(dead), ctl.data_ptr(),
            int(phase_mask), int(count_slot), int(raw_slot),
            int(bool(clear)), int(bool(decide)), ws.data_ptr())


def row_exit(cur, prev, ctl, phase_mask: int, copy: bool) -> None:
    """`row_exit_kernel`: see `row_exit_ref`. `cur` and `prev` are int32
    buffers of one shape, 16-byte aligned on CUDA."""
    _check("row_exit", ctl.device, cur=cur, prev=prev, ctl=ctl)
    if cur.shape != prev.shape:
        raise ValueError("row_exit: cur and prev must be one shape")
    if cur.data_ptr() == prev.data_ptr():
        raise ValueError("row_exit: cur and prev are one buffer")
    _count(ctl, phase_mask, lambda: exit_work(cur.numel(), copy))
    if ctl.device.type == "cpu":
        return row_exit_ref(cur, prev, ctl, phase_mask, copy)
    if cur.data_ptr() % 16 or prev.data_ptr() % 16:
        raise ValueError("row_exit: cur and prev must be 16-byte aligned")
    _launch("exit", "openr_row_exit", ctl.device, cur.data_ptr(),
            prev.data_ptr(), cur.numel(), int(bool(copy)), ctl.data_ptr(),
            int(phase_mask))


def split_ctl(ctl, phase_mask: int) -> None:
    """`split_ctl_kernel`: see `split_ctl_ref`."""
    _check("split_ctl", ctl.device, ctl=ctl)
    _count(ctl, phase_mask, ctl_work)
    if ctl.device.type == "cpu":
        return split_ctl_ref(ctl, phase_mask)
    _launch("ctl", "openr_split_ctl", ctl.device, ctl.data_ptr(),
            int(phase_mask))


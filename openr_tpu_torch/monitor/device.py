"""Device telemetry of the port: kernel cost rows, HBM gauges and the
efficiency join (the counterpart of `openr_tpu/monitor/device.py`).

**Kernel cost rows.** The JAX package reads XLA's static analysis of
each jitted entry point's executable. The port's kernels are hand
written, so a row counts their work instead: `bytes_accessed` and `flops`
(integer operations; the port does no floating point) are the least
DRAM bytes and operations of the hand-kernel launches the call made,
summed. Each kernel's count lives beside its wrapper (`ops/relax.py`
`launch_work`, `ops/election.py` `elect_work`, `ops/ksp.py`
`sssp_work` / `walk_work`, `ops/edge_relax.py` `init_work` /
`fix_work`, `ops/split_loop.py` `snap_work` / `mark_work` /
`compact_work` / `ctl_work`, `ops/rib_epilogue.py` `epilogue_work`) and
is the count `chip_smoke.py`'s kernels line turns into its `bound_ms`,
so the two cannot drift. A launch of the split loop that its guard
turns into a no-op counts no work, and a launch recorded into a CUDA
graph counts none either (`paused`): the captured call is the first,
eager run of a shape. A wrapper counts the same work
whether it launches its kernel or runs its plain twin on the CPU, so a
CPU row equals the CUDA row of the same call.

A call site wraps the call in `observe(fn, key, span=...)`. Steady state
is one dict probe: a row is captured only the first time `fn` meets a
new shape key (V, W, B, design, ...), the counterpart of a fresh jit
compile. During a capture the wrappers add each launch's work to a
thread-local sink; some counts read the data (the distinct rows a relax
gathers, the entries a fixpoint reached), so a capture reads the device
and syncs, once per shape. Rows are keyed by the JAX package's function
names: `batched_sssp_split_rib`, `batched_sssp_split_warm_rib`,
`batched_sssp_split`, `batched_sssp_dense`, `_relax_once` (one sweep),
`batched_sssp`, `first_hop_matrix` (the dense and edge tables' RIB:
`rib_epilogue_kernel`'s one launch, counted by `epilogue_work`),
`_elect_seg`, `_ksp_edge_disjoint_dense_jit`. `span_complete`
says whether the row's span covers a host read of the result.

**HBM gauges.** `sample_hbm(counters)` writes the JAX package's names
`device.<i>.hbm_bytes_in_use`, `hbm_peak_bytes` and `hbm_limit_bytes`:
the caching allocator's allocated bytes, their peak, and the card's
memory. It reads the allocator's counters once a device
(`memory_stats_as_nested_dict`, the C call `memory_allocated` goes
through before flattening it) and the card's memory once. Without CUDA
the first sample latches off and every later one is a flag test. It
runs on every `annotate` span exit with counters and at a Decision's
rebuild edge (`decision/hook.py`). `enabled = False` stops both the
captures and the sampling (the overhead control).

`efficiency_rows(rows, snapshot)` is the JAX package's pure join: each
row with a completed span's `profile.<span>_ms` p50 gets its achieved
rate. `shard_rows(arr)` is the per-position layout of a sharded solve's
result, from its layout alone (never a read of a piece).
"""

from __future__ import annotations

import threading
from dataclasses import dataclass

import torch

#: the card's peak rates the least times are counted against (NVIDIA
#: H100 SXM data sheet): HBM3 bytes per second, and 32-bit integer
#: operations per second (the non-tensor-core 32-bit rate)
HBM_BYTES_PER_S = 3.35e12
INT32_OPS_PER_S = 67e12


def bound(nbytes: float, ops: float) -> tuple[float, str]:
    """(least ms on the card for `nbytes` DRAM bytes and `ops` integer
    operations, "bytes" or "operations": whichever takes longer)."""
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / INT32_OPS_PER_S
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops
                                       else "operations")


@dataclass
class KernelCostRow:
    """One entry point's counted work at its last captured shape."""

    fn: str
    #: the span whose `profile.<span>_ms` p50 the efficiency join reads
    span: str | None = None
    #: whether that span covers a host read of the result (the work's
    #: completion) or ends at an enqueue; the join skips the latter
    span_complete: bool = True
    #: integer operations (the JAX row's field name)
    flops: float = 0.0
    bytes_accessed: float = 0.0
    transcendentals: float = 0.0
    arg_bytes: int = 0
    out_bytes: int = 0
    temp_bytes: int = 0
    #: bytes of the built libraries the call's kernels come from (0 on
    #: the CPU, which builds none)
    code_bytes: int = 0
    captures: int = 0
    shapes: str = ""
    error: str | None = None
    #: hand-kernel launches (or plain-twin calls) the captured call made
    launches: int = 0
    #: the kernel sources they come from
    sources: tuple = ()

    @property
    def resident_hbm_bytes(self) -> int:
        return (self.arg_bytes + self.out_bytes + self.temp_bytes
                + self.code_bytes)

    def to_jsonable(self) -> dict:
        return {
            "fn": self.fn,
            "span": self.span,
            "span_complete": self.span_complete,
            "flops": self.flops,
            "bytes_accessed": self.bytes_accessed,
            "transcendentals": self.transcendentals,
            "arg_bytes": self.arg_bytes,
            "out_bytes": self.out_bytes,
            "temp_bytes": self.temp_bytes,
            "code_bytes": self.code_bytes,
            "resident_hbm_bytes": self.resident_hbm_bytes,
            "captures": self.captures,
            "shapes": self.shapes,
            "error": self.error,
            "launches": self.launches,
            "sources": list(self.sources),
        }

    #: the numeric fields exported as `cuda.kernel.<fn>.<field>`
    EXPORT_FIELDS = (
        "flops", "bytes_accessed", "arg_bytes", "out_bytes", "temp_bytes",
        "code_bytes", "captures", "launches",
    )


def _nbytes(tensors) -> int:
    return sum(int(t.nbytes) for t in tensors if t is not None)


class Work:
    """The work a capture has counted so far: launches, bytes and
    operations summed, the first launch's alone, and the sources."""

    __slots__ = ("bytes", "ops", "launches", "first", "sources")

    def __init__(self) -> None:
        self.bytes = 0
        self.ops = 0
        self.launches = 0
        self.first: tuple[int, int] | None = None
        self.sources: dict[str, None] = {}

    def add(self, source: str | None, nbytes: int, ops: int,
            launches: int = 1) -> None:
        self.bytes += int(nbytes)
        self.ops += int(ops)
        self.launches += launches
        if launches and self.first is None:
            self.first = (int(nbytes), int(ops))
        if source is not None:
            self.sources[source] = None

    def merge(self, other: "Work") -> None:
        self.bytes += other.bytes
        self.ops += other.ops
        self.launches += other.launches
        if self.first is None:
            self.first = other.first
        self.sources.update(other.sources)


_TLS = threading.local()


def sink() -> Work | None:
    """The work of the capture running on this thread, or None: a
    wrapper adds its launch's count here when it is not None."""
    return getattr(_TLS, "sink", None)


class paused:
    """Within the block this thread has no sink: launches recorded into
    a CUDA graph launch nothing, so they count no work (and may not read
    the device)."""

    def __enter__(self):
        self._prev = sink()
        _TLS.sink = None
        return self

    def __exit__(self, *exc) -> bool:
        _TLS.sink = self._prev
        return False


class _NullCapture:
    """What `observe` returns in steady state: falsy, does nothing."""

    __slots__ = ()

    def __bool__(self) -> bool:
        return False

    def __enter__(self):
        return self

    def __exit__(self, exc_type, exc, tb) -> bool:
        return False

    def add(self, source, nbytes, ops, launches=1) -> None:
        pass

    def io(self, args=(), outs=(), temps=()) -> None:
        pass


_NULL = _NullCapture()


class _Capture:
    """One capture: the sink of this thread while the call runs, then
    the row."""

    def __init__(self, tel: "DeviceTelemetry", name: str, key, span,
                 span_complete: bool, first_launch_only: bool):
        self.tel, self.name, self.key = tel, name, key
        self.span, self.span_complete = span, span_complete
        self.first_launch_only = first_launch_only
        self.work = Work()
        self.arg_bytes = self.out_bytes = self.temp_bytes = 0
        self._prev = None

    def __bool__(self) -> bool:
        return True

    def __enter__(self):
        self._prev = sink()
        _TLS.sink = self.work
        return self

    def add(self, source, nbytes, ops, launches=1) -> None:
        """Work of the call that no wrapper counts (torch ops)."""
        self.work.add(source, nbytes, ops, launches)

    def io(self, args=(), outs=(), temps=()) -> None:
        """The call's inputs, outputs and scratch tensors, by bytes."""
        self.arg_bytes = _nbytes(args)
        self.out_bytes = _nbytes(outs)
        self.temp_bytes = _nbytes(temps)

    def __exit__(self, exc_type, exc, tb) -> bool:
        _TLS.sink = self._prev
        if self._prev is not None:
            self._prev.merge(self.work)
        if exc_type is None:
            self.tel._record(self)
        return False


def _code_bytes(sources) -> int:
    from openr_tpu_torch.ops import cuda_build

    return sum(cuda_build.library_bytes(s) for s in sources)


class DeviceTelemetry:
    """Process-wide kernel cost rows and the HBM latch. Thread-safe."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._rows: dict[str, KernelCostRow] = {}
        #: shape keys each fn was captured at (a key seen before is the
        #: counterpart of a jit cache hit: no recapture)
        self._seen: dict[str, set] = {}
        self.enabled = True
        #: None = unprobed, False = no CUDA (latched), True = gauges live
        self._hbm_state: bool | None = None
        self._limits: dict[int, int] = {}
        self._names: dict[int, str] = {}

    # ------------------------------------------------------------ capture

    def observe(self, name: str, key, span: str | None = None,
                span_complete: bool = True, first_launch_only: bool = False):
        """A context for one call of `name` at shape `key`: a capture
        the first time `name` meets `key`, else a falsy no-op.
        `first_launch_only` keeps the first launch's work alone (a row
        for one sweep of a loop of equal sweeps)."""
        if not self.enabled:
            return _NULL
        seen = self._seen.get(name)
        if seen is not None and key in seen:
            return _NULL
        return _Capture(self, name, key, span, span_complete,
                        first_launch_only)

    def _record(self, cap: _Capture) -> None:
        w = cap.work
        nbytes, ops = (w.first or (0, 0)) if cap.first_launch_only else (
            w.bytes, w.ops)
        sources = tuple(w.sources)
        row = KernelCostRow(
            fn=cap.name, span=cap.span, span_complete=cap.span_complete,
            flops=float(ops), bytes_accessed=float(nbytes),
            arg_bytes=cap.arg_bytes, out_bytes=cap.out_bytes,
            temp_bytes=cap.temp_bytes, code_bytes=_code_bytes(sources),
            shapes=str(cap.key),
            launches=min(w.launches, 1) if cap.first_launch_only
            else w.launches,
            sources=sources,
        )
        with self._lock:
            prev = self._rows.get(cap.name)
            row.captures = (prev.captures if prev else 0) + 1
            self._rows[cap.name] = row
            self._seen.setdefault(cap.name, set()).add(cap.key)

    # ------------------------------------------------------------ queries

    def kernel_rows(self) -> dict[str, KernelCostRow]:
        with self._lock:
            return dict(self._rows)

    def reset(self) -> None:
        """Drop every row, every seen key and the HBM latch (tests)."""
        with self._lock:
            self._rows.clear()
            self._seen.clear()
            self._hbm_state = None

    def export_to(self, counters) -> None:
        """Stamp every row into a counters registry as
        `cuda.kernel.<fn>.<field>` gauges."""
        for name, row in self.kernel_rows().items():
            for fld in KernelCostRow.EXPORT_FIELDS:
                counters.set(f"cuda.kernel.{name}.{fld}", getattr(row, fld))

    # ---------------------------------------------------------------- hbm

    def sample_hbm(self, counters=None) -> list[dict] | None:
        """Per-device rows of allocated bytes, their peak and the card's
        memory, or None without CUDA (the first such sample latches off)
        or before CUDA is initialised. With `counters`, also stamps the
        `device.<i>.hbm_*` gauges."""
        if not self.enabled or self._hbm_state is False:
            return None
        if self._hbm_state is None and not torch.cuda.is_available():
            self._hbm_state = False
            return None
        if not torch.cuda.is_initialized():
            return None  # not latched: CUDA may come up later
        self._hbm_state = True
        rows = []
        for i in range(torch.cuda.device_count()):
            stats = torch.cuda.memory_stats_as_nested_dict(i)
            alloc = stats.get("allocated_bytes", {}).get("all", {})
            in_use = int(alloc.get("current", 0))
            peak = int(alloc.get("peak", in_use))
            limit = self._limits.get(i)
            if limit is None:
                props = torch.cuda.get_device_properties(i)
                limit = self._limits[i] = int(props.total_memory)
                self._names[i] = props.name
            rows.append({
                "device": i, "kind": self._names[i], "platform": "cuda",
                "hbm_bytes_in_use": in_use, "hbm_peak_bytes": peak,
                "hbm_limit_bytes": limit,
            })
            if counters is not None:
                counters.set(f"device.{i}.hbm_bytes_in_use", in_use)
                counters.set(f"device.{i}.hbm_peak_bytes", peak)
                counters.set(f"device.{i}.hbm_limit_bytes", limit)
        return rows

    @property
    def hbm_available(self) -> bool | None:
        return self._hbm_state

    def hbm_in_use_mb(self) -> float | None:
        """Allocated bytes summed over the devices, in MB, or None
        without CUDA: the soak's HBM watermark sample."""
        rows = self.sample_hbm()
        if rows is None:
            return None
        return sum(r["hbm_bytes_in_use"] for r in rows) / 1e6


# ----------------------------------------------------------- pure joins


def efficiency_rows(rows: dict[str, KernelCostRow],
                    snapshot: dict[str, float]) -> list[dict]:
    """Each row joined with its span's measured p50 (`profile.<span>_ms`
    in `snapshot`) into achieved operations and bytes per second. A span
    that ends before the work completes reports its p50 and no rate.
    Pure: the JAX package's join, on the port's rows."""
    out: list[dict] = []
    for name in sorted(rows):
        row = rows[name]
        d = row.to_jsonable()
        p50 = count = None
        if row.span:
            p50 = snapshot.get(f"profile.{row.span}_ms.p50")
            count = snapshot.get(f"profile.{row.span}_ms.count")
        d["span_p50_ms"] = p50
        d["span_count"] = int(count) if count else 0
        if row.span_complete and p50 and p50 > 0:
            sec = p50 / 1e3
            d["achieved_gflops"] = round(row.flops / sec / 1e9, 3)
            d["achieved_gbs"] = round(row.bytes_accessed / sec / 1e9, 3)
        else:
            d["achieved_gflops"] = None
            d["achieved_gbs"] = None
        out.append(d)
    return out


def shard_rows(arr) -> list[dict]:
    """One row per mesh position of a `parallel.mesh.ShardedArray`, with
    the reference's keys: `device` (the position's index in sources-major
    order, which equals a JAX mesh's device id over the same grid of
    devices 0..n-1), `platform` (the position's device type), `index`
    ([start, stop] per dimension), `shard_shape` and `shard_bytes`. Read
    from the layout only: no piece is touched, so nothing syncs. [] for
    anything without a mesh layout."""
    indices = getattr(arr, "indices", None)
    mesh = getattr(arr, "mesh", None)
    if indices is None or mesh is None:
        return []
    itemsize = arr.dtype.itemsize
    rows = []
    for (s, g), idx in indices.items():
        shape = [b - a for a, b in idx]
        nbytes = itemsize
        for n in shape:
            nbytes *= n
        rows.append({
            "device": mesh.flat(s, g),
            "platform": mesh.device(s, g).type,
            "index": [[a, b] for a, b in idx],
            "shard_shape": shape,
            "shard_bytes": nbytes,
        })
    rows.sort(key=lambda r: r["device"])
    return rows


#: the process telemetry every consumer shares
_TELEMETRY = DeviceTelemetry()


def telemetry() -> DeviceTelemetry:
    return _TELEMETRY


def observe(name: str, key, span: str | None = None,
            span_complete: bool = True, first_launch_only: bool = False):
    return _TELEMETRY.observe(name, key, span=span,
                              span_complete=span_complete,
                              first_launch_only=first_launch_only)


def kernel_rows() -> dict[str, KernelCostRow]:
    return _TELEMETRY.kernel_rows()


def export_to(counters) -> None:
    _TELEMETRY.export_to(counters)


def sample_hbm(counters=None) -> list[dict] | None:
    return _TELEMETRY.sample_hbm(counters)


def hbm_in_use_mb() -> float | None:
    return _TELEMETRY.hbm_in_use_mb()


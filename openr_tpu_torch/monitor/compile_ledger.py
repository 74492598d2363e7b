"""The port's build and transfer ledger: the counterpart of the JAX
package's compile ledger (`openr_tpu/monitor/compile_ledger.py`).

Where JAX compiles a jitted function per new shape, the port builds each
hand-kernel source (`csrc/<name>.cu`) once with `nvcc` and loads the
library; a kernel takes any shape after that. So the ledger counts:

  * **builds**, per source, with their seconds, recorded by
    `ops/cuda_build.py` `build`; a library found from an earlier build in
    the same checkout counts as a load, not a build;
  * **host transfers**: `record_transfer(nbytes)` at every device→host
    seam of the main paths (the packed RIB buffer, the warm buffer, the
    lazy distance matrix, the first-hop / LFA / distance copies off the
    split tables, the election's result buffer, the KSP copy, the
    all-sources and fleet chunks). On the CPU the same seams count, as
    the JAX package counts them on its CPU backend;
  * **host syncs**: `record_sync()` at every scalar read of a loop's
    exit state that the host waits for (the split solve's per-sweep and
    per-tail-round reads, the sharded solve's per-sweep flag). They move
    a few bytes each but stall the host until the device drains, so
    they are counted apart from the transfers.

`mark_warm()` then `builds_since_warm()` is the steady-state rule: no
build after warm-up (the counterpart of "no compile after warm-up").
`export_to(counters)` writes `cuda.builds.<source>`, `cuda.builds.total`,
`cuda.transfers.host_reads`, `cuda.transfers.host_bytes` and
`cuda.transfers.host_syncs`: names of
their own, since a Decision's export of the JAX ledger writes the
`jax.*` names after every rebuild. Process-wide and thread-safe: kernels
build from worker threads and a Decision computes in them.
"""

from __future__ import annotations

import threading


class CompileLedger:
    """Builds and loads per source, and host transfers (see the module
    docstring)."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._builds: dict[str, int] = {}
        self._seconds: dict[str, float] = {}
        self._loads: dict[str, int] = {}
        self._warm: dict[str, int] | None = None
        self.host_reads = 0
        self.host_bytes = 0
        self.host_syncs = 0

    # ----------------------------------------------------------- recording

    def record_build(self, source: str, seconds: float) -> None:
        """One `nvcc` build of `csrc/<source>.cu` that took `seconds`."""
        with self._lock:
            self._builds[source] = self._builds.get(source, 0) + 1
            self._seconds[source] = self._seconds.get(source, 0.0) + seconds

    def record_load(self, source: str) -> None:
        """A library of `source` found from an earlier build."""
        with self._lock:
            self._loads[source] = self._loads.get(source, 0) + 1

    def record_transfer(self, nbytes: int) -> None:
        """One device→host copy of `nbytes` at a transfer seam: two
        integer adds under the lock."""
        with self._lock:
            self.host_reads += 1
            self.host_bytes += int(nbytes)

    def record_sync(self) -> None:
        """One scalar read of a loop's exit state (see the module
        docstring)."""
        with self._lock:
            self.host_syncs += 1

    # ------------------------------------------------------------- queries

    def builds(self) -> dict[str, int]:
        with self._lock:
            return dict(self._builds)

    def build_seconds(self) -> dict[str, float]:
        with self._lock:
            return dict(self._seconds)

    def loads(self) -> dict[str, int]:
        with self._lock:
            return dict(self._loads)

    def transfers(self) -> tuple[int, int]:
        """(host reads, host bytes) so far."""
        with self._lock:
            return self.host_reads, self.host_bytes

    def mark_warm(self) -> None:
        """Declare warm-up over: a build after this point is a
        steady-state violation (`builds_since_warm`)."""
        self._warm = self.builds()

    def builds_since_warm(self) -> dict[str, int]:
        """{source: builds since `mark_warm()`}; empty when never marked."""
        if self._warm is None:
            return {}
        return {s: n - self._warm.get(s, 0) for s, n in self.builds().items()
                if n > self._warm.get(s, 0)}

    def reset(self) -> None:
        """Drop every count and the warm mark (tests)."""
        with self._lock:
            self._builds.clear()
            self._seconds.clear()
            self._loads.clear()
            self._warm = None
            self.host_reads = 0
            self.host_bytes = 0
            self.host_syncs = 0

    # -------------------------------------------------------------- export

    def export_to(self, counters) -> None:
        """Stamp the ledger into a counters registry (anything with
        `set`). Values are process-wide."""
        builds = self.builds()
        reads, nbytes = self.transfers()
        for source, n in builds.items():
            counters.set(f"cuda.builds.{source}", n)
        counters.set("cuda.builds.total", sum(builds.values()))
        counters.set("cuda.transfers.host_reads", reads)
        counters.set("cuda.transfers.host_bytes", nbytes)
        counters.set("cuda.transfers.host_syncs", self.host_syncs)


#: the process ledger every consumer shares
_LEDGER = CompileLedger()


def ledger() -> CompileLedger:
    return _LEDGER


def record_build(source: str, seconds: float) -> None:
    _LEDGER.record_build(source, seconds)


def record_load(source: str) -> None:
    _LEDGER.record_load(source)


def record_transfer(nbytes: int) -> None:
    _LEDGER.record_transfer(nbytes)


def record_sync() -> None:
    _LEDGER.record_sync()


def mark_warm() -> None:
    _LEDGER.mark_warm()


def builds_since_warm() -> dict[str, int]:
    return _LEDGER.builds_since_warm()


def export_to(counters) -> None:
    _LEDGER.export_to(counters)


def reset() -> None:
    _LEDGER.reset()

"""Named spans around the solver's phases (the port's copy of `annotate`
in `openr_tpu/monitor/profiling.py`).

    with annotate("spf:batched_solve"):            # a profiler span
        ...
    with annotate("spf:batched_solve", counters=c):
        ...  # also records its wall ms: `profile.spf:batched_solve_ms`

The span is a `torch.profiler.record_function`, so a `torch.profiler`
trace shows it as a row above the kernels it launched. With `counters`
(anything with `add_value(name, value)` and `set`, such as
`monitor/counters.py` `Counters` or the JAX package's), the span's host
wall time is recorded on exit, and the HBM gauges are sampled there
(`monitor/device.py` `sample_hbm`: on a host without CUDA the first
sample latches off and later ones are a flag test). No device sync is
added: the time is the host's, as in the reference, and it covers the
device work only where the wrapped code reads a result back.
"""

from __future__ import annotations

import time

import torch

from openr_tpu_torch.monitor import device


def annotate(name: str, counters=None):
    """A `record_function(name)` span; with `counters`, one that also
    records its wall ms into the `profile.<name>_ms` stat."""
    span = torch.profiler.record_function(name)
    if counters is None:
        return span
    return _TimedSpan(name, counters, span)


class _TimedSpan:
    """The span plus a wall-clock timer recorded on exit. Nested spans
    each record their own duration; exceptions pass through."""

    __slots__ = ("name", "counters", "inner", "_t0")

    def __init__(self, name: str, counters, inner):
        self.name = name
        self.counters = counters
        self.inner = inner
        self._t0 = 0.0

    def __enter__(self):
        self._t0 = time.perf_counter()
        self.inner.__enter__()
        return self

    def __exit__(self, exc_type, exc, tb):
        self.inner.__exit__(exc_type, exc, tb)
        self.counters.add_value(
            f"profile.{self.name}_ms",
            (time.perf_counter() - self._t0) * 1e3,
        )
        device.sample_hbm(self.counters)
        return False

"""Observability of the port: named spans, counters, the work ledger,
the build and transfer ledger, and device telemetry (kernel cost rows,
HBM gauges)."""

from openr_tpu_torch.monitor import compile_ledger, device, work_ledger  # noqa: F401
from openr_tpu_torch.monitor.counters import Counters  # noqa: F401

"""Observability of the port: named spans, counters, the work ledger,
the build and transfer ledger, device telemetry (kernel cost rows, HBM
gauges), and the Monitor module's event and trace rings."""

from openr_tpu_torch.monitor import compile_ledger, device, work_ledger  # noqa: F401
from openr_tpu_torch.monitor.counters import Counters, render_prometheus  # noqa: F401
from openr_tpu_torch.monitor.monitor import LogSample, Monitor  # noqa: F401

"""LinkMonitor (the port's copy of `openr_tpu/linkmonitor/`)."""

from openr_tpu_torch.linkmonitor.linkmonitor import LinkMonitor  # noqa: F401

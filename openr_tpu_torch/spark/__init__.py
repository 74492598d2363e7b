"""Spark: neighbour discovery over packet I/O (the port's copy of
`openr_tpu/spark/`): the hello / handshake / heartbeat state machine per
(interface, neighbour), the hold timer, the RTT, graceful restart, and
the packet providers (`MockIoHub` in process, `UdpIoProvider` on UDP).
"""

from openr_tpu_torch.spark.io import IoProvider, MockIoHub, UdpIoProvider  # noqa: F401
from openr_tpu_torch.spark.spark import Spark, SparkNeighborState  # noqa: F401

"""Inter-module events: Spark's neighbour events and the platform's
interface events, as LinkMonitor consumes them.

Same fields, ordering and equality as `openr_tpu/types/events.py`, so
both packages encode them to the same bytes.
"""

from __future__ import annotations

import enum
from dataclasses import dataclass, field

from openr_tpu_torch.monitor.perf import PerfEvents
from openr_tpu_torch.types.serde import register_wire_types


class NeighborEventType(enum.IntEnum):
    NEIGHBOR_UP = 0
    NEIGHBOR_DOWN = 1
    NEIGHBOR_RESTARTING = 2
    NEIGHBOR_RESTARTED = 3
    NEIGHBOR_RTT_CHANGE = 4


@dataclass(frozen=True)
class NeighborInfo:
    """What LinkMonitor needs to build an adjacency and a KvStore
    peer."""

    node_name: str
    local_if: str
    remote_if: str = ""
    area: str = "0"
    kvstore_port: int = 0
    ctrl_port: int = 0
    hold_time_ms: int = 0
    gr_time_ms: int = 0
    rtt_us: int = 0
    label: int = 0
    # host of the KvStore peer (TCP transports; unused in process)
    endpoint_host: str = ""


@dataclass(frozen=True)
class NeighborEvent:
    type: NeighborEventType
    info: NeighborInfo
    # the convergence trace carried along the pipeline; it annotates the
    # event and does not identify it
    perf_events: PerfEvents | None = field(
        default=None, compare=False
    )


@dataclass(frozen=True)
class InterfaceInfo:
    name: str
    is_up: bool = True
    ifindex: int = 0
    addrs: tuple[str, ...] = ()


@dataclass
class InterfaceEvent:
    interfaces: list[InterfaceInfo] = field(default_factory=list)


register_wire_types(NeighborInfo, NeighborEvent, InterfaceInfo, InterfaceEvent)

"""Link-state topology types: adjacencies and prefix advertisements.

Same fields, ordering and equality as `openr_tpu/types/topology.py`.
"""

from __future__ import annotations

import enum
from dataclasses import dataclass

from openr_tpu_torch.common.constants import DEFAULT_AREA
from openr_tpu_torch.types.network import IpPrefix
from openr_tpu_torch.types.serde import register_wire_types


class ForwardingType(enum.IntEnum):
    IP = 0
    SR_MPLS = 1


class ForwardingAlgorithm(enum.IntEnum):
    SP_ECMP = 0
    KSP2_ED_ECMP = 1  # 2 edge-disjoint shortest paths (SR-MPLS)


@dataclass(frozen=True)
class Adjacency:
    """One directed adjacency (this node -> other node over if_name)."""

    other_node_name: str
    if_name: str
    metric: int = 1
    adj_label: int = 0
    is_overloaded: bool = False
    rtt_us: int = 0
    weight: int = 1
    other_if_name: str = ""


@dataclass(frozen=True)
class AdjacencyDatabase:
    this_node_name: str
    adjacencies: tuple[Adjacency, ...] = ()
    is_overloaded: bool = False  # node drain: never transit this node
    node_label: int = 0
    area: str = DEFAULT_AREA


DEFAULT_PATH_PREFERENCE = 1000
DEFAULT_SOURCE_PREFERENCE = 100


@dataclass(frozen=True)
class PrefixMetrics:
    """Compared lexicographically: higher path_preference, then higher
    source_preference, then lower distance."""

    path_preference: int = DEFAULT_PATH_PREFERENCE
    source_preference: int = DEFAULT_SOURCE_PREFERENCE
    distance: int = 0


@dataclass(frozen=True, slots=True)
class PrefixEntry:
    prefix: IpPrefix
    metrics: PrefixMetrics = PrefixMetrics()
    forwarding_type: ForwardingType = ForwardingType.IP
    forwarding_algorithm: ForwardingAlgorithm = ForwardingAlgorithm.SP_ECMP
    tags: tuple[str, ...] = ()
    area_stack: tuple[str, ...] = ()
    weight: int = 0
    min_nexthop: int = 0


@dataclass(frozen=True)
class PrefixDatabase:
    this_node_name: str
    prefix_entries: tuple[PrefixEntry, ...] = ()
    area: str = DEFAULT_AREA
    delete_prefix: bool = False


register_wire_types(
    Adjacency, AdjacencyDatabase, PrefixMetrics, PrefixEntry, PrefixDatabase
)

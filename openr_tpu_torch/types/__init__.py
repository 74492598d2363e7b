"""Typed schemas of the port: the topology, network and RIB dataclasses
with the same fields, ordering and equality as the JAX package's."""

from openr_tpu_torch.types.network import (  # noqa: F401
    IpPrefix,
    MplsAction,
    MplsActionType,
    NextHop,
    sorted_nexthops,
)
from openr_tpu_torch.types.routes import (  # noqa: F401
    NexthopGroup,
    NexthopIntern,
    RibEntry,
    RibMplsEntry,
    RouteDatabase,
)
from openr_tpu_torch.types.topology import (  # noqa: F401
    Adjacency,
    AdjacencyDatabase,
    ForwardingAlgorithm,
    ForwardingType,
    PrefixDatabase,
    PrefixEntry,
    PrefixMetrics,
)

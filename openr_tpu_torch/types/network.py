"""Network-layer types: prefixes, nexthops, MPLS actions.

Same fields, ordering and equality as `openr_tpu/types/network.py`;
the wire-format registration is not part of the port.
"""

from __future__ import annotations

import enum
import ipaddress
from dataclasses import dataclass
from functools import total_ordering


class MplsActionType(enum.IntEnum):
    PUSH = 0
    SWAP = 1
    PHP = 2  # penultimate hop pop
    POP_AND_LOOKUP = 3


@dataclass(frozen=True)
class MplsAction:
    action: MplsActionType
    swap_label: int | None = None
    push_labels: tuple[int, ...] = ()


@total_ordering
@dataclass(frozen=True)
class IpPrefix:
    """A v4/v6 prefix in canonical "net/len" form."""

    prefix: str

    @staticmethod
    def make(s: str) -> "IpPrefix":
        return IpPrefix(prefix=str(ipaddress.ip_network(s, strict=False)))

    def __hash__(self):
        # cached: every RIB dict probe hashes the prefix
        try:
            return self._hash
        except AttributeError:
            object.__setattr__(self, "_hash", hash(self.prefix))
            return self._hash

    def __str__(self) -> str:
        return self.prefix

    def __lt__(self, other: "IpPrefix") -> bool:
        return self.prefix < other.prefix


@total_ordering
@dataclass(frozen=True, slots=True)
class NextHop:
    """One nexthop of a route (`weight` 0 == ECMP)."""

    address: str
    if_name: str = ""
    metric: int = 0
    weight: int = 0
    mpls_action: MplsAction | None = None
    area: str = ""
    neighbor_node: str = ""

    def _key(self):
        a = self.mpls_action
        return (
            self.address,
            self.if_name,
            self.metric,
            self.weight,
            (-1, 0, ()) if a is None else (
                int(a.action),
                a.swap_label if a.swap_label is not None else -1,
                a.push_labels,
            ),
            self.area,
            self.neighbor_node,
        )

    def __lt__(self, other: "NextHop") -> bool:
        return self._key() < other._key()


def sorted_nexthops(nhs) -> tuple[NextHop, ...]:
    """Canonical ordering so route equality is set-equality."""
    return tuple(sorted(nhs, key=NextHop._key))

"""RIB types: computed routes.

Same fields, ordering and equality as `openr_tpu/types/routes.py`
(route deltas and route conversions are not part of the port yet).
"""

from __future__ import annotations

from dataclasses import dataclass, field

from openr_tpu_torch.types.network import IpPrefix, NextHop
from openr_tpu_torch.types.topology import PrefixEntry


class NexthopGroup(tuple):
    """Interned ECMP nexthop set shared across routes: a tuple with
    identity, so two bindings of one group compare by pointer; groups
    from different tables still compare by content."""

    gid = -1  # per-table mint sequence, diagnostics only

    def __new__(cls, nexthops, gid: int = -1):
        self = super().__new__(cls, nexthops)
        self.gid = gid
        return self

    def __eq__(self, other):
        if self is other:
            return True
        return tuple.__eq__(self, other)

    def __ne__(self, other):
        eq = self.__eq__(other)
        return eq if eq is NotImplemented else not eq

    __hash__ = tuple.__hash__


class NexthopIntern:
    """Intern table: `intern(nhs)` returns THE group for a nexthop tuple.
    Past `cap` groups it resets (equality falls back to content)."""

    __slots__ = ("_table", "hits", "cap", "_next_gid")

    def __init__(self, cap: int = 1 << 16):
        self._table: dict[tuple, NexthopGroup] = {}
        self.hits = 0
        self.cap = cap
        self._next_gid = 0

    def intern(self, nhs) -> NexthopGroup:
        if type(nhs) is NexthopGroup:
            return nhs
        got = self._table.get(nhs)
        if got is not None:
            self.hits += 1
            return got
        if len(self._table) >= self.cap:
            self._table.clear()
        g = NexthopGroup(nhs, gid=self._next_gid)
        self._next_gid += 1
        self._table[g] = g
        return g

    def __len__(self) -> int:
        return len(self._table)


@dataclass(frozen=True, slots=True)
class RibEntry:
    """A computed unicast route with provenance."""

    prefix: IpPrefix
    nexthops: tuple[NextHop, ...]
    best_node: str = ""
    best_nodes: tuple[str, ...] = ()
    best_entry: PrefixEntry | None = None
    igp_cost: int = 0
    backup_nexthops: tuple[NextHop, ...] = ()


@dataclass(frozen=True, slots=True)
class RibMplsEntry:
    label: int
    nexthops: tuple[NextHop, ...]


@dataclass
class RouteDatabase:
    """Full RIB snapshot."""

    this_node_name: str = ""
    unicast_routes: dict[IpPrefix, RibEntry] = field(default_factory=dict)
    mpls_routes: dict[int, RibMplsEntry] = field(default_factory=dict)

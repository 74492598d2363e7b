"""RIB types: computed routes.

Same fields, ordering and equality as `openr_tpu/types/routes.py`, with
its route delta (`RouteUpdate`, `diff_route_dbs`) and the conversions to
FIB routes (`to_unicast_route`, `to_mpls_route`).
"""

from __future__ import annotations

import enum
from dataclasses import dataclass, field

from openr_tpu_torch.types.network import (
    IpPrefix,
    MplsRoute,
    NextHop,
    UnicastRoute,
)
from openr_tpu_torch.types.serde import register_wire_types
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

    def to_unicast_route(self) -> UnicastRoute:
        return UnicastRoute(dest=self.prefix, nexthops=self.nexthops)


@dataclass(frozen=True, slots=True)
class RibMplsEntry:
    label: int
    nexthops: tuple[NextHop, ...]

    def to_mpls_route(self) -> MplsRoute:
        return MplsRoute(top_label=self.label, nexthops=self.nexthops)


@dataclass
class RouteDatabase:
    """Full RIB snapshot."""

    this_node_name: str = ""
    unicast_routes: dict[IpPrefix, RibEntry] = field(default_factory=dict)
    mpls_routes: dict[int, RibMplsEntry] = field(default_factory=dict)


class RouteUpdateType(enum.IntEnum):
    INCREMENTAL = 0
    FULL_SYNC = 1


@dataclass
class RouteUpdate:
    """The delta between successive RIBs: what Decision emits and Fib
    consumes."""

    type: RouteUpdateType = RouteUpdateType.INCREMENTAL
    unicast_to_update: dict[IpPrefix, RibEntry] = field(default_factory=dict)
    unicast_to_delete: list[IpPrefix] = field(default_factory=list)
    mpls_to_update: dict[int, RibMplsEntry] = field(default_factory=dict)
    mpls_to_delete: list[int] = field(default_factory=list)
    # the convergence traces of the publications folded into this delta;
    # they annotate it and do not identify it
    perf_events: list = field(default_factory=list, compare=False)

    def empty(self) -> bool:
        return not (
            self.unicast_to_update
            or self.unicast_to_delete
            or self.mpls_to_update
            or self.mpls_to_delete
        )


def diff_route_dbs(
    old: RouteDatabase,
    new: RouteDatabase,
    prefix_scope=None,
    label_scope=None,
) -> RouteUpdate:
    """The update that turns `old` into `new`.

    Entry equality short-circuits on identity first (the solver's route
    caches hand back the same frozen entry for an unchanged route), and
    a changed entry's nexthops on `NexthopGroup` identity.
    `prefix_scope` / `label_scope` restrict the walk to those keys: the
    caller asserts that nothing else changed. None walks everything.
    """
    upd = RouteUpdate()
    if old is new:
        return upd
    if prefix_scope is None:
        new_u = new.unicast_routes
        old_u = old.unicast_routes
        # dict equality runs in C with a per-value identity shortcut, so
        # an unchanged table proves itself without the walk below
        if old_u != new_u:
            old_get = old_u.get
            upd_u = upd.unicast_to_update
            for prefix, entry in new_u.items():
                prev = old_get(prefix)
                if prev is not entry and prev != entry:
                    upd_u[prefix] = entry
            if old_u.keys() != new_u.keys():
                upd.unicast_to_delete.extend(
                    p for p in old_u if p not in new_u
                )
    else:
        for prefix in sorted(prefix_scope):  # sorted: deterministic delta
            entry = new.unicast_routes.get(prefix)
            if entry is None:
                if prefix in old.unicast_routes:
                    upd.unicast_to_delete.append(prefix)
                continue
            prev = old.unicast_routes.get(prefix)
            if prev is not entry and prev != entry:
                upd.unicast_to_update[prefix] = entry
    if label_scope is None:
        for label, mentry in new.mpls_routes.items():
            prev_m = old.mpls_routes.get(label)
            if prev_m is not mentry and prev_m != mentry:
                upd.mpls_to_update[label] = mentry
        for label in old.mpls_routes:
            if label not in new.mpls_routes:
                upd.mpls_to_delete.append(label)
    else:
        for label in sorted(label_scope):
            mentry = new.mpls_routes.get(label)
            if mentry is None:
                if label in old.mpls_routes:
                    upd.mpls_to_delete.append(label)
                continue
            prev_m = old.mpls_routes.get(label)
            if prev_m is not mentry and prev_m != mentry:
                upd.mpls_to_update[label] = mentry
    return upd


register_wire_types(RibEntry, RibMplsEntry, RouteDatabase, RouteUpdate)

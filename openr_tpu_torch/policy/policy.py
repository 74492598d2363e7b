"""Policy engines (the port's copy of `openr_tpu/policy/policy.py`):

  * origination policy (`PolicyStatement`, `RouteMap`, `PolicyManager`):
    match and transform applied when prefixes are originated or
    redistributed, on tags or a prefix list, then accept (optionally
    rewriting metrics and tags) or deny; PrefixManager applies it;
  * `RibPolicy`, Decision's weight policy with a TTL: statements match
    routes (by prefix or tag) and give each next hop a UCMP weight from
    area and neighbor maps; weight 0 removes the next hop. Decision
    applies it after route computation.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field, replace

from openr_tpu_torch.decision.ksp import normalize_weights
from openr_tpu_torch.types.network import IpPrefix
from openr_tpu_torch.types.routes import RouteDatabase
from openr_tpu_torch.types.topology import PrefixEntry

# ---------------------------------------------------------------- origination


@dataclass(frozen=True)
class PolicyStatement:
    """One origination policy rule.

    Matching: empty matcher field = wildcard. `match_tags` matches if the
    entry carries ANY of the tags; `match_prefixes` matches exact prefix
    or any subnet of a listed prefix.
    """

    name: str = ""
    match_tags: tuple[str, ...] = ()
    match_prefixes: tuple[str, ...] = ()
    action_accept: bool = True
    set_path_preference: int | None = None
    set_source_preference: int | None = None
    set_distance_increment: int | None = None  # distance += N (redistribution)
    add_tags: tuple[str, ...] = ()

    def matches(self, entry: PrefixEntry) -> bool:
        if self.match_tags and not (set(self.match_tags) & set(entry.tags)):
            return False
        if self.match_prefixes:
            net = entry.prefix.network
            ok = False
            for p in self.match_prefixes:
                pn = IpPrefix.make(p).network
                if pn.version == net.version and net.subnet_of(pn):
                    ok = True
                    break
            if not ok:
                return False
        return True

    def apply(self, entry: PrefixEntry) -> PrefixEntry | None:
        if not self.action_accept:
            return None
        m = entry.metrics
        if self.set_path_preference is not None:
            m = replace(m, path_preference=self.set_path_preference)
        if self.set_source_preference is not None:
            m = replace(m, source_preference=self.set_source_preference)
        if self.set_distance_increment is not None:
            m = replace(m, distance=m.distance + self.set_distance_increment)
        tags = tuple(dict.fromkeys((*entry.tags, *self.add_tags)))
        return replace(entry, metrics=m, tags=tags)


@dataclass(frozen=True)
class RouteMapTerm:
    """One numbered term of an ordered route-map: a numbered sequence,
    permit or deny, an AND of matchers, tag-set algebra.

    Matching is the AND of every non-empty matcher:
      match_tags_any   — entry carries at least one of these tags
      match_tags_all   — entry carries every one of these tags
      match_not_tags   — entry carries none of these tags
      match_prefixes   — entry's prefix is a subnet of one listed, with
                         optional [ge, le] prefix-length bounds per item
                         ("10.0.0.0/8 ge 24 le 28" style, parsed form)
    Transforms (permit only), applied in this order:
      set_tags (replace) -> add_tags -> remove_tags, then preference /
      distance rewrites.
    """

    seq: int
    action: str = "permit"  # "permit" | "deny"
    match_tags_any: tuple[str, ...] = ()
    match_tags_all: tuple[str, ...] = ()
    match_not_tags: tuple[str, ...] = ()
    # (prefix, ge, le): ge/le = 0 means unconstrained
    match_prefixes: tuple[tuple[str, int, int], ...] = ()
    set_path_preference: int | None = None
    set_source_preference: int | None = None
    set_distance_increment: int | None = None
    set_tags: tuple[str, ...] | None = None
    add_tags: tuple[str, ...] = ()
    remove_tags: tuple[str, ...] = ()

    def __post_init__(self):
        # parse + validate the prefix matchers and freeze the tag sets
        # ONCE (redistribution applies the map per RIB prefix — doing
        # this per evaluation would be O(prefixes x terms) rebuild work,
        # and a malformed prefix must fail at build time, not on the
        # first matching entry inside PrefixManager's event loop)
        object.__setattr__(
            self,
            "_nets",
            tuple(
                (IpPrefix.make(p).network, ge, le)
                for p, ge, le in self.match_prefixes
            ),
        )
        object.__setattr__(self, "_any", frozenset(self.match_tags_any))
        object.__setattr__(self, "_all", frozenset(self.match_tags_all))
        object.__setattr__(self, "_not", frozenset(self.match_not_tags))

    def matches(self, entry: PrefixEntry, _tags=None) -> bool:
        tags = set(entry.tags) if _tags is None else _tags
        if self._any and not (self._any & tags):
            return False
        if self._all and not (self._all <= tags):
            return False
        if self._not and (self._not & tags):
            return False
        if self.match_prefixes:
            net = entry.prefix.network
            for pn, ge, le in self._nets:
                if pn.version != net.version or not net.subnet_of(pn):
                    continue
                if ge and net.prefixlen < ge:
                    continue
                if le and net.prefixlen > le:
                    continue
                return True
            return False
        return True

    def transform(self, entry: PrefixEntry) -> PrefixEntry:
        tags = list(self.set_tags) if self.set_tags is not None else list(
            entry.tags
        )
        tags += [t for t in self.add_tags if t not in tags]
        if self.remove_tags:
            drop = set(self.remove_tags)
            tags = [t for t in tags if t not in drop]
        m = entry.metrics
        if self.set_path_preference is not None:
            m = replace(m, path_preference=self.set_path_preference)
        if self.set_source_preference is not None:
            m = replace(m, source_preference=self.set_source_preference)
        if self.set_distance_increment is not None:
            m = replace(m, distance=m.distance + self.set_distance_increment)
        return replace(entry, metrics=m, tags=tuple(dict.fromkeys(tags)))


@dataclass(frozen=True)
class RouteMap:
    """Ordered route-map: terms evaluated in ascending `seq`; the FIRST
    matching term decides (permit -> transformed entry, deny -> None);
    no match falls through to `default_accept` (route-map convention:
    implicit deny).

    Earlier broad terms SHADOW later ones.
    """

    name: str = ""
    terms: tuple[RouteMapTerm, ...] = ()
    default_accept: bool = False

    def __post_init__(self):
        object.__setattr__(
            self, "terms", tuple(sorted(self.terms, key=lambda t: t.seq))
        )
        seqs = [t.seq for t in self.terms]
        if len(set(seqs)) != len(seqs):
            raise ValueError(f"route-map {self.name!r}: duplicate seq")
        for t in self.terms:
            if t.action not in ("permit", "deny"):
                raise ValueError(
                    f"route-map {self.name!r} seq {t.seq}: bad action "
                    f"{t.action!r}"
                )

    def apply(self, entry: PrefixEntry) -> PrefixEntry | None:
        tags = set(entry.tags)  # once per entry, shared across terms
        for t in self.terms:
            if t.matches(entry, _tags=tags):
                if t.action == "deny":
                    return None
                return t.transform(entry)
        return entry if self.default_accept else None


@dataclass
class PolicyManager:
    """Origination/redistribution policy engine. Either an ordered `route_map` (takes precedence)
    or the simpler first-match statement list; `default_accept` governs
    entries nothing matches on the statement path (the route-map has
    its own default)."""

    statements: tuple[PolicyStatement, ...] = ()
    default_accept: bool = True
    route_map: RouteMap | None = None

    def apply(self, entry: PrefixEntry) -> PrefixEntry | None:
        """None = denied (do not originate)."""
        if self.route_map is not None:
            return self.route_map.apply(entry)
        for st in self.statements:
            if st.matches(entry):
                return st.apply(entry)
        return entry if self.default_accept else None


def parse_prefix_match(spec: str) -> tuple[str, int, int]:
    """Parse "PREFIX [ge N] [le N]" into the RouteMapTerm tuple form."""
    parts = spec.split()
    prefix, ge, le = parts[0], 0, 0
    i = 1
    while i < len(parts):
        if i + 1 >= len(parts):
            raise ValueError(f"bad prefix match {spec!r}")
        kw, val = parts[i], int(parts[i + 1])
        if kw == "ge":
            ge = val
        elif kw == "le":
            le = val
        else:
            raise ValueError(f"bad prefix match {spec!r}")
        i += 2
    if ge and le and ge > le:
        raise ValueError(f"bad prefix match {spec!r}: ge > le")
    IpPrefix.make(prefix)  # validate now — not on first evaluation
    return prefix, ge, le


def build_route_map(term_configs, default_accept: bool) -> RouteMap:
    """Assemble a RouteMap from route-map term configs (objects with
    `RouteMapTermConfig`'s fields; prefix matchers parsed here)."""
    terms = tuple(
        RouteMapTerm(
            seq=t.seq,
            action=t.action,
            match_tags_any=tuple(t.match_tags_any),
            match_tags_all=tuple(t.match_tags_all),
            match_not_tags=tuple(t.match_not_tags),
            match_prefixes=tuple(
                parse_prefix_match(p) for p in t.match_prefixes
            ),
            set_path_preference=t.set_path_preference,
            set_source_preference=t.set_source_preference,
            set_distance_increment=t.set_distance_increment,
            set_tags=tuple(t.set_tags) if t.set_tags is not None else None,
            add_tags=tuple(t.add_tags),
            remove_tags=tuple(t.remove_tags),
        )
        for t in term_configs
    )
    return RouteMap(terms=terms, default_accept=default_accept)


# ------------------------------------------------------------------ RibPolicy


@dataclass(frozen=True)
class RibPolicyStatement:
    """A matcher (prefixes, tags) and the weights it gives next hops."""

    name: str = ""
    match_prefixes: tuple[str, ...] = ()
    match_tags: tuple[str, ...] = ()
    default_weight: int = 1
    area_to_weight: dict[str, int] = field(default_factory=dict)
    neighbor_to_weight: dict[str, int] = field(default_factory=dict)

    def matches(self, entry) -> bool:
        if self.match_tags:
            tags = entry.best_entry.tags if entry.best_entry else ()
            if not (set(self.match_tags) & set(tags)):
                return False
        if self.match_prefixes:
            net = entry.prefix.network
            return any(
                (pn := IpPrefix.make(p).network).version == net.version
                and net.subnet_of(pn)
                for p in self.match_prefixes
            )
        return True

    def weight_for(self, nh) -> int:
        if nh.neighbor_node in self.neighbor_to_weight:
            return self.neighbor_to_weight[nh.neighbor_node]
        if nh.area in self.area_to_weight:
            return self.area_to_weight[nh.area]
        return self.default_weight


@dataclass
class RibPolicy:
    """Statements and a TTL. Decision holds at most one; `apply` mutates a
    computed RouteDatabase in place, replacing entries (never mutating
    one) and deleting routes."""

    statements: tuple[RibPolicyStatement, ...] = ()
    ttl_secs: float = 300.0

    def __post_init__(self):
        # NOT a dataclass field: the deadline is process-local monotonic
        # time and must never travel over the wire — a deserialized policy
        # re-stamps its TTL from receipt
        self._expires_at = time.monotonic() + self.ttl_secs

    @property
    def expired(self) -> bool:
        return time.monotonic() >= self._expires_at

    def apply(self, rdb: RouteDatabase) -> int:
        """Rewrite nexthop weights on matching routes; returns the number
        of routes modified. Weight 0 drops the nexthop; a route whose
        nexthops all drop is removed."""
        if self.expired:
            return 0
        modified = 0
        for prefix in list(rdb.unicast_routes):
            entry = rdb.unicast_routes[prefix]
            st = next(
                (s for s in self.statements if s.matches(entry)), None
            )
            if st is None:
                continue
            weighted = {
                (nh.neighbor_node, nh.if_name): st.weight_for(nh)
                for nh in entry.nexthops
            }
            kept = {k: w for k, w in weighted.items() if w > 0}
            if not kept:
                del rdb.unicast_routes[prefix]
                modified += 1
                continue
            norm = normalize_weights(kept)
            new_nhs = tuple(
                sorted(
                    replace(nh, weight=norm[(nh.neighbor_node, nh.if_name)])
                    for nh in entry.nexthops
                    if (nh.neighbor_node, nh.if_name) in kept
                )
            )
            if new_nhs != entry.nexthops:
                rdb.unicast_routes[prefix] = replace(
                    entry, nexthops=new_nhs
                )
                modified += 1
        return modified

"""PrefixManager: the one authority for what this node advertises (the
port's copy of `openr_tpu/prefixmgr/prefix_manager.py`).

    pm = PrefixManager(config, kv_client,
                       prefix_events_reader=events.get_reader(),
                       fib_updates_reader=fib_updates.get_reader())
    await pm.start()

Origination requests come from the config (`originated_prefixes`), from
`PrefixEvent`s (the API, the prefix allocator) and, on a node of more
than one area, from the Decision's RIB (cross-area redistribution). The
manager keeps one entry per (source, prefix), advertises the best entry
of each prefix as a `prefix:<node>:<area>:[<prefix>]` key through the
KvStoreClient, and withdraws by a tombstone (`delete_prefix=True`) that
dies by TTL. A config origination with `minimum_supporting_routes` is
advertised only while that many more-specific routes are programmed, as
Fib's programmed stream tells. Ranges (`PrefixRange`) are advertised in
chunks of `RANGE_CHUNK` entries a key. The books (`_best`,
`_owned_count`, `_by_source`, `_dirty_adv`) keep every step
proportional to what changed. The durable books (`persist=`) come with
the port's `persist/`.
"""

from __future__ import annotations

import dataclasses
import enum
import logging
from dataclasses import dataclass, field

from openr_tpu_torch.common import constants as C
from openr_tpu_torch.common.eventbase import OpenrModule
from openr_tpu_torch.config import Config, OriginatedPrefix
from openr_tpu_torch.kvstore.client import KvStoreClient
from openr_tpu_torch.messaging import QueueClosedError, RQueue
from openr_tpu_torch.monitor import work_ledger
from openr_tpu_torch.types.network import IpPrefix
from openr_tpu_torch.types.routes import RouteUpdate, RouteUpdateType
from openr_tpu_torch.types.serde import to_wire
from openr_tpu_torch.types.topology import (
    PrefixDatabase,
    PrefixEntry,
    PrefixMetrics,
)

log = logging.getLogger(__name__)


class PrefixSource(enum.IntEnum):
    """The origin of an advertisement; the higher wins at one prefix."""

    RIB = 10          # cross-area redistribution
    ALLOCATOR = 20    # the prefix allocator's elected block
    CONFIG = 30       # originated_prefixes in the config
    API = 40          # an operator's advertisement


class PrefixEventType(enum.IntEnum):
    ADD_PREFIXES = 0
    WITHDRAW_PREFIXES = 1
    WITHDRAW_SOURCE = 2  # everything of one source


@dataclass
class PrefixEvent:
    """An origination request."""

    type: PrefixEventType
    source: PrefixSource = PrefixSource.API
    entries: tuple[PrefixEntry, ...] = ()
    dest_areas: tuple[str, ...] = ()  # (): every configured area
    # contiguous blocks advertised as chunked PrefixDatabases
    ranges: tuple = ()


@dataclass
class _Origination:
    """A config origination and its FIB gate."""

    cfg: OriginatedPrefix
    prefix: IpPrefix = field(init=False)
    supporting: set[IpPrefix] = field(default_factory=set)
    advertised: bool = False

    def __post_init__(self):
        self.prefix = IpPrefix.make(self.cfg.prefix)

    def ready(self) -> bool:
        return len(self.supporting) >= self.cfg.minimum_supporting_routes


class PrefixManager(OpenrModule):
    def __init__(
        self,
        config: Config,
        kv_client: KvStoreClient,
        prefix_events_reader: RQueue | None = None,
        fib_updates_reader: RQueue | None = None,
        route_updates_reader: RQueue | None = None,
        policy=None,  # an origination policy: policy.PolicyManager
        counters=None,
        persist=None,
    ):
        if persist is not None:
            raise NotImplementedError(
                "PrefixManager: persist= needs the durable journal, which "
                "is not part of the port yet"
            )
        super().__init__(f"{config.node_name}.prefixmgr", counters=counters)
        self.policy = policy
        self.config = config
        self.node_name = config.node_name
        self.kv_client = kv_client
        self.events_reader = prefix_events_reader
        self.fib_reader = fib_updates_reader
        # the Decision's RIB stream, read only with more than one area
        self.route_reader = route_updates_reader
        # (source, prefix) -> (entry, dest_areas)
        self._entries: dict[
            tuple[PrefixSource, IpPrefix], tuple[PrefixEntry, tuple[str, ...]]
        ] = {}
        # the books, kept by _entry_set / _entry_del:
        #   _best: prefix -> (source, entry, dest_areas), the winner;
        #   _owned_count: prefix -> its sources other than RIB (the
        #     "never shadow our own origination" probe);
        #   _by_source: source -> its prefixes;
        #   _dirty_adv: prefixes whose winner or areas moved since the
        #     last _sync_advertisements, which reads only these
        self._best: dict[
            IpPrefix, tuple[PrefixSource, PrefixEntry, tuple[str, ...]]
        ] = {}
        self._owned_count: dict[IpPrefix, int] = {}
        self._by_source: dict[PrefixSource, set[IpPrefix]] = {}
        self._dirty_adv: set[IpPrefix] = set()
        # (source, range key) -> (PrefixRange, dest_areas)
        self._range_entries: dict[tuple, tuple] = {}
        # range key -> (PrefixRange, advertised areas)
        self._range_adv: dict[tuple, tuple] = {}
        # prefix -> the areas it is advertised into
        self._advertised: dict[IpPrefix, set[str]] = {}
        self._originations: list[_Origination] = [
            _Origination(cfg=op) for op in config.node.originated_prefixes
        ]
        self.ttl_ms = config.node.kvstore.key_ttl_ms

    async def main(self) -> None:
        if self.events_reader is not None:
            self.spawn(self._event_loop(), name=f"{self.name}.events")
        if self.fib_reader is not None:
            self.spawn(self._fib_loop(), name=f"{self.name}.fib")
        if self.route_reader is not None and len(self.config.area_ids()) > 1:
            self.spawn(self._rib_loop(), name=f"{self.name}.rib")
        self._sync_originations()
        self._sync_advertisements()

    # ------------------------------------------------------------- events

    async def _event_loop(self) -> None:
        while True:
            try:
                ev = await self.events_reader.get()
            except QueueClosedError:
                return
            self.process_event(ev)

    def process_event(self, ev: PrefixEvent) -> None:
        if ev.type == PrefixEventType.ADD_PREFIXES:
            for e in ev.entries:
                if self.policy is not None:
                    e = self.policy.apply(e)
                    if e is None:  # denied by the origination policy
                        if self.counters:
                            self.counters.increment("prefixmgr.policy_denied")
                        continue
                self._entry_set(ev.source, e.prefix, e, ev.dest_areas)
            # ranges skip the per-entry policy: their template is the
            # one entry shape, policed before it is handed over
            for r in ev.ranges:
                self._range_entries[(ev.source, r.key())] = (r, ev.dest_areas)
        elif ev.type == PrefixEventType.WITHDRAW_PREFIXES:
            for e in ev.entries:
                self._entry_del(ev.source, e.prefix)
            for r in ev.ranges:
                self._range_entries.pop((ev.source, r.key()), None)
        elif ev.type == PrefixEventType.WITHDRAW_SOURCE:
            for p in list(self._by_source.get(ev.source, ())):
                self._entry_del(ev.source, p)
            for key in [k for k in self._range_entries if k[0] == ev.source]:
                del self._range_entries[key]
        self._sync_advertisements()
        if self.counters:
            self.counters.increment("prefixmgr.events")

    # ------------------------------------------------------- entry books

    def _entry_set(
        self,
        source: PrefixSource,
        prefix: IpPrefix,
        entry: PrefixEntry,
        areas: tuple[str, ...],
    ) -> None:
        """Insert or replace one (source, prefix) entry, in O(1)."""
        key = (source, prefix)
        prev = self._entries.get(key)
        if prev is not None and prev[0] == entry and prev[1] == areas:
            return  # nothing moved
        self._entries[key] = (entry, areas)
        if prev is None:
            self._by_source.setdefault(source, set()).add(prefix)
            if source != PrefixSource.RIB:
                self._owned_count[prefix] = (
                    self._owned_count.get(prefix, 0) + 1
                )
        cur = self._best.get(prefix)
        if cur is None or source >= cur[0]:
            if cur != (source, entry, areas):
                self._best[prefix] = (source, entry, areas)
                self._dirty_adv.add(prefix)

    def _entry_del(self, source: PrefixSource, prefix: IpPrefix) -> None:
        """Remove one (source, prefix) entry; the winner's successor is
        found by probing the other sources, best first."""
        key = (source, prefix)
        if self._entries.pop(key, None) is None:
            return
        srcs = self._by_source.get(source)
        if srcs is not None:
            srcs.discard(prefix)
        if source != PrefixSource.RIB:
            n = self._owned_count.get(prefix, 0) - 1
            if n > 0:
                self._owned_count[prefix] = n
            else:
                self._owned_count.pop(prefix, None)
        cur = self._best.get(prefix)
        if cur is None or cur[0] != source:
            return  # a shadowed source left: the winner stays
        for s in sorted(PrefixSource, reverse=True):
            nxt = self._entries.get((s, prefix))
            if nxt is not None:
                self._best[prefix] = (s, nxt[0], nxt[1])
                break
        else:
            del self._best[prefix]
        self._dirty_adv.add(prefix)

    # ---------------------------------------------------------- fib gating

    async def _fib_loop(self) -> None:
        while True:
            try:
                upd: RouteUpdate = await self.fib_reader.get()
            except QueueClosedError:
                return
            self._fold_fib_update(upd)
            self._sync_originations()
            self._sync_advertisements()

    def _fold_fib_update(self, upd: RouteUpdate) -> None:
        for orig in self._originations:
            net = orig.prefix.network
            if upd.type == RouteUpdateType.FULL_SYNC:
                orig.supporting = set()
            for p in upd.unicast_to_update:
                if (
                    p != orig.prefix
                    and p.is_v4 == orig.prefix.is_v4
                    and p.network.subnet_of(net)
                ):
                    orig.supporting.add(p)
            for p in upd.unicast_to_delete:
                orig.supporting.discard(p)

    # ------------------------------------------- cross-area redistribution

    async def _rib_loop(self) -> None:
        while True:
            try:
                upd: RouteUpdate = await self.route_reader.get()
            except QueueClosedError:
                return
            self.fold_rib_update(upd)
            self._sync_advertisements()

    def fold_rib_update(self, upd: RouteUpdate) -> None:
        """Area border role: a prefix learned in area X is advertised by
        this node into every other configured area, its distance one
        more and X appended to its area stack; never into an area the
        stack holds (loop prevention)."""
        all_areas = set(self.config.area_ids())
        delta = len(upd.unicast_to_update) + len(upd.unicast_to_delete)
        with work_ledger.scope("redistribute", delta) as ws:
            if upd.type == RouteUpdateType.FULL_SYNC:
                # drop the RIB slice, O(dropped), and fold the update
                rib_prefixes = list(
                    self._by_source.get(PrefixSource.RIB, ())
                )
                ws.add(len(rib_prefixes))
                for p in rib_prefixes:
                    self._entry_del(PrefixSource.RIB, p)
            ws.add(delta)
            for prefix, rib in upd.unicast_to_update.items():
                best = rib.best_entry
                if best is None:
                    continue
                if prefix in self._owned_count:
                    continue  # never shadow our own origination
                learned = {nh.area for nh in rib.nexthops if nh.area}
                dest = tuple(
                    sorted(
                        all_areas - learned - set(best.area_stack)
                    )
                )
                if not dest:
                    self._entry_del(PrefixSource.RIB, prefix)
                    continue
                entry = dataclasses.replace(
                    best,
                    metrics=dataclasses.replace(
                        best.metrics, distance=best.metrics.distance + 1
                    ),
                    area_stack=tuple(best.area_stack)
                    + tuple(sorted(learned)),
                )
                if self.policy is not None:
                    entry = self.policy.apply(entry)
                    if entry is None:
                        if self.counters:
                            self.counters.increment(
                                "prefixmgr.policy_denied"
                            )
                        # an accepted version must not linger once the
                        # policy rejects the update
                        self._entry_del(PrefixSource.RIB, prefix)
                        continue
                self._entry_set(PrefixSource.RIB, prefix, entry, dest)
                if self.counters:
                    self.counters.increment("prefixmgr.redistributed")
            for prefix in upd.unicast_to_delete:
                self._entry_del(PrefixSource.RIB, prefix)

    def _sync_originations(self) -> None:
        """Fold the ready config originations into the entry book, and
        take out those no longer ready."""
        for orig in self._originations:
            if orig.ready():
                entry = PrefixEntry(
                    prefix=orig.prefix,
                    metrics=_metrics_for(orig.cfg),
                    forwarding_type=orig.cfg.forwarding_type,
                    forwarding_algorithm=orig.cfg.forwarding_algorithm,
                    tags=tuple(orig.cfg.tags),
                )
                self._entry_set(PrefixSource.CONFIG, orig.prefix, entry, ())
                orig.advertised = True
            elif orig.advertised:
                self._entry_del(PrefixSource.CONFIG, orig.prefix)
                orig.advertised = False

    # -------------------------------------------------------- advertisement

    def _best_entries(self) -> dict[IpPrefix, tuple[PrefixEntry, tuple[str, ...]]]:
        """The winner of each prefix, read from the `_best` book."""
        return {p: (e, a) for p, (_s, e, a) in self._best.items()}

    def _sync_ranges(self) -> None:
        """Make the KvStore hold the range book: each range as chunked
        per-prefix-key PrefixDatabases, advertised again only when its
        template or areas moved."""
        want = {
            rkey: (rng, areas)
            for (_src, rkey), (rng, areas) in sorted(
                self._range_entries.items()
            )
        }
        all_areas = tuple(self.config.area_ids())
        for rkey, (rng, dest_areas) in want.items():
            areas = tuple(dest_areas or all_areas)
            prev = self._range_adv.get(rkey)
            if prev is not None:
                if prev[0].template == rng.template and prev[1] == areas:
                    continue
                stale = set(prev[1]) - set(areas)
                if stale:
                    self._withdraw_range_areas(prev[0], stale)
            chunks = 0
            for area in areas:
                for first, entries in rng.chunks():
                    key = C.prefix_key(self.node_name, area, first)
                    db = PrefixDatabase(
                        this_node_name=self.node_name,
                        prefix_entries=entries,
                        area=area,
                    )
                    self.kv_client.persist_key(
                        area, key, to_wire(db), ttl_ms=self.ttl_ms
                    )
                    chunks += 1
            self._range_adv[rkey] = (rng, areas)
            if self.counters:
                self.counters.increment("prefixmgr.range_chunks", chunks)
        for rkey in [k for k in self._range_adv if k not in want]:
            rng, areas = self._range_adv.pop(rkey)
            self._withdraw_range_areas(rng, areas)
        if self.counters:
            self.counters.set(
                "prefixmgr.range_prefixes",
                sum(len(r) for r, _a in self._range_adv.values()),
            )

    def _withdraw_range_areas(self, rng, areas) -> None:
        """Tombstone every chunk of `rng` in `areas`."""
        for area in areas:
            for first, entries in rng.chunks():
                key = C.prefix_key(self.node_name, area, first)
                tombstone = PrefixDatabase(
                    this_node_name=self.node_name,
                    prefix_entries=entries,
                    area=area,
                    delete_prefix=True,
                )
                self.kv_client.persist_key(
                    area, key, to_wire(tombstone), ttl_ms=self.ttl_ms
                )
                self.kv_client.unset_key(area, key)

    def _sync_advertisements(self) -> None:
        """Make the KvStore hold the entry book: only the prefixes in
        `_dirty_adv` are advertised again or tombstoned (the client keeps
        the others alive)."""
        self._sync_ranges()
        all_areas = tuple(self.config.area_ids())
        dirty = self._dirty_adv
        self._dirty_adv = set()
        with work_ledger.scope("redistribute", len(dirty)) as ws:
            ws.add(len(dirty))
            for prefix in dirty:
                best = self._best.get(prefix)
                want_areas = (
                    set(best[2] or all_areas) if best is not None else set()
                )
                adv = self._advertised.get(prefix, set())
                if best is not None:
                    entry = best[1]
                    for area in want_areas:
                        key = C.prefix_key(
                            self.node_name, area, str(prefix.prefix)
                        )
                        db = PrefixDatabase(
                            this_node_name=self.node_name,
                            prefix_entries=(entry,),
                            area=area,
                        )
                        self.kv_client.persist_key(
                            area, key, to_wire(db), ttl_ms=self.ttl_ms
                        )
                for area in adv - want_areas:
                    key = C.prefix_key(
                        self.node_name, area, str(prefix.prefix)
                    )
                    tombstone = PrefixDatabase(
                        this_node_name=self.node_name,
                        prefix_entries=(PrefixEntry(prefix=prefix),),
                        area=area,
                        delete_prefix=True,
                    )
                    # the tombstone once (its version beats the value
                    # everywhere), then no refresh: it dies by TTL
                    self.kv_client.persist_key(
                        area, key, to_wire(tombstone), ttl_ms=self.ttl_ms
                    )
                    self.kv_client.unset_key(area, key)
                if want_areas:
                    self._advertised[prefix] = want_areas
                else:
                    self._advertised.pop(prefix, None)
        if self.counters:
            self.counters.set("prefixmgr.advertised", len(self._advertised))
            self.counters.set(
                "prefixmgr.redistribute.book_size", len(self._entries)
            )
            work_ledger.export_to(self.counters)

    # ------------------------------------------------------------ accessors

    def get_advertised(self) -> dict[IpPrefix, PrefixEntry]:
        return {p: e for p, (e, _a) in self._best_entries().items()
                if p in self._advertised}


def _metrics_for(cfg: OriginatedPrefix) -> PrefixMetrics:
    return PrefixMetrics(
        path_preference=cfg.path_preference,
        source_preference=cfg.source_preference,
    )

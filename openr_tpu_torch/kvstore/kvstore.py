"""The KvStore module: peering, flooding, sync, TTL (the port's copy of
`openr_tpu/kvstore/kvstore.py`).

KvStore owns one KvStoreDb per area; peers arrive as PeerEvents (from
LinkMonitor, or `add_peer_sync`); each peer gets a full sync on add and
incremental floods afterwards (split horizon by the publication's
node_ids loop guard), and an anti-entropy re-sync every
`sync_interval_s`. Floods to a peer go through its pending buffer,
coalesced by key and drained by one task under a token bucket
(`flood_rate_msgs_per_sec`, `flood_rate_burst_size`); a buffer past
`flood_pending_max_keys` is dropped and repaired by a full sync. Local
subscribers (Decision, clients) receive every accepted update on the
publications queue. KvStore holds no device state: it runs on the event
loop, and a Decision behind it solves in its own worker threads.

Peers are reached through the transport the store was given:
`InProcKvTransport` in process, `TcpKvTransport` over the port's `rpc/`,
with `register_rpc` putting the store's handlers on a node's
`RpcServer` (full sync, flood, DUAL, flood topology). Counters keep the
JAX package's `kvstore.*` names. Not part of the port yet: the
flight-recorder records at the store's record sites, and the cross-node
flood spans: the port's store does not sample them
(`trace_sample_every > 0` raises) and does not stamp its hop into a
span a JAX peer sampled. A relayed publication that carries such a span
(`perf_events.span_bin`) gets no KVSTORE_FLOODED marker, as in the JAX
package, and is flooded on with its span and events as they came.
"""

from __future__ import annotations

import asyncio
import logging
import time
from dataclasses import dataclass, field
from typing import Any

from openr_tpu_torch.common.backoff import ExponentialBackoff, stable_rng
from openr_tpu_torch.common.constants import DEFAULT_AREA
from openr_tpu_torch.common.eventbase import OpenrModule
from openr_tpu_torch.config import Config
from openr_tpu_torch.kvstore.floodtopo import FloodTopo
from openr_tpu_torch.kvstore.store import KvStoreDb
from openr_tpu_torch.kvstore.transport import (
    decode_flood_params,
    pub_from_json,
    pub_to_json,
    pub_wire_bin,
)
from openr_tpu_torch.messaging import QueueClosedError, ReplicateQueue
from openr_tpu_torch.monitor import perf, work_ledger
from openr_tpu_torch.rpc import RpcError, RpcTransportError
from openr_tpu_torch.types.kvstore import KeyDumpParams, Publication, Value
from openr_tpu_torch.types.serde import from_jsonable, to_jsonable

log = logging.getLogger(__name__)


@dataclass
class PeerSpec:
    """A peer: its name, its transport endpoint (None in process) and
    area."""

    node_name: str
    endpoint: Any = None  # transport-specific (None for in-proc)
    area: str = DEFAULT_AREA


@dataclass
class PeerEvent:
    """Peer changes (LinkMonitor → KvStore)."""

    peers_to_add: list[PeerSpec] = field(default_factory=list)
    peers_to_del: list[str] = field(default_factory=list)
    area: str = DEFAULT_AREA


class _Peer:
    def __init__(self, spec: PeerSpec, owner: str = ""):
        self.spec = spec
        self.session = None
        self.synced = False
        # jittered: after a partition heals, every peer on the losing
        # side has an identical failure history — without jitter they
        # all re-sync at the same instant (thundering herd). RNG seeded
        # from (owner, peer): decorrelated across pairs, reproducible
        # across runs (seeded-soak replay)
        self.backoff = ExponentialBackoff(
            100, 30_000, jitter=True,
            rng=stable_rng(owner, spec.node_name, "kv-sync"),
        )
        self.flood_failures = 0
        self.sync_task: "asyncio.Task | None" = None
        # a completed full sync unlocks the anti-entropy noop probe:
        # later re-syncs open with a digestless store-hash compare and
        # only ship the per-key digest on mismatch
        self.probe_ok = False
        # legacy-responder fallback: a
        # pre-delta peer rejects the compact triple digest (its
        # value_from_json chokes on a list), surfacing as a handler
        # error — after one such rejection this peer's syncs use the
        # old hash-only Value-dict digest, which BOTH builds accept.
        # Reset on peer flap (the _Peer is rebuilt), so an upgraded
        # neighbor is re-probed with the delta form.
        self.legacy_sync = False
        # set after the first successful transport connect: a later
        # successful connect on the SAME _Peer is a reconnect (the far
        # process died and came back, or the TCP session was torn down
        # mid-flood) — counted as kvstore.peer_reconnects so kill/
        # restart chaos is observable separately from first contact
        self.ever_connected = False
        # pending flood state (coalesced by key: versions only grow, so
        # replacing an unsent value with a newer one is always correct)
        self.pending_keys: dict[str, Value] = {}
        self.pending_expired: set[str] = set()
        self.pending_perf = None  # merged trace of the pending backlog
        # serialize-once fast path: when the pending buffer holds
        # exactly one unmerged Publication, this is THAT object — its
        # cached wire frame (already encoded, and shared with every
        # other peer that adopted it wholesale) goes out verbatim.
        # Any coalescing on top voids it and the drain falls back to
        # rebuilding a per-peer Publication from the merged buffer.
        self.pending_src: "Publication | None" = None
        self.flood_wake = asyncio.Event()
        self.flood_task: "asyncio.Task | None" = None


class KvStore(OpenrModule):
    """One node's KvStore across all configured areas."""

    def __init__(
        self,
        config: Config,
        transport,
        publications_queue: ReplicateQueue,
        peer_events_reader=None,
        counters=None,
    ):
        if config.node.kvstore.trace_sample_every > 0:
            raise ValueError(
                "KvStore: trace_sample_every > 0 stamps cross-node flood "
                "spans, which are not part of the port"
            )
        super().__init__(f"{config.node_name}.kvstore", counters=counters)
        self.config = config
        self.node_name = config.node_name
        self.transport = transport
        self.pub_queue = publications_queue
        self.peer_events_reader = peer_events_reader
        self.dbs: dict[str, KvStoreDb] = {
            a: KvStoreDb(a, counters=counters) for a in config.area_ids()
        }
        self.peers: dict[tuple[str, str], _Peer] = {}  # (area, node) -> peer
        self.initial_sync_done = asyncio.Event()
        self.flood_topos: dict[str, FloodTopo] = {}
        if config.node.kvstore.enable_flood_optimization:
            kcfg = config.node.kvstore
            is_root = (
                self.node_name in kcfg.flood_root_candidates
                if kcfg.flood_root_candidates
                else kcfg.is_flood_root
            )
            self.flood_topos = {
                a: FloodTopo(a, self, is_root)
                for a in config.area_ids()
            }

    # ------------------------------------------------------------------ run

    async def main(self) -> None:
        if self.peer_events_reader is not None:
            self.spawn(self._peer_event_loop(), name=f"{self.name}.peers")
        self.run_every(1.0, self._ttl_tick, name=f"{self.name}.ttl")
        if self.flood_topos:
            self.run_every(
                5.0, self._flood_topo_tick, name=f"{self.name}.dualTick"
            )
        sync_s = self.config.node.kvstore.sync_interval_s
        self.run_every(sync_s, self._anti_entropy, name=f"{self.name}.sync")
        self.spawn(self._initial_sync_grace(), name=f"{self.name}.grace")

    async def _initial_sync_grace(self) -> None:
        """KVSTORE_SYNCED signal for the no-peer case: peers arrive via
        spawned event loops AFTER main() returns, so an immediate
        `not self.peers` check would always fire. Wait a grace period; if
        no peer has shown up by then, this node is alone and the store is
        trivially synced."""
        await asyncio.sleep(self.config.node.kvstore.initial_sync_grace_s)
        if not self.peers:
            self.initial_sync_done.set()

    async def cleanup(self) -> None:
        for peer in self.peers.values():
            if peer.flood_task is not None and not peer.flood_task.done():
                peer.flood_task.cancel()
            if peer.session is not None:
                try:
                    await peer.session.close()
                except asyncio.CancelledError:
                    raise  # cleanup itself is being cancelled
                except Exception:  # noqa: BLE001
                    pass
        self.peers.clear()

    async def _peer_event_loop(self) -> None:
        while True:
            try:
                ev: PeerEvent = await self.peer_events_reader.get()
            except QueueClosedError:
                return
            for name in ev.peers_to_del:
                await self._del_peer(ev.area, name)
            for spec in ev.peers_to_add:
                await self._add_peer(spec)

    # ---------------------------------------------------------------- peers

    async def _add_peer(self, spec: PeerSpec) -> None:
        key = (spec.area, spec.node_name)
        existing = self.peers.get(key)
        if existing is not None:
            if existing.spec.endpoint == spec.endpoint:
                return
            # same neighbor, NEW endpoint: a graceful restart holds the
            # adjacency (the peer is never deleted), but the restarted
            # process binds fresh ephemeral ports — NEIGHBOR_RESTARTED
            # re-advertises them here. Without this teardown the old
            # _Peer's sync loop would retry the dead endpoint until its
            # backoff saturated, permanently (seen only across real
            # process boundaries; the in-proc transport keys by name)
            log.info(
                "%s: peer %s moved %s -> %s, re-peering",
                self.name, spec.node_name,
                existing.spec.endpoint, spec.endpoint,
            )
            await self._del_peer(spec.area, spec.node_name)
        if spec.area not in self.dbs:
            # area mismatch between neighbors: reject instead of letting the
            # sync fiber crash-loop on a missing KvStoreDb
            log.warning(
                "%s: peer %s in unconfigured area %r ignored",
                self.name, spec.node_name, spec.area,
            )
            if self.counters is not None:
                self.counters.increment("kvstore.peers_rejected_bad_area")
            return
        peer = _Peer(spec, owner=self.node_name)
        self.peers[key] = peer
        if self.counters is not None:
            self.counters.increment("kvstore.peers_added")
        self._spawn_sync(peer)

    def _spawn_sync(self, peer: _Peer) -> None:
        """One sync task per peer at a time (a down peer's retry loop must
        not accumulate duplicates across anti-entropy ticks)."""
        if peer.sync_task is not None and not peer.sync_task.done():
            return
        peer.sync_task = self.spawn(
            self._sync_with_peer(peer),
            name=f"{self.name}.sync.{peer.spec.node_name}",
        )

    async def _del_peer(self, area: str, node_name: str) -> None:
        peer = self.peers.pop((area, node_name), None)
        if peer is None:
            return
        if peer.sync_task is not None and not peer.sync_task.done():
            peer.sync_task.cancel()  # no orphaned retry loops/sessions
        if peer.flood_task is not None and not peer.flood_task.done():
            peer.flood_task.cancel()
        if peer.session is not None:
            try:
                await peer.session.close()
            except asyncio.CancelledError:
                raise  # _del_peer's caller is being cancelled
            except Exception:  # noqa: BLE001
                pass
        if self.counters is not None:
            self.counters.increment("kvstore.peers_removed")
        ft = self.flood_topos.get(area)
        if ft is not None:
            ft.peer_down(node_name)
        # the departed peer may have been the last unsynced one
        self._maybe_initial_sync_done()

    def add_peer_sync(self, spec: PeerSpec) -> None:
        """Test/emulator convenience: schedule a peer add."""
        self.spawn(self._add_peer(spec))

    # ----------------------------------------------------------- full sync

    async def _sync_with_peer(self, peer: _Peer) -> None:
        """The full-sync state machine, with backoff."""
        area = peer.spec.area
        db = self.dbs[area]
        key = (area, peer.spec.node_name)
        # identity check (not just membership): a peer flap replaces the
        # _Peer under the same key; the stale task must exit
        while not self.stopped and self.peers.get(key) is peer:
            wait = peer.backoff.time_remaining_s()
            if wait > 0:
                await asyncio.sleep(wait)
            try:
                if peer.session is None:
                    peer.session = await self.transport.connect(
                        peer.spec.node_name, peer.spec.endpoint,
                        counters=self.counters,
                    )
                    if peer.ever_connected:
                        if self.counters is not None:
                            self.counters.increment(
                                "kvstore.peer_reconnects"
                            )
                    peer.ever_connected = True
                own_hash = db.store_hash()
                # delta sync: after the first successful
                # sync, open with a digestless store-hash probe — a
                # converged pair answers "noop" for a handful of bytes
                # instead of re-shipping the whole per-key digest every
                # anti-entropy round. A peer flagged legacy_sync gets
                # the pre-delta hash-only Value-dict digest instead
                # (old responders reject the triple form).
                if peer.legacy_sync:
                    digest = {
                        k: pub_to_json_value(v)
                        for k, v in db.digest().items()
                    }
                    if self.counters is not None:
                        self.counters.increment("kvstore.full_syncs_legacy")
                else:
                    digest = None if peer.probe_ok else db.digest_triples()
                raw = await peer.session.full_sync(
                    area, self.node_name, digest, store_hash=own_hash
                )
                if isinstance(raw, dict) and raw.get("need_digest"):
                    # probe missed: peer's store differs — one more
                    # round trip with the real digest (same attempt, no
                    # backoff penalty)
                    if self.counters is not None:
                        self.counters.increment(
                            "kvstore.full_sync_probe_miss"
                        )
                    # recompute the hash for the retry: a flood landing
                    # during the probe await may have moved our store,
                    # and a stale hash could spuriously match the
                    # responder's post-convergence state
                    raw = await peer.session.full_sync(
                        area, self.node_name, db.digest_triples(),
                        store_hash=db.store_hash(),
                    )
                if isinstance(raw, dict) and raw.get("noop"):
                    if self.counters is not None:
                        self.counters.increment("kvstore.full_syncs_noop")
                pub = pub_from_json(raw)
                self._apply(area, pub, from_peer=peer.spec.node_name)
                # send back what the peer asked for (3-way sync)
                if pub.to_be_updated_keys:
                    want = db.dump(
                        KeyDumpParams(keys=list(pub.to_be_updated_keys))
                    )
                    if want:
                        await peer.session.flood(
                            Publication(
                                area=area,
                                key_vals=want,
                                node_ids=[self.node_name],
                            )
                        )
                peer.synced = True
                # legacy responders ignore a digestless probe's intent
                # (None digest reads as empty → they dump their whole
                # store), so only delta-capable pairs unlock it
                peer.probe_ok = not peer.legacy_sync
                peer.backoff.report_success()
                # un-gate the flood pump: publications buffered while the
                # peer was sessionless flush now, as one coalesced batch
                peer.flood_wake.set()
                if self.counters is not None:
                    self.counters.increment("kvstore.full_syncs")
                ft = self.flood_topos.get(area)
                if ft is not None:
                    ft.peer_up(peer.spec.node_name)
                self._maybe_initial_sync_done()
                return
            except asyncio.CancelledError:
                raise
            except Exception as e:  # noqa: BLE001
                log.debug("%s: sync with %s failed: %s", self.name, peer.spec.node_name, e)
                # a handler-level rejection (plain RpcError — the peer
                # ANSWERED with an error) from a peer we offered the
                # delta digest most likely means a pre-delta build
                # choked on the triple form — retry in the legacy
                # format, which every build accepts. RpcTransportError is excluded: a
                # connection that died mid-call (peer SIGKILLed, RST,
                # timeout) says nothing about what the peer supports,
                # and misclassifying it would permanently lock a
                # delta-capable neighbor onto the O(store) legacy
                # digest after every crash
                if (
                    not peer.legacy_sync
                    and isinstance(e, RpcError)
                    and not isinstance(e, RpcTransportError)
                ):
                    peer.legacy_sync = True
                peer.backoff.report_error()
                if peer.session is not None:
                    peer.session = None
                    if self.counters is not None:
                        self.counters.increment("kvstore.peer_disconnects")
                if self.counters is not None:
                    self.counters.increment("kvstore.full_sync_failures")

    def _maybe_initial_sync_done(self) -> None:
        # true also for the peers-all-deleted case (vacuous all())
        if all(p.synced for p in self.peers.values()):
            self.initial_sync_done.set()

    async def _anti_entropy(self) -> None:
        """Periodic re-sync with all peers (the anti-entropy repair
        path)."""
        for peer in list(self.peers.values()):
            if peer.sync_task is not None and not peer.sync_task.done():
                continue  # previous sync still running/retrying
            peer.synced = False
            self._spawn_sync(peer)

    # ------------------------------------------------------------- flooding

    def _apply(
        self, area: str, pub: Publication, from_peer: str | None
    ) -> dict[str, Value]:
        db = self.dbs.get(area)
        if db is None:
            return {}
        accepted, _stale = db.merge(pub.key_vals)
        if accepted or pub.expired_keys:
            pe = pub.perf_events
            # a relayed flood that carries a JAX node's sampled flood span
            # is not stamped: there the span's hop record stands for the
            # marker, as in the JAX package (which stamps the hop into
            # the span; the port carries the span as it came). A local
            # write and an untraced relay are stamped.
            relayed_span = from_peer is not None and pe is not None \
                and bool(pe.span_bin)
            if pe is not None and not relayed_span:
                pe.add_perf_event(perf.KVSTORE_FLOODED, node=self.node_name)
            out = Publication(
                area=area,
                key_vals=accepted,
                expired_keys=list(pub.expired_keys),
                node_ids=list(pub.node_ids),
                perf_events=pe,
            )
            if self.node_name not in out.node_ids:
                out.node_ids.append(self.node_name)
            if not self._publish(out):
                return accepted  # stopping: merged, not notifiable
            self._flood(area, out, exclude=from_peer)
        return accepted

    def _publish(self, pub: Publication) -> bool:
        """Push to the local publication queue, tolerating the shutdown
        race (observed in 49-node emulator teardown): a peer's set_key,
        a ttl expiry, or a flood can land after stop() closed our
        queue — the merge itself already happened (correct for a
        restarting node; GR keeps the LSDB), only the notification is
        undeliverable. Returns False when dropped."""
        try:
            self.pub_queue.push(pub)
        except QueueClosedError:
            if not self.stopped:
                raise
            return False
        return True

    def _flood(
        self, area: str, pub: Publication, exclude: str | None
    ) -> None:
        """Split-horizon flood to synced peers: skip the sender and anyone
        in node_ids. With flood optimization on, restrict to the DUAL
        spanning-tree peers (parent + registered children) — O(V) network
        messages per update instead of O(E).

        Delivery is via a per-peer pending queue drained by one ordered
        task per peer with a token bucket: under churn, updates to
        the same key coalesce while waiting, so the wire carries the
        newest version at the allowed rate instead of every intermediate
        one."""
        ft = self.flood_topos.get(area)
        spt: set[str] | None = ft.flood_peers() if ft is not None else None
        targets = [
            peer
            for (parea, pname), peer in self.peers.items()
            if parea == area
            and pname != exclude
            and pname not in pub.node_ids
            and (spt is None or pname in spt)
        ]
        if any(
            getattr(p.session, "codec", None) == "bin" for p in targets
        ):
            # serialize-once: encode the publication NOW,
            # synchronously — before Decision/Fib (draining the local
            # queue) stamp their perf markers on the shared trace, and
            # exactly once for all N fan-out targets. Every drain pump
            # that adopts this publication wholesale ships these bytes.
            # Gated on a NEGOTIATED binary session existing (not the
            # transport's preference): an all-JSON peer set would pay
            # this encode for a frame nobody ships
            pub_wire_bin(pub, self.counters)
        for peer in targets:
            # sessionless (backed-off / reconnecting) peers still get the
            # update QUEUED: it coalesces into the per-peer pending
            # buffer and flushes when the sync task re-establishes the
            # session — one merged message instead of a thundering
            # replay (flood throttling; the buffer stays bounded by
            # flood_pending_max_keys below)
            self._enqueue_flood(peer, pub)

    def _enqueue_flood(self, peer: _Peer, pub: Publication) -> None:
        """Merge one publication into the peer's pending-flood buffer.

        Version-dominant per key (the same total order as
        store.merge_key_values): a queued value is only replaced by one
        that would win the merge, so out-of-order local enqueues can
        never regress what the peer eventually receives."""
        # serialize-once eligibility: an EMPTY buffer adopting this
        # publication wholesale can flood pub's pre-encoded frame
        # verbatim; anything already buffered means the drain must
        # rebuild a coalesced per-peer publication instead
        fresh = (
            not peer.pending_keys
            and not peer.pending_expired
            and peer.pending_perf is None
        )
        coalesced = 0
        for k, v in pub.key_vals.items():
            cur = peer.pending_keys.get(k)
            if cur is not None:
                coalesced += 1
                v.with_hash()
                cur.with_hash()
                if (
                    v.value is None
                    and (v.version, v.originator_id, v.hash)
                    == (cur.version, cur.originator_id, cur.hash)
                ):
                    # ttl refresh of the buffered payload: fold the newer
                    # ttl into the queued FULL value — replacing it with
                    # the hash-only refresh would strand the peer on a
                    # payload it now can only get via anti-entropy
                    if v.ttl_version > cur.ttl_version:
                        peer.pending_keys[k] = Value(
                            version=cur.version,
                            originator_id=cur.originator_id,
                            value=cur.value,
                            ttl=v.ttl,
                            ttl_version=v.ttl_version,
                            hash=cur.hash,
                        )
                    peer.pending_expired.discard(k)
                    continue
                if (v.version, v.originator_id, v.hash, v.ttl_version) < (
                    cur.version, cur.originator_id, cur.hash, cur.ttl_version
                ):
                    continue  # queued value already dominates
            peer.pending_keys[k] = v
            peer.pending_expired.discard(k)  # re-advertised: alive again
        peer.pending_expired.update(pub.expired_keys)
        if pub.perf_events is not None:
            # traces of coalesced publications merge, same as the keys.
            # Copied: the original keeps riding the LOCAL publication
            # queue where Decision/Fib stamp their markers — those must
            # not leak into the trace this peer receives
            peer.pending_perf = (
                pub.perf_events.copy()
                if peer.pending_perf is None
                else peer.pending_perf.merge(pub.perf_events)
            )
        peer.pending_src = (
            pub if fresh and pub._wire_cache is not None else None
        )
        if coalesced and self.counters is not None:
            self.counters.increment("kvstore.flood_keys_coalesced", coalesced)
        # backpressure: a peer that can't drain fast enough gets a bounded
        # queue; on overflow, drop the backlog and schedule a FULL_SYNC —
        # one dump repairs everything the dropped floods carried
        max_keys = self.config.node.kvstore.flood_pending_max_keys
        if len(peer.pending_keys) > max_keys:
            if self.counters is not None:
                self.counters.increment(
                    "kvstore.flood_backpressure_drops", len(peer.pending_keys)
                )
            peer.pending_keys.clear()
            peer.pending_expired.clear()
            peer.pending_src = None
            peer.synced = False
            self._spawn_sync(peer)
            return
        if peer.flood_task is None or peer.flood_task.done():
            peer.flood_task = self.spawn(
                self._flood_drain(peer),
                name=f"{self.name}.flood.{peer.spec.node_name}",
            )
        peer.flood_wake.set()

    async def _flood_drain(self, peer: _Peer) -> None:
        """Single ordered flood pump for one peer: token bucket + batch
        coalescing. All pending keys go out as ONE message per token."""
        kvconf = self.config.node.kvstore
        rate = kvconf.flood_rate_msgs_per_sec
        burst = max(1.0, float(kvconf.flood_rate_burst_size))
        tokens = burst
        last = asyncio.get_running_loop().time()
        key = (peer.spec.area, peer.spec.node_name)
        while not self.stopped and self.peers.get(key) is peer:
            if not peer.pending_keys and not peer.pending_expired:
                peer.flood_wake.clear()
                await peer.flood_wake.wait()
                continue
            if peer.session is None:
                # backed-off peer: hold the coalesced backlog — further
                # publications keep merging into it — until the sync
                # task re-establishes the session (it sets flood_wake);
                # the post-heal flush is ONE rate-limited message, not a
                # replay of every buffered publication
                if self.counters is not None:
                    self.counters.increment("kvstore.floods_held")
                peer.flood_wake.clear()
                if peer.session is None:  # re-check: no await raced us
                    await peer.flood_wake.wait()
                continue
            if rate > 0:
                now = asyncio.get_running_loop().time()
                tokens = min(burst, tokens + (now - last) * rate)
                last = now
                if tokens < 1.0:
                    if self.counters is not None:
                        self.counters.increment("kvstore.floods_rate_limited")
                    await asyncio.sleep((1.0 - tokens) / rate)
                    continue
                tokens -= 1.0
            kv, peer.pending_keys = peer.pending_keys, {}
            exp, peer.pending_expired = peer.pending_expired, set()
            pe, peer.pending_perf = peer.pending_perf, None
            src, peer.pending_src = peer.pending_src, None
            if src is not None and (
                getattr(peer.session, "codec", None) == "bin"
            ):
                # serialize-once fast path: the buffer holds exactly one
                # unmerged publication whose wire frame was encoded at
                # fan-out time — every peer in this state ships the SAME
                # immutable bytes (pe is the defensive trace copy of
                # src.perf_events; the frozen frame supersedes it).
                # Gated on the SESSION's negotiated codec, not the
                # transport's preference: a JSON-negotiated old peer
                # would re-serialize src freshly — leaking the live
                # shared trace the rebuild path's pe copy exists to
                # protect — so it takes the rebuild branch instead
                pub = src
            else:
                # node_ids carries only us: per-key provenance is lost
                # when coalescing across publications, and understating
                # node_ids is safe — a duplicate delivery is rejected by
                # merge() and never re-flooded, so loops still terminate
                pub = Publication(
                    area=peer.spec.area,
                    key_vals=kv,
                    expired_keys=sorted(exp),
                    node_ids=[self.node_name],
                    perf_events=pe,
                )
            session = peer.session
            if session is None:
                # session died during the rate-limit wait: fold the batch
                # back under whatever newer values landed meanwhile and
                # hold until the sync task restores the session. An
                # expiry only comes back for keys NOT re-advertised in
                # the interim — pending_keys is the newer word
                for k, v in kv.items():
                    peer.pending_keys.setdefault(k, v)
                peer.pending_expired |= exp - peer.pending_keys.keys()
                if pe is not None:
                    peer.pending_perf = (
                        pe if peer.pending_perf is None
                        else pe.merge(peer.pending_perf)
                    )
                continue
            try:
                t0 = asyncio.get_running_loop().time()
                nbytes = await session.flood(pub)
                if self.counters is not None:
                    self.counters.increment("kvstore.floods_sent")
                    if nbytes:
                        # wire-derived (the session reports the actual
                        # frame size), so bench bytes/flood is counter
                        # math, not an estimate
                        self.counters.increment(
                            "kvstore.flood_bytes", nbytes
                        )
                    self.counters.add_value(
                        "kvstore.flood_fanout_ms",
                        (asyncio.get_running_loop().time() - t0) * 1e3,
                    )
            except asyncio.CancelledError:
                raise
            except Exception as exc:  # noqa: BLE001
                peer.flood_failures += 1
                peer.synced = False
                if self.counters is not None:
                    self.counters.increment("kvstore.flood_failures")
                # drop the session only if it is still the one that
                # failed: a concurrent sync may have already torn it
                # down (counted there) or re-established a fresh one
                # that must not be clobbered
                if peer.session is session:
                    peer.session = None
                    if self.counters is not None:
                        self.counters.increment("kvstore.peer_disconnects")
                ft = self.flood_topos.get(peer.spec.area)
                if ft is not None:
                    ft.peer_down(peer.spec.node_name)
                # re-sync repairs whatever the failed flood carried
                peer.pending_keys.clear()
                peer.pending_expired.clear()
                peer.pending_src = None
                self._spawn_sync(peer)

    # ---------------------------------------------------- transport handlers

    async def handle_full_sync(self, params: dict) -> dict:
        """Respond to a peer's full-sync request.

        Delta protocol: the requester ships a
        (key → [version, originator, hash]) digest and gets back ONLY
        missing/newer entries plus a ``store_hash`` trailer. A
        digestless request whose ``store_hash`` matches ours short-
        circuits to a noop reply (the anti-entropy fast path); on
        mismatch the responder asks for the digest (``need_digest``).
        Legacy peers that send hash-only Value dicts — or no
        store_hash at all — take the same compare path unchanged."""
        area = params["area"]
        digest_raw = params.get("digest")
        db = self.dbs.get(area)
        if db is None:
            return pub_to_json(Publication(area=area))
        own_hash = db.store_hash()
        their_hash = params.get("store_hash")
        # the noop short-circuit serves DIGESTLESS probes only: a
        # request that carries a digest gets the full compare even on
        # hash match — the requester may have moved since it computed
        # the hash, and discarding its fresh digest would strand the
        # 3-way exchange until the next anti-entropy round
        if digest_raw is None and their_hash is not None and their_hash == own_hash:
            if self.counters is not None:
                self.counters.increment("kvstore.full_syncs_served")
                self.counters.increment("kvstore.full_syncs_noop_served")
            out = pub_to_json(
                Publication(area=area, node_ids=[self.node_name])
            )
            out["store_hash"] = own_hash
            out["noop"] = True
            return out
        if digest_raw is None:
            # probe miss from a delta-capable peer: ask for the digest
            out = pub_to_json(
                Publication(area=area, node_ids=[self.node_name])
            )
            out["store_hash"] = own_hash
            out["need_digest"] = True
            return out
        theirs = {
            k: _digest_entry(v) for k, v in digest_raw.items()
        }
        to_send: dict[str, Value] = {}
        they_need: list[str] = []
        ours = db.kv
        # work ledger `full_sync` stage: the anti-entropy compare walks
        # both digests (touched); the delta is what actually moves — set
        # once the two walks below have decided it
        with work_ledger.scope("full_sync") as ws:
            ws.add(len(ours) + len(theirs))
            for k, v in db.dump().items():
                t = theirs.get(k)
                if t is None:
                    to_send[k] = v
                    continue
                have = (ours[k].version, ours[k].originator_id, ours[k].with_hash().hash)
                if have > t:
                    to_send[k] = v
            for k, t in theirs.items():
                cur = ours.get(k)
                if cur is None:
                    they_need.append(k)
                else:
                    have = (cur.version, cur.originator_id, cur.with_hash().hash)
                    if t > have:
                        they_need.append(k)
            ws.set_delta(len(to_send) + len(they_need))
        pub = Publication(
            area=area,
            key_vals=to_send,
            node_ids=[self.node_name],
            to_be_updated_keys=they_need,
        )
        if self.counters is not None:
            self.counters.increment("kvstore.full_syncs_served")
            self.counters.increment(
                "kvstore.full_sync_keys_sent", len(to_send)
            )
            work_ledger.export_to(self.counters)
        out = pub_to_json(pub)
        out["store_hash"] = own_hash
        return out

    async def handle_flood(self, params: dict) -> None:
        t0 = time.perf_counter()
        pub = decode_flood_params(params)
        sender = pub.node_ids[-1] if pub.node_ids else None
        if self.counters is not None:
            self.counters.increment("kvstore.floods_received")
            # pure-CPU decode cost of the wire seam (no awaits inside:
            # not inflated by event-loop queueing the way the wall-
            # clock kvstore.flood_fanout_ms latency stat is)
            self.counters.add_value(
                "kvstore.flood_decode_ms",
                (time.perf_counter() - t0) * 1e3,
            )
        self._apply(pub.area, pub, from_peer=sender)

    async def handle_dual_messages(self, params: dict) -> None:
        ft = self.flood_topos.get(params["area"])
        if ft is not None:
            ft.handle_messages(params["sender"], params["msgs"])

    async def handle_flood_topo_set(self, params: dict) -> None:
        ft = self.flood_topos.get(params["area"])
        if ft is not None:
            ft.handle_topo_set(
                params["root"], params["child"], bool(params["set"])
            )

    def register_rpc(self, server) -> None:
        """Put the store's transport handlers on a node's RpcServer."""

        async def full_sync(params):
            return await self.handle_full_sync(params)

        async def flood(params):
            await self.handle_flood(params)
            return None

        async def dual(params):
            await self.handle_dual_messages(params)
            return None

        async def flood_topo_set(params):
            await self.handle_flood_topo_set(params)
            return None

        server.register("kv.fullSync", full_sync)
        server.register("kv.flood", flood)
        server.register("kv.dual", dual)
        server.register("kv.floodTopoSet", flood_topo_set)

    # ------------------------------------------------------------ local API

    def set_key(
        self,
        area: str,
        key: str,
        value: Value,
        perf_events=None,
    ) -> bool:
        """Local write (client API). Returns True if accepted."""
        accepted = self._apply(
            area,
            Publication(
                area=area, key_vals={key: value}, perf_events=perf_events
            ),
            from_peer=None,
        )
        return key in accepted

    def get_peers(self, area: str) -> list[str]:
        """Peer node names in one area."""
        return [node for (a, node) in self.peers if a == area]

    def get_key(self, area: str, key: str) -> Value | None:
        db = self.dbs.get(area)
        return db.kv.get(key) if db else None

    def dump(self, area: str, params: KeyDumpParams | None = None) -> dict[str, Value]:
        db = self.dbs.get(area)
        return db.dump(params) if db else {}

    def get_flood_topo(self, area: str) -> dict:
        """SPT / flood-optimization dump."""
        ft = self.flood_topos.get(area)
        if ft is None:
            return {"enabled": False}
        return {"enabled": True, **ft.status()}

    def _flood_topo_tick(self) -> None:
        for area, ft in self.flood_topos.items():
            ft.tick()
            # flood optimization enabled but no electable root in sight
            # (e.g. the flood_root_candidates set names no live node):
            # the store silently floods full-mesh, which is correct but
            # defeats the operator-enabled optimization — surface it
            if self.peers and ft.dual.pick_flood_root() is None:
                if self.counters:
                    self.counters.increment("kvstore.flood_root_missing")
                if not getattr(self, "_warned_no_flood_root", False):
                    self._warned_no_flood_root = True
                    log.warning(
                        "%s: flood optimization enabled in area %s but no "
                        "flood root is electable (check is_flood_root / "
                        "flood_root_candidates) — falling back to "
                        "full-mesh flooding",
                        self.name, area,
                    )

    # ------------------------------------------------------------------ TTL

    def _ttl_tick(self) -> None:
        for area, db in self.dbs.items():
            dead = db.expire_keys()
            if dead:
                pub = Publication(
                    area=area,
                    expired_keys=dead,
                    node_ids=[self.node_name],
                )
                self._publish(pub)
                # expiry is local-clock-driven on every store; no flood


def _digest_entry(raw) -> tuple:
    """One full-sync digest entry → (version, originator, hash).
    Accepts both the compact triple form this build sends and the
    legacy hash-only Value dict an old peer ships."""
    if isinstance(raw, (list, tuple)) and len(raw) == 3:
        return (raw[0], raw[1], raw[2])
    v = value_from_json(raw)
    return (v.version, v.originator_id, v.hash)


def pub_to_json_value(v: Value) -> dict:
    return to_jsonable(v)


def value_from_json(raw: dict) -> Value:
    return from_jsonable(raw, Value)

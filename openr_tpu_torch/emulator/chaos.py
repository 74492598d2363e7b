"""Seeded, replayable chaos over the emulator's three I/O seams (the
port's copy of `openr_tpu/emulator/chaos.py`):

  * ``ChaosPlan``: one seeded RNG namespace and a deterministic fault
    schedule. The same seed and storm arguments give the same schedule
    (`schedule_hash`, byte-equal to the JAX package's), and every failure
    message of the invariant checker carries the seed to replay the run.
  * ``ChaosIoHub``: a MockIoHub whose delivery seam drops, delays
    (reorders) or duplicates Spark packets per link.
  * ``ChaosKvTransport`` / ``_ChaosKvSession``: a per-node wrapper of
    InProcKvTransport with failed ``full_sync`` / ``flood`` calls (the
    session is torn down by KvStore's own recovery), delivery delay and
    hard partition blocks.
  * ``ChaosFibHandler``: a MockFibHandler with the plan's seeded failure
    rate, gated by ``plan.active`` so the cluster can quiesce for the
    invariant check.
  * ``run_schedule``: runs a schedule against a Cluster in real time.

The disk-fault seam (``n_disk_faults``, ``disk_injector``) needs
`persist/`, which the port does not have yet: asking for it raises
NotImplementedError naming the module.

The schedule comes from the seed alone. Per-packet fault decisions use
seeded substreams too, but their interleaving follows runtime packet
order: a replayed seed reproduces the storm's shape and fault rates,
not a byte-identical packet log.
"""

from __future__ import annotations

import asyncio
import hashlib
import logging
import random
from dataclasses import dataclass

from openr_tpu_torch.fib.fib import MockFibHandler
from openr_tpu_torch.spark.io import MockIoHub

log = logging.getLogger(__name__)


# --------------------------------------------------------------- fault knobs


@dataclass(frozen=True)
class LinkFaults:
    """Per-delivery Spark packet faults (probabilities in [0, 1])."""

    drop: float = 0.0  # P(packet silently dropped)
    dup: float = 0.0  # P(packet delivered twice)
    reorder: float = 0.0  # P(packet held back by up to jitter_ms)
    jitter_ms: float = 0.0  # max hold-back for reordered packets


@dataclass(frozen=True)
class KvFaults:
    """KvStore peer-session faults (probabilities in [0, 1])."""

    fail_full_sync: float = 0.0  # P(full_sync raises ConnectionError)
    fail_flood: float = 0.0  # P(flood raises ConnectionError)
    delay_ms: float = 0.0  # max uniform delivery delay per call


@dataclass(frozen=True)
class FibFaults:
    fail_rate: float = 0.0  # P(one FibService op raises FibProgramError)


@dataclass(frozen=True)
class ChaosEvent:
    """One scheduled structural fault, relative to storm start."""

    at_s: float
    kind: str  # fail_link | heal_link | crash | restart | partition | heal_partition | disk_fault
    target: tuple = ()


#: the JAX package's storm-safe disk faults (its persist/faults.py),
#: kept so a schedule's shape matches the reference's
DISK_FAULT_KINDS = ("torn", "corrupt", "enospc")


def _no_persist(what: str) -> NotImplementedError:
    return NotImplementedError(
        f"chaos: {what} needs persist/ (the durable-state plane and its "
        "disk faults), which is not part of the port yet"
    )


class ChaosPlan:
    """Seeded fault configuration + deterministic fault schedule.

    One plan drives all three seams. Rate-based faults (packet drops,
    kv call failures, fib failures) are gated by ``active`` — the storm
    runner clears it after the last scheduled event so the cluster can
    quiesce; structural faults (downed links, partitions, crashed
    nodes) are only undone by their own heal/restart events.
    """

    def __init__(
        self,
        seed: int,
        link_faults: LinkFaults | None = None,
        kv_faults: KvFaults | None = None,
        fib_faults: FibFaults | None = None,
        link_overrides: dict | None = None,
    ):
        self.seed = int(seed)
        self.link_faults = link_faults or LinkFaults()
        self.kv_faults = kv_faults or KvFaults()
        self.fib_faults = fib_faults or FibFaults()
        # frozenset({a, b}) -> LinkFaults, overriding the default per link
        self.link_overrides: dict[frozenset, LinkFaults] = dict(
            link_overrides or {}
        )
        self.active = True
        self.events: tuple[ChaosEvent, ...] = ()
        self.stats: dict[str, int] = {}
        self._streams: dict[str, random.Random] = {}
        self._kv_blocked: set[frozenset] = set()

    # ------------------------------------------------------------ randomness

    def rng(self, stream: str) -> random.Random:
        """Named deterministic substream: seeded from (seed, stream), so
        one seam's consumption never perturbs another's."""
        r = self._streams.get(stream)
        if r is None:
            digest = hashlib.sha256(
                f"{self.seed}/{stream}".encode()
            ).digest()
            r = self._streams[stream] = random.Random(
                int.from_bytes(digest[:8], "big")
            )
        return r

    def note(self, what: str, n: int = 1) -> None:
        self.stats[what] = self.stats.get(what, 0) + n

    # ------------------------------------------------------------- partition

    def block_kv(self, a: str, b: str) -> None:
        self._kv_blocked.add(frozenset((a, b)))

    def unblock_kv_all(self) -> None:
        self._kv_blocked.clear()

    def kv_blocked(self, a: str, b: str) -> bool:
        return frozenset((a, b)) in self._kv_blocked

    # -------------------------------------------------------------- schedule

    def build_storm(
        self,
        links,
        nodes=(),
        *,
        duration_s: float = 2.0,
        n_flaps: int = 0,
        n_crashes: int = 0,
        n_partitions: int = 0,
        heal_after_s: float = 0.6,
        graceful_crashes: bool | None = True,
        n_disk_faults: int = 0,
    ) -> tuple[ChaosEvent, ...]:
        """Deterministic storm schedule from the plan's seed: same seed +
        same arguments → the identical event list (see `schedule_hash`).

        `links` is an iterable of (a, b) node-name pairs; `nodes` the
        crash/partition candidate set. Crash targets are sampled without
        replacement, so no node is crashed while already down; each
        structural fault heals `heal_after_s` after it fires.
        `graceful_crashes`: True → every crash announces Spark GR,
        False → every crash is hard (hold-timer detection), None →
        seeded 50/50 mix.
        `n_disk_faults` > 0 raises NotImplementedError: the disk faults
        need `persist/`.
        """
        if n_disk_faults > 0:
            raise _no_persist("n_disk_faults > 0")
        rng = self.rng("schedule")
        links = sorted(tuple(sorted(l)) for l in links)
        # dedupe: callers often pass node lists derived from edge lists;
        # sampling positions of a multiset would break the
        # no-node-crashed-twice guarantee below
        nodes = sorted(set(nodes))
        ev: list[ChaosEvent] = []
        horizon = max(duration_s - heal_after_s, 0.01)
        for _ in range(n_flaps):
            a, b = links[rng.randrange(len(links))]
            t = round(rng.uniform(0, horizon), 4)
            ev.append(ChaosEvent(t, "fail_link", (a, b)))
            ev.append(
                ChaosEvent(round(t + heal_after_s, 4), "heal_link", (a, b))
            )
        victims = rng.sample(
            nodes, min(n_crashes + n_disk_faults, len(nodes))
        )
        for i, name in enumerate(victims):
            t = round(rng.uniform(0, horizon), 4)
            if i < n_crashes:
                graceful = (
                    rng.random() < 0.5
                    if graceful_crashes is None
                    else graceful_crashes
                )
            else:
                # disk-fault crash: arm the fault, then kill HARD — a
                # graceful shutdown would fsync/close around the damage
                kind = DISK_FAULT_KINDS[rng.randrange(len(DISK_FAULT_KINDS))]
                ev.append(ChaosEvent(t, "disk_fault", (name, kind)))
                t = round(t + 0.05, 4)
                graceful = False
            ev.append(ChaosEvent(t, "crash", (name, graceful)))
            ev.append(
                ChaosEvent(round(t + heal_after_s, 4), "restart", (name,))
            )
        for _ in range(n_partitions):
            t = round(rng.uniform(0, horizon), 4)
            shuffled = list(nodes)
            rng.shuffle(shuffled)
            cut = rng.randrange(1, max(len(shuffled), 2))
            g1 = tuple(sorted(shuffled[:cut]))
            g2 = tuple(sorted(shuffled[cut:]))
            ev.append(ChaosEvent(t, "partition", (g1, g2)))
            ev.append(
                ChaosEvent(round(t + heal_after_s, 4), "heal_partition", ())
            )
        ev.sort(key=lambda e: (e.at_s, e.kind, e.target))
        self.events = tuple(ev)
        return self.events

    def schedule_hash(self) -> str:
        """Stable digest of everything that shapes the storm: seed,
        fault rates, per-link overrides, and the built schedule."""
        overrides = sorted(
            (tuple(sorted(k)), v) for k, v in self.link_overrides.items()
        )
        payload = repr(
            (
                self.seed,
                self.link_faults,
                self.kv_faults,
                self.fib_faults,
                overrides,
                self.events,
            )
        )
        return hashlib.sha256(payload.encode()).hexdigest()

    def replay_hint(self) -> str:
        """What a failure message must carry to reproduce the run."""
        return (
            f"ChaosPlan(seed={self.seed}) "
            f"schedule_sha256={self.schedule_hash()[:16]}"
        )

    # ---------------------------------------------------------- seam lookups

    def faults_for_link(self, a_node: str, b_node: str) -> LinkFaults:
        return self.link_overrides.get(
            frozenset((a_node, b_node)), self.link_faults
        )

    def disk_injector(self, node_name: str):
        """The seeded per-node disk-fault injector of the JAX package's
        persist plane: not part of the port yet."""
        raise _no_persist("disk_injector")


# ------------------------------------------------------------ Spark packets


class ChaosIoHub(MockIoHub):
    """MockIoHub whose delivery seam injects seeded per-packet faults.

    Reordering is modelled as a random hold-back (up to jitter_ms):
    later packets on the link overtake the held one, which is exactly
    the UDP reordering Spark has to tolerate.
    """

    def __init__(self, plan: ChaosPlan):
        super().__init__()
        self.plan = plan

    def _enqueue(self, lk, dst_node, dst_if, payload, inbox) -> None:
        plan = self.plan
        if plan.active:
            f = plan.faults_for_link(lk.a[0], lk.b[0])
            if f.drop or f.dup or f.reorder:
                rng = plan.rng("io")
                if f.drop and rng.random() < f.drop:
                    plan.note("io.dropped")
                    return
                if f.dup and rng.random() < f.dup:
                    plan.note("io.duplicated")
                    super()._enqueue(lk, dst_node, dst_if, payload, inbox)
                if (
                    f.reorder
                    and f.jitter_ms > 0
                    and rng.random() < f.reorder
                ):
                    plan.note("io.reordered")
                    asyncio.get_event_loop().call_later(
                        rng.uniform(0.2, 1.0) * f.jitter_ms / 1e3,
                        self._late_deliver,
                        dst_node,
                        dst_if,
                        payload,
                    )
                    return
        super()._enqueue(lk, dst_node, dst_if, payload, inbox)

    def _late_deliver(self, dst_node: str, dst_if: str, payload: bytes) -> None:
        # _inbox_put re-resolves the inbox at fire time (the destination
        # may have crashed while the packet was held back) and enforces
        # the inbox bound
        self._inbox_put(dst_node, dst_if, payload)


# ---------------------------------------------------------- KvStore sessions


class ChaosKvTransport:
    """Per-node wrapper around a shared InProcKvTransport registry.

    Each node gets its own wrapper (the `owner`), so sessions know both
    endpoints — that is what lets a partition block exactly the
    cross-group pairs while intra-group peering keeps working.
    """

    def __init__(self, inner, plan: ChaosPlan, owner: str):
        self._inner = inner
        self.plan = plan
        self.owner = owner

    def register(self, node_name: str, store) -> None:
        self._inner.register(node_name, store)

    def unregister(self, node_name: str) -> None:
        self._inner.unregister(node_name)

    async def connect(self, peer_id: str, endpoint, counters=None):
        if self.plan.kv_blocked(self.owner, peer_id):
            self.plan.note("kv.connect_blocked")
            raise ConnectionError(
                f"chaos: kv partition {self.owner} | {peer_id}"
            )
        session = await self._inner.connect(
            peer_id, endpoint, counters=counters
        )
        return _ChaosKvSession(session, self.plan, self.owner, peer_id)

    @property
    def codec(self) -> str | None:
        """Expose the wrapped transport's wire codec so KvStore's
        serialize-once fan-out stays active under chaos."""
        return getattr(self._inner, "codec", None)


class _ChaosKvSession:
    @property
    def codec(self):
        """Delegate the per-session wire codec so KvStore's serialize-
        once drain check sees through the chaos wrapper."""
        return getattr(self._inner, "codec", None)

    def __init__(self, inner, plan: ChaosPlan, owner: str, peer_id: str):
        self._inner = inner
        self.plan = plan
        self.owner = owner
        self.peer_id = peer_id

    async def _gate(self, op: str, fail_p: float) -> None:
        """Partition check + seeded delay/failure for one session call.
        A raised ConnectionError feeds KvStore's own recovery: the
        caller drops the session and schedules a FULL_SYNC repair."""
        plan = self.plan
        if plan.kv_blocked(self.owner, self.peer_id):
            plan.note(f"kv.{op}_blocked")
            raise ConnectionError(
                f"chaos: kv partition {self.owner} | {self.peer_id}"
            )
        if not plan.active:
            return
        f = plan.kv_faults
        rng = plan.rng("kv")
        if f.delay_ms > 0:
            await asyncio.sleep(rng.uniform(0, f.delay_ms) / 1e3)
        if fail_p and rng.random() < fail_p:
            plan.note(f"kv.{op}_failed")
            raise ConnectionError(
                f"chaos: injected {op} failure "
                f"{self.owner} -> {self.peer_id}"
            )

    async def full_sync(self, area, sender_id, digest, store_hash=None):
        await self._gate("full_sync", self.plan.kv_faults.fail_full_sync)
        return await self._inner.full_sync(
            area, sender_id, digest, store_hash=store_hash
        )

    async def flood(self, pub):
        await self._gate("flood", self.plan.kv_faults.fail_flood)
        return await self._inner.flood(pub)

    async def dual_messages(self, area, sender, msgs):
        await self._gate("dual", 0.0)
        await self._inner.dual_messages(area, sender, msgs)

    async def flood_topo_set(self, area, root, child, set_flag):
        await self._gate("flood_topo_set", 0.0)
        await self._inner.flood_topo_set(area, root, child, set_flag)

    async def close(self) -> None:
        await self._inner.close()


# ------------------------------------------------------------- Fib handler


class ChaosFibHandler(MockFibHandler):
    """MockFibHandler with plan-gated seeded failure rate: failures stop
    the moment the storm runner deactivates the plan, so Fib's backoff
    can drain and the invariant check sees a quiescent dataplane."""

    def __init__(self, plan: ChaosPlan, node_name: str):
        super().__init__(
            fail_rate=plan.fib_faults.fail_rate,
            rng=plan.rng(f"fib/{node_name}"),
        )
        self.plan = plan

    def _fail_maybe(self):
        if not self.plan.active:
            # storm over: suppress only the RATE faults — the inherited
            # count-based fail_next_n contract stays honored so
            # post-storm tests can still inject deterministic failures
            saved, self.fail_rate = self.fail_rate, 0.0
            try:
                super()._fail_maybe()
            finally:
                self.fail_rate = saved
            return
        try:
            super()._fail_maybe()
        except Exception:
            self.plan.note("fib.op_failed")
            raise


# ------------------------------------------------------------ storm runner


async def run_schedule(cluster, plan: ChaosPlan, events=None) -> None:
    """Execute a fault schedule against a Cluster in real time.

    Events fire at their `at_s` offsets from call time; when the last
    one has run, `plan.active` is cleared so rate-based faults stop and
    the cluster can quiesce for the invariant check. Crash/restart
    events are skipped when their target is already in the requested
    state (overlapping storms compose instead of crashing the runner).
    """
    events = plan.events if events is None else tuple(events)
    loop = asyncio.get_running_loop()
    t0 = loop.time()
    try:
        for ev in sorted(events, key=lambda e: e.at_s):
            delay = t0 + ev.at_s - loop.time()
            if delay > 0:
                await asyncio.sleep(delay)
            await _dispatch(cluster, ev)
    finally:
        plan.active = False


async def _dispatch(cluster, ev: ChaosEvent) -> None:
    log.debug("chaos: t=%.3fs %s %r", ev.at_s, ev.kind, ev.target)
    if ev.kind == "fail_link":
        await _maybe_await(cluster.fail_link(*ev.target))
    elif ev.kind == "heal_link":
        await _maybe_await(cluster.heal_link(*ev.target))
    elif ev.kind == "crash":
        name, graceful = ev.target
        if name in cluster.nodes:
            await cluster.crash_node(name, graceful=graceful)
    elif ev.kind == "restart":
        (name,) = ev.target
        if name in cluster.crashed:
            await cluster.restart_node(name)
    elif ev.kind == "partition":
        await _maybe_await(cluster.partition(ev.target))
    elif ev.kind == "heal_partition":
        await _maybe_await(cluster.heal_partition())
    elif ev.kind == "disk_fault":
        name, kind = ev.target
        inject = getattr(cluster, "inject_disk_fault", None)
        # only a cluster with a persist plane can arm one (the paired
        # hard crash still fires)
        if inject is not None and name in cluster.nodes:
            await _maybe_await(inject(name, kind))
    else:
        raise ValueError(f"unknown chaos event kind {ev.kind!r}")


async def _maybe_await(result) -> None:
    """Link and partition faults are plain calls on the in-process
    Cluster, and may be coroutines on a cluster of processes: one
    dispatcher serves both."""
    if asyncio.iscoroutine(result):
        await result

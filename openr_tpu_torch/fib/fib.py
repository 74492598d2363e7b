"""Fib: the Decision's route updates in, the dataplane programmed (the
port's copy of `openr_tpu/fib/fib.py`).

    fib = Fib(config, route_updates.get_reader(), MockFibHandler(),
              fib_updates_queue=fib_updates, perf_events_queue=perf_q)
    await fib.start()

Fib keeps the RIB as the Decision last gave it (`desired_*`, the
Decision's `RibEntry` bindings, never mutated) and what it has
programmed (`programmed_*`, `UnicastRoute` / `MplsRoute`). Its state
machine: AWAITING (no RIB yet: nothing is programmed, so a warm-booted
table survives) → SYNCING (the whole table through `sync_fib`) → SYNCED
(each pass programs the delta book, the bindings changed since the last
successful pass, in chunks of `program_batch_size`). A failed pass
re-enters SYNCING after a jittered exponential backoff; a periodic
`_mark_full_sync` resyncs the whole table. After each successful pass
Fib stamps `FIB_PROGRAMMED` on the convergence traces that pass covered
and hands them to Monitor, and publishes the programmed bindings on its
own stream (PrefixManager gates originations on it). The durable book of
programmed routes (`persist=`) comes with the port's `persist/`.
"""

from __future__ import annotations

import asyncio
import logging
import time
from typing import Iterable, Protocol

from openr_tpu_torch.common import constants as C
from openr_tpu_torch.common.backoff import ExponentialBackoff, stable_rng
from openr_tpu_torch.common.eventbase import OpenrModule
from openr_tpu_torch.config import Config
from openr_tpu_torch.messaging import QueueClosedError, ReplicateQueue, RQueue
from openr_tpu_torch.monitor import perf, work_ledger
from openr_tpu_torch.types.network import IpPrefix, MplsRoute, UnicastRoute
from openr_tpu_torch.types.routes import (
    RibEntry,
    RibMplsEntry,
    RouteUpdate,
    RouteUpdateType,
)

log = logging.getLogger(__name__)

# the FibService client id namespacing each routing daemon's table
CLIENT_ID_OPENR = C.FIB_CLIENT_OPENR
CLIENT_ID_STATIC = C.FIB_CLIENT_STATIC


class FibService(Protocol):
    """The route-programming boundary."""

    async def add_unicast_routes(self, client_id: int, routes: list[UnicastRoute]) -> None: ...
    async def delete_unicast_routes(self, client_id: int, prefixes: list[IpPrefix]) -> None: ...
    async def add_mpls_routes(self, client_id: int, routes: list[MplsRoute]) -> None: ...
    async def delete_mpls_routes(self, client_id: int, labels: list[int]) -> None: ...
    async def sync_fib(self, client_id: int, routes: list[UnicastRoute]) -> None: ...
    async def sync_mpls_fib(self, client_id: int, routes: list[MplsRoute]) -> None: ...
    async def get_route_table_by_client(self, client_id: int) -> list[UnicastRoute]: ...
    async def get_mpls_route_table_by_client(self, client_id: int) -> list[MplsRoute]: ...


class FibProgramError(RuntimeError):
    pass


def _dataplane_key_nh(nh) -> tuple:
    """The fields of a next hop the dataplane stores: a route dumped back
    from it matches its original on exactly these."""
    act = nh.mpls_action
    labels: tuple = ()
    if act is not None:
        if act.push_labels:
            labels = ("push", tuple(act.push_labels))
        elif act.swap_label is not None:
            labels = ("swap", act.swap_label)
    return (nh.address, nh.if_name, max(1, nh.weight), labels)


def _dataplane_key_unicast(r: UnicastRoute) -> tuple:
    return (r.dest, tuple(sorted(_dataplane_key_nh(n) for n in r.nexthops)))


def _dataplane_key_mpls(r: MplsRoute) -> tuple:
    return (
        r.top_label,
        tuple(sorted(_dataplane_key_nh(n) for n in r.nexthops)),
    )


class MockFibHandler:
    """An in-memory FibService that records the programmed tables per
    client. `fail_next_n` fails the next N calls; `fail_rate` fails each
    call with that probability, drawn from `rng`."""

    def __init__(self, fail_rate: float = 0.0, rng=None):
        self.unicast: dict[int, dict[IpPrefix, UnicastRoute]] = {}
        self.mpls: dict[int, dict[int, MplsRoute]] = {}
        self.fail_next_n = 0
        self.fail_rate = fail_rate
        self.rng = rng
        self.op_count = 0
        self.fail_count = 0
        self.sync_count = 0
        self._changed = asyncio.Event()

    def _fail_maybe(self):
        self.op_count += 1
        if self.fail_next_n > 0:
            self.fail_next_n -= 1
            self.fail_count += 1
            raise FibProgramError("injected failure")
        if self.fail_rate > 0 and self.rng is not None:
            if self.rng.random() < self.fail_rate:
                self.fail_count += 1
                raise FibProgramError("injected failure (rate)")

    def _notify(self):
        self._changed.set()
        self._changed = asyncio.Event()

    async def wait_for_change(self, timeout: float = 5.0) -> None:
        await asyncio.wait_for(self._changed.wait(), timeout)

    async def add_unicast_routes(self, client_id, routes):
        self._fail_maybe()
        tbl = self.unicast.setdefault(client_id, {})
        for r in routes:
            tbl[r.dest] = r
        self._notify()

    async def delete_unicast_routes(self, client_id, prefixes):
        self._fail_maybe()
        tbl = self.unicast.setdefault(client_id, {})
        for p in prefixes:
            tbl.pop(p, None)
        self._notify()

    async def add_mpls_routes(self, client_id, routes):
        self._fail_maybe()
        tbl = self.mpls.setdefault(client_id, {})
        for r in routes:
            tbl[r.top_label] = r
        self._notify()

    async def delete_mpls_routes(self, client_id, labels):
        self._fail_maybe()
        tbl = self.mpls.setdefault(client_id, {})
        for label in labels:
            tbl.pop(label, None)
        self._notify()

    async def sync_fib(self, client_id, routes):
        self._fail_maybe()
        self.sync_count += 1
        self.unicast[client_id] = {r.dest: r for r in routes}
        self._notify()

    async def sync_mpls_fib(self, client_id, routes):
        self._fail_maybe()
        self.mpls[client_id] = {r.top_label: r for r in routes}
        self._notify()

    async def get_route_table_by_client(self, client_id):
        return list(self.unicast.get(client_id, {}).values())

    async def get_mpls_route_table_by_client(self, client_id):
        return list(self.mpls.get(client_id, {}).values())


class Fib(OpenrModule):
    """Programs computed routes into the dataplane, reliably (see the
    module docstring)."""

    # traces awaiting a successful program pass, bounded like the
    # Decision's pending list
    PERF_PENDING_CAP = 64

    def __init__(
        self,
        config: Config,
        route_updates_reader: RQueue,
        fib_handler: FibService,
        fib_updates_queue: ReplicateQueue | None = None,
        perf_events_queue: ReplicateQueue | None = None,
        counters=None,
        persist=None,
    ):
        if persist is not None:
            raise NotImplementedError(
                "Fib: persist= needs the durable journal, which is not "
                "part of the port yet"
            )
        super().__init__(f"{config.node_name}.fib", counters=counters)
        self.config = config
        self.handler = fib_handler
        self.reader = route_updates_reader
        self.fib_updates = fib_updates_queue
        self.perf_queue = perf_events_queue
        self._pending_perf: list = []
        self.dry_run = config.node.fib.dry_run
        # the RIB as the Decision last gave it (desired state)
        self.desired_unicast: dict[IpPrefix, RibEntry] = {}
        self.desired_mpls: dict[int, RibMplsEntry] = {}
        # the delta book: bindings changed since the last successful
        # pass (desired == programmed + the book); a SYNCED pass reads
        # only the book, so an idle pass is O(1) and a delta O(delta)
        self._pend_u_upd: dict[IpPrefix, RibEntry] = {}
        self._pend_u_del: set[IpPrefix] = set()
        self._pend_m_upd: dict[int, RibMplsEntry] = {}
        self._pend_m_del: set[int] = set()
        self.batch_size = max(1, config.node.fib.program_batch_size)
        # what was programmed successfully (actual state)
        self.programmed_unicast: dict[IpPrefix, UnicastRoute] = {}
        self.programmed_mpls: dict[int, MplsRoute] = {}
        self.synced = asyncio.Event()  # FIB_SYNCED init gate
        self._need_full_sync = True
        self._have_rib = False  # AWAITING: no RIB from the Decision yet
        self._warm_booted = False  # programmed_* adopted from the handler
        self._dirty = asyncio.Event()
        self.backoff = ExponentialBackoff(
            config.node.fib.initial_retry_ms,
            config.node.fib.max_retry_ms,
            # a dataplane outage fails every node at once: jitter spreads
            # the retries, seeded by the node's name (reproducible runs)
            jitter=True,
            rng=stable_rng(config.node_name, "fib-program"),
        )
        self._fail_streak = 0  # consecutive failed passes
        self._warned_backoff_saturated = False

    async def main(self) -> None:
        if self.config.node.fib.enable_warm_boot and not self.dry_run:
            # before any RIB: the dump must be the previous incarnation's
            await self._warm_boot()
        self.spawn(self._update_loop(), name=f"{self.name}.updates")
        self.spawn(self._program_loop(), name=f"{self.name}.program")
        self.run_every(
            self.config.node.fib.sync_interval_s,
            self._mark_full_sync,
            name=f"{self.name}.resync",
        )

    async def _warm_boot(self) -> None:
        """Adopt the handler's surviving routes as the programmed state,
        so that the first RIB programs only the delta (forwarding never
        gaps). The dump lacks control-plane fields, so that first delta
        compares dataplane keys."""
        try:
            u = await self.handler.get_route_table_by_client(CLIENT_ID_OPENR)
            m = await self.handler.get_mpls_route_table_by_client(
                CLIENT_ID_OPENR
            )
        except asyncio.CancelledError:
            raise
        except Exception as exc:  # noqa: BLE001 — cold boot on any failure
            log.info("%s: warm-boot dump unavailable (%s)", self.name, exc)
            return
        if not u and not m:
            return
        self.programmed_unicast = {r.dest: r for r in u}
        self.programmed_mpls = {r.top_label: r for r in m}
        self._warm_booted = True
        self._need_full_sync = False  # the first pass: the delta
        if self.counters:
            self.counters.set("fib.warm_boot_routes", len(u) + len(m))
        log.info(
            "%s: warm boot adopted %d unicast / %d mpls routes",
            self.name, len(u), len(m),
        )

    def _mark_full_sync(self) -> None:
        self._need_full_sync = True
        self._dirty.set()

    # ------------------------------------------------------------- consume

    async def _update_loop(self) -> None:
        while True:
            try:
                upd = await self.reader.get()
            except QueueClosedError:
                return
            self._fold_update(upd)
            self._have_rib = True
            self._dirty.set()

    def _fold_update(self, upd: RouteUpdate) -> None:
        if upd.perf_events:
            room = self.PERF_PENDING_CAP - len(self._pending_perf)
            self._pending_perf.extend(upd.perf_events[:room])
        if upd.type == RouteUpdateType.FULL_SYNC:
            self.desired_unicast = dict(upd.unicast_to_update)
            self.desired_mpls = dict(upd.mpls_to_update)
            # the full-table paths snapshot `desired`: the book is
            # superseded
            self._clear_pending()
            # after a warm boot the delta against the adopted table is
            # the full sync (it deletes stale routes too)
            if not self._warm_booted:
                self._need_full_sync = True
            return
        for prefix, entry in upd.unicast_to_update.items():
            self.desired_unicast[prefix] = entry
            self._pend_u_upd[prefix] = entry
            self._pend_u_del.discard(prefix)
        for prefix in upd.unicast_to_delete:
            self.desired_unicast.pop(prefix, None)
            self._pend_u_upd.pop(prefix, None)
            self._pend_u_del.add(prefix)
        for label, mentry in upd.mpls_to_update.items():
            self.desired_mpls[label] = mentry
            self._pend_m_upd[label] = mentry
            self._pend_m_del.discard(label)
        for label in upd.mpls_to_delete:
            self.desired_mpls.pop(label, None)
            self._pend_m_upd.pop(label, None)
            self._pend_m_del.add(label)

    def _clear_pending(self) -> None:
        self._pend_u_upd, self._pend_u_del = {}, set()
        self._pend_m_upd, self._pend_m_del = {}, set()

    # ------------------------------------------------------------- program

    async def _program_loop(self) -> None:
        while not self.stopped:
            await self._dirty.wait()
            self._dirty.clear()
            try:
                t0 = time.perf_counter()
                # traces folded in while the handler is awaited belong to
                # the next pass: this pass covers only these
                n_covered = len(self._pending_perf)
                await self._program_once()
                self.backoff.report_success()
                if self._fail_streak:
                    self._fail_streak = 0
                    self._warned_backoff_saturated = False
                    if self.counters:
                        self.counters.set("fib.program_fail_streak", 0)
                if self._have_rib and not self.synced.is_set():
                    self.synced.set()
                if self.counters:
                    self.counters.increment("fib.program_ok")
                    if self._have_rib:
                        self.counters.add_value(
                            "fib.program_ms",
                            (time.perf_counter() - t0) * 1e3,
                        )
                    work_ledger.export_to(self.counters)
                self._complete_traces(n_covered)
            except asyncio.CancelledError:
                raise
            except Exception as exc:  # noqa: BLE001
                self._need_full_sync = True
                self._dirty.set()
                self.backoff.report_error()
                delay = self.backoff.delay_ms / 1e3
                self._fail_streak += 1
                if self.counters:
                    self.counters.increment("fib.program_fail")
                    self.counters.set(
                        "fib.program_fail_streak", self._fail_streak
                    )
                if (
                    self.backoff.current_ms >= self.config.node.fib.max_retry_ms
                    and not self._warned_backoff_saturated
                ):
                    # once a saturation episode: the FibService is down,
                    # not riding out transient failures
                    self._warned_backoff_saturated = True
                    log.warning(
                        "%s: programming backoff saturated at %.0f ms "
                        "after %d consecutive failures",
                        self.name, self.backoff.current_ms, self._fail_streak,
                    )
                log.warning(
                    "%s: programming failed (%s); retry in %.3fs",
                    self.name, exc, delay,
                )
                await asyncio.sleep(delay)

    async def _program_once(self) -> None:
        # AWAITING: programming before the first RIB would wipe a
        # warm-booted table and pass the FIB_SYNCED gate early
        if not self._have_rib:
            return
        if self.dry_run or self._need_full_sync or self._warm_booted:
            await self._program_full_table()
            return
        # SYNCED: the delta book alone. Pop it now: folds arriving while
        # the handler is awaited land in a fresh book and set _dirty
        u_upd, u_del_set = self._pend_u_upd, self._pend_u_del
        m_upd, m_del_set = self._pend_m_upd, self._pend_m_del
        self._clear_pending()
        scanned = len(u_upd) + len(u_del_set) + len(m_upd) + len(m_del_set)
        if self.counters and scanned:
            self.counters.increment("fib.program_scan_routes", scanned)
        if scanned:
            work_ledger.commit("fib", scanned, scanned)
        u_add = []
        for p, e in u_upd.items():
            r = e.to_unicast_route()
            prev = self.programmed_unicast.get(p)
            if prev is not None and prev == r:
                continue  # a rebinding to the same route
            u_add.append((p, r))
        u_del = [p for p in u_del_set if p in self.programmed_unicast]
        m_add = []
        for label, me in m_upd.items():
            r = me.to_mpls_route()
            prev = self.programmed_mpls.get(label)
            if prev is not None and prev == r:
                continue
            m_add.append((label, r))
        m_del = [
            label for label in m_del_set if label in self.programmed_mpls
        ]
        if not (u_add or u_del or m_add or m_del):
            return  # idle: no handler call
        for lo in range(0, len(u_add), self.batch_size):
            chunk = u_add[lo : lo + self.batch_size]
            await self.handler.add_unicast_routes(
                CLIENT_ID_OPENR, [r for _p, r in chunk]
            )
            self._count_batch(len(chunk))
        for lo in range(0, len(u_del), self.batch_size):
            chunk = u_del[lo : lo + self.batch_size]
            await self.handler.delete_unicast_routes(CLIENT_ID_OPENR, chunk)
            self._count_batch(len(chunk))
        for lo in range(0, len(m_add), self.batch_size):
            chunk = m_add[lo : lo + self.batch_size]
            await self.handler.add_mpls_routes(
                CLIENT_ID_OPENR, [r for _l, r in chunk]
            )
            self._count_batch(len(chunk))
        for lo in range(0, len(m_del), self.batch_size):
            chunk = m_del[lo : lo + self.batch_size]
            await self.handler.delete_mpls_routes(CLIENT_ID_OPENR, chunk)
            self._count_batch(len(chunk))
        for p, r in u_add:
            self.programmed_unicast[p] = r
        for p in u_del:
            self.programmed_unicast.pop(p, None)
        for label, r in m_add:
            self.programmed_mpls[label] = r
        for label in m_del:
            self.programmed_mpls.pop(label, None)
        if self.counters:
            self.counters.increment(
                "fib.routes_programmed",
                len(u_add) + len(u_del) + len(m_add) + len(m_del),
            )
        self._publish_programmed(
            {p: u_upd[p] for p, _r in u_add},
            {label: m_upd[label] for label, _r in m_add},
            u_del=u_del,
            m_del=m_del,
        )

    def _count_batch(self, n: int) -> None:
        if self.counters:
            self.counters.increment("fib.program_batches")
            self.counters.add_value("fib.program_batch_size", n)

    async def _program_full_table(self) -> None:
        """The whole-table paths: dry run, full resync (the first RIB,
        the periodic one, the recovery after a failure) and the warm
        boot's one dataplane-key delta."""
        # snapshot now: updates folded while the handler is awaited are
        # not reported as programmed (they set _dirty again)
        snap_u = dict(self.desired_unicast)
        snap_m = dict(self.desired_mpls)
        self._clear_pending()
        # full-table by design: its own ledger stage, delta 0
        work_ledger.commit("fib_resync", len(snap_u) + len(snap_m), 0)
        desired_u = {p: e.to_unicast_route() for p, e in snap_u.items()}
        desired_m = {l: e.to_mpls_route() for l, e in snap_m.items()}
        if self.dry_run:
            self.programmed_unicast = desired_u
            self.programmed_mpls = desired_m
            self._publish_programmed(snap_u, snap_m, full=True)
            return
        if self._need_full_sync:
            await self.handler.sync_fib(CLIENT_ID_OPENR, list(desired_u.values()))
            await self.handler.sync_mpls_fib(CLIENT_ID_OPENR, list(desired_m.values()))
            self._need_full_sync = False
            self.programmed_unicast = desired_u
            self.programmed_mpls = desired_m
            if self.counters:
                self.counters.increment(
                    "fib.routes_programmed", len(desired_u) + len(desired_m)
                )
            self._publish_programmed(snap_u, snap_m, full=True)
            return
        # warm boot: the adopted routes came from a dump without the
        # control-plane fields; compare their dataplane keys
        def same_u(a: UnicastRoute | None, b: UnicastRoute) -> bool:
            return a is not None and (
                _dataplane_key_unicast(a) == _dataplane_key_unicast(b)
            )

        def same_m(a: MplsRoute | None, b: MplsRoute) -> bool:
            return a is not None and (
                _dataplane_key_mpls(a) == _dataplane_key_mpls(b)
            )

        u_add = [
            r for p, r in desired_u.items()
            if not same_u(self.programmed_unicast.get(p), r)
        ]
        u_del = [p for p in self.programmed_unicast if p not in desired_u]
        m_add = [
            r for l, r in desired_m.items()
            if not same_m(self.programmed_mpls.get(l), r)
        ]
        m_del = [l for l in self.programmed_mpls if l not in desired_m]
        if u_add:
            await self.handler.add_unicast_routes(CLIENT_ID_OPENR, u_add)
        if u_del:
            await self.handler.delete_unicast_routes(CLIENT_ID_OPENR, u_del)
        if m_add:
            await self.handler.add_mpls_routes(CLIENT_ID_OPENR, m_add)
        if m_del:
            await self.handler.delete_mpls_routes(CLIENT_ID_OPENR, m_del)
        # every surviving route is now held in control-plane form
        self._warm_booted = False
        self.programmed_unicast = desired_u
        self.programmed_mpls = desired_m
        if self.counters:
            self.counters.set(
                "fib.warm_boot_reprogrammed", len(u_add) + len(m_add)
            )
            work_ledger.export_to(self.counters)
        self._publish_programmed(snap_u, snap_m, full=True)

    def _complete_traces(self, n_covered: int) -> None:
        """Stamp FIB_PROGRAMMED on the first `n_covered` pending traces
        (those the pass just finished covered) and hand them to Monitor.
        Runs only after a successful pass: a failed one keeps its traces
        pending, so the retry's latency stays in them."""
        if not self._have_rib or not self._pending_perf or n_covered <= 0:
            return
        traces = self._pending_perf[:n_covered]
        self._pending_perf = self._pending_perf[n_covered:]
        for pe in traces:
            pe.add_perf_event(
                perf.FIB_PROGRAMMED, node=self.config.node_name
            )
            if self.perf_queue is not None:
                try:
                    self.perf_queue.push(pe)
                except QueueClosedError:
                    if not self.stopped:
                        raise
                    return
        if self.counters:
            self.counters.increment("fib.perf_traces_completed", len(traces))

    def _publish_programmed(
        self,
        snap_u: dict[IpPrefix, RibEntry],
        snap_m: dict[int, RibMplsEntry],
        full: bool = False,
        u_del: Iterable[IpPrefix] = (),
        m_del: Iterable[int] = (),
    ) -> None:
        """Publish the programmed bindings: the whole table on the full
        paths, only the changed bindings on the delta path."""
        if self.fib_updates is None:
            return
        upd = RouteUpdate()
        if full:
            upd.type = RouteUpdateType.FULL_SYNC
            upd.unicast_to_update = dict(snap_u)
            upd.mpls_to_update = dict(snap_m)
        else:
            upd.type = RouteUpdateType.INCREMENTAL
            upd.unicast_to_update = dict(snap_u)
            upd.unicast_to_delete = list(u_del)
            upd.mpls_to_update = dict(snap_m)
            upd.mpls_to_delete = list(m_del)
        self.fib_updates.push(upd)

    # ----------------------------------------------------------- accessors

    def pending_changes(self) -> dict:
        """Desired against programmed: the counts of what differs, and a
        few examples (the convergence check)."""
        desired_u = {p: e.to_unicast_route() for p, e in self.desired_unicast.items()}
        desired_m = {l: e.to_mpls_route() for l, e in self.desired_mpls.items()}
        u_stale = [
            str(p) for p, r in desired_u.items()
            if self.programmed_unicast.get(p) != r
        ]
        u_del = [str(p) for p in self.programmed_unicast if p not in desired_u]
        m_stale = [
            l for l, r in desired_m.items()
            if self.programmed_mpls.get(l) != r
        ]
        m_del = [l for l in self.programmed_mpls if l not in desired_m]
        return {
            "converged": not (u_stale or u_del or m_stale or m_del),
            "desired_unicast": len(desired_u),
            "desired_mpls": len(desired_m),
            "stale": u_stale[:3] + u_del[:3],
            "stale_mpls": m_stale[:3] + m_del[:3],
            "pending": len(u_stale) + len(u_del) + len(m_stale) + len(m_del),
        }

    def get_programmed_unicast(self) -> list[UnicastRoute]:
        return sorted(self.programmed_unicast.values(), key=lambda r: r.dest)

    def get_programmed_mpls(self) -> list[MplsRoute]:
        return sorted(self.programmed_mpls.values(), key=lambda r: r.top_label)

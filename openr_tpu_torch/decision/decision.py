"""The port's Decision: KvStore publications in, RouteUpdates out, the
solve on the card.

    from openr_tpu_torch.config import Config
    from openr_tpu_torch.decision.decision import Decision
    from openr_tpu_torch.messaging import ReplicateQueue

    pubs, routes = ReplicateQueue(name="pubs"), ReplicateQueue(name="routes")
    d = Decision(Config.default("node-0"), pubs.get_reader(), routes)
    await d.start()      # reads publications, debounces, rebuilds
    pubs.push(publication)
    update = await routes_reader.get()   # a RouteUpdate

A copy of the JAX package's `openr_tpu/decision/decision.py` that always
solves with the port's `TorchSpfSolver`, on the card unless
`device="cpu"` is asked for: `device=None` means CUDA and raises without
it. Decision subscribes to the publications queue, buffers `adj:<node>`
and `prefix:...` keys coalesced by key, debounces bursts with a (min,
max) window and at each rebuild decodes the buffered payloads (three
tiers for an adjacency database: a byte-span splice of one changed
adjacency, a splice of several, a full parse), applies them to the
per-area LinkState / PrefixState, classifies the dirt and rebuilds:

  * full: an area with structural topology dirt (or no usable cache) is
    solved from scratch (`compute_routes`), and the cross-area merge
    and the diff run over every route;
  * topology delta: metric-only adjacency changes warm-start the cached
    solve (`warm_compute_routes`);
  * prefix only: touched prefixes are re-assembled against the cached
    solve (`assemble_prefix_routes`), with no solve at all.

Scoped rounds fold only the touched prefixes and labels across areas
(`merge_scope_delta`), and that fold is the RouteUpdate. The decode and
the rebuild run off the event loop in worker threads
(`asyncio.to_thread`); the rebuild's worker makes the solver's CUDA
device current first, since PyTorch's current device is per thread.

The solver is built from `DecisionConfig` by `hook.solver_for`, as
`hook.attach` builds its own (the table knobs, LFA, KSP paths,
`native_rib`, a mesh of `mesh_sources` x `mesh_graph` positions over
`mesh_devices`). `use_tpu_solver=False` selects the host oracle
(`decision/oracle.py`) instead, as the reference's "cpu" backend: such
a Decision builds no solver, needs no CUDA and never touches the card.
`native_rib="on"` raises ValueError, as it is not part of the port.
`set_rib_policy` installs a `RibPolicy` (`policy/policy.py`), applied to
the merged RIB of every rebuild; while one is installed every rebuild
takes the full path, and its TTL expiry (or `set_rib_policy(None)`)
triggers a rebuild without it. Counters go to `counters` under the Decision's
`decision.*` names and the port's `cuda.*`, `device.*` and `work.*`
names (the port's `monitor/` modules). A rebuild whose solve raises
(a kernel that fails to build or launch included) raises out of
`_rebuild_routes`; started, the debounce task's guard counts it under
`<name>.task_exceptions`. No RIB is served over a failed solve.
"""

from __future__ import annotations

import asyncio
import json
import logging
import sys
import threading
import time
from dataclasses import replace

import numpy as np
import torch

from openr_tpu_torch.common import constants as C
from openr_tpu_torch.common.eventbase import OpenrModule
from openr_tpu_torch.common.throttle import AsyncDebounce
from openr_tpu_torch.config import Config
from openr_tpu_torch.decision import hook, oracle
from openr_tpu_torch.decision.ksp import normalize_weights
from openr_tpu_torch.decision.linkstate import LinkState, PrefixState
from openr_tpu_torch.decision.oracle import metric_key
from openr_tpu_torch.decision.spf_backend import resolve_device
from openr_tpu_torch.messaging import QueueClosedError, ReplicateQueue, RQueue
from openr_tpu_torch.monitor import compile_ledger, perf, work_ledger
from openr_tpu_torch.monitor import device as device_telemetry
from openr_tpu_torch.types.kvstore import Publication, Value
from openr_tpu_torch.types.network import IpPrefix
from openr_tpu_torch.types.routes import (
    RouteDatabase,
    RouteUpdate,
    RouteUpdateType,
    diff_route_dbs,
)
from openr_tpu_torch.types.serde import decoder_for, from_wire, to_wire
from openr_tpu_torch.types.topology import (
    Adjacency,
    AdjacencyDatabase,
    PrefixDatabase,
)

log = logging.getLogger(__name__)

_ADJ_DEC = decoder_for(Adjacency)
_ADJDB_DEC = decoder_for(AdjacencyDatabase)
# _adj_reuse bound: an entry holds one node's payload, its raw dicts, the
# decoded adjacencies and database and two span arrays (~25-30 KB at
# degree 32). A tombstone racing a threaded decode can strand an entry,
# so the cache is LRU-capped rather than trusted to drain
_ADJ_REUSE_CAP = 2048

# convergence traces buffered toward the next rebuild, bounded so that a
# trace-per-flap storm cannot grow the list between debounce fires
_PERF_PENDING_CAP = 64

# empty dirt marker for areas untouched since the last rebuild
_NO_DIRT: frozenset = frozenset()

# consecutive rebuilds with no warm start before the warm-only state
# (host distance mirrors, the solver's route-cache fingerprints) is
# dropped
_WARM_IDLE_TRIM = 64


class _TopoDelta:
    """Bounded topology dirt for one area: the directed (node, neighbor)
    pairs whose metric changed (metric-only adjacency updates; anything
    structural is full topology dirt, None), plus the prefix dirt of the
    same window. The rebuild warm-starts the cached solve from these
    pairs or falls back to a full area solve."""

    __slots__ = ("edges", "prefixes")

    def __init__(self, edges=(), prefixes=()):
        self.edges: set = set(edges)
        self.prefixes: set = set(prefixes)


def _fold_unicast(cur, entry):
    """One cross-area selection step for a unicast prefix: `entry` (from
    a later-sorted area) folded into the current winner `cur`."""
    ek = metric_key(entry.best_entry) if entry.best_entry else (0, 0, 0)
    ck = metric_key(cur.best_entry) if cur.best_entry else (0, 0, 0)
    if ek > ck or (ek == ck and entry.igp_cost < cur.igp_cost):
        return entry
    if ek == ck and entry.igp_cost == cur.igp_cost:
        return replace(
            cur, nexthops=_union_nexthops(cur.nexthops, entry.nexthops)
        )
    return cur


def _fold_mpls(cur, mentry):
    """One cross-area selection step for an MPLS label route: the lower
    IGP cost wins; an equal IGP cost unions the nexthop sets."""
    mi, ci = _mpls_igp(mentry), _mpls_igp(cur)
    if mi < ci:
        return mentry
    if mi > ci or mentry.nexthops == cur.nexthops:
        return cur
    return replace(
        cur, nexthops=_union_nexthops(cur.nexthops, mentry.nexthops)
    )


def merge_area_ribs(
    per_area: dict[str, RouteDatabase], my_node: str
) -> RouteDatabase:
    """Cross-area best-route selection: the highest metric key wins; at
    equal metrics and equal IGP cost the nexthop sets are unioned
    (equal-cost multi-area ECMP); MPLS label routes follow the same
    equal-IGP-cost rule. Entries present in one area land by bulk dict
    ops; only prefixes in both the accumulator and the next area run
    the fold step, in sorted area order."""
    areas = sorted(per_area)
    if len(areas) == 1:
        return per_area[areas[0]]
    out = RouteDatabase(this_node_name=my_node)
    with work_ledger.scope("merge_full", 0) as ws:
        for area in areas:
            rdb = per_area[area]
            ws.add(len(rdb.unicast_routes) + len(rdb.mpls_routes))
            src_u = rdb.unicast_routes
            dst_u = out.unicast_routes
            if not dst_u:
                out.unicast_routes = dict(src_u)
            else:
                folded = {
                    p: _fold_unicast(dst_u[p], src_u[p])
                    for p in dst_u.keys() & src_u.keys()
                }
                dst_u.update(src_u)
                dst_u.update(folded)
            src_m = rdb.mpls_routes
            dst_m = out.mpls_routes
            if not dst_m:
                out.mpls_routes = dict(src_m)
            else:
                folded_m = {
                    lbl: _fold_mpls(dst_m[lbl], src_m[lbl])
                    for lbl in dst_m.keys() & src_m.keys()
                }
                dst_m.update(src_m)
                dst_m.update(folded_m)
    return out


def merge_scope_delta(
    per_area: dict[str, RouteDatabase],
    base: RouteDatabase,
    scope,
    label_scope=(),
) -> RouteUpdate:
    """Cross-area re-selection of the `scope` prefixes (and the
    `label_scope` labels of a topology-delta round) only, as the
    RouteUpdate that turns the previous merged RIB `base` into the new
    one. Valid because a scoped round changes no route out of its scope.
    Areas fold in `merge_area_ribs`' order, so applying the update to
    `base` equals a full re-merge; an in-scope entry equal to the book's
    (identity first, as `diff_route_dbs` compares) ships nothing."""
    areas = sorted(per_area)
    delta = len(scope) + len(label_scope)
    # touched: one per-area probe per scoped key
    work_ledger.commit("merge", delta * len(areas), delta)
    uni_up: dict = {}
    uni_del: list = []
    mpls_up: dict = {}
    mpls_del: list = []
    for prefix in scope:
        merged = None
        for a in areas:
            entry = per_area[a].unicast_routes.get(prefix)
            if entry is None:
                continue
            merged = entry if merged is None else _fold_unicast(merged, entry)
        prev = base.unicast_routes.get(prefix)
        if merged is None:
            if prev is not None:
                uni_del.append(prefix)
        elif prev is not merged and prev != merged:
            uni_up[prefix] = merged
    for label in label_scope:
        mmerged = None
        for a in areas:
            mentry = per_area[a].mpls_routes.get(label)
            if mentry is None:
                continue
            mmerged = (
                mentry if mmerged is None else _fold_mpls(mmerged, mentry)
            )
        prev = base.mpls_routes.get(label)
        if mmerged is None:
            if prev is not None:
                mpls_del.append(label)
        elif prev is not mmerged and prev != mmerged:
            mpls_up[label] = mmerged
    return RouteUpdate(
        unicast_to_update=uni_up,
        unicast_to_delete=uni_del,
        mpls_to_update=mpls_up,
        mpls_to_delete=mpls_del,
    )


def _mpls_igp(entry) -> int:
    """IGP cost of an MPLS route: its nexthops' metric (all equal)."""
    return min((nh.metric for nh in entry.nexthops), default=1 << 30)


def _union_nexthops(a, b):
    """Equal-cost multi-area nexthop union: slots deduplicated by
    (neighbor, interface), UCMP weights summed per slot and renormalized
    over the merged set."""
    slots: dict[tuple, object] = {}
    wsum: dict[tuple, int] = {}
    weighted = any(nh.weight for nh in (*a, *b))
    for nh in (*a, *b):
        key = (nh.neighbor_node, nh.if_name)
        slots.setdefault(key, nh)
        if weighted:
            wsum[key] = wsum.get(key, 0) + max(nh.weight, 1)
    if weighted:
        wsum = normalize_weights(wsum)
        return tuple(
            sorted(replace(nh, weight=wsum[k]) for k, nh in slots.items())
        )
    return tuple(sorted(slots.values()))


def solver_device(device) -> torch.device:
    """The Decision's device with its index: `None` is the current CUDA
    device, and raises without CUDA. A worker thread's current device is
    the process default, so a rebuild names the device it runs on."""
    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


class Decision(OpenrModule):
    """Per-node route computation: reads the publications queue, writes
    the route-updates queue, and answers `get_route_db`, `get_spf_path`,
    `get_adj_dbs` and `get_received_routes`."""

    def __init__(
        self,
        config: Config,
        kvstore_pub_reader: RQueue,
        route_updates_queue: ReplicateQueue,
        counters=None,
        initial_sync_event: "asyncio.Event | None" = None,
        device=None,
        mesh_devices=None,
    ):
        dcfg = config.node.decision
        super().__init__(f"{config.node_name}.decision", counters=counters)
        self.config = config
        self.node_name = config.node_name
        self.pub_reader = kvstore_pub_reader
        self.route_updates = route_updates_queue
        # KVSTORE_SYNCED gate: with an event, the first rebuild waits
        # until the store finished its initial full sync, so a restarted
        # node never computes its first RIB from a partial LSDB
        self._initial_sync_event = initial_sync_event
        self._sync_waiter: "asyncio.Task | None" = None
        self._link_states: dict[str, LinkState] = {
            a: LinkState(a) for a in config.area_ids()
        }
        self._prefix_states: dict[str, PrefixState] = {
            a: PrefixState(a) for a in config.area_ids()
        }
        # raw publication buffer, coalesced by key (last value wins): the
        # publication loop only appends; decode and LSDB apply happen
        # once per rebuild (`_drain_pending`)
        self._pending_kvs: dict[tuple[str, str], Value | None] = {}
        # churn decode cache: (area, adj key) -> dict(payload, spans,
        # proven, raws, adjs, db) of the last accepted version. A flap
        # re-sends the node's whole AdjacencyDatabase with one metric
        # changed; the splice tiers re-parse only the changed bodies,
        # and the full parse reuses unchanged Adjacency objects by raw
        # dict equality. Values are replaced, never mutated; every dict
        # mutation holds _adj_reuse_lock (the decode worker and the
        # event loop both write here)
        self._adj_reuse: dict[tuple[str, str], dict] = {}
        self._adj_reuse_lock = threading.Lock()
        # decodes by tier: byte-splice of one body, of several, full
        # parse, payload-identical
        self.decode_stats = {"fast": 0, "multi": 0, "full": 0, "same": 0}
        self._decode_stats_lock = threading.Lock()
        # what solves: a TorchSpfSolver on `device` ("card"), or the
        # host oracle, with no solver and no device ("oracle")
        self.device = None
        if dcfg.use_tpu_solver:
            self.device = solver_device(device)
            self.engine = hook.solver_for(dcfg, self.device, counters,
                                          mesh_devices)
        else:
            self.engine = oracle.OracleEngine(dcfg.enable_lfa,
                                              dcfg.ksp_paths)
        self.debounce = AsyncDebounce(
            dcfg.debounce_min_ms, dcfg.debounce_max_ms, self._rebuild_routes,
            owner=self.name, counters=counters,
        )
        self.rib = RouteDatabase(this_node_name=self.node_name)
        self.rib_computed = asyncio.Event()  # RIB_COMPUTED init gate
        self._spf_runs = 0
        self._last_spf_ms = 0.0
        self.last_breakdown_ms: dict[str, float] = {}
        self._compute_split_ms: dict[str, float] = {}
        # perf_counter() of the snapshot behind the last emitted
        # RouteUpdate and behind the last completed rebuild (emitted or
        # not): a benchmark attributes a flap to the rebuild that held it
        self._last_emitted_snapshot_t0 = 0.0
        self._last_completed_snapshot_t0 = 0.0
        # convergence traces of buffered publications (stamped
        # DECISION_RECEIVED), carried into the next emitted RouteUpdate
        self._pending_perf: list = []
        # ---- dirty-scoped rebuild state -----------------------------------
        # area -> None (topology dirt) | _TopoDelta | set of touched
        # IpPrefix, accumulated by _drain_pending and consumed after the
        # rebuild's snapshot. Every LSDB mutation flows through
        # process_publication; an out-of-band one is caught by the
        # revision guards in _compute_and_diff and rebuilds in full
        self._dirty: dict[str, set | _TopoDelta | None] = {}
        # area -> PrefixState.rev / LinkState.rev bumps of the drains
        # feeding the next rebuild: a cache is used only while the live
        # rev equals its rev plus exactly these bumps
        self._dirty_ps_bumps: dict[str, int] = {}
        self._dirty_ls_bumps: dict[str, int] = {}
        # area -> {"rdb", "art", "ls_rev", "ps_rev"}: the last rebuild's
        # per-area RouteDatabase and SolveArtifact
        self._area_cache: dict[str, dict] = {}
        # send every rebuild down the from-scratch path (benchmarks)
        self.force_full_rebuild = False
        # the installed RibPolicy (set_rib_policy), or None
        self.rib_policy = None
        self._area_solves = 0  # _compute_area calls (full area solves)
        self._rebuild_path = "full"  # the path the last rebuild took
        self._rebuild_cached_areas = 0
        # self.rib is the merge book: scoped rounds patch it in place on
        # the event loop with the update merge_scope_delta made; full
        # rounds replace it (it never aliases a per-area cache rdb)
        self._merge_mode = "full"
        # last rebuild's warm-started areas and warm region size, and the
        # warm attempts that fell back to a full solve
        self._rebuild_warm_areas = 0
        self._rebuild_warm_region = 0
        self._warm_fallbacks = 0
        # consecutive rebuilds that did not warm-start (trim policy)
        self._warm_idle_rounds = 0

    # ------------------------------------------------------------------ run

    async def main(self) -> None:
        self.spawn(self._pub_loop(), name=f"{self.name}.pubs")

    async def cleanup(self) -> None:
        self.debounce.cancel()

    def _on_device(self, fn, *args):
        """`fn(*args)` with the solver's CUDA device current (the calling
        thread's current device is not the solver's in a worker)."""
        if self.device is None or self.device.type != "cuda":
            return fn(*args)
        with torch.cuda.device(self.device):
            return fn(*args)

    # ----------------------------------------------------------- publication

    async def _pub_loop(self) -> None:
        while True:
            try:
                pub = await self.pub_reader.get()
            except QueueClosedError:
                return
            if self.process_publication(pub):
                self.debounce.poke()

    @property
    def backend(self) -> str:
        """"card" or "oracle": what `engine` solves on."""
        return ("oracle" if isinstance(self.engine, oracle.OracleEngine)
                else "card")

    @property
    def solver(self):
        """The card solver (or its `hook.DecisionAdapter`); None on the
        oracle backend."""
        return None if self.backend == "oracle" else self.engine

    @property
    def link_states(self) -> dict[str, LinkState]:
        """Live LSDB view; drains the buffered publications first."""
        self._drain_pending()
        return self._link_states

    @property
    def prefix_states(self) -> dict[str, PrefixState]:
        self._drain_pending()
        return self._prefix_states

    def _get_area(self, area: str) -> tuple[LinkState, PrefixState]:
        ls = self._link_states.get(area)
        if ls is None:
            # an unknown area is learned on first sight
            ls = self._link_states[area] = LinkState(area)
            self._prefix_states[area] = PrefixState(area)
        return ls, self._prefix_states[area]

    def process_publication(self, pub: Publication) -> bool:
        """Buffer one publication for the next rebuild; True if it can
        affect routing."""
        area = pub.area
        buffered = False
        for key, val in pub.key_vals.items():
            if val.value is None:
                continue  # TTL refresh: no payload change
            if (
                C.parse_adj_key(key) is not None
                or C.parse_prefix_key(key) is not None
            ):
                self._pending_kvs[(area, key)] = val
                buffered = True
        for key in pub.expired_keys:
            if (
                C.parse_adj_key(key) is not None
                or C.parse_prefix_key(key) is not None
            ):
                self._pending_kvs[(area, key)] = None  # tombstone
                buffered = True
        if (
            buffered
            and pub.perf_events is not None
            and len(self._pending_perf) < _PERF_PENDING_CAP
        ):
            pub.perf_events.add_perf_event(
                perf.DECISION_RECEIVED, node=self.node_name
            )
            self._pending_perf.append(pub.perf_events)
        return buffered

    def _note_dirt(self, area: str, dirt) -> None:
        """Record one applied key's dirt: None (structural topology
        dirt), a _TopoDelta (metric-only edges) or a set of prefixes.
        Structural dirt absorbs everything; edge dirt absorbs prefix
        dirt."""
        cur = self._dirty.get(area, _NO_DIRT)
        if dirt is None or cur is None:
            self._dirty[area] = None
        elif isinstance(dirt, _TopoDelta):
            if isinstance(cur, _TopoDelta):
                cur.edges |= dirt.edges
                cur.prefixes |= dirt.prefixes
            elif cur is _NO_DIRT:
                self._dirty[area] = _TopoDelta(dirt.edges, dirt.prefixes)
            else:  # existing prefix-only dirt folds into the delta
                self._dirty[area] = _TopoDelta(
                    dirt.edges, cur | dirt.prefixes
                )
        elif isinstance(cur, _TopoDelta):
            cur.prefixes |= dirt
        elif cur is _NO_DIRT:
            self._dirty[area] = set(dirt)
        else:
            cur |= dirt

    def _drain_pending(self, decoded: dict | None = None) -> bool:
        """Decode and apply the coalesced publication buffer, classifying
        each applied key's dirt. `decoded` (from _decode_batch, run in a
        worker) leaves only the LSDB apply to the event loop."""
        if not self._pending_kvs:
            return False
        batch, self._pending_kvs = self._pending_kvs, {}
        changed = False
        work_ledger.commit("dirt", len(batch), len(batch))
        for (area, key), val in batch.items():
            ls, ps = self._get_area(area)
            rev0 = ps.rev
            rev0_ls = ls.rev
            if val is None:
                ch, dirt = self._expire_key(ls, ps, key)
            else:
                db = (decoded or {}).get((area, key, id(val)))
                if db is not None:
                    ch, dirt = self._apply_decoded(ls, ps, key, db)
                else:
                    ch, dirt = self._apply_key(ls, ps, key, val)
            bump = ps.rev - rev0
            if bump:
                self._dirty_ps_bumps[area] = (
                    self._dirty_ps_bumps.get(area, 0) + bump
                )
            bump_ls = ls.rev - rev0_ls
            if bump_ls:
                self._dirty_ls_bumps[area] = (
                    self._dirty_ls_bumps.get(area, 0) + bump_ls
                )
            if ch:
                changed = True
                self._note_dirt(area, dirt)
        if changed and self.counters is not None:
            self.counters.increment("decision.lsdb_changes")
        return changed

    @staticmethod
    def _key_schema(key: str):
        """(expected origin node or None, schema) of a key."""
        node = C.parse_adj_key(key)
        if node is not None:
            return node, AdjacencyDatabase
        parsed = C.parse_prefix_key(key)
        if parsed is not None:
            return parsed[0], PrefixDatabase
        return None, None

    @staticmethod
    def _adj_spans(payload: bytes, adjs: tuple):
        """Byte spans (starts, ends) of each adjacency object's body
        (without braces) in a canonical AdjacencyDatabase payload, or
        None when untrustworthy.

        The scan counts every b'},{' between the array's open and the
        last b'}],'. Real separators are always there and fake ones
        (inside strings) only add to the count, so exactly n - 1 proves
        the middle boundaries. The array head and the tail stay soft
        anchors: a span is proven only once its bytes equal the parsed
        adjacency's canonical encoding, which the splice tiers check
        lazily for the spans they use."""
        n_adjs = len(adjs)
        head = payload.find(b'"adjacencies":[{')
        if head < 0 or n_adjs == 0:
            return None
        start0 = head + 16  # len(b'"adjacencies":[{')
        tail = payload.rfind(b"}],")
        if tail < 0 or tail < start0:
            return None
        seps = []
        p = payload.find(b"},{", start0)
        while p != -1 and p < tail:
            seps.append(p)
            p = payload.find(b"},{", p + 1)
        if len(seps) != n_adjs - 1:
            return None
        starts = np.array([start0] + [s + 3 for s in seps], np.int64)
        ends = np.array([*seps, tail], np.int64)
        return starts, ends

    def _decode_adj_fast(self, payload: bytes, prev: dict):
        """Tier 1: if `payload` differs from the cached payload only
        within one adjacency's body span, parse that body and splice it
        into the cached objects.

        The common prefix covers everything before the body and the
        common suffix everything after it, so the new document equals
        the old outside the body; the body's canonical re-encode proves
        it a complete adjacency interior, so a full parse would give the
        spliced result. Anything unproven returns None (a full parse)."""
        pv = prev["payload"]
        if payload == pv:  # TTL refresh or an idempotent re-publish
            return prev
        spans = prev["spans"]
        if spans is None:
            return None
        starts, ends = spans
        a = np.frombuffer(payload, np.uint8)
        bb = np.frombuffer(pv, np.uint8)
        m = min(a.size, bb.size)
        neq = a[:m] != bb[:m]
        pre = int(neq.argmax()) if neq.any() else m
        neqr = a[-m:][::-1] != bb[-m:][::-1]
        suf = int(neqr.argmax()) if neqr.any() else m
        suf = min(suf, m - pre)
        delta = a.size - bb.size
        # the only span that can hold the diff's start
        i = int(np.searchsorted(starts, pre, side="right")) - 1
        if i < 0:
            return None
        s, e = int(starts[i]), int(ends[i])
        if pre >= e + 3 or suf < bb.size - e:
            return None  # diff in the framing, or past this body
        proven = prev["proven"]
        if not proven[i]:
            # the old bytes of this span must be the cached adjacency's
            # canonical encoding, pinning the span to the true object
            if to_wire(prev["adjs"][i]) != b"{%s}" % pv[s:e]:
                return None
        body = payload[s : e + delta]
        adj = self._validated_adj_body(body)
        if adj is None:
            return None
        adjs = prev["adjs"][:i] + (adj,) + prev["adjs"][i + 1 :]
        raws = prev["raws"]
        if raws is not None:
            raws = list(raws)
            raws[i] = None  # decoded without a raw dict
        if delta:
            starts = starts.copy()
            ends = ends.copy()
            starts[i + 1 :] += delta
            ends[i:] += delta
        if not proven[i]:
            proven = proven.copy()
            proven[i] = True
        return {
            "payload": payload,
            "spans": (starts, ends),
            "proven": proven,
            "raws": raws,
            "adjs": adjs,
            "db": replace(prev["db"], adjacencies=adjs),
        }

    @staticmethod
    def _validated_adj_body(body: bytes):
        """Parse one adjacency body and prove it canonical (re-encode ==
        input); the Adjacency or None."""
        try:
            adj = _ADJ_DEC(json.loads(b"{%s}" % body))
        except Exception:  # noqa: BLE001 — the structural proof failed
            return None
        if to_wire(adj) != b"{%s}" % body:
            return None  # not canonical: the span would be unproven
        return adj

    def _decode_adj_multi(self, payload: bytes, prev: dict):
        """Tier 1b: several adjacency bodies changed (flaps of one node
        coalesced into one window). The new payload's spans are scanned
        under `_adj_spans`' proof; the framing before the first body and
        from the last body's end must equal the cached payload's. Bodies
        pair by position: equal bytes reuse the cached Adjacency,
        differing ones are parsed and validated as in tier 1. Anything
        unproven returns None (a full parse)."""
        spans_old = prev["spans"]
        if spans_old is None:
            return None
        new_spans = self._adj_spans(payload, prev["adjs"])
        if new_spans is None:
            return None
        starts_o, ends_o = spans_old
        starts_n, ends_n = new_spans
        pv = prev["payload"]
        if payload[: starts_n[0]] != pv[: starts_o[0]]:
            return None
        if payload[ends_n[-1] :] != pv[ends_o[-1] :]:
            return None
        proven = prev["proven"]
        adjs = list(prev["adjs"])
        raws = prev["raws"]
        raws = list(raws) if raws is not None else None
        new_proven = proven.copy()
        changed = 0
        mv_old, mv_new = memoryview(pv), memoryview(payload)
        for i in range(len(adjs)):
            so, eo = int(starts_o[i]), int(ends_o[i])
            sn, en = int(starts_n[i]), int(ends_n[i])
            if mv_old[so:eo] == mv_new[sn:en]:
                continue
            body = payload[sn:en]
            if not proven[i]:
                if to_wire(adjs[i]) != b"{%s}" % pv[so:eo]:
                    return None
            adj = self._validated_adj_body(body)
            if adj is None:
                return None
            adjs[i] = adj
            if raws is not None:
                raws[i] = None
            new_proven[i] = True
            changed += 1
        if changed == 0:
            return prev
        adjs_t = tuple(adjs)
        return {
            "payload": payload,
            "spans": new_spans,
            "proven": new_proven,
            "raws": raws,
            "adjs": adjs_t,
            "db": replace(prev["db"], adjacencies=adjs_t),
        }

    def _decode_value(self, area: str, key: str, val: Value, schema):
        """Decode one publication value; an AdjacencyDatabase goes
        through the churn decode cache (see _adj_reuse)."""
        if schema is not AdjacencyDatabase:
            return from_wire(val.value, schema)
        payload = val.value
        if isinstance(payload, str):
            payload = payload.encode()
        cache = self._adj_reuse
        prev = cache.get((area, key))
        entry = None
        tier = "full"
        if prev is not None:
            entry = self._decode_adj_fast(payload, prev)
            if entry is not None:
                tier = "same" if entry is prev else "fast"
            else:
                entry = self._decode_adj_multi(payload, prev)
                if entry is not None:
                    tier = "same" if entry is prev else "multi"
        with self._decode_stats_lock:
            self.decode_stats[tier] += 1
        if entry is None:
            raw = json.loads(payload)
            raws = raw.pop("adjacencies", None) or []
            if prev is not None and prev["raws"] is not None:
                prev_raws, prev_objs = prev["raws"], prev["adjs"]
                n = len(prev_raws)
                adjs = tuple(
                    prev_objs[i]
                    if i < n and prev_raws[i] is not None
                    and r == prev_raws[i]
                    else _ADJ_DEC(r)
                    for i, r in enumerate(raws)
                )
            else:
                adjs = tuple(_ADJ_DEC(r) for r in raws)
            # the other fields through the schema's own decoder
            db = replace(_ADJDB_DEC(raw), adjacencies=adjs)
            entry = {
                "payload": payload,
                "spans": self._adj_spans(payload, adjs),
                "proven": np.zeros(len(adjs), bool),
                "raws": raws,
                "adjs": adjs,
                "db": db,
            }
        with self._adj_reuse_lock:
            cache.pop((area, key), None)  # refresh the LRU position
            cache[(area, key)] = entry
            while len(cache) > _ADJ_REUSE_CAP:
                cache.pop(next(iter(cache)))
        return entry["db"]

    def _decode_batch(self, batch: dict) -> dict:
        """Decode a pending batch (thread-safe: it touches no Decision
        state but the replace-only decode cache), keyed by (area, key,
        id(value)) so that a value superseded meanwhile is never
        misapplied."""
        out = {}
        for (area, key), val in batch.items():
            if val is None:
                continue
            _node, schema = self._key_schema(key)
            if schema is None:
                continue
            try:
                out[(area, key, id(val))] = self._decode_value(
                    area, key, val, schema
                )
            except Exception:  # noqa: BLE001 — _apply_key retries inline
                continue
        return out

    def _apply_decoded(self, ls, ps, key: str, db):
        """Apply one decoded database: (changed, dirt) as _note_dirt
        takes it."""
        if isinstance(db, AdjacencyDatabase):
            node, _schema = self._key_schema(key)
            if node is not None and db.this_node_name != node:
                log.warning(
                    "%s: adj key %s names node %s",
                    self.name, key, db.this_node_name,
                )
            ch, pairs = ls.update_adjacency_db_delta(db)
            if (
                pairs is None
                or not self.config.node.decision.enable_topo_delta
            ):
                return ch, None
            return ch, _TopoDelta(edges=pairs)
        changed = ps.update_prefix_db(db)
        return bool(changed), set(changed)

    def _apply_key(
        self, ls: LinkState, ps: PrefixState, key: str, val: Value
    ):
        _node, schema = self._key_schema(key)
        if schema is None:
            return False, None
        try:
            db = self._decode_value(ls.area, key, val, schema)
        except Exception:  # noqa: BLE001 — a corrupt key is ignored
            log.warning("%s: bad db in key %s", self.name, key)
            return False, None
        return self._apply_decoded(ls, ps, key, db)

    def _expire_key(self, ls: LinkState, ps: PrefixState, key: str):
        """(changed, dirt) of an expiry: an adj key removes a node
        (topology dirt); a prefix withdrawal moves no distance (prefix
        dirt)."""
        node = C.parse_adj_key(key)
        if node is not None:
            with self._adj_reuse_lock:
                self._adj_reuse.pop((ls.area, key), None)
            return ls.delete_adjacency_db(node), None
        parsed = C.parse_prefix_key(key)
        if parsed is not None:
            pnode, _area, pfx = parsed
            if pfx:
                p = IpPrefix(prefix=pfx)
                return ps.withdraw(pnode, p), {p}
            changed = ps.withdraw_node(pnode)
            return bool(changed), set(changed)
        return False, None

    # -------------------------------------------------------------- rebuild

    def _compute_area(
        self, ls: LinkState, ps: PrefixState, want_artifact: bool = False
    ):
        """One area's full solve and assembly; with `want_artifact`,
        (rdb, SolveArtifact | None)."""
        self._area_solves += 1
        res = self.engine.compute_routes(
            ls, ps, self.node_name, return_artifact=want_artifact
        )
        rdb = res[0] if want_artifact else res
        work_ledger.commit(
            "spf_full", len(rdb.unicast_routes) + len(rdb.mpls_routes), 1
        )
        return res

    def _reassemble_area(
        self, cache: dict, ps: PrefixState, prefixes: set
    ) -> RouteDatabase:
        """Prefix-only path for one area: no solve; only the touched
        prefixes are re-assembled against the cached artifact, in place
        in the cached per-area RIB (private to the rebuild: the merge
        book never aliases it), so every other entry stays the same
        object and the diff short-circuits on identity."""
        rdb = cache["rdb"]
        work_ledger.commit("assembly", len(prefixes), len(prefixes))
        entries = self.engine.assemble_prefix_routes(cache["art"], ps,
                                                      prefixes)
        for p in prefixes:
            e = entries.get(p)
            if e is None:
                rdb.unicast_routes.pop(p, None)
            else:
                rdb.unicast_routes[p] = e
        return rdb

    def _snapshot_states(self) -> dict[str, tuple[LinkState, PrefixState]]:
        """Taken on the event loop, so that the worker's solve never races
        the publication loop's LSDB mutations."""
        return {
            a: (self.link_states[a].snapshot(), self.prefix_states[a].snapshot())
            for a in self.link_states
        }

    def compute_rib(
        self,
        states: dict[str, tuple[LinkState, PrefixState]] | None = None,
    ) -> RouteDatabase:
        """The full cross-area RIB from scratch (synchronous)."""
        if states is None:
            states = self._snapshot_states()
        return self._full_rib(states, self.rib_policy)

    def _full_rib(self, states, policy) -> RouteDatabase:
        """The full RIB under `policy`, which the caller read once: a
        removal or expiry on the event loop meanwhile rebinds
        `self.rib_policy` and pokes the next rebuild."""
        per_area = self._on_device(lambda: {
            a: self._compute_area(ls, ps) for a, (ls, ps) in states.items()
        })
        rdb = merge_area_ribs(per_area, self.node_name)
        if policy is not None:
            policy.apply(rdb)
        return rdb

    def _warm_area(self, ls, ps, cache, d: _TopoDelta):
        """A topology-delta warm rebuild of one area against its cached
        artifact: (rdb, art, touched prefixes, touched labels, region),
        or None to demand a full area solve."""
        return self.engine.warm_compute_routes(
            cache["art"], ls, ps, self.node_name,
            d.edges, d.prefixes, cache["rdb"],
            self.config.node.decision.topo_delta_max_frac,
        )

    def _compute_and_diff(
        self,
        states,
        dirt: dict | None = None,
        ps_bumps: dict | None = None,
        ls_bumps: dict | None = None,
    ):
        """The worker's rebuild body: per-area compute and the diff
        against the published RIB (only the serialized rebuild coroutine
        rebinds self.rib, so reading it here is race-free).

        `dirt` maps area -> None | _TopoDelta | set of prefixes, as
        _drain_pending accumulated it; None for the argument makes every
        area topology-dirty. Per area: topology dirt without a usable
        cache solves in full; a _TopoDelta with one warm-starts; no dirt
        (revision-verified) reuses the cached RIB; prefix dirt
        re-assembles the touched prefixes. With no area solved, the
        merge is the scoped book fold, whose RouteUpdate is the diff.
        An installed RibPolicy, `force_full_rebuild`, a first build, a
        revision mismatch or a missing artifact fall back to the full
        path."""
        ts = time.perf_counter()
        if dirt is None:
            dirt = {a: None for a in states}
        scope: set | None = None
        lscope: tuple | None = None
        cached_areas = 0
        warm_areas = 0
        warm_region = 0
        policy = self.rib_policy  # one read: the event loop may clear it
        if policy is not None or self.force_full_rebuild:
            # RibPolicy.apply rewrites the merged rdb in place, which is
            # the area's own rdb when there is one area: no per-area cache
            # while a policy is installed. The empty cache sends the round
            # after its removal or expiry down the full path too
            self._area_cache.clear()
            new_rib = self._full_rib(states, policy)
            path = "full"
        else:
            per_area: dict[str, RouteDatabase] = {}
            solved_any = False
            prefix_scope: set = set()
            label_scope_set: set = set()
            bumps = ps_bumps or {}
            lbumps = ls_bumps or {}
            for a, (ls, ps) in states.items():
                d = dirt.get(a, _NO_DIRT)
                cache = self._area_cache.get(a)
                # revision guard: both revs must equal the cached rev
                # plus the exact bumps of the tracked drains
                if cache is not None and (
                    cache["ls_rev"] + lbumps.get(a, 0) != ls.rev
                    or ps.rev != cache["ps_rev"] + bumps.get(a, 0)
                ):
                    cache = None  # out-of-band mutation: solve in full
                if (
                    isinstance(d, _TopoDelta)
                    and cache is not None
                    and cache["art"] is not None
                ):
                    res = self._warm_area(ls, ps, cache, d)
                    if res is not None:
                        rdb, art, t_pfx, t_lbl, region = res
                        work_ledger.commit(
                            "spf_warm",
                            region + len(t_pfx) + len(t_lbl),
                            len(d.edges) + len(d.prefixes),
                        )
                        self._area_cache[a] = {
                            "rdb": rdb, "art": art,
                            "ls_rev": ls.rev, "ps_rev": ps.rev,
                        }
                        prefix_scope |= t_pfx
                        label_scope_set |= t_lbl
                        warm_areas += 1
                        warm_region += region
                        per_area[a] = rdb
                        continue
                    self._warm_fallbacks += 1
                    d = None  # warm refused: full solve for this area
                elif isinstance(d, _TopoDelta):
                    d = None  # no warmable cache: full solve
                # the artifact is needed only to re-assemble prefix
                # dirt; a clean area reuses its rdb even without one
                if d is None or cache is None or (d and cache["art"] is None):
                    rdb, art = self._compute_area(ls, ps, want_artifact=True)
                    self._area_cache[a] = {
                        "rdb": rdb, "art": art,
                        "ls_rev": ls.rev, "ps_rev": ps.rev,
                    }
                    solved_any = True
                elif not d:
                    rdb = cache["rdb"]
                    cached_areas += 1
                else:
                    rdb = self._reassemble_area(cache, ps, d)
                    cache["rdb"] = rdb
                    cache["ps_rev"] = ps.rev
                    prefix_scope |= d
                per_area[a] = rdb
            if solved_any:
                path = "full"
                new_rib = merge_area_ribs(per_area, self.node_name)
                if len(per_area) == 1:
                    # one area: merge_area_ribs returned the cached rdb
                    # itself; the book must not alias it (scoped rounds
                    # patch cache rdbs in place off the loop)
                    detached = RouteDatabase(this_node_name=self.node_name)
                    detached.unicast_routes = dict(new_rib.unicast_routes)
                    detached.mpls_routes = dict(new_rib.mpls_routes)
                    new_rib = detached
            else:
                path = "topo_delta" if warm_areas else "prefix_only"
                scope = prefix_scope
                lscope = tuple(sorted(label_scope_set))
                # the book fold: only the scoped keys, as the update that
                # patches the live book (applied on the event loop)
                update = merge_scope_delta(per_area, self.rib, scope, lscope)
                new_rib = self.rib
        tr = time.perf_counter()
        self._merge_mode = "scoped" if scope is not None else "full"
        if scope is not None:
            work_ledger.commit(
                "diff",
                len(scope) + len(lscope),
                len(scope) + len(lscope),
            )
        else:
            work_ledger.commit(
                "diff",
                len(self.rib.unicast_routes)
                + len(self.rib.mpls_routes)
                + len(new_rib.unicast_routes)
                + len(new_rib.mpls_routes),
                0,
            )
            update = diff_route_dbs(self.rib, new_rib)
        self._rebuild_path = path
        self._rebuild_cached_areas = cached_areas
        self._rebuild_warm_areas = warm_areas
        self._rebuild_warm_region = warm_region
        self._compute_split_ms = {
            "compute_rib": (tr - ts) * 1e3,
            "diff": (time.perf_counter() - tr) * 1e3,
        }
        return new_rib, update

    async def _rebuild_routes(self) -> None:
        if (
            self._initial_sync_event is not None
            and not self._initial_sync_event.is_set()
            and not self.rib_computed.is_set()
        ):
            # hold the first RIB until KVSTORE_SYNCED; a waiter pokes the
            # debounce again when the gate opens
            if self._sync_waiter is None or self._sync_waiter.done():
                self._sync_waiter = self.spawn(
                    self._poke_after_initial_sync(),
                    name=f"{self.name}.syncgate",
                )
            return
        t0 = time.perf_counter()
        traces: list = []
        try:
            # the backlog's decode runs in a worker; the event loop pays
            # only the LSDB apply and the snapshot
            t1 = t0
            if self._pending_kvs:
                batch_view = dict(self._pending_kvs)
                decoded = await asyncio.to_thread(
                    self._decode_batch, batch_view
                )
                t1 = time.perf_counter()
                self._drain_pending(decoded)
            # the traces are taken after the decode await: the snapshot's
            # drain folds in what arrived meanwhile, so their traces ride
            # this update; later arrivals wait for the next rebuild
            traces, self._pending_perf = self._pending_perf, []
            for pe in traces:
                pe.add_perf_event(
                    perf.DECISION_DEBOUNCED, node=self.node_name
                )
            states = self._snapshot_states()
            # the dirt is consumed after the snapshot, for the same reason
            dirt, self._dirty = self._dirty, {}
            ps_bumps, self._dirty_ps_bumps = self._dirty_ps_bumps, {}
            ls_bumps, self._dirty_ls_bumps = self._dirty_ls_bumps, {}
            t2 = time.perf_counter()
            new_rib, update = await asyncio.to_thread(
                self._on_device, self._compute_and_diff, states, dirt,
                ps_bumps, ls_bumps,
            )
            t3 = time.perf_counter()
            self.last_breakdown_ms = {
                "decode": (t1 - t0) * 1e3,
                "apply_snapshot": (t2 - t1) * 1e3,
                "compute_diff": (t3 - t2) * 1e3,
                **self._compute_split_ms,
            }
        except asyncio.CancelledError:
            raise  # a shutdown mid-rebuild propagates
        except Exception:
            # a failed solve (a kernel that does not build or launch
            # included) is raised, never served over: the caller, or the
            # debounce task's guard (`<name>.task_exceptions`), sees it.
            # This batch's dirt was consumed but its routes never landed:
            # drop the per-area caches so that a later rebuild is from
            # scratch (the book is still the published RIB, which the
            # forced full round re-arms)
            self._area_cache.clear()
            # a later rebuild will hold these publications' changes, so
            # their traces go back ahead of the newer ones
            self._pending_perf = (
                traces + self._pending_perf
            )[:_PERF_PENDING_CAP]
            raise
        self._last_spf_ms = (time.perf_counter() - t0) * 1e3
        self._spf_runs += 1
        path = self._rebuild_path
        marker = {
            "prefix_only": perf.REBUILD_PREFIX_ONLY,
            "topo_delta": perf.REBUILD_TOPO_DELTA,
        }.get(path, perf.REBUILD_FULL)
        for pe in traces:
            pe.add_perf_event(marker, node=self.node_name)
            pe.add_perf_event(perf.SPF_SOLVE_DONE, node=self.node_name)
        # trim policy: after _WARM_IDLE_TRIM rebuilds with no warm start
        # the warm-only state goes, so structural or prefix-only churn
        # never pins it
        if self._rebuild_warm_areas:
            self._warm_idle_rounds = 0
        else:
            self._warm_idle_rounds += 1
            if self._warm_idle_rounds == _WARM_IDLE_TRIM:
                self.trim_warm_state()
        if self.counters is not None:
            self._export_counters(t3 - t2)
        first = not self.rib_computed.is_set()
        if new_rib is self.rib:
            # the scoped update patches the live book in place, with no
            # await before the push: readers never see a torn table
            rib = self.rib
            rib.unicast_routes.update(update.unicast_to_update)
            for p in update.unicast_to_delete:
                rib.unicast_routes.pop(p, None)
            rib.mpls_routes.update(update.mpls_to_update)
            for lbl in update.mpls_to_delete:
                rib.mpls_routes.pop(lbl, None)
        else:
            self.rib = new_rib
        self._last_completed_snapshot_t0 = t0
        if first or not update.empty():
            self._last_emitted_snapshot_t0 = t0
            for pe in traces:
                pe.add_perf_event(
                    perf.ROUTE_UPDATE_SENT, node=self.node_name
                )
            update.perf_events = traces
        # else: the rebuild proved no route change; the traces end here
        if first:
            update.type = RouteUpdateType.FULL_SYNC
            self.rib_computed.set()
            self.route_updates.push(update)
        elif not update.empty():
            self.route_updates.push(update)

    def _export_counters(self, compute_s: float) -> None:
        """The rebuild's counters: the Decision's `decision.*`, and the
        port's ledgers and gauges (`work.*`, `cuda.*`, `device.*`)."""
        c = self.counters
        path = self._rebuild_path
        c.increment("decision.spf_runs")
        if path == "prefix_only":
            c.increment("decision.rebuild.prefix_only")
        elif path == "topo_delta":
            c.increment("decision.rebuild.topo_delta")
        else:
            c.increment("decision.rebuild.full")
        if self._rebuild_cached_areas:
            c.increment("decision.rebuild.cached_areas",
                        self._rebuild_cached_areas)
        c.increment(f"decision.merge.{self._merge_mode}")
        if self._rebuild_warm_areas:
            c.increment("decision.spf.warm_starts", self._rebuild_warm_areas)
            c.add_value("decision.spf.warm_region_nodes",
                        self._rebuild_warm_region)
        c.set("decision.spf.warm_fallbacks", self._warm_fallbacks)
        c.set("decision.rebuild.area_solves", self._area_solves)
        c.set("decision.spf_ms", self._last_spf_ms)
        c.add_value("decision.spf_solve_ms", self._compute_split_ms.get(
            "compute_rib", compute_s * 1e3))
        c.add_value("decision.rebuild_ms", self._last_spf_ms)
        with self._decode_stats_lock:
            for tier, n in self.decode_stats.items():
                c.set(f"decision.decode.{tier}", n)
        s = self.solver
        if s is None:
            # the oracle: host accounting only, no device ledgers
            work_ledger.export_to(c)
            c.set("decision.nexthop_groups", sum(
                len(a["art"].nh_intern) for a in self._area_cache.values()
                if a.get("art") is not None
                and a["art"].nh_intern is not None))
            return
        for k, n in s.dev_cache_stats.items():
            c.set(f"decision.dev_cache.{k}", n)
        for k, n in s.spf_kernel_stats.items():
            c.set(f"decision.spf.{k}", n)
        for k, n in s.elect_stats.items():
            c.set(f"decision.elect.{k}", n)
        for k, v in s.last_phase_ms.items():
            c.add_value(f"decision.elect.{k}_ms", v)
        c.set("decision.nexthop_groups", len(s._nh_intern))
        c.set("decision.spf.solves", s.solve_count)
        s.work_ledger.export_to(c)
        compile_ledger.export_to(c)
        device_telemetry.export_to(c)
        device_telemetry.sample_hbm(c)

    async def _poke_after_initial_sync(self) -> None:
        await self._initial_sync_event.wait()
        self.debounce.poke()

    # ------------------------------------------------------------ accessors

    def warm_cache_bytes(self) -> int:
        """Host bytes of the warm-start-only state across the cached
        artifacts (what `trim_warm_state` reclaims)."""
        total = 0
        for cache in self._area_cache.values():
            art = cache.get("art")
            if art is not None:
                total += art.warm_state_bytes()
        return total

    def prefix_table_bytes(self) -> int:
        """Rough footprint of the prefix tables and the nexthop-group
        intern tables."""
        total = 0
        for ps in self._prefix_states.values():
            total += sys.getsizeof(ps.prefixes)
            for per in ps.prefixes.values():
                # the per-advertiser dict and a rough constant per entry
                total += sys.getsizeof(per) + 96 * len(per)
        if self.solver is not None:
            total += 120 * len(self.solver._nh_intern)
        for c in self._area_cache.values():
            art = c.get("art")
            if art is not None and art.nh_intern is not None:
                total += 120 * len(art.nh_intern)
        return total

    def trim_warm_state(self) -> None:
        """Drop the warm-start-only state of every cached artifact and the
        solver's extra cache fingerprints; the prefix-only path stays
        intact, and the next topology-delta round rebuilds what it needs
        or solves in full."""
        for cache in self._area_cache.values():
            art = cache.get("art")
            if art is not None:
                art.drop_warm_state()
        self.engine.trim_caches()

    def set_rib_policy(self, policy) -> None:
        """Install or replace the RibPolicy (None removes it) and rebuild;
        another rebuild is scheduled at the policy's TTL expiry, so its
        weights do not outlive it on a quiet network."""
        self.rib_policy = policy
        self.debounce.poke()
        if policy is not None and getattr(policy, "ttl_secs", None):
            self.spawn(
                self._policy_expiry_watch(policy),
                name=f"{self.name}.policy-ttl",
            )

    async def _policy_expiry_watch(self, policy) -> None:
        await asyncio.sleep(policy.ttl_secs)
        if self.rib_policy is policy:
            self.rib_policy = None  # expired: drop it and rebuild
            self.debounce.poke()

    def get_rib_policy(self):
        return self.rib_policy

    def get_route_db(self) -> RouteDatabase:
        return self.rib

    def get_spf_path(
        self, src: str, dst: str, area: str | None = None
    ) -> dict:
        """The deterministic shortest path src -> dst on the current LSDB
        (a host query: the CSR's adjacency and overload rules, the
        name-smallest predecessor at each step), the best over the
        candidate areas."""
        from openr_tpu_torch.decision.ksp import dijkstra, extract_path
        from openr_tpu_torch.decision.oracle import build_adjacency

        areas = [area] if area is not None else sorted(self._link_states)
        best: dict | None = None
        for a in areas:
            ls = self._link_states.get(a)
            if ls is None or src not in ls.nodes or dst not in ls.nodes:
                continue
            if src == dst:
                return {
                    "area": a, "src": src, "dst": dst,
                    "reachable": True, "cost": 0, "hops": [src],
                    "hop_metrics": [],
                }
            adj = build_adjacency(ls)
            overloaded = {n for n in ls.nodes if ls.is_node_overloaded(n)}
            dist = dijkstra(adj, src, overloaded)
            # the solver's saturation: a cost at DIST_INF is unreachable
            if dist.get(dst, C.DIST_INF) >= C.DIST_INF:
                continue
            hops = extract_path(adj, dist, src, dst, overloaded)
            if hops is None:
                continue
            if best is None or int(dist[dst]) < best["cost"]:
                best = {
                    "area": a, "src": src, "dst": dst,
                    "reachable": True, "cost": int(dist[dst]),
                    "hops": hops,
                    "hop_metrics": [
                        int(adj[u][v]) for u, v in zip(hops, hops[1:])
                    ],
                }
        return best or {"src": src, "dst": dst, "reachable": False}

    def get_adj_dbs(self) -> dict[str, list[AdjacencyDatabase]]:
        return {
            area: [db for n in ls.nodes if (db := ls.adjacency_db(n))]
            for area, ls in self.link_states.items()
        }

    def get_received_routes(self) -> dict[str, dict]:
        return {
            area: {
                str(p.prefix): sorted(per_node)
                for p, per_node in ps.prefixes.items()
            }
            for area, ps in self.prefix_states.items()
        }

"""The diffusing update algorithm (DUAL) over KvStore peers (the port's
copy of `openr_tpu/dual/dual.py`): a per-root distance machine with
passive and active states, the feasibility condition, queries and
replies, and one machine per flood-root candidate; the root election
picks the smallest root id with a finite distance.

Design notes:
- Pure algorithm, no I/O: outbound messages go through a ``send(nbr,
  [DualMsg])`` callback supplied by the owner (KvStore's flood-topology
  manager, or a test pump). All state transitions are synchronous.
- Passive state keeps the classic invariant FD == D (feasible distance
  equals current distance); an input event with no feasible successor
  (no neighbor with reported distance < FD) starts a diffusing
  computation: queries to every neighbor, distance frozen until all
  replies arrive, then FD resets and the successor is re-elected.
- Going ACTIVE freezes the distance *through the old successor* (INF if
  that neighbor is gone) — the EIGRP discipline. Queries therefore carry
  poisoned distances on route loss, which is what makes the diffusing
  computation terminate in one wave instead of counting to infinity.
- The reply owed to the query that *triggered* a passive→active
  transition is deferred until the node returns to passive (so a parent
  only unfreezes once its subtree has converged); queries that arrive
  while already ACTIVE get an immediate reply with the frozen distance,
  which breaks crossing-query deadlocks. The steady state (all nodes
  passive) is the exact shortest-path tree, and KvStore's anti-entropy
  full-sync already guarantees delivery if a transient flood-topology
  gap drops a publication.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable

from openr_tpu_torch.types.serde import from_jsonable, to_jsonable

DUAL_INF = 1 << 30

# every Nth DualNode.tick re-advertises PASSIVE distances to ALL
# neighbors (heal backstop); other ticks refresh only rd==INF peers
FULL_REFRESH_EVERY = 6

PASSIVE = "PASSIVE"
ACTIVE = "ACTIVE"

# parent sentinel for "I am the root"
SELF = "::self"


@dataclass
class DualMsg:
    """One DUAL protocol message: the root it is about, its type and a
    distance."""

    root: str
    mtype: str  # "update" | "query" | "reply"
    dist: int

    def to_json(self) -> dict:
        return to_jsonable(self)

    @staticmethod
    def from_json(raw: dict) -> "DualMsg":
        return from_jsonable(raw, DualMsg)


@dataclass
class RootStatus:
    """Snapshot of one root's state at this node (for dumps)."""

    root: str
    dist: int
    parent: str | None  # neighbor toward root; SELF if we are the root
    state: str


class _RootState:
    """Per-root DUAL machine at one node."""

    def __init__(self, root: str, node: "DualNode"):
        self.root = root
        self.node = node
        self.i_am_root = root == node.node_name
        self.rd: dict[str, int] = {
            n: DUAL_INF for n in node.costs
        }  # reported distances
        self.state = PASSIVE
        self.pending: set[str] = set()  # awaited replies while ACTIVE
        self.deferred: set[str] = set()  # queriers owed a reply at finish
        self.sia_probes = 0  # stuck-in-active retransmit count
        self.dead_ticks = 0  # consecutive ticks at dist == INF (pruning)
        if self.i_am_root:
            self.dist = 0
            self.fd = 0
            self.parent: str | None = SELF
        else:
            self.dist = DUAL_INF
            self.fd = DUAL_INF
            self.parent = None

    # ------------------------------------------------------------ helpers

    def _best(self) -> tuple[int, str | None]:
        """min over neighbors of rd + link cost; deterministic tie-break
        on neighbor name (gives every node the same SPT shape)."""
        best_d, best_n = DUAL_INF, None
        for n, c in sorted(self.node.costs.items()):
            d = self.rd[n] + c
            if d < best_d:
                best_d, best_n = d, n
        return (best_d, best_n) if best_d < DUAL_INF else (DUAL_INF, None)

    def _feasible(self) -> list[str]:
        return [n for n in self.node.costs if self.rd[n] < self.fd]

    def _set_parent(self, new_parent: str | None) -> None:
        if new_parent != self.parent:
            old = self.parent
            self.parent = new_parent
            self.node._on_parent_change(self.root, old, new_parent)

    def _send_all(self, mtype: str, dist: int) -> None:
        for n in self.node.costs:
            self.node._enqueue(n, DualMsg(self.root, mtype, dist))

    # ------------------------------------------------------------- events

    def on_event(self) -> None:
        """Re-evaluate after any rd/cost/topology mutation (passive only;
        while ACTIVE the mutated rd is picked up by the finish recompute)."""
        if self.i_am_root or self.state == ACTIVE:
            return
        feas = self._feasible()
        if feas:
            # stay passive: pick min-distance successor among feasible
            s = min(feas, key=lambda n: (self.rd[n] + self.node.costs[n], n))
            new_d = self.rd[s] + self.node.costs[s]
            self._set_parent(s)
            if new_d != self.dist:
                self.dist = new_d
                self.fd = min(self.fd, new_d)
                self._send_all("update", self.dist)
            return
        best_d, _ = self._best()
        if best_d >= DUAL_INF:
            # no candidate path at all: accept loss directly (poisoned
            # case — diffusing through nothing proves nothing)
            changed = self.dist != DUAL_INF
            self.dist = DUAL_INF
            self.fd = DUAL_INF
            self._set_parent(None)
            if changed:
                self._send_all("update", DUAL_INF)
            return
        # an alternate exists but is not provably loop-free → diffuse.
        # Frozen distance is THROUGH THE OLD SUCCESSOR (INF if gone):
        # queries advertise the loss, not the unproven alternate.
        s = self.parent
        if s is not None and s in self.node.costs and s in self.rd:
            frozen = min(self.rd[s] + self.node.costs[s], DUAL_INF)
        else:
            frozen = DUAL_INF
        self.state = ACTIVE
        self.pending = set(self.node.costs)
        self.sia_probes = 0
        self.dist = frozen
        self._send_all("query", frozen)

    def _finish_active(self) -> None:
        self.state = PASSIVE
        self.sia_probes = 0
        self.fd = DUAL_INF  # feasibility reset: any successor allowed
        d, s = self._best()
        self.dist = d
        self.fd = d
        self._set_parent(s)
        self._send_all("update", self.dist)
        for nbr in self.deferred:
            if nbr in self.node.costs:
                self.node._enqueue(nbr, DualMsg(self.root, "reply", self.dist))
        self.deferred.clear()

    # --------------------------------------------------------- msg inputs

    def on_update(self, nbr: str, d: int) -> None:
        if nbr not in self.node.costs:
            return
        self.rd[nbr] = d
        self.on_event()

    def on_query(self, nbr: str, d: int) -> None:
        if nbr not in self.node.costs:
            return
        self.rd[nbr] = d
        if self.i_am_root:
            self.node._enqueue(nbr, DualMsg(self.root, "reply", 0))
            return
        if self.state == PASSIVE:
            self.on_event()
            if self.state == ACTIVE:
                # this query triggered our diffusion: owe the reply until
                # our subtree converges (passive again)
                self.deferred.add(nbr)
            else:
                self.node._enqueue(nbr, DualMsg(self.root, "reply", self.dist))
        else:
            # already active: immediate reply with the frozen distance
            # (breaks crossing-query deadlocks; see module docstring)
            self.node._enqueue(nbr, DualMsg(self.root, "reply", self.dist))

    def on_reply(self, nbr: str, d: int) -> None:
        if nbr not in self.node.costs:
            return
        self.rd[nbr] = d
        if self.state == ACTIVE:
            self.pending.discard(nbr)
            if not self.pending:
                self._finish_active()
        else:
            self.on_event()

    def on_peer_up(self, nbr: str) -> None:
        self.rd.setdefault(nbr, DUAL_INF)
        # introduce ourselves (root announces 0; others their distance)
        self.node._enqueue(nbr, DualMsg(self.root, "update", self.dist))

    def on_peer_down(self, nbr: str) -> None:
        self.rd.pop(nbr, None)
        self.deferred.discard(nbr)
        if self.state == ACTIVE:
            self.pending.discard(nbr)
            if not self.pending:
                self._finish_active()
                return
        self.on_event()

    def tick(self, max_sia_probes: int, full_refresh: bool = False) -> None:
        """Periodic liveness pass (lost-message self-healing).

        ACTIVE: retransmit queries to still-pending neighbors (a lost
        reply otherwise wedges the machine forever — there is no other
        retransmit path); after `max_sia_probes` retransmits, force the
        finish from current knowledge (stuck-in-active bound, the moral
        equivalent of EIGRP's SIA timer). PASSIVE: re-advertise our
        distance to every neighbor — heals dropped introduction updates
        (e.g. a message sent before the peer finished its own sync).
        """
        if self.state == ACTIVE:
            self.sia_probes += 1
            if self.sia_probes > max_sia_probes:
                self._finish_active()
                return
            for n in self.pending:
                if n in self.node.costs:
                    self.node._enqueue(n, DualMsg(self.root, "query", self.dist))
        else:
            if self.dist >= DUAL_INF and not self.i_am_root:
                # dead root: stop refreshing it (re-advertising INF would
                # re-instantiate the machine on every receiver forever)
                self.dead_ticks += 1
                return
            self.dead_ticks = 0
            # steady-state: refresh only neighbors whose reported distance
            # for this root is still INF (they can have missed the
            # introduction) — a full _send_all every tick is
            # O(num_roots × degree) cluster-wide. A lost update toward a
            # neighbor with finite rd is healed by the periodic
            # full_refresh tick below, just less often.
            for n in self.node.costs:
                if full_refresh or self.rd.get(n, DUAL_INF) >= DUAL_INF:
                    self.node._enqueue(
                        n, DualMsg(self.root, "update", self.dist)
                    )

    def status(self) -> RootStatus:
        return RootStatus(
            root=self.root, dist=self.dist, parent=self.parent,
            state=self.state,
        )


class DualNode:
    """All DUAL machines at one node, one per known flood-root candidate.
    Root candidates are discovered from
    the messages themselves: any message about an unknown root
    instantiates its machine; root-eligible nodes originate their own.
    """

    def __init__(
        self,
        node_name: str,
        is_root: bool,
        send: Callable[[str, list[DualMsg]], None],
        on_parent_change: Callable[[str, str | None, str | None], None]
        | None = None,
    ):
        self.node_name = node_name
        self.is_root = is_root
        self._send = send
        self._on_parent_change_cb = on_parent_change
        self.costs: dict[str, int] = {}  # neighbor -> link cost
        self.roots: dict[str, _RootState] = {}
        self._outbox: dict[str, list[DualMsg]] = {}
        self._depth = 0
        self._tick_count = 0
        if is_root:
            self.roots[node_name] = _RootState(node_name, self)

    # -------------------------------------------------------- msg batching

    def _enqueue(self, nbr: str, msg: DualMsg) -> None:
        self._outbox.setdefault(nbr, []).append(msg)

    def _flush(self) -> None:
        """Deliver batched messages once the outermost event unwinds (one
        wire message per neighbor per input event)."""
        if self._depth > 0:
            return
        while self._outbox:
            out, self._outbox = self._outbox, {}
            for nbr, msgs in out.items():
                if nbr in self.costs:
                    self._send(nbr, msgs)

    def _event(self, fn) -> None:
        self._depth += 1
        try:
            fn()
        finally:
            self._depth -= 1
        self._flush()

    # ------------------------------------------------------------- inputs

    def peer_up(self, nbr: str, cost: int = 1) -> None:
        def go():
            self.costs[nbr] = cost
            for rs in self.roots.values():
                rs.on_peer_up(nbr)
                rs.on_event()

        self._event(go)

    def peer_down(self, nbr: str) -> None:
        def go():
            if self.costs.pop(nbr, None) is None:
                return
            for rs in self.roots.values():
                rs.on_peer_down(nbr)

        self._event(go)

    def peer_cost_change(self, nbr: str, cost: int) -> None:
        def go():
            if nbr in self.costs:
                self.costs[nbr] = cost
                for rs in self.roots.values():
                    rs.on_event()

        self._event(go)

    def process_messages(self, from_nbr: str, msgs: list[DualMsg]) -> None:
        def go():
            if from_nbr not in self.costs:
                return  # stale message from a departed peer
            for m in msgs:
                rs = self.roots.get(m.root)
                if rs is None:
                    rs = self.roots[m.root] = _RootState(m.root, self)
                if m.mtype == "update":
                    rs.on_update(from_nbr, m.dist)
                elif m.mtype == "query":
                    rs.on_query(from_nbr, m.dist)
                elif m.mtype == "reply":
                    rs.on_reply(from_nbr, m.dist)

        self._event(go)

    # -------------------------------------------------------------- output

    def _on_parent_change(
        self, root: str, old: str | None, new: str | None
    ) -> None:
        if self._on_parent_change_cb is not None:
            self._on_parent_change_cb(root, old, new)

    def tick(self, max_sia_probes: int = 3, dead_root_ticks: int = 3) -> None:
        """Periodic self-healing: retransmit/unwedge ACTIVE machines,
        refresh PASSIVE introductions, and prune machines for roots that
        have been unreachable for `dead_root_ticks` consecutive ticks —
        without pruning, every root-eligible node name that EVER existed
        would stay in the dict (and on the wire) for the cluster's
        lifetime (see _RootState.tick)."""

        self._tick_count += 1
        # every Nth tick is a full PASSIVE re-advertisement to ALL
        # neighbors — the backstop that heals a dropped update toward a
        # neighbor whose rd is finite (targeted refresh can't see those)
        full_refresh = self._tick_count % FULL_REFRESH_EVERY == 0

        def go():
            for rs in self.roots.values():
                rs.tick(max_sia_probes, full_refresh=full_refresh)
            for root in [
                r for r, rs in self.roots.items()
                if rs.dead_ticks >= dead_root_ticks and not rs.i_am_root
            ]:
                del self.roots[root]

        self._event(go)

    def pick_flood_root(self) -> str | None:
        """Smallest root id with a finite distance (the same choice on
        every node)."""
        best = None
        for root, rs in sorted(self.roots.items()):
            if rs.dist < DUAL_INF:
                best = root
                break
        return best

    def status(self) -> dict[str, RootStatus]:
        return {r: rs.status() for r, rs in self.roots.items()}

    def parent_for(self, root: str) -> str | None:
        rs = self.roots.get(root)
        return rs.parent if rs else None

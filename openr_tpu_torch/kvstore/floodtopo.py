"""Flood-topology manager: a DUAL-elected spanning tree for KvStore
floods (the port's copy of `openr_tpu/kvstore/floodtopo.py`).

When `enable_flood_optimization` is set, each area runs a DualNode over
its peers (unit link costs), elects the smallest reachable flood root,
and restricts incremental floods to its SPT neighbors: the parent
toward the root plus any children that registered themselves via
FLOOD_TOPO_SET. Full syncs and anti-entropy still go peer-to-peer, so a
transient tree break only delays — never loses — convergence.
"""

from __future__ import annotations

import asyncio
import logging
from typing import TYPE_CHECKING

from openr_tpu_torch.dual import DualMsg, DualNode, RootStatus
from openr_tpu_torch.dual.dual import SELF

if TYPE_CHECKING:
    from openr_tpu_torch.kvstore.kvstore import KvStore

log = logging.getLogger(__name__)


class FloodTopo:
    """One area's flooding spanning tree."""

    def __init__(self, area: str, store: "KvStore", is_root: bool):
        self.area = area
        self.store = store
        self.dual = DualNode(
            store.node_name,
            is_root=is_root,
            send=self._send_msgs,
            on_parent_change=self._parent_changed,
        )
        self.children: dict[str, set[str]] = {}  # root -> children peers

    # ------------------------------------------------------------- wiring

    def _session(self, nbr: str):
        peer = self.store.peers.get((self.area, nbr))
        return peer.session if peer is not None else None

    def _send_msgs(self, nbr: str, msgs: list[DualMsg]) -> None:
        sess = self._session(nbr)
        if sess is None:
            return  # peer flapped; DUAL re-introduces on next peer_up
        payload = [m.to_json() for m in msgs]
        self.store.spawn(self._send_one(sess, nbr, payload))

    async def _send_one(self, sess, nbr: str, payload: list[dict]) -> None:
        try:
            await sess.dual_messages(self.area, self.store.node_name, payload)
        except asyncio.CancelledError:
            raise
        except Exception:  # noqa: BLE001
            log.debug("dual send to %s failed", nbr)

    def _parent_changed(
        self, root: str, old: str | None, new: str | None
    ) -> None:
        for target, flag in ((old, False), (new, True)):
            if target is None or target == SELF:
                continue
            sess = self._session(target)
            if sess is None:
                continue
            self.store.spawn(
                self._set_child(sess, root, flag),
            )

    async def _set_child(self, sess, root: str, flag: bool) -> None:
        try:
            await sess.flood_topo_set(
                self.area, root, self.store.node_name, flag
            )
        except asyncio.CancelledError:
            raise
        except Exception:  # noqa: BLE001
            pass

    # ------------------------------------------------------------- inputs

    def tick(self) -> None:
        """Periodic self-healing (driven by KvStore's timer): DUAL
        retransmit/introduction refresh, plus an idempotent re-register
        of ourselves as our parent's child — a FLOOD_TOPO_SET dropped
        while the parent's session was down would otherwise leave that
        tree edge broken until the next parent change."""
        self.dual.tick()
        root = self.dual.pick_flood_root()
        if root is None:
            return
        parent = self.dual.parent_for(root)
        if parent is None or parent == SELF:
            return
        sess = self._session(parent)
        if sess is not None:
            self.store.spawn(self._set_child(sess, root, True))

    def peer_up(self, nbr: str) -> None:
        self.dual.peer_up(nbr, cost=1)

    def peer_down(self, nbr: str) -> None:
        self.dual.peer_down(nbr)
        for kids in self.children.values():
            kids.discard(nbr)

    def handle_messages(self, from_nbr: str, raw: list[dict]) -> None:
        self.dual.process_messages(
            from_nbr, [DualMsg.from_json(r) for r in raw]
        )

    def handle_topo_set(self, root: str, child: str, flag: bool) -> None:
        kids = self.children.setdefault(root, set())
        if flag:
            kids.add(child)
        else:
            kids.discard(child)

    # ------------------------------------------------------------- output

    def flood_peers(self) -> set[str] | None:
        """Peers to flood to, or None for flood-to-all: the SPT peers
        when the DUAL root is elected and reachable, else every peer."""
        root = self.dual.pick_flood_root()
        if root is None:
            return None
        peers: set[str] = set(self.children.get(root, ()))
        parent = self.dual.parent_for(root)
        if parent is not None and parent != SELF:
            peers.add(parent)
        if not peers and self.dual.costs:
            # tree not confirmed yet (e.g. we elected ourselves root but
            # no child has registered): over-flood rather than suppress
            return None
        return peers

    def status(self) -> dict:
        """SPT dump. `mode` is
        "spt" when tree-restricted, "all-peers" while falling back to
        full flooding — an empty peer list under "all-peers" means
        flooding to EVERYONE, not to nobody."""
        infos: dict[str, RootStatus] = self.dual.status()
        spt = self.flood_peers()
        return {
            "flood_root": self.dual.pick_flood_root(),
            "mode": "all-peers" if spt is None else "spt",
            "flood_peers": sorted(
                spt if spt is not None else self.dual.costs
            ),
            "roots": {
                r: {
                    "dist": s.dist,
                    "parent": s.parent,
                    "state": s.state,
                    "children": sorted(self.children.get(r, ())),
                }
                for r, s in infos.items()
            },
        }

"""Packet I/O for Spark (the port's copy of `openr_tpu/spark/io.py`).

`MockIoHub` is an in-process packet fabric: point-to-point links between
(node, interface) endpoints with latency and up/down control, the event
loop as the pump. `UdpIoProvider` is real UDP: one socket an interface
on localhost, each bound to a fixed peer address. Both bound a node's
inbox and shed its oldest packet at the bound (hellos are periodic and
supersede each other), counted as `spark.inbox_dropped`.
"""

from __future__ import annotations

import asyncio
from dataclasses import dataclass
from typing import Protocol

from openr_tpu_torch.common.constants import SPARK_INBOX_MAXSIZE
from openr_tpu_torch.messaging import RQueue


class IoProvider(Protocol):
    async def recv(self) -> tuple[str, bytes]:
        """Returns (local_if_name, payload)."""
        ...

    async def send(self, if_name: str, payload: bytes) -> None: ...

    def close(self) -> None: ...


@dataclass
class _MockLink:
    a: tuple[str, str]  # (node, if)
    b: tuple[str, str]
    latency_ms: float = 0.0
    up: bool = True


class MockIoHub:
    """In-process packet fabric: point-to-point links between (node, if)
    endpoints with latency and up/down control."""

    # per-node inbox bound: a partitioned or stalled receiver sheds its
    # OLDEST packets (hellos are periodic and self-superseding, so the
    # newest state always survives) instead of growing RAM without limit
    INBOX_MAX = SPARK_INBOX_MAXSIZE

    def __init__(self, inbox_max: int | None = None):
        self._links: list[_MockLink] = []
        self._inboxes: dict[str, RQueue] = {}
        self.inbox_max = self.INBOX_MAX if inbox_max is None else inbox_max
        self.inbox_drops: dict[str, int] = {}  # dst node -> dropped packets
        self._counters: dict[str, object] = {}  # dst node -> Counters

    def io_for(self, node: str) -> "MockIo":
        # the bound and shed-oldest policy live in the queue itself;
        # _inbox_put keeps the per-node drop accounting
        # (`spark.inbox_dropped`) at the shed point
        self._inboxes.setdefault(
            node,
            RQueue(
                name=f"spark.inbox.{node}",
                maxsize=self.inbox_max,
                policy="shed_oldest",
            ),
        )
        return MockIo(self, node)

    def set_counters(self, node: str, counters) -> None:
        """Attach a node's Counters registry so inbox drops surface as
        that node's `spark.inbox_dropped` counter (the hub exists before
        the nodes do, so registration is a second step)."""
        self._counters[node] = counters

    def link(
        self,
        a_node: str,
        a_if: str,
        b_node: str,
        b_if: str,
        latency_ms: float = 0.0,
    ) -> _MockLink:
        lk = _MockLink(a=(a_node, a_if), b=(b_node, b_if), latency_ms=latency_ms)
        self._links.append(lk)
        return lk

    def set_link(self, a_node: str, a_if: str, up: bool) -> None:
        """Partition control: take every link touching (node, if) up/down."""
        for lk in self._links:
            if (a_node, a_if) in (lk.a, lk.b):
                lk.up = up

    def drop_node(self, node: str) -> None:
        """Forget a node's inbox (emulated crash): in-flight and future
        packets to it are discarded until `io_for` recreates the inbox,
        so a restarted node never replays its dead incarnation's
        backlog."""
        self._inboxes.pop(node, None)

    def _deliver(self, src_node: str, src_if: str, payload: bytes) -> None:
        for lk in self._links:
            if not lk.up:
                continue
            if lk.a == (src_node, src_if):
                dst_node, dst_if = lk.b
            elif lk.b == (src_node, src_if):
                dst_node, dst_if = lk.a
            else:
                continue
            inbox = self._inboxes.get(dst_node)
            if inbox is None:
                continue
            self._enqueue(lk, dst_node, dst_if, payload, inbox)

    def _enqueue(
        self,
        lk: _MockLink,
        dst_node: str,
        dst_if: str,
        payload: bytes,
        inbox: RQueue,
    ) -> None:
        """Final delivery of one packet onto the destination inbox (the
        per-delivery seam a lossy hub overrides)."""
        if lk.latency_ms > 0:
            asyncio.get_event_loop().call_later(
                lk.latency_ms / 1e3, self._inbox_put, dst_node, dst_if, payload
            )
        else:
            self._inbox_put(dst_node, dst_if, payload)

    def _inbox_put(self, dst_node: str, dst_if: str, payload: bytes) -> None:
        """Bounded inbox append (re-resolving the inbox, so a packet
        delayed past a crash is discarded with the dead incarnation).
        At the bound the oldest packet is shed and counted."""
        inbox = self._inboxes.get(dst_node)
        if inbox is None:
            return
        if inbox.full:
            # the RQueue sheds its own oldest at the bound; this branch
            # just keeps the per-node drop accounting
            self.inbox_drops[dst_node] = self.inbox_drops.get(dst_node, 0) + 1
            c = self._counters.get(dst_node)
            if c is not None:
                c.increment("spark.inbox_dropped")
        inbox.put_nowait((dst_if, payload))


class MockIo:
    def __init__(self, hub: MockIoHub, node: str):
        self._hub = hub
        self.node = node

    def attach_counters(self, counters) -> None:
        """Spark hands its node's Counters down at construction so hub
        inbox drops surface as `spark.inbox_dropped` (same seam on every
        IoProvider)."""
        self._hub.set_counters(self.node, counters)

    async def recv(self) -> tuple[str, bytes]:
        return await self._hub._inboxes[self.node].get()

    async def send(self, if_name: str, payload: bytes) -> None:
        self._hub._deliver(self.node, if_name, payload)

    def close(self) -> None:
        pass


class UdpIoProvider:
    """Real UDP I/O: one socket per interface. Without per-interface
    network namespaces, interfaces map to localhost UDP ports: an
    interface's registration supplies (local_port, peer_addr)."""

    def __init__(self, inbox_max: int = SPARK_INBOX_MAXSIZE):
        self._transports: dict[str, asyncio.DatagramTransport] = {}
        self._peers: dict[str, tuple[str, int]] = {}
        # bounded rx queue, shedding its oldest
        self._rx: RQueue = RQueue(
            name="spark.udp.rx", maxsize=inbox_max, policy="shed_oldest"
        )
        self.inbox_max = inbox_max
        self.rx_dropped = 0  # oldest-shed count at the rx bound
        self._counters = None
        # socket-level partition rules: interfaces in this set neither
        # send nor deliver received datagrams (the UDP counterpart of
        # MockIoHub.set_link(up=False)); dropping rx as well as tx keeps
        # a partition symmetric when only one side got the rule
        self._dropped_ifs: set[str] = set()

    def set_drop(self, if_name: str, dropped: bool) -> None:
        """Install/remove a per-interface drop rule (partition chaos)."""
        if dropped:
            self._dropped_ifs.add(if_name)
        else:
            self._dropped_ifs.discard(if_name)

    def clear_drops(self) -> None:
        self._dropped_ifs.clear()

    def drop_rules(self) -> list[str]:
        return sorted(self._dropped_ifs)

    def attach_counters(self, counters) -> None:
        """Export rx sheds as `spark.inbox_dropped` (wired by Spark)."""
        self._counters = counters

    async def add_interface(
        self, if_name: str, local_port: int = 0,
        peer: tuple[str, int] | None = None,
    ) -> int:
        loop = asyncio.get_event_loop()
        rx = self._rx

        provider = self

        class Proto(asyncio.DatagramProtocol):
            def datagram_received(self, data, addr):
                if if_name in provider._dropped_ifs:
                    # partitioned interface: discard at the socket edge,
                    # exactly where a real filtered link loses packets
                    if provider._counters is not None:
                        provider._counters.increment("spark.chaos_dropped")
                    return
                # bounded rx: the RQueue sheds its oldest at the bound
                # (periodic Spark traffic is self-superseding); count
                # the drop here where the node identity is known
                if rx.full:
                    provider.rx_dropped += 1
                    if provider._counters is not None:
                        provider._counters.increment("spark.inbox_dropped")
                rx.put_nowait((if_name, data))

        transport, _ = await loop.create_datagram_endpoint(
            Proto, local_addr=("127.0.0.1", local_port)
        )
        self._transports[if_name] = transport
        if peer:
            self._peers[if_name] = peer
        return transport.get_extra_info("sockname")[1]

    def set_peer(self, if_name: str, peer: tuple[str, int]) -> None:
        self._peers[if_name] = peer

    async def recv(self) -> tuple[str, bytes]:
        return await self._rx.get()

    async def send(self, if_name: str, payload: bytes) -> None:
        if if_name in self._dropped_ifs:
            if self._counters is not None:
                self._counters.increment("spark.chaos_dropped")
            return
        t = self._transports.get(if_name)
        peer = self._peers.get(if_name)
        if t is not None and peer is not None:
            t.sendto(payload, peer)

    def close(self) -> None:
        for t in self._transports.values():
            t.close()
        self._transports.clear()

"""The Spark module: per-(interface, neighbour) discovery (the port's
copy of `openr_tpu/spark/spark.py`).

A neighbour's state machine runs IDLE -> WARM -> NEGOTIATE -> ESTABLISHED
(and RESTART for a graceful restart):

  * hellos go out on every interface, at the fast-init cadence on a new
    interface until its neighbours answer, and carry the sender's heard
    map with timestamps; seeing our own name in a neighbour's hello
    proves the link works both ways -> NEGOTIATE.
  * the handshake negotiates the area and carries the transport
    endpoints (KvStore port, ctrl port, host), the hold times and the
    neighbour's label.
  * heartbeats keep an ESTABLISHED neighbour alive; the hold timer's
    expiry -> NEIGHBOR_DOWN.
  * the RTT comes from our own hello timestamp echoed back with the
    neighbour's turnaround lag: both ends of the subtraction are our clock.
  * graceful restart: a hello with `restarting` -> NEIGHBOR_RESTARTING;
    the adjacency is held for the graceful-restart time, and the new
    instance's handshake -> NEIGHBOR_RESTARTED.

Packets are `SparkPacket`s in the binary codec (`wire_codec="json"` sends
canonical JSON); every packet received is sniffed (`from_wire_auto`).
The bytes are the JAX package's, so a port node and a JAX node find each
other. Spark holds no device state.
"""

from __future__ import annotations

import enum
import logging
import time
from dataclasses import dataclass, field

from openr_tpu_torch.common.eventbase import OpenrModule
from openr_tpu_torch.config import Config
from openr_tpu_torch.messaging import ReplicateQueue
from openr_tpu_torch.monitor import perf
from openr_tpu_torch.types.events import (
    NeighborEvent,
    NeighborEventType,
    NeighborInfo,
)
from openr_tpu_torch.types.serde import (
    from_wire_auto,
    register_wire_types,
    to_wire,
    to_wire_bin,
)

log = logging.getLogger(__name__)


class SparkNeighborState(enum.IntEnum):
    IDLE = 0
    WARM = 1
    NEGOTIATE = 2
    ESTABLISHED = 3
    RESTART = 4


@dataclass
class HelloMsg:
    node_name: str
    if_name: str
    seq: int
    # neighbors I can hear on this interface: name -> [their_seq,
    # their_sent_ts_us echoed back verbatim, my_turnaround_lag_us]
    # (bidirectional check + NTP-free RTT: the echo is on the receiver's
    # own clock; the lag is a duration, clock-independent)
    heard: dict[str, tuple[int, int, int]] = field(default_factory=dict)
    sent_ts_us: int = 0
    restarting: bool = False
    fastinit: bool = False


@dataclass
class HandshakeMsg:
    node_name: str
    if_name: str
    area: str
    hold_time_ms: int
    gr_time_ms: int
    kvstore_port: int
    ctrl_port: int
    endpoint_host: str = ""
    label: int = 0
    # set when the sender has already accepted us (stops retransmits)
    is_ack: bool = False


@dataclass
class HeartbeatMsg:
    node_name: str
    if_name: str
    seq: int
    hold_time_ms: int


@dataclass
class SparkPacket:
    hello: HelloMsg | None = None
    handshake: HandshakeMsg | None = None
    heartbeat: HeartbeatMsg | None = None


@dataclass
class _Neighbor:
    node_name: str
    local_if: str
    state: SparkNeighborState = SparkNeighborState.IDLE
    remote_if: str = ""
    area: str = "0"
    hold_time_ms: int = 0
    gr_time_ms: int = 0
    kvstore_port: int = 0
    ctrl_port: int = 0
    endpoint_host: str = ""
    label: int = 0
    rtt_us: int = 0
    last_heard: float = 0.0
    last_seq: int = 0
    handshake_done: bool = False
    # when our last handshake to it went out (monotonic s), in NEGOTIATE
    handshake_sent_at: float = 0.0
    # RTT measurement state: the neighbor's latest hello sent-timestamp
    # (THEIR clock, echoed back verbatim) and when we received it (OUR
    # monotonic clock), so our next hello can report our turnaround lag.
    last_their_sent_us: int = 0
    last_recv_mono_us: int = 0


class Spark(OpenrModule):
    def __init__(
        self,
        config: Config,
        io,  # IoProvider
        neighbor_events: ReplicateQueue,
        kvstore_port: int = 0,
        ctrl_port: int = 0,
        endpoint_host: str = "127.0.0.1",
        counters=None,
    ):
        super().__init__(f"{config.node_name}.spark", counters=counters)
        self.config = config
        self.node_name = config.node_name
        self.io = io
        self.events = neighbor_events
        self.kvstore_port = kvstore_port
        self.ctrl_port = ctrl_port
        self.endpoint_host = endpoint_host
        self.interfaces: set[str] = set()
        # tx codec: compact binary frames by default, "json" for
        # canonical-JSON packets. The rx path sniffs every packet's first
        # byte (from_wire_auto), so either codec is always accepted.
        self._encode = (
            to_wire_bin
            if config.node.spark.wire_codec == "bin"
            else to_wire
        )
        # inbox-shed visibility: every IoProvider that bounds its rx
        # queue exports drops through this node's counters
        attach = getattr(io, "attach_counters", None)
        if attach is not None and counters is not None:
            attach(counters)
        # (if_name, neighbor_name) -> state
        self.neighbors: dict[tuple[str, str], _Neighbor] = {}
        self.seq = 0
        self._fastinit_until: dict[str, float] = {}

    # ---------------------------------------------------------------- setup

    def add_interface(self, if_name: str) -> None:
        """Start discovery on an interface (from LinkMonitor), at the
        fast-init hello cadence."""
        if if_name in self.interfaces:
            return
        self.interfaces.add(if_name)
        cfg = self.config.node.spark
        self._fastinit_until[if_name] = (
            time.monotonic() + 4 * cfg.hello_time_ms / 1e3
        )

    def remove_interface(self, if_name: str) -> None:
        self.interfaces.discard(if_name)
        for key in [k for k in self.neighbors if k[0] == if_name]:
            self._neighbor_down(self.neighbors[key], "interface removed")

    # ----------------------------------------------------------------- main

    async def main(self) -> None:
        cfg = self.config.node.spark
        self.spawn(self._rx_loop(), name=f"{self.name}.rx")
        self.run_every(
            cfg.fastinit_hello_time_ms / 1e3,
            self._hello_tick,
            name=f"{self.name}.hello",
        )
        self.run_every(
            cfg.keepalive_time_ms / 1e3,
            self._heartbeat_tick,
            name=f"{self.name}.hb",
        )
        self.run_every(
            cfg.keepalive_time_ms / 1e3 / 2,
            self._hold_timer_tick,
            name=f"{self.name}.hold",
        )

    async def cleanup(self) -> None:
        self.io.close()

    # ------------------------------------------------------------------- tx

    _last_slow_hello: float = 0.0

    async def _hello_tick(self) -> None:
        """Hellos at fast-init cadence on fresh interfaces, normal cadence
        otherwise (the timer runs at fastinit rate; slow interfaces skip)."""
        cfg = self.config.node.spark
        now = time.monotonic()
        slow_due = now - self._last_slow_hello >= cfg.hello_time_ms / 1e3
        if slow_due:
            self._last_slow_hello = now
        self.seq += 1
        for if_name in list(self.interfaces):
            fast = now < self._fastinit_until.get(if_name, 0)
            if not (fast or slow_due):
                continue
            heard = {}
            now_us = int(now * 1e6)
            for (ifn, nname), nb in self.neighbors.items():
                if ifn != if_name or nb.state == SparkNeighborState.IDLE:
                    continue
                lag_us = now_us - nb.last_recv_mono_us if nb.last_recv_mono_us else 0
                heard[nname] = (nb.last_seq, nb.last_their_sent_us, lag_us)
            pkt = SparkPacket(
                hello=HelloMsg(
                    node_name=self.node_name,
                    if_name=if_name,
                    seq=self.seq,
                    heard=heard,
                    sent_ts_us=int(now * 1e6),
                    fastinit=fast,
                )
            )
            await self.io.send(if_name, self._encode(pkt))
            if self.counters is not None:
                self.counters.increment("spark.hello_sent")

    async def announce_restart(self) -> None:
        """Tell every neighbor we are about to gracefully restart: a
        hello with restarting=true, so that peers hold the adjacency for
        gr_time instead of withdrawing it at the hold timer's expiry.

        These are the instance's last words: the interface set is
        cleared afterwards so a hello tick racing the (yielding) module
        teardown can't send a restarting=False hello that would cancel
        the GR hold on the receivers."""
        self.seq += 1
        now_us = int(time.monotonic() * 1e6)
        interfaces, self.interfaces = list(self.interfaces), set()
        for if_name in interfaces:
            pkt = SparkPacket(
                hello=HelloMsg(
                    node_name=self.node_name,
                    if_name=if_name,
                    seq=self.seq,
                    sent_ts_us=now_us,
                    restarting=True,
                )
            )
            await self.io.send(if_name, self._encode(pkt))
            if self.counters is not None:
                self.counters.increment("spark.restart_announced")

    async def _heartbeat_tick(self) -> None:
        cfg = self.config.node.spark
        sent_ifs = set()
        for (if_name, _), nb in self.neighbors.items():
            if nb.state != SparkNeighborState.ESTABLISHED:
                continue
            if if_name in sent_ifs:
                continue
            sent_ifs.add(if_name)
            self.seq += 1
            pkt = SparkPacket(
                heartbeat=HeartbeatMsg(
                    node_name=self.node_name,
                    if_name=if_name,
                    seq=self.seq,
                    hold_time_ms=cfg.hold_time_ms,
                )
            )
            await self.io.send(if_name, self._encode(pkt))
            if self.counters is not None:
                self.counters.increment("spark.heartbeat_sent")

    async def _send_handshake(self, nb: _Neighbor, is_ack: bool) -> None:
        cfg = self.config.node.spark
        pkt = SparkPacket(
            handshake=HandshakeMsg(
                node_name=self.node_name,
                if_name=nb.local_if,
                area=self._negotiate_area(nb.node_name),
                hold_time_ms=cfg.hold_time_ms,
                gr_time_ms=cfg.graceful_restart_time_ms,
                kvstore_port=self.kvstore_port,
                ctrl_port=self.ctrl_port,
                endpoint_host=self.endpoint_host,
                label=0,
                is_ack=is_ack,
            )
        )
        await self.io.send(nb.local_if, self._encode(pkt))
        if self.counters is not None:
            self.counters.increment("spark.handshake_sent")

    def _negotiate_area(self, neighbor_name: str) -> str:
        """The first area whose neighbor regexes match the neighbour's
        name, else the first area."""
        import re

        for area in self.config.areas:
            for pattern in area.neighbor_regexes:
                if re.fullmatch(pattern, neighbor_name):
                    return area.area_id
        return self.config.areas[0].area_id

    # ------------------------------------------------------------------- rx

    async def _rx_loop(self) -> None:
        while True:
            if_name, payload = await self.io.recv()
            if if_name not in self.interfaces:
                continue
            try:
                pkt = from_wire_auto(payload, SparkPacket)
            except Exception:  # noqa: BLE001
                if self.counters is not None:
                    self.counters.increment("spark.bad_packets")
                continue
            if pkt.hello is not None:
                self._on_hello(if_name, pkt.hello)
            elif pkt.handshake is not None:
                await self._on_handshake(if_name, pkt.handshake)
            elif pkt.heartbeat is not None:
                self._on_heartbeat(if_name, pkt.heartbeat)

    def _nb(self, if_name: str, node: str) -> _Neighbor:
        key = (if_name, node)
        if key not in self.neighbors:
            self.neighbors[key] = _Neighbor(node_name=node, local_if=if_name)
        return self.neighbors[key]

    def _on_hello(self, if_name: str, hello: HelloMsg) -> None:
        if hello.node_name == self.node_name:
            return
        nb = self._nb(if_name, hello.node_name)
        now = time.monotonic()
        nb.last_heard = now
        nb.last_seq = hello.seq
        nb.remote_if = hello.if_name
        if self.counters is not None:
            self.counters.increment("spark.hello_recv")

        was_established = nb.state in (
            SparkNeighborState.ESTABLISHED,
            SparkNeighborState.RESTART,
        )
        if hello.restarting:
            if nb.state == SparkNeighborState.ESTABLISHED:
                nb.state = SparkNeighborState.RESTART
                # the restarting instance's transport endpoints die with
                # it: a REAL restart comes back on fresh (ephemeral)
                # ports, so the cached handshake is void — re-establish
                # only after the new instance handshakes again
                nb.handshake_done = False
                self._emit(NeighborEventType.NEIGHBOR_RESTARTING, nb)
            return

        now_us = int(now * 1e6)
        nb.last_their_sent_us = hello.sent_ts_us
        nb.last_recv_mono_us = now_us

        heard_us = self.node_name in hello.heard
        if nb.state == SparkNeighborState.ESTABLISHED and not heard_us:
            # an ESTABLISHED neighbor always carries us in its heard map
            # (entries are only dropped when the neighbor object is), so
            # its absence means the sender is a FRESH instance after a
            # non-graceful restart (SIGKILL/re-exec — it never announced,
            # so we never entered RESTART) or it expired us via its own
            # hold timer. Its transport endpoints may have changed with
            # it: tear down and re-negotiate from scratch so the fresh
            # handshake re-learns the new kvstore/ctrl ports.
            self._neighbor_down(nb, "established neighbor no longer hears us")
            if self.counters is not None:
                self.counters.increment("spark.nongr_restarts_detected")
            nb = self._nb(if_name, hello.node_name)
            nb.last_heard = now
            nb.last_seq = hello.seq
            nb.remote_if = hello.if_name
            nb.last_their_sent_us = hello.sent_ts_us
            nb.last_recv_mono_us = now_us
        if nb.state == SparkNeighborState.IDLE:
            nb.state = SparkNeighborState.WARM
        if heard_us:
            # RTT: the neighbor echoed OUR sent timestamp plus its
            # turnaround lag; both endpoints of the subtraction are our
            # clock.
            _seq, echoed_sent_us, their_lag_us = hello.heard[self.node_name]
            if echoed_sent_us > 0 and their_lag_us >= 0:
                raw_rtt = now_us - echoed_sent_us - their_lag_us
                if raw_rtt > 0:
                    self._update_rtt(nb, raw_rtt)
            if nb.state == SparkNeighborState.WARM or (
                nb.state == SparkNeighborState.NEGOTIATE
                and now - nb.handshake_sent_at
                >= self.config.node.spark.handshake_time_ms / 1e3
            ):
                # in NEGOTIATE a hello that hears us, handshake_time_ms
                # after our handshake, sends it again: the handshake and
                # its ack are single packets, and with both lost the
                # neighbour, ESTABLISHED on our earlier ack, would never
                # send another (Open/R's Spark repeats its handshake every
                # handshakeTime for the same reason)
                nb.state = SparkNeighborState.NEGOTIATE
                nb.handshake_sent_at = now
                self.spawn(self._send_handshake(nb, is_ack=False))
            elif (
                nb.state == SparkNeighborState.RESTART
                and nb.handshake_done
            ):
                # neighbor came back from graceful restart AND its new
                # instance has re-handshaked (fresh kvstore/ctrl ports).
                # Re-establishing on the hello alone would advertise the
                # pre-restart endpoints — a peer that no longer exists
                # when the restart was a real process re-exec.
                nb.state = SparkNeighborState.ESTABLISHED
                self._emit(NeighborEventType.NEIGHBOR_RESTARTED, nb)

    # an EWMA + 10% emit-threshold: ignore jitter, report real shifts
    RTT_EWMA_ALPHA = 0.5
    RTT_CHANGE_FRACTION = 0.1

    def _update_rtt(self, nb: _Neighbor, raw_rtt_us: int) -> None:
        old = nb.rtt_us
        nb.rtt_us = (
            raw_rtt_us
            if old == 0
            else int(
                self.RTT_EWMA_ALPHA * raw_rtt_us
                + (1 - self.RTT_EWMA_ALPHA) * old
            )
        )
        if (
            nb.state == SparkNeighborState.ESTABLISHED
            and abs(nb.rtt_us - old) > self.RTT_CHANGE_FRACTION * max(old, 1)
        ):
            self._emit(NeighborEventType.NEIGHBOR_RTT_CHANGE, nb)

    async def _on_handshake(self, if_name: str, hs: HandshakeMsg) -> None:
        if hs.node_name == self.node_name:
            return
        nb = self._nb(if_name, hs.node_name)
        now = time.monotonic()
        nb.last_heard = now
        nb.area = hs.area
        nb.hold_time_ms = hs.hold_time_ms
        nb.gr_time_ms = hs.gr_time_ms
        nb.kvstore_port = hs.kvstore_port
        nb.ctrl_port = hs.ctrl_port
        nb.endpoint_host = hs.endpoint_host
        nb.label = hs.label
        if self.counters is not None:
            self.counters.increment("spark.handshake_recv")
        if not hs.is_ack:
            await self._send_handshake(nb, is_ack=True)
        if nb.state in (SparkNeighborState.WARM, SparkNeighborState.NEGOTIATE):
            nb.state = SparkNeighborState.ESTABLISHED
            nb.handshake_done = True
            self._emit(NeighborEventType.NEIGHBOR_UP, nb)
        elif nb.state == SparkNeighborState.RESTART:
            # the restarted instance is a fresh FSM, so it ALWAYS
            # handshakes anew — this is the moment its new transport
            # endpoints are known, so re-establish HERE, not on the
            # hello that merely
            # proves it is alive again
            nb.state = SparkNeighborState.ESTABLISHED
            nb.handshake_done = True
            self._emit(NeighborEventType.NEIGHBOR_RESTARTED, nb)
        elif nb.state == SparkNeighborState.ESTABLISHED and not hs.is_ack:
            # a steady-state peer never re-handshakes (handshakes are
            # sent only from NEGOTIATE), so an unsolicited handshake
            # from an ESTABLISHED neighbor is a fresh FSM after a
            # restart we never got the GR announcement for (SIGKILL /
            # re-exec — often the only observable sign: the survivor's
            # own stale heard entry lets the new instance skip straight
            # to NEGOTIATE, so no empty-heard hello ever arrives). The
            # endpoint fields above just took its NEW kvstore/ctrl
            # ports; re-emit so consumers re-peer instead of flooding
            # the dead endpoint forever. A duplicate NEGOTIATE-phase
            # handshake that lost the race to our ack lands here too —
            # the re-emitted endpoints are then unchanged and the
            # consumers' re-peer is a no-op.
            nb.handshake_done = True
            if self.counters is not None:
                self.counters.increment("spark.nongr_restarts_detected")
            self._emit(NeighborEventType.NEIGHBOR_RESTARTED, nb)

    def _on_heartbeat(self, if_name: str, hb: HeartbeatMsg) -> None:
        if hb.node_name == self.node_name:
            return
        key = (if_name, hb.node_name)
        nb = self.neighbors.get(key)
        if nb is None:
            return
        nb.last_heard = time.monotonic()
        nb.hold_time_ms = hb.hold_time_ms or nb.hold_time_ms

    # ------------------------------------------------------------ liveness

    def _hold_timer_tick(self) -> None:
        cfg = self.config.node.spark
        now = time.monotonic()
        for key in list(self.neighbors):
            nb = self.neighbors[key]
            if nb.state == SparkNeighborState.IDLE:
                continue
            hold_s = (nb.hold_time_ms or cfg.hold_time_ms) / 1e3
            if nb.state == SparkNeighborState.RESTART:
                hold_s = (nb.gr_time_ms or cfg.graceful_restart_time_ms) / 1e3
            if now - nb.last_heard > hold_s:
                self._neighbor_down(nb, "hold timer expired")

    def _neighbor_down(self, nb: _Neighbor, why: str) -> None:
        was_up = nb.state in (
            SparkNeighborState.ESTABLISHED,
            SparkNeighborState.RESTART,
        )
        log.debug("%s: neighbor %s down (%s)", self.name, nb.node_name, why)
        self.neighbors.pop((nb.local_if, nb.node_name), None)
        if was_up:
            self._emit(NeighborEventType.NEIGHBOR_DOWN, nb)
            if self.counters is not None:
                self.counters.increment("spark.neighbor_down")

    # -------------------------------------------------------------- events

    def _emit(self, etype: NeighborEventType, nb: _Neighbor) -> None:
        self.events.push(
            NeighborEvent(
                type=etype,
                perf_events=perf.PerfEvents.start(
                    perf.NEIGHBOR_EVENT, node=self.node_name
                ),
                info=NeighborInfo(
                    node_name=nb.node_name,
                    local_if=nb.local_if,
                    remote_if=nb.remote_if,
                    area=nb.area,
                    kvstore_port=nb.kvstore_port,
                    ctrl_port=nb.ctrl_port,
                    hold_time_ms=nb.hold_time_ms,
                    gr_time_ms=nb.gr_time_ms,
                    rtt_us=nb.rtt_us,
                    label=nb.label,
                    endpoint_host=nb.endpoint_host,
                ),
            )
        )
        if self.counters is not None and etype == NeighborEventType.NEIGHBOR_UP:
            self.counters.increment("spark.neighbor_up")


# wire-schema lock registration: the four UDP discovery frame types
register_wire_types(HelloMsg, HandshakeMsg, HeartbeatMsg, SparkPacket)

"""Peer transport seam (the port's copy of
`openr_tpu/kvstore/transport.py`): in process for tests, TCP for real.

`InProcKvTransport` wires N stores in one process. Floods still cross a
real encode/decode boundary (bytes in, bytes out), so the codec is paid
honestly: `codec="bin"` is the compact binary codec with a
serialize-once flood path (a Publication fanned out to N peers is
encoded one time, the blob cached on the Publication, and every session
ships the same immutable bytes); `codec="json"` is one canonical-JSON
encode a peer. `TcpKvTransport` opens an `RpcClient` session to a peer's
KvStore listener (`KvStore.register_rpc`); each session negotiates the
binary framing on connect and falls back to JSON lines against a peer
that declines, and its binary flood is one cached `kv.flood` frame
written to every peer (`pub_flood_frame`). `flood` returns the size it
wrote, so KvStore's `kvstore.flood_bytes` is counted from the wire.
"""

from __future__ import annotations

import asyncio
import time
from typing import Any

from openr_tpu_torch.rpc import RpcClient, RpcError, RpcTransportError, bin_frame
from openr_tpu_torch.types.kvstore import Publication
from openr_tpu_torch.types.serde import (
    from_jsonable,
    from_wire,
    from_wire_bin,
    to_jsonable,
    to_wire,
    to_wire_bin,
)


def pub_to_json(pub: Publication) -> dict:
    return to_jsonable(pub)


def pub_from_json(raw: dict) -> Publication:
    return from_jsonable(raw, Publication)


def pub_wire_bin(pub: Publication, counters=None) -> bytes:
    """The Publication's binary blob, encoded at most once per
    Publication object: every peer session reuses these bytes.
    `kvstore.flood_encodes` counts the encodes, `kvstore.flood_encode_ms`
    their CPU time."""
    cache = pub._wire_cache
    if cache is None:
        cache = pub._wire_cache = {}
    blob = cache.get("bin")
    if blob is None:
        t0 = time.perf_counter()
        blob = cache["bin"] = to_wire_bin(pub)
        if counters is not None:
            counters.increment("kvstore.flood_encodes")
            counters.add_value(
                "kvstore.flood_encode_ms",
                (time.perf_counter() - t0) * 1e3,
            )
    return blob


def pub_flood_frame(pub: Publication, counters=None) -> bytes:
    """The complete, immutable ``kv.flood`` notification frame of a
    binary connection. It is the same for every peer (a notification
    carries no request id), so the whole frame is cached beside the blob
    and a TCP fan-out is one ``writer.write(frame)`` a peer."""
    cache = pub._wire_cache
    if cache is None:
        cache = pub._wire_cache = {}
    frame = cache.get("rpc_bin")
    if frame is None:
        frame = cache["rpc_bin"] = bin_frame(
            {
                "method": "kv.flood",
                "params": {"pub_bin": pub_wire_bin(pub, counters)},
            }
        )
    return frame


def decode_flood_params(params: dict) -> Publication:
    """Decode one flood's params, whichever codec it used: `pub_bin`
    (binary blob), `pub_wire` (canonical JSON bytes) or `pub` (a JSON
    tree)."""
    blob = params.get("pub_bin")
    if blob is not None:
        return from_wire_bin(blob, Publication)
    wire = params.get("pub_wire")
    if wire is not None:
        return from_wire(wire, Publication)
    return pub_from_json(params["pub"])


class InProcKvTransport:
    """Registry-based direct delivery between the stores of one process."""

    def __init__(self, codec: str = "bin"):
        if codec not in ("bin", "json"):
            raise ValueError(f"InProcKvTransport: codec {codec!r}")
        self.codec = codec
        self._stores: dict[str, Any] = {}  # node_name -> KvStore

    def register(self, node_name: str, store: Any) -> None:
        self._stores[node_name] = store

    def unregister(self, node_name: str) -> None:
        self._stores.pop(node_name, None)

    async def connect(
        self, peer_id: str, endpoint: Any, counters=None
    ) -> "_InProcSession":
        if peer_id not in self._stores:
            raise ConnectionError(f"no in-proc store {peer_id!r}")
        return _InProcSession(self, peer_id, counters=counters)


class _InProcSession:
    def __init__(
        self, transport: InProcKvTransport, peer_id: str, counters=None
    ):
        self._t = transport
        self.peer_id = peer_id
        self.counters = counters  # the connecting node's counters

    @property
    def codec(self) -> str:
        """The session's codec (the transport's: in-process sessions
        negotiate nothing). KvStore's flood drain ships a pre-encoded
        blob only when this is "bin"."""
        return self._t.codec

    def _peer(self):
        store = self._t._stores.get(self.peer_id)
        if store is None:
            raise ConnectionError(f"in-proc store {self.peer_id!r} gone")
        return store

    async def full_sync(
        self, area: str, sender_id: str, digest: dict | None,
        store_hash: int | None = None,
    ) -> dict:
        return await self._peer().handle_full_sync(
            {
                "area": area,
                "sender": sender_id,
                "digest": digest,
                "store_hash": store_hash,
            }
        )

    async def flood(self, pub: Publication) -> int:
        # yield to the loop: the network boundary stays asynchronous
        await asyncio.sleep(0)
        if self._t.codec == "bin":
            blob = pub_wire_bin(pub, self.counters)
            await self._peer().handle_flood({"pub_bin": blob})
        else:
            t0 = time.perf_counter()
            blob = to_wire(pub)
            if self.counters is not None:
                self.counters.increment("kvstore.flood_encodes")
                self.counters.add_value(
                    "kvstore.flood_encode_ms",
                    (time.perf_counter() - t0) * 1e3,
                )
            await self._peer().handle_flood({"pub_wire": blob})
        return len(blob)

    async def dual_messages(
        self, area: str, sender: str, msgs: list[dict]
    ) -> None:
        await asyncio.sleep(0)
        await self._peer().handle_dual_messages(
            {"area": area, "sender": sender, "msgs": msgs}
        )

    async def flood_topo_set(
        self, area: str, root: str, child: str, set_flag: bool
    ) -> None:
        await asyncio.sleep(0)
        await self._peer().handle_flood_topo_set(
            {"area": area, "root": root, "child": child, "set": set_flag}
        )

    async def close(self) -> None:
        pass


class TcpKvTransport:
    """RPC-over-TCP sessions to peers' KvStore listeners. Pass a client
    `ssl.SSLContext` (rpc.tls) for a TLS mesh. Each session negotiates
    the binary framing on connect (rpc ``_wire.hello``) and falls back
    to JSON lines against a peer that declines."""

    codec = "bin"  # preferred; per-session actual comes from negotiation

    def __init__(self, ssl=None):
        self.ssl = ssl

    async def connect(
        self, peer_id: str, endpoint: tuple[str, int], counters=None
    ):
        host, port = endpoint
        client = RpcClient(host, port, ssl=self.ssl, counters=counters)
        await client.connect()
        return _TcpSession(client, peer_id, counters=counters)


class _TcpSession:
    def __init__(self, client: RpcClient, peer_id: str, counters=None):
        self._c = client
        self.peer_id = peer_id
        self.counters = counters

    @property
    def codec(self) -> str:
        """The negotiated per-connection codec ("bin" | "json"): a
        JSON-only peer gets a freshly built publication (with its
        defensive trace copy), never the cached binary-path object."""
        return self._c.codec

    async def full_sync(
        self, area: str, sender_id: str, digest: dict | None,
        store_hash: int | None = None,
    ) -> dict:
        try:
            return await self._c.call(
                "kv.fullSync",
                {
                    "area": area,
                    "sender": sender_id,
                    "digest": digest,
                    "store_hash": store_hash,
                },
            )
        except (ConnectionError, RpcTransportError) as e:
            # connection-level death (peer process SIGKILLed mid-sync,
            # RST, timeout) surfaces as ConnectionError so the KvStore
            # repair loop treats it exactly like a refused connect:
            # backoff + retry. A plain RpcError — the peer's HANDLER
            # answered with an error — passes through untouched; that
            # is the only signal the legacy-responder probe may use.
            raise ConnectionError(str(e)) from e

    async def flood(self, pub: Publication) -> int:
        try:
            if self._c.codec == "bin":
                # serialize-once: the complete notification frame is
                # cached on the Publication; N peers, one encode, N
                # writes of the same bytes
                frame = pub_flood_frame(pub, self.counters)
                await self._c.send_frame(frame)
                return len(frame)
            # a JSON-negotiated peer: one encode a peer
            t0 = time.perf_counter()
            tree = pub_to_json(pub)
            if self.counters is not None:
                self.counters.increment("kvstore.flood_encodes")
                self.counters.add_value(
                    "kvstore.flood_encode_ms",
                    (time.perf_counter() - t0) * 1e3,
                )
            return await self._c.notify("kv.flood", {"pub": tree})
        except (ConnectionError, RpcError) as e:
            raise ConnectionError(str(e)) from e

    async def dual_messages(
        self, area: str, sender: str, msgs: list[dict]
    ) -> None:
        try:
            await self._c.notify(
                "kv.dual", {"area": area, "sender": sender, "msgs": msgs}
            )
        except (ConnectionError, RpcError) as e:
            raise ConnectionError(str(e)) from e

    async def flood_topo_set(
        self, area: str, root: str, child: str, set_flag: bool
    ) -> None:
        try:
            await self._c.notify(
                "kv.floodTopoSet",
                {"area": area, "root": root, "child": child, "set": set_flag},
            )
        except (ConnectionError, RpcError) as e:
            raise ConnectionError(str(e)) from e

    async def close(self) -> None:
        await self._c.close()

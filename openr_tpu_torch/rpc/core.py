"""The RPC core (the port's copy of `openr_tpu/rpc/core.py`): request /
response calls, fire-and-forget notifications and server-push streams
over asyncio TCP (optionally TLS, `rpc/tls.py`).

Envelope shape (one object per frame):
  request:      {"id": 1, "method": "m", "params": {...}}
  response:     {"id": 1, "result": {...}} | {"id": 1, "error": "..."}
  notification: {"method": "m", "params": {...}}            (no id)
  stream item:  {"id": 1, "item": {...}}                    (until "end")
  stream end:   {"id": 1, "end": true}

Two framings coexist on a connection:

  * JSON lines: one JSON object per ``\\n``-terminated line. Every
    connection starts here.
  * Binary frames: ``[0xB1][uvarint length][payload]``, the payload a
    complete ``serde.to_wire_bin`` blob of the same envelope dict.

The receive path sniffs every frame's first byte (a JSON text cannot
begin with 0xB1), so it needs no mode state. Only the transmit codec is
negotiated: a client that wants binary sends a ``_wire.hello`` call
first; a server that agrees replies ``{"codec": "bin1"}`` and both sides
switch their writers. The frames are the JAX package's, byte for byte, so
a port node and a JAX node peer with each other.
"""

from __future__ import annotations

import asyncio
import json
import logging
from typing import Any, AsyncIterator, Awaitable, Callable

from openr_tpu_torch.common.tasks import guard_task, reap
from openr_tpu_torch.messaging import QueueClosedError, RQueue
from openr_tpu_torch.types.serde import (
    WIRE_BIN_MAGIC,
    from_wire_bin,
    to_wire_bin,
    write_uvarint,
)

log = logging.getLogger(__name__)

MAX_LINE = 64 * 1024 * 1024  # LSDB dumps can be large

# the codec name the hello negotiates; bumping the serde wire version
# would introduce "bin2" here and old peers would keep matching "bin1"
WIRE_CODEC_BIN = "bin1"

# per-subscription client-side buffer: a slow stream consumer
# backpressures the rx loop (and so, via TCP, the server's per-sub
# eviction queue) instead of growing RAM without bound
STREAM_BUF = 1024

# how long the rx loop will sit blocked at one stream's bound before
# declaring that consumer dead and breaking its stream — a subscriber
# that never drains (or a generator that was never iterated, whose
# cleanup can therefore never run) must not stall every other reply on
# the client forever
STREAM_STALL_S = 30.0

_MAGIC = bytes((WIRE_BIN_MAGIC,))


class RpcError(Exception):
    """Remote handler raised / transport failed."""


class RpcTransportError(RpcError):
    """The CONNECTION failed (refused, reset, closed, timed out) — the
    remote handler never answered. Distinct from a plain RpcError so
    callers running capability probes (KvStore's delta-sync negotiation)
    can tell "the peer's handler rejected this method" from "the peer
    process died mid-call": only the former says anything about what
    the peer supports. Subclasses RpcError, so every existing
    `except RpcError` path is unchanged."""


class WireFrameError(ValueError):
    """Framing is unrecoverable on this connection (bad varint,
    oversized length prefix): the byte stream can no longer be resynced,
    so the CONNECTION is dropped — never the node."""


def _dumps(obj: dict) -> bytes:
    return json.dumps(obj, separators=(",", ":")).encode() + b"\n"


def bin_frame(obj: dict) -> bytes:
    """One binary wire frame: magic + uvarint length + serde blob."""
    blob = to_wire_bin(obj)
    head = bytearray(_MAGIC)
    write_uvarint(head, len(blob))
    return bytes(head) + blob


async def _read_frame(reader: asyncio.StreamReader) -> tuple[str, bytes]:
    """Sniff + read one wire message: ("bin", blob) | ("json", line).

    Raises IncompleteReadError at EOF / mid-frame truncation,
    WireFrameError when the binary framing itself is corrupt, and
    LimitOverrunError for an overlong JSON line.
    """
    first = await reader.readexactly(1)
    if first == _MAGIC:
        n = 0
        shift = 0
        while True:
            b = (await reader.readexactly(1))[0]
            n |= (b & 0x7F) << shift
            if not b & 0x80:
                break
            shift += 7
            if shift > 35:
                raise WireFrameError("unterminated length varint")
        if n > MAX_LINE:
            raise WireFrameError(f"oversized frame ({n} bytes)")
        return "bin", await reader.readexactly(n)
    return "json", first + await reader.readuntil(b"\n")


class _ConnState:
    """Per-connection transmit state: negotiated codec + accounting.
    The receive path sniffs every frame and needs no state."""

    __slots__ = ("writer", "codec", "counters")

    def __init__(self, writer: asyncio.StreamWriter, counters=None):
        self.writer = writer
        self.codec = "json"
        self.counters = counters

    def write_msg(self, msg: dict) -> None:
        data = bin_frame(msg) if self.codec == "bin" else _dumps(msg)
        self.writer.write(data)
        if self.counters is not None:
            self.counters.increment("rpc.bytes_tx", len(data))


class StreamWriter:
    """Handed to streaming handlers to push items to the subscriber."""

    def __init__(self, conn: _ConnState, req_id: int):
        self._conn = conn
        self._id = req_id
        self.closed = False

    async def send(self, item: Any) -> None:
        if self.closed:
            raise RpcTransportError("stream closed")
        try:
            self._conn.write_msg({"id": self._id, "item": item})
            await self._conn.writer.drain()
        except (ConnectionError, RuntimeError) as e:
            self.closed = True
            raise RpcTransportError(f"stream write failed: {e}") from e

    async def end(self) -> None:
        if not self.closed:
            self.closed = True
            try:
                self._conn.write_msg({"id": self._id, "end": True})
                await self._conn.writer.drain()
            except (ConnectionError, RuntimeError):
                pass


Handler = Callable[..., Awaitable[Any]]


class RpcServer:
    """Dispatches methods on incoming connections.

    register(name, fn): async fn(params_dict) -> jsonable result.
    register_stream(name, fn): async fn(params_dict, stream: StreamWriter);
    the stream stays open until fn returns or the client disconnects.

    `binary=True` (default) agrees to binary in ``_wire.hello``
    negotiations; False declines (replies ``{"codec": "json"}``) so the
    connection stays on JSON, as an older peer's would. A truly
    pre-binary server answers the hello with a no-method error, which
    the client treats the same way.
    """

    def __init__(self, name: str = "rpc", counters=None, binary: bool = True):
        self.name = name
        self.counters = counters
        self.binary = binary
        self._methods: dict[str, Handler] = {}
        self._streams: dict[str, Handler] = {}
        self._server: asyncio.AbstractServer | None = None
        self._conn_tasks: set[asyncio.Task] = set()
        self.port: int | None = None

    def register(self, method: str, fn: Handler) -> None:
        self._methods[method] = fn

    def register_stream(self, method: str, fn: Handler) -> None:
        self._streams[method] = fn

    async def start(
        self, host: str = "127.0.0.1", port: int = 0, ssl=None
    ) -> int:
        """Bind and serve; returns the bound port (0 → ephemeral).
        Pass an `ssl.SSLContext` (see rpc.tls) for a TLS listener."""
        self._server = await asyncio.start_server(
            self._on_conn, host, port, limit=MAX_LINE, ssl=ssl
        )
        self.port = self._server.sockets[0].getsockname()[1]
        return self.port

    async def stop(self) -> None:
        # cancel handlers BEFORE wait_closed(): since py3.12 wait_closed
        # blocks until every connection handler returns
        for t in list(self._conn_tasks):
            t.cancel()
        for t in list(self._conn_tasks):
            # swallows only t's own cancellation; one aimed at stop()
            # itself re-raises. cancel=False: all conn tasks were
            # cancelled above.
            await reap(t, cancel=False)
        self._conn_tasks.clear()
        if self._server is not None:
            self._server.close()
            await self._server.wait_closed()
            self._server = None

    async def _on_conn(
        self, reader: asyncio.StreamReader, writer: asyncio.StreamWriter
    ) -> None:
        task = asyncio.current_task()
        if task:
            self._conn_tasks.add(task)
        conn = _ConnState(writer, counters=self.counters)
        stream_tasks: list[asyncio.Task] = []
        try:
            while True:
                try:
                    kind, payload = await _read_frame(reader)
                except asyncio.IncompleteReadError:
                    break  # peer closed (or died mid-frame)
                except (WireFrameError, asyncio.LimitOverrunError,
                        ValueError):
                    # unrecoverable framing: the stream can't be
                    # resynced — drop THIS connection, keep serving
                    log.warning(
                        "%s: unrecoverable framing from peer", self.name
                    )
                    break
                if self.counters is not None:
                    self.counters.increment("rpc.bytes_rx", len(payload))
                try:
                    if kind == "bin":
                        msg = from_wire_bin(payload)
                    else:
                        msg = json.loads(payload)
                except ValueError:
                    # JSONDecodeError *or* UnicodeDecodeError *or*
                    # WireDecodeError: a corrupt payload inside intact
                    # framing — skip the frame, keep the connection
                    log.warning("%s: bad frame from peer", self.name)
                    continue
                if not isinstance(msg, dict):
                    log.warning("%s: non-object frame from peer", self.name)
                    continue
                method = msg.get("method")
                req_id = msg.get("id")
                params = msg.get("params") or {}
                if method == "_wire.hello":
                    # codec negotiation: agree to binary
                    # when both sides support it, then switch OUR
                    # transmit codec; the client switches on seeing the
                    # reply. Reply goes out in the OLD codec.
                    codecs = (
                        params.get("codecs") if isinstance(params, dict)
                        else None
                    ) or []
                    agree = (
                        WIRE_CODEC_BIN
                        if self.binary and WIRE_CODEC_BIN in codecs
                        else "json"
                    )
                    if req_id is not None:
                        conn.write_msg({"id": req_id,
                                        "result": {"codec": agree}})
                        await writer.drain()
                    if agree == WIRE_CODEC_BIN:
                        conn.codec = "bin"
                        if self.counters is not None:
                            self.counters.increment("rpc.conns_binary")
                    continue
                if method in self._streams and req_id is not None:
                    sw = StreamWriter(conn, req_id)

                    async def run_stream(fn=self._streams[method], p=params, s=sw):
                        try:
                            await fn(p, s)
                        except RpcError:
                            pass
                        except asyncio.CancelledError:
                            raise  # conn teardown cancels us
                        except Exception:  # noqa: BLE001
                            log.exception("%s: stream handler failed", self.name)
                        finally:
                            await s.end()

                    stream_tasks.append(asyncio.ensure_future(run_stream()))
                elif method in self._methods:
                    try:
                        result = await self._methods[method](params)
                        reply = {"id": req_id, "result": result}
                    except asyncio.CancelledError:
                        raise  # server stop cancels conn tasks
                    except Exception as e:  # noqa: BLE001
                        log.exception("%s: handler %s failed", self.name, method)
                        reply = {"id": req_id, "error": f"{type(e).__name__}: {e}"}
                    if req_id is not None:
                        conn.write_msg(reply)
                        await writer.drain()
                elif req_id is not None:
                    conn.write_msg(
                        {"id": req_id, "error": f"no method {method!r}"}
                    )
                    await writer.drain()
        except (ConnectionError, asyncio.IncompleteReadError):
            pass
        except asyncio.CancelledError:
            raise
        finally:
            for t in stream_tasks:
                t.cancel()
            writer.close()
            if task:
                self._conn_tasks.discard(task)


class RpcClient:
    """One connection; concurrent calls multiplexed by request id.

    `negotiate=True` (default) sends a ``_wire.hello`` on connect and
    upgrades the connection to binary frames when the server agrees;
    against an old (JSON-only) server the hello fails cleanly and the
    connection stays on JSON.
    """

    def __init__(
        self,
        host: str = "127.0.0.1",
        port: int = 0,
        ssl=None,
        counters=None,
        negotiate: bool = True,
    ):
        self.host = host
        self.port = port
        self.ssl = ssl  # ssl.SSLContext (rpc.tls) or None for plaintext
        self.counters = counters
        self.negotiate = negotiate
        self._codec = "json"
        self._reader: asyncio.StreamReader | None = None
        self._writer: asyncio.StreamWriter | None = None
        self._next_id = 1
        self._pending: dict[int, asyncio.Future] = {}
        self._streams: dict[int, RQueue] = {}
        self._rx_task: asyncio.Task | None = None

    @property
    def connected(self) -> bool:
        return self._writer is not None

    @property
    def codec(self) -> str:
        """Negotiated transmit codec: "json" or "bin"."""
        return self._codec

    async def connect(self, timeout: float = 5.0) -> None:
        self._reader, self._writer = await asyncio.wait_for(
            asyncio.open_connection(
                self.host, self.port, limit=MAX_LINE, ssl=self.ssl
            ),
            timeout,
        )
        self._codec = "json"
        self._rx_task = guard_task(
            asyncio.ensure_future(self._rx_loop()), owner="rpc.client.rx"
        )
        if self.negotiate:
            try:
                res = await self.call(
                    "_wire.hello", {"codecs": [WIRE_CODEC_BIN]},
                    timeout=timeout,
                )
                if isinstance(res, dict) and res.get("codec") == WIRE_CODEC_BIN:
                    self._codec = "bin"
            except RpcError:
                # old server: no such method (or conn-level failure the
                # next real call will surface) — stay on JSON frames
                pass

    async def close(self) -> None:
        if self._rx_task:
            # swallows only the rx fiber's cancellation, not close()'s
            await reap(self._rx_task)
            self._rx_task = None
        if self._writer:
            self._writer.close()
            self._writer = None
        self._fail_all(RpcTransportError("client closed"))

    def _fail_all(self, err: Exception) -> None:
        for fut in self._pending.values():
            if not fut.done():
                fut.set_exception(err)
        self._pending.clear()
        for q in self._streams.values():
            # force: the sentinel must land even on a full queue
            q.put_nowait(_STREAM_ERR, force=True)
        self._streams.clear()

    def _write_msg(self, msg: dict) -> int:
        data = bin_frame(msg) if self._codec == "bin" else _dumps(msg)
        self._writer.write(data)
        if self.counters is not None:
            self.counters.increment("rpc.bytes_tx", len(data))
        return len(data)

    async def send_frame(self, frame: bytes) -> None:
        """Write one pre-encoded wire frame (the serialize-once flood
        path: the SAME immutable frame is handed to every peer client).
        The frame must match this connection's negotiated codec."""
        if self._writer is None:
            raise RpcTransportError("not connected")
        self._writer.write(frame)
        if self.counters is not None:
            self.counters.increment("rpc.bytes_tx", len(frame))
        await self._writer.drain()

    async def _rx_loop(self) -> None:
        assert self._reader is not None
        try:
            while True:
                try:
                    kind, payload = await _read_frame(self._reader)
                except asyncio.IncompleteReadError:
                    break
                if self.counters is not None:
                    self.counters.increment("rpc.bytes_rx", len(payload))
                msg = (
                    from_wire_bin(payload)
                    if kind == "bin"
                    else json.loads(payload)
                )
                if not isinstance(msg, dict):
                    continue
                req_id = msg.get("id")
                if "item" in msg and req_id in self._streams:
                    try:
                        # backpressured put: a slow consumer stalls line
                        # reads (and via TCP, the sender) at STREAM_BUF
                        await asyncio.wait_for(
                            self._streams[req_id].put(msg["item"]),
                            STREAM_STALL_S,
                        )
                    except QueueClosedError:
                        # consumer abandoned the stream (gen() closed
                        # its queue) — possibly while we were blocked
                        # at the bound; drop the item and move on
                        self._streams.pop(req_id, None)
                    except asyncio.TimeoutError:
                        # consumer sat at the bound for STREAM_STALL_S
                        # without draining — or the generator was never
                        # even iterated (its cleanup can't run). Break
                        # THAT stream (its next get raises) rather than
                        # stall every reply on this client forever.
                        dead = self._streams.pop(req_id, None)
                        if dead is not None:
                            dead.close()
                elif msg.get("end") and req_id in self._streams:
                    self._streams.pop(req_id).put_nowait(
                        _STREAM_END, force=True
                    )
                elif req_id in self._streams and (
                    "error" in msg or "result" in msg
                ):
                    # server treated the subscription as a plain call (bad
                    # method / non-stream handler): fail the stream instead
                    # of hanging the subscriber forever
                    self._streams.pop(req_id).put_nowait(
                        _STREAM_ERR, force=True
                    )
                elif req_id in self._pending:
                    fut = self._pending.pop(req_id)
                    if not fut.done():
                        if "error" in msg:
                            fut.set_exception(RpcError(msg["error"]))
                        else:
                            fut.set_result(msg.get("result"))
        except (ConnectionError, ValueError, asyncio.IncompleteReadError,
                asyncio.LimitOverrunError):
            # ValueError covers JSONDecodeError, UnicodeDecodeError AND
            # WireDecodeError/WireFrameError — a corrupt frame from a
            # hostile/broken server takes the clean connection-lost
            # path, same as the server side. LimitOverrunError (NOT a
            # ValueError) is readuntil's overlong-JSON-line signal: the
            # old readline() converted it to ValueError, _read_frame's
            # readuntil raises it directly
            pass
        except asyncio.CancelledError:
            raise
        finally:
            self._fail_all(RpcTransportError("connection lost"))

    async def call(
        self, method: str, params: Any = None, timeout: float = 30.0
    ) -> Any:
        if self._writer is None:
            raise RpcTransportError("not connected")
        req_id = self._next_id
        self._next_id += 1
        fut: asyncio.Future = asyncio.get_event_loop().create_future()
        self._pending[req_id] = fut
        try:
            self._write_msg(
                {"id": req_id, "method": method, "params": params or {}}
            )
            await self._writer.drain()
        except BaseException as e:
            # transport failure mid-send (e.g. a TLS reject surfacing at
            # drain): deregister the slot AND settle the future — a
            # racing _fail_all may already have parked an exception on
            # it, which would otherwise never be retrieved
            self._pending.pop(req_id, None)
            if fut.done():
                fut.exception()
            else:
                fut.cancel()
            if isinstance(e, ConnectionError):
                # callers see one exception type for "call failed",
                # whether the transport died before, during or after
                # the send (RpcError docstring contract)
                raise RpcTransportError(f"transport failed: {e}") from e
            raise
        try:
            return await asyncio.wait_for(fut, timeout)
        except asyncio.TimeoutError as e:
            self._pending.pop(req_id, None)  # don't leak the slot
            raise RpcTransportError(
                f"call {method!r} timed out after {timeout}s"
            ) from e

    async def notify(self, method: str, params: Any = None) -> int:
        """Fire-and-forget. Returns the frame size written, so callers
        doing byte accounting (KvStore flood_bytes) get the real wire
        cost on either codec."""
        if self._writer is None:
            raise RpcTransportError("not connected")
        n = self._write_msg({"method": method, "params": params or {}})
        await self._writer.drain()
        return n

    async def subscribe(
        self, method: str, params: Any = None
    ) -> AsyncIterator[Any]:
        """Server-push stream; iterate until the server ends it."""
        if self._writer is None:
            raise RpcTransportError("not connected")
        req_id = self._next_id
        self._next_id += 1
        # bounded, block policy: the rx
        # loop's awaited put is the backpressure point
        q: RQueue = RQueue(
            name=f"rpc.stream.{req_id}", maxsize=STREAM_BUF, policy="block"
        )
        self._streams[req_id] = q
        self._write_msg({"id": req_id, "method": method, "params": params or {}})
        await self._writer.drain()

        async def gen():
            try:
                while True:
                    try:
                        item = await q.get()
                    except QueueClosedError:
                        # the rx loop declared this consumer stalled
                        # (STREAM_STALL_S at the bound) and broke the
                        # stream to protect the rest of the client
                        raise RpcTransportError(
                            "stream dropped: consumer stalled past "
                            "the buffer bound"
                        ) from None
                    if item is _STREAM_END:
                        return
                    if item is _STREAM_ERR:
                        raise RpcTransportError("stream broken")
                    yield item
            finally:
                # consumer stopped iterating (break / aclose / GC):
                # deregister AND close the queue, waking an rx loop
                # blocked on `await q.put(...)` — otherwise one
                # abandoned stream at the bound would stall every
                # reply on this client forever
                if self._streams.pop(req_id, None) is not None:
                    q.close()

        return gen()


class _Sentinel:
    pass


_STREAM_END = _Sentinel()
_STREAM_ERR = _Sentinel()

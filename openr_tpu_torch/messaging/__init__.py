"""Typed in-process queues: the module interconnect (the port's copy of
`openr_tpu/messaging/__init__.py`).

A `ReplicateQueue` has one writer and many readers: `push()` hands every
item to each reader (`RQueue`), so a slow consumer cannot drop another's
items. Each queue takes an optional bound and an overflow policy:

  * ``block``       — `put_nowait` raises :class:`QueueFullError`; async
                      producers `await q.put(item)` and wait for room;
  * ``coalesce``    — merge the newest item into the pending tail with
                      `coalesce_fn(tail, new)`; None appends it past the
                      bound, counted as overflow;
  * ``shed_oldest`` — drop the oldest pending item.

With `counters`, each queue exports ``queue.<key>.depth`` and
``.highwater`` / ``.coalesced`` / ``.shed`` / ``.overflow``.
"""

from __future__ import annotations

import asyncio
from collections import deque
from typing import Callable, Generic, TypeVar

T = TypeVar("T")

# overflow policies (None = unbounded, the seed behavior)
BLOCK = "block"
COALESCE = "coalesce"
SHED_OLDEST = "shed_oldest"
_POLICIES = (None, BLOCK, COALESCE, SHED_OLDEST)


class QueueClosedError(Exception):
    """Raised by RQueue.get() once the queue is closed and drained
    (reference: messaging/Queue.h † QueueClosedError)."""


class QueueFullError(Exception):
    """Raised by put_nowait() on a full ``block``-policy queue: the
    producer must apply backpressure (``await q.put(item)``) instead of
    growing the backlog."""


class _Close:
    pass


_CLOSE = _Close()


class RQueue(Generic[T]):
    """Reader endpoint of a ReplicateQueue (reference: RQueue<T> †)."""

    def __init__(
        self,
        name: str = "",
        maxsize: int = 0,
        policy: str | None = None,
        coalesce_fn: Callable[[T, T], T | None] | None = None,
        counters=None,
        counter_key: str | None = None,
    ):
        assert policy in _POLICIES, policy
        assert policy != COALESCE or coalesce_fn is not None
        self.name = name
        self.maxsize = maxsize
        self.policy = policy if maxsize > 0 else None
        self.coalesce_fn = coalesce_fn
        self.counters = counters
        self.ckey = counter_key or name
        # gauge keys precomputed: _gauge runs on EVERY put/get of the
        # hot seams — per-op f-string construction is wasted work
        self._k_depth = f"queue.{self.ckey}.depth"
        self._k_highwater = f"queue.{self.ckey}.highwater"
        self._k_blocked = f"queue.{self.ckey}.blocked"
        self._items: deque = deque()
        self._getters: deque[asyncio.Future] = deque()
        self._putters: deque[asyncio.Future] = deque()
        self._closed = False  # sentinel consumed: fully drained
        self._closing = False  # close() called: no new writes
        # lifetime stats, readable without a Counters registry (the
        # invariant checker walks these directly)
        self.highwater = 0
        self.coalesced = 0
        self.shed = 0
        self.overflow = 0

    # ------------------------------------------------------------- plumbing

    def _wake(self, waiters: deque) -> None:
        while waiters:
            fut = waiters.popleft()
            if not fut.done():
                fut.set_result(None)
                return

    def _gauge(self) -> None:
        n = len(self._items)
        if n > self.highwater:
            self.highwater = n
            if self.counters is not None:
                self.counters.set(self._k_highwater, n)
                if self.policy is not None and n * 2 >= self.maxsize:
                    # flight recorder: a policied seam crossing half its
                    # bound with a NEW watermark is the early overload
                    # signal a post-mortem wants; rare by construction
                    # (each depth fires at most once per queue lifetime)
                    fr = getattr(self.counters, "flight_record", None)
                    if fr is not None:
                        fr(
                            "queue.highwater",
                            queue=self.ckey,
                            depth=n,
                            cap=self.maxsize,
                        )
        if self.counters is not None:
            self.counters.set(self._k_depth, n)

    def _count(self, what: str, attr: str) -> None:
        setattr(self, attr, getattr(self, attr) + 1)
        if self.counters is not None:
            self.counters.increment(f"queue.{self.ckey}.{what}")

    @property
    def full(self) -> bool:
        return self.maxsize > 0 and len(self._items) >= self.maxsize

    # ---------------------------------------------------------------- write

    def put_nowait(self, item: T, force: bool = False) -> None:
        """Enqueue one item, applying the overflow policy at the bound.
        ``force`` bypasses the bound (the close sentinel must always
        land)."""
        if (self._closed or self._closing) and not force:
            raise QueueClosedError(self.name)
        if self.full and not force:
            if self.policy == COALESCE and self._items:
                tail = self._items[-1]
                if not isinstance(tail, _Close):
                    merged = self.coalesce_fn(tail, item)
                    if merged is not None:
                        self._items[-1] = merged
                        self._count("coalesced", "coalesced")
                        self._gauge()
                        return
                # unmergeable tail (e.g. different area): admit past the
                # bound rather than lose data — counted so the soak's
                # bounded-depth invariant can see it
                self._count("overflow", "overflow")
            elif self.policy == SHED_OLDEST:
                self._items.popleft()
                self._count("shed", "shed")
            elif self.policy == BLOCK:
                raise QueueFullError(self.name)
        self._items.append(item)
        self._wake(self._getters)
        self._gauge()

    async def _wait_room(self) -> None:
        """Wait until this ``block``-policy queue has room (or closes)."""
        while (
            self.full
            and self.policy == BLOCK
            and not (self._closed or self._closing)
        ):
            fut = asyncio.get_event_loop().create_future()
            self._putters.append(fut)
            if self.counters is not None:
                self.counters.increment(self._k_blocked)
            try:
                await fut
            except asyncio.CancelledError:
                if fut.done() and not self.full:
                    # our wakeup already fired: pass it on, or room sits
                    # free while another producer sleeps
                    self._wake(self._putters)
                raise

    async def put(self, item: T) -> None:
        """Backpressured enqueue: waits for room on a full ``block``
        queue (the producer-side seam of the overload design)."""
        await self._wait_room()
        self.put_nowait(item)

    # ----------------------------------------------------------------- read

    async def get(self) -> T:
        """Await the next item; QueueClosedError after close+drain."""
        while not self._items:
            if self._closed:
                raise QueueClosedError(self.name)
            fut = asyncio.get_event_loop().create_future()
            self._getters.append(fut)
            try:
                await fut
            except asyncio.CancelledError:
                if fut.done() and self._items:
                    # our wakeup already fired: pass it on, or the item
                    # sits while another getter sleeps
                    self._wake(self._getters)
                raise
        item = self._items.popleft()
        self._wake(self._putters)
        self._gauge()
        if isinstance(item, _Close):
            self._closed = True
            raise QueueClosedError(self.name)
        return item

    def try_get(self) -> T | None:
        """Non-blocking get; None if empty (or closed)."""
        while self._items:
            item = self._items.popleft()
            self._wake(self._putters)
            self._gauge()
            if isinstance(item, _Close):
                self._closed = True
                return None
            return item
        return None

    def size(self) -> int:
        return len(self._items)

    # stdlib-compatible aliases: call sites migrated off raw
    # asyncio.Queue (OR004) keep their shape
    def qsize(self) -> int:
        return len(self._items)

    def get_nowait(self) -> T | None:
        """Alias of try_get(): next item or None when empty/closed."""
        return self.try_get()

    @property
    def closed(self) -> bool:
        return self._closed

    def close(self) -> None:
        """Close this reader endpoint directly (standalone RQueues, e.g.
        the rpc stream buffers): wakes any blocked producer — whose next
        ``put`` raises :class:`QueueClosedError` — and ``get`` raises it
        after the drain sentinel. Readers minted by a ReplicateQueue are
        closed via ``ReplicateQueue.close()`` instead."""
        self._close()

    def _close(self) -> None:
        self._closing = True
        self.put_nowait(_CLOSE, force=True)
        # blocked producers must not wait on a dead queue
        for fut in self._putters:
            if not fut.done():
                fut.set_result(None)
        self._putters.clear()


class ReplicateQueue(Generic[T]):
    """Single-writer multi-reader queue: push() replicates to every reader.

    reference: messaging/ReplicateQueue.h † — getReader(), push(),
    close(); per-reader buffering so a slow consumer can't drop another
    consumer's messages. With ``maxsize`` set, each reader is bounded and
    applies this queue's overflow policy independently (a slow reader
    coalesces/sheds its OWN backlog; the fast one still sees every item).
    """

    def __init__(
        self,
        name: str = "",
        maxsize: int = 0,
        policy: str | None = None,
        coalesce_fn: Callable[[T, T], T | None] | None = None,
        counters=None,
        counter_key: str | None = None,
    ):
        assert policy in _POLICIES, policy
        self.name = name
        self.maxsize = maxsize
        self.policy = policy
        self.coalesce_fn = coalesce_fn
        self.counters = counters
        self.ckey = counter_key or name
        self._readers: list[RQueue[T]] = []
        self._closed = False
        self._writes = 0

    def get_reader(self, name: str = "") -> RQueue[T]:
        if self._closed:
            raise QueueClosedError(self.name)
        r: RQueue[T] = RQueue(
            name or f"{self.name}.r{len(self._readers)}",
            maxsize=self.maxsize,
            policy=self.policy,
            coalesce_fn=self.coalesce_fn,
            counters=self.counters,
            counter_key=self.ckey,
        )
        self._readers.append(r)
        return r

    def push(self, item: T) -> int:
        """Replicate to all readers; returns replication count. Raises
        QueueFullError when a ``block``-policy reader is full — sync
        producers of block queues must use ``await put()``. The check
        runs BEFORE any delivery (no awaits in between), so a raised
        push delivered to nobody and a retry can't duplicate."""
        if self._closed:
            raise QueueClosedError(self.name)
        for r in self._readers:
            if r.full and r.policy == BLOCK and not (r._closing or r.closed):
                raise QueueFullError(r.name)
        self._writes += 1
        for r in self._readers:
            r.put_nowait(item)
        return len(self._readers)

    async def put(self, item: T) -> int:
        """Backpressured replicate: waits for room in EVERY reader before
        enqueueing anywhere, so one slow reader throttles the producer
        (the ``block`` policy's contract). The scan restarts from the
        first reader after every wait — a concurrent producer may have
        refilled an earlier reader while we slept on a later one."""
        while True:
            if self._closed:
                raise QueueClosedError(self.name)
            blocked = next(
                (
                    r
                    for r in self._readers
                    if r.full
                    and r.policy == BLOCK
                    and not (r._closing or r.closed)
                ),
                None,
            )
            if blocked is None:
                break
            await blocked._wait_room()
        self._writes += 1
        for r in self._readers:
            r.put_nowait(item)
        return len(self._readers)

    def close(self) -> None:
        """Signal end-of-stream; readers drain then see QueueClosedError."""
        if not self._closed:
            self._closed = True
            for r in self._readers:
                r._close()

    @property
    def num_readers(self) -> int:
        return len(self._readers)

    @property
    def num_writes(self) -> int:
        return self._writes

    @property
    def readers(self) -> tuple[RQueue[T], ...]:
        """Reader endpoints (the invariant checker walks their depth
        watermarks)."""
        return tuple(self._readers)

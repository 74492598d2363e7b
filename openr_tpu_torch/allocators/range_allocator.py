"""RangeAllocator: a collision-free integer election through KvStore (the
port's copy of `openr_tpu/allocators/range_allocator.py`).

Each node claims a value v in [start, end] by writing the key
`<key_prefix><v>` with its own name as payload; the KvStore's conflict
resolution (version, then originator, then hash) picks one winner
everywhere, and a loser that sees the winner's publication probes the
next candidate. The candidates are a permutation seeded by the node's
name, so that contention stays rare when many nodes elect at once.
"""

from __future__ import annotations

import asyncio
import hashlib
import logging
import math
from typing import Awaitable, Callable

from openr_tpu_torch.common.constants import DEFAULT_AREA, TTL_REFRESH_FRACTION
from openr_tpu_torch.common.eventbase import OpenrModule
from openr_tpu_torch.kvstore.kvstore import KvStore
from openr_tpu_torch.messaging import QueueClosedError, RQueue
from openr_tpu_torch.types.kvstore import TTL_INFINITY, Publication, Value

log = logging.getLogger(__name__)


class RangeAllocator(OpenrModule):
    """Elects a unique integer from [start, end] for `node_name`.

    `on_allocated(value | None)` fires when the election settles (None:
    the range is exhausted). A later publication that shows another
    owner of our value re-opens the election and notifies again.
    """

    # TTL refresh cadence, as KvStoreClient's
    SCAN_PERIOD_S = 1.0

    def __init__(
        self,
        node_name: str,
        kvstore: KvStore,
        pub_reader: RQueue,
        key_prefix: str,
        start: int,
        end: int,
        on_allocated: Callable[[int | None], Awaitable | None] | None = None,
        area: str = DEFAULT_AREA,
        ttl_ms: int | None = None,
        initial_value: int | None = None,
        counters=None,
    ):
        super().__init__(f"{node_name}.range-alloc", counters=counters)
        assert start <= end
        if area not in kvstore.dbs:
            raise ValueError(
                f"range allocator area {area!r} not configured on this "
                f"node's KvStore (has: {sorted(kvstore.dbs)})"
            )
        self.node_name = node_name
        self.kvstore = kvstore
        self.pub_reader = pub_reader
        self.key_prefix = key_prefix
        self.range_start, self.range_end = start, end
        self.on_allocated = on_allocated
        self.area = area
        self.ttl_ms = ttl_ms or kvstore.config.node.kvstore.key_ttl_ms
        self.my_value: int | None = None
        # a restarted node tries the value it held before first
        self._initial = (
            initial_value
            if initial_value is not None and start <= initial_value <= end
            else None
        )
        self._probe_i = 0
        self.settled = asyncio.Event()

    # ----------------------------------------------------------------- run

    async def main(self) -> None:
        self.spawn(self._watch_loop(), name=f"{self.name}.watch")
        self.run_every(
            self.SCAN_PERIOD_S, self._refresh_ttl, name=f"{self.name}.ttl"
        )
        self._probe_next()

    def _key(self, v: int) -> str:
        return f"{self.key_prefix}{v}"

    def _candidate(self, i: int) -> int:
        """The i-th candidate: a walk of the range by a stride co-prime
        with its size, from a point seeded by the node's name, so that
        i = 0..n-1 visits every value."""
        n = self.range_end - self.range_start + 1
        seed = int.from_bytes(
            hashlib.sha256(self.node_name.encode()).digest()[:8], "big"
        )
        stride = (seed % n) or 1
        while math.gcd(stride, n) != 1:
            stride += 1
        return self.range_start + ((seed + i * stride) % n)

    def _claimable(self, v: int) -> bool:
        """Free, expired, or already ours."""
        cur = self.kvstore.get_key(self.area, self._key(v))
        return (
            cur is None
            or not cur.value
            or cur.value.decode() == self.node_name
        )

    def _probe_next(self) -> None:
        n = self.range_end - self.range_start + 1
        if self._initial is not None:
            v, self._initial = self._initial, None
            if self._claimable(v):
                self._claim(v)
                return
        tried = 0
        while tried < n:
            v = self._candidate(self._probe_i)
            self._probe_i += 1
            tried += 1
            if self._claimable(v):
                self._claim(v)
                return
        log.warning(
            "%s: range [%d,%d] exhausted",
            self.name, self.range_start, self.range_end,
        )
        self.my_value = None
        self.settled.set()
        self._notify(None)

    def _claim(self, v: int) -> None:
        key = self._key(v)
        cur = self.kvstore.get_key(self.area, key)
        version = (cur.version + 1) if cur is not None else 1
        self.my_value = v
        accepted = self.kvstore.set_key(
            self.area,
            key,
            Value(
                version=version,
                originator_id=self.node_name,
                value=self.node_name.encode(),
                ttl=self.ttl_ms,
            ).with_hash(),
        )
        if not accepted:  # lost a same-version race: probe on
            log.warning("%s: claim of %d rejected by store", self.name, v)
            self.my_value = None
            self._probe_next()
            return
        # settled for now: a publication of another winner of this key
        # re-opens the election
        self.settled.set()
        self._notify(v)

    def _notify(self, v: int | None) -> None:
        if self.on_allocated is None:
            return
        res = self.on_allocated(v)
        if asyncio.iscoroutine(res):
            self.spawn(res, name=f"{self.name}.notify")

    # --------------------------------------------------------------- watch

    async def _watch_loop(self) -> None:
        while True:
            try:
                pub: Publication = await self.pub_reader.get()
            except QueueClosedError:
                return
            if pub.area != self.area:
                continue
            if self.my_value is None:
                # exhausted: an expiry or a change of owner (a payload,
                # not a TTL refresh) may have freed a value
                touched = any(
                    k.startswith(self.key_prefix) for k in pub.expired_keys
                ) or any(
                    k.startswith(self.key_prefix) and v.value is not None
                    for k, v in pub.key_vals.items()
                )
                if touched:
                    self._probe_next()
                continue
            key = self._key(self.my_value)
            if key not in pub.key_vals and key not in pub.expired_keys:
                continue
            cur = self.kvstore.get_key(self.area, key)
            if cur is None:
                self._claim(self.my_value)  # expired: claim it again
            elif cur.value is not None and cur.value.decode() != self.node_name:
                log.info(
                    "%s: lost value %d to %s, re-electing",
                    self.name, self.my_value, cur.value.decode(),
                )
                self.settled.clear()
                self.my_value = None
                self._probe_next()

    def _refresh_ttl(self) -> None:
        """Refresh our claim's TTL when a fraction of it is left."""
        if self.my_value is None:
            return
        key = self._key(self.my_value)
        cur = self.kvstore.get_key(self.area, key)
        if cur is None or cur.value is None:
            return
        db = self.kvstore.dbs.get(self.area)
        if db is not None:
            remaining = db.remaining_ttl_ms(key)
            threshold = max(
                self.ttl_ms * TTL_REFRESH_FRACTION,
                2.5 * self.SCAN_PERIOD_S * 1e3,
            )
            if remaining == TTL_INFINITY or remaining >= threshold:
                return
        if cur.originator_id == self.node_name:
            self.kvstore.set_key(
                self.area,
                key,
                Value(
                    version=cur.version,
                    originator_id=cur.originator_id,
                    value=None,  # TTL-only refresh
                    ttl=self.ttl_ms,
                    ttl_version=cur.ttl_version + 1,
                    hash=cur.hash,
                ),
            )

"""KvStoreClient: persistent key advertisement with self-healing (the
port's copy of `openr_tpu/kvstore/client.py`).

The helper every originating module uses: `persist_key` keeps a key alive
(TTL refresh) and re-advertises it with a higher version whenever another
writer overwrites it. The durable book of self-originated keys
(`persist=`) comes with the port's `persist/`: passing one raises.
"""

from __future__ import annotations

from openr_tpu_torch.common.constants import TTL_REFRESH_FRACTION
from openr_tpu_torch.common.eventbase import OpenrModule
from openr_tpu_torch.kvstore.kvstore import KvStore
from openr_tpu_torch.messaging import QueueClosedError, RQueue
from openr_tpu_torch.types.kvstore import TTL_INFINITY, Publication, Value


class KvStoreClient(OpenrModule):
    SCAN_PERIOD_S = 1.0  # ttl-refresh scan cadence

    def __init__(
        self,
        kvstore: KvStore,
        node_name: str,
        pub_reader: RQueue,
        counters=None,
        persist=None,
    ):
        if persist is not None:
            raise ValueError(
                "KvStoreClient: persist= needs the durable journal, which "
                "is not part of the port yet"
            )
        super().__init__(f"{node_name}.kvclient", counters=counters)
        self.kvstore = kvstore
        self.node_name = node_name
        self.pub_reader = pub_reader
        # (area, key) -> (value_bytes, ttl_ms)
        self._persisted: dict[tuple[str, str], tuple[bytes, int]] = {}

    async def main(self) -> None:
        self.spawn(self._watch_loop(), name=f"{self.name}.watch")
        self.run_every(
            self.SCAN_PERIOD_S, self._refresh_ttls, name=f"{self.name}.ttl"
        )

    # ------------------------------------------------------------- persist

    def persist_key(
        self,
        area: str,
        key: str,
        value: bytes,
        ttl_ms: int = TTL_INFINITY,
        perf_events=None,
    ) -> None:
        """Advertise and keep advertising `key` until unset: version =
        current + 1 when the stored value isn't ours or differs; the TTL
        refreshed at a fraction of expiry; overwrites contested by a
        version bump.
        `perf_events` rides this write's publication only (self-healing
        re-advertisements are not part of the traced convergence)."""
        self._persisted[(area, key)] = (value, ttl_ms)
        self._advertise(area, key, perf_events=perf_events)

    def unset_key(self, area: str, key: str) -> None:
        """Stop refreshing; the key dies by TTL everywhere."""
        self._persisted.pop((area, key), None)

    def _advertise(self, area: str, key: str, perf_events=None) -> None:
        value, ttl_ms = self._persisted[(area, key)]
        cur = self.kvstore.get_key(area, key)
        if (
            cur is not None
            and cur.originator_id == self.node_name
            and cur.value == value
        ):
            return  # already winning with identical content
        version = (cur.version + 1) if cur is not None else 1
        self.kvstore.set_key(
            area,
            key,
            Value(
                version=version,
                originator_id=self.node_name,
                value=value,
                ttl=ttl_ms,
                ttl_version=0,
            ).with_hash(),
            perf_events=perf_events,
        )
        if self.counters is not None:
            self.counters.increment("kvclient.advertisements")

    # ------------------------------------------------------------ watchers

    async def _watch_loop(self) -> None:
        """Re-advertise persisted keys lost to another writer or expiry."""
        while True:
            try:
                pub: Publication = await self.pub_reader.get()
            except QueueClosedError:
                return
            for key in pub.key_vals:
                pk = (pub.area, key)
                if pk not in self._persisted:
                    continue
                cur = self.kvstore.get_key(pub.area, key)
                if (
                    cur is None
                    or cur.originator_id != self.node_name
                    or cur.value != self._persisted[pk][0]
                ):
                    self._advertise(pub.area, key)
            for key in pub.expired_keys:
                pk = (pub.area, key)
                if pk in self._persisted:
                    self._advertise(pub.area, key)

    def _refresh_ttls(self) -> None:
        """Bump ttl_version so flooding refreshes expiry everywhere (at
        TTL_REFRESH_FRACTION of the lifetime left)."""
        for (area, key), (value, ttl_ms) in self._persisted.items():
            if ttl_ms == TTL_INFINITY:
                continue
            db = self.kvstore.dbs.get(area)
            cur = self.kvstore.get_key(area, key)
            if cur is None or db is None:
                self._advertise(area, key)
                continue
            remaining = db.remaining_ttl_ms(key)
            # refresh when TTL_REFRESH_FRACTION of lifetime remains — but
            # never let the deadline fall between two scan ticks (small
            # TTLs), or the key would expire before the next scan
            threshold = max(
                ttl_ms * TTL_REFRESH_FRACTION, 2.5 * self.SCAN_PERIOD_S * 1e3
            )
            if remaining != TTL_INFINITY and remaining < threshold:
                self.kvstore.set_key(
                    area,
                    key,
                    Value(
                        version=cur.version,
                        originator_id=cur.originator_id,
                        value=None,  # ttl-only refresh
                        ttl=ttl_ms,
                        ttl_version=cur.ttl_version + 1,
                        hash=cur.hash,
                    ),
                )

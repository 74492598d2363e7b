"""Store state and the conflict-resolution core (the port's copy of
`openr_tpu/kvstore/store.py`).

Every store applies `merge_key_values` to every incoming batch; its total
order over (version, originator, hash, ttl_version) makes flooding
converge to one winner everywhere.
"""

from __future__ import annotations

import hashlib
import time

from openr_tpu_torch.types.kvstore import TTL_INFINITY, KeyDumpParams, Value


def merge_key_values(
    store: dict[str, Value],
    incoming: dict[str, Value],
) -> tuple[dict[str, Value], list[str]]:
    """Merge `incoming` into `store` (mutates store).

    Returns (accepted, sender_stale_keys):
      accepted — the updates applied (to flood onward / publish locally);
      sender_stale_keys — keys where OUR copy is strictly newer (the
      full-sync responder uses this as to_be_updated_keys so the initiator
      sends its values back: the 3-way sync).

    Ordering per key:
      1. higher version wins
      2. tie → lexicographically larger originator_id wins
      3. tie → larger value hash wins (canonical bytes ⇒ deterministic)
      4. same writer (version+originator equal, hash equal or no payload):
         higher ttl_version refreshes TTL only (not re-flooded as data)
    """
    accepted: dict[str, Value] = {}
    stale: list[str] = []
    for key, inc in incoming.items():
        inc = inc.with_hash()
        cur = store.get(key)
        if cur is None:
            if inc.value is None:
                continue  # hash-only ad for a key we don't have: ignore
            store[key] = inc
            accepted[key] = inc
            continue
        cur.with_hash()
        win = (inc.version, inc.originator_id, inc.hash)
        have = (cur.version, cur.originator_id, cur.hash)
        if win[:2] == have[:2]:
            # same writer generation: ttl refresh path
            newer_ttl = inc.ttl_version > cur.ttl_version
            if inc.value is None or inc.hash == cur.hash:
                if newer_ttl:
                    cur.ttl = inc.ttl
                    cur.ttl_version = inc.ttl_version
                    accepted[key] = Value(
                        version=cur.version,
                        originator_id=cur.originator_id,
                        value=None,
                        ttl=cur.ttl,
                        ttl_version=cur.ttl_version,
                        hash=cur.hash,
                    )
                elif inc.ttl_version < cur.ttl_version:
                    stale.append(key)
                continue
            # same (version, originator) but different payload: hash breaks
        if win > have and inc.value is not None:
            store[key] = inc
            accepted[key] = inc
        elif win < have:
            stale.append(key)
        elif win > have:  # inc wins but carried no payload (hash-only)
            stale.append(key)  # ask sender for the payload via full sync
    return accepted, stale


class KvStoreDb:
    """One area's key-value database with TTL bookkeeping."""

    def __init__(self, area: str, counters=None):
        self.area = area
        self.counters = counters
        self.kv: dict[str, Value] = {}
        self._expiry: dict[str, float] = {}  # key -> monotonic deadline
        # store-hash cache: _rev bumps on every mutation (merge accept /
        # expiry), so the O(n) hash only recomputes when the store moved
        self._rev = 0
        self._hash_at_rev: tuple[int, int] | None = None  # (rev, hash)

    # ---- merge/apply ------------------------------------------------------

    def merge(self, key_vals: dict[str, Value]) -> tuple[dict[str, Value], list[str]]:
        accepted, stale = merge_key_values(self.kv, key_vals)
        if accepted:
            self._rev += 1
        now = time.monotonic()
        for key, v in accepted.items():
            cur = self.kv.get(key)
            if cur is None:
                continue
            if cur.ttl == TTL_INFINITY:
                self._expiry.pop(key, None)
            else:
                self._expiry[key] = now + cur.ttl / 1e3
        if self.counters is not None:
            self.counters.increment("kvstore.merged_updates", len(accepted))
        return accepted, stale

    # ---- TTL --------------------------------------------------------------

    def expire_keys(self) -> list[str]:
        """Drop keys past their deadline (absolute monotonic deadlines,
        not a countdown); returns the expired key names."""
        now = time.monotonic()
        dead = [k for k, dl in self._expiry.items() if dl <= now]
        for k in dead:
            self._expiry.pop(k, None)
            self.kv.pop(k, None)
        if dead:
            self._rev += 1
            if self.counters is not None:
                self.counters.increment("kvstore.expired_keys", len(dead))
        return dead

    def remaining_ttl_ms(self, key: str) -> int:
        """Current TTL for flooding, less the least decrement of 1 ms."""
        v = self.kv.get(key)
        if v is None:
            return 0
        if v.ttl == TTL_INFINITY:
            return TTL_INFINITY
        rem = (self._expiry.get(key, 0) - time.monotonic()) * 1e3
        return max(0, int(rem) - 1)

    # ---- dumps ------------------------------------------------------------

    def dump(self, params: KeyDumpParams | None = None) -> dict[str, Value]:
        """Filtered copy of the store with flooding-ready TTLs."""
        params = params or KeyDumpParams()
        # sets: a full sync's send-back names every key a restarted peer
        # lacks, and a list probe a key made that dump quadratic
        keys = set(params.keys) if params.keys else None
        origins = set(params.originator_ids) if params.originator_ids else None
        out: dict[str, Value] = {}
        for key, v in self.kv.items():
            if params.prefix and not key.startswith(params.prefix):
                continue
            if keys is not None and key not in keys:
                continue
            if origins is not None and v.originator_id not in origins:
                continue
            out[key] = Value(
                version=v.version,
                originator_id=v.originator_id,
                value=v.value,
                ttl=self.remaining_ttl_ms(key),
                ttl_version=v.ttl_version,
                hash=v.hash,
            )
        return out

    def digest(self) -> dict[str, Value]:
        """Hash-only dump for full-sync requests (no payloads)."""
        return {
            k: Value(
                version=v.version,
                originator_id=v.originator_id,
                value=None,
                ttl=v.ttl,
                ttl_version=v.ttl_version,
                hash=v.with_hash().hash,
            )
            for k, v in self.kv.items()
        }

    def digest_triples(self) -> dict[str, list]:
        """Compact full-sync digest: key → [version, originator, hash]
        (exactly the tuple the responder's delta compare uses); ~4x
        smaller on the wire than hash-only Values."""
        return {
            k: [v.version, v.originator_id, v.with_hash().hash]
            for k, v in self.kv.items()
        }

    def store_hash(self) -> int:
        """Order-independent 63-bit hash of the whole store over the
        delta-sync identity tuples (key, version, originator,
        value-hash) — equal stores hash equal on every node. Used as
        the full-sync trailer and the anti-entropy noop probe:
        matching hashes skip the digest exchange
        entirely. Cached per store revision; TTL countdown state is
        deliberately excluded (it is local-clock-relative)."""
        cached = self._hash_at_rev
        if cached is not None and cached[0] == self._rev:
            return cached[1]
        acc = 0
        for k, v in self.kv.items():
            e = hashlib.blake2b(digest_size=8)
            e.update(k.encode())
            e.update(v.with_hash().hash.to_bytes(8, "big"))
            acc ^= int.from_bytes(e.digest(), "big") >> 1
        # never 0 for a non-empty store (0 is the "empty" sentinel a
        # fresh peer naturally reports)
        if self.kv and acc == 0:
            acc = 1
        self._hash_at_rev = (self._rev, acc)
        return acc

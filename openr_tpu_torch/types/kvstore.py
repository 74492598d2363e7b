"""KvStore wire types: versioned values, publications and dump filters
(the port's copy of `openr_tpu/types/kvstore.py`).

A publication maps keys to versioned `Value`s, whose payload is the
canonical JSON of an `AdjacencyDatabase` or a `PrefixDatabase`
(`types/serde.py`), and lists the expired keys. KvStore floods them
between stores in the binary codec and publishes them to Decision.
"""

from __future__ import annotations

import hashlib
from dataclasses import dataclass, field

from openr_tpu_torch.common.constants import DEFAULT_AREA
from openr_tpu_torch.monitor.perf import PerfEvent, PerfEvents
from openr_tpu_torch.types.serde import register_wire_types

# TTL sentinel: the key never expires
TTL_INFINITY = -1


def value_hash(version: int, originator_id: str, value: bytes | None) -> int:
    """Content hash, the last conflict-resolution tiebreak: 63 bits of a
    blake2b over the version, the length-prefixed originator and the
    payload (None and b"" differ). Equal to the JAX package's."""
    h = hashlib.blake2b(digest_size=8)
    h.update(version.to_bytes(8, "big", signed=False))
    oid = originator_id.encode()
    h.update(len(oid).to_bytes(4, "big"))
    h.update(oid)
    h.update(b"\x01" if value is not None else b"\x00")
    if value is not None:
        h.update(value)
    return int.from_bytes(h.digest(), "big") >> 1


@dataclass
class Value:
    """A versioned KvStore value. `value=None` is hash-only (a TTL
    refresh); `ttl` is ms remaining (TTL_INFINITY: never expires)."""

    version: int
    originator_id: str
    value: bytes | None = None
    ttl: int = TTL_INFINITY
    ttl_version: int = 0
    hash: int | None = None

    def with_hash(self) -> "Value":
        if self.hash is None:
            self.hash = value_hash(self.version, self.originator_id, self.value)
        return self


@dataclass
class Publication:
    """A batch of key updates and expiries for one area."""

    area: str = DEFAULT_AREA
    key_vals: dict[str, Value] = field(default_factory=dict)
    expired_keys: list[str] = field(default_factory=list)
    node_ids: list[str] = field(default_factory=list)  # flood loop guard
    # set on full-sync responses: keys the responder wants back
    to_be_updated_keys: list[str] | None = None
    # convergence trace riding the update; it annotates the update and
    # does not identify it
    perf_events: PerfEvents | None = field(default=None, compare=False)
    # the encoded flood blob, keyed by codec ("bin"): encoded once and
    # shared by every peer's flood. Transient (never on the wire); safe
    # to share because KvStore's coalescing always builds new
    # Publications, so a cached blob never goes stale in place
    _wire_cache: dict | None = field(
        default=None, compare=False, repr=False
    )


@dataclass
class KeyDumpParams:
    """Filter of a store dump: a key prefix ("" for all), originators,
    keys."""

    prefix: str = ""
    originator_ids: list[str] = field(default_factory=list)
    keys: list[str] = field(default_factory=list)
    ignore_ttl: bool = True


# the flood and full-sync payloads; the perf pair is registered here
# because monitor/perf.py cannot import types/serde.py back
register_wire_types(Value, Publication, KeyDumpParams, PerfEvent, PerfEvents)

"""Range origination (the port's copy of
`openr_tpu/prefixmgr/ranges.py`): a block of contiguous prefixes
advertised as one object.

A `PrefixRange` is a frozen descriptor (the base address, the prefix
length, a count, one template `PrefixEntry` with the shared metrics and
flags); its prefixes are made lazily, a chunk at a time when it is
advertised. PrefixManager advertises a range as per-prefix-key
PrefixDatabases of `RANGE_CHUNK` entries each, so that the wire and the
LSDB see the usual prefix keys while the origination book stays
O(ranges).
"""

from __future__ import annotations

import ipaddress
from dataclasses import dataclass, field, replace

from openr_tpu_torch.types.network import IpPrefix
from openr_tpu_torch.types.serde import register_wire_types
from openr_tpu_torch.types.topology import PrefixEntry

#: prefixes per advertised PrefixDatabase (one KvStore key each)
RANGE_CHUNK = 1024


def _v4_str(addr: int) -> str:
    return (
        f"{(addr >> 24) & 0xFF}.{(addr >> 16) & 0xFF}."
        f"{(addr >> 8) & 0xFF}.{addr & 0xFF}"
    )


@dataclass(frozen=True)
class PrefixRange:
    """`count` consecutive /`plen` IPv4 prefixes from `base` (which must
    be `plen`-aligned), all with `template`'s metrics and flags."""

    base: str  # network address of the first prefix, e.g. "10.128.0.0"
    plen: int
    count: int
    template: PrefixEntry = field(
        default_factory=lambda: PrefixEntry(
            prefix=IpPrefix(prefix="0.0.0.0/32")
        )
    )

    def __post_init__(self):
        base_int = int(ipaddress.IPv4Address(self.base))
        step = 1 << (32 - self.plen)
        if base_int % step:
            raise ValueError(
                f"range base {self.base} is not /{self.plen}-aligned"
            )
        if base_int + self.count * step > 1 << 32:
            raise ValueError("range overflows the v4 address space")
        object.__setattr__(self, "_base_int", base_int)
        object.__setattr__(self, "_step", step)

    def __len__(self) -> int:
        return self.count

    def prefix_at(self, i: int) -> IpPrefix:
        if not 0 <= i < self.count:
            raise IndexError(i)
        # canonical by construction: every member is aligned
        return IpPrefix(
            prefix=f"{_v4_str(self._base_int + i * self._step)}/{self.plen}"
        )

    def entry_at(self, i: int) -> PrefixEntry:
        return replace(self.template, prefix=self.prefix_at(i))

    def entries(self):
        """Lazy iterator over the range's PrefixEntry objects."""
        for i in range(self.count):
            yield self.entry_at(i)

    def chunks(self, size: int = RANGE_CHUNK):
        """(first prefix, entries) per advertised chunk."""
        for lo in range(0, self.count, size):
            hi = min(lo + size, self.count)
            yield (
                str(self.prefix_at(lo).prefix),
                tuple(self.entry_at(i) for i in range(lo, hi)),
            )

    def key(self) -> tuple[str, int, int]:
        """The block's identity (base, plen, count)."""
        return (self.base, self.plen, self.count)


register_wire_types(PrefixRange)

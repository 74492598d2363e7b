"""PrefixAllocator: a collision-free per-node block of a seed prefix (the
port's copy of `openr_tpu/allocators/prefix_allocator.py`).

The configured seed (say 10.0.0.0/8 with alloc_prefix_len 24) is carved
into 2^(alloc_len - seed_len) equal blocks; each node elects a block
index through a `RangeAllocator` (or pins `static_index`) and originates
the block through PrefixManager (source ALLOCATOR). Losing an election
withdraws the old block and originates the newly won one. The stored
index of a restarted node (`store=`) comes with the port's
`configstore/`.
"""

from __future__ import annotations

import ipaddress
import logging

from openr_tpu_torch.allocators.range_allocator import RangeAllocator
from openr_tpu_torch.common.eventbase import OpenrModule
from openr_tpu_torch.config import Config
from openr_tpu_torch.kvstore.kvstore import KvStore
from openr_tpu_torch.messaging import ReplicateQueue, RQueue
from openr_tpu_torch.prefixmgr import PrefixEvent, PrefixEventType, PrefixSource
from openr_tpu_torch.types.network import IpPrefix
from openr_tpu_torch.types.topology import PrefixEntry

log = logging.getLogger(__name__)

ALLOC_KEY_PREFIX = "allocprefix:"


def carve(seed: IpPrefix, alloc_len: int, index: int) -> IpPrefix:
    """The index-th /alloc_len subnet of the seed prefix."""
    net = seed.network
    width = 32 if seed.is_v4 else 128
    sub = ipaddress.ip_network(
        (int(net.network_address) + (index << (width - alloc_len)), alloc_len)
    )
    return IpPrefix.make(str(sub))


class PrefixAllocator(OpenrModule):
    def __init__(
        self,
        config: Config,
        kvstore: KvStore,
        pub_reader: RQueue,
        prefix_events_queue: ReplicateQueue,
        store=None,
        counters=None,
    ):
        if store is not None:
            raise NotImplementedError(
                "PrefixAllocator: store= needs the persistent config "
                "store, which is not part of the port yet"
            )
        super().__init__(f"{config.node_name}.prefix-alloc", counters=counters)
        pa = config.node.prefix_allocation
        assert pa is not None, "prefix_allocation config required"
        self.config = config
        self.node_name = config.node_name
        self.seed = IpPrefix.make(pa.seed_prefix)
        self.alloc_len = pa.alloc_prefix_len
        self.static_index = pa.static_index
        self.prefix_events = prefix_events_queue
        self.num_blocks = 1 << (self.alloc_len - self.seed.prefix_len)
        if self.static_index is not None and not (
            0 <= self.static_index < self.num_blocks
        ):
            raise ValueError(
                f"static_index {self.static_index} outside seed "
                f"{self.seed} blocks [0, {self.num_blocks})"
            )
        self.allocated: IpPrefix | None = None
        self.area = config.area_ids()[0]
        self.range_alloc = RangeAllocator(
            config.node_name,
            kvstore,
            pub_reader,
            key_prefix=ALLOC_KEY_PREFIX,
            start=0,
            end=self.num_blocks - 1,
            on_allocated=self._on_index,
            area=self.area,
            counters=counters,
        )

    async def main(self) -> None:
        if self.static_index is not None:
            self._on_index(self.static_index)
            return
        await self.range_alloc.start()

    async def cleanup(self) -> None:
        if self.static_index is None:
            await self.range_alloc.stop()

    def _on_index(self, index: int | None) -> None:
        old = self.allocated
        new = carve(self.seed, self.alloc_len, index) if index is not None else None
        if new == old:
            return
        if old is not None:
            self.prefix_events.push(
                PrefixEvent(
                    type=PrefixEventType.WITHDRAW_PREFIXES,
                    source=PrefixSource.ALLOCATOR,
                    entries=(PrefixEntry(prefix=old),),
                )
            )
        self.allocated = new
        if new is not None:
            log.info("%s: allocated %s (block %s)", self.name, new, index)
            self.prefix_events.push(
                PrefixEvent(
                    type=PrefixEventType.ADD_PREFIXES,
                    source=PrefixSource.ALLOCATOR,
                    entries=(PrefixEntry(prefix=new),),
                )
            )
        if self.counters:
            self.counters.increment("prefix_allocator.allocations")

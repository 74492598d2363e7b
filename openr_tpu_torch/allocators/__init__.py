"""Distributed allocators (the port's copy of `openr_tpu/allocators/`):
a collision-free integer election through KvStore, and the per-node
prefix carving built on it."""

from openr_tpu_torch.allocators.range_allocator import RangeAllocator  # noqa: F401
from openr_tpu_torch.allocators.prefix_allocator import PrefixAllocator  # noqa: F401

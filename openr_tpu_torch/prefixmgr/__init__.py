"""Prefix origination (the port's copy of `openr_tpu/prefixmgr/`):
`PrefixManager` is the one authority for what a node advertises, and
`PrefixRange` a block of prefixes advertised as a few chunked keys."""

from openr_tpu_torch.prefixmgr.prefix_manager import (  # noqa: F401
    PrefixEvent,
    PrefixEventType,
    PrefixManager,
    PrefixSource,
)
from openr_tpu_torch.prefixmgr.ranges import RANGE_CHUNK, PrefixRange  # noqa: F401

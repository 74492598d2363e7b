"""Launch and capture counts that many threads share.

Every Decision rebuilds in a worker thread, and an emulated cluster runs
many Decisions in one process, each solving on the same card: the
wrappers' module-wide counts are then bumped from several threads at
once. The wrappers bump them under `LOCK`, so no increment is lost, and
add the same count to the calling thread's own tally (`add_mine`). A
caller that counts its own work as a difference around it (a solve's
launches, a graph capture's kernels) reads `mine`, which no other
thread's work can move: a solve, and a capture, run in one thread from
start to end.
"""

from __future__ import annotations

import threading

#: held while a wrapper bumps a module-wide count
LOCK = threading.Lock()
_TLS = threading.local()


def add_mine(key: str, n: int = 1) -> None:
    """Adds `n` to this thread's tally under `key`."""
    tally = getattr(_TLS, "tally", None)
    if tally is None:
        tally = _TLS.tally = {}
    tally[key] = tally.get(key, 0) + n


def mine(key: str) -> int:
    """This thread's tally under `key` since the thread started."""
    tally = getattr(_TLS, "tally", None)
    return 0 if tally is None else tally.get(key, 0)

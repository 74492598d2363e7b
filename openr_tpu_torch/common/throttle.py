"""Debounce for event coalescing (the port's copy of
`openr_tpu/common/throttle.py`).

Decision coalesces bursts of KvStore publications with a (min, max)
debounce: fire `min` after the latest poke, but never later than `max`
after the first pending poke.
"""

from __future__ import annotations

import asyncio
import time
from typing import Awaitable, Callable

from openr_tpu_torch.common.tasks import guard_task


class AsyncDebounce:
    """poke() schedules `fn` after min_ms; more pokes push it out, bounded
    by max_ms since the first unflushed poke. A poke that lands while `fn`
    runs fires it once more after it returns."""

    def __init__(
        self,
        min_ms: float,
        max_ms: float,
        fn: Callable[[], Awaitable | None],
        owner: str = "debounce",
        counters=None,
    ):
        assert 0 < min_ms <= max_ms
        self.min_s = min_ms / 1e3
        self.max_s = max_ms / 1e3
        self.fn = fn
        self.owner = owner
        self.counters = counters
        self._task: asyncio.Task | None = None
        self._first_poke: float | None = None
        self._latest_poke: float = 0.0
        self.fires = 0
        self.pokes = 0

    def poke(self) -> None:
        self.pokes += 1
        now = time.monotonic()
        self._latest_poke = now
        if self._first_poke is None:
            self._first_poke = now
        if self._task is None or self._task.done():
            self._task = guard_task(
                asyncio.get_event_loop().create_task(
                    self._wait(), name=f"{self.owner}.debounce"
                ),
                owner=self.owner,
                counters=self.counters,
                counter_key=f"{self.owner}.task_exceptions",
            )

    async def _wait(self) -> None:
        while True:
            while True:
                now = time.monotonic()
                deadline = min(
                    self._latest_poke + self.min_s,
                    self._first_poke + self.max_s,
                )
                if now >= deadline:
                    break
                await asyncio.sleep(deadline - now)
            self._first_poke = None
            self.fires += 1
            res = self.fn()
            if asyncio.iscoroutine(res):
                await res
            # a poke during fn set _first_poke again: go round once more
            if self._first_poke is None:
                return

    def cancel(self) -> None:
        if self._task is not None and not self._task.done():
            self._task.cancel()
        self._task = None
        self._first_poke = None

    @property
    def pending(self) -> bool:
        return self._task is not None and not self._task.done()

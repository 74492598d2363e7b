"""Module runtime (the port's copy of `openr_tpu/common/eventbase.py`).

A module is a set of asyncio tasks on the process loop: `start()` runs
`main()`, which spawns its long-running fibers with `spawn`; `stop()`
cancels them in reverse order, reaps them and runs `cleanup()`.
`run_every` adds a periodic timer fiber. A heartbeat fiber stamps
`last_heartbeat` once a second.
"""

from __future__ import annotations

import asyncio
import logging
import time
from typing import Awaitable, Callable, Coroutine

from openr_tpu_torch.common.tasks import guard_task, reap

log = logging.getLogger(__name__)


class OpenrModule:
    """Base class of a control-plane module: override `main()` and
    `cleanup()`."""

    def __init__(self, name: str, counters=None):
        self.name = name
        self.counters = counters
        self._tasks: dict[asyncio.Task, None] = {}  # insertion-ordered set
        self._stopped = asyncio.Event()
        self._started = False
        self.last_heartbeat = time.monotonic()

    # ---- lifecycle --------------------------------------------------------

    async def start(self) -> None:
        assert not self._started, f"{self.name} started twice"
        self._started = True
        self.spawn(self._heartbeat_loop(), name=f"{self.name}.heartbeat")
        await self.main()
        log.debug("module %s started", self.name)

    async def stop(self) -> None:
        """Cancel all fibers and run cleanup (idempotent)."""
        if self._stopped.is_set():
            return
        self._stopped.set()
        live = list(self._tasks)
        for t in reversed(live):
            t.cancel()
        for t in live:
            # cancel=False: every fiber was cancelled above, and a
            # second cancel would cut its CancelledError handler short
            await reap(t, cancel=False)
        self._tasks.clear()
        await self.cleanup()
        log.debug("module %s stopped", self.name)

    @property
    def stopped(self) -> bool:
        return self._stopped.is_set()

    # ---- overridables -----------------------------------------------------

    async def main(self) -> None:
        """Spawn long-running fibers; called once by start()."""

    async def cleanup(self) -> None:
        """Release resources; called once by stop()."""

    # ---- fibers & timers --------------------------------------------------

    def spawn(
        self, coro: Coroutine, name: str | None = None
    ) -> asyncio.Task:
        """Track a fiber; it is cancelled on stop(). Its exceptions are
        logged and counted, never swallowed silently."""
        task = asyncio.get_event_loop().create_task(
            self._guard(coro), name=name or self.name
        )
        self._tasks[task] = None
        guard_task(
            task,
            owner=self.name,
            counters=self.counters,
            counter_key=f"{self.name}.task_exceptions",
        )

        def _done(t, _coro=coro):
            self._tasks.pop(t, None)
            # a task cancelled before its first step never awaited the
            # coroutine: close it, or the collector warns
            _coro.close()

        task.add_done_callback(_done)
        return task

    async def _guard(self, coro: Coroutine) -> None:
        try:
            await coro
        except asyncio.CancelledError:
            raise
        except Exception:  # noqa: BLE001
            log.exception("module %s fiber crashed", self.name)
            if self.counters is not None:
                self.counters.increment(f"{self.name}.fiber_crashes")

    def run_every(
        self,
        interval_s: float,
        fn: Callable[[], Awaitable | None],
        name: str | None = None,
    ) -> asyncio.Task:
        """A periodic timer fiber calling `fn` (awaited when it returns a
        coroutine) every `interval_s`; a call that raises is logged and
        counted under `<name>.timer_errors`, and the timer keeps going."""

        async def loop():
            while not self.stopped:
                await asyncio.sleep(interval_s)
                try:
                    res = fn()
                    if asyncio.iscoroutine(res):
                        await res
                except asyncio.CancelledError:
                    raise
                except Exception:  # noqa: BLE001
                    log.exception("module %s timer %s failed", self.name, name)
                    if self.counters is not None:
                        self.counters.increment(f"{self.name}.timer_errors")

        return self.spawn(loop(), name=name or f"{self.name}.timer")

    async def _heartbeat_loop(self) -> None:
        while not self.stopped:
            self.last_heartbeat = time.monotonic()
            await asyncio.sleep(1.0)

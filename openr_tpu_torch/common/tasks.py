"""Task hygiene (the port's copy of `openr_tpu/common/tasks.py`).

`guard_task` logs and counts a fire-and-forget task's uncaught
exception the moment the task finishes, never at garbage-collection
time. `reap` cancels and awaits a task, swallowing only that task's own
cancellation: a cancellation aimed at the caller still propagates.
"""

from __future__ import annotations

import asyncio
import logging

log = logging.getLogger(__name__)

#: the counter `guard_task` bumps on an uncaught task exception
UNCAUGHT_KEY = "task.uncaught_exceptions"


def guard_task(
    task: asyncio.Task,
    owner: str = "",
    counters=None,
    counter_key: str | None = None,
) -> asyncio.Task:
    """Attach a done-callback that retrieves, logs and counts the task's
    uncaught exception, if any. Returns the task."""

    def _done(t: asyncio.Task) -> None:
        if t.cancelled():
            return
        exc = t.exception()  # marks the exception retrieved
        if exc is not None:
            log.error(
                "task %r (owner=%s) crashed",
                t.get_name(),
                owner or "-",
                exc_info=exc,
            )
            if counters is not None:
                counters.increment(counter_key or UNCAUGHT_KEY)

    task.add_done_callback(_done)
    return task


async def reap(task: asyncio.Task | None, *, cancel: bool = True) -> None:
    """Cancel `task` and await it. Its own CancelledError is swallowed; a
    cancellation aimed at the caller re-raises. Other exceptions are
    logged, not raised. `cancel=False` when the caller already cancelled
    it: a second cancel would cut its CancelledError handler short."""
    if task is None or task.done():
        if task is not None and not task.cancelled():
            exc = task.exception()  # retrieve, so it cannot fire at GC
            if exc is not None:
                log.debug(
                    "reaped task %r had failed: %r", task.get_name(), exc
                )
        return
    if cancel:
        task.cancel()
    try:
        # shield: a cancellation of the reaper must not look like the
        # task's own
        await asyncio.shield(task)
    except asyncio.CancelledError:
        if not task.cancelled():
            raise  # aimed at the caller, not the task
    except Exception:  # noqa: BLE001 — teardown must finish
        log.exception(
            "reaped task %r raised during cancellation", task.get_name()
        )

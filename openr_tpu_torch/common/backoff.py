"""Exponential backoff (the port's copy of `openr_tpu/common/backoff.py`):
the delay doubles on each error up to a bound and resets on success.
KvStore paces its peer-sync retries with it.

With ``jitter=True`` the actual retry delay is drawn uniformly from
[envelope/2, envelope] on every error, where the *envelope* keeps the
deterministic doubling: peers that failed at the same instant — every
node on the losing side of a partition — no longer retry at the same
instant after the heal (thundering herd), and the spread applies from
the FIRST retry (where the herd is largest), while ``current_ms`` (the
envelope) stays deterministic so saturation detection ("backoff pinned
at max") keeps exact semantics. The RNG is injectable so seeded soaks
stay reproducible.
"""

from __future__ import annotations

import hashlib
import random
import time


def stable_rng(*names: str) -> random.Random:
    """Deterministic RNG seeded from a name tuple (e.g. node + peer):
    different names decorrelate (the point of jitter), identical runs
    reproduce identical delay sequences (the seeded-soak replay
    contract). Python's `hash()` is salted per process, hence sha256."""
    digest = hashlib.sha256("/".join(names).encode()).digest()
    return random.Random(int.from_bytes(digest[:8], "big"))


class ExponentialBackoff:
    def __init__(
        self,
        initial_ms: float,
        max_ms: float,
        jitter: bool = False,
        rng: random.Random | None = None,
    ):
        assert 0 < initial_ms <= max_ms
        self.initial_ms = initial_ms
        self.max_ms = max_ms
        self.jitter = jitter
        self.rng = rng if rng is not None else random.Random()
        self._current_ms = 0.0  # deterministic doubling envelope
        self._delay_ms = 0.0  # the (possibly jittered) delay in force
        self._last_error_at = 0.0

    def report_error(self) -> None:
        """Double the envelope (bounded by max); with jitter on, draw
        this round's delay uniformly from [envelope/2, envelope]."""
        self._current_ms = min(
            self.max_ms, max(self.initial_ms, self._current_ms * 2)
        )
        self._delay_ms = (
            self.rng.uniform(self._current_ms / 2, self._current_ms)
            if self.jitter
            else self._current_ms
        )
        self._last_error_at = time.monotonic()

    def report_success(self) -> None:
        self._current_ms = 0.0
        self._delay_ms = 0.0

    @property
    def has_error(self) -> bool:
        return self._current_ms > 0

    def time_remaining_s(self) -> float:
        """Seconds until retry is allowed (0 = now)."""
        if self._current_ms == 0:
            return 0.0
        elapsed = time.monotonic() - self._last_error_at
        return max(0.0, self._delay_ms / 1e3 - elapsed)

    @property
    def current_ms(self) -> float:
        """The deterministic envelope (what saturation checks compare
        against max_ms)."""
        return self._current_ms

    @property
    def delay_ms(self) -> float:
        """The delay actually in force: equals current_ms without
        jitter, a draw from [current_ms/2, current_ms] with it."""
        return self._delay_ms

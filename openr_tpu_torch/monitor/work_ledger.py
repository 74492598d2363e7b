"""Steady-state work ledger (the port's copy of
`openr_tpu/monitor/work_ledger.py`, which imports nothing of JAX).

Every pipeline stage reports *entities touched* against *delta size*
per round, so a steady state is delta-proportional or visibly not. The
port's solver commits the `election` stage where the JAX package's
solver does: the full count in `_assemble_routes` (touched: plain
prefixes + multi-advertiser slots + complex candidates; delta: the
electable prefixes) and the scoped count in the scoped assembly
(touched: the candidates of the scoped prefixes; delta: the scoped
prefixes). It commits to the ledger it holds (`solver.work_ledger`),
by default this module's process ledger; a caller behind a Decision
hands in the JAX package's `work_ledger` module instead, so the commits
land in the ledger the Decision, ctrl `get_work_ledger` and the soak
invariant read.

  * `WorkScope` / `scope(stage, delta)`: integer adds inside, one commit
    on exit.
  * `commit(stage, touched, delta)`: for counts already computed.
  * `mark_warm()` / `since_warm()` / `steady_violations(k, floor)`:
    after the mark, a round that touches more than `k * delta + floor`
    entities of a stage is a violation.
  * `rows()` / `export_to(counters)`: `work.<stage>.touched / .delta /
    .ratio` gauges.

Process-wide and thread-safe: a Decision computes in worker threads.
"""

from __future__ import annotations

import threading
from dataclasses import dataclass

#: the pipeline stage vocabulary (the JAX package's, stage for stage)
STAGES: tuple[str, ...] = (
    "dirt",
    "spf_full",
    "spf_warm",
    "election",
    "assembly",
    "merge",
    "merge_full",
    "diff",
    "fib",
    "fib_resync",
    "redistribute",
    "full_sync",
    # crash-recovery replay (persist/): boot-time FIB reconciliation
    # against the recovered durable book — touched is what the handler
    # reprogrammed, delta the desired-vs-durable dataplane diff, so a
    # regression to a full-table boot reprogram breaches the bound
    # (NOT in WORK_EXEMPT_STAGES; ratio gated ≈ 1 by the crash-recovery
    # smoke lane)
    "persist_replay",
)

#: sanitizer default: a steady-state round may touch up to
#: ``k * delta + floor`` entities per stage. The floor absorbs
#: per-round constants (bounded warm-start cones, fixed-size auxiliary
#: walks) that are not per-entity work.
DEFAULT_K = 8.0
DEFAULT_FLOOR = 64


@dataclass
class _StageAcct:
    """Cumulative + since-warm accounting for one stage."""

    __slots__ = (
        "touched", "delta", "rounds",
        "warm_touched", "warm_delta", "warm_rounds",
        "worst_touched", "worst_delta",
    )

    touched: int
    delta: int
    rounds: int
    # snapshot taken at mark_warm(); since-warm = current - warm_*
    warm_touched: int
    warm_delta: int
    warm_rounds: int
    # the worst single round since mark_warm(), by touched/max(delta,1)
    worst_touched: int
    worst_delta: int

    def __init__(self) -> None:
        self.touched = 0
        self.delta = 0
        self.rounds = 0
        self.warm_touched = 0
        self.warm_delta = 0
        self.warm_rounds = 0
        self.worst_touched = 0
        self.worst_delta = 0


def _ratio(touched: int | float, delta: int | float) -> float:
    return touched / max(delta, 1)


class WorkScope:
    """One stage entry's accounting context.

    Steady-state cheap by contract: entering allocates ONE slotted
    object; inside the scope the only operations are integer adds
    (``add`` batches — never call it per entity when a batch count is
    available). Exiting commits (touched, delta) to the process ledger
    under its lock. Exceptions still commit (the work happened) and
    propagate.
    """

    __slots__ = ("stage", "delta", "touched", "_ledger")

    def __init__(self, stage: str, delta_size: int = 0, ledger=None):
        self.stage = stage
        self.delta = int(delta_size)
        self.touched = 0
        self._ledger = ledger if ledger is not None else _LEDGER

    def add(self, n: int = 1) -> None:
        self.touched += n

    def set_delta(self, n: int) -> None:
        """For stages whose delta is only known mid-scope (e.g. the
        full_sync compare computes what it will ship)."""
        self.delta = int(n)

    def __enter__(self) -> "WorkScope":
        return self

    def __exit__(self, exc_type, exc, tb) -> bool:
        self._ledger.commit(self.stage, self.touched, self.delta)
        return False


class _NullScope:
    """Shared no-op scope returned while the ledger is disabled (the
    bench overhead control): zero allocation, zero lock traffic."""

    __slots__ = ()

    def add(self, n: int = 1) -> None:
        pass

    def set_delta(self, n: int) -> None:
        pass

    def __enter__(self):
        return self

    def __exit__(self, exc_type, exc, tb) -> bool:
        return False


_NULL_SCOPE = _NullScope()


class WorkLedger:
    """Process-wide per-stage work accounting (see module docstring)."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._stages: dict[str, _StageAcct] = {s: _StageAcct() for s in STAGES}
        self.enabled = True
        self.warm_marked = False

    # ----------------------------------------------------------- record

    def scope(self, stage: str, delta_size: int = 0):
        if not self.enabled:
            return _NULL_SCOPE
        return WorkScope(stage, delta_size, ledger=self)

    def commit(self, stage: str, touched: int, delta: int) -> None:
        """Record one completed stage round. Integer adds under the
        lock; called once per scope exit, never per entity."""
        if not self.enabled:
            return
        with self._lock:
            acct = self._stages.get(stage)
            if acct is None:
                acct = self._stages.setdefault(stage, _StageAcct())
            acct.touched += touched
            acct.delta += delta
            acct.rounds += 1
            if self.warm_marked and _ratio(touched, delta) > _ratio(
                acct.worst_touched, acct.worst_delta
            ):
                acct.worst_touched = touched
                acct.worst_delta = delta

    # ------------------------------------------------------- warm marks

    def mark_warm(self) -> None:
        """Declare the warmup boundary: rounds committed after this are
        steady state — tracked per stage (since-warm totals + the worst
        single round) and judged by :meth:`steady_violations`. Same
        contract as ``compile_ledger.mark_warm()``."""
        with self._lock:
            self.warm_marked = True
            for acct in self._stages.values():
                acct.warm_touched = acct.touched
                acct.warm_delta = acct.delta
                acct.warm_rounds = acct.rounds
                acct.worst_touched = 0
                acct.worst_delta = 0

    def reset_warm(self) -> None:
        with self._lock:
            self.warm_marked = False
            for acct in self._stages.values():
                acct.warm_touched = acct.touched
                acct.warm_delta = acct.delta
                acct.warm_rounds = acct.rounds
                acct.worst_touched = 0
                acct.worst_delta = 0

    def since_warm(self) -> dict[str, dict]:
        """{stage: {touched, delta, rounds, ratio, worst_ratio}} for
        stages with steady-state rounds; empty when never marked."""
        if not self.warm_marked:
            return {}
        out: dict[str, dict] = {}
        with self._lock:
            for stage, a in self._stages.items():
                rounds = a.rounds - a.warm_rounds
                if rounds <= 0:
                    continue
                touched = a.touched - a.warm_touched
                delta = a.delta - a.warm_delta
                out[stage] = {
                    "touched": touched,
                    "delta": delta,
                    "rounds": rounds,
                    "ratio": round(_ratio(touched, delta), 3),
                    "worst_ratio": round(
                        _ratio(a.worst_touched, a.worst_delta), 3
                    ),
                    "worst_touched": a.worst_touched,
                    "worst_delta": a.worst_delta,
                }
        return out

    def steady_violations(
        self,
        k: float = DEFAULT_K,
        floor: int = DEFAULT_FLOOR,
        exempt: tuple[str, ...] = (),
    ) -> list[dict]:
        """Stages whose worst steady-state round touched more than
        ``k * delta + floor`` entities — the delta-proportionality
        contract the ``work_proportional`` sanitizer enforces. Exempt
        the stages a test legitimately drives O(routes)/O(area)
        (``spf_full``, ``merge_full``, ``full_sync`` and the full diff
        — the counter-asserted fallback class; ``merge`` and
        ``redistribute`` are delta-native and no longer exempt)."""
        out: list[dict] = []
        for stage, row in self.since_warm().items():
            if stage in exempt:
                continue
            t, d = row["worst_touched"], row["worst_delta"]
            if t > k * d + floor:
                out.append(
                    {
                        "stage": stage,
                        "touched": t,
                        "delta": d,
                        "ratio": round(_ratio(t, d), 2),
                        "bound": round(k * d + floor, 1),
                    }
                )
        out.sort(key=lambda r: -r["ratio"])
        return out

    # ---------------------------------------------------------- queries

    def rows(self) -> list[dict]:
        """Per-stage joined rows (cumulative + since-warm), the ctrl /
        breeze table. Stages with zero rounds are omitted."""
        steady = self.since_warm()
        out: list[dict] = []
        with self._lock:
            for stage in self._stages:
                a = self._stages[stage]
                if a.rounds == 0:
                    continue
                row = {
                    "stage": stage,
                    "touched": a.touched,
                    "delta": a.delta,
                    "rounds": a.rounds,
                    "ratio": round(_ratio(a.touched, a.delta), 3),
                }
                s = steady.get(stage)
                row["steady"] = s
                out.append(row)
        # pipeline order, not alphabetical: the table reads as dataflow
        order = {s: i for i, s in enumerate(STAGES)}
        out.sort(key=lambda r: order.get(r["stage"], len(order)))
        return out

    def top_offender(self) -> dict | None:
        """The stage with the worst proportionality ratio (steady-state
        ratio when warm was marked, cumulative otherwise) — the 'where
        is my steady-state time going' headline."""
        rows = self.rows()
        if not rows:
            return None

        def key(r: dict) -> float:
            s = r.get("steady")
            return s["ratio"] if s else r["ratio"]

        worst = max(rows, key=key)
        return {"stage": worst["stage"], "ratio": key(worst)}

    def reset(self) -> None:
        """Drop all accounting (tests/benches)."""
        with self._lock:
            self._stages = {s: _StageAcct() for s in STAGES}
            self.warm_marked = False

    # ----------------------------------------------------------- export

    def export_to(self, counters) -> None:
        """Stamp every active stage into a Counters registry as
        ``work.<stage>.touched/delta/ratio`` gauges.
        Values are process-wide, like the compile ledger's."""
        for row in self.rows():
            stage = row["stage"]
            counters.set(f"work.{stage}.touched", float(row["touched"]))
            counters.set(f"work.{stage}.delta", float(row["delta"]))
            counters.set(f"work.{stage}.ratio", float(row["ratio"]))


#: the process ledger every consumer shares
_LEDGER = WorkLedger()


def ledger() -> WorkLedger:
    return _LEDGER


def scope(stage: str, delta_size: int = 0):
    """``with work_ledger.scope("merge", len(scope_set)) as ws: ...`` —
    the hot-path entry point."""
    return _LEDGER.scope(stage, delta_size)


def commit(stage: str, touched: int, delta: int) -> None:
    """Scope-free commit for sites whose counts are already computed
    (e.g. Fib's delta-book scan)."""
    _LEDGER.commit(stage, touched, delta)


def mark_warm() -> None:
    _LEDGER.mark_warm()


def reset_warm() -> None:
    _LEDGER.reset_warm()


def since_warm() -> dict[str, dict]:
    return _LEDGER.since_warm()


def rows() -> list[dict]:
    return _LEDGER.rows()


def export_to(counters) -> None:
    _LEDGER.export_to(counters)


def reset() -> None:
    _LEDGER.reset()


def steady_violations(
    k: float = DEFAULT_K,
    floor: int = DEFAULT_FLOOR,
    exempt: tuple[str, ...] = (),
) -> list[dict]:
    return _LEDGER.steady_violations(k=k, floor=floor, exempt=exempt)


def set_enabled(on: bool) -> None:
    """Bench control: the overhead comparison runs the same workload
    with scopes no-op'd (shared null scope, zero lock traffic)."""
    _LEDGER.enabled = bool(on)


def steady_violation_report(
    k: float = DEFAULT_K,
    floor: int = DEFAULT_FLOOR,
    exempt: tuple[str, ...] = (),
) -> str | None:
    """Human-readable violation detail for the conftest sanitizer and
    the soak invariant, or None when every scoped stage stayed
    delta-proportional."""
    bad = _LEDGER.steady_violations(k=k, floor=floor, exempt=exempt)
    if not bad:
        return None
    parts = [
        f"{r['stage']}: touched {r['touched']} vs delta {r['delta']} "
        f"(ratio {r['ratio']}, bound {r['bound']})"
        for r in bad
    ]
    return "; ".join(parts)

"""fb303-style counters (the port's copy of `Counters` in
`openr_tpu/monitor/counters.py`, which imports nothing of JAX).

One `Counters` instance per node: `set` and `increment` write plain
counters, `add_value` records a sample into a stat that keeps the
all-time sum/count/min/max/last and log-bucketed histograms over sliding
windows (60 s, 600 s, all-time), so `snapshot()` exports `.p50` / `.p99`
per window under `<key>.<stat>.<window>` names. The port's telemetry
(`monitor/compile_ledger.py`, `monitor/device.py`,
`monitor/work_ledger.py`) writes into any object with `set` and
`add_value`: this class, or the JAX package's own `Counters` that a
Decision hands the solver.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field

# Log-spaced histogram bucket upper edges, in the stat's own unit
# (latencies here are milliseconds): 10 buckets per decade (ratio
# ~1.26, so a percentile read off the geometric bucket midpoint is
# within ~12%), spanning 1 µs .. ~800 s. Values above the last edge
# land in a final overflow bucket.
_EDGES = tuple(0.001 * 10 ** (i / 10) for i in range(120))
_N_BUCKETS = len(_EDGES) + 1  # + overflow

# sliding-window layout: 10 s sub-buckets, windows in whole sub-buckets
_SUB_S = 10
WINDOWS_S = (60, 600)


def _bucket_of(v: float) -> int:
    """Index of the histogram bucket containing v (binary search over
    the static edges)."""
    lo, hi = 0, len(_EDGES)
    while lo < hi:
        mid = (lo + hi) // 2
        if v <= _EDGES[mid]:
            hi = mid
        else:
            lo = mid + 1
    return lo


def _bucket_mid(i: int) -> float:
    """Representative value for bucket i: geometric midpoint (log-spaced
    edges), edge values for the boundary buckets."""
    if i == 0:
        return _EDGES[0]
    if i >= len(_EDGES):
        return _EDGES[-1]
    return (_EDGES[i - 1] * _EDGES[i]) ** 0.5


def _percentile(counts: list[int], q: float) -> float | None:
    total = sum(counts)
    if total == 0:
        return None
    target = max(1, int(q * total + 0.5))
    acc = 0
    for i, c in enumerate(counts):
        acc += c
        if acc >= target:
            return _bucket_mid(i)
    return _bucket_mid(len(counts) - 1)


@dataclass
class _Stat:
    sum: float = 0.0
    count: int = 0
    min: float = float("inf")
    max: float = float("-inf")
    last: float = 0.0
    # all-time histogram + sliding 10 s sub-histograms (newest last);
    # sub-entries are (sub_bucket_index_of_time, counts)
    hist: list[int] = field(default_factory=lambda: [0] * _N_BUCKETS)
    subs: list[tuple[int, list[int]]] = field(default_factory=list)

    def add(self, v: float, now: float | None = None) -> None:
        self.sum += v
        self.count += 1
        self.min = min(self.min, v)
        self.max = max(self.max, v)
        self.last = v
        b = _bucket_of(v)
        self.hist[b] += 1
        t = time.monotonic() if now is None else now
        sub = int(t // _SUB_S)
        if not self.subs or self.subs[-1][0] != sub:
            self.subs.append((sub, [0] * _N_BUCKETS))
            self._evict(sub)
        self.subs[-1][1][b] += 1

    def _evict(self, newest_sub: int) -> None:
        horizon = newest_sub - max(WINDOWS_S) // _SUB_S
        while self.subs and self.subs[0][0] < horizon:
            self.subs.pop(0)

    def window_counts(self, window_s: int, now: float | None = None) -> list[int]:
        """Merged histogram of the trailing `window_s` seconds."""
        t = time.monotonic() if now is None else now
        oldest = int(t // _SUB_S) - window_s // _SUB_S
        merged = [0] * _N_BUCKETS
        for sub, counts in self.subs:
            if sub <= oldest:
                continue
            for i, c in enumerate(counts):
                if c:
                    merged[i] += c
        return merged

    def percentile(
        self, q: float, window_s: int | None = None, now: float | None = None
    ) -> float | None:
        """q-quantile (0..1) from the bucketed histogram; None when the
        window holds no samples. window_s=None → all-time."""
        counts = (
            self.hist if window_s is None else self.window_counts(window_s, now)
        )
        return _percentile(counts, q)

    @property
    def avg(self) -> float:
        return self.sum / self.count if self.count else 0.0


@dataclass
class Counters:
    counters: dict[str, float] = field(default_factory=dict)
    stats: dict[str, _Stat] = field(default_factory=dict)
    # the node's FlightRecorder (monitor/flight.py), attached by
    # OpenrNode; not a metric, so left out of snapshot() and compare
    flight: object | None = field(default=None, compare=False, repr=False)

    def flight_record(self, kind: str, **attrs) -> None:
        """Record one flight-recorder event; nothing without a recorder."""
        f = self.flight
        if f is not None:
            f.record(kind, **attrs)

    def set(self, key: str, value: float) -> None:
        self.counters[key] = value

    def increment(self, key: str, delta: float = 1) -> None:
        self.counters[key] = self.counters.get(key, 0) + delta

    def get(self, key: str, default: float = 0) -> float:
        return self.counters.get(key, default)

    def add_value(self, key: str, value: float, now: float | None = None) -> None:
        """Record one sample (`now` is injectable for window tests)."""
        self.stats.setdefault(key, _Stat()).add(value, now=now)

    def touch(self, key: str) -> None:
        """Timestamp counter (reference pattern: `<event>.time` counters)."""
        self.counters[key] = time.time()

    def snapshot(self, now: float | None = None) -> dict[str, float]:
        """Flat export (reference: getCounters() thrift API shape —
        stats expand to .sum/.count/.avg/.min/.max plus windowed
        `.p50`/`.p99` and `.p50.<window>`/`.p99.<window>` suffixes)."""
        out = dict(self.counters)
        for k, s in self.stats.items():
            out[f"{k}.sum"] = s.sum
            out[f"{k}.count"] = s.count
            out[f"{k}.avg"] = s.avg
            if s.count:
                out[f"{k}.min"] = s.min
                out[f"{k}.max"] = s.max
                for q, qname in ((0.5, "p50"), (0.99, "p99")):
                    v = s.percentile(q, None, now)
                    if v is not None:
                        out[f"{k}.{qname}"] = v
                    for w in WINDOWS_S:
                        v = s.percentile(q, w, now)
                        if v is not None:
                            out[f"{k}.{qname}.{w}"] = v
        return out


# --------------------------------------------------------- prometheus export


def _esc(label_value: str) -> str:
    """Prometheus label-value escaping (text exposition format: backslash,
    double-quote, newline)."""
    return (
        label_value.replace("\\", "\\\\")
        .replace('"', '\\"')
        .replace("\n", "\\n")
    )


def _num(v: float) -> str:
    if v == float("inf"):
        return "+Inf"
    if v == float("-inf"):
        return "-Inf"
    return repr(round(float(v), 6))


def render_prometheus(
    counters: Counters, node: str, now: float | None = None
) -> str:
    """Prometheus text exposition (format 0.0.4) of one node's counters.

    Counter keys are dotted free-form strings, so they ride in a `key`
    label rather than the metric name (names allow only [a-zA-Z0-9_:]).
    Three families:

      openr_counter{node,key}                       plain counters
      openr_stat{node,key,stat[,window]}            add_value aggregates
                                                    + windowed p50/p99
      openr_latency_bucket/_sum/_count{node,key,le} all-time histogram
    """
    lines: list[str] = []
    n = _esc(node)

    lines.append("# TYPE openr_counter gauge")
    for k in sorted(counters.counters):
        lines.append(
            f'openr_counter{{node="{n}",key="{_esc(k)}"}} '
            f"{_num(counters.counters[k])}"
        )

    lines.append("# TYPE openr_stat gauge")
    for k in sorted(counters.stats):
        s = counters.stats[k]
        ek = _esc(k)
        base = (
            ("count", float(s.count)),
            ("sum", s.sum),
            ("avg", s.avg),
        )
        for stat, v in base:
            lines.append(
                f'openr_stat{{node="{n}",key="{ek}",stat="{stat}"}} {_num(v)}'
            )
        if not s.count:
            continue
        for q, qname in ((0.5, "p50"), (0.99, "p99")):
            v = s.percentile(q, None, now)
            if v is not None:
                lines.append(
                    f'openr_stat{{node="{n}",key="{ek}",stat="{qname}",'
                    f'window="all"}} {_num(v)}'
                )
            for w in WINDOWS_S:
                v = s.percentile(q, w, now)
                if v is not None:
                    lines.append(
                        f'openr_stat{{node="{n}",key="{ek}",stat="{qname}",'
                        f'window="{w}s"}} {_num(v)}'
                    )

    lines.append("# TYPE openr_latency histogram")
    for k in sorted(counters.stats):
        s = counters.stats[k]
        if not s.count:
            continue
        ek = _esc(k)
        acc = 0
        for i, c in enumerate(s.hist[: len(_EDGES)]):
            if not c:
                continue  # one line per OCCUPIED bucket: dense enough to
                # parse, sparse enough to read (120 empty les elided);
                # cumulative values stay exact since empties add 0
            acc += c
            lines.append(
                f'openr_latency_bucket{{node="{n}",key="{ek}",'
                f'le="{_num(_EDGES[i])}"}} {acc}'
            )
        lines.append(
            f'openr_latency_bucket{{node="{n}",key="{ek}",le="+Inf"}} '
            f"{s.count}"
        )
        lines.append(
            f'openr_latency_sum{{node="{n}",key="{ek}"}} {_num(s.sum)}'
        )
        lines.append(
            f'openr_latency_count{{node="{n}",key="{ek}"}} {s.count}'
        )
    return "\n".join(lines) + "\n"

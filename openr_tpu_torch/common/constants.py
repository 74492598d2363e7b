"""Numeric and protocol constants the port needs: the solver's numeric
contract, the KvStore key conventions Decision parses, the default
ports, Spark's timers, the KvStore defaults, the queue and inbox bounds,
the Decision debounce defaults, LinkMonitor's flap damping, Fib's retry
bounds and client ids, the SR-MPLS label ranges and the watchdog's
periods.

Copied from the JAX package's `common/constants.py`; the port keeps its
own copy so that it imports nothing of the JAX package.

Solver numeric contract: int32 distances with INF sentinel 2^30. Valid
metrics are clamped to METRIC_MAX = 2^30-1; the relax step computes
min(dist + metric, INF) guarded by dist < INF, so the sum is at most
(2^30-1) + 2^30 = 2^31-1 == INT32_MAX — no wraparound.
"""

from __future__ import annotations

# KvStore key conventions: `adj:<node>` and
# `prefix:<node>:<area>:[<prefix>]`
ADJ_DB_MARKER = "adj:"
PREFIX_DB_MARKER = "prefix:"
KEY_DELIMITER = ":"

# default ports: the ctrl API, KvStore peering (TCP)
CTRL_PORT = 2018
KVSTORE_PORT = 2019

# Spark's timers, ms
SPARK_HELLO_INTERVAL_MS = 500
SPARK_FASTINIT_HELLO_INTERVAL_MS = 100
SPARK_HANDSHAKE_INTERVAL_MS = 500
SPARK_HEARTBEAT_INTERVAL_MS = 500
SPARK_HOLD_TIME_MS = 2_000
SPARK_GR_HOLD_TIME_MS = 30_000

# KvStore defaults: key TTL, anti-entropy period, flood rate limit (a
# token bucket per peer), the bound of a peer's pending-flood buffer
KVSTORE_DEFAULT_TTL_MS = 300_000
KVSTORE_TTL_DECREMENT_MS = 1  # the least decrement of a flooded TTL
KVSTORE_SYNC_INTERVAL_S = 60
KVSTORE_FLOOD_RATE_MSGS_PER_SEC = 600
KVSTORE_FLOOD_RATE_BURST = 300
KVSTORE_FLOOD_PENDING_MAX_KEYS = 8192
# per-reader depth cap of the policied inter-module queues (0: unbounded)
QUEUE_MAXSIZE = 1024
# Spark's inbox bound in the packet providers: past it the oldest packet
# is shed
SPARK_INBOX_MAXSIZE = 2048
# an originator refreshes a key's TTL at this fraction of it left
TTL_REFRESH_FRACTION = 0.25

# Decision's (min, max) debounce window, ms
DECISION_DEBOUNCE_MIN_MS = 10
DECISION_DEBOUNCE_MAX_MS = 250

# LinkMonitor's interface flap damping (an exponential hold-down), ms
LINK_FLAP_INITIAL_BACKOFF_MS = 60
LINK_FLAP_MAX_BACKOFF_MS = 300_000

# Fib's program retry backoff (ms) and full-resync period (s)
FIB_INITIAL_RETRY_MS = 8
FIB_MAX_RETRY_MS = 4_096
FIB_SYNC_INTERVAL_S = 60

# FibService client ids: each routing daemon programs its own table
FIB_CLIENT_OPENR = 786
FIB_CLIENT_STATIC = 64

# SR-MPLS label spaces: node segment labels, adjacency labels
MPLS_LABEL_MIN = 16
MPLS_LABEL_MAX = (1 << 20) - 1
SR_GLOBAL_RANGE = (101, 49_999)
SR_LOCAL_RANGE = (50_000, 59_999)

# the watchdog's check period and a module's heartbeat timeout, s
WATCHDOG_INTERVAL_S = 20
WATCHDOG_THREAD_TIMEOUT_S = 300

DEFAULT_AREA = "0"
DIST_INF = 1 << 30
METRIC_MAX = (1 << 30) - 1


def adj_key(node: str) -> str:
    """`adj:<node>`."""
    return f"{ADJ_DB_MARKER}{node}"


def validate_name(name: str, what: str = "name") -> str:
    """Node and area names must be non-empty and hold no key delimiter."""
    if KEY_DELIMITER in name or not name:
        raise ValueError(f"invalid {what} {name!r}: empty or contains ':'")
    return name


def prefix_key(node: str, area: str, prefix: str) -> str:
    """Per-prefix key `prefix:<node>:<area>:[<prefix>]`."""
    validate_name(node, "node name")
    validate_name(area, "area")
    return f"{PREFIX_DB_MARKER}{node}{KEY_DELIMITER}{area}{KEY_DELIMITER}[{prefix}]"


def parse_adj_key(key: str) -> str | None:
    """The node name if `key` is an adj key, else None."""
    if key.startswith(ADJ_DB_MARKER):
        return key[len(ADJ_DB_MARKER):]
    return None


def parse_prefix_key(key: str) -> tuple[str, str, str] | None:
    """(node, area, prefix) if `key` is a per-prefix key, else None."""
    if not key.startswith(PREFIX_DB_MARKER):
        return None
    rest = key[len(PREFIX_DB_MARKER):]
    try:
        node, area, bracketed = rest.split(KEY_DELIMITER, 2)
    except ValueError:
        return None
    if bracketed.startswith("[") and bracketed.endswith("]"):
        return node, area, bracketed[1:-1]
    return None

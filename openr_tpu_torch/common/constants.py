"""Numeric and protocol constants the port's solve path needs.

Copied from the JAX package's `common/constants.py`; the port keeps its
own copy so that it imports nothing of the JAX package.

Solver numeric contract: int32 distances with INF sentinel 2^30. Valid
metrics are clamped to METRIC_MAX = 2^30-1; the relax step computes
min(dist + metric, INF) guarded by dist < INF, so the sum is at most
(2^30-1) + 2^30 = 2^31-1 == INT32_MAX — no wraparound.
"""

MPLS_LABEL_MIN = 16
DEFAULT_AREA = "0"
DIST_INF = 1 << 30
METRIC_MAX = (1 << 30) - 1

"""Reusable per-area solve state (the port's copy of `SpfResult` and
`SolveArtifact` of `openr_tpu/decision/oracle.py`), shared by both
engines.

`TorchSpfSolver.compute_routes(..., return_artifact=True)` and the
oracle's `compute_routes` return one beside the RouteDatabase;
`assemble_prefix_routes` re-assembles touched prefixes against it with
no new solve, and `warm_compute_routes` seeds the topology-delta warm
solve from it.
"""

from __future__ import annotations

import sys
from dataclasses import dataclass

from openr_tpu_torch.types.routes import NexthopIntern


@dataclass
class SpfResult:
    """One root's host SPF (the oracle engine): distances, the ECMP
    first-hop set of every reached node, and the equal-cost predecessor
    DAG they come from. `preds` is kept so `warm_spf` can repair the DAG
    locally; None once `drop_warm_state` released it (the next warm round
    then takes one full solve)."""

    dist: dict[str, int]
    first_hops: dict[str, set[str]]
    preds: dict[str, set[str]] | None = None


@dataclass
class SolveArtifact:
    """Reusable per-area solve state of either engine: the oracle's
    adjacency and SPF results, or the card's `solve()` tuple. It is valid
    while the area's topology is unchanged."""

    my_node: str
    ls: object  # the LinkState (or snapshot) the solve ran against
    # --- oracle engine state ------------------------------------------
    adj: dict[str, dict[str, int]] | None = None
    spf: SpfResult | None = None
    lfa_spfs: dict[str, SpfResult] | None = None
    overloaded_set: set[str] | None = None  # lazy (KSP prefixes only)
    ksp_k: int = 2
    # --- card engine state: the solve() tuple (csr, dist, fh, nbr_ids, lfa)
    solved: tuple | None = None
    # --- oracle warm-start state, built on the first topology-delta
    # round and dropped by `drop_warm_state` -----------------------------
    radj: dict[str, dict[str, int]] | None = None  # reverse adjacency
    # the least edge weight seen (may be stale-low across warm rounds,
    # the safe side of warm_spf's >= 1 guard)
    min_metric: int | None = None
    # nexthop-group intern table; None on the oracle's scalar path
    # (vectorize=False), which stays plain tuples
    nh_intern: NexthopIntern | None = None

    def warm_state_bytes(self) -> int:
        """Host bytes of the warm-start-only state (what `drop_warm_state`
        reclaims), counted as the reference counts them: the oracle's
        reverse adjacency and predecessor sets, and the `LazyDist` host
        mirror of the card's [vp, B] distances once something has read
        it. The device-resident matrix does not count; it stays, since
        the warm solve relaxes a copy of it."""
        total = 0
        if self.radj is not None:
            total += sys.getsizeof(self.radj)
            total += sum(sys.getsizeof(d) for d in self.radj.values())
        if self.spf is not None and self.spf.preds is not None:
            total += sys.getsizeof(self.spf.preds)
            total += sum(sys.getsizeof(s) for s in self.spf.preds.values())
        if self.solved is not None:
            mirror = getattr(self.solved[1], "_np", None)
            if mirror is not None:
                total += int(mirror.nbytes)
        return total

    def drop_warm_state(self) -> None:
        """Release the warm-start-only state. What `assemble_prefix_routes`
        reads stays; the next warm round rebuilds the reverse adjacency
        or the host mirror on demand, and without `preds` takes one full
        solve."""
        self.radj = None
        if self.spf is not None:
            self.spf.preds = None
        if self.solved is not None and hasattr(self.solved[1], "_np"):
            self.solved[1]._np = None


def metric_key(e) -> tuple[int, int, int]:
    """Lexicographic best-route key of a PrefixEntry, larger is better:
    path_preference desc, source_preference desc, distance asc."""
    return (
        e.metrics.path_preference,
        e.metrics.source_preference,
        -e.metrics.distance,
    )

"""Reusable per-area solve state (the port's copy of the engine fields of
`openr_tpu/decision/oracle.py` `SolveArtifact`).

`TorchSpfSolver.compute_routes(..., return_artifact=True)` returns one
beside the RouteDatabase; `assemble_prefix_routes` re-assembles touched
prefixes against it with no new solve, and `warm_compute_routes` seeds
the topology-delta warm solve from it.
"""

from __future__ import annotations

from dataclasses import dataclass

from openr_tpu_torch.types.routes import NexthopIntern


@dataclass
class SolveArtifact:
    my_node: str
    ls: object  # the LinkState (or snapshot) the solve ran against
    ksp_k: int = 2
    # the solve() tuple (csr, dist, fh, nbr_ids, lfa)
    solved: tuple | None = None
    nh_intern: NexthopIntern | None = None


def metric_key(e) -> tuple[int, int, int]:
    """Lexicographic best-route key of a PrefixEntry, larger is better:
    path_preference desc, source_preference desc, distance asc."""
    return (
        e.metrics.path_preference,
        e.metrics.source_preference,
        -e.metrics.distance,
    )

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

    def warm_state_bytes(self) -> int:
        """Host bytes of the warm-start-only state (what `drop_warm_state`
        reclaims): the `LazyDist` host mirror of the [vp, B] distances,
        once something has read it. The device-resident matrix does not
        count, as in the reference, whose number is host memory only
        (Decision's soak watermark reads it as such); it stays, since the
        warm solve relaxes a copy of it."""
        if self.solved is None:
            return 0
        mirror = getattr(self.solved[1], "_np", None)
        return 0 if mirror is None else int(mirror.nbytes)

    def drop_warm_state(self) -> None:
        """Release the host mirror. The root column, the first hops and the
        device matrix stay, so `assemble_prefix_routes` needs nothing
        back and the next warm round copies the matrix again on demand."""
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

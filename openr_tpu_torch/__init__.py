"""openr_tpu_torch: the PyTorch/CUDA port of openr_tpu's device layer.

It ports the cold single-root RIB solve (`TorchSpfSolver(device=...)
.solve()` / `.compute_routes()`, for every prefix shape: plain, anycast,
UCMP, min_nexthop, LFA backups and KSP2_ED_ECMP) and its warm rebuild
after a link flap (`LinkState`'s metric-patch journal,
`TorchSpfSolver.warm_compute_routes`), and the batched multi-root solve
behind `TorchSpfSolver._solve_dist` on each table kind the reference's
knobs pick (`use_dense`, `dense_waste_limit`, `use_pallas`,
`kernel_impl`): the split tables, the dense in-neighbor tables, or the
edge list; with it `ops.spf.all_sources_sssp` (every source, in chunks)
and `decision.fleet.compute_fleet_ribs` (every node's RIB). Every relax
of the split and dense tables runs the hand-written Hopper kernel
`csrc/relax.cu` on a CUDA device and its plain PyTorch version on the
CPU; the edge list runs `csrc/edge_relax.cu`, the anycast election
`csrc/election.cu` and KSP `csrc/ksp.cu` the same way; `probe_gather`
holds the relax kernel's two designs against the TPU gather probe.
`parallel` shards the batched solve over a mesh of positions (one or
more cards, or processes joined by `torch.distributed`), on the same
kernels. The package imports torch, numpy and the standard library
only.
"""

from openr_tpu_torch.decision.linkstate import (  # noqa: F401
    CsrGraph,
    LinkState,
    PrefixState,
)
from openr_tpu_torch.decision.spf_backend import TorchSpfSolver  # noqa: F401

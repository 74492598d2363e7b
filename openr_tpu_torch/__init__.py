"""openr_tpu_torch: the PyTorch/CUDA port of openr_tpu's device layer.

It ports the cold single-root RIB solve on the split path
(`TorchSpfSolver(device=...).solve()` / `.compute_routes()`) and its
warm rebuild after a link flap (`LinkState`'s metric-patch journal,
`TorchSpfSolver.warm_compute_routes`). Every relax runs the
hand-written Hopper kernel `csrc/relax.cu` on a CUDA device and its
plain PyTorch version on the CPU; `probe_gather` holds the kernel's two
designs against the TPU gather probe. The package imports torch, numpy
and the standard library only.
"""

from openr_tpu_torch.decision.linkstate import (  # noqa: F401
    CsrGraph,
    LinkState,
    PrefixState,
)
from openr_tpu_torch.decision.spf_backend import TorchSpfSolver  # noqa: F401

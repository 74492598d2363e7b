"""Sharded SPF over a mesh of positions (port of `openr_tpu/parallel/`).

  * `sources` axis: the SPF roots, split with no exchange (batch
    parallelism: all-sources SSSP, fleet solves);
  * `graph` axis: the tables or the edge list, split, with an exchange of
    the distances every sweep or round (the LSDB beyond one device).

`mesh.py` builds the meshes, `sharded_spf.py` runs the solves on kernels
A and H, and `distributed.py` spans processes with `torch.distributed`.
"""

from openr_tpu_torch.parallel.mesh import make_mesh  # noqa: F401
from openr_tpu_torch.parallel.sharded_spf import (  # noqa: F401
    sharded_sssp,
    sharded_sssp_padded,
    sharded_sssp_split,
)

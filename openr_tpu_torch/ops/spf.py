"""Numeric contract, the first-hop / LFA epilogue of the batched solve
as torch functions, and the dense in-neighbor tables (port of
`openr_tpu/ops/spf.py`).

Distances are int32 with INF_DIST = 2^30 meaning unreachable; valid
metrics are at most METRIC_MAX = 2^30-1, so a guarded `d + w` never
exceeds INT32_MAX.
"""

from __future__ import annotations

import numpy as np
import torch

from openr_tpu_torch.common import constants as _C
from openr_tpu_torch.common.util import pad_bucket as pad_batch

INF_DIST = _C.DIST_INF
METRIC_MAX = _C.METRIC_MAX
DIST_DTYPE = torch.int32


def first_hop_matrix(dist, neighbor_metric, neighbor_ids, neighbor_overloaded):
    """ECMP first-hop validity [N, Vp]: neighbor n is a first hop toward
    d iff metric(root->n) + dist_n(d) == dist_root(d), both reachable;
    overloaded neighbors only toward themselves. `dist` [Vp, B] has
    col 0 = the root, cols 1..N = its neighbors."""
    d_root = dist[:, 0]
    d_nbr = dist[:, 1 : 1 + neighbor_ids.shape[0]]
    reach = (d_root < INF_DIST)[:, None] & (d_nbr < INF_DIST)
    on_spt = reach & (neighbor_metric[None, :] + d_nbr == d_root[:, None])
    ids = torch.arange(dist.shape[0], device=dist.device)
    dest_is_nbr = ids[:, None] == neighbor_ids[None, :]
    allowed = ~neighbor_overloaded[None, :] | dest_is_nbr
    return (on_spt & allowed).T


def lfa_matrix(dist, my_id, neighbor_ids, neighbor_overloaded):
    """RFC 5286 loop-free alternates [N, Vp]:
    dist_n(d) < dist_n(root) + dist_root(d), all three reachable;
    overloaded neighbors only toward themselves."""
    n = neighbor_ids.shape[0]
    d_root = dist[:, 0]
    d_nbr = dist[:, 1 : 1 + n]
    n_to_root = dist[int(my_id), 1 : 1 + n]
    reach = (
        (d_root < INF_DIST)[:, None]
        & (d_nbr < INF_DIST)
        & (n_to_root < INF_DIST)[None, :]
    )
    loop_free = d_nbr < torch.clamp_max(
        n_to_root[None, :] + d_root[:, None], INF_DIST
    )
    ids = torch.arange(dist.shape[0], device=dist.device)
    dest_is_nbr = ids[:, None] == neighbor_ids[None, :]
    allowed = ~neighbor_overloaded[None, :] | dest_is_nbr
    return (reach & loop_free & allowed).T


def build_dense_tables(
    edge_src: np.ndarray,
    edge_dst: np.ndarray,
    edge_metric: np.ndarray,
    num_nodes_padded: int,
    min_width: int = 8,
) -> tuple[np.ndarray, np.ndarray]:
    """Dense in-neighbor tables nbr [Vp, D] i32, wgt [Vp, D] i32 (INF
    padding, neighbor 0), from dst-sorted edge arrays: edge i fills row
    dst[i] at its rank among that row's edges. D is the next power of two
    >= the max in-degree (at least `min_width`)."""
    valid = edge_metric < int(INF_DIST)
    src = edge_src[valid].astype(np.int64)
    dst = edge_dst[valid].astype(np.int64)
    met = edge_metric[valid]
    e = src.shape[0]
    indeg = np.bincount(dst, minlength=num_nodes_padded)
    max_deg = int(indeg.max()) if e else 1
    d_width = pad_batch(max_deg, minimum=min_width)
    nbr = np.zeros((num_nodes_padded, d_width), dtype=np.int32)
    wgt = np.full((num_nodes_padded, d_width), INF_DIST, dtype=np.int32)
    if e:
        row_start = np.zeros(num_nodes_padded + 1, dtype=np.int64)
        np.add.at(row_start, dst + 1, 1)
        row_start = np.cumsum(row_start)
        col = np.arange(e, dtype=np.int64) - row_start[dst]
        nbr[dst, col] = src.astype(np.int32)
        wgt[dst, col] = met
    return nbr, wgt

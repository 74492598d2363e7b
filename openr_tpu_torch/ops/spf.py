"""Numeric contract, the first-hop / LFA epilogue of the batched solve
as torch functions, the dense in-neighbor tables, the blocked-edge mask
and the chunked all-sources solve (port of `openr_tpu/ops/spf.py`; its
edge-list `batched_sssp` is `ops/edge_relax.py`).

Distances are int32 with INF_DIST = 2^30 meaning unreachable; valid
metrics are at most METRIC_MAX = 2^30-1, so a guarded `d + w` never
exceeds INT32_MAX.
"""

from __future__ import annotations

import numpy as np
import torch

from openr_tpu_torch.common import constants as _C
from openr_tpu_torch.common.util import pad_bucket as pad_batch
from openr_tpu_torch.monitor import compile_ledger

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


def first_hop_work(vp: int, b: int) -> tuple[int, int]:
    """(least DRAM bytes, integer operations) of `first_hop_matrix` on
    a [vp, b] distance matrix: the matrix read once, the b - 1 neighbors'
    metric, id and overload flag read, the [b - 1, vp] bits written as
    bytes; an add, two compares and two ands per bit."""
    n = b - 1
    return vp * b * 4 + n * 9 + n * vp, 5 * n * vp


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


def build_blocked(
    edge_metric: np.ndarray,
    edge_src: np.ndarray,
    node_overloaded: np.ndarray,
) -> np.ndarray:
    """Host-side: edges that never carry transit traffic: padding and
    invalid slots, and every edge leaving an overloaded node (the
    per-root exemption happens at the edge-list solve's init)."""
    return (edge_metric >= int(INF_DIST)) | node_overloaded[edge_src]


class HostRows:
    """A host [rows, cols] int32 result filled from device chunks: each
    `put` copies a chunk's first columns, transposed, into the next rows
    on a side stream into pinned memory, so that the copy overlaps
    whatever the device runs next; `result()` waits for every copy. On
    the CPU the copies are plain."""

    def __init__(self, rows: int, cols: int, device):
        self.device = torch.device(device)
        cuda = self.device.type == "cuda"
        self.out = torch.empty((rows, cols), dtype=DIST_DTYPE,
                               pin_memory=cuda)
        self.stream = torch.cuda.Stream(self.device) if cuda else None

    def put(self, row0: int, dist: torch.Tensor, n: int) -> None:
        """Rows row0 .. row0+n-1 = columns 0 .. n-1 of `dist` [cols, B]."""
        t = dist[:, :n].t().contiguous()
        compile_ledger.record_transfer(t.nbytes)
        if self.stream is None:
            self.out[row0 : row0 + n].copy_(t)
            return
        self.stream.wait_stream(torch.cuda.current_stream(self.device))
        with torch.cuda.stream(self.stream):
            self.out[row0 : row0 + n].copy_(t, non_blocking=True)
        t.record_stream(self.stream)  # kept until the copy has read it

    def result(self) -> np.ndarray:
        if self.stream is not None:
            self.stream.synchronize()
        return self.out.numpy()


def all_sources_sssp(
    edge_src: torch.Tensor,
    edge_dst: torch.Tensor,
    edge_metric: torch.Tensor,
    edge_blocked: torch.Tensor,
    num_nodes: int,
    chunk: int = 256,
    stats: dict | None = None,
    index=None,
) -> np.ndarray:
    """Distances from every node slot (BASELINE config 3) on the
    edge-list solve, in chunks of `chunk` roots; the tail chunk is padded
    with root 0, as the reference pads it. Returns host [V, V] int32
    (row = source). Each chunk's copy to the host runs on a side stream
    while the next chunk computes (`HostRows`). The edge index
    (`edge_relax.EdgeIndex`) is built once, for every chunk, where
    `index` does not give it."""
    from openr_tpu_torch.ops.edge_relax import batched_sssp, device_edge_index

    dev = edge_src.device
    if index is None:
        index = device_edge_index(edge_src, edge_dst, edge_metric,
                                  num_nodes)
    sink = HostRows(num_nodes, num_nodes, dev)
    for start in range(0, num_nodes, chunk):
        b = min(chunk, num_nodes - start)
        roots = torch.zeros(chunk, dtype=torch.int32)
        roots[:b] = torch.arange(start, start + b, dtype=torch.int32)
        d = batched_sssp(
            edge_src, edge_dst, edge_metric, edge_blocked, roots.to(dev),
            num_nodes, stats=stats, index=index,
        )
        sink.put(start, d, b)
    return sink.result()

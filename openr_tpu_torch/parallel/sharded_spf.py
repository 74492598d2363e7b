"""Sharded batched SSSP over a sources x graph mesh (port of
`openr_tpu/parallel/sharded_spf.py`).

  * roots are split over the `sources` axis: each graph row of the mesh
    (one sources index) solves its own slice of roots, with no exchange
    between rows;
  * the tables or the edge list are split over the `graph` axis: each
    position relaxes its own part, and the positions of a graph row
    exchange what they found every sweep or round.

`sharded_sssp_split` runs the split tables' solve: position (s, g) owns
the base rows [g vp/G, (g+1) vp/G). A sweep relaxes each position's own
rows in place with kernel A (`ops/relax.py` `relax_rows`, with the rows'
own overload mask), gathers the rows over the graph row, then relaxes
the replicated overflow rows with kernel A from the sweep's start
(Jacobi, as the reference's overflow relax is). The sweep's in-place
updates are Gauss-Seidel where the reference is Jacobi: the same
fixpoint of the monotone min system, in as many sweeps or fewer.
`sharded_sssp` runs the edge-list Bellman-Ford: position (s, g) owns the
contiguous edge slice g. The init is kernel H's init on each slice
(`edge_relax.edge_init`), then a MIN over the graph row; a round is
kernel H capped at one round on each slice (`edge_relax.edge_round`,
which keeps the min with the distances), then a MIN over the graph row.

Positions that share a device share one copy of the distances of their
graph row: a gather between them is nothing, and a MIN is taken as their
rounds are. Between devices of one process the exchanges are copies;
between processes (a mesh from `distributed.global_mesh`) they are
`torch.distributed` collectives on the graph row's own group: an
`all_gather` of the rows each process relaxed, an `all_reduce` MIN. The
distances are then equal at every position of a graph row, so each row's
exit flag (did anything fall this sweep) is the same in every process
and the trip counts agree without a collective of their own. The flags
of every row a process drives are read back together, one host sync a
sweep or round (`compile_ledger.record_sync`).

The results are `ShardedArray`s laid out (None, sources): each position
holds its row's [vp, B/S] columns.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from openr_tpu_torch.common.constants import DIST_INF
from openr_tpu_torch.monitor import compile_ledger
from openr_tpu_torch.monitor import device as _telemetry
from openr_tpu_torch.ops import edge_relax, relax
from openr_tpu_torch.parallel.mesh import (
    GRAPH_AXIS,
    SOURCES_AXIS,
    Mesh,
    ShardedArray,
    shard,
)

INF_DIST = DIST_INF
#: the layout of every result: rows whole, roots over `sources`
OUT_SPEC = (None, SOURCES_AXIS)


class _GraphRow:
    """Graph row `s` of a mesh, as this process drives it: its local
    positions, their devices, and the exchanges between its positions."""

    def __init__(self, mesh: Mesh, s: int):
        self.mesh, self.s = mesh, s
        g_n = mesh.shape[GRAPH_AXIS]
        self.local = [g for g in range(g_n) if mesh.is_local(s, g)]
        self.devices: list[torch.device] = []
        for g in self.local:
            d = mesh.device(s, g)
            if d not in self.devices:
                self.devices.append(d)
        self.group = mesh.groups[s] if mesh.groups is not None else None
        if self.group is not None and len(self.devices) > 1:
            raise ValueError(
                "a mesh across processes takes one device per process; "
                f"graph row {s} has {self.devices} here"
            )

    def gather_rows(self, bufs: dict, rows: int) -> None:
        """Every buffer of the row (one per device, [vp, B]) gets the
        rows [g rows, (g+1) rows) of position g from the buffer of g's
        device, or of g's process."""
        if self.group is None:
            for g in range(self.mesh.shape[GRAPH_AXIS]):
                src = bufs[self.mesh.device(self.s, g)]
                for d, buf in bufs.items():
                    if buf is not src:
                        buf[g * rows:(g + 1) * rows].copy_(
                            src[g * rows:(g + 1) * rows])
            return
        import torch.distributed as dist

        (buf,) = bufs.values()
        by_rank = self._positions_by_rank()
        k = max(len(gs) for gs in by_rank.values())
        mine = buf.new_empty((k * rows, buf.shape[1]))
        for j, g in enumerate(self.local):
            mine[j * rows:(j + 1) * rows] = buf[g * rows:(g + 1) * rows]
        got = [torch.empty_like(mine) for _ in by_rank]
        dist.all_gather(got, mine, group=self.group)
        for part, (rank, gs) in zip(got, sorted(by_rank.items())):
            if rank == self.mesh.rank:
                continue
            for j, g in enumerate(gs):
                buf[g * rows:(g + 1) * rows] = part[j * rows:(j + 1) * rows]

    def all_min(self, accs: dict) -> None:
        """Every buffer of the row (one per device) becomes the
        entry-wise MIN of the row's buffers, in every process."""
        if self.group is None:
            first, *rest = accs.values()
            for t in rest:
                torch.minimum(first, t.to(first.device), out=first)
            for t in rest:
                t.copy_(first)
            return
        import torch.distributed as dist

        (acc,) = accs.values()
        dist.all_reduce(acc, op=dist.ReduceOp.MIN, group=self.group)

    def _positions_by_rank(self) -> dict[int, list[int]]:
        out: dict[int, list[int]] = {}
        for g in range(self.mesh.shape[GRAPH_AXIS]):
            out.setdefault(int(self.mesh.ranks[self.s, g]), []).append(g)
        return out


def _rows(mesh: Mesh) -> list[_GraphRow]:
    """The graph rows this process drives a position of."""
    rows = [_GraphRow(mesh, s) for s in range(mesh.shape[SOURCES_AXIS])]
    return [r for r in rows if r.local]


def _check_divides(n: int, mesh: Mesh, axis: str, what: str) -> None:
    if n % mesh.shape[axis]:
        raise ValueError(
            f"{what}={n} must divide by {axis} axis size {mesh.shape[axis]}"
        )


def _read_flags(flags: list) -> list[bool]:
    """The rows' exit flags (device bools), read back in one sync."""
    if not flags:
        return []
    dev = flags[0].device
    vals = torch.stack([f.to(dev) for f in flags]).tolist()
    compile_ledger.record_sync()
    return [bool(v) for v in vals]


def _out(mesh: Mesh, shape, dists: dict) -> ShardedArray:
    """The result laid out (None, sources) from each local position's
    columns: `dists[(s, device)]`."""
    pieces = {}
    for (s, g), d in np.ndenumerate(mesh.devices):
        if mesh.is_local(s, g):
            pieces[(s, g)] = dists[(s, d)]
    return ShardedArray(mesh, shape, OUT_SPEC, pieces, dtype=torch.int32)


def sharded_sssp_split(base_nbr, base_wgt, ov_ids, ov_nbr, ov_wgt,
                       node_overloaded, roots, mesh: Mesh,
                       has_overloads: bool = False,
                       stats: dict | None = None) -> ShardedArray:
    """Distances [vp, B] from each root on the split tables, laid out
    (None, sources) over `mesh`. `base_nbr` / `base_wgt` [vp, W] (vp
    must divide by the graph axis) and the replicated `ov_ids`, `ov_nbr`,
    `ov_wgt`, `node_overloaded` and the roots [B] (B must divide by the
    sources axis) are tensors or NumPy arrays (the same whole arrays in
    every process) or `ShardedArray`s of `shard` with the specs
    (graph, None), (), (), (), (), (), (sources,). With `stats`, sets
    sweeps (the most any graph row ran) and host_syncs."""
    vp = int(base_nbr.shape[0])
    _check_divides(vp, mesh, GRAPH_AXIS, "vp")
    b = int(roots.shape[0])
    _check_divides(b, mesh, SOURCES_AXIS, "B")
    nbr = shard(base_nbr, mesh, (GRAPH_AXIS, None))
    wgt = shard(base_wgt, mesh, (GRAPH_AXIS, None))
    ov = {k: shard(a, mesh, ()) for k, a in (
        ("ids", ov_ids), ("nbr", ov_nbr), ("wgt", ov_wgt),
        ("over", node_overloaded))}
    rts = shard(roots, mesh, (SOURCES_AXIS,))
    rows = vp // mesh.shape[GRAPH_AXIS]
    bs = b // mesh.shape[SOURCES_AXIS]

    work = []  # per graph row: (row, bufs {device: dist}, per-device args)
    for row in _rows(mesh):
        s = row.s
        bufs, ovs, own = {}, {}, {}
        for d in row.devices:
            g0 = next(g for g in row.local if mesh.device(s, g) == d)
            r = rts.pieces[(s, g0)].to(torch.int32)
            dist = torch.full((vp, bs), INF_DIST, dtype=torch.int32,
                              device=d)
            dist[r.long(), torch.arange(bs, device=d)] = 0
            bufs[d] = dist
            ovn = ov["nbr"].pieces[(s, g0)]
            over = ov["over"].pieces[(s, g0)]
            ovs[d] = (r, ov["ids"].pieces[(s, g0)], ovn,
                      ov["wgt"].pieces[(s, g0)],
                      over[ovn.long()].contiguous() if has_overloads
                      else None)
        for g in row.local:
            d = mesh.device(s, g)
            n_g = nbr.pieces[(s, g)]
            over = ov["over"].pieces[(s, g)]
            own[g] = (d, n_g, wgt.pieces[(s, g)],
                      over[n_g.long()].contiguous() if has_overloads
                      else None,
                      torch.arange(g * rows, (g + 1) * rows,
                                   dtype=torch.int32, device=d))
        work.append((row, bufs, ovs, own))

    active = list(range(len(work)))
    sweeps = syncs = 0
    while active and sweeps < vp:
        flags = []
        for i in active:
            row, bufs, ovs, own = work[i]
            prev = {d: t.clone() for d, t in bufs.items()}
            for g in row.local:
                d, n_g, w_g, o_g, dst = own[g]
                relax.relax_rows(bufs[d], bufs[d], n_g, w_g, ovs[d][0], o_g,
                                 n=rows, dst_rows=dst)
            row.gather_rows(bufs, rows)
            for d, buf in bufs.items():
                r, ids, ovn, ovw, ovo = ovs[d]
                relax.relax_rows(prev[d], buf, ovn, ovw, r, ovo,
                                 dst_rows=ids)
            d0 = row.devices[0]
            flags.append((bufs[d0] < prev[d0]).any())
        sweeps += 1
        syncs += 1
        active = [i for i, f in zip(active, _read_flags(flags)) if f]
    if stats is not None:
        stats["sweeps"] = sweeps
        stats["host_syncs"] = syncs
    return _out(mesh, (vp, b), {(row.s, d): t for row, bufs, _o, _w in work
                                for d, t in bufs.items()})


def _pad_roots(r: torch.Tensor) -> torch.Tensor:
    """`r` padded to a multiple of 4 columns by repeating its first root:
    kernel H carries 4 columns a lane."""
    bq = -(-r.shape[0] // 4) * 4
    if bq == r.shape[0]:
        return r
    return torch.cat([r, r[:1].expand(bq - r.shape[0])]).contiguous()


def sharded_sssp(edge_src, edge_dst, edge_metric, edge_blocked, roots,
                 mesh: Mesh, num_nodes: int,
                 stats: dict | None = None) -> ShardedArray:
    """Distances [num_nodes, B] from each root on the dst-sorted edge
    list, laid out (None, sources) over `mesh`. The edge arrays [Ep] (Ep
    must divide by the graph axis; `edge_blocked` bool, holding the
    overloaded-transit edges) and the roots [B] (B must divide by the
    sources axis) are tensors or NumPy arrays or `ShardedArray`s of
    `shard` with the specs (graph,) and (sources,). Each slice's
    `edge_relax.EdgeIndex` is built on the host per call. With `stats`,
    sets rounds (the most any graph row ran), host_syncs and index_ms
    (the host wall of the index builds)."""
    e = int(edge_src.shape[0])
    _check_divides(e, mesh, GRAPH_AXIS, "Ep")
    b = int(roots.shape[0])
    _check_divides(b, mesh, SOURCES_AXIS, "B")
    edges = [shard(a, mesh, (GRAPH_AXIS,)) for a in (
        edge_src, edge_dst, edge_metric, edge_blocked)]
    rts = shard(roots, mesh, (SOURCES_AXIS,))
    bs = b // mesh.shape[SOURCES_AXIS]
    v = int(num_nodes)
    sink = _telemetry.sink()

    t0 = time.perf_counter()
    slices = {}  # (device, g) -> (src, dst, metric, blocked, index)
    for (s, g), d in np.ndenumerate(mesh.devices):
        if mesh.is_local(s, g) and (d, g) not in slices:
            src, dst, met, blk = (a.pieces[(s, g)] for a in edges)
            src, dst, met = (x.to(torch.int32).contiguous()
                             for x in (src, dst, met))
            index = edge_relax.index_to(edge_relax.edge_index(
                src.cpu().numpy(), dst.cpu().numpy(), met.cpu().numpy(), v,
            ), d)
            slices[(d, g)] = (src, dst, met, blk.to(torch.bool).contiguous(),
                              index)
    index_ms = (time.perf_counter() - t0) * 1e3

    work = []  # per graph row: (row, roots by device, dist by device)
    for row in _rows(mesh):
        s = row.s
        rq, accs = {}, {}
        for d in row.devices:
            g0 = next(g for g in row.local if mesh.device(s, g) == d)
            rq[d] = _pad_roots(rts.pieces[(s, g0)].to(torch.int32))
            bq = rq[d].shape[0]
            for g in row.local:
                if mesh.device(s, g) != d:
                    continue
                src, dst, met, _blk, index = slices[(d, g)]
                t = torch.empty((v, bq), dtype=torch.int32, device=d)
                edge_relax.edge_init(t, src, dst, met, rq[d], index)
                if sink is not None:
                    sink.add("edge_relax", *edge_relax.init_work(
                        index, v, bq, edge_relax.tile_cols(bq), rq[d]))
                if d in accs:
                    torch.minimum(accs[d], t, out=accs[d])
                else:
                    accs[d] = t
        row.all_min(accs)
        work.append((row, rq, accs))

    active = list(range(len(work)))
    rounds = syncs = 0
    while active and rounds < v:
        flags = []
        for i in active:
            row, rq, dists = work[i]
            nxt = {}
            for d, cur in dists.items():
                changed = torch.zeros(1, dtype=torch.int32, device=d)
                for g in row.local:
                    if mesh.device(row.s, g) != d:
                        continue
                    src, dst, met, blk, index = slices[(d, g)]
                    t = torch.empty_like(cur)
                    edge_relax.edge_round(cur, t, src, dst, met, blk,
                                          index.row_start, changed,
                                          index=index)
                    if sink is not None:
                        sink.add("edge_relax", *edge_relax.round_work(
                            src, blk, index, v, cur.shape[1])[:2])
                    if d in nxt:
                        torch.minimum(nxt[d], t, out=nxt[d])
                    else:
                        nxt[d] = t
            row.all_min(nxt)
            d0 = row.devices[0]
            flags.append((nxt[d0] < dists[d0]).any())
            work[i] = (row, rq, nxt)
        rounds += 1
        syncs += 1
        active = [i for i, f in zip(active, _read_flags(flags)) if f]
    if stats is not None:
        stats["rounds"] = rounds
        stats["host_syncs"] = syncs
        stats["index_ms"] = index_ms
    return _out(mesh, (v, b), {
        (row.s, d): t[:, :bs] if t.shape[1] != bs else t
        for row, _rq, dists in work for d, t in dists.items()})


def sharded_sssp_padded(edge_src, edge_dst, edge_metric, edge_blocked,
                        roots, mesh: Mesh, num_nodes: int,
                        stats: dict | None = None) -> ShardedArray:
    """`sharded_sssp` for any sizes: the roots padded to a multiple of
    the sources axis (repeating the first root; the duplicate columns
    are cut from the result) and the edge arrays to a multiple of the
    graph axis with dead slots (src 0, dst `num_nodes - 1`, metric INF,
    blocked), which no round relaxes and `edge_row_start` leaves out of
    every run. `ShardedArray`s (of `distributed.shard_host_array`) pass
    through unpadded. Returns [num_nodes, len(roots)], and records the
    `sharded_sssp` cost row under the span `spf:sharded_solve`."""
    s_n, g_n = mesh.shape[SOURCES_AXIS], mesh.shape[GRAPH_AXIS]
    b = int(roots.shape[0])
    bp = b
    if not isinstance(roots, ShardedArray):
        roots = (roots.to(torch.int32) if isinstance(roots, torch.Tensor)
                 else torch.as_tensor(np.asarray(roots), dtype=torch.int32))
        bp = -(-b // s_n) * s_n
        if bp != b:
            roots = torch.cat([roots, roots[:1].expand(bp - b)])
    arrs = [a if isinstance(a, (torch.Tensor, ShardedArray))
            else torch.as_tensor(a)
            for a in (edge_src, edge_dst, edge_metric, edge_blocked)]
    e = int(arrs[0].shape[0])
    pad = 0
    if not any(isinstance(a, ShardedArray) for a in arrs):
        pad = -(-e // g_n) * g_n - e
    if pad:
        fill = (0, num_nodes - 1, INF_DIST, True)
        arrs = [torch.cat([a, torch.full((pad,), f, dtype=a.dtype,
                                         device=a.device)])
                for a, f in zip(arrs, fill)]
    key = (tuple(mesh.shape.values()), int(num_nodes), e + pad, bp)
    with _telemetry.observe("sharded_sssp", key, span="spf:sharded_solve"):
        out = sharded_sssp(*arrs, roots, mesh, num_nodes, stats=stats)
    return out if bp == b else out.cut(1, b)

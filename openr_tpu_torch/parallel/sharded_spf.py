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
contiguous edge slice g, whose `edge_relax.EdgeIndex` is built on its
device per call (`edge_relax.device_edge_index`). The init is kernel H's
init on each slice (`edge_relax.edge_init`), then a MIN over the graph
row; a round is kernel H capped at one round on each slice
(`edge_relax.edge_round`, which keeps the min with the distances), then
a MIN over the graph row.

Positions that share a device share one copy of the distances of their
graph row: a gather between them is nothing, and a MIN is taken as their
rounds are. Between devices of one process the exchanges are copies;
between processes (a mesh from `distributed.global_mesh`) they are
`torch.distributed` collectives on the graph row's own group: an
`all_gather` of the rows each process relaxed, an `all_reduce` MIN.

The loops run on the devices, as the reference's `while_loop` inside
`shard_map` does (`openr_tpu/parallel/sharded_spf.py:95,180`). Each graph
row keeps a control block on each of its devices (`ops/split_loop.py`'s
layout, in phase NET until the exit), and every launch of a sweep or
round reads its phase: kernel A and kernel H under their guards, then
the row's exit (`split_loop.row_exit`: did an entry fall below the
sweep's start, the reference's cap of sweeps, and for the split solve
the next sweep's snapshot in the same pass). The host launches a block
of `BLOCK` sweeps or rounds back to back for every row not yet done and
reads the control blocks of all its rows once a block
(`compile_ledger.record_sync`), as `SplitProgram` does. Nothing in the
loop reads the device otherwise: a capture's sink is paused while it
runs, and each row's work is counted after it from the sweeps or rounds
its control block ran. After the
exchange every position of a graph row holds the same distances, so
every device and process of the row reaches the same exit with no
collective of its own: every process runs the same blocks, each with the
same exchanges, and a row that is done still takes part in its block's
remaining exchanges, which move unchanged rows.

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
from openr_tpu_torch.ops import edge_relax, relax, split_loop
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
#: sweeps or rounds a block: the host reads the control blocks once per
#: block. At BASELINE config 3 on an H100 (PERF.md, PR 15) the host's
#: enqueue of a sweep (~0.6 ms on a 4x2 mesh) is close to its device
#: time, so each no-op sweep past a row's exit costs about that much:
#: K 1, 2 and 4 gave the split call one p50, K 8 to 32 2-7 ms more
BLOCK = 4
#: the guard of every launch of a sweep or round: the loop's one phase
LOOP = 1 << split_loop.NET


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
        self._parts = None
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
        if self._parts is None:  # the exchange's buffers, once a call
            k = max(len(gs) for gs in by_rank.values())
            mine = buf.new_empty((k * rows, buf.shape[1]))
            self._parts = (mine, [torch.empty_like(mine) for _ in by_rank])
        mine, got = self._parts
        for j, g in enumerate(self.local):
            mine[j * rows:(j + 1) * rows] = buf[g * rows:(g + 1) * rows]
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


def _read_ctls(ctls: list[list]) -> list[list[int]]:
    """The control blocks of the rows (a list of each row's blocks, one a
    device), read back in one sync; each row's blocks must agree."""
    flat = [c for row in ctls for c in row]
    dev = flat[0].device
    vals = torch.stack([c.to(dev) for c in flat]).tolist()
    compile_ledger.record_sync()
    out, i = [], 0
    for row in ctls:
        got = vals[i:i + len(row)]
        i += len(row)
        if any(g != got[0] for g in got):
            raise RuntimeError(
                f"a graph row's control blocks disagree across its devices: "
                f"{got}")
        out.append(got[0])
    return out


def _run_blocks(ctls: list[list], step) -> tuple[list, int]:
    """Runs `step(i)` (one sweep or round of row i, guarded on the
    device) `BLOCK` times back to back for every row not yet done, then
    reads every row's control blocks, until every row is done (the exit
    caps each row's sweeps). The capture's sink, if any, is paused
    meanwhile: a wrapper that counts its work reads the phase, a device
    sync a launch. Returns (each row's last control block read, blocks
    run)."""
    if BLOCK < 1:
        raise ValueError(f"BLOCK={BLOCK} must be at least 1")
    live = list(range(len(ctls)))
    last: list = [None] * len(ctls)
    replays = 0
    with _telemetry.paused():
        while live:
            for _ in range(BLOCK):
                for i in live:
                    step(i)
            replays += 1
            for i, c in zip(live, _read_ctls([ctls[i] for i in live])):
                last[i] = c
            live = [i for i in live if last[i][split_loop.PHASE]
                    != split_loop.DONE]
    return last, replays


def _count_trips(sink, work: list, last: list) -> None:
    """Adds to `sink` each row's work a live sweep or round (`work[i]`,
    (source, bytes, operations) a launch) once for each one its control
    block ran (`last[i][IT]`)."""
    if sink is None:
        return
    for launches, c in zip(work, last):
        for _ in range(c[split_loop.IT]):
            for source, nbytes, ops in launches:
                sink.add(source, nbytes, ops)


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
    (graph, None), (), (), (), (), (), (sources,). The host reads the
    rows' control blocks once per `BLOCK` sweeps. With
    `stats`, sets sweeps (the most any graph row ran), row_trips (each
    row's sweeps, in the order of the rows this process drives), replays
    (blocks run), host_syncs (= replays) and block (`BLOCK`)."""
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

    # per graph row: (row, per device {dist, snap, ctl, overflow args},
    # per local position its own rows' args)
    work = []
    for row in _rows(mesh):
        s = row.s
        per, own = {}, {}
        for d in row.devices:
            g0 = next(g for g in row.local if mesh.device(s, g) == d)
            r = rts.pieces[(s, g0)].to(torch.int32)
            dist = torch.full((vp, bs), INF_DIST, dtype=torch.int32,
                              device=d)
            dist[r.long(), torch.arange(bs, device=d)] = 0
            ovn = ov["nbr"].pieces[(s, g0)]
            over = ov["over"].pieces[(s, g0)]
            per[d] = dict(
                dist=dist, snap=dist.clone(),
                ctl=split_loop.new_ctl(split_loop.NET, 0, 0, vp, d),
                ov=(r, ov["ids"].pieces[(s, g0)], ovn,
                    ov["wgt"].pieces[(s, g0)],
                    over[ovn.long()].contiguous() if has_overloads
                    else None))
        for g in row.local:
            d = mesh.device(s, g)
            n_g = nbr.pieces[(s, g)]
            over = ov["over"].pieces[(s, g)]
            own[g] = (d, n_g, wgt.pieces[(s, g)],
                      over[n_g.long()].contiguous() if has_overloads
                      else None,
                      torch.arange(g * rows, (g + 1) * rows,
                                   dtype=torch.int32, device=d))
        work.append((row, per, own))

    def sweep(i: int) -> None:
        """One sweep of row i, every launch guarded: own rows in place,
        the gather, the overflow rows from the snapshot, the exit (which
        takes the next snapshot)."""
        row, per, own = work[i]
        for g in row.local:
            d, n_g, w_g, o_g, dst = own[g]
            p = per[d]
            relax.relax_rows(p["dist"], p["dist"], n_g, w_g, p["ov"][0],
                             o_g, n=rows, dst_rows=dst, ctl=p["ctl"],
                             phase_mask=LOOP)
        row.gather_rows({d: p["dist"] for d, p in per.items()}, rows)
        for p in per.values():
            r, ids, ovn, ovw, ovo = p["ov"]
            relax.relax_rows(p["snap"], p["dist"], ovn, ovw, r, ovo,
                             dst_rows=ids, ctl=p["ctl"], phase_mask=LOOP)
            split_loop.row_exit(p["dist"], p["snap"], p["ctl"], LOOP,
                                copy=True)

    sink = _telemetry.sink()
    sweep_work = None
    if sink is not None:  # a live sweep's launches, counted after the loop
        sweep_work = [_sweep_work(row, per, own, rows) for row, per, own
                      in work]
    last, replays = _run_blocks(
        [[p["ctl"] for p in per.values()] for _r, per, _o in work], sweep)
    _count_trips(sink, sweep_work, last)
    if stats is not None:
        stats["row_trips"] = [c[split_loop.IT] for c in last]
        stats["sweeps"] = max(stats["row_trips"], default=0)
        stats["replays"] = stats["host_syncs"] = replays
        stats["block"] = BLOCK
    return _out(mesh, (vp, b), {(row.s, d): p["dist"]
                                for row, per, _o in work
                                for d, p in per.items()})


def _sweep_work(row: _GraphRow, per: dict, own: dict, rows: int) -> list:
    """(source, bytes, operations) of each launch of a live sweep of
    `row`: kernel A on each local position's own rows, then on each
    device the overflow relax and the exit."""
    out = []
    for g in row.local:
        d, n_g, w_g, o_g, dst = own[g]
        out.append(("relax", *relax.launch_work(
            n_g, w_g, per[d]["dist"].shape[1], over=o_g, n=rows,
            dst_rows=dst)[1:3]))
    for p in per.values():
        _r, ids, ovn, ovw, ovo = p["ov"]
        out.append(("relax", *relax.launch_work(
            ovn, ovw, p["dist"].shape[1], over=ovo, dst_rows=ids)[1:3]))
        out.append(("split_loop",
                    *split_loop.exit_work(p["dist"].numel(), True)))
    return out


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
    `edge_relax.EdgeIndex` is built on its device per call, with one host
    read a slice. The host reads the rows' control blocks once per
    `BLOCK` rounds. With `stats`, sets rounds (the most any graph row
    ran), row_trips (each row's rounds), replays (blocks run), host_syncs
    (= replays), block (`BLOCK`) and index_ms (the host wall of the index
    builds, each up to its read)."""
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
            slices[(d, g)] = (src, dst, met, blk.to(torch.bool).contiguous(),
                              edge_relax.device_edge_index(src, dst, met, v))
    index_ms = (time.perf_counter() - t0) * 1e3

    # per graph row, per device: the two buffers rounds alternate (the
    # init into the first), a buffer for each further slice there, each
    # slice's scratch, the control block; the rows' work a round
    work = []
    for row in _rows(mesh):
        s = row.s
        per = {}
        for d in row.devices:
            g0 = next(g for g in row.local if mesh.device(s, g) == d)
            rq = _pad_roots(rts.pieces[(s, g0)].to(torch.int32))
            mine = [g for g in row.local if mesh.device(s, g) == d]
            bufs = [torch.empty((v, rq.shape[0]), dtype=torch.int32,
                                device=d) for _ in range(2)]
            extra = [torch.empty_like(bufs[0]) for _ in mine[1:]]
            for g, t in zip(mine, [bufs[0]] + extra):
                src, dst, met, _blk, index = slices[(d, g)]
                edge_relax.edge_init(t, src, dst, met, rq, index)
                if sink is not None:
                    sink.add("edge_relax", *edge_relax.init_work(
                        index, v, rq.shape[0],
                        edge_relax.tile_cols(rq.shape[0]), rq))
            for t in extra:
                torch.minimum(bufs[0], t, out=bufs[0])
            per[d] = dict(bufs=bufs, extra=extra, slices=mine,
                          scratch=[edge_relax.fix_scratch(v, d)
                                   for _ in mine],
                          ctl=split_loop.new_ctl(split_loop.NET, 0, 0, v, d))
        row.all_min({d: p["bufs"][0] for d, p in per.items()})
        round_work = None
        if sink is not None:  # a live round's launches, counted after
            round_work = [("edge_relax", *edge_relax.round_work(
                slices[(d, g)][0], slices[(d, g)][3], slices[(d, g)][4], v,
                p["bufs"][0].shape[1])[:2])
                for d, p in per.items() for g in p["slices"]] + [
                ("split_loop", *split_loop.exit_work(p["bufs"][0].numel(),
                                                     False))
                for p in per.values()]
        work.append([row, per, 0, round_work])

    def one_round(i: int) -> None:
        """One round of row i, every launch guarded: kernel H on each
        slice from buffer r % 2 into buffer (r + 1) % 2 (the device's
        first slice) or its own buffer, the MIN on the device and over
        the row, the exit. A round after the exit writes neither kernel
        H's output nor the control block, and the MINs then leave the
        result's buffer as it is (each slice buffer is at least the
        result), so the result is buffer ctl[IT] % 2: the parity of the
        last live round."""
        row, per, r, _w = work[i]
        for d, p in per.items():
            cur, nxt = p["bufs"][r % 2], p["bufs"][(r + 1) % 2]
            for g, out, scr in zip(p["slices"], [nxt] + p["extra"],
                                   p["scratch"]):
                src, dst, met, blk, index = slices[(d, g)]
                edge_relax.edge_round(cur, out, src, dst, met, blk,
                                      index.row_start, None, index=index,
                                      ctl=p["ctl"], phase_mask=LOOP,
                                      scratch=scr)
            for t in p["extra"]:
                torch.minimum(nxt, t, out=nxt)
        row.all_min({d: p["bufs"][(r + 1) % 2] for d, p in per.items()})
        for p in per.values():
            split_loop.row_exit(p["bufs"][(r + 1) % 2], p["bufs"][r % 2],
                                p["ctl"], LOOP, copy=False)
        work[i][2] = r + 1

    last, replays = _run_blocks(
        [[p["ctl"] for p in per.values()] for _r, per, _n, _w in work],
        one_round)
    _count_trips(sink, [w for *_x, w in work], last)
    if stats is not None:
        stats["row_trips"] = [c[split_loop.IT] for c in last]
        stats["rounds"] = max(stats["row_trips"], default=0)
        stats["replays"] = stats["host_syncs"] = replays
        stats["block"] = BLOCK
        stats["index_ms"] = index_ms
    return _out(mesh, (v, b), {
        (row.s, d): _cut(p["bufs"][c[split_loop.IT] % 2], bs)
        for (row, per, _n, _w), c in zip(work, last)
        for d, p in per.items()})


def _cut(t: torch.Tensor, bs: int) -> torch.Tensor:
    """The first `bs` columns (the padded roots cut off)."""
    return t[:, :bs] if t.shape[1] != bs else t


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
    `sharded_sssp` cost row under the span `spf:sharded_solve`. `stats`
    is `sharded_sssp`'s."""
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

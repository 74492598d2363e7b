"""Split-width dense relaxation with a compacted tail: the cold
single-root RIB solve and its warm start after a metric-only delta
(port of `openr_tpu/ops/spf_split.py`).

Host builders (`tight_nodes`, `pick_base_width`, `build_split_tables`,
`pick_gs_chunks`) are NumPy copies of the JAX package's. The solve keeps
its three phases and their knobs:

  1. dense sweeps, Gauss-Seidel chunked, while more than
     `tail_threshold` rows changed;
  2. compacted tail rounds: expand the changed rows through the
     out-neighbor table, dedupe by sort, relax only those rows; a spill
     flag fires when `tail_cap` would truncate a list;
  3. the exactness net: dense sweeps to fixpoint if the tail spilled or
     hit `tail_rounds_cap` with work left.

The warm solve (`batched_sssp_split_warm_rib`) starts from the previous
distances instead, skips phase 1 and runs phases 2-3 from a seed set.

Every relax is the hand-written kernel of `ops/relax.py` (the plain
version when the tensors lie on the CPU), and the kernel's row flags
are the change detection: the rows a sweep or tail round lowered and
their count. Loop conditions read one scalar back to the host per sweep
or tail round (`.item()`); the count is reported in
`stats["host_syncs"]`.

Any update order reaches the same fixpoint of the monotone min system,
so distances equal the JAX package's bit for bit even where the kernel's
in-place chunk updates converge in a different number of sweeps.
"""

from __future__ import annotations

import numpy as np
import torch

from openr_tpu_torch.common import constants as _C
from openr_tpu_torch.ops import relax
from openr_tpu_torch.ops.spf import first_hop_matrix, lfa_matrix

INF_DIST = _C.DIST_INF
DIST_DTYPE = torch.int32


def tight_nodes(n: int, step: int = 512) -> int:
    """Node padding: the next multiple of `step` STRICTLY greater than n
    (slot vp-1 is always dead), quantized up to the grid
    {m * 2^k : 8 <= m < 16}. 100_000 -> 106_496."""
    v = (n // step + 1) * step
    g = 1 << max(v.bit_length() - 4, 0)
    return -(-v // g) * g


def _pow2(n: int, minimum: int = 8) -> int:
    cap = minimum
    while cap < n:
        cap <<= 1
    return cap


def pick_base_width(indeg: np.ndarray, minimum: int = 8) -> int:
    """Power-of-two W minimizing rows gathered per sweep, counting the
    overflow table at its padded size."""
    vmax = int(indeg.max()) if indeg.size else 1
    best_w, best_rows = minimum, None
    w = minimum
    while True:
        n_over = int((indeg > w).sum())
        ov_rows = _pow2(n_over) * _pow2(vmax - w) if n_over else 0
        rows = indeg.shape[0] * w + ov_rows
        if best_rows is None or rows < best_rows:
            best_rows, best_w = rows, w
        if w >= vmax:
            break
        w <<= 1
    return best_w


def build_split_tables(
    edge_src: np.ndarray,
    edge_dst: np.ndarray,
    edge_metric: np.ndarray,
    num_nodes: int,
    base_width: int | None = None,
) -> dict:
    """Split in-neighbor tables plus the out-neighbor table: vp,
    base_nbr/base_wgt [vp,W], ov_ids [Go], ov_nbr/ov_wgt [Go,Wo],
    ov_pos [vp], out_nbr [vp,Wout], uniform_metric."""
    valid = edge_metric < INF_DIST
    src = edge_src[valid].astype(np.int64)
    dst = edge_dst[valid].astype(np.int64)
    met = edge_metric[valid].astype(np.int32)
    uniform = int(met[0]) if met.size and (met == met[0]).all() else 0
    vp = tight_nodes(num_nodes)
    dead = vp - 1
    e = src.shape[0]

    indeg = np.bincount(dst, minlength=vp)
    w = base_width or pick_base_width(indeg)
    row_start = np.zeros(vp + 1, dtype=np.int64)
    np.add.at(row_start, dst + 1, 1)
    row_start = np.cumsum(row_start)
    col = np.arange(e, dtype=np.int64) - row_start[dst]

    base_nbr = np.zeros((vp, w), dtype=np.int32)
    base_wgt = np.full((vp, w), INF_DIST, dtype=np.int32)
    in_base = col < w
    base_nbr[dst[in_base], col[in_base]] = src[in_base].astype(np.int32)
    base_wgt[dst[in_base], col[in_base]] = met[in_base]

    ov_rows = np.nonzero(indeg > w)[0]
    go = _pow2(max(len(ov_rows), 1))
    max_over = int(indeg.max()) - w if indeg.size and int(indeg.max()) > w else 1
    wo = _pow2(max_over)
    ov_ids = np.full(go, dead, dtype=np.int32)
    ov_ids[: len(ov_rows)] = ov_rows.astype(np.int32)
    ov_nbr = np.zeros((go, wo), dtype=np.int32)
    ov_wgt = np.full((go, wo), INF_DIST, dtype=np.int32)
    ov_pos = np.full(vp, -1, dtype=np.int32)
    ov_pos[ov_rows] = np.arange(len(ov_rows), dtype=np.int32)
    in_ov = ~in_base
    if in_ov.any():
        ov_nbr[ov_pos[dst[in_ov]], col[in_ov] - w] = src[in_ov].astype(
            np.int32
        )
        ov_wgt[ov_pos[dst[in_ov]], col[in_ov] - w] = met[in_ov]

    outdeg = np.bincount(src, minlength=vp)
    wout = _pow2(int(outdeg.max()) if e else 1)
    order = np.argsort(src, kind="stable")
    srow = np.zeros(vp + 1, dtype=np.int64)
    np.add.at(srow, src + 1, 1)
    srow = np.cumsum(srow)
    ocol = np.arange(e, dtype=np.int64) - srow[src[order]]
    out_nbr = np.full((vp, wout), dead, dtype=np.int32)
    out_nbr[src[order], ocol] = dst[order].astype(np.int32)

    return {
        "vp": vp,
        "base_nbr": base_nbr,
        "base_wgt": base_wgt,
        "ov_ids": ov_ids,
        "ov_nbr": ov_nbr,
        "ov_wgt": ov_wgt,
        "ov_pos": ov_pos,
        "out_nbr": out_nbr,
        "uniform_metric": uniform,
    }


GS_CHUNKS = 4
GS_MIN_VP = 8192


def pick_gs_chunks(vp: int) -> int:
    """Gauss-Seidel block count for dense sweeps: the largest
    gs <= GS_CHUNKS splitting vp into equal 8-row-aligned chunks; 1 below
    GS_MIN_VP."""
    if vp < GS_MIN_VP:
        return 1
    for gs in range(GS_CHUNKS, 1, -1):
        if vp % gs == 0 and (vp // gs) % 8 == 0:
            return gs
    return 1


def _compact_ids(mask_ids, vp: int, cap: int, dead: int):
    """Sort-compact: ids < vp first, padded with `dead`, exactly `cap`
    long (int32). `mask_ids` holds the id where active, >= vp where not."""
    flat = mask_ids.reshape(-1)
    if flat.shape[0] < cap:
        flat = torch.cat(
            [flat, torch.full((cap - flat.shape[0],), vp, dtype=flat.dtype,
                              device=flat.device)]
        )
    ids = torch.sort(flat).values[:cap]
    return torch.where(ids < vp, ids, dead).to(torch.int32)


def _first_of_runs(srt, keep):
    """Mask of the first element of each run of equal values in a sorted
    1-D tensor, and'ed with `keep`."""
    first = torch.ones_like(srt, dtype=torch.bool)
    first[1:] = srt[1:] != srt[:-1]
    return first & keep


def _make_dense_sweep(tables, over_base, over_ov, roots, gs, flags):
    """Dense relax sweep over base + overflow tables, in place.

    With gs > 1 the base rows go in `gs` contiguous chunks, each reading
    the dist the earlier chunks updated; the overflow rows always read
    the pre-sweep dist, as `_make_dense_sweep` of the JAX package does.
    Returns `sweep(dist)`: it clears `flags` (int32 [vp + 1]) and leaves
    in `flags[:vp]` the rows the sweep lowered and in `flags[vp]` their
    count."""
    base_nbr, base_wgt = tables["base_nbr"], tables["base_wgt"]
    ov_ids, ov_nbr, ov_wgt = (
        tables["ov_ids"], tables["ov_nbr"], tables["ov_wgt"]
    )
    vp = base_nbr.shape[0]
    csz = vp // gs
    fl = dict(row_flag=flags[:vp], rows_changed=flags[vp:])

    def dense_sweep(dist):
        prev = dist.clone()
        src = prev if gs == 1 else dist
        flags.zero_()
        for c in range(gs):
            relax.relax_rows(
                src, dist, base_nbr, base_wgt, roots, over_base,
                row0=c * csz, n=csz, **fl,
            )
        relax.relax_rows(
            prev, dist, ov_nbr, ov_wgt, roots, over_ov, dst_rows=ov_ids, **fl
        )

    return dense_sweep


def _make_tail_relax(tables, over_base, over_ov, roots, flags):
    """One compacted tail round's relax: the listed base rows and every
    overflow row, all reading the pre-round dist (Jacobi), in place.
    Returns `tail_relax(dist, rows)`, which clears `flags` and leaves the
    rows it lowered and their count there, as `dense_sweep` does."""
    base_nbr, base_wgt = tables["base_nbr"], tables["base_wgt"]
    ov_ids, ov_nbr, ov_wgt = (
        tables["ov_ids"], tables["ov_nbr"], tables["ov_wgt"]
    )
    vp = base_nbr.shape[0]
    fl = dict(row_flag=flags[:vp], rows_changed=flags[vp:])

    def tail_relax(dist, rows):
        snap = dist.clone()
        flags.zero_()
        relax.relax_rows(
            snap, dist, base_nbr, base_wgt, roots, over_base,
            src_rows=rows, dst_rows=rows, **fl,
        )
        # overflow in-edges: the ov tables are tiny — relax them all
        relax.relax_rows(
            snap, dist, ov_nbr, ov_wgt, roots, over_ov, dst_rows=ov_ids, **fl
        )

    return tail_relax


class _Solve:
    """What the cold and the warm solve share: the overload masks, the
    Gauss-Seidel chunk count, the flag buffer (`row_flag` [vp] and
    `rows_changed` [1] in one int32 [vp + 1] tensor), the dense sweep
    and the tail relax, and the loop counters `st`."""

    def __init__(self, tables, roots, has_overloads, gs_chunks):
        base_nbr = tables["base_nbr"]
        self.out_nbr, self.ov_ids = tables["out_nbr"], tables["ov_ids"]
        self.dev = base_nbr.device
        self.vp = vp = base_nbr.shape[0]
        self.dead = vp - 1
        self.iota = torch.arange(vp, dtype=torch.int32, device=self.dev)
        self.st = {"sweeps": 0, "tail_rounds": 0, "spilled": False,
                   "host_syncs": 0}
        if has_overloads:
            over = tables["over"]
            over_base = over[base_nbr.long()].contiguous()
            over_ov = over[tables["ov_nbr"].long()].contiguous()
        else:
            over_base = over_ov = None
        gs = gs_chunks if gs_chunks is not None else pick_gs_chunks(vp)
        if vp % gs:  # explicit override that doesn't divide: no chunking
            gs = 1
        # Change detection comes from the kernel: every sweep or tail
        # round clears `flags` once and each of its launches sets
        # row_flag[t] for the rows it lowered and counts them in
        # rows_changed — the JAX package's `(new < dist).any(axis=1)` and
        # its sum.
        self.flags = torch.zeros(vp + 1, dtype=torch.int32, device=self.dev)
        self.row_flag = self.flags[:vp]
        self.rows_changed = self.flags[vp:]
        self.dense_sweep = _make_dense_sweep(
            tables, over_base, over_ov, roots, gs, self.flags
        )
        self.tail_relax = _make_tail_relax(
            tables, over_base, over_ov, roots, self.flags
        )

    def compact(self, mask, cap):
        """The ids where `mask` [vp] holds, sorted, dead-padded to `cap`."""
        return _compact_ids(torch.where(mask, self.iota, self.vp), self.vp,
                            cap, self.dead)

    def tail(self, dist, frontier, spilled, tail_cap, tail_rounds_cap,
             with_frontier):
        """Compacted tail rounds from `frontier` until it empties, spills
        or hits the round cap. Each round relaxes the sorted, deduplicated
        out-neighbors of the frontier (and, `with_frontier`, the frontier
        itself) plus every overflow row; the rows it lowered are the next
        frontier. `spilled` may be a device bool, read back with the
        frontier's head in one sync. Returns (pending, spilled)."""
        vp, dead, st = self.vp, self.dead, self.st
        out_nbr, ov_ids, row_flag = self.out_nbr, self.ov_ids, self.row_flag
        if torch.is_tensor(spilled):
            head, sp = torch.stack(
                [frontier[0].to(torch.int64), spilled.to(torch.int64)]
            ).tolist()
            spilled = bool(sp)
        else:
            head = int(frontier[0].item())
        pending = head != dead
        st["host_syncs"] += 1
        it = 0
        while pending and not spilled and it < tail_rounds_cap:
            exp = out_nbr[frontier.long()].reshape(-1)
            if with_frontier:
                exp = torch.cat([exp, frontier])
            exp = torch.sort(exp).values
            first = _first_of_runs(exp, exp != dead)
            spill_dev = first.sum() > tail_cap
            rows = _compact_ids(torch.where(first, exp, vp), vp, tail_cap,
                                dead)
            self.tail_relax(dist, rows)
            changed_rows = row_flag[rows.long()] != 0
            ov_changed = row_flag[ov_ids.long()] != 0
            both = torch.cat(
                [torch.where(changed_rows, rows, vp),
                 torch.where(ov_changed, ov_ids, vp)]
            )
            srt = torch.sort(both).values
            firstb = _first_of_runs(srt, srt < vp)
            # a truncated next frontier would drop pending updates: spill
            spill_dev = spill_dev | (firstb.sum() > tail_cap)
            frontier = _compact_ids(torch.where(firstb, srt, vp), vp,
                                    tail_cap, dead)
            head, sp = torch.stack(
                [frontier[0].to(torch.int64), spill_dev.to(torch.int64)]
            ).tolist()
            st["host_syncs"] += 1
            st["tail_rounds"] += 1
            pending, spilled = head != dead, bool(sp)
            it += 1
        st["spilled"] = bool(spilled)
        return pending, spilled

    def net(self, dist, changed):
        """The exactness net: dense sweeps to fixpoint while `changed`."""
        it = 0
        while changed and it < self.vp:
            self.dense_sweep(dist)
            changed = int(self.rows_changed.item()) > 0
            self.st["host_syncs"] += 1
            self.st["sweeps"] += 1
            it += 1


def batched_sssp_split(
    tables: dict,
    roots,
    has_overloads: bool = False,
    tail_threshold: int = 1024,
    tail_cap: int = 8192,
    tail_rounds_cap: int = 64,
    gs_chunks: int | None = None,
    stats: dict | None = None,
):
    """Distances [vp, B] int32 from each root.

    `tables` is the device table set of `convert.split_tables_from_numpy`
    (base_nbr, base_wgt, ov_ids, ov_nbr, ov_wgt, out_nbr, over). If
    `stats` is given it is filled with sweeps, tail_rounds, spilled and
    host_syncs."""
    sv = _Solve(tables, roots, has_overloads, gs_chunks)
    vp, b, st = sv.vp, roots.shape[0], sv.st
    dist = torch.full((vp, b), INF_DIST, dtype=DIST_DTYPE, device=sv.dev)
    dist[roots.long(), torch.arange(b, device=sv.dev)] = 0

    # ---- phase 1: dense sweeps while the changed set is large ----------
    sv.row_flag[roots.long()] = 1  # the entry set before any sweep
    n_changed = tail_threshold + 1
    it = 0
    while n_changed > tail_threshold and it < vp:
        sv.dense_sweep(dist)
        n_changed = int(sv.rows_changed.item())
        st["host_syncs"] += 1
        st["sweeps"] += 1
        it += 1

    # ---- phase 2: compacted tail --------------------------------------
    frontier = sv.compact(sv.row_flag != 0, tail_cap)
    # the entry set itself may not fit
    pending, spilled = sv.tail(dist, frontier, n_changed > tail_cap,
                               tail_cap, tail_rounds_cap, False)

    # ---- phase 3: exactness net — dense to fixpoint if the tail bailed
    sv.net(dist, spilled or pending)
    if stats is not None:
        stats.update(st)
    return dist


def packbits_rows(bits):
    """MSB-first packbits along the last axis of a bool [R, V] tensor
    (V a multiple of 8): the layout of `jnp.packbits(..., axis=1)` and
    the inverse of `np.unpackbits` with its default bit order."""
    r, v = bits.shape
    weights = torch.tensor(
        [128, 64, 32, 16, 8, 4, 2, 1], dtype=torch.uint8, device=bits.device
    )
    return (bits.reshape(r, v // 8, 8).to(torch.uint8) * weights).sum(
        dim=2, dtype=torch.uint8
    )


def batched_sssp_split_rib(
    tables: dict,
    roots,          # [B]: col 0 = the RIB root, 1.. = neighbors
    nbr_metric,     # [B-1] i32 metric(root -> neighbor i)
    nbr_ids,        # [B-1] i32 (padding -> dead slot)
    nbr_over,       # [B-1] bool (padding -> True)
    my_id: int,     # the root's node id (LFA only)
    has_overloads: bool = False,
    with_lfa: bool = False,
    tail_threshold: int = 1024,
    tail_cap: int = 8192,
    tail_rounds_cap: int = 64,
    gs_chunks: int | None = None,
    stats: dict | None = None,
):
    """Distances plus the host-bound outputs packed into one uint8
    buffer, the layout `unpack_rib_buffer` decodes:

        buf = [ d_root as 4·vp bytes | packbits(fh) | packbits(lfa)? ]
    """
    dist = batched_sssp_split(
        tables, roots,
        has_overloads=has_overloads,
        tail_threshold=tail_threshold,
        tail_cap=tail_cap,
        tail_rounds_cap=tail_rounds_cap,
        gs_chunks=gs_chunks,
        stats=stats,
    )
    return dist, _rib_buffer(dist, nbr_metric, nbr_ids, nbr_over, my_id,
                             with_lfa)


def _rib_buffer(dist, nbr_metric, nbr_ids, nbr_over, my_id, with_lfa):
    """The packed buffer `unpack_rib_buffer` decodes, from the solved
    distances."""
    fh = first_hop_matrix(dist, nbr_metric, nbr_ids, nbr_over)
    parts = [
        dist[:, 0].contiguous().view(torch.uint8),
        packbits_rows(fh).reshape(-1),
    ]
    if with_lfa:
        lfa = lfa_matrix(dist, my_id, nbr_ids, nbr_over)
        parts.append(packbits_rows(lfa).reshape(-1))
    return torch.cat(parts)


def batched_sssp_split_warm_rib(
    tables: dict,
    roots,          # [B]: col 0 = the RIB root, 1.. = neighbors
    nbr_metric,     # [B-1] i32 metric(root -> neighbor i)
    nbr_ids,        # [B-1] i32 (padding -> dead slot)
    nbr_over,       # [B-1] bool (padding -> True)
    dist0,          # [vp, B] i32 warm start, relaxed IN PLACE
    seed_mask,      # [vp] bool: nodes whose distance may change
    has_overloads: bool = False,
    tail_cap: int = 8192,
    tail_rounds_cap: int = 64,
    gs_chunks: int | None = None,
    stats: dict | None = None,
):
    """The warm-start solve after a bounded metric-only delta: same
    fixpoint and packed buffer (without LFA) as `batched_sssp_split_rib`,
    seeded from the previous solve.

    `dist0` must be an entry-wise upper bound of the new distances with
    0 at each root: the previous distance matrix with the raised edges'
    increase cones set to INF. `seed_mask` is the cones plus the heads of
    lowered edges. Tail rounds start from the seeds and relax the
    frontier itself with its out-neighbors (cone rows must re-pull from
    their unchanged in-neighbors); the dense net restores exactness if
    the tail spills (already at entry when the seeds exceed `tail_cap`)
    or hits its round cap. `dist0` is overwritten with the result and
    returned as the distances, with the packed buffer: the caller owns
    it, and must pass a copy where the old matrix is still read.
    `stats` gets sweeps, tail_rounds, spilled and host_syncs."""
    sv = _Solve(tables, roots, has_overloads, gs_chunks)
    dist = dist0
    frontier = sv.compact(seed_mask, tail_cap)
    pending, spilled = sv.tail(dist, frontier, seed_mask.sum() > tail_cap,
                               tail_cap, tail_rounds_cap, True)
    sv.net(dist, spilled or pending)
    if stats is not None:
        stats.update(sv.st)
    return dist, _rib_buffer(dist, nbr_metric, nbr_ids, nbr_over, 0, False)


_BYTE_ORDER_OK: dict[str, bool] = {}


def check_byte_order(device) -> None:
    """Once per device type: prove that the device's int32 -> uint8 view
    round-trips through the host's np.view(np.int32) — the packed
    buffer's layout depends on it."""
    key = torch.device(device).type
    if key not in _BYTE_ORDER_OK:
        probe = np.array([1, -2, 1 << 30, -(1 << 21)], np.int32)
        got = (
            torch.from_numpy(probe).to(device).view(torch.uint8).cpu()
            .numpy().view(np.int32)
        )
        _BYTE_ORDER_OK[key] = bool((got == probe).all())
    if not _BYTE_ORDER_OK[key]:
        raise RuntimeError(
            "device int32->uint8 byte order does not round-trip through "
            "np.view(int32) on this host: the packed RIB buffer layout "
            "is unusable here"
        )


def unpack_rib_buffer(
    buf: np.ndarray, vp: int, b: int, with_lfa: bool
) -> tuple[np.ndarray, np.ndarray, np.ndarray | None]:
    """Decode the packed buffer:

        [ d_root: vp int32 as 4·vp bytes
        | fh:     (b-1) rows × vp/8 packbits bytes
        | lfa:    (b-1) rows × vp/8 packbits bytes, iff with_lfa ]

    Returns (d_root int32 [vp], fh bool [b-1, vp], lfa or None)."""
    row = vp // 8

    def unpack(off: int) -> np.ndarray:
        return np.unpackbits(
            buf[off : off + (b - 1) * row].reshape(b - 1, row), axis=1
        ).view(bool)

    d_root = buf[: vp * 4].view(np.int32)
    fh = unpack(vp * 4)
    lfa = unpack(vp * 4 + (b - 1) * row) if with_lfa else None
    return d_root, fh, lfa

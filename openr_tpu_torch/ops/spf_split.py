"""Split-width dense relaxation with a compacted tail: the cold
single-root RIB solve and its warm start after a metric-only delta
(port of `openr_tpu/ops/spf_split.py`).

Host builders (`tight_nodes`, `pick_base_width`, `build_split_tables`,
`pick_gs_chunks`) are NumPy copies of the JAX package's. The solve keeps
its three phases and their knobs:

  1. dense sweeps, Gauss-Seidel chunked, while more than
     `tail_threshold` rows changed;
  2. compacted tail rounds: relax only the out-neighbors of the rows the
     last round lowered; a spill flag fires when `tail_cap` would
     truncate a list;
  3. the exactness net: dense sweeps to fixpoint if the tail spilled or
     hit `tail_rounds_cap` with work left.

The warm solve (`batched_sssp_split_warm_rib`) starts from the previous
distances instead, skips phase 1 and runs phases 2-3 from a seed set.

The loop runs on the device, as the JAX package's `while_loop`s do: a
`SplitProgram` keeps its state in a control block that every launch
reads (`ops/split_loop.py`), so a fixed block of steps runs whichever
phase the solve is in and the host reads the state once per block; on
CUDA a kept program replays the block as a CUDA graph. Every relax is
the hand-written kernel of `ops/relax.py`, and the kernel's row flags
are the change detection; the tail's lists are stream compactions of
flag arrays in index order (`flag_compact_kernel`), the sorted,
deduplicated lists of the JAX package's `_compact_ids` without a sort.
The RIB epilogue is one kernel, `ops/rib_epilogue.py`. On the CPU every
launch runs its plain twin. The reads are counted in
`stats["host_syncs"]` and in the ledger's `cuda.transfers.host_syncs`
(`monitor/compile_ledger.py`).

Any update order reaches the same fixpoint of the monotone min system,
so distances equal the JAX package's bit for bit even where the kernel's
in-place chunk updates converge in a different number of sweeps.
"""

from __future__ import annotations

import numpy as np
import torch

from openr_tpu_torch.common import constants as _C
from openr_tpu_torch.monitor import compile_ledger
from openr_tpu_torch.monitor import device as _telemetry
from openr_tpu_torch.ops import relax, rib_epilogue, split_loop
from openr_tpu_torch.ops.rib_epilogue import packbits_rows  # noqa: F401

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


def _over_masks(tables, has_overloads):
    """The overload masks of the base and overflow tables' slots, or
    None twice without overloads."""
    if not has_overloads:
        return None, None
    over = tables["over"]
    return (over[tables["base_nbr"].long()].contiguous(),
            over[tables["ov_nbr"].long()].contiguous())


class _Relaxes:
    """The split solve's three kinds of relax launch on kernel A, each
    min-scattering into `dist` and flagging the rows it lowered in
    `row_flag` (counted in `rows_changed`): the dense base table in `gs`
    Gauss-Seidel chunks (reading `dist` itself, or `prev` where gs is 1),
    a tail round's listed rows and the whole overflow table (both reading
    `prev`, the step's snapshot). `guard` is the loop guard of
    `relax.relax_rows` (ctl, phase_mask, n_live)."""

    def __init__(self, tables, over_base, over_ov, roots, gs, row_flag,
                 rows_changed):
        self.base_nbr, self.base_wgt = tables["base_nbr"], tables["base_wgt"]
        self.ov_ids, self.ov_nbr, self.ov_wgt = (
            tables["ov_ids"], tables["ov_nbr"], tables["ov_wgt"]
        )
        self.over_base, self.over_ov, self.roots = over_base, over_ov, roots
        self.gs = gs
        self.csz = self.base_nbr.shape[0] // gs
        self.fl = dict(row_flag=row_flag, rows_changed=rows_changed)

    def chunks(self, dist, prev, **guard):
        src = prev if self.gs == 1 else dist
        for c in range(self.gs):
            relax.relax_rows(
                src, dist, self.base_nbr, self.base_wgt, self.roots,
                self.over_base, row0=c * self.csz, n=self.csz, **self.fl,
                **guard,
            )

    def rows(self, dist, prev, rows, **guard):
        relax.relax_rows(
            prev, dist, self.base_nbr, self.base_wgt, self.roots,
            self.over_base, src_rows=rows, dst_rows=rows, **self.fl, **guard,
        )

    def overflow(self, dist, prev, **guard):
        # overflow in-edges: the ov tables are tiny — relax them all
        relax.relax_rows(
            prev, dist, self.ov_nbr, self.ov_wgt, self.roots, self.over_ov,
            dst_rows=self.ov_ids, **self.fl, **guard,
        )


#: steps a block (a replay) runs between two reads of the loop's state:
#: the 100k benchmark's cold solve takes ~15 dense sweeps and a few tail
#: rounds, config 3's about as many, so one block finishes either; a
#: warm solve is mostly a few tail rounds
STEPS_COLD = 32
STEPS_WARM = 16


class SplitProgram:
    """The split solve as a program of steps on the device, for one table
    set, B, overload flag, Gauss-Seidel chunk count and set of caps, cold
    or warm.

    State lives in static buffers: `dist` and its snapshot `snap` [vp,
    B], `row_flag` and `mark` [vp], the tail's `rows` and `frontier`
    lists [tail_cap], `roots` [B] and the control block `ctl`
    (`ops/split_loop.py`). A step is one dense sweep (phases 1 and 3) or
    one tail round (phase 2); every launch of it is guarded by the phase,
    so the same `gs + STEP_LAUNCHES` launches serve either, and after the
    loop's exit a step touches nothing:

      1. `split_snap_kernel`: snap = dist, row flags and count cleared;
      2. `frontier_mark_kernel` (tail): the frontier's out-neighbors (and,
         warm, the frontier itself) marked;
      3. `flag_compact_kernel` (tail): the marks into the round's rows,
         spill if they exceed `tail_cap`;
      4. kernel A: the `gs` dense chunks (dense), the listed rows up to
         their count (tail), the overflow rows (both);
      5. `split_ctl_kernel`: the step counted, phase 1 ended
         while at most `tail_threshold` rows changed, the net ended at a
         sweep that changed nothing;
      6. `flag_compact_kernel` (tail): the lowered rows into the next
         frontier, spill if they exceed `tail_cap`; its last block then
         decides: done on an empty frontier, to the net on a spill or at
         `tail_rounds_cap` rounds.

    `run` executes blocks of `steps` steps and reads `ctl` back once per
    block until the phase is done: the solve's host syncs are its blocks.
    With `graphs` (CUDA only) the first run is eager — the warm-up, and
    the run whose launches a telemetry capture counts — and then the init
    and a block of steps are captured as two CUDA graphs that later runs
    replay. The wrappers count the kernels they launch, so a replay moves
    no wrapper's count: the stats count replays instead, and the graph
    nodes, the kernels the wrappers recorded into the block's capture.
    On the CPU the steps call the twins, and a block is a host loop."""

    def __init__(self, tables, b: int, *, has_overloads: bool,
                 gs_chunks: int | None, tail_threshold: int, tail_cap: int,
                 tail_rounds_cap: int, warm: bool, steps: int | None = None,
                 graphs: bool = False):
        base_nbr = tables["base_nbr"]
        self.tables = tables  # held: the buffers' pointers stay valid
        self.dev = dev = base_nbr.device
        self.vp = vp = base_nbr.shape[0]
        self.dead = vp - 1
        self.b = b
        gs = gs_chunks if gs_chunks is not None else pick_gs_chunks(vp)
        if vp % gs:  # explicit override that doesn't divide: no chunking
            gs = 1
        self.gs = gs
        self.warm = warm
        self.steps = steps or (STEPS_WARM if warm else STEPS_COLD)
        self.graphs = graphs and dev.type == "cuda"
        self.out_nbr = tables["out_nbr"]
        i32 = dict(dtype=torch.int32, device=dev)
        self.dist = torch.empty((vp, b), **i32)
        self.snap = torch.empty((vp, b), **i32)
        self.row_flag = torch.zeros(vp, **i32)
        self.mark = torch.zeros(vp, **i32)
        self.rows = torch.full((tail_cap,), self.dead, **i32)
        self.frontier = torch.full((tail_cap,), self.dead, **i32)
        self.roots = torch.zeros(b, **i32)
        self.ctl = torch.zeros(split_loop.CTL_WORDS, **i32)
        self.ws = split_loop.compact_ws(vp, dev)  # zero between launches
        self.ctl0 = split_loop.new_ctl(
            split_loop.TAIL if warm else split_loop.DENSE, tail_threshold,
            tail_rounds_cap, vp, dev)
        self.cols = torch.arange(b, device=dev)
        self.flat = torch.zeros(b, dtype=torch.int64, device=dev)
        over_base, over_ov = _over_masks(tables, has_overloads)
        rc = split_loop.ROWS_CHANGED
        self.rx = _Relaxes(tables, over_base, over_ov, self.roots, gs,
                           self.row_flag, self.ctl[rc:rc + 1])
        nr = split_loop.N_ROWS
        self.n_live = self.ctl[nr:nr + 1]
        # the loop's iterations are bounded (each phase by its cap), so
        # are its blocks
        self.max_blocks = (2 * vp + tail_rounds_cap + 2) // self.steps + 2
        self._graphs = None  # (init, steps) CUDA graphs once captured
        self._nodes = 0  # kernels recorded into the block's graph

    #: launches of one step besides the `gs` dense chunks: the snapshot,
    #: the mark, two compactions, kernel A's listed and overflow rows, the
    #: decision
    STEP_LAUNCHES = 7

    def _init(self) -> None:
        sl = split_loop
        self.ctl.copy_(self.ctl0)
        if self.warm:  # the seeds (in `mark`) become the first frontier
            sl.flag_compact(self.mark, self.frontier, self.ctl, sl.M_TAIL,
                            sl.N_FRONT, sl.RAW_FRONT, self.dead, True,
                            decide=True, ws=self.ws)
            return
        self.flat.copy_(self.roots)
        self.flat.mul_(self.b).add_(self.cols)
        self.dist.fill_(INF_DIST)
        self.dist.view(-1).index_fill_(0, self.flat, 0)

    def _step(self) -> None:
        sl, ctl = split_loop, self.ctl
        sl.snap(self.dist, self.snap, self.row_flag, ctl, sl.M_ALL)
        sl.frontier_mark(self.frontier, self.out_nbr, self.mark, ctl,
                         sl.M_TAIL, self.warm, self.dead)
        sl.flag_compact(self.mark, self.rows, ctl, sl.M_TAIL, sl.N_ROWS,
                        sl.RAW_ROWS, self.dead, True, ws=self.ws)
        self.rx.chunks(self.dist, self.snap, ctl=ctl, phase_mask=sl.M_DENSE)
        self.rx.rows(self.dist, self.snap, self.rows, ctl=ctl,
                     phase_mask=sl.M_TAIL, n_live=self.n_live)
        self.rx.overflow(self.dist, self.snap, ctl=ctl, phase_mask=sl.M_ALL)
        sl.split_ctl(ctl, sl.M_ALL)
        sl.flag_compact(self.row_flag, self.frontier, ctl, sl.M_TAIL,
                        sl.N_FRONT, sl.RAW_FRONT, self.dead, False,
                        decide=True, ws=self.ws)

    def _capture(self) -> None:
        """The init and a block of steps as two CUDA graphs. Nothing in
        them syncs or allocates, and capturing launches nothing."""
        cur = torch.cuda.current_stream(self.dev)
        side = torch.cuda.Stream(self.dev)
        side.wait_stream(cur)
        graphs = []
        nodes = []
        with torch.cuda.stream(side), _telemetry.paused():
            for body in (self._init, self._block):
                g = torch.cuda.CUDAGraph()
                g.capture_begin(capture_error_mode="thread_local")
                try:
                    nodes.append(self._recorded(body))
                finally:
                    g.capture_end()
                graphs.append(g)
        cur.wait_stream(side)
        self._graphs, self._nodes = graphs, nodes[1]

    @staticmethod
    def _recorded(body) -> int:
        """Runs `body`; returns the kernels the wrappers recorded into
        the running capture meanwhile."""
        n0 = relax.CAPTURED + split_loop.CAPTURED
        body()
        return relax.CAPTURED + split_loop.CAPTURED - n0

    def _block(self) -> None:
        for _ in range(self.steps):
            self._step()

    def run(self, roots, dist0=None, seed=None) -> dict:
        """Solves from `roots` (int32 [B], on the device); a warm program
        starts from `dist0` [vp, B] (read, not written) and the seed mask
        `seed` [vp]. The distances are left in `self.dist`. Returns the
        stats: sweeps, tail_rounds, spilled, host_syncs (= replays, the
        blocks run), steps (the steps that did work), relax_launches
        (kernel A's launches that did work; 0 on the CPU, which runs the
        twin), graph_nodes (the kernels a replayed block holds, as the
        wrappers recorded them; 0 when the blocks ran eagerly)."""
        self.roots.copy_(roots)
        if self.warm:
            self.dist.copy_(dist0)
            self.mark.copy_(seed)
        replay = self._graphs is not None and _telemetry.sink() is None
        if replay:
            self._graphs[0].replay()
        else:
            self._init()
        blocks = 0
        while True:
            if replay:
                self._graphs[1].replay()
            else:
                self._block()
            blocks += 1
            c = self.ctl.tolist()  # the block's one read of the loop state
            compile_ledger.record_sync()
            if c[split_loop.PHASE] == split_loop.DONE:
                break
            if blocks >= self.max_blocks:
                raise RuntimeError(
                    f"split solve: the loop did not finish in {blocks} "
                    f"blocks of {self.steps} steps (ctl {c})")
        if self.graphs and self._graphs is None:
            self._capture()
        sweeps, rounds = c[split_loop.SWEEPS], c[split_loop.TAIL_ROUNDS]
        cuda = self.dev.type == "cuda"
        return {
            "sweeps": sweeps, "tail_rounds": rounds,
            "spilled": bool(c[split_loop.SPILL]), "host_syncs": blocks,
            "replays": blocks, "steps": c[split_loop.STEPS],
            "relax_launches": (sweeps * (self.gs + 1) + 2 * rounds
                               if cuda else 0),
            "graph_nodes": self._nodes if replay else 0,
        }


class ProgramCache:
    """Split programs by key, least recently used first, at most `cap`
    (each holds two [vp, B] buffers and, on CUDA, two graphs). Its
    programs run `steps` steps a block (None: `STEPS_COLD` cold,
    `STEPS_WARM` warm)."""

    def __init__(self, cap: int = 4, steps: int | None = None):
        self.cap = cap
        self.steps = steps
        self._progs: dict = {}

    def get(self, key, make):
        prog = self._progs.pop(key, None)
        if prog is None:
            prog = make()
        self._progs[key] = prog
        while len(self._progs) > self.cap:
            self._progs.pop(next(iter(self._progs)))
        return prog

    def keep_tables(self, live) -> None:
        """Drops the programs of table sets not in `live`."""
        ids = {id(t) for t in live}
        for key in [k for k, p in self._progs.items()
                    if id(p.tables) not in ids]:
            del self._progs[key]

    def clear(self) -> None:
        self._progs.clear()

    def __len__(self) -> int:
        return len(self._progs)


def _program(tables, b, programs, **kw):
    """(the program for this solve, whether it is kept): from `programs`
    where given, else a fresh one that runs eagerly and is dropped."""
    if programs is None:
        return SplitProgram(tables, b, **kw), False
    key = (id(tables), b, *sorted(kw.items()))
    return programs.get(key, lambda: SplitProgram(
        tables, b, steps=programs.steps, graphs=True, **kw)), True


def batched_sssp_split(
    tables: dict,
    roots,
    has_overloads: bool = False,
    tail_threshold: int = 1024,
    tail_cap: int = 8192,
    tail_rounds_cap: int = 64,
    gs_chunks: int | None = None,
    stats: dict | None = None,
    programs: ProgramCache | None = None,
):
    """Distances [vp, B] int32 from each root, a tensor of its own.

    `tables` is the device table set of `convert.split_tables_from_numpy`
    (base_nbr, base_wgt, ov_ids, ov_nbr, ov_wgt, out_nbr, over). The solve
    runs as a `SplitProgram`; with `programs` the program is kept there (on CUDA: replayed as CUDA graphs from its
    second solve). If `stats` is given it is filled with `run`'s stats."""
    prog, kept = _program(
        tables, roots.shape[0], programs, has_overloads=has_overloads,
        gs_chunks=gs_chunks, tail_threshold=tail_threshold,
        tail_cap=tail_cap, tail_rounds_cap=tail_rounds_cap, warm=False)
    st = prog.run(roots)
    if stats is not None:
        stats.update(st)
    return prog.dist.clone() if kept else prog.dist


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
    programs: ProgramCache | None = None,
):
    """Distances plus the host-bound outputs packed into one uint8
    buffer by `rib_epilogue_kernel` (`ops/rib_epilogue.py`), the layout
    `unpack_rib_buffer` decodes:

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
        programs=programs,
    )
    return dist, rib_epilogue.rib_buffer(dist, nbr_metric, nbr_ids, nbr_over,
                                         my_id, with_lfa)


def batched_sssp_split_warm_rib(
    tables: dict,
    roots,          # [B]: col 0 = the RIB root, 1.. = neighbors
    nbr_metric,     # [B-1] i32 metric(root -> neighbor i)
    nbr_ids,        # [B-1] i32 (padding -> dead slot)
    nbr_over,       # [B-1] bool (padding -> True)
    dist0,          # [vp, B] i32 warm start (read, not written)
    seed_mask,      # [vp] bool: nodes whose distance may change
    has_overloads: bool = False,
    tail_cap: int = 8192,
    tail_rounds_cap: int = 64,
    gs_chunks: int | None = None,
    stats: dict | None = None,
    programs: ProgramCache | None = None,
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
    or hits its round cap. Returns the distances (a tensor of its own)
    and the packed buffer; `stats` gets `SplitProgram.run`'s stats."""
    prog, kept = _program(
        tables, roots.shape[0], programs, has_overloads=has_overloads,
        gs_chunks=gs_chunks, tail_threshold=0, tail_cap=tail_cap,
        tail_rounds_cap=tail_rounds_cap, warm=True)
    st = prog.run(roots, dist0, seed_mask)
    if stats is not None:
        stats.update(st)
    dist = prog.dist.clone() if kept else prog.dist
    return dist, rib_epilogue.rib_buffer(dist, nbr_metric, nbr_ids, nbr_over,
                                         0, False)


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

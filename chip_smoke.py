#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one GPU: builds the hand
kernels from this checkout, holds each against its plain PyTorch
version, times them on the device, drives the cold single-root RIB
solve at full size and checks its answers.

    python3 chip_smoke.py

Phases (any failure exits non-zero and prints no result line):

  1. device: requires CUDA; prints the card's name and power limit;
  2. build: compiles csrc/relax.cu with nvcc and, at the same time, a
     cubin with `-Xptxas -v`, whose registers, shared memory and spills
     it prints per kernel; checks the C dispatch against `design_for`;
  3. kernels vs plain on the card, exact int32 equality of dist, the
     changed count, row_flag and rows_changed: every vectorised
     specialisation (W, B in {8, 16, 32, 64}) and the generic kernel on
     shapes outside that table (W in {1, 4, 128}, B = 128), on random
     tables (dense row0 chunks, a Jacobi sweep, dst_rows with dead-slot
     repeats, src_rows indirection, overload mask on/off, INF padding,
     flags an earlier launch set); then both designs at the main path's
     own calls on the 100k-node tables, checked the same way and timed
     on the device: CUPTI kernel durations (torch.profiler) and a
     CUDA-graph replay less a copy-only replay, with `out` and the flags
     restored before every launch, the designs in turns (generic, vec,
     vec, generic), the card's clocks sampled before and after;
  4. main path: `erdos_renyi_lsdb(100_000, avg_degree=20, seed=0,
     max_metric=64)` through `TorchSpfSolver(device="cuda")`, solve and
     compute_routes, root and two neighbor columns checked against
     scipy's Dijkstra and the first hops against a NumPy recomputation;
     the relax launches by design and their CUPTI time in one solve;
     then the same path at a shape outside the specialisation table:
     the hub of `hub_and_spoke(2, 100)` (101 neighbors, B = 128), which
     takes the generic kernel;
  5. the link-flap warm path on the same graph, built as a real
     `LinkState` from its directed edges: 5 seeded rounds of 32 metric
     changes (16 raised by +20, 16 lowered to 1, none root-incident)
     through `update_adjacency_db_delta` and `warm_compute_routes`, each
     round then reverted the same way; every warm RouteDatabase equal to
     a cold `compute_routes` of a fresh solver, one warm solve against
     scipy; warm and cold p50, the warm stats, the relax launches by
     design and the relax kernel's CUPTI time in one profiled warm solve;
  6. overloads + LFA on a small graph, the packed first-hop and LFA bits
     checked against a NumPy recomputation from scipy distances;
  7. the gather probe (`openr_tpu_torch.probe_gather`) at its full
     shapes: both sweeps exact against the plain version and the probe's
     check sum, CUPTI time of each kernel, the torch-ops sweep's time.

The line before the card's name is a JSON object `{"kernels": [...]}`;
the last line is `{"ok": true, "device": {...}}`.
"""

from __future__ import annotations

import json
import re
import shutil
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

HBM_BYTES_PER_S = 3.35e12  # H100 SXM HBM3, data sheet
INT32_OPS_PER_S = 67e12  # non-tensor-core 32-bit rate (fp32 peak), data sheet
INF = 1 << 30
WIDTHS = (8, 16, 32, 64)
GENERIC_SHAPES = [(w, b) for w in (1, 4, 128) for b in (8, 32, 128)] + [
    (8, 128), (32, 128)
]
TIMING_REPS = 30
DEVICE = "cuda"  # every tensor and solver of the run lives here


def fail(msg: str) -> None:
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def log(msg: str) -> None:
    print(msg, flush=True)


def smi(query: str) -> str:
    """One line of `nvidia-smi --query-gpu=<query>` for card 0 ("" if it
    fails)."""
    res = subprocess.run(
        ["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    lines = res.stdout.strip().splitlines()
    return lines[0] if res.returncode == 0 and lines else ""


def cuda_ms(fn, reps: int = 3) -> float:
    """Mean ms of `fn()` between two CUDA events, after a warm-up (for
    the plain version, a sequence of many torch ops)."""
    fn()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(reps):
        fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / reps


# ------------------------------------------------------- device timing


def kernel_device_us(prof, names) -> tuple[float, int]:
    """(total CUPTI µs, launches) of the kernels whose name holds one of
    `names`, from a finished torch.profiler run."""
    us, count = 0.0, 0
    for ev in prof.key_averages():
        if str(getattr(ev, "device_type", "")).endswith("CPU"):
            continue
        if not any(n in ev.key for n in names):
            continue
        t = getattr(ev, "self_device_time_total", None)
        if t is None:
            t = getattr(ev, "self_cuda_time_total", 0.0)
        us += t
        count += ev.count
    return us, count


def cupti_us(launch, restore, name: str, reps: int) -> float | None:
    """Mean CUPTI duration (µs) of kernel `name` over `reps` launches,
    each after `restore()` (whose copy kernels are not counted)."""
    from torch.profiler import ProfilerActivity, profile

    restore()
    launch()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            restore()
            launch()
        torch.cuda.synchronize()
    us, count = kernel_device_us(prof, (name,))
    if count != reps:
        log(f"[3]   CUPTI saw {count} launches of {name}, expected {reps}")
        return None
    return us / count


def graph_us(launch, restore, reps: int) -> float:
    """µs per launch from CUDA-graph replays: `reps` x (restore, launch)
    less `reps` x restore, each the median of three replays."""
    s = torch.cuda.Stream()
    s.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(s):  # warm-up off the default stream
        restore()
        launch()
    torch.cuda.current_stream().wait_stream(s)
    torch.cuda.synchronize()
    g_copy, g_full = torch.cuda.CUDAGraph(), torch.cuda.CUDAGraph()
    with torch.cuda.graph(g_copy):
        for _ in range(reps):
            restore()
    with torch.cuda.graph(g_full):
        for _ in range(reps):
            restore()
            launch()

    def replay_ms(g):
        g.replay()
        torch.cuda.synchronize()
        out = []
        for _ in range(3):
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            g.replay()
            b.record()
            torch.cuda.synchronize()
            out.append(a.elapsed_time(b))
        return statistics.median(out)

    return (replay_ms(g_full) - replay_ms(g_copy)) / reps * 1e3


# ------------------------------------------------------------ phase 2


def start_ptxas_report(cuda_build):
    """Start `nvcc -cubin -Xptxas -v` on relax.cu; returns (process, dir)."""
    tmp = tempfile.mkdtemp(prefix="relax_ptxas_")
    cmd = [
        cuda_build.find_nvcc(), "-gencode=arch=compute_90a,code=sm_90a",
        "-std=c++17", "-O3", "-cubin", "-Xptxas", "-v",
        "-o", str(Path(tmp) / "relax.cubin"),
        str(cuda_build.CSRC_DIR / "relax.cu"),
    ]
    return subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True), tmp


def parse_ptxas(text: str) -> list[tuple[str, int, int, int, int]]:
    """(kernel, registers, smem bytes, spill stores, spill loads) per
    kernel in `-Xptxas -v` output."""
    rows, cur, spill = [], None, (0, 0)
    for line in text.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            k = re.search(r"(relax_(?:vec|generic)_kernel)"
                          r"(?:ILi(\d+)ELi(\d+)ELb(\d)E)?", m.group(1))
            cur = m.group(1) if k is None else k.group(1)
            if k is not None and k.group(2):
                over = "over" if k.group(4) == "1" else "no over"
                cur += f"<{k.group(2)},{k.group(3)},{over}>"
            spill = (0, 0)
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m and cur:
            spill = (int(m.group(1)), int(m.group(2)))
            continue
        m = re.search(r"Used (\d+) registers(?:.*?(\d+) bytes smem)?", line)
        if m and cur:
            rows.append((cur, int(m.group(1)), int(m.group(2) or 0), *spill))
            cur = None
    return rows


# ------------------------------------------------------------ phase 3


def random_case(g, vp, b, r, w, with_over, dev):
    def ri(lo, hi, shape):
        return torch.randint(lo, hi, shape, generator=g, dtype=torch.int32)

    dist = ri(0, 5000, (vp, b))
    dist[torch.rand(vp, b, generator=g) < 0.3] = INF
    nbr = ri(0, vp, (r, w))
    wgt = ri(1, 65, (r, w))
    wgt[torch.rand(r, w, generator=g) < 0.3] = INF  # INF padding slots
    over = (torch.rand(r, w, generator=g) < 0.2) if with_over else None
    roots = ri(0, vp, (b,))
    if with_over:  # the per-root exemption: a root among the neighbors
        nbr[0, 0] = roots[0]
        over[0, 0] = True
    out = [dist, nbr, wgt, roots, over]
    return [None if x is None else x.to(dev) for x in out]


def compare(fn, relax, dist, out0, nbr, wgt, roots, over, flag0, **kw):
    """`fn` (a kernel wrapper) and the plain version on the same inputs,
    each into its own copy of `out0` and of the flags `flag0`; returns
    the max |diff| (0 required) over dist, the changed count, row_flag
    and rows_changed, and the rows the plain version newly flagged."""
    res = []
    for f in (fn, relax.relax_rows_ref):
        out = out0.clone()
        ch = torch.zeros(1, dtype=torch.int32, device=dist.device)
        rf = flag0.clone()
        rc = torch.zeros(1, dtype=torch.int32, device=dist.device)
        f(dist, out, nbr, wgt, roots, over, changed=ch, row_flag=rf,
          rows_changed=rc, **kw)
        res.append((out, ch, rf, rc))
    torch.cuda.synchronize()
    err = max(int((a.long() - b.long()).abs().max().item())
              for a, b in zip(*res))
    return err, int(res[1][3].item())


def phase3_random(relax, dev) -> tuple[dict, dict]:
    """Every specialisation and the generic shapes on random tables;
    returns (worst |diff| by design, cases by design)."""
    g = torch.Generator().manual_seed(20261016)
    worst = {"vec": 0, "generic": 0}
    cases = {"vec": 0, "generic": 0}
    vp = r = 4096
    q = r // 4
    for w, b in [(w, b) for w in WIDTHS for b in WIDTHS] + GENERIC_SHAPES:
        design = relax.design_for(w, b)
        for with_over in (False, True):
            dist, nbr, wgt, roots, over = random_case(
                g, vp, b, r, w, with_over, dev
            )
            flag0 = (torch.rand(vp, generator=g) < 0.05).to(
                torch.int32).to(dev)
            ro = 256
            dst = torch.randint(0, vp, (ro,), generator=g, dtype=torch.int32)
            dst[ro // 2 :] = vp - 1  # dead-slot padding
            dst[:4] = dst[4]  # a live target repeated
            rows = torch.randint(0, vp, (q - 1,), generator=g,
                                 dtype=torch.int32)
            rows[700:] = vp - 1
            dst, rows = dst.to(dev), rows.to(dev)
            tab = (nbr, wgt, over)
            ov_tab = tuple(None if x is None else x[:ro].contiguous()
                           for x in tab)
            calls = (
                # dense row0 chunks (the first of odd length), as in place
                [(tab, dict(row0=0, n=q - 1))]
                + [(tab, dict(row0=c * q, n=q)) for c in range(1, 4)]
                + [(tab, dict(row0=0)),  # a Jacobi sweep over all rows
                   (ov_tab, dict(dst_rows=dst)),  # overflow table form
                   (tab, dict(src_rows=rows, dst_rows=rows))]  # tail form
            )
            for (tn, tw, to), kw in calls:
                err, newly = compare(relax.relax_rows, relax, dist, dist,
                                     tn, tw, roots, to, flag0, **kw)
                if newly == 0:
                    fail(f"random case W={w} B={b} {kw.keys()} lowered "
                         "no row: the flags went untested")
                worst[design] = max(worst[design], err)
                cases[design] += 1
    return worst, cases


def relax_bytes(w, kind, n, b, dist_rows_read):
    """Bytes one relax call must move: the n table rows (nbr + wgt), each
    distinct gathered dist row once, the n target rows read and written,
    their row flags written, roots and the row-index lists."""
    bytes_ = n * w * 8 + dist_rows_read * b * 4 + 2 * n * b * 4 + b * 4
    bytes_ += n * 4
    if kind != "dense":
        bytes_ += n * 4 * (2 if kind == "tail" else 1)
    return bytes_


def main_path_calls(relax, solver, ls, tables):
    """Both designs at the main path's three calls on the 100k tables:
    exact against the plain version, then timed on the device. Returns
    ({kind: numbers}, worst |diff| by design)."""
    vp = tables["vp"]
    first = solver.solve(ls, "node-0")
    dist_final = first[1].device_tensor
    b = dist_final.shape[1]
    g = torch.Generator(device=DEVICE).manual_seed(7)
    bump = torch.randint(0, 200, dist_final.shape, generator=g,
                         device=DEVICE, dtype=torch.int32)
    # every reachable entry raised: each launch lowers most of its rows,
    # as the early sweeps of the main path do
    dist_in = torch.clamp_max(dist_final + bump, INF).contiguous()
    roots = torch.tensor(
        [0] + list(first[3]) + [0] * (b - 1 - len(first[3])),
        dtype=torch.int32, device=DEVICE,
    )
    from openr_tpu_torch.ops.spf_split import pick_gs_chunks

    csz = vp // pick_gs_chunks(vp)
    rows = torch.unique(
        torch.randint(0, vp - 1, (8192,), generator=g, device=DEVICE)
    ).to(torch.int32)
    rows = torch.cat([rows, torch.full((8192 - rows.numel(),), vp - 1,
                                       dtype=torch.int32, device=DEVICE)])
    calls = {
        "dense": (tables["base_nbr"], tables["base_wgt"],
                  dict(row0=vp - csz, n=csz)),
        "overflow": (tables["ov_nbr"], tables["ov_wgt"],
                     dict(dst_rows=tables["ov_ids"])),
        "tail": (tables["base_nbr"], tables["base_wgt"],
                 dict(src_rows=rows, dst_rows=rows)),
    }
    worst = {"vec": 0, "generic": 0}
    zero_flags = torch.zeros(vp, dtype=torch.int32, device=DEVICE)
    for kind, (nbr, wgt, kw) in calls.items():
        for fn, design in ((relax.relax_rows,
                            relax.design_for(nbr.shape[1], b)),
                           (relax.relax_rows_generic, "generic")):
            err, newly = compare(fn, relax, dist_in, dist_in, nbr, wgt,
                                 roots, None, zero_flags, **kw)
            worst[design] = max(worst[design], err)
            if newly == 0:
                fail(f"main-path call {kind} lowered no row")
    log(f"[3] both designs vs plain at the main path's calls: max |diff| "
        f"{worst}")
    if any(worst.values()):
        fail(f"relax kernels disagree at main-path shapes ({worst})")

    log(f"[3] clocks before timing (sm MHz, W, C): "
        f"{smi('clocks.sm,power.draw,temperature.gpu')}")
    work = dist_in.clone()
    flags = torch.zeros(vp + 1, dtype=torch.int32, device=DEVICE)
    fl = dict(row_flag=flags[:vp], rows_changed=flags[vp:])

    def restore():
        work.copy_(dist_in)
        flags.zero_()

    out = {}
    for kind, (nbr, wgt, kw) in calls.items():
        w = nbr.shape[1]
        # the dense chunk relaxes in place; overflow and tail read a
        # pre-round snapshot, as on the main path
        src = work if kind == "dense" else dist_in
        wrappers = {"vec": relax.relax_rows,
                    "generic": relax.relax_rows_generic}
        if relax.design_for(w, b) != "vec":
            fail(f"main-path call {kind} (W={w}, B={b}) has no "
                 "specialisation to time")
        t = {"vec": [], "generic": [], "vec_graph": [], "generic_graph": []}
        for design in ("generic", "vec", "vec", "generic"):
            fn = wrappers[design]

            def launch(fn=fn):
                fn(src, work, nbr, wgt, roots, None, **fl, **kw)

            t[design].append(cupti_us(
                launch, restore, relax.KERNEL_NAMES[design], TIMING_REPS))
            t[design + "_graph"].append(
                graph_us(launch, restore, TIMING_REPS))
        p_ms = cuda_ms(lambda: relax.relax_rows_ref(
            src, work, nbr, wgt, roots, None, **fl, **kw))
        n = kw.get("n") or next(
            v.shape[0] for k, v in kw.items() if k.endswith("rows"))
        if "src_rows" in kw:
            sel = nbr[kw["src_rows"].long()]
            swgt = wgt[kw["src_rows"].long()]
        else:
            r0 = kw.get("row0", 0)
            sel, swgt = nbr[r0:r0 + n], wgt[r0:r0 + n]
        valid = swgt < INF
        distinct = int(torch.unique(sel[valid]).numel())
        nbytes = relax_bytes(w, kind, n, b, distinct)
        t_bytes = nbytes / HBM_BYTES_PER_S * 1e6
        ops = int(valid.sum().item()) * b * 4
        t_ops = ops / INT32_OPS_PER_S * 1e6
        bound_us = max(t_bytes, t_ops)
        res = dict(n=n, w=w, b=b, bytes=nbytes, ops=ops, bound_us=bound_us,
                   bound_by="bytes" if t_bytes >= t_ops else "operations",
                   plain_ms=p_ms)
        for design in ("vec", "generic"):
            cu = [x for x in t[design] if x is not None]
            gr = statistics.fmean(t[design + "_graph"])
            res[design] = dict(
                cupti_us=statistics.fmean(cu) if cu else None,
                graph_us=gr, samples=t[design],
                graph_samples=t[design + "_graph"],
            )
            res[design]["us"] = res[design]["cupti_us"] or gr
            res[design]["bound_share"] = bound_us / res[design]["us"]
        out[kind] = res
        v, gn = res["vec"], res["generic"]
        log(f"[3] {kind}: n={n} W={w} B={b}; generic "
            f"{gn['cupti_us']} us CUPTI ({gn['graph_us']:.3f} graph); vec "
            f"{v['cupti_us']} us CUPTI ({v['graph_us']:.3f} graph); bound "
            f"{bound_us:.3f} us by {res['bound_by']} ({nbytes} B, {ops} "
            f"int ops); share of bound generic {gn['bound_share']:.3f}, "
            f"vec {v['bound_share']:.3f}; vec/generic "
            f"{v['us'] / gn['us']:.3f}; plain {p_ms:.4f} ms")
        log(f"[3]   samples (generic, vec, vec, generic order) CUPTI "
            f"generic {t['generic']}, vec {t['vec']}; graph generic "
            f"{t['generic_graph']}, vec {t['vec_graph']}")
    log(f"[3] clocks after timing (sm MHz, W, C): "
        f"{smi('clocks.sm,power.draw,temperature.gpu')}")
    return out, worst


# ------------------------------------------------------------ phase 4


def check_solve(csr, solved, rdb, cols: int, tag: str) -> None:
    """The root and its first `cols - 1` neighbor columns against scipy's
    Dijkstra, their first hops against a NumPy recomputation, and one
    unicast route per other node."""
    from scipy.sparse import csr_matrix
    from scipy.sparse.csgraph import dijkstra

    _csr, dist, fh, nbr_ids, _lfa = solved
    n_live = csr.num_nodes
    e = int(csr.num_edges)
    my_id = _csr.name_to_id["node-0"]
    src_ids = [my_id] + list(nbr_ids[: cols - 1])
    graph = csr_matrix(
        (csr.edge_metric[:e].astype(np.float64),
         (csr.edge_src[:e], csr.edge_dst[:e])),
        shape=(n_live, n_live),
    )
    ref = dijkstra(graph, directed=True, indices=src_ids)
    ref = np.where(np.isinf(ref), INF, ref).astype(np.int64)
    got = np.asarray(dist)[:n_live][:, : len(src_ids)].T.astype(np.int64)
    if not np.array_equal(got, ref):
        bad = int((got != ref).sum())
        fail(f"{tag}: solve disagrees with scipy dijkstra at {bad} entries")
    d_root, d_n = ref[0], ref[1:]
    met = np.array(
        [min(x[1] for x in csr.details(my_id, j)) for j in src_ids[1:]]
    )
    fh_ref = (d_root < INF)[None, :] & (d_n < INF) & (
        met[:, None] + d_n == d_root[None, :]
    )
    if not np.array_equal(fh[: len(src_ids) - 1, :n_live], fh_ref):
        fail(f"{tag}: first-hop bits disagree with the NumPy recomputation")
    if len(rdb.unicast_routes) != n_live - 1:
        fail(f"{tag}: {len(rdb.unicast_routes)} unicast routes, expected "
             f"{n_live - 1}")


def path_designs(relax, tables, b) -> set[str]:
    """The relax designs the split solve's shapes select."""
    return {relax.design_for(tables["base_nbr"].shape[1], b),
            relax.design_for(tables["ov_nbr"].shape[1], b)}


def phase4_hub(relax) -> dict:
    """The main path at a shape outside the specialisation table: a hub
    router's RIB (101 neighbors, B = 128). Returns the launches by
    design from this run (counts set to 0 just before it)."""
    from openr_tpu_torch import LinkState, PrefixState, TorchSpfSolver
    from openr_tpu_torch.utils.topogen import hub_and_spoke

    adj, pfx = hub_and_spoke(hubs=2, spokes=100)
    ls, ps = LinkState(), PrefixState()
    for db in adj:
        ls.update_adjacency_db(db)
    for db in pfx:
        ps.update_prefix_db(db)
    solver = TorchSpfSolver(device=DEVICE)
    relax.reset_launches()
    solved = solver.solve(ls, "node-0")
    rdb = solver.compute_routes(ls, ps, "node-0")
    torch.cuda.synchronize()
    launches = dict(relax.LAUNCHES_BY_DESIGN)
    csr = solved[0]
    b = solved[1].device_tensor.shape[1]
    designs = path_designs(relax, solver._device_arrays(csr), b)
    if "generic" not in designs:
        fail(f"hub root: B={b} selects {designs}, not the generic kernel")
    for d in designs:
        if launches[d] == 0:
            fail(f"hub root: the {d} relax kernel was launched no time")
    check_solve(csr, solved, rdb, cols=b, tag="hub root")
    log(f"[4] hub root: {csr.num_nodes} nodes, B={b}, designs {designs}; "
        f"launches {launches}; all {len(solved[3]) + 1} columns vs scipy, "
        f"first hops and {len(rdb.unicast_routes)} routes: ok")
    return launches


# ------------------------------------------------------------ phase 5


def er_linkstate(n: int, avg_degree: int, seed: int, max_metric: int):
    """A real LinkState + PrefixState of `erdos_renyi_csr`'s directed
    edges, through the topology generator's `_mk_dbs`: the names, node
    labels and interface names of `erdos_renyi_lsdb`'s view."""
    from openr_tpu_torch.decision.linkstate import LinkState, PrefixState
    from openr_tpu_torch.utils.topogen import _mk_dbs, erdos_renyi_csr

    src, dst, met, _vp, nn, e = erdos_renyi_csr(
        n, avg_degree=avg_degree, seed=seed, max_metric=max_metric
    )
    adj, pfx = _mk_dbs(nn, list(zip(src[:e].tolist(), dst[:e].tolist(),
                                    met[:e].tolist())))
    ls, ps = LinkState(), PrefixState()
    for db in adj:
        ls.update_adjacency_db(db)
    for db in pfx:
        ps.update_prefix_db(db)
    return ls, ps, e


def flap_round(ls, rng, n_up: int, n_down: int):
    """Metric changes on n_up + n_down directed adjacencies of distinct
    nodes, none touching node-0: n_up raised by +20, n_down lowered to 1.
    Returns (edge pairs, the replaced AdjacencyDatabases)."""
    from dataclasses import replace

    names = ls.nodes
    picked: dict[str, tuple[int, int]] = {}
    while len(picked) < n_up + n_down:
        node = names[int(rng.integers(1, len(names)))]
        if node == "node-0" or node in picked:
            continue
        adjs = ls.adjacency_db(node).adjacencies
        k = int(rng.integers(len(adjs)))
        if adjs[k].other_node_name == "node-0":
            continue
        new = adjs[k].metric + 20 if len(picked) < n_up else 1
        if new == adjs[k].metric:
            continue
        picked[node] = (k, new)
    pairs: set = set()
    old_dbs = []
    for node, (k, m) in picked.items():
        db = ls.adjacency_db(node)
        old_dbs.append(db)
        adjs = list(db.adjacencies)
        adjs[k] = replace(adjs[k], metric=m)
        changed, got = ls.update_adjacency_db_delta(
            replace(db, adjacencies=tuple(adjs)))
        if not changed or got is None:
            fail(f"warm: the flap on {node} was not metric-only")
        pairs.update(got)
    return pairs, old_dbs


def revert_round(ls, old_dbs):
    pairs: set = set()
    for db in old_dbs:
        changed, got = ls.update_adjacency_db_delta(db)
        if not changed or got is None:
            fail(f"warm: the revert of {db.this_node_name} was not "
                 "metric-only")
        pairs.update(got)
    return pairs


def phase5_warm(relax, shape4) -> dict:
    """The link-flap warm path on the 100k graph; returns the relax
    launches by design of its warm calls (counts set to 0 just before
    each call and read just after)."""
    from torch.profiler import ProfilerActivity, profile

    from openr_tpu_torch.decision.spf_backend import TorchSpfSolver

    t0 = time.perf_counter()
    ls, ps, e = er_linkstate(100_000, avg_degree=20, seed=0, max_metric=64)
    t_dbs = time.perf_counter() - t0
    csr = ls.to_csr()
    t_csr = time.perf_counter() - t0 - t_dbs
    solver = TorchSpfSolver(device=DEVICE)
    tables = solver._device_arrays(csr)
    shape = (tables["vp"], tables["base_nbr"].shape[1],
             tuple(tables["ov_nbr"].shape))
    if shape != shape4 or csr.num_edges != e:
        fail(f"warm: the LinkState's CSR gives {shape}, {csr.num_edges} "
             f"edges; phase 4 gave {shape4}, {e}")
    log(f"[5] LinkState: {csr.num_nodes} nodes, {csr.num_edges} directed "
        f"edges, vp {shape[0]}, W {shape[1]}, overflow {shape[2]}; set-up "
        f"{t_dbs:.1f} s (AdjacencyDatabases) + {t_csr:.1f} s (CSR)")
    rdb, art = solver.compute_routes(ls, ps, "node-0", return_artifact=True)
    cold_solver = TorchSpfSolver(device=DEVICE)
    cold_solver.compute_routes(ls, ps, "node-0")  # uploads its tables
    rng = np.random.default_rng(20261017)
    warm_ms, cold_ms, cold_gc, stats = [], [], [], []
    launches = {"vec": 0, "generic": 0}

    gc_ms = [0.0]
    gc_t0 = [0.0]

    def gc_timer(phase, _info):
        # host time inside the garbage collector, which the timed calls
        # include: millions of live objects make a full collection slow
        if phase == "start":
            gc_t0[0] = time.perf_counter()
        else:
            gc_ms[0] += (time.perf_counter() - gc_t0[0]) * 1e3

    def timed(fn):
        gc_ms[0] = 0.0
        t = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, (time.perf_counter() - t) * 1e3, gc_ms[0]

    def warm(pairs, tag):
        """One warm call, counts from 0; returns its result and times."""
        nonlocal rdb, art
        relax.reset_launches()
        got, dt, g = timed(lambda: solver.warm_compute_routes(
            art, ls, ps, "node-0", pairs, set(), rdb, 0.25))
        for k, v in relax.LAUNCHES_BY_DESIGN.items():
            launches[k] += v
        if got is None:
            fail(f"warm: {tag}: warm_compute_routes returned None on a "
                 "flap set with no fallback trigger")
        rdb, art = got[0], got[1]
        stats.append(dict(solver.last_warm_stats, region=got[4],
                          wall_ms=dt, gc_ms=g,
                          by_design=dict(relax.LAUNCHES_BY_DESIGN)))
        return dt

    def check(tag, scipy_check=False):
        """The warm RIB against a fresh solver's and the patched cold
        solver's; returns the cold solver's wall ms."""
        fresh = TorchSpfSolver(device=DEVICE).compute_routes(
            ls, ps, "node-0")
        cold, c_dt, g = timed(
            lambda: cold_solver.compute_routes(ls, ps, "node-0"))
        for ref, name in ((fresh, "a fresh solver"),
                          (cold, "the patched cold solver")):
            if (rdb.unicast_routes != ref.unicast_routes
                    or rdb.mpls_routes != ref.mpls_routes):
                fail(f"warm: {tag}: the warm RouteDatabase differs from "
                     f"a cold compute_routes of {name}")
        if scipy_check:
            check_solve(art.solved[0], art.solved, rdb, cols=3,
                        tag=f"warm {tag}")
        cold_gc.append(g)
        return c_dt

    def warm_call(pairs, tag, scipy_check=False):
        warm_ms.append(warm(pairs, tag))
        cold_ms.append(check(tag, scipy_check))

    import gc

    gc.callbacks.append(gc_timer)
    try:
        for rnd in range(5):
            pairs, old_dbs = flap_round(ls, rng, 16, 16)
            warm_call(pairs, f"round {rnd} flap", scipy_check=rnd == 0)
            warm_call(revert_round(ls, old_dbs), f"round {rnd} revert")
        # one more flap, traced alone: the relax kernel's device time and
        # the device's busy time in a warm call
        pairs, old_dbs = flap_round(ls, rng, 16, 16)
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            traced_ms = warm(pairs, "traced flap")
        check("traced flap")
        warm_call(revert_round(ls, old_dbs), "traced flap revert")
    finally:
        gc.callbacks.remove(gc_timer)
    k_us, k_n = kernel_device_us(prof, tuple(relax.KERNEL_NAMES.values()))
    dev_us, _n = kernel_device_us(prof, ("",))
    log(f"[5] warm p50 {statistics.median(warm_ms):.3f} ms (samples "
        f"{[round(x, 3) for x in warm_ms]}); cold p50 after the same flap "
        f"{statistics.median(cold_ms):.3f} ms (samples "
        f"{[round(x, 3) for x in cold_ms]}, of which in the garbage "
        f"collector {[round(x, 1) for x in cold_gc]}); host wall, ms")
    for i, st in enumerate(stats):
        log(f"[5] warm call {i}: {st}")
    st = stats[-2]  # the traced call
    log(f"[5] traced warm call ({st['tail_rounds']} tail rounds, "
        f"{st['sweeps']} sweeps, spilled {st['spilled']}, wall "
        f"{traced_ms:.3f} ms under the profiler): relax kernel {k_n} "
        f"launches, {k_us:.1f} us (CUPTI)"
        + (f", {k_us / k_n:.2f} us per launch" if k_n else
           " (not measured: the profiler saw no relax kernel)")
        + f"; all device kernels {dev_us:.1f} us, busy share "
        f"{dev_us / 1e3 / traced_ms:.3f} of the traced wall")
    log(f"[5] {len(stats)} warm calls, none None, each equal to a fresh "
        f"cold compute_routes; round 0 vs scipy: ok; solver "
        f"warm_solves {solver.warm_solves}, solve_count "
        f"{solver.solve_count}, device cache {solver.dev_cache_stats}")
    for d in path_designs(relax, tables, art.solved[1].shape[1]):
        if launches[d] == 0:
            fail(f"warm: the warm path launched the {d} relax kernel no "
                 "time")
    return launches


# ------------------------------------------------------------ phase 7


def phase7_probe(relax) -> dict:
    """`probe_gather` at the probe's shapes, counts from 0: both sweeps
    exact, their CUPTI times, the torch-ops sweep's and the plain
    version's times, and the sweep's bound."""
    from openr_tpu_torch import probe_gather as pg

    relax.reset_launches()
    res = pg.measure(DEVICE, pg.VP, reps=20)
    torch.cuda.synchronize()
    launches = dict(relax.LAUNCHES_BY_DESIGN)
    names = {name: fn.__name__ for name, fn, _k in pg.VARIANTS}
    out = {names[k]: v for k, v in res.items()}
    for fn, design in (("sweep_b1", "generic"), ("sweep_b2", "vec")):
        row = out[fn]
        if not row["sum_ok"] or row["max_abs_err"]:
            fail(f"probe: {fn} is wrong (sum ok {row['sum_ok']}, max "
                 f"|diff| vs plain {row['max_abs_err']})")
        if launches[design] == 0:
            fail(f"probe: {fn} launched the {design} kernel no time")
    if not out["sweep_torch_ops"]["sum_ok"]:
        fail("probe: the torch-ops sweep is wrong")
    vp, d, b = pg.VP, pg.D, pg.B
    nbytes = vp * d * 8 + 2 * vp * b * 4  # nbr+wgt, dist in, out
    ops = vp * d * b * 4
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / INT32_OPS_PER_S
    out.update(
        launches=launches,
        plain_ms=out["sweep_ref"]["us"] / 1e3,
        bound_ms=max(t_bytes, t_ops) * 1e3,
        bound_by="bytes" if t_bytes >= t_ops else "operations",
    )
    for name, row in res.items():
        log(f"[7] {name}: {row['us']:.2f} us ({row['gbs']:.0f} GB/s eff, "
            f"VP*D*B*4 logical bytes); sum ok {row['sum_ok']}, max |diff| "
            f"vs plain {row['max_abs_err']}")
    log(f"[7] probe VP {vp} D {d} B {b}: bound {out['bound_ms'] * 1e3:.3f} "
        f"us by {out['bound_by']} ({nbytes} B, {ops} int ops); launches "
        f"{launches}")
    return out


# ------------------------------------------------------------------ main


def main() -> None:
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this smoke run needs a GPU")
    card = smi("name,power.limit")
    if not card:
        fail("nvidia-smi could not read the card's name and power limit")
    log(f"[1] device: {card}; torch {torch.__version__} cuda "
        f"{torch.version.cuda}; count {torch.cuda.device_count()}")

    # ---- phase 2: build ------------------------------------------------
    from openr_tpu_torch.ops import cuda_build, relax

    t0 = time.perf_counter()
    proc, ptx_dir = start_ptxas_report(cuda_build)
    try:
        relax.build()
        ptx_out, _ = proc.communicate(timeout=600)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
        shutil.rmtree(ptx_dir, ignore_errors=True)
    log(f"[2] build: relax.cu in {time.perf_counter() - t0:.3f} s "
        f"(nvcc {cuda_build.BUILD_SECONDS.get('relax', 0.0):.3f} s, the "
        "-Xptxas -v cubin alongside)")
    if proc.returncode != 0:
        fail(f"nvcc -Xptxas -v failed:\n{ptx_out}")
    ptx = parse_ptxas(ptx_out)
    if len(ptx) != 1 + 2 * len(WIDTHS) ** 2:  # generic + vec x over
        fail(f"ptxas reported {len(ptx)} kernels:\n{ptx_out}")
    for name, regs, smem, st, ld in ptx:
        log(f"[2] ptxas {name}: {regs} registers, {smem} B smem, spill "
            f"stores {st} B, spill loads {ld} B")
    lib = relax._lib()
    grid = (1, 2, 4, 8, 16, 24, 32, 64, 128, 256)
    bad = [(w, b) for w in grid for b in grid
           if bool(lib.openr_relax_vec_shape(w, b))
           != (relax.design_for(w, b) == "vec")]
    if bad:
        fail(f"C dispatch and design_for disagree at {bad}")

    dev = torch.device(DEVICE)
    # ---- phase 3a: kernels vs plain on random tables ---------------------
    worst_r, cases = phase3_random(relax, dev)
    log(f"[3] kernels vs plain, random tables: {cases} cases, max |diff| "
        f"{worst_r} (dist, changed, row_flag, rows_changed)")
    if any(worst_r.values()):
        fail(f"relax kernels disagree with relax_rows_ref ({worst_r})")

    # ---- phase 4 set-up: the 100k LSDB and its device tables -------------
    from openr_tpu_torch.decision.spf_backend import TorchSpfSolver
    from openr_tpu_torch.utils.topogen import erdos_renyi_lsdb

    t0 = time.perf_counter()
    ls, ps, csr = erdos_renyi_lsdb(
        100_000, avg_degree=20, seed=0, max_metric=64
    )
    solver = TorchSpfSolver(device=DEVICE)
    tables = solver._device_arrays(csr)
    torch.cuda.synchronize()
    vp = tables["vp"]
    w_base = tables["base_nbr"].shape[1]
    ov_shape = tuple(tables["ov_nbr"].shape)
    log(f"[4] LSDB: {csr.num_nodes} nodes, {int(csr.num_edges)} directed "
        f"edges, vp {vp}, W {tables['base_nbr'].shape[1]}, overflow "
        f"{tuple(tables['ov_nbr'].shape)} with "
        f"{int((tables['ov_ids'] != vp - 1).sum().item())} live rows, "
        f"set-up {time.perf_counter() - t0:.1f} s")

    # ---- phase 3b: both designs at the main path's calls ---------------
    timing, worst_m = main_path_calls(relax, solver, ls, tables)

    # ---- phase 4: the main path, counts from 0 -----------------------------
    from torch.profiler import ProfilerActivity, profile

    relax.reset_launches()
    solver.solve(ls, "node-0")  # warm-up
    solve_ms = []
    for _ in range(5):
        t0 = time.perf_counter()
        solved = solver.solve(ls, "node-0")
        solve_ms.append((time.perf_counter() - t0) * 1e3)
    st = dict(solver.last_solve_stats)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        solver.solve(ls, "node-0")
        torch.cuda.synchronize()
    prof_st = dict(solver.last_solve_stats)
    k_us, k_n = kernel_device_us(prof, tuple(relax.KERNEL_NAMES.values()))
    solver.compute_routes(ls, ps, "node-0")  # warm-up
    rib_ms = []
    for _ in range(3):
        t0 = time.perf_counter()
        rdb = solver.compute_routes(ls, ps, "node-0")
        rib_ms.append((time.perf_counter() - t0) * 1e3)
    torch.cuda.synchronize()
    launches = dict(relax.LAUNCHES_BY_DESIGN)
    b = solved[1].device_tensor.shape[1]
    designs = path_designs(relax, tables, b)
    for d in designs:
        if launches[d] == 0:
            fail(f"the main path launched the {d} relax kernel no time")
    check_solve(csr, solved, rdb, cols=3, tag="100k")
    solve_p50 = statistics.median(solve_ms)
    rib_p50 = statistics.median(rib_ms)
    n_routes = len(rdb.unicast_routes)
    log(f"[4] solve p50 {solve_p50:.3f} ms (samples "
        f"{[round(x, 3) for x in solve_ms]}); full RIB p50 {rib_p50:.3f} ms "
        f"(samples {[round(x, 3) for x in rib_ms]}); routes {n_routes} "
        f"unicast + {len(rdb.mpls_routes)} mpls; routes/s "
        f"{n_routes / (rib_p50 / 1e3):.0f}")
    log(f"[4] per solve: sweeps {st['sweeps']}, tail rounds "
        f"{st['tail_rounds']}, spilled {st['spilled']}, host syncs "
        f"{st['host_syncs']}, relax launches {st['relax_launches']}")
    if k_n:
        log(f"[4] relax kernel on the main path (CUPTI, one profiled solve "
            f"of {prof_st['sweeps']} sweeps / {prof_st['tail_rounds']} tail "
            f"rounds): {k_n} launches, {k_us:.1f} us in all, "
            f"{k_us / k_n:.2f} us per launch")
    else:
        log("[4] relax kernel on the main path (CUPTI): not measured "
            "(the profiler saw no relax kernel)")
    log(f"[4] main-path relax launches by design (solves + RIBs): "
        f"{launches}; designs of its shapes {designs}; scipy root+2 "
        "neighbor columns and first hops: ok")
    hub_launches = phase4_hub(relax)

    # ---- phase 5: the link-flap warm path ------------------------------
    warm_launches = phase5_warm(relax, (vp, w_base, ov_shape))

    # ---- phase 6: overloads + LFA ----------------------------------------
    phase6()

    # ---- phase 7: the gather probe ---------------------------------------
    probe = phase7_probe(relax)

    d = timing["dense"]
    kernels = []
    for design, name, n_launch, worst in (
        ("vec", relax.KERNEL_NAMES["vec"], launches["vec"],
         max(worst_r["vec"], worst_m["vec"])),
        ("generic", relax.KERNEL_NAMES["generic"], hub_launches["generic"],
         max(worst_r["generic"], worst_m["generic"])),
    ):
        kernels.append({
            "name": name,
            "route": "cuda",
            "source": "openr_tpu_torch/csrc/relax.cu",
            "replaces": "openr_tpu/ops/spf_pallas.py:90",
            "launches": n_launch,
            "max_abs_err": worst,
            "ms": d[design]["us"] / 1e3,
            "plain_ms": d["plain_ms"],
            "bound_ms": d["bound_us"] / 1e3,
            "bound_by": d["bound_by"],
            "library_ms": None,
        })
    for design, fn, line in (("generic", "sweep_b1", 81),
                             ("vec", "sweep_b2", 102)):
        row = probe[fn]
        kernels.append({
            "name": f"{relax.KERNEL_NAMES[design]} (probe {fn})",
            "route": "cuda",
            "source": "openr_tpu_torch/csrc/relax.cu",
            "replaces": f"benchmarks/probe_pallas_gather.py:{line}",
            "launches": probe["launches"][design],
            "max_abs_err": row["max_abs_err"],
            "ms": row["us"] / 1e3,
            "plain_ms": probe["plain_ms"],
            "bound_ms": probe["bound_ms"],
            "bound_by": probe["bound_by"],
            "library_ms": None,
        })
    log(f"[5] warm-path relax launches by design: {warm_launches}")
    print(json.dumps({"kernels": kernels}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)


def phase6() -> None:
    """Overloaded nodes + LFA on a small WAN-like graph."""
    from dataclasses import replace

    from scipy.sparse import csr_matrix
    from scipy.sparse.csgraph import dijkstra

    from openr_tpu_torch.decision.linkstate import LinkState
    from openr_tpu_torch.decision.spf_backend import TorchSpfSolver
    from openr_tpu_torch.utils.topogen import wan_like

    adj, _pfx = wan_like(300, seed=5)
    over_names = {"node-3", "node-7", "node-120"}
    ls = LinkState()
    for db in adj:
        if db.this_node_name in over_names:
            db = replace(db, is_overloaded=True)
        ls.update_adjacency_db(db)
    me = "node-3"  # an overloaded root: its own out-edges stay usable
    solver = TorchSpfSolver(device=DEVICE, enable_lfa=True)
    csr, dist, fh, nbr_ids, lfa = solver.solve(ls, me)
    n = csr.num_nodes
    e = csr.num_edges
    my_id = csr.name_to_id[me]
    src, dst = csr.edge_src[:e], csr.edge_dst[:e]
    w = csr.edge_metric[:e].astype(np.float64)
    over = csr.node_overloaded[:n]

    def col(root):
        keep = ~over[src] | (src == root)  # overloaded: no transit
        g = csr_matrix((w[keep], (src[keep], dst[keep])), shape=(n, n))
        d = dijkstra(g, directed=True, indices=[root])[0]
        return np.where(np.isinf(d), INF, d).astype(np.int64)

    roots = [my_id] + list(nbr_ids)
    ref = np.stack([col(r) for r in roots])  # [1+N, n]
    got = np.asarray(dist)[:n, : len(roots)].T.astype(np.int64)
    if not np.array_equal(got, ref):
        fail("phase 6: distances disagree with scipy dijkstra")
    d_root, d_n = ref[0], ref[1:]
    met = np.array([min(x[1] for x in csr.details(my_id, j)) for j in nbr_ids])
    ids = np.arange(n)
    allowed = ~over[np.array(nbr_ids)][:, None] | (
        ids[None, :] == np.array(nbr_ids)[:, None]
    )
    reach = (d_root < INF)[None, :] & (d_n < INF)
    fh_ref = reach & (met[:, None] + d_n == d_root[None, :]) & allowed
    n_to_root = d_n[:, my_id]
    lfa_ref = (
        reach & (n_to_root < INF)[:, None]
        & (d_n < np.minimum(n_to_root[:, None] + d_root[None, :], INF))
        & allowed
    )
    k = len(nbr_ids)
    if not np.array_equal(fh[:k, :n], fh_ref):
        fail("phase 6: first-hop bits disagree with the recomputation")
    if not np.array_equal(lfa[:k, :n], lfa_ref):
        fail("phase 6: LFA bits disagree with the recomputation")
    if fh[k:].any() or lfa[k:].any():
        fail("phase 6: padding neighbor rows carry bits")
    log(f"[6] overloads+LFA: {n} nodes, {len(over_names)} overloaded "
        f"(root among them), {k} neighbors; fh bits {int(fh.sum())}, "
        f"lfa bits {int(lfa.sum())}: distances, fh and LFA exact")


if __name__ == "__main__":
    main()

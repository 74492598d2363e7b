#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one GPU: builds the hand
kernels from this checkout, holds each against its plain PyTorch
version, drives the cold single-root RIB solve at full size and checks
its answers.

    python3 chip_smoke.py

Phases (any failure exits non-zero and prints no result line):

  1. device: requires CUDA; prints the card's name and power limit;
  2. build: compiles csrc/relax.cu with nvcc and times the build;
  3. kernel vs plain on the card, exact int32 equality: random tables
     (dense row0 chunks, dst_rows with dead-slot repeats, src_rows
     indirection, overload mask on/off, INF padding, B in {8, 32, 64}),
     then the main path's own calls on the 100k-node tables;
  4. main path: `erdos_renyi_lsdb(100_000, avg_degree=20, seed=0,
     max_metric=64)` through `TorchSpfSolver(device="cuda")`, solve and
     compute_routes, root and two neighbor columns checked against
     scipy's Dijkstra and the first hops against a NumPy recomputation;
  5. overloads + LFA on a small graph, the packed first-hop and LFA bits
     checked against a NumPy recomputation from scipy distances.

The line before the card's name is a JSON object `{"kernels": [...]}`;
the last line is `{"ok": true, "device": {...}}`.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

HBM_BYTES_PER_S = 3.35e12  # H100 SXM HBM3, data sheet
INT32_OPS_PER_S = 67e12  # non-tensor-core 32-bit rate (fp32 peak), data sheet
INF = 1 << 30


def fail(msg: str) -> None:
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def log(msg: str) -> None:
    print(msg, flush=True)


def cuda_ms(fn, reps: int = 20) -> float:
    """Mean device ms of `fn()` over `reps` calls, after a warm-up."""
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


# ---------------------------------------------------------------- phase 3


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


def compare(relax, dist, out0, nbr, wgt, roots, over, **kw):
    """Kernel and plain version on the same inputs; returns max |diff|
    (0 required) over dist and the changed count."""
    outs = []
    for fn in (relax.relax_rows, relax.relax_rows_ref):
        out = out0.clone()
        ch = torch.zeros(1, dtype=torch.int32, device=dist.device)
        fn(dist, out, nbr, wgt, roots, over, changed=ch, **kw)
        outs.append((out, ch))
    torch.cuda.synchronize()
    err = int((outs[0][0].long() - outs[1][0].long()).abs().max().item())
    err = max(err, abs(int(outs[0][1].item()) - int(outs[1][1].item())))
    return err


def phase3_random(relax, dev) -> tuple[int, int]:
    g = torch.Generator().manual_seed(20261016)
    worst, cases = 0, 0
    for b in (8, 32, 64):
        for with_over in (False, True):
            vp, r, w = 4096, 4096, 32
            dist, nbr, wgt, roots, over = random_case(
                g, vp, b, r, w, with_over, dev
            )
            # dense row0 chunks, in place (out is dist), one per quarter
            for c in range(4):
                worst = max(worst, compare(
                    relax, dist, dist, nbr, wgt, roots, over,
                    row0=c * (r // 4), n=r // 4,
                ))
                cases += 1
            # Jacobi sweep into a separate out (the Pallas kernel's form)
            worst = max(worst, compare(
                relax, dist, dist.clone(), nbr, wgt, roots, over, row0=0
            ))
            # dst_rows with repeats of the dead slot (overflow table form)
            ro = 256
            dst = torch.randint(0, vp, (ro,), generator=g, dtype=torch.int32)
            dst[ro // 2 :] = vp - 1
            worst = max(worst, compare(
                relax, dist, dist, nbr[:ro].contiguous(),
                wgt[:ro].contiguous(), roots,
                None if over is None else over[:ro].contiguous(),
                dst_rows=dst.to(dev),
            ))
            # src_rows == dst_rows indirection (compacted tail form)
            rows = torch.randint(0, vp, (1024,), generator=g, dtype=torch.int32)
            rows[700:] = vp - 1
            rows = rows.to(dev)
            worst = max(worst, compare(
                relax, dist, dist, nbr, wgt, roots, over,
                src_rows=rows, dst_rows=rows,
            ))
            cases += 3
    return worst, cases


def relax_bytes(w, kind, n, b, dist_rows_read):
    """Bytes one relax call must move: the n table rows (nbr + wgt), each
    distinct gathered dist row once, the n target rows read and written,
    roots and the row-index lists."""
    bytes_ = n * w * 8 + dist_rows_read * b * 4 + 2 * n * b * 4 + b * 4
    if kind != "dense":
        bytes_ += n * 4 * (2 if kind == "tail" else 1)
    return bytes_


# ------------------------------------------------------------------ main


def main() -> None:
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this smoke run needs a GPU")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    card = smi.stdout.strip().splitlines()[0] if smi.stdout.strip() else ""
    if smi.returncode != 0 or not card:
        fail(f"nvidia-smi failed: {smi.stderr.strip()}")
    dev = torch.device("cuda")
    log(f"[1] device: {card}; torch {torch.__version__} cuda "
        f"{torch.version.cuda}; count {torch.cuda.device_count()}")

    # ---- phase 2: build ------------------------------------------------
    from openr_tpu_torch.ops import cuda_build, relax

    t0 = time.perf_counter()
    relax.build()
    log(f"[2] build: relax.cu in {time.perf_counter() - t0:.3f} s "
        f"(nvcc {cuda_build.BUILD_SECONDS.get('relax', 0.0):.3f} s)")

    # ---- phase 3a: kernel vs plain on random tables ----------------------
    worst, cases = phase3_random(relax, dev)
    log(f"[3] kernel vs plain, random tables: {cases} cases, "
        f"max |diff| {worst}")
    if worst != 0:
        fail(f"relax kernel disagrees with relax_rows_ref ({worst})")

    # ---- phase 4 set-up: the 100k LSDB and its device tables -------------
    from openr_tpu_torch.decision.spf_backend import TorchSpfSolver
    from openr_tpu_torch.ops.spf_split import pick_gs_chunks
    from openr_tpu_torch.utils.topogen import erdos_renyi_lsdb

    t0 = time.perf_counter()
    ls, ps, csr = erdos_renyi_lsdb(
        100_000, avg_degree=20, seed=0, max_metric=64
    )
    solver = TorchSpfSolver(device="cuda")
    tables = solver._device_arrays(csr)
    torch.cuda.synchronize()
    vp = tables["vp"]
    n_edges = int(csr.num_edges)
    log(f"[4] LSDB: {csr.num_nodes} nodes, {n_edges} directed edges, "
        f"vp {vp}, W {tables['base_nbr'].shape[1]}, overflow rows "
        f"{int((tables['ov_ids'] != vp - 1).sum().item())}, set-up "
        f"{time.perf_counter() - t0:.1f} s")

    # ---- phase 3b: the main path's own calls, at its shapes --------------
    first = solver.solve(ls, "node-0")
    dist_final = first[1].device_tensor
    b = dist_final.shape[1]
    g = torch.Generator(device="cuda").manual_seed(7)
    bump = torch.randint(0, 200, dist_final.shape, generator=g,
                         device="cuda", dtype=torch.int32)
    dist_in = torch.clamp_max(dist_final + bump, INF).contiguous()
    roots = torch.tensor(
        [0] + list(first[3]) + [0] * (b - 1 - len(first[3])),
        dtype=torch.int32, device="cuda",
    )
    gs = pick_gs_chunks(vp)
    csz = vp // gs
    rows = torch.unique(
        torch.randint(0, vp - 1, (8192,), generator=g, device="cuda")
    ).to(torch.int32)
    rows = torch.cat([rows, torch.full((8192 - rows.numel(),), vp - 1,
                                       dtype=torch.int32, device="cuda")])
    calls = {
        "dense": dict(nbr=tables["base_nbr"], wgt=tables["base_wgt"],
                      kw=dict(row0=vp - csz, n=csz)),
        "ov": dict(nbr=tables["ov_nbr"], wgt=tables["ov_wgt"],
                   kw=dict(dst_rows=tables["ov_ids"])),
        "tail": dict(nbr=tables["base_nbr"], wgt=tables["base_wgt"],
                     kw=dict(src_rows=rows, dst_rows=rows)),
    }
    main_err = 0
    timing = {}
    for kind, c in calls.items():
        main_err = max(main_err, compare(
            relax, dist_in, dist_in, c["nbr"], c["wgt"], roots, None,
            **c["kw"],
        ))
        scratch = dist_in.clone()
        k_ms = cuda_ms(lambda: relax.relax_rows(
            dist_in, scratch, c["nbr"], c["wgt"], roots, None, **c["kw"]))
        p_ms = cuda_ms(lambda: relax.relax_rows_ref(
            dist_in, scratch, c["nbr"], c["wgt"], roots, None, **c["kw"]),
            reps=5)
        n = c["kw"].get("n") or next(
            v.shape[0] for k, v in c["kw"].items() if k.endswith("rows"))
        if "src_rows" in c["kw"]:
            sel = c["nbr"][c["kw"]["src_rows"].long()]
            swgt = c["wgt"][c["kw"]["src_rows"].long()]
        else:
            r0 = c["kw"].get("row0", 0)
            sel, swgt = c["nbr"][r0:r0 + n], c["wgt"][r0:r0 + n]
        valid = swgt < INF
        distinct = int(torch.unique(sel[valid]).numel())
        nbytes = relax_bytes(c["nbr"].shape[1], kind, n, b, distinct)
        t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
        ops = int(valid.sum().item()) * b * 4
        t_ops = ops / INT32_OPS_PER_S * 1e3
        timing[kind] = dict(
            ms=k_ms, plain_ms=p_ms, bound_ms=max(t_bytes, t_ops),
            bound_by="bytes" if t_bytes >= t_ops else "operations",
            bytes=nbytes, ops=ops, n=n,
        )
        log(f"[3] main-path call {kind}: n={n} B={b} kernel {k_ms:.4f} ms, "
            f"plain {p_ms:.4f} ms, bound {max(t_bytes, t_ops):.4f} ms "
            f"({nbytes} B, {ops} int ops)")
    log(f"[3] kernel vs plain at main-path shapes: max |diff| {main_err}")
    if main_err != 0:
        fail(f"relax kernel disagrees at main-path shapes ({main_err})")

    # ---- phase 4: the main path, counts from 0 -----------------------------
    relax.reset_launches()
    t0 = time.perf_counter()
    solver.solve(ls, "node-0")  # warm-up
    solve_ms = []
    for _ in range(5):
        t0 = time.perf_counter()
        solved = solver.solve(ls, "node-0")
        solve_ms.append((time.perf_counter() - t0) * 1e3)
    st = dict(solver.last_solve_stats)
    with relax.profile_launches() as events:
        solver.solve(ls, "node-0")
    torch.cuda.synchronize()
    per_launch_us = [a.elapsed_time(z) * 1e3 for a, z in events]
    if not per_launch_us:
        fail("the profiled solve recorded no relax launch")
    solver.compute_routes(ls, ps, "node-0")  # warm-up
    rib_ms = []
    for _ in range(3):
        t0 = time.perf_counter()
        rdb = solver.compute_routes(ls, ps, "node-0")
        rib_ms.append((time.perf_counter() - t0) * 1e3)
    torch.cuda.synchronize()
    launches = relax.LAUNCHES
    if launches == 0:
        fail("the main path launched the relax kernel no time")

    csr_, dist, fh, nbr_ids, _lfa = solved
    n_live = csr.num_nodes
    check_cols = [0, 1, 2]
    src_ids = [0] + [nbr_ids[0], nbr_ids[1]]
    from scipy.sparse import csr_matrix
    from scipy.sparse.csgraph import dijkstra

    e = n_edges
    graph = csr_matrix(
        (csr.edge_metric[:e].astype(np.float64),
         (csr.edge_src[:e], csr.edge_dst[:e])),
        shape=(n_live, n_live),
    )
    ref = dijkstra(graph, directed=True, indices=src_ids)
    ref = np.where(np.isinf(ref), INF, ref).astype(np.int64)
    got = np.asarray(dist)[:n_live][:, check_cols].T.astype(np.int64)
    if not np.array_equal(got, ref):
        bad = int((got != ref).sum())
        fail(f"100k solve disagrees with scipy dijkstra at {bad} entries")
    d_root, d_n = ref[0], ref[1:]
    met = np.array(
        [min(x[1] for x in csr.details(0, j)) for j in src_ids[1:]]
    )
    fh_ref = (d_root < INF)[None, :] & (d_n < INF) & (
        met[:, None] + d_n == d_root[None, :]
    )
    if not np.array_equal(fh[:2, :n_live], fh_ref):
        fail("first-hop bits disagree with the NumPy recomputation")
    n_routes = len(rdb.unicast_routes)
    if n_routes != n_live - 1:
        fail(f"{n_routes} unicast routes, expected {n_live - 1}")
    solve_p50 = statistics.median(solve_ms)
    rib_p50 = statistics.median(rib_ms)
    mean_us = statistics.fmean(per_launch_us)
    log(f"[4] solve p50 {solve_p50:.3f} ms (samples "
        f"{[round(x, 3) for x in solve_ms]}); full RIB p50 {rib_p50:.3f} ms "
        f"(samples {[round(x, 3) for x in rib_ms]}); routes {n_routes} "
        f"unicast + {len(rdb.mpls_routes)} mpls; routes/s "
        f"{n_routes / (rib_p50 / 1e3):.0f}")
    log(f"[4] per solve: sweeps {st['sweeps']}, tail rounds "
        f"{st['tail_rounds']}, spilled {st['spilled']}, host syncs "
        f"{st['host_syncs']}, relax launches {st['relax_launches']}; "
        f"relax kernel {mean_us:.2f} us per launch over "
        f"{len(per_launch_us)} launches (sum {sum(per_launch_us):.1f} us)")
    log(f"[4] main-path relax launches (all solves + RIBs): {launches}; "
        "scipy root+2 neighbor columns and first hops: ok")

    # ---- phase 5: overloads + LFA ----------------------------------------
    phase5()

    d = timing["dense"]
    kernels = [{
        "name": "relax_rows",
        "route": "cuda",
        "source": "openr_tpu_torch/csrc/relax.cu",
        "replaces": "openr_tpu/ops/spf_pallas.py:90",
        "launches": launches,
        "max_abs_err": max(worst, main_err),
        "ms": d["ms"],
        "plain_ms": d["plain_ms"],
        "bound_ms": d["bound_ms"],
        "bound_by": d["bound_by"],
        "library_ms": None,
    }]
    print(json.dumps({"kernels": kernels}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)


def phase5() -> None:
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
    solver = TorchSpfSolver(device="cuda", enable_lfa=True)
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
        fail("phase 5: distances disagree with scipy dijkstra")
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
        fail("phase 5: first-hop bits disagree with the recomputation")
    if not np.array_equal(lfa[:k, :n], lfa_ref):
        fail("phase 5: LFA bits disagree with the recomputation")
    if fh[k:].any() or lfa[k:].any():
        fail("phase 5: padding neighbor rows carry bits")
    log(f"[5] overloads+LFA: {n} nodes, {len(over_names)} overloaded "
        f"(root among them), {k} neighbors; fh bits {int(fh.sum())}, "
        f"lfa bits {int(lfa.sum())}: distances, fh and LFA exact")


if __name__ == "__main__":
    main()

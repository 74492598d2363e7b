"""The relax-sweep gather probe on the card: the port's counterpart of
`benchmarks/probe_pallas_gather.py`, which asks which gather formulation
reads one Jacobi relax sweep fastest,

    out = min(dist, min_d (dist[nbr[:, d]] + wgt[:, d]))

at VP 131 072 rows, D 64 slots and B 32 columns, all int32, with random
`nbr` in [0, VP), `wgt` in [1, 64) and `dist` below 2^20 (no INF, no
overloads, so the kernel's INF guard changes nothing).

The probe's two TPU formulations have Hopper counterparts in the port's
two relax designs (`csrc/relax.cu`):

  * `sweep_b1`, the d-loop of one [VP, B] gather per slot, is
    `relax_generic_kernel`: a warp per row, lanes over B, the slots
    walked one by one;
  * `sweep_b2`, four slots packed into one 128-lane gather, is
    `relax_vec_kernel<64, 32>`: B/4 = 8 lanes per dist row with 16-byte
    loads, so one warp load serves 4 slots.

`sweep_torch_ops` stands where the probe's XLA row stands: the sweep as
plain torch ops over the [VP, D, B] gather. No single PyTorch call
computes a min-plus gather-relax.

    python3 -m openr_tpu_torch.probe_gather            # on the card
    python3 -m openr_tpu_torch.probe_gather --device cpu --vp 4096

prints, per variant, the device time (CUPTI for the kernels, CUDA events
for the torch ops), the effective GB/s counted as the probe counts it
(VP·D·B·4 logical gathered bytes) and `ok` or `WRONG` against the
probe's check sum.
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from openr_tpu_torch.common.constants import DIST_INF
from openr_tpu_torch.ops import relax

VP = 131_072
D = 64
B = 32


def make_inputs(vp: int = VP, d: int = D, b: int = B, seed: int = 0,
                device="cpu"):
    """(nbr, wgt, dist) int32 tensors on `device`, drawn with numpy from
    `default_rng(seed)` in the probe's order: dist, nbr, wgt."""
    rng = np.random.default_rng(seed)
    dist = rng.integers(0, 1 << 20, size=(vp, b), dtype=np.int32)
    nbr = rng.integers(0, vp, size=(vp, d), dtype=np.int32)
    wgt = rng.integers(1, 64, size=(vp, d), dtype=np.int32)
    return tuple(torch.from_numpy(x).to(device) for x in (nbr, wgt, dist))


def _roots(dist):
    # no overload mask: the roots are never read
    return torch.zeros(dist.shape[1], dtype=torch.int32, device=dist.device)


def sweep_b1(nbr, wgt, dist):
    """The probe's B1 on the generic relax kernel (the plain version on
    CPU tensors)."""
    out = dist.clone()
    relax.relax_rows_generic(dist, out, nbr, wgt, _roots(dist), row0=0)
    return out


def sweep_b2(nbr, wgt, dist):
    """The probe's B2 on the vectorised relax kernel; its shape must be
    one the specialisation table holds."""
    w, b = nbr.shape[1], dist.shape[1]
    if relax.design_for(w, b) != "vec":
        raise ValueError(f"sweep_b2: no vectorised kernel for W={w}, B={b}")
    out = dist.clone()
    relax.relax_rows(dist, out, nbr, wgt, _roots(dist), row0=0)
    return out


def sweep_ref(nbr, wgt, dist):
    """The plain PyTorch version of the sweep (`relax_rows_ref`)."""
    out = dist.clone()
    relax.relax_rows_ref(dist, out, nbr, wgt, _roots(dist), row0=0)
    return out


def sweep_torch_ops(nbr, wgt, dist):
    """The sweep as torch ops over the full [VP, D, B] gather."""
    cand = (dist[nbr.long()] + wgt[..., None]).clamp_max(DIST_INF)
    return torch.minimum(cand.amin(1), dist)


def _wrap32(v: int) -> int:
    return (v + (1 << 31)) % (1 << 32) - (1 << 31)


def ref_sum(nbr, wgt, dist) -> int:
    """The probe's check: the int32-wrapped sum of the reference sweep,
    computed with numpy on the host, one slot at a time."""
    nbr, wgt, dist = (x.cpu().numpy() for x in (nbr, wgt, dist))
    acc = dist.copy()
    for d in range(nbr.shape[1]):
        np.minimum(acc, dist[nbr[:, d]] + wgt[:, d, None], out=acc)
    return _wrap32(int(acc.astype(np.int64).sum()))


def out_sum(out) -> int:
    return _wrap32(int(out.to(torch.int64).sum().item()))


def _cupti_us(fn, name: str, reps: int) -> float:
    """Mean CUPTI duration (µs) of the kernel whose name holds `name`
    over the launches the profiler kept of `reps` calls of `fn`."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    us, count = 0.0, 0
    for ev in prof.key_averages():
        if str(getattr(ev, "device_type", "")).endswith("CPU"):
            continue
        if name not in ev.key:
            continue
        t = getattr(ev, "self_device_time_total", None)
        us += t if t is not None else getattr(ev, "self_cuda_time_total", 0.0)
        count += ev.count
    if count == 0:
        raise RuntimeError(f"CUPTI saw no launch of {name}")
    return us / count


def _event_us(fn, reps: int) -> float:
    """Mean µs per call of `fn` between two CUDA events, after a
    warm-up."""
    fn()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(reps):
        fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) * 1e3 / reps


#: name, sweep, kernel name as the profiler shows it (None: torch ops)
VARIANTS = (
    ("B1 d-loop (relax_generic_kernel)", sweep_b1,
     relax.KERNEL_NAMES["generic"]),
    ("B2 packed x4 (relax_vec_kernel<64,32>)", sweep_b2,
     relax.KERNEL_NAMES["vec"]),
    ("X  torch-ops sweep", sweep_torch_ops, None),
    ("plain version (relax_rows_ref)", sweep_ref, None),
)


def measure(device="cuda", vp: int = VP, reps: int = 20) -> dict:
    """Every variant at (vp, D, B) on `device`: {name: {"us", "gbs",
    "sum_ok", "max_abs_err"}}, the error against `sweep_ref`'s output.
    Device times are None on the CPU."""
    dev = torch.device(device)
    nbr, wgt, dist = make_inputs(vp, D, B, 0, dev)
    want_sum = ref_sum(nbr, wgt, dist)
    ref = sweep_ref(nbr, wgt, dist)
    gb = vp * D * B * 4 / 1e9  # the probe's logical gathered bytes
    res = {}
    for name, fn, kernel in VARIANTS:
        out = fn(nbr, wgt, dist)
        err = int((out.to(torch.int64) - ref.to(torch.int64)).abs().max())
        row = {"sum_ok": out_sum(out) == want_sum, "max_abs_err": err,
               "us": None, "gbs": None}
        del out
        if dev.type == "cuda":
            def call(fn=fn):
                fn(nbr, wgt, dist)
            row["us"] = (_cupti_us(call, kernel, reps) if kernel
                         else _event_us(call, max(1, reps // 4)))
            row["gbs"] = gb / (row["us"] * 1e-6)
        res[name] = row
    return res


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu (the plain versions)")
    ap.add_argument("--vp", type=int, default=VP,
                    help=f"rows (default {VP}, the probe's)")
    ap.add_argument("--reps", type=int, default=20)
    args = ap.parse_args(argv)
    dev = torch.device(args.device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "probe_gather runs on CUDA by default and no CUDA device is "
            "available; pass --device cpu to run the plain versions"
        )
    name = (torch.cuda.get_device_name(dev) if dev.type == "cuda"
            else "cpu")
    print(f"# device: {name}  VP={args.vp} D={D} B={B}", flush=True)
    t0 = time.perf_counter()
    res = measure(dev, args.vp, args.reps)
    bad = 0
    for vname, row in res.items():
        tag = "ok" if row["sum_ok"] and row["max_abs_err"] == 0 else (
            f"WRONG (sum {'ok' if row['sum_ok'] else 'differs'}, max |diff| "
            f"vs plain {row['max_abs_err']})"
        )
        bad += tag != "ok"
        if row["us"] is None:
            timing = "device time not measured (cpu)"
        else:
            timing = f"{row['us']:9.2f} us ({row['gbs']:7.0f} GB/s eff)"
        print(f"  {vname}: {timing}  [{tag}]", flush=True)
    print(f"# {time.perf_counter() - t0:.1f} s", flush=True)
    return 1 if bad else 0


if __name__ == "__main__":
    raise SystemExit(main())

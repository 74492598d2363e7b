"""`openr_tpu_torch.probe_gather`, the port of the relax-sweep gather
probe `benchmarks/probe_pallas_gather.py`: its two sweeps (the plain
version on CPU tensors) equal the probe's reference expression and the
JAX package's Pallas relax kernel in interpret mode, and its inputs are
the probe's draws.

The probe module itself cannot be imported here: it draws and solves at
VP 131 072 and benchmarks on the TPU at import time. Its reference
expression (`probe_pallas_gather.py:44-49`) and its draws (`:36-39`)
are copied below instead."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from openr_tpu.ops.spf_pallas import _relax_once
from openr_tpu_torch import probe_gather as pg

# one intra-op thread: the suite runs several test workers at once
torch.set_num_threads(1)

VP_SMALL = 512


def _probe_ref(nbr_h, wgt_h, dist_h):
    """`probe_pallas_gather.py:44-49`, at any VP."""
    vp, d = nbr_h.shape
    b = dist_h.shape[1]
    ref = np.minimum(
        (dist_h[nbr_h.reshape(-1)].reshape(vp, d, b).astype(np.int64)
         + wgt_h[:, :, None]).min(axis=1),
        dist_h,
    ).astype(np.int32)
    ref_sum = int(np.int64(ref.astype(np.int64).sum() & 0xFFFFFFFF)
                  .astype(np.int32))
    return ref, ref_sum


SWEEPS = {"b1": pg.sweep_b1, "b2": pg.sweep_b2, "ref": pg.sweep_ref,
          "torch_ops": pg.sweep_torch_ops}


@pytest.mark.parametrize("sweep", sorted(SWEEPS))
def test_sweeps_equal_the_probe_reference(sweep):
    nbr, wgt, dist = pg.make_inputs(VP_SMALL, pg.D, pg.B, 0, "cpu")
    ref, ref_sum = _probe_ref(nbr.numpy(), wgt.numpy(), dist.numpy())
    out = SWEEPS[sweep](nbr, wgt, dist)
    np.testing.assert_array_equal(out.numpy(), ref)
    assert pg.out_sum(out) == ref_sum == pg.ref_sum(nbr, wgt, dist)


@pytest.mark.parametrize("sweep", ["b1", "b2"])
def test_sweeps_equal_pallas_relax_interpret(sweep):
    nbr, wgt, dist = pg.make_inputs(VP_SMALL, pg.D, pg.B, 0, "cpu")
    want, _changed = _relax_once(
        jnp.asarray(nbr.numpy()), jnp.asarray(wgt.numpy()),
        jnp.zeros((VP_SMALL, pg.D), bool), jnp.zeros(pg.B, jnp.int32),
        jnp.asarray(dist.numpy()), 128, False, True,
    )
    np.testing.assert_array_equal(
        SWEEPS[sweep](nbr, wgt, dist).numpy(), np.asarray(want)
    )


def test_make_inputs_reproduces_the_probe_draws():
    rng = np.random.default_rng(0)  # probe_pallas_gather.py:36-39
    dist_h = rng.integers(0, 1 << 20, size=(pg.VP, pg.B), dtype=np.int32)
    nbr_h = rng.integers(0, pg.VP, size=(pg.VP, pg.D), dtype=np.int32)
    wgt_h = rng.integers(1, 64, size=(pg.VP, pg.D), dtype=np.int32)
    nbr, wgt, dist = pg.make_inputs()
    for got, want in ((nbr, nbr_h), (wgt, wgt_h), (dist, dist_h)):
        assert got.dtype == torch.int32 and tuple(got.shape) == want.shape
        assert int(got.to(torch.int64).sum()) == int(want.astype(np.int64)
                                                     .sum())


def test_sweep_b2_needs_a_vectorised_shape():
    nbr, wgt, dist = pg.make_inputs(64, 12, pg.B, 0, "cpu")
    with pytest.raises(ValueError, match="vectorised"):
        pg.sweep_b2(nbr, wgt, dist)


def test_main_needs_cuda_unless_cpu_is_asked(monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        pg.main([])
    assert pg.main(["--device", "cpu", "--vp", str(VP_SMALL)]) == 0
    out = capsys.readouterr().out
    assert out.count("[ok]") == len(pg.VARIANTS)
    assert "not measured" in out and "WRONG" not in out

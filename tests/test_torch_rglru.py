"""B7's plain version (the step-by-step RG-LRU recurrence) against the JAX
package's oracle ``rglru_naive`` and its Pallas kernel in interpret mode,
at the shapes of ``tests/test_kernels.py`` and at a model-like width, and
the wrapper's CPU contract.  The Hopper kernel runs only on the card
(``chip_smoke.py`` phase 12 holds it against the plain version there).

Tolerance: rtol = atol = 1e-5, the reference's own bar
(``tests/test_kernels.py``): float32 steps in the same order, exp rounded
differently in the last bit.
"""
from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.rglru import rglru as ref_rglru
from repro.kernels.rglru import rglru_naive as ref_rglru_naive
from repro_torch.kernels.rglru import rglru, rglru_cuda

TOL = 1e-5
CASES = [(2, 64, 32, 16), (1, 100, 8, 32), (3, 33, 16, 8), (2, 130, 256, 128)]


def _inputs(B, L, W, seed):
    rng = np.random.default_rng(seed)
    la = -rng.uniform(0.01, 2.0, (B, L, W)).astype(np.float32)
    gx = rng.normal(size=(B, L, W)).astype(np.float32)
    return la, gx


@pytest.mark.parametrize("route", ["oracle", "pallas"])
@pytest.mark.parametrize("B,L,W,chunk", CASES)
def test_plain_version_matches_reference(route, B, L, W, chunk):
    la, gx = _inputs(B, L, W, B * L + W)
    if route == "oracle":
        want_h, want_t = ref_rglru_naive(jnp.asarray(la), jnp.asarray(gx))
    else:
        want_h, want_t = ref_rglru(jnp.asarray(la), jnp.asarray(gx), chunk=chunk,
                                   impl="pallas", interpret=True)
    got_h, got_t = rglru(torch.tensor(la), torch.tensor(gx))
    assert got_h.dtype == torch.float32 and got_h.shape == (B, L, W)
    np.testing.assert_allclose(got_h.numpy(), np.asarray(want_h), rtol=TOL, atol=TOL)
    np.testing.assert_allclose(got_t.numpy(), np.asarray(want_t), rtol=TOL, atol=TOL)


def test_cpu_tensors_take_the_plain_version_and_the_kernel_refuses_them():
    la, gx = _inputs(1, 8, 4, 0)
    before = rglru_cuda.launches
    rglru(torch.tensor(la), torch.tensor(gx))
    assert rglru_cuda.launches == before
    with pytest.raises(ValueError, match="CUDA"):
        rglru_cuda(torch.tensor(la), torch.tensor(gx))
    assert rglru_cuda.launches == before


# ---- the entry on other dtypes (ROADMAP C8) ------------------------------- #
# The reference's default route casts both operands to float32 and returns
# float32; its ``impl="xla"`` route keeps the input type and rounds every
# step to it, so there the bar is that rounding: L steps of one unit of the
# type at the largest |h|.  (float64 is float32 to the reference, whose
# JAX runs without 64-bit types.)
@pytest.mark.parametrize("route", ["pallas", "xla"])
@pytest.mark.parametrize("dtype", ["bfloat16", "float16", "float64"])
def test_entry_casts_other_dtypes_to_float32(route, dtype):
    la, gx = _inputs(2, 40, 16, 0)
    tdt, jdt = getattr(torch, dtype), jnp.dtype(dtype)
    tla, tgx = torch.tensor(la).to(tdt), torch.tensor(gx).to(tdt)
    jla = jnp.asarray(tla.float().numpy()).astype(jdt)
    jgx = jnp.asarray(tgx.float().numpy()).astype(jdt)
    kw = dict(impl="pallas", interpret=True) if route == "pallas" else dict(impl="xla")
    want_h, want_t = (np.asarray(x, np.float32) for x in ref_rglru(jla, jgx, **kw))
    got_h, got_t = rglru(tla, tgx)
    assert got_h.dtype == torch.float32 and got_t.dtype == torch.float32
    tol = TOL
    if route == "xla" and dtype != "float64":
        tol = 40 * float(torch.finfo(tdt).eps) * float(np.abs(want_h).max())
    np.testing.assert_allclose(got_h.numpy(), want_h, rtol=tol, atol=tol)
    np.testing.assert_allclose(got_t.numpy(), want_t, rtol=tol, atol=tol)

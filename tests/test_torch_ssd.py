"""B6's plain version (the chunked SSD scan, ``ssd_chunked``'s algorithm)
against the JAX package's oracle ``ssd_naive`` and its Pallas kernel in
interpret mode, at the shapes of ``tests/test_kernels.py`` and at mamba2's
head shape (P 64, N 128, chunk 256) with L not a multiple of the chunk,
and the wrapper's CPU contract.  The Hopper kernel runs only on the card
(``chip_smoke.py`` phase 12).

Tolerance: rtol = atol = 3e-4, the reference's own bar
(``tests/test_kernels.py``): the chunked and step-by-step forms sum in
different orders.
"""
from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.ssd import ssd as ref_ssd
from repro.kernels.ssd import ssd_naive as ref_ssd_naive
from repro_torch.kernels.ssd import ssd, ssd_cuda, ssd_naive, ssd_ref

TOL = 3e-4
CASES = [(2, 64, 3, 8, 16, 16), (1, 100, 2, 16, 8, 32), (2, 32, 1, 4, 4, 8),
         (1, 300, 2, 64, 128, 256)]


def _inputs(B, L, H, P, N, seed):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(B, L, H, P)).astype(np.float32),
            rng.uniform(0.001, 0.1, (B, L, H)).astype(np.float32),
            -rng.uniform(0.5, 2.0, (H,)).astype(np.float32),
            rng.normal(size=(B, L, N)).astype(np.float32),
            rng.normal(size=(B, L, N)).astype(np.float32))


@pytest.mark.parametrize("route", ["oracle", "pallas"])
@pytest.mark.parametrize("B,L,H,P,N,chunk", CASES)
def test_plain_version_matches_reference(route, B, L, H, P, N, chunk):
    args = _inputs(B, L, H, P, N, L + P)
    jargs = [jnp.asarray(a) for a in args]
    if route == "oracle":
        want_y, want_h = ref_ssd_naive(*jargs)
    else:
        want_y, want_h = ref_ssd(*jargs, chunk=chunk, impl="pallas", interpret=True)
    got_y, got_h = ssd(*(torch.tensor(a) for a in args), chunk=chunk)
    assert got_y.shape == (B, L, H, P) and got_h.shape == (B, H, P, N)
    np.testing.assert_allclose(got_y.numpy(), np.asarray(want_y), rtol=TOL, atol=TOL)
    np.testing.assert_allclose(got_h.numpy(), np.asarray(want_h), rtol=TOL, atol=TOL)


@pytest.mark.parametrize("B,L,H,P,N,chunk", CASES[:2])
def test_naive_copy_matches_reference_naive(B, L, H, P, N, chunk):
    args = _inputs(B, L, H, P, N, 11)
    want_y, want_h = ref_ssd_naive(*(jnp.asarray(a) for a in args))
    got_y, got_h = ssd_naive(*(torch.tensor(a) for a in args))
    np.testing.assert_allclose(got_y.numpy(), np.asarray(want_y), rtol=TOL, atol=TOL)
    np.testing.assert_allclose(got_h.numpy(), np.asarray(want_h), rtol=TOL, atol=TOL)


def test_bf16_inputs_round_y_once():
    x, dt, A, B_, C_ = (torch.tensor(a) for a in _inputs(1, 40, 2, 16, 8, 5))
    xb, Bb, Cb = x.to(torch.bfloat16), B_.to(torch.bfloat16), C_.to(torch.bfloat16)
    y, h = ssd_ref(xb, dt, A, Bb, Cb, 16)
    y32, h32 = ssd_ref(xb.float(), dt, A, Bb.float(), Cb.float(), 16)
    assert y.dtype == torch.bfloat16 and h.dtype == torch.float32
    assert torch.equal(y, y32.to(torch.bfloat16)) and torch.equal(h, h32)


def test_cpu_tensors_take_the_plain_version_and_the_kernel_refuses_them():
    args = [torch.tensor(a) for a in _inputs(1, 8, 2, 64, 128, 0)]
    before = ssd_cuda.launches
    ssd(*args, chunk=4)
    assert ssd_cuda.launches == before
    with pytest.raises(ValueError, match="CUDA"):
        ssd_cuda(*args)
    assert ssd_cuda.launches == before

"""B5's plain version (dense masked softmax in float32) against the JAX
package's oracle ``flash_attention_ref`` (``impl="xla"``) and its Pallas
kernel in interpret mode, at the shapes of ``tests/test_kernels.py`` and at
recurrentgemma's head shape (hd 256, 10 query heads on one KV head, a
window shorter than the sequence), and the wrapper's CPU contract.  The
Hopper kernel runs only on the card (``chip_smoke.py`` phase 12).

Tolerances are the reference's own (``tests/test_kernels.py``): float32
within rtol = atol = 2e-4 (sums in another order), bf16 within 3e-2.
"""
from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention import flash_attention as ref_flash
from repro_torch.kernels.flash_attention import (attention_mask, flash_attention,
                                                 flash_attention_cuda)

CASES = [(2, 128, 4, 2, 32, True, None, 32, 32),
         (1, 256, 8, 8, 16, True, 64, 64, 64),
         (2, 64, 4, 1, 32, False, None, 32, 16),
         (1, 128, 2, 2, 64, True, 32, 32, 32),
         (1, 128, 6, 3, 16, True, None, 64, 32),
         (1, 256, 10, 1, 256, True, 96, 128, 128)]


def _qkv(B, S, H, Hkv, hd, seed, dtype=np.float32):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(B, S, H, hd)).astype(dtype),
            rng.normal(size=(B, S, Hkv, hd)).astype(dtype),
            rng.normal(size=(B, S, Hkv, hd)).astype(dtype))


@pytest.mark.parametrize("route", ["xla", "pallas"])
@pytest.mark.parametrize("B,S,H,Hkv,hd,causal,window,bq,bk", CASES)
def test_plain_version_matches_reference(route, B, S, H, Hkv, hd, causal, window, bq, bk):
    q, k, v = _qkv(B, S, H, Hkv, hd, S + H + hd)
    kw = dict(impl="pallas", bq=bq, bk=bk, interpret=True) if route == "pallas" \
        else dict(impl="xla")
    want = ref_flash(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=causal,
                     window=window, **kw)
    got = flash_attention(torch.tensor(q), torch.tensor(k), torch.tensor(v),
                          causal=causal, window=window)
    assert got.shape == (B, S, H, hd) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-4, atol=2e-4)


@pytest.mark.parametrize("route", ["xla", "pallas"])
def test_bf16_matches_reference(route):
    q, k, v = _qkv(1, 64, 2, 2, 32, 3)
    jq, jk, jv = (jnp.asarray(a, jnp.bfloat16) for a in (q, k, v))
    kw = dict(impl="pallas", bq=32, bk=32, interpret=True) if route == "pallas" \
        else dict(impl="xla")
    want = np.asarray(ref_flash(jq, jk, jv, **kw), np.float32)
    got = flash_attention(*(torch.tensor(a).to(torch.bfloat16) for a in (q, k, v)))
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), want, rtol=3e-2, atol=3e-2)


def test_mask_is_causal_and_windowed():
    m = attention_mask(6, True, 3).numpy()
    i, j = np.arange(6)[:, None], np.arange(6)[None, :]
    assert np.array_equal(m, (j <= i) & (i - j < 3))
    assert attention_mask(4, False, None).all()


def test_cpu_tensors_take_the_plain_version_and_the_kernel_refuses_them():
    q, k, v = (torch.tensor(a).to(torch.bfloat16) for a in _qkv(1, 16, 2, 1, 16, 0))
    before = flash_attention_cuda.launches
    flash_attention(q, k, v)
    assert flash_attention_cuda.launches == before
    with pytest.raises(ValueError, match="CUDA"):
        flash_attention_cuda(q, k, v)
    assert flash_attention_cuda.launches == before

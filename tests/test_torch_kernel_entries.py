"""The kernel entries against the JAX package's, on the CPU (ROADMAP C13
and C14).

C13: B1's ``dpd_branch`` takes what the reference's takes, ``(..., L + 9)``
streams of any float type at any order, casts them to float32 and answers
as the reference does for those float32 values (the result float32).
C14: every entry takes the reference's keywords, so the reference's own
kernel calls (``tests/test_kernels.py``) run on the port's entries and
give the reference's results; an unknown ``impl`` raises, and so does a
kernel route under autograd.

Bars: float32 results within the reference's own bars for the same calls
(``tests/test_kernels.py``: B3 rtol 1e-5 atol 1e-3, B4 exact, B1 2e-3, B5
2e-4 and bf16 3e-2, B6 3e-4, B7 1e-5).  C13's float32 and float64 streams
within 1e-5 of the plane's largest magnitude (the repo's cross-framework
rule for float tokens, ROADMAP hazard C2), the reference called on the
stream's values cast to float32.  For bf16 and f16 streams that is a
departure: the reference computes their basis in the stream's own type
(ROADMAP, departures).
"""
from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.dyn_fir import dpd_branch as ref_dpd_branch
from repro.kernels.flash_attention import flash_attention as ref_flash_attention
from repro.kernels.gauss5x5 import gauss5x5 as ref_gauss5x5
from repro.kernels.motion_post import motion_post as ref_motion_post
from repro.kernels.rglru import rglru as ref_rglru
from repro.kernels.ssd import ssd as ref_ssd
from repro_torch.kernels.dyn_fir import dpd_branch
from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.kernels.gauss5x5 import gauss5x5
from repro_torch.kernels.motion_post import motion_post
from repro_torch.kernels.rglru import rglru
from repro_torch.kernels.ssd import ssd


def _planes_close(ref, got, rel):
    for r, g in zip(ref, got):
        r, g = np.asarray(r, np.float64), g.numpy().astype(np.float64)
        assert g.shape == r.shape
        assert np.abs(g - r).max() <= rel * np.abs(r).max(), np.abs(g - r).max()


# ---------------------------------------------------------------------- #
# C13: B1's entry.
# ---------------------------------------------------------------------- #
@pytest.mark.parametrize("dtype,shape,order", [
    ("float64", (1033,), 3), ("float64", (4, 1033), 10), ("bfloat16", (1033,), 2),
    ("bfloat16", (2, 3, 137), 5), ("float32", (4, 1033), 1), ("float32", (4, 1033), 0),
    ("float32", (4, 1033), 11), ("float64", (3, 20), 12), ("float16", (3, 300), 7)])
def test_dpd_branch_takes_what_the_reference_takes(rng, dtype, shape, order):
    xr, xi = (rng.normal(size=shape) * 0.7 for _ in range(2))
    hr, hi = (rng.normal(size=10) for _ in range(2))
    ops = [torch.tensor(a).to(getattr(torch, dtype)) for a in (xr, xi, hr, hi)]
    want = ref_dpd_branch(*(jnp.asarray(t.to(torch.float32).numpy()) for t in ops),
                          order=order)
    got = dpd_branch(*ops, order=order)
    assert all(g.dtype == torch.float32 and g.shape == shape[:-1] + (shape[-1] - 9,)
               for g in got)
    _planes_close(want, got, 1e-5)


# ---------------------------------------------------------------------- #
# C14: the reference's own kernel calls (tests/test_kernels.py).
# ---------------------------------------------------------------------- #
@pytest.mark.parametrize("hw", [(240, 320), (120, 160), (64, 48)])
def test_gauss5x5_reference_calls(rng, hw):
    H, W = hw
    f = rng.uniform(0, 255, (H, W)).astype(np.float32)
    want = np.asarray(ref_gauss5x5(jnp.asarray(f), impl="pallas", block_h=H // 4,
                                   interpret=True))
    for kw in ({"impl": "xla"}, {"impl": "pallas", "block_h": H // 4, "interpret": True}):
        np.testing.assert_allclose(gauss5x5(torch.tensor(f), **kw).numpy(), want,
                                   rtol=1e-5, atol=1e-3)


@pytest.mark.parametrize("hw,block_h", [((240, 320), 60), ((120, 160), 30), ((64, 64), 16)])
def test_motion_post_reference_calls(rng, hw, block_h):
    cur, prev = (rng.uniform(0, 255, hw).astype(np.float32) for _ in range(2))
    want = np.asarray(ref_motion_post(jnp.asarray(cur), jnp.asarray(prev), impl="pallas",
                                      block_h=block_h, interpret=True))
    for kw in ({"impl": "xla"}, {"impl": "pallas", "block_h": block_h, "interpret": True}):
        np.testing.assert_array_equal(
            motion_post(torch.tensor(cur), torch.tensor(prev), **kw).numpy(), want)


@pytest.mark.parametrize("order", [1, 5, 10])
@pytest.mark.parametrize("L,block", [(2048, 512), (1024, 1024)])
def test_dpd_branch_reference_calls(rng, order, L, block):
    args = [rng.normal(size=L + 9), rng.normal(size=L + 9), rng.normal(size=10),
            rng.normal(size=10)]
    want = ref_dpd_branch(*(jnp.asarray(a, jnp.float32) for a in args), order=order,
                          impl="pallas", block=block, interpret=True)
    targs = [torch.tensor(a, dtype=torch.float32) for a in args]
    for kw in ({"impl": "xla"}, {"impl": "pallas", "block": block, "interpret": True}):
        for w, g in zip(want, dpd_branch(*targs, order=order, **kw)):
            np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=2e-3, atol=2e-3)


@pytest.mark.parametrize(
    "B,S,H,Hkv,hd,causal,window,bq,bk",
    [(2, 128, 4, 2, 32, True, None, 32, 32),
     (1, 256, 8, 8, 16, True, 64, 64, 64),
     (2, 64, 4, 1, 32, False, None, 32, 16),
     (1, 128, 2, 2, 64, True, 32, 32, 32),
     (1, 128, 6, 3, 16, True, None, 64, 32)])
def test_flash_attention_reference_calls(rng, B, S, H, Hkv, hd, causal, window, bq, bk):
    q = rng.normal(size=(B, S, H, hd)).astype(np.float32)
    k, v = (rng.normal(size=(B, S, Hkv, hd)).astype(np.float32) for _ in range(2))
    want = np.asarray(ref_flash_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                          causal=causal, window=window, impl="pallas",
                                          bq=bq, bk=bk, interpret=True))
    for kw in ({"impl": "xla"}, {"impl": "pallas", "bq": bq, "bk": bk, "interpret": True}):
        got = flash_attention(torch.tensor(q), torch.tensor(k), torch.tensor(v),
                              causal=causal, window=window, **kw)
        np.testing.assert_allclose(got.numpy(), want, rtol=2e-4, atol=2e-4)


def test_flash_attention_bf16_reference_call(rng):
    q, k, v = (rng.normal(size=(1, 64, 2, 32)) for _ in range(3))
    want = ref_flash_attention(*(jnp.asarray(a, jnp.bfloat16) for a in (q, k, v)),
                               impl="pallas", bq=32, bk=32, interpret=True)
    got = flash_attention(*(torch.tensor(a).bfloat16() for a in (q, k, v)),
                          impl="pallas", bq=32, bk=32, interpret=True)
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32),
                               rtol=3e-2, atol=3e-2)


@pytest.mark.parametrize("B,L,H,P,N,chunk",
                         [(2, 64, 3, 8, 16, 16), (1, 100, 2, 16, 8, 32), (2, 32, 1, 4, 4, 8)])
def test_ssd_reference_calls(rng, B, L, H, P, N, chunk):
    x = rng.normal(size=(B, L, H, P)).astype(np.float32)
    dt = rng.uniform(0.001, 0.1, (B, L, H)).astype(np.float32)
    A = -rng.uniform(0.5, 2.0, (H,)).astype(np.float32)
    Bm, Cm = (rng.normal(size=(B, L, N)).astype(np.float32) for _ in range(2))
    yw, hw = ref_ssd(*(jnp.asarray(a) for a in (x, dt, A, Bm, Cm)), chunk=chunk,
                     impl="pallas", interpret=True)
    for kw in ({"impl": "xla"}, {"impl": "pallas", "interpret": True}):
        y, h = ssd(*(torch.tensor(a) for a in (x, dt, A, Bm, Cm)), chunk=chunk, **kw)
        np.testing.assert_allclose(y.numpy(), np.asarray(yw), rtol=3e-4, atol=3e-4)
        np.testing.assert_allclose(h.numpy(), np.asarray(hw), rtol=3e-4, atol=3e-4)


@pytest.mark.parametrize("B,L,W,chunk", [(2, 64, 32, 16), (1, 100, 8, 32), (3, 33, 16, 8)])
def test_rglru_reference_calls(rng, B, L, W, chunk):
    la = -rng.uniform(0.01, 2.0, (B, L, W)).astype(np.float32)
    gx = rng.normal(size=(B, L, W)).astype(np.float32)
    sw, tw = ref_rglru(jnp.asarray(la), jnp.asarray(gx), chunk=chunk, impl="pallas",
                       interpret=True)
    for kw in ({"impl": "xla"}, {"impl": "pallas", "chunk": chunk, "interpret": True}):
        s, t = rglru(torch.tensor(la), torch.tensor(gx), **kw)
        np.testing.assert_allclose(s.numpy(), np.asarray(sw), rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(t.numpy(), np.asarray(tw), rtol=1e-5, atol=1e-5)


# ---------------------------------------------------------------------- #
# Refusals: unknown impl, tiling keywords, the kernel route under autograd.
# ---------------------------------------------------------------------- #
def _calls(requires_grad=False):
    """One small call of every entry, each as (name, fn(**kw))."""
    g = torch.Generator().manual_seed(0)

    def r(*shape):
        return torch.randn(shape, generator=g).requires_grad_(requires_grad)

    q, k = r(1, 8, 2, 4), r(1, 8, 1, 4)
    la, gx = -r(1, 8, 4).abs(), r(1, 8, 4)
    x, dt, A, Bm = r(1, 8, 2, 4), r(1, 8, 2).abs(), -r(2).abs(), r(1, 8, 3)
    f, fr, fi, h = r(60, 8), r(1033), r(1033), r(10)     # the default tiles divide them
    return [("flash_attention", lambda **kw: flash_attention(q, k, k, **kw)),
            ("rglru", lambda **kw: rglru(la, gx, **kw)),
            ("ssd", lambda **kw: ssd(x, dt, A, Bm, Bm, **kw)),
            ("gauss5x5", lambda **kw: gauss5x5(f, **kw)),
            ("motion_post", lambda **kw: motion_post(f, f, **kw)),
            ("dpd_branch", lambda **kw: dpd_branch(fr, fi, h, h, order=3, **kw))]


def test_unknown_impl_and_interpret_are_refused():
    for name, call in _calls():
        with pytest.raises(ValueError, match=f"{name}: impl 'triton'"):
            call(impl="triton")
        with pytest.raises(ValueError, match="interpret must be a bool"):
            call(impl="xla", interpret="yes")


def test_tiling_keywords_are_checked_on_the_kernel_route():
    """At impl="pallas", as the reference's kernels check them; the device
    rule (None) takes any shape, as the port's kernels do."""
    q = torch.zeros((1, 96, 2, 4))
    with pytest.raises(ValueError, match="must divide block sizes"):
        flash_attention(q, q, q, bq=64, impl="pallas")
    for impl in (None, "xla"):
        flash_attention(q, q, q, bq=64, impl=impl)
    f = torch.zeros((50, 8))
    with pytest.raises(ValueError, match="not divisible by block_h"):
        gauss5x5(f, impl="pallas")
    gauss5x5(f)
    with pytest.raises(ValueError, match="not divisible by block_h"):
        motion_post(f, f, impl="pallas", block_h=16)
    x = torch.zeros(109)
    with pytest.raises(ValueError, match="not divisible by block"):
        dpd_branch(x, x, x[:10], x[:10], order=2, impl="pallas", block=64)
    with pytest.raises(ValueError, match="chunk must be a positive int"):
        rglru(torch.zeros((1, 4, 2)), torch.zeros((1, 4, 2)), chunk=0)


def test_kernel_route_under_autograd_raises_and_xla_differentiates():
    for name, call in _calls(requires_grad=True):
        for impl in (None, "pallas"):
            with pytest.raises(ValueError, match=f"{name}: an operand requires grad.*"
                                                 "kernel_impl='xla'"):
                call(impl=impl)
        out = call(impl="xla")
        out = out[0] if isinstance(out, tuple) else out
        if name != "motion_post":                       # a threshold has no gradient
            assert out.requires_grad and out.grad_fn is not None, name
        with torch.no_grad():                            # no grad mode: no guard
            call(impl=None)

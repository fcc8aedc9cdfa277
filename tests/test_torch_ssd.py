"""B6's plain version (the chunked SSD scan, ``ssd_chunked``'s algorithm)
against the JAX package's oracle ``ssd_naive`` and its Pallas kernel in
interpret mode, at the shapes of ``tests/test_kernels.py`` and at mamba2's
head shape (P 64, N 128, chunk 256) with L not a multiple of the chunk,
also at the serving decays and under strong decays, and the wrapper's
CPU contract; and the Hopper kernel's precision scheme
(bf16 tensor-core products, float32 operands split into hi + lo), emulated
on the CPU.  The kernel itself runs only on the card
(``tests/test_torch_kernels_cuda.py``, ``chip_smoke.py`` phase 12).

Tolerance: rtol = atol = 3e-4, the reference's own bar
(``tests/test_kernels.py``): the chunked and step-by-step forms sum in
different orders.
"""
from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

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


@pytest.mark.parametrize("decays", ["softplus", "strong"])
def test_plain_version_holds_the_bar_at_the_serving_decays(decays):
    """At mamba2's head shape, with L over two chunks and a ragged tail, and
    with the decays that the cases above do not reach: dt = softplus(randn)
    and A from -1 to -16 (as ``chip_smoke.py`` phase 12 draws them), and dt
    up to 5 at A = -16 (the card's strong-decay test), where a chunk's
    cumsum of dt A reaches -1e4 and cum_t - cum_s cancels.  Against the JAX
    package's step-by-step oracle, which takes each decay from one step."""
    rng = np.random.default_rng(3)
    B, L, H = 1, 600, 4
    x, B_, C_ = (rng.normal(size=s).astype(np.float32)
                 for s in ((B, L, H, 64), (B, L, 128), (B, L, 128)))
    if decays == "softplus":
        dt = np.logaddexp(0.0, rng.normal(size=(B, L, H))).astype(np.float32)
        A = -np.linspace(1.0, 16.0, H).astype(np.float32)
    else:
        dt = rng.uniform(0.0, 5.0, (B, L, H)).astype(np.float32)
        A = np.full((H,), -16.0, np.float32)
    args = (x, dt, A, B_, C_)
    want_y, want_h = (np.asarray(a) for a in ref_ssd_naive(*(jnp.asarray(a) for a in args)))
    got_y, got_h = ssd(*(torch.tensor(a) for a in args), chunk=256)
    assert np.abs(got_y.numpy() - want_y).max() <= TOL * np.abs(want_y).max()
    assert np.abs(got_h.numpy() - want_h).max() <= TOL * np.abs(want_h).max()


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


# ---- the Hopper kernel's precision scheme, emulated on the CPU ------------- #
# B6 on the card runs every product on bf16 tensor cores with float32 sums
# (csrc/ssd.cu).  An operand that is exact in bf16 (B, C, and x on bf16
# inputs) goes in as it is; a float32 operand is split into bf16 hi + lo
# and both parts go in (lo * lo dropped).  Emulated here at mamba2's head
# shape with the plain version's phases: products of bf16 values are exact
# in float32, so a float32 matmul of bf16-valued tensors is what the
# tensor cores sum.  One bf16 rounding of the float32 operands instead
# breaks the 3e-4 bar; the split holds it.


def _bf(t):
    return t.to(torch.bfloat16).to(torch.float32)


def _mm(a, b, a_exact, b_exact, split):
    """``a @ b`` as the kernel's products: each operand exact, or split into
    hi + lo (``split``), or rounded once to bf16 (not ``split``)."""
    def parts(t, exact):
        if exact:
            return [t]
        hi = _bf(t)
        return [hi, _bf(t - hi)] if split else [hi]
    pa, pb = parts(a, a_exact), parts(b, b_exact)
    out = pa[0] @ pb[0]
    if len(pa) > 1:
        out = out + pa[1] @ pb[0]
    if len(pb) > 1:
        out = out + pa[0] @ pb[1]
    return out


def _emulate(x, dt, A, B_, C_, exact, split, chunk=256):
    """The chunked scan (``ssd_ref``'s phases) with the kernel's products:
    C B^T, (C B^T * L * dt) x, (w x)^T B and C h_in^T.  float32 in and out;
    ``exact`` says that x, B and C hold bf16 values."""
    Bsz, L, H, P = x.shape
    N = B_.shape[-1]
    pad = -L % chunk
    x, dt = F.pad(x, (0, 0, 0, 0, 0, pad)), F.pad(dt, (0, 0, 0, pad))
    B_, C_ = F.pad(B_, (0, 0, 0, pad)), F.pad(C_, (0, 0, 0, pad))
    nc = (L + pad) // chunk
    xc = x.reshape(Bsz, nc, chunk, H, P).permute(0, 1, 3, 2, 4)
    dtc = dt.reshape(Bsz, nc, chunk, H).permute(0, 1, 3, 2)
    Bc, Cc = B_.reshape(Bsz, nc, chunk, N), C_.reshape(Bsz, nc, chunk, N)
    cum = torch.cumsum((dtc * A[:, None]).double(), -1)
    seg = (cum[..., :, None] - cum[..., None, :]).float()
    Lmat = torch.where(torch.ones(chunk, chunk, dtype=torch.bool).tril(), torch.exp(seg),
                       torch.zeros(()))
    G = _mm(Cc, Bc.transpose(-1, -2), exact, exact, split)
    Y1 = _mm(G[:, :, None] * Lmat * dtc[..., None, :], xc, False, exact, split)
    w = torch.exp((cum[..., -1:] - cum).float()) * dtc
    S = _mm((w[..., None] * xc).transpose(-1, -2), Bc[:, :, None], False, exact, split)
    h = torch.zeros((Bsz, H, P, N))
    h_in = []
    for z in range(nc):
        h_in.append(h)
        h = h * torch.exp(cum[:, z, :, -1].float())[..., None, None] + S[:, z]
    h_in = torch.stack(h_in, 1)
    Y2 = torch.exp(cum.float())[..., None] * _mm(Cc[:, :, None], h_in.transpose(-1, -2),
                                                 exact, False, split)
    y = (Y1 + Y2).permute(0, 1, 3, 2, 4).reshape(Bsz, nc * chunk, H, P)[:, :L]
    return y, h


def _scheme_errors(inputs, split):
    """(max |dy| / max |y|, max |dhT| / max |hT|) of the emulation against
    ssd_naive, at B 1, L 600 (three chunks, the last ragged), H 4, P 64,
    N 128, with dt and A drawn as chip_smoke.py's phase 12 draws them."""
    rng = np.random.default_rng(7)
    B, L, H = 1, 600, 4
    x, B_, C_ = (torch.tensor(rng.normal(size=s).astype(np.float32))
                 for s in ((B, L, H, 64), (B, L, 128), (B, L, 128)))
    dt = F.softplus(torch.tensor(rng.normal(size=(B, L, H)).astype(np.float32)))
    A = -torch.linspace(1.0, 16.0, H)
    exact = inputs == "bf16"
    if exact:
        x, B_, C_ = _bf(x), _bf(B_), _bf(C_)
    want_y, want_h = ssd_naive(x, dt, A, B_, C_)
    got_y, got_h = _emulate(x, dt, A, B_, C_, exact, split)
    return (float((got_y - want_y).abs().max() / want_y.abs().max()),
            float((got_h - want_h).abs().max() / want_h.abs().max()))


@pytest.mark.parametrize("inputs", ["float32", "bf16"])
def test_split_products_hold_the_bar(inputs):
    ey, eh = _scheme_errors(inputs, split=True)
    assert ey <= TOL and eh <= TOL, (ey, eh)


@pytest.mark.parametrize("inputs", ["float32", "bf16"])
def test_one_bf16_rounding_breaks_the_bar(inputs):
    ey, eh = _scheme_errors(inputs, split=False)
    assert ey > TOL and eh > TOL, (ey, eh)


# ---- the entry on other dtypes (ROADMAP C10 a) ---------------------------- #
# The reference casts dt, A, x, B and C to float32 inside its kernel and
# returns y in x's type (float64 is float32 to it: its JAX runs without
# 64-bit types).  Bar: the file's, plus one unit of y's type at |y|.
@pytest.mark.parametrize("route", ["oracle", "pallas"])
@pytest.mark.parametrize("xdt,dtdt,adt", [("bfloat16", "float32", "float32"),
                                          ("float16", "bfloat16", "float64"),
                                          ("float64", "float16", "float16"),
                                          ("float32", "float64", "bfloat16")])
def test_entry_casts_like_the_reference(route, xdt, dtdt, adt):
    x, dt, A, B_, C_ = _inputs(2, 40, 2, 8, 16, 1)
    tx, tB, tC = (torch.tensor(a).to(getattr(torch, xdt)) for a in (x, B_, C_))
    tdt, tA = torch.tensor(dt).to(getattr(torch, dtdt)), torch.tensor(A).to(getattr(torch, adt))
    to_j = lambda t: jnp.asarray(t.float().numpy()).astype(jnp.dtype(str(t.dtype)[6:]))
    if route == "pallas":
        want_y, want_h = ref_ssd(*(to_j(t) for t in (tx, tdt, tA, tB, tC)), chunk=16,
                                 impl="pallas", interpret=True)
    else:
        want_y, want_h = ref_ssd_naive(*(to_j(t).astype(jnp.float32)
                                         for t in (tx, tdt, tA, tB, tC)))
        want_y = want_y.astype(to_j(tx).dtype)
    got_y, got_h = ssd(tx, tdt, tA, tB, tC, chunk=16)
    assert str(got_y.dtype)[6:] == str(want_y.dtype) and got_h.dtype == torch.float32
    want_y = np.asarray(want_y, np.float32)
    eps = float(torch.finfo(got_y.dtype).eps)
    np.testing.assert_allclose(got_y.float().numpy(), want_y, rtol=TOL + eps, atol=TOL)
    np.testing.assert_allclose(got_h.numpy(), np.asarray(want_h), rtol=TOL, atol=TOL)

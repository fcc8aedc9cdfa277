"""B5's plain version (dense masked softmax in float32) against the JAX
package's oracle ``flash_attention_ref`` (``impl="xla"``) and its Pallas
kernel in interpret mode, at the shapes of ``tests/test_kernels.py`` and at
recurrentgemma's head shape (hd 256, 10 query heads on one KV head, a
window shorter than the sequence), and the wrapper's CPU contract.  The
Hopper kernel runs only on the card (``chip_smoke.py`` phase 12,
``tests/test_torch_kernels_cuda.py``); here a torch emulation of its
schedule (tile walk, skips, cut-only masks, bf16 weights) is held to the
JAX package, so the schedule is shown exact before any card run.

Tolerances are the reference's own (``tests/test_kernels.py``): float32
within rtol = atol = 2e-4 (sums in another order), bf16 within 3e-2.
"""
from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention import flash_attention as ref_flash
from repro_torch.kernels.flash_attention import (NEG_INF, attention_mask,
                                                 flash_attention, flash_attention_cuda)

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


# ---- the Hopper kernel's schedule, emulated ------------------------------- #
# csrc/flash_attention.cu: one block per (batch, head, 128-query tile), two
# warpgroups of 64 rows, key tiles of 64.  The block walks the key tiles
# holding a live key for some of its rows; each warpgroup computes only
# the tiles live for its own rows and masks only the tiles that the causal
# diagonal, the window edge or the end of the sequence cuts.

BM, BN, WG_ROWS = 128, 64, 64


def _walk(S, causal, window):
    """Per (query tile start q0, warpgroup first row r_lo): the key-tile
    starts the block walks and, of those, this warpgroup's live ones, each
    with whether it is cut (masked).  As the kernel computes them."""
    walk = []
    for q0 in range(0, S, BM):
        k_lo = max(0, q0 - window + 1) if window else 0
        k_hi = min(q0 + BM - 1, S - 1) if causal else S - 1
        block = [t * BN for t in range(k_lo // BN, k_hi // BN + 1)]
        for r_lo in (q0, q0 + WG_ROWS):
            if r_lo >= S:
                walk.append((q0, r_lo, block, []))
                continue
            r_hi = min(r_lo + WG_ROWS - 1, S - 1)
            lo_key = max(0, r_lo - window + 1) if window else 0
            hi_key = r_hi if causal else S - 1
            live = [(kt, (causal and kt + BN - 1 > r_lo)
                     or (bool(window) and r_hi - kt >= window) or kt + BN > S)
                    for kt in block if lo_key // BN <= kt // BN <= hi_key // BN]
            walk.append((q0, r_lo, block, live))
    return walk


def _hopper_schedule(q, k, v, causal, window, round_p=True):
    """The kernel's arithmetic in float32 on the CPU, tile by tile: scores
    scaled by scale * log2(e), a masked score NEG_INF, a key at or past S
    -inf (both only on cut tiles), base-2 online softmax with alpha =
    2^(m_prev - m_new), the weights rounded to bf16 before P V (``round_p``)
    while l sums them unrounded, out = O / max(l, 1e-20) in q's type."""
    B, S, H, hd = q.shape
    G = H // k.shape[2]
    scale2 = torch.tensor((1.0 / hd ** 0.5) * np.log2(np.e), dtype=torch.float32)
    qf, kf, vf = (t.float() for t in (q, k, v))
    pad = BM + BN
    kp = torch.cat([kf, kf.new_zeros(B, pad, *kf.shape[2:])], dim=1)  # TMA's zero fill
    vp = torch.cat([vf, vf.new_zeros(B, pad, *vf.shape[2:])], dim=1)
    qp = torch.cat([qf, qf.new_zeros(B, pad, *qf.shape[2:])], dim=1)
    out = torch.zeros(B, S, H, hd)
    for q0, r_lo, _, live in _walk(S, causal, window):
        if not live:
            continue
        rows = torch.arange(r_lo, r_lo + WG_ROWS)
        for b in range(B):
            for h in range(H):
                Q = qp[b, r_lo:r_lo + WG_ROWS, h]
                m = torch.full((WG_ROWS,), NEG_INF)
                l = torch.zeros(WG_ROWS)
                O = torch.zeros(WG_ROWS, hd)
                for kt, cut in live:
                    keys = torch.arange(kt, kt + BN)
                    s = (Q @ kp[b, kt:kt + BN, h // G].T) * scale2
                    if cut:
                        dead = torch.zeros(WG_ROWS, BN, dtype=torch.bool)
                        if causal:
                            dead |= keys[None] > rows[:, None]
                        if window:
                            dead |= rows[:, None] - keys[None] >= window
                        s = torch.where(dead, torch.tensor(NEG_INF), s)
                        s = torch.where(keys[None] >= S, torch.tensor(-np.inf), s)
                    m_new = torch.maximum(m, s.max(dim=1).values)
                    alpha = torch.exp2(m - m_new)
                    p = torch.exp2(s - m_new[:, None])
                    l = alpha * l + p.sum(dim=1)
                    pv = p.to(torch.bfloat16).float() if round_p else p
                    O = O * alpha[:, None] + pv @ vp[b, kt:kt + BN, h // G]
                    m = m_new
                n = min(WG_ROWS, S - r_lo)
                out[b, r_lo:r_lo + n, h] = (O / l.clamp(min=1e-20)[:, None])[:n]
    return out.to(q.dtype)


# recurrentgemma's head shape (10 query heads on one KV head of 256) at a
# ragged S with a window shorter than two key tiles, and non-causal cases.
SCHEDULE_CASES = [(1, 600, 10, 1, 256, True, 96, 200),
                  (1, 600, 10, 1, 256, False, 96, 200),
                  (2, 300, 4, 2, 64, False, None, 150)]


@pytest.mark.parametrize("route", ["xla", "pallas"])
@pytest.mark.parametrize("B,S,H,Hkv,hd,causal,window,blk", SCHEDULE_CASES)
def test_hopper_schedule_matches_reference(route, B, S, H, Hkv, hd, causal, window, blk):
    """The kernel's tile walk, skip, cut-only masks and bf16 weights, in
    bf16 against the JAX package within the file's bf16 tolerance."""
    q, k, v = (torch.tensor(a).to(torch.bfloat16)
               for a in _qkv(B, S, H, Hkv, hd, S + hd))
    kw = dict(impl="pallas", bq=blk, bk=blk, interpret=True) if route == "pallas" \
        else dict(impl="xla")
    want = np.asarray(ref_flash(*(jnp.asarray(t.float().numpy(), jnp.bfloat16)
                                  for t in (q, k, v)),
                                causal=causal, window=window, **kw), np.float32)
    got = _hopper_schedule(q, k, v, causal, window)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), want, rtol=3e-2, atol=3e-2)


@pytest.mark.parametrize("B,S,H,Hkv,hd,causal,window,blk", SCHEDULE_CASES)
def test_hopper_schedule_is_exact_in_float32(B, S, H, Hkv, hd, causal, window, blk):
    """With the weights unrounded and float32 inputs the schedule is the
    reference's function: skipping dead tiles and masking only cut ones
    loses nothing (within the file's float32 tolerance)."""
    q, k, v = _qkv(B, S, H, Hkv, hd, S + hd + 1)
    want = ref_flash(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=causal,
                     window=window, impl="xla")
    got = _hopper_schedule(*(torch.tensor(a) for a in (q, k, v)), causal, window,
                           round_p=False)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-4, atol=2e-4)


@pytest.mark.parametrize("S,causal,window", [(600, True, 96), (4096, True, 2048),
                                             (333, False, None), (129, False, 1),
                                             (700, True, 37), (1, True, None)])
def test_tile_walk_covers_live_keys_and_skips_the_rest(S, causal, window):
    """Every live (query, key) pair of a warpgroup's rows lies in one of its
    live tiles; every tile it skips holds no live pair for its rows, and
    every tile it does not mask holds no masked pair (keys past S count as
    masked); a window keeps the walk at O(window) tiles per block."""
    mask = attention_mask(S, causal, window).numpy()
    for q0, r_lo, block, live in _walk(S, causal, window):
        rows = slice(r_lo, min(r_lo + WG_ROWS, S))
        live_starts = {kt for kt, _ in live}
        assert live_starts <= set(block)
        for kt in range(0, S, BN):
            tile = mask[rows, kt:kt + BN]
            if kt not in live_starts:
                assert not tile.any()
        for kt, cut in live:
            tile = mask[rows, kt:kt + BN]
            if not cut:
                assert tile.all() and tile.shape[1] == BN
        if window:
            assert len(block) <= (BM + window - 2) // BN + 2


# ---- the float32 / f16 route (ROADMAP C9), emulated ------------------------ #
# csrc/flash_attention.cu's flash_fwd_ffma: one block per (batch, head,
# 64-query tile), a warp per 8 query rows, key tiles of 32; the block walks
# the key tiles live for some of its rows and each warp skips the tiles
# dead for all of its own.  float32 arithmetic from the start (m = NEG_INF,
# masked scores NEG_INF, keys past S -inf, natural exp), out = O / max(l,
# 1e-20) in q's type.  The routing is the wrapper's.


def _ffma_schedule(q, k, v, causal, window):
    from repro_torch.kernels.flash_attention.kernel import (FFMA_KEYS, FFMA_QUERY_ROWS,
                                                            FFMA_WARP_ROWS)
    B, S, H, hd = q.shape
    G = H // k.shape[2]
    scale = torch.tensor(1.0 / hd ** 0.5, dtype=torch.float32)
    qf, kf, vf = (t.float() for t in (q, k, v))
    kf, vf = kf.repeat_interleave(G, dim=2), vf.repeat_interleave(G, dim=2)
    out = torch.zeros(B, S, H, hd)
    for q0 in range(0, S, FFMA_QUERY_ROWS):
        k_lo = max(0, q0 - window + 1) if window else 0
        k_hi = min(q0 + FFMA_QUERY_ROWS - 1, S - 1) if causal else S - 1
        for r_lo in range(q0, min(q0 + FFMA_QUERY_ROWS, S), FFMA_WARP_ROWS):
            r_hi = min(r_lo + FFMA_WARP_ROWS - 1, S - 1)
            rows = torch.arange(r_lo, r_hi + 1)
            Q = qf[:, r_lo:r_hi + 1].transpose(1, 2)                 # (B, H, R, hd)
            m = torch.full((B, H, len(rows)), NEG_INF)
            l = torch.zeros(B, H, len(rows))
            O = torch.zeros(B, H, len(rows), hd)
            for kt in range(k_lo // FFMA_KEYS * FFMA_KEYS, k_hi + 1, FFMA_KEYS):
                if (causal and kt > r_hi) or (window and kt + FFMA_KEYS - 1 <= r_lo - window):
                    continue
                keys = torch.arange(kt, min(kt + FFMA_KEYS, S))
                Kt = kf[:, kt:kt + FFMA_KEYS].transpose(1, 2)            # (B, H, n, hd)
                Vt = vf[:, kt:kt + FFMA_KEYS].transpose(1, 2)
                s = (Q @ Kt.transpose(-1, -2)) * scale
                dead = torch.zeros(len(rows), len(keys), dtype=torch.bool)
                if causal:
                    dead |= keys[None] > rows[:, None]
                if window:
                    dead |= rows[:, None] - keys[None] >= window
                s = torch.where(dead, torch.tensor(NEG_INF), s)
                m_new = torch.maximum(m, s.max(dim=-1).values)
                p = torch.exp(s - m_new[..., None])
                alpha = torch.exp(m - m_new)
                l = alpha * l + p.sum(dim=-1)
                O = O * alpha[..., None] + p @ Vt
                m = m_new
            out[:, r_lo:r_hi + 1] = (O / l.clamp(min=1e-20)[..., None]).transpose(1, 2)
    return out.to(q.dtype)


FFMA_CASES = [(1, 300, 10, 1, 256, True, 64), (2, 97, 4, 2, 8, False, 40),
              (1, 130, 6, 3, 64, True, None), (1, 70, 2, 2, 16, True, 7)]


@pytest.mark.parametrize("route", ["xla", "pallas"])
@pytest.mark.parametrize("dtype", ["float32", "float16"])
@pytest.mark.parametrize("B,S,H,Hkv,hd,causal,window", FFMA_CASES)
def test_float_route_schedule_matches_reference(route, dtype, B, S, H, Hkv, hd, causal,
                                                window):
    """The FFMA kernel's walk, skips and float32 online softmax against both
    reference routes: float32 within the file's float32 tolerance, f16
    within two f16 steps of |want| plus 2^-10 of the largest magnitude.
    The reference's Pallas kernel runs as one tile (``bq = bk = S``), so S
    need not divide into its blocks."""
    tdt = getattr(torch, dtype)
    q, k, v = (torch.tensor(a).to(tdt) for a in _qkv(B, S, H, Hkv, hd, S + hd + 2))
    kw = dict(impl="pallas", bq=S, bk=S, interpret=True) if route == "pallas" \
        else dict(impl="xla")
    want = np.asarray(ref_flash(*(jnp.asarray(t.float().numpy()).astype(jnp.dtype(dtype))
                                  for t in (q, k, v)),
                                causal=causal, window=window, **kw), np.float32)
    got = _ffma_schedule(q, k, v, causal, window)
    assert got.dtype == tdt
    if dtype == "float32":
        np.testing.assert_allclose(got.numpy(), want, rtol=2e-4, atol=2e-4)
    else:
        step = float(torch.finfo(tdt).eps)
        np.testing.assert_allclose(got.float().numpy(), want, rtol=2 * step,
                                   atol=2.0 ** -10 * np.abs(want).max())


def test_float32_and_f16_take_the_ffma_route():
    from repro_torch.kernels.flash_attention.kernel import ROUTES
    assert ROUTES == {torch.bfloat16: "wgmma", torch.float32: "ffma",
                      torch.float16: "ffma"}
    assert flash_attention_cuda.route_launches.keys() == {"wgmma", "ffma"}
    for dtype in (torch.float32, torch.float16):
        q, k, v = (torch.tensor(a).to(dtype) for a in _qkv(1, 16, 2, 1, 8, 0))
        before = dict(flash_attention_cuda.route_launches)
        assert flash_attention(q, k, v).dtype == dtype
        assert flash_attention_cuda.route_launches == before
        with pytest.raises(ValueError, match="CUDA"):
            flash_attention_cuda(q, k, v)

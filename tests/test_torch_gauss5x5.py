"""The plain PyTorch Gauss blur (B3's oracle) against the reference's
``gauss5x5`` through both its routes (``impl="xla"``, the 25-tap version,
and ``impl="pallas"`` in interpret mode, the separable kernel), and the
wrappers' CPU contract: ``gauss5x5`` takes any dtype and returns the
float32 blur, as the reference's entry does; ``gauss5x5_u8`` is the Gauss
actor's body, u8 in and the blur rounded to u8 out.  The Hopper kernel itself runs only on the card
(``chip_smoke.py`` holds it against the plain version there); its u8
scheme, an integer separable 1-4-6-4-1 blur with S / 256 rounded half to
even in integers and two sums packed in a 32-bit word, is emulated here in
numpy and held to the plain version and the reference on the same frames.

Tolerances: float frames within ``rtol 1e-5, atol 1e-3`` (the reference's
own bar, ``tests/test_kernels.py:20``: sums in another order differ in the
last bits); integer-valued and u8 frames exactly, since every partial sum
is then a multiple of 1/256 below 256, exact in float32.
"""
from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.gauss5x5 import gauss5x5 as ref_gauss5x5
from repro.kernels.gauss5x5.ref import KERNEL_2D as REF_KERNEL_2D
from repro_torch.kernels.gauss5x5 import (KERNEL_2D, gauss5x5, gauss5x5_cuda,
                                          gauss5x5_ref, gauss5x5_u8, gauss5x5_u8_ref,
                                          to_u8)

SHAPES = [(48, 64), (240, 320)]


def _ref(frames: np.ndarray, impl: str) -> np.ndarray:
    """The reference blur of (H, W) or (N, H, W) frames, frame by frame."""
    batch = frames.reshape((-1,) + frames.shape[-2:])
    kw = dict(impl="pallas", interpret=True, block_h=frames.shape[-2] // 4) \
        if impl == "pallas" else dict(impl="xla")
    out = np.stack([np.asarray(ref_gauss5x5(jnp.asarray(f), **kw)) for f in batch])
    return out.reshape(frames.shape)


def _ref_u8(x: np.ndarray) -> np.ndarray:
    return np.asarray(jnp.clip(jnp.round(jnp.asarray(x)), 0, 255).astype(jnp.uint8))


def test_weights_equal_reference():
    assert np.array_equal(KERNEL_2D, REF_KERNEL_2D) and KERNEL_2D.sum() == 1.0


@pytest.mark.parametrize("impl", ["xla", "pallas"])
@pytest.mark.parametrize("shape", SHAPES)
def test_float_frames_within_tolerance(impl, shape):
    rng = np.random.default_rng(shape[0])
    x = rng.uniform(0, 255, shape).astype(np.float32)
    got = gauss5x5(torch.tensor(x))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), _ref(x, impl), rtol=1e-5, atol=1e-3)


@pytest.mark.parametrize("impl", ["xla", "pallas"])
@pytest.mark.parametrize("shape", SHAPES + [(4, 240, 320)])
def test_integer_valued_frames_exact(impl, shape):
    rng = np.random.default_rng(sum(shape))
    x = np.round(rng.uniform(0, 255, shape)).astype(np.float32)
    assert np.array_equal(gauss5x5(torch.tensor(x)).numpy(), _ref(x, impl))


@pytest.mark.parametrize("shape", SHAPES + [(4, 240, 320)])
def test_u8_path_is_the_rounded_reference_exactly(shape):
    rng = np.random.default_rng(7 + sum(shape))
    x = rng.integers(0, 256, shape).astype(np.uint8)
    blurred = _ref(x.astype(np.float32), "xla")
    ties = np.count_nonzero(blurred - np.floor(blurred) == 0.5)
    assert ties > 0                     # round half to even is exercised
    got = gauss5x5_u8(torch.tensor(x))
    assert got.dtype == torch.uint8 and tuple(got.shape) == shape
    assert np.array_equal(got.numpy(), _ref_u8(blurred))


@pytest.mark.parametrize("impl", ["xla", "pallas"])
@pytest.mark.parametrize("shape", SHAPES)
def test_u8_frames_give_the_reference_float_blur_exactly(impl, shape):
    """``gauss5x5`` on u8 frames casts them and returns the float32 blur,
    as the reference's entry does on the same u8 array: bit for bit, since
    every partial sum of the blur is exact on u8 sources."""
    rng = np.random.default_rng(11 + sum(shape))
    x = rng.integers(0, 256, shape).astype(np.uint8)
    got = gauss5x5(torch.tensor(x))
    ref = _ref(x, impl)
    assert got.dtype == torch.float32 and ref.dtype == np.float32
    assert np.array_equal(got.numpy(), ref)
    assert np.count_nonzero(ref - np.floor(ref)) > 0    # not u8-valued


@pytest.mark.parametrize("shape", [(5, 7), (2, 24, 32)])
def test_u8_entry_is_the_rounded_float_entry_and_takes_only_u8(shape):
    x = torch.tensor(np.random.default_rng(2).integers(0, 256, shape), dtype=torch.uint8)
    assert torch.equal(gauss5x5_u8(x), to_u8(gauss5x5(x)))
    with pytest.raises(ValueError, match="uint8"):
        gauss5x5_u8(x.to(torch.float32))


def test_border_passes_through_and_edges_clamp():
    rng = np.random.default_rng(3)
    x = torch.tensor(rng.uniform(0, 255, (12, 16)).astype(np.float32))
    y = gauss5x5_ref(x)
    border = torch.ones_like(x, dtype=torch.bool)
    border[2:-2, 2:-2] = False
    assert torch.equal(y[border], x[border])
    flat = torch.full((8, 8), 9.0)
    assert torch.equal(gauss5x5_ref(flat), flat)   # weights sum to 1, exactly


def test_to_u8_rounds_half_to_even_and_clamps():
    x = np.array([-3.0, 0.5, 1.5, 2.5, 3.49, 254.5, 255.5, 300.0], np.float32)
    got = to_u8(torch.tensor(x)).numpy()
    assert np.array_equal(got, _ref_u8(x))
    assert got.tolist() == [0, 0, 2, 2, 3, 254, 255, 255]


def test_cpu_wrapper_takes_the_plain_version_without_launching():
    x = torch.tensor(np.random.default_rng(0).integers(0, 256, (2, 24, 32)),
                     dtype=torch.uint8)
    before = gauss5x5_cuda.launches
    out = gauss5x5_u8(x)
    assert gauss5x5_cuda.launches == before
    assert torch.equal(out, to_u8(gauss5x5_ref(x.float())))
    with pytest.raises(ValueError, match="CUDA tensor"):
        gauss5x5_cuda(x)
    assert gauss5x5_cuda.launches == before


# ---- B3's u8 scheme (csrc/gauss5x5.cu, motion.cuh), emulated ------------- #
BINOMIAL = (1, 4, 6, 4, 1)


def _rint_div256_pair(w: np.ndarray) -> np.ndarray:
    """``motion::rint_div256_pair`` on uint32 words holding two sums."""
    w = w.astype(np.uint32)
    return ((w + np.uint32(0x007F007F) + ((w >> 8) & np.uint32(0x00010001))) >> 8) \
        & np.uint32(0x00FF00FF)


def _binomial5(a, b, c, d, e):
    """``motion::binomial5``: a + 4 b + 6 c + 4 d + e (uint32 words)."""
    return a + e + ((b + d) << 2) + (c << 2) + (c << 1)


def _separable_u8(frames: np.ndarray) -> np.ndarray:
    """The kernel's u8 blur in integers: a row pass over edge-clamped
    columns (sums at most 4 080), a column pass over edge-clamped rows of
    the row sums (at most 65 280) on pixel pairs packed in uint32 words, S /
    256 rounded half to even, and the 2-pixel border passed through."""
    x = frames.astype(np.uint32)
    H, W = x.shape[-2:]
    cols = np.clip(np.arange(W)[:, None] + np.arange(-2, 3), 0, W - 1)
    rows = np.clip(np.arange(H)[:, None] + np.arange(-2, 3), 0, H - 1)
    hsum = _binomial5(*(x[..., :, cols[:, k]] for k in range(5)))
    assert hsum.max() <= 4080
    pad = np.zeros(hsum.shape[:-1] + (W + W % 2,), np.uint32)
    pad[..., :W] = hsum
    packed = pad[..., 0::2] | (pad[..., 1::2] << 16)       # pixels 2j, 2j + 1
    s = _binomial5(*(packed[..., rows[:, k], :] for k in range(5)))
    q = _rint_div256_pair(s)
    blurred = np.stack([q & 0xFF, q >> 16], axis=-1).reshape(pad.shape)[..., :W]
    ys, xs = np.arange(H)[:, None], np.arange(W)[None, :]
    border = (ys < 2) | (ys >= H - 2) | (xs < 2) | (xs >= W - 2)
    return np.where(border, frames, blurred).astype(np.uint8)


def test_packed_rounding_is_to_u8_of_s_over_256_for_every_sum():
    """Every column-pass sum 0..65 280 in each half of the word: the integer
    rounding equals ``to_u8(S / 256)`` in float32 (half to even), and one
    half never disturbs the other."""
    s = np.arange(65281, dtype=np.uint32)
    got = _rint_div256_pair(s | (s[::-1] << 16))
    want = to_u8(torch.tensor(s.astype(np.float32) * np.float32(1 / 256))).numpy()
    assert np.array_equal(got & 0xFF, want)
    assert np.array_equal(got >> 16, want[::-1])


def test_packed_column_pass_keeps_the_halves_apart():
    rng = np.random.default_rng(5)
    h = rng.integers(0, 4081, (5, 2, 10000)).astype(np.uint32)
    h[:, :, 0] = 4080                                     # the largest sums
    packed = _binomial5(*(h[k, 0] | (h[k, 1] << 16) for k in range(5)))
    assert np.array_equal(packed & 0xFFFF, _binomial5(*h[:, 0]))
    assert np.array_equal(packed >> 16, _binomial5(*h[:, 1]))


def _frame(kind: str, shape: tuple) -> np.ndarray:
    rng = np.random.default_rng(sum(shape))
    if kind == "random":
        return rng.integers(0, 256, shape).astype(np.uint8)
    if kind == "zeros":
        return np.zeros(shape, np.uint8)
    if kind == "white":
        return np.full(shape, 255, np.uint8)
    if kind == "checker":
        ys, xs = np.indices(shape[-2:])
        return np.broadcast_to(((ys + xs) % 2 * 255).astype(np.uint8), shape).copy()
    f = np.zeros(shape, np.uint8)                          # .5 ties
    f[..., 4::9, 4::11] = 128
    f[..., 8::9, 8::11] = 64
    return f


# Tiny frames where every pixel is border (H or W below 5), a single
# interior pixel (5 x 5), odd shapes, and the main path's (4, 240, 320).
@pytest.mark.parametrize("kind", ["random", "zeros", "white", "checker", "ties"])
@pytest.mark.parametrize("shape", [(1, 1), (2, 3), (4, 4), (3, 9), (5, 5),
                                   (3, 17, 33), (2, 13, 7), (4, 240, 320)])
def test_separable_u8_scheme_is_the_plain_version_and_the_reference(shape, kind):
    x = _frame(kind, shape)
    got = _separable_u8(x)
    assert np.array_equal(got, gauss5x5_u8_ref(torch.tensor(x)).numpy())
    impls = ["xla"] + (["pallas"] if shape[-2] % 4 == 0 else [])
    for impl in impls:
        assert np.array_equal(got, _ref_u8(_ref(x.astype(np.float32), impl))), impl
    if kind == "ties" and min(shape[-2:]) >= 9:
        blurred = _ref(x.astype(np.float32), "xla")
        assert np.count_nonzero(blurred - np.floor(blurred) == 0.5) > 0

"""The plain PyTorch Thres + Med tail (B4's oracle) against the reference's
``motion_post`` through both its routes (``impl="xla"`` and
``impl="pallas"`` in interpret mode) and against its ``thres_ref``,
``med_ref`` and ``median5``: exactly, since only compares, ``abs``, one
subtraction and min/max are involved.  ``motion_post`` takes frames of any
dtype and returns float32, as the reference's entry does.  The Hopper
kernel itself runs only on the card (``chip_smoke.py`` and
``tests/test_torch_kernels_cuda.py`` hold it against the plain version
there); its scheme, threshold bits packed a nibble a row in a 32-bit word,
neighbours by shifts and by the adjacent lanes' words, and the median of
five as a bitwise majority vote, is emulated here in numpy and held to the
plain version and the reference exactly.
"""
from __future__ import annotations

import itertools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.motion_post import DEFAULT_THRESHOLD as REF_THRESHOLD
from repro.kernels.motion_post import med_ref as ref_med_ref
from repro.kernels.motion_post import median5 as ref_median5
from repro.kernels.motion_post import motion_post as ref_motion_post
from repro.kernels.motion_post import thres_ref as ref_thres_ref
from repro.kernels.motion_post.ref import motion_post_ref as ref_motion_post_ref
from repro_torch.kernels.motion_post import (DEFAULT_THRESHOLD, med_ref, median5,
                                             motion_post, motion_post_cuda,
                                             motion_post_ref, thres_ref)

SHAPES = [(48, 64), (240, 320)]


def _pair(shape, seed, integer=False):
    rng = np.random.default_rng(seed)
    cur = rng.uniform(0, 255, shape).astype(np.float32)
    prev = np.clip(cur + rng.normal(scale=45.0, size=shape), 0, 255).astype(np.float32)
    if integer:
        cur, prev = np.round(cur), np.round(prev)
    return cur, prev


@pytest.mark.parametrize("impl", ["xla", "pallas"])
@pytest.mark.parametrize("integer", [False, True])
@pytest.mark.parametrize("shape", SHAPES)
def test_motion_post_equals_reference(shape, integer, impl):
    cur, prev = _pair(shape, shape[1] + integer, integer)
    ref = np.asarray(ref_motion_post(jnp.asarray(cur), jnp.asarray(prev),
                                     **_ref_kw(impl, shape[0])))
    got = motion_post(torch.tensor(cur), torch.tensor(prev))
    assert got.dtype == torch.float32
    assert np.array_equal(got.numpy(), ref)
    assert 0 < np.count_nonzero(ref) < ref.size      # both outcomes occur


def _ref_kw(impl: str, H: int) -> dict:
    return dict(impl="pallas", interpret=True, block_h=H // 4) \
        if impl == "pallas" else dict(impl="xla")


@pytest.mark.parametrize("impl", ["xla", "pallas"])
@pytest.mark.parametrize("dtype", [np.uint8, np.int32, np.float64])
@pytest.mark.parametrize("shape", SHAPES)
def test_motion_post_takes_any_dtype_as_the_reference(shape, dtype, impl):
    """The reference's entry casts both frames to float32 and returns the
    float32 map; so does the port's, exactly (u8 frames no longer subtract
    with wraparound)."""
    rng = np.random.default_rng(shape[0] + np.dtype(dtype).itemsize)
    cur = rng.uniform(0, 255, shape)
    prev = np.clip(cur + rng.normal(scale=45.0, size=shape), 0, 255)
    if dtype != np.float64:
        cur, prev = np.round(cur).astype(dtype), np.round(prev).astype(dtype)
    ref = np.asarray(ref_motion_post(jnp.asarray(cur), jnp.asarray(prev),
                                     **_ref_kw(impl, shape[0])))
    got = motion_post(torch.tensor(cur), torch.tensor(prev))
    assert got.dtype == torch.float32 and ref.dtype == np.float32
    assert np.array_equal(got.numpy(), ref)
    assert 0 < np.count_nonzero(ref) < ref.size


@pytest.mark.parametrize("threshold", [DEFAULT_THRESHOLD, 0.0, 12.5])
def test_thres_and_med_equal_reference(threshold):
    cur, prev = _pair((4, 24, 32), 11)
    ref_m = np.stack([np.asarray(ref_thres_ref(jnp.asarray(c), jnp.asarray(p), threshold))
                      for c, p in zip(cur, prev)])
    m = thres_ref(torch.tensor(cur), torch.tensor(prev), threshold)
    assert m.dtype == torch.float32 and np.array_equal(m.numpy(), ref_m)
    ref_med = np.stack([np.asarray(ref_med_ref(jnp.asarray(x))) for x in ref_m])
    assert np.array_equal(med_ref(m).numpy(), ref_med)
    assert DEFAULT_THRESHOLD == REF_THRESHOLD == 40.0


def test_median5_equals_reference_on_every_order():
    vals = np.array([0.0, 255.0, 3.0, 7.0, 7.0], np.float32)
    perms = np.array(list(itertools.permutations(vals)), np.float32).T
    ref = np.asarray(ref_median5(*map(jnp.asarray, perms)))
    got = median5(*map(torch.tensor, perms)).numpy()
    assert np.array_equal(got, ref) and np.all(got == 7.0)


def test_cpu_wrapper_takes_the_plain_version_without_launching():
    cur, prev = (torch.tensor(x) for x in _pair((24, 32), 5))
    before = motion_post_cuda.launches
    out = motion_post(cur, prev, threshold=30.0)
    assert motion_post_cuda.launches == before
    assert torch.equal(out, med_ref(thres_ref(cur, prev, 30.0)))
    with pytest.raises(ValueError, match="CUDA tensor"):
        motion_post_cuda(cur, prev, 30.0)
    assert motion_post_cuda.launches == before


# ---- B4's scheme (csrc/motion_post.cu), emulated ------------------------- #
def _u8_threshold(t: float) -> tuple:
    """The kernel's ``Threshold`` for u8 pixels: ``(ge, keep)`` with
    ``|c - p| > t  <=>  keep and |c - p| >= ge`` for integer differences."""
    t = np.float32(t)
    if not t < 255:                                       # also NaN
        return 0, 0
    return (int(np.floor(t)) + 1 if t >= 0 else 0), 1


def _bits(cur: np.ndarray, prev: np.ndarray, t: float) -> np.ndarray:
    """Threshold bits (uint32 0/1) as the kernel takes them: float32 pixels
    by ``fabsf(cur - prev) > t``, u8 pixels by the byte compare."""
    if cur.dtype == np.uint8:
        ge, keep = _u8_threshold(t)
        d = np.abs(cur.astype(np.int32) - prev.astype(np.int32))
        return ((d >= ge) & bool(keep)).astype(np.uint32)
    return (np.abs(cur - prev) > np.float32(t)).astype(np.uint32)


def _majority5(a, b, c, d, e):
    """``majority5`` of ``motion_post.cu``: at least 3 of the 5 bits set."""
    s1, c1 = a ^ b ^ c, (a & b) | (c & (a ^ b))
    s2, c2 = d ^ e, d & e
    return (c1 & c2) | ((c1 | c2) & (s1 | s2))


def _bit_majority(cur: np.ndarray, prev: np.ndarray, t: float, R: int) -> np.ndarray:
    """The kernel on one (H, W) frame pair, warp by warp: strips of 4
    columns (clamped past W), bands of R rows whose halo rows are clamped,
    a nibble a row in a uint32 word, the left and right words from the
    adjacent lanes of a 32-lane warp or, at the warp's edge lanes, from the
    column beyond loaded alone, the frame's edge columns their own
    neighbours; up and down by nibble shifts; a bitwise majority."""
    H, W = cur.shape
    S = -(-W // 4)
    col = np.minimum(np.arange(4 * S), W - 1)
    shift = np.arange(4, dtype=np.uint32)
    u32 = np.uint32
    out = np.zeros((H, W), np.float32)
    for y0 in range(0, H, R):
        rows = np.clip(np.arange(y0 - 1, y0 + R + 1), 0, H - 1)
        bits = _bits(cur[np.ix_(rows, col)], prev[np.ix_(rows, col)], t)
        nib = (bits.reshape(R + 2, S, 4) << shift).sum(-1).astype(u32)  # (R + 2, S)
        top, bot = nib[0], nib[R + 1]
        m = np.zeros(S, u32)
        for r in range(R):
            m |= nib[r + 1] << u32(4 * r)
        s = np.arange(S)
        lane = s % 32
        from_l = np.concatenate([[u32(0)], m[:-1]])       # __shfl_up_sync
        from_r = np.concatenate([m[1:], [u32(0)]])        # __shfl_down_sync
        edge = np.zeros(S, u32)                           # the column beyond
        band = np.minimum(y0 + np.arange(R), H - 1)
        for k in s[((lane == 0) & (s > 0)) | ((lane == 31) & (s + 1 < S))]:
            xe, at = (4 * k - 1, 3) if lane[k] == 0 else (4 * k + 4, 0)
            b = _bits(cur[band, xe], prev[band, xe], t)
            edge[k] = sum(int(b[r]) << (4 * r + at) for r in range(R))
        lw = np.where(s == 0, m << u32(3),
                      np.where((lane == 0) & (s > 0), edge, from_l)).astype(u32)
        rw = np.where(s == S - 1, m >> u32(3),
                      np.where((lane == 31) & (s + 1 < S), edge, from_r)).astype(u32)
        left = ((m << u32(1)) & u32(0xEEEEEEEE)) | ((lw >> u32(3)) & u32(0x11111111))
        right = ((m >> u32(1)) & u32(0x77777777)) | ((rw << u32(3)) & u32(0x88888888))
        up = (m << u32(4)) | top
        down = (m >> u32(4)) | (bot << u32(4 * (R - 1)))
        o = _majority5(up, down, left, right, m)
        for r in range(min(R, H - y0)):
            px = (o[:, None] >> (u32(4 * r) + shift)) & u32(1)
            out[y0 + r] = np.where(px.reshape(-1)[:W] == 1, 255.0, 0.0)
    return out


def test_majority5_is_the_median_on_every_bit_pattern():
    pats = np.array(list(itertools.product([0, 1], repeat=5)), np.uint32).T
    vals = (pats * 255).astype(np.float32)
    want = np.asarray(ref_median5(*map(jnp.asarray, vals)))
    assert np.array_equal(median5(*map(torch.tensor, vals)).numpy(), want)
    assert np.array_equal(_majority5(*pats) * 255, want)


@pytest.mark.parametrize("t", [0.0, 40.0, -1.0, 12.5, -0.0, 0.5, 254.5, 254.99, 255.0,
                               255.5, 300.0, np.inf, -np.inf, np.nan])
def test_u8_byte_threshold_is_the_float_threshold_for_every_difference(t):
    d = np.arange(256)
    ge, keep = _u8_threshold(t)
    assert np.array_equal((d >= ge) & bool(keep), d.astype(np.float32) > np.float32(t))


def _scheme_frames(kind: str, H: int, W: int, seed: int) -> tuple:
    rng = np.random.default_rng(seed)
    cur = rng.uniform(0, 255, (H, W))
    prev = np.clip(cur + rng.normal(scale=45.0, size=(H, W)), 0, 255)
    if kind == "u8":
        return np.round(cur).astype(np.uint8), np.round(prev).astype(np.uint8)
    cur, prev = cur.astype(np.float32), prev.astype(np.float32)
    if kind == "nan":
        cur[rng.random((H, W)) < 0.2] = np.nan
        prev[rng.random((H, W)) < 0.2] = np.nan
    if kind == "equal":                                   # the all-0 map
        prev = cur.copy()
    return cur, prev


# Widths 1-9 and 13 (ragged last strips), heights 1-3 (bands past the
# frame), and wider frames whose warps' edge lanes load the column beyond.
SCHEME_SHAPES = [(H, W) for H in (1, 2, 3) for W in (*range(1, 10), 13)] \
    + [(5, 129), (3, 260), (9, 516)]


@pytest.mark.parametrize("threshold", [0.0, DEFAULT_THRESHOLD, -1.0, 12.5])
@pytest.mark.parametrize("kind", ["float", "u8", "nan", "equal"])
@pytest.mark.parametrize("R", [1, 2, 4, 8])   # the kernel's R is 4
def test_bit_majority_scheme_is_the_plain_version_and_the_reference(R, kind, threshold):
    for i, (H, W) in enumerate(SCHEME_SHAPES):
        cur, prev = _scheme_frames(kind, H, W, seed=i)
        got = _bit_majority(cur, prev, threshold, R)
        c32, p32 = cur.astype(np.float32), prev.astype(np.float32)
        want = motion_post_ref(torch.tensor(c32), torch.tensor(p32), threshold).numpy()
        assert np.array_equal(got, want), (H, W)
        ref = np.asarray(ref_motion_post_ref(jnp.asarray(c32), jnp.asarray(p32), threshold))
        assert np.array_equal(got, ref), (H, W)
        if threshold == -1.0 and kind != "nan":
            assert np.all(got == 255.0)                   # the all-255 map
        if kind == "equal" and threshold >= 0:
            assert np.all(got == 0.0)

"""The plain PyTorch Gauss blur (B3's oracle) against the reference's
``gauss5x5`` through both its routes (``impl="xla"``, the 25-tap version,
and ``impl="pallas"`` in interpret mode, the separable kernel), and the
wrapper's CPU contract.  The Hopper kernel itself runs only on the card
(``chip_smoke.py`` holds it against the plain version there).

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
                                          gauss5x5_ref, to_u8)

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
    got = gauss5x5(torch.tensor(x))
    assert got.dtype == torch.uint8 and tuple(got.shape) == shape
    assert np.array_equal(got.numpy(), _ref_u8(blurred))


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
    out = gauss5x5(x)
    assert gauss5x5_cuda.launches == before
    assert torch.equal(out, to_u8(gauss5x5_ref(x.float())))
    with pytest.raises(ValueError, match="CUDA tensor"):
        gauss5x5_cuda(x)
    assert gauss5x5_cuda.launches == before

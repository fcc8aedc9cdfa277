"""The plain PyTorch Thres + Med tail (B4's oracle) against the reference's
``motion_post`` through both its routes (``impl="xla"`` and
``impl="pallas"`` in interpret mode) and against its ``thres_ref``,
``med_ref`` and ``median5``: exactly, since only compares, ``abs``, one
subtraction and min/max are involved.  The Hopper kernel itself runs only
on the card (``chip_smoke.py`` holds it against the plain version there).
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
from repro_torch.kernels.motion_post import (DEFAULT_THRESHOLD, med_ref, median5,
                                             motion_post, motion_post_cuda,
                                             thres_ref)

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
    kw = dict(impl="pallas", interpret=True, block_h=shape[0] // 4) \
        if impl == "pallas" else dict(impl="xla")
    ref = np.asarray(ref_motion_post(jnp.asarray(cur), jnp.asarray(prev), **kw))
    got = motion_post(torch.tensor(cur), torch.tensor(prev))
    assert got.dtype == torch.float32
    assert np.array_equal(got.numpy(), ref)
    assert 0 < np.count_nonzero(ref) < ref.size      # both outcomes occur


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

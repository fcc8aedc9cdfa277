"""The plain PyTorch DPD branch against the reference's ``branch_ref`` and
its Pallas kernel (interpret mode), and the wrapper's CPU contract.  The
Hopper kernel itself runs only on the card (``chip_smoke.py`` holds it
against the plain version there)."""
from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.dyn_fir.kernel import dpd_branch_pallas
from repro.kernels.dyn_fir.ref import branch_ref as jax_branch_ref
from repro_torch.kernels import _build
from repro_torch.kernels.dyn_fir import (N_TAPS, branch_ref, dpd_branch,
                                         dpd_branch_cuda, poly_branch)

REL_TOL = 1e-5
L = 1024


def _inputs(seed):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(2, L + N_TAPS - 1)).astype(np.float32)
    h = rng.normal(scale=0.3, size=(2, N_TAPS)).astype(np.float32)
    return x, h


def _assert_close(ref_planes, got_planes):
    for r, g in zip(ref_planes, got_planes):
        r, g = np.asarray(r, np.float64), np.asarray(g, np.float64)
        assert np.abs(g - r).max() <= REL_TOL * np.abs(r).max()


@pytest.mark.parametrize("order", range(1, 11))
def test_plain_matches_jax_branch_ref(order):
    x, h = _inputs(order)
    ref = jax_branch_ref(jnp.asarray(x[0]), jnp.asarray(x[1]),
                         jnp.asarray(h[0]), jnp.asarray(h[1]), order)
    got = branch_ref(torch.tensor(x[0]), torch.tensor(x[1]),
                     torch.tensor(h[0]), torch.tensor(h[1]), order)
    _assert_close(ref, [t.numpy() for t in got])


@pytest.mark.parametrize("order", range(1, 11))
def test_plain_matches_pallas_interpret(order):
    x, h = _inputs(100 + order)
    ref = dpd_branch_pallas(jnp.asarray(x[0]), jnp.asarray(x[1]),
                            jnp.asarray(h[0]), jnp.asarray(h[1]),
                            order=order, block=512, interpret=True)
    got = branch_ref(torch.tensor(x[0]), torch.tensor(x[1]),
                     torch.tensor(h[0]), torch.tensor(h[1]), order)
    _assert_close(ref, [t.numpy() for t in got])


@pytest.mark.parametrize("order", [1, 4, 10])
def test_cpu_wrappers_take_the_plain_version_without_launching(order):
    x, h = _inputs(order)
    xt, ht = torch.tensor(x), torch.tensor(h)
    before = dpd_branch_cuda.launches
    y_re, y_im = dpd_branch(xt[0], xt[1], ht[0], ht[1], order)
    y, next_hist = poly_branch(xt[:, :N_TAPS - 1], xt[:, N_TAPS - 1:], ht, order)
    assert dpd_branch_cuda.launches == before
    ref = branch_ref(xt[0], xt[1], ht[0], ht[1], order)
    assert torch.equal(y_re, ref[0]) and torch.equal(y_im, ref[1])
    assert torch.equal(y, torch.stack(ref))
    assert torch.equal(next_hist, xt[:, -(N_TAPS - 1):])


@pytest.mark.parametrize("length", [1, 4, 9, 300])
def test_poly_branch_next_history_is_the_streams_last_nine(length):
    # The reference's Poly keeps concat([hist, win])[-9:], also for L < 9.
    rng = np.random.default_rng(length)
    hist = rng.normal(size=(2, N_TAPS - 1)).astype(np.float32)
    win = rng.normal(size=(2, length)).astype(np.float32)
    h = rng.normal(scale=0.3, size=(2, N_TAPS)).astype(np.float32)
    _, next_hist = poly_branch(torch.tensor(hist), torch.tensor(win),
                               torch.tensor(h), 3)
    want = np.concatenate([hist, win], axis=1)[:, -(N_TAPS - 1):]
    assert np.array_equal(next_hist.numpy(), want)


def test_kernel_wrapper_refuses_cpu_tensors():
    x, h = _inputs(0)
    xt, ht = torch.tensor(x), torch.tensor(h)
    before = dpd_branch_cuda.launches
    with pytest.raises(ValueError, match="CUDA tensor"):
        dpd_branch_cuda(xt[:, :9], xt[:, 9:], ht, 3)
    assert dpd_branch_cuda.launches == before


def test_build_raises_without_nvcc(monkeypatch, tmp_path):
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(_build.shutil, "which", lambda name: None)
    monkeypatch.setattr(_build.os.path, "exists", lambda path: False)
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.build("dyn_fir")


def test_library_path_is_keyed_by_source_and_targets_sm90a(monkeypatch, tmp_path):
    assert "arch=compute_90a,code=sm_90a" in _build.NVCC_FLAGS
    monkeypatch.setattr(_build, "CSRC", tmp_path)
    src = tmp_path / "k.cu"
    src.write_text("// one\n")
    first = _build.library_path("k")
    src.write_text("// two\n")
    assert _build.library_path("k") != first
    assert first.parent == _build.BUILD_DIR and first.suffix == ".so"

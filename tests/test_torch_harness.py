"""Parity harness between the JAX reference (``repro``) and the PyTorch port
(``repro_torch``), with tests of its own.

* ``jax_literal``: the reference's ``NetworkBuilder.build`` reads
  ``jax.core.Literal``, which newer jax moved to ``jax.extend.core``.  The
  fixture aliases it for one test only; it is never installed at import,
  so test files that do not ask for it see jax as it is.
* ``ref_leaves`` / ``port_leaves``: both states flattened to numpy in the
  reference's pytree leaf order.
* ``assert_leaves_match``: integer leaves (cursors, indices, control
  rings) exactly; float leaves within ``rel * max|ref|`` per (re, im)
  plane.  Exact bytes are not the bar across frameworks: JAX-CPU and
  torch-CPU round the DPD branch differently in the last bits.
"""
from __future__ import annotations

from typing import Dict, List, Sequence

import jax
import numpy as np
import pytest
import torch

from repro_torch.convert import state_to_numpy

#: Float tolerance, relative to the largest magnitude of each plane.
REL_TOL = 1e-5

_HAD_LITERAL = hasattr(jax.core, "Literal")


@pytest.fixture
def jax_literal(monkeypatch):
    """Alias ``jax.core.Literal`` for the duration of one test."""
    if not hasattr(jax.core, "Literal"):
        from jax.extend.core import Literal
        monkeypatch.setattr(jax.core, "Literal", Literal, raising=False)


def ref_leaves(state) -> List[np.ndarray]:
    return [np.asarray(x) for x in jax.tree.leaves(state)]


def port_leaves(state) -> List[np.ndarray]:
    return state_to_numpy(state)


def _planes(x: np.ndarray) -> List[np.ndarray]:
    """(re, im) planes of a complex-as-planes leaf, else the whole leaf."""
    if x.ndim >= 2 and x.shape[-2] == 2:
        return [x[..., 0, :], x[..., 1, :]]
    return [x]


def assert_leaves_match(ref: Sequence[np.ndarray], port: Sequence[np.ndarray],
                        rel: float = REL_TOL) -> None:
    assert len(ref) == len(port), f"{len(ref)} reference leaves vs {len(port)} port leaves"
    for i, (r, p) in enumerate(zip(ref, port)):
        r, p = np.asarray(r), np.asarray(p)
        assert r.shape == p.shape, f"leaf {i}: shape {r.shape} vs {p.shape}"
        if r.dtype.kind in "iub":
            assert p.dtype.kind in "iub", f"leaf {i}: {r.dtype} vs {p.dtype}"
            assert np.array_equal(r, p), f"leaf {i}: integers differ"
            continue
        assert p.dtype == r.dtype, f"leaf {i}: {r.dtype} vs {p.dtype}"
        for rp, pp in zip(_planes(r.astype(np.float64)), _planes(p.astype(np.float64))):
            if rp.size == 0:
                continue
            bound = rel * np.abs(rp).max()
            err = np.abs(pp - rp).max()
            assert err <= bound, f"leaf {i}: |Δ| {err:.3g} > {rel} * max|y| = {bound:.3g}"


def assert_runs_match(ref_result, port_result, rel: float = REL_TOL) -> None:
    """Sweeps and fire counts exactly, then every state leaf."""
    if ref_result.sweeps is not None:
        assert int(ref_result.sweeps) == port_result.sweeps
        counts: Dict[str, int] = {k: int(v) for k, v in ref_result.fire_counts.items()}
        assert counts == port_result.fire_counts
    assert_leaves_match(ref_leaves(ref_result.state), port_leaves(port_result.state), rel)


# --------------------------------------------------------------------------- #
# Tests of the harness itself.
# --------------------------------------------------------------------------- #
def test_literal_fixture_installs_alias(jax_literal):
    assert hasattr(jax.core, "Literal")


def test_literal_alias_does_not_outlive_its_test():
    assert hasattr(jax.core, "Literal") == _HAD_LITERAL


def test_integer_leaves_compare_exactly():
    ref = [np.arange(4, dtype=np.int32), np.asarray(3, np.int32)]
    assert_leaves_match(ref, [np.arange(4, dtype=np.int32), np.asarray(3, np.int32)])
    with pytest.raises(AssertionError, match="integers differ"):
        assert_leaves_match(ref, [np.arange(4, dtype=np.int32), np.asarray(4, np.int32)])


@pytest.mark.parametrize("scale,ok", [(0.5e-5, True), (2e-5, False)])
def test_float_tolerance_is_relative_per_plane(scale, ok):
    rng = np.random.default_rng(0)
    ref = rng.normal(size=(1, 2, 64)).astype(np.float32)
    ref[:, 1] *= 1e-3                  # a small plane is held to its own scale
    got = ref.copy()
    got[0, 1, 5] += scale * np.abs(ref[0, 1]).max()
    if ok:
        assert_leaves_match([ref], [got])
    else:
        with pytest.raises(AssertionError, match="max"):
            assert_leaves_match([ref], [got])


def test_leaf_count_and_shape_mismatch_fail():
    a = np.zeros((2, 3), np.float32)
    with pytest.raises(AssertionError, match="leaves"):
        assert_leaves_match([a], [a, a])
    with pytest.raises(AssertionError, match="shape"):
        assert_leaves_match([a], [np.zeros((3, 2), np.float32)])


def test_init_state_leaves_line_up_with_reference(jax_literal):
    from repro.graphs.factories import make_dpd as ref_make_dpd
    from repro_torch.graphs.factories import make_dpd
    ref_net, _ = ref_make_dpd(block_l=64)
    net, _ = make_dpd(block_l=64, device="cpu")
    ref = ref_leaves(ref_net.init_state())
    port = port_leaves(net.init_state())
    # Signal, taps, zero rings and cursors are staged identically: exact.
    assert_leaves_match(ref, port, rel=0.0)
    assert [x.dtype for x in port] == [
        np.dtype(np.int32) if x.dtype.kind == "i" else x.dtype for x in ref]


def test_port_leaves_are_host_copies():
    from repro_torch.graphs.factories import make_dpd
    net, _ = make_dpd(n_firings=2, block_l=32, device="cpu")
    st = net.init_state()
    leaves = port_leaves(st)
    leaves[0][...] = 7
    assert not torch.any(st.fifos[0].buf == 7)

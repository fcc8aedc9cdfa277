"""The port's motion detection network against the reference's, on the CPU.

Motion detection is held to the reference **exactly**: the video is
rounded to u8 at the source, every partial sum of the blur is then a
multiple of 1/256 below 256 (exact in float32 in any order), and Thres and
Med only compare.  So every leaf of every state (rings, the delay ring's
copied-back slot 0, cursors, slabs), fire counts and sweeps must equal the
reference's, in static, dynamic and interpreted mode, at rates 1 and 4.
"""
from __future__ import annotations

import jax
import numpy as np
import pytest
import torch

from repro.graphs.factories import make_motion_detection as ref_make_md
from repro.graphs.motion_detection import bench_workload as ref_bench_workload
from repro.graphs.motion_detection import build_motion_detection as ref_build_md
from repro_torch.convert import state_from_numpy
from repro_torch.graphs.factories import make_motion_detection, states_equal
from repro_torch.graphs.motion_detection import (FRAME_H, FRAME_W, bench_workload,
                                                 build_motion_detection)
from repro_torch.kernels.gauss5x5 import gauss5x5_cuda
from test_torch_harness import (assert_leaves_match, assert_runs_match,
                                jax_literal, port_leaves, ref_leaves)

__all__ = ["jax_literal"]  # the fixture is used by name

SMALL = (48, 64)
FIFOS = ["f_src_gauss", "f_gauss_thres", "f_gauss_thres_d", "f_thres_med",
         "f_med_sink"]


def _pair(rate, n_frames=12, frame_hw=SMALL, seed=1):
    ref_net, n = ref_make_md(n_frames, rate=rate, frame_hw=frame_hw, seed=seed)
    net, _ = make_motion_detection(n_frames, rate=rate, frame_hw=frame_hw,
                                   seed=seed, device="cpu")
    return ref_net, net, n


def _dtype_name(dtype) -> str:
    if isinstance(dtype, torch.dtype):
        return str(dtype).split(".")[-1]
    return np.dtype(dtype).name


def _spec_key(spec):
    return (spec.name, spec.rate, tuple(spec.token_shape), _dtype_name(spec.dtype),
            spec.delay, spec.is_control, spec.capacity_tokens, spec.capacity_bytes,
            spec.n_write_phases, spec.writable_occupancy_bound)


@pytest.mark.parametrize("rate", [1, 4])
def test_fifos_and_actors_equal_reference(jax_literal, rate):
    ref_net, net, _ = _pair(rate)
    assert list(net.fifos) == list(ref_net.fifos) == FIFOS
    assert list(net.actors) == list(ref_net.actors)
    assert [_spec_key(s) for s in net.fifos.values()] == \
        [_spec_key(s) for s in ref_net.fifos.values()]
    assert net.register_fifos == ref_net.register_fifos == frozenset()
    assert net.topological_order() == ref_net.topological_order()
    assert net.delay_partition_constraints() == ref_net.delay_partition_constraints()


@pytest.mark.parametrize("rate,nbytes", [(4, 3_456_000), (1, 921_600)])
def test_buffer_bytes_full_frame_is_table1(jax_literal, rate, nbytes):
    ref = ref_build_md(4, rate=rate).buffer_bytes()
    net = build_motion_detection(4, rate=rate, device="cpu")
    assert net.buffer_bytes() == ref == nbytes
    assert net.compile(mode="dynamic").stats().buffer_bytes == nbytes
    assert (FRAME_H, FRAME_W) == (240, 320)


def test_init_state_equals_reference_exactly(jax_literal):
    ref = ref_leaves(ref_bench_workload(8, rate=4, frame_hw=SMALL).init_state())
    got = port_leaves(bench_workload(8, rate=4, frame_hw=SMALL, device="cpu").init_state())
    assert_leaves_match(ref, got, rel=0.0)
    assert [x.dtype for x in got] == [
        np.dtype(np.int32) if x.dtype.kind == "i" else x.dtype for x in ref]
    assert got[-4].dtype == np.uint8 and got[-4].any()       # the staged video


PLANS = {
    "dynamic": lambda n: dict(mode="dynamic"),
    "dynamic_single": lambda n: dict(mode="dynamic", multi_firing=False),
    "static": lambda n: dict(mode="static", n_iterations=n),
    "static_unspecialized": lambda n: dict(mode="static", n_iterations=n,
                                           specialize=False),
    "interpreted": lambda n: dict(mode="interpreted", n_iterations=n),
}


@pytest.mark.parametrize("plan", sorted(PLANS))
@pytest.mark.parametrize("rate", [1, 4])
def test_modes_equal_reference_exactly(jax_literal, rate, plan):
    ref_net, net, n = _pair(rate)
    kw = PLANS[plan](n)
    ref = ref_net.compile(**kw).run()
    got = net.compile(**kw).run()
    if kw["mode"] == "dynamic":
        assert_runs_match(ref, got, rel=0.0)
        assert set(got.fire_counts.values()) == {n}
        if plan == "dynamic" and rate == 4:
            assert got.sweeps == 3
    else:
        assert_leaves_match(ref_leaves(ref.state), port_leaves(got.state), rel=0.0)
    assert got.state.fifo("f_gauss_thres_d").wr == n


def test_paper_frame_size_equals_reference(jax_literal):
    ref_net, net, n = _pair(4, n_frames=48, frame_hw=(FRAME_H, FRAME_W), seed=0)
    ref = ref_net.compile(mode="dynamic").run()
    got = net.compile(mode="dynamic").run()
    assert n == 12 and got.sweeps == int(ref.sweeps)
    assert_runs_match(ref, got, rel=0.0)


def test_run_from_reference_init_state_ends_equal(jax_literal):
    ref_net, net, _ = _pair(4, seed=9)
    leaves = ref_leaves(ref_net.init_state())
    # A delay token that is not zeros, so the shared start matters.
    d = 4 * FIFOS.index("f_gauss_thres_d")     # its ring: buf, rd, wr, occ
    leaves[d] = leaves[d].copy()
    leaves[d][0] = np.arange(SMALL[0] * SMALL[1]).reshape(SMALL) % 251
    ref_st = jax.tree.unflatten(jax.tree.structure(ref_net.init_state()),
                                [jax.numpy.asarray(x) for x in leaves])
    st = state_from_numpy(net, leaves)
    assert_leaves_match(leaves, port_leaves(st), rel=0.0)
    assert st.fifo("f_gauss_thres_d").buf.dtype == torch.uint8
    ref = ref_net.compile(mode="dynamic").run(ref_st)
    got = net.compile(mode="dynamic").run(st)
    assert_runs_match(ref, got, rel=0.0)


@pytest.mark.parametrize("rate", [1, 4])
def test_static_resumes_from_a_phase_misaligned_state(jax_literal, rate):
    """The reference's specialized static mode raises on a state advanced
    by part of its unroll period; the port's eager cursors take it, and
    continue to the reference's ``specialize=False`` result."""
    ref_net, net, n = _pair(rate)
    ref_one = ref_net.compile(mode="static", n_iterations=1,
                              specialize=False).run().state
    with pytest.raises(ValueError):
        ref_net.compile(mode="static", n_iterations=n - 1).run(ref_one)
    ref = ref_net.compile(mode="static", n_iterations=n - 1,
                          specialize=False).run(ref_one)
    st = state_from_numpy(net, ref_leaves(ref_one))
    got = net.compile(mode="static", n_iterations=n - 1).run(st)
    assert_leaves_match(ref_leaves(ref.state), port_leaves(got.state), rel=0.0)


def test_cpu_run_launches_no_kernel_and_collects_the_sink():
    net, n = make_motion_detection(12, rate=4, frame_hw=SMALL, device="cpu")
    before = gauss5x5_cuda.launches
    prog = net.compile(mode="dynamic")
    res = prog.run()
    assert gauss5x5_cuda.launches == before
    out = prog.collect("sink")
    assert out.dtype == torch.uint8 and tuple(out.shape) == (12,) + SMALL
    assert set(torch.unique(out).tolist()) == {0, 255}
    static = net.compile(mode="static", n_iterations=n).run().state
    assert states_equal(static, res.state)


def test_no_device_and_no_gpu_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        build_motion_detection(4, rate=4, frame_hw=SMALL)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make_motion_detection(frame_hw=SMALL)


def test_rejects_a_frame_count_the_rate_does_not_divide():
    with pytest.raises(ValueError, match="divisible"):
        build_motion_detection(10, rate=4, frame_hw=SMALL, device="cpu")

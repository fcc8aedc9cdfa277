"""The port's DPD network against the reference's, on the CPU at small
sizes: structure (fire counts, sweeps, cursors, integer leaves,
``register_fifos``, ``buffer_bytes``) exactly, float tokens within
``1e-5 * max|y|`` per plane."""
from __future__ import annotations

import numpy as np
import pytest
import torch

from repro.graphs.dpd import build_dpd as ref_build_dpd
from repro.graphs.factories import make_dpd as ref_make_dpd
from repro_torch.convert import state_from_numpy, state_to_numpy
from repro_torch.core import ExecutionPlan
from repro_torch.graphs.dpd import build_dpd, default_active_schedule
from repro_torch.graphs.factories import make_dpd, states_equal
from repro_torch.kernels.dyn_fir import dpd_branch_cuda
from test_torch_harness import (assert_leaves_match, assert_runs_match,
                                jax_literal, port_leaves, ref_leaves)

__all__ = ["jax_literal"]  # the fixture is used by name

DPD_REGISTER_FIFOS = (
    {f"f_b{k}" for k in range(10)} | {f"f_y{k}" for k in range(10)}
    | {f"f_c{k}" for k in range(10)} | {"f_c_add", "f_c_fork", "f_in", "f_out"})


@pytest.mark.parametrize("block_l", [256, 1024])
def test_register_fifos_equal_reference(jax_literal, block_l):
    ref_net, _ = ref_make_dpd(block_l=block_l)
    net, _ = make_dpd(block_l=block_l, device="cpu")
    assert set(net.register_fifos) == set(ref_net.register_fifos) == DPD_REGISTER_FIFOS
    assert list(net.fifos) == list(ref_net.fifos)
    assert list(net.actors) == list(ref_net.actors)


def test_static_all_active_registers_nothing(jax_literal):
    ref_net, _ = ref_make_dpd(static_all_active=True)
    net, _ = make_dpd(static_all_active=True, device="cpu")
    assert net.register_fifos == ref_net.register_fifos == frozenset()


def test_buffer_bytes_full_width_is_table1(jax_literal):
    ref = ref_build_dpd(2, block_l=32768).buffer_bytes()
    net = build_dpd(2, block_l=32768, device="cpu")
    assert net.buffer_bytes() == ref == 11_534_432
    assert net.compile(mode="dynamic").stats().buffer_bytes == 11_534_432


def test_dynamic_defaults_match_reference(jax_literal):
    ref_net, _ = ref_make_dpd()
    net, _ = make_dpd(device="cpu")
    ref = ref_net.compile(mode="dynamic").run()
    got = net.compile(mode="dynamic").run()
    assert got.sweeps == 4
    assert set(got.fire_counts.values()) == {6}   # rate-0 firings count
    assert_runs_match(ref, got)


def test_dynamic_single_firing_matches_reference(jax_literal):
    ref_net, _ = ref_make_dpd()
    net, _ = make_dpd(device="cpu")
    ref = ref_net.compile(mode="dynamic", multi_firing=False).run()
    got = net.compile(mode="dynamic", multi_firing=False).run()
    assert got.sweeps == int(ref.sweeps) == 7
    assert_runs_match(ref, got)


@pytest.mark.parametrize("specialize", [True, False])
@pytest.mark.parametrize("static_all_active", [False, True])
def test_static_matches_reference(jax_literal, static_all_active, specialize):
    ref_net, n = ref_make_dpd(block_l=512, static_all_active=static_all_active)
    net, _ = make_dpd(block_l=512, static_all_active=static_all_active, device="cpu")
    plan = dict(mode="static", n_iterations=n, specialize=specialize)
    assert_runs_match(ref_net.compile(**plan).run(), net.compile(**plan).run())


def test_run_from_reference_init_state_ends_equal(jax_literal):
    sched = default_active_schedule(8, seed=3)
    ref_net, _ = ref_make_dpd(8, block_l=256, seed=5, active_schedule=sched)
    net, _ = make_dpd(8, block_l=256, seed=5, active_schedule=sched, device="cpu")
    # Perturb the reference's starting state so the shared start matters.
    ref_st = ref_net.init_state()
    leaves = ref_leaves(ref_st)
    for i, x in enumerate(leaves):
        if x.dtype == np.float32 and x.shape == (2, 9):       # Poly histories
            leaves[i] = np.full_like(x, 0.25 * (i % 7))
    import jax
    ref_st = jax.tree.unflatten(jax.tree.structure(ref_st),
                                [jax.numpy.asarray(x) for x in leaves])
    st = state_from_numpy(net, leaves)
    assert_leaves_match(leaves, port_leaves(st), rel=0.0)
    ref = ref_net.compile(mode="dynamic").run(ref_st)
    got = net.compile(mode="dynamic").run(st)
    assert_runs_match(ref, got)


def test_state_numpy_round_trip_is_exact():
    net, _ = make_dpd(device="cpu")
    res = net.compile(mode="dynamic").run()
    back = state_from_numpy(net, state_to_numpy(res.state))
    assert states_equal(back, res.state)
    assert back.fifo("f_c0").buf.device.type == "cpu"
    with pytest.raises(ValueError, match="leaves"):
        state_from_numpy(net, state_to_numpy(res.state)[:-1])


def test_no_device_and_no_gpu_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        build_dpd(2, block_l=64)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make_dpd()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        build_dpd(2, block_l=64, device="cuda")


@pytest.mark.parametrize("field,value", [
    ("donate", True), ("donate_threshold_bytes", 1), ("unroll_bound", 6), ("accelerated", ("poly0",)), ("devices", 2),
    ("device_assign", {})])
def test_unported_plan_fields_raise(field, value):
    if field == "accelerated":
        # Ported with heterogeneous placement (ROADMAP A11): the plan
        # constructs, the network judges it (the feed and fetch slabs need
        # n_iterations), and it runs.
        net, _ = make_dpd(n_firings=2, block_l=32, device="cpu")
        with pytest.raises(ValueError, match="pass n_iterations"):
            net.compile(mode="dynamic", **{field: value})
        prog = net.compile(mode="dynamic", n_iterations=2, **{field: value})
        assert prog.plan.accelerated == value and "__feed_f_b0" in prog.network.actors
        return
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        ExecutionPlan(mode="dynamic", **{field: value})
    net, _ = make_dpd(n_firings=2, block_l=32, device="cpu")
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        net.compile(mode="dynamic", **{field: value})


@pytest.mark.parametrize("field,value,msg", [
    ("interpret", True, "interpret"), ("cores", 2, "grid-partition knobs"),
    ("assign", {}, "grid-partition knobs"),
    ("cut_objective", "flops", "grid-partition knobs")])
def test_grid_knobs_off_megakernel_raise(field, value, msg):
    net, _ = make_dpd(n_firings=2, block_l=32, device="cpu")
    with pytest.raises(ValueError, match=msg):
        net.compile(mode="dynamic", **{field: value})


@pytest.mark.parametrize("mode", ["megakernel", "interpreted"])
def test_unported_modes_raise(mode):
    """Named for the raise it checked while these modes were unported; both
    are ported now (megakernel: ROADMAP A5, interpreted: A3), so their
    plans construct, and interpreted mode runs DPD as static mode without
    forwarding does."""
    if mode == "megakernel":
        assert ExecutionPlan(mode=mode).mode == "megakernel"
        return
    assert ExecutionPlan(mode=mode, n_iterations=2).mode == "interpreted"
    with pytest.raises(ValueError, match="n_iterations"):
        ExecutionPlan(mode=mode)
    net, n = make_dpd(device="cpu")
    got = net.compile(mode=mode, n_iterations=n).run()
    want = net.compile(mode="static", n_iterations=n, specialize=False).run()
    assert got.sweeps is None and states_equal(got.state, want.state)


def test_plan_validation():
    with pytest.raises(ValueError, match="n_iterations"):
        ExecutionPlan(mode="static")
    with pytest.raises(ValueError, match="mode"):
        ExecutionPlan(mode="eager")


def test_run_never_mutates_the_callers_state_unless_asked():
    net, _ = make_dpd(device="cpu")
    prog = net.compile(mode="dynamic")
    st = net.init_state()
    before = state_to_numpy(st)
    res = prog.run(st)
    assert_leaves_match(before, state_to_numpy(st), rel=0.0)
    res2 = prog.run(st, in_place=True)
    assert res2.state is st
    assert states_equal(res.state, st)


def test_cpu_run_launches_no_kernel_and_collects_the_sink():
    net, _ = make_dpd(device="cpu")
    before = dpd_branch_cuda.launches
    prog = net.compile(mode="static", n_iterations=6)
    prog.run()
    assert dpd_branch_cuda.launches == before
    out = prog.collect("sink")
    assert tuple(out.shape) == (2, 6 * 256) and torch.isfinite(out).all()
    stats = prog.stats()
    assert stats.register_fifos == tuple(sorted(DPD_REGISTER_FIFOS))
    assert (stats.n_actors, stats.n_fifos) == (15, 34)


def test_dynamic_stats_report_last_run():
    net, _ = make_dpd(device="cpu")
    prog = net.compile(mode="dynamic")
    res = prog.run()
    stats = prog.stats()
    assert stats.last_sweeps == res.sweeps == 4
    assert stats.last_fire_counts == res.fire_counts


def test_static_specialize_requires_drained_transients():
    net, _ = make_dpd(device="cpu")
    st = net.init_state()
    st.fifo("f_in").occ = 1
    with pytest.raises(ValueError, match="drained"):
        net.compile(mode="static", n_iterations=1).run(st)


def test_sweep_budget_exhaustion_warns():
    net, _ = make_dpd(device="cpu")
    with pytest.warns(RuntimeWarning, match="max_sweeps"):
        res = net.compile(mode="dynamic", max_sweeps=1).run()
    assert res.stalled and res.sweeps == 1


def test_static_modes_agree_within_the_port():
    net, n = make_dpd(device="cpu")
    a = net.compile(mode="static", n_iterations=n).run().state
    b = net.compile(mode="static", n_iterations=n, specialize=False).run().state
    c = net.compile(mode="dynamic").run().state
    # Live tokens and every actor state agree exactly; only the dead slots
    # of the forwarded rings differ (the MoC leaves them unspecified).
    for other in (b, c):
        assert torch.equal(a.actor("sink")[0], other.actor("sink")[0])
        for k in range(10):
            assert torch.equal(a.actor(f"poly{k}")[0], other.actor(f"poly{k}")[0])
        assert [(f.rd, f.wr, f.occ) for f in a.fifos] == \
            [(f.rd, f.wr, f.occ) for f in other.fifos]

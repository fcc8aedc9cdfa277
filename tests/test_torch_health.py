"""The port's health layer (``core/health.py``, ``ExecutionPlan(guards=True)``)
against the JAX package's, on the CPU, for the host dynamic executor and
the megakernel backend (B2's plain version) at ``cores=1`` and ``cores=2``.

Mirrors ``tests/test_faults.py``.  The bars (structure exact, ROADMAP's
parity rule):

* a clean guarded run is bit-identical to an unguarded one (states,
  cursors, fire counts, sweeps);
* each fault injected on DPD's ``f_in`` raises :class:`NetworkFaultError`
  with the reference's diagnostics exactly (every faulting channel, its
  fault names, high-water marks, the stalled flag and stall forensics);
* the partial state of a faulty run is bit-identical across the port's
  backends, and within hazard C2's float tolerance of the reference's;
* ``check_bounds`` gives the reference's verdicts and messages.

Megakernel plans run ``specialize=False``, as the reference's chaos suite
does: injected faults target ring cursors, and forwarded channels refuse a
state that is not drained.
"""
from __future__ import annotations

import warnings

import jax
import numpy as np
import pytest
import torch

from repro.core import ExecutionPlan as RefPlan
from repro.core import NetworkFaultError as RefFaultError
from repro.core import faultinject as ref_fi
from repro.graphs.factories import make_dpd as ref_make_dpd
from repro.graphs.factories import make_motion_detection as ref_make_md
from repro_torch.core import ExecutionPlan, NetworkBuilder, dynamic_actor, static_actor
from repro_torch.core import faultinject as fi
from repro_torch.core.executor import _can_fire, _max_fireable, fire_actor
from repro_torch.core.health import (CURSOR_INVALID, NONFINITE, OVERFLOW,
                                     UNDERFLOW, NetworkFaultError, fault_names)
from repro_torch.graphs.factories import make_dpd, make_motion_detection, states_equal
from test_torch_harness import REL_TOL, jax_literal, port_leaves, ref_leaves  # noqa: F401

BACKENDS = ("dynamic", "megakernel", "grid2")
MD_HW = (48, 64)

FAULTS = {
    "overflow": ("inject_overflow", {}, OVERFLOW),
    "underflow": ("inject_underflow", {}, UNDERFLOW),
    "cursor": ("corrupt_cursor", {"occ": 1}, CURSOR_INVALID),
    "nonfinite": ("poison_tokens", {}, NONFINITE),
}


def _kw(backend, **kw):
    if backend == "dynamic":
        return dict(mode="dynamic", **kw)
    return dict(mode="megakernel", specialize=False,
                cores={"megakernel": 1, "grid2": 2}[backend], **kw)


def _ref_build(make, *args, **kw):
    with pytest.MonkeyPatch.context() as mp:
        if not hasattr(jax.core, "Literal"):
            from jax.extend.core import Literal
            mp.setattr(jax.core, "Literal", Literal, raising=False)
        net, _ = make(*args, **kw)
    return net


@pytest.fixture(scope="module")
def nets():
    return (_ref_build(ref_make_dpd, n_firings=6, block_l=64),
            make_dpd(n_firings=6, block_l=64, device="cpu")[0])


def _inject(mod, net, fault):
    st = net.init_state()
    if fault == "clean":
        return st
    name, kw, _ = FAULTS[fault]
    return getattr(mod, name)(net, st, "f_in", **kw)


def _outcome(prog, state, err_type):
    """(result, diagnostics) of a run that may raise its fault error."""
    try:
        res = prog.run(state)
        return res, res.diagnostics
    except err_type as e:
        return e.result, e.diagnostics


@pytest.fixture(scope="module")
def ref_faults(nets):
    """The reference's guarded and traced runs of DPD per (backend, fault),
    one compiled program per backend, run on first use."""
    ref_net = nets[0]
    progs, cache = {}, {}

    def get(backend, fault):
        if (backend, fault) not in cache:
            if backend not in progs:
                progs[backend] = ref_net.compile(RefPlan(**_kw(backend, guards=True,
                                                               trace=True)))
            cache[backend, fault] = _outcome(progs[backend], _inject(ref_fi, ref_net, fault),
                                             RefFaultError)
        return cache[backend, fault]

    return get


def _diag_tuple(d):
    faults = tuple((f.fifo, f.src_actor, f.src_port, f.dst_actor, f.dst_port, int(f.bits),
                    f.faults, int(f.high_water), int(f.occupancy_bound)) for f in d.faults)
    stall = None
    if d.stall is not None:
        stall = (d.stall.runnable, d.stall.blocked, dict(d.stall.occupancy))
    return (bool(d.ok), bool(d.stalled), faults, dict(d.high_water), stall)


def _bits(state):
    return [x.contiguous().view(torch.uint8).numpy().tobytes()
            if isinstance(x, torch.Tensor) else x for x in state.leaves()]


def _assert_partial_states_match(ref_state, port_state):
    """Integers exactly; floats within hazard C2's tolerance per plane, NaN
    where the reference has NaN."""
    for i, (r, p) in enumerate(zip(ref_leaves(ref_state), port_leaves(port_state))):
        r, p = np.asarray(r), np.asarray(p)
        assert r.shape == p.shape, i
        if r.dtype.kind in "iub":
            assert np.array_equal(r, p), f"leaf {i}: integers differ"
            continue
        nan = np.isnan(r)
        assert np.array_equal(nan, np.isnan(p)), f"leaf {i}: NaN positions differ"
        r, p = r[~nan].astype(np.float64), p[~nan].astype(np.float64)
        if r.size:
            assert np.abs(p - r).max() <= REL_TOL * max(np.abs(r).max(), 1e-30), i


# --------------------------------------------------------------------------- #
# Clean runs: guards change nothing.
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("backend", BACKENDS)
def test_clean_guarded_run_bit_identical(nets, ref_faults, backend):
    net = nets[1]
    off = net.compile(ExecutionPlan(**_kw(backend))).run()
    on = net.compile(ExecutionPlan(**_kw(backend, guards=True, trace=True))).run()
    assert states_equal(off.state, on.state)
    assert (off.sweeps, off.fire_counts) == (on.sweeps, on.fire_counts)
    assert on.diagnostics.ok and not on.diagnostics.faults
    assert off.diagnostics is not None and not off.diagnostics.stalled
    assert off.diagnostics.high_water == {} and off.trace is None
    _, ref_diag = ref_faults(backend, "clean")
    assert _diag_tuple(on.diagnostics) == _diag_tuple(ref_diag)


def _oracle_high_water(net):
    """The reference test's eager queue replay: each channel's largest
    occupancy after a firing of its producer."""
    state = net.init_state()
    hw = {f: 0 for f in net.fifos}
    names = list(net.fifos)
    fired_any = True
    while fired_any:
        fired_any = False
        for nm in net.actors:
            for _ in range(_max_fireable(net, nm, state)):
                if not _can_fire(net, nm, state):
                    break
                fire_actor(net, nm, state)
                fired_any = True
                for _, _, fi_ in net.out_port_specs[nm]:
                    hw[names[fi_]] = max(hw[names[fi_]], state.fifos[fi_].occ)
    return hw


def test_high_water_matches_reference_and_queue_oracle(nets, ref_faults):
    net = nets[1]
    res = net.compile(ExecutionPlan(mode="dynamic", guards=True)).run()
    _, ref_diag = ref_faults("dynamic", "clean")
    hw = res.diagnostics.high_water
    assert hw == {k: int(v) for k, v in ref_diag.high_water.items()}
    assert hw == _oracle_high_water(net)
    for name, spec in net.fifos.items():
        assert 0 < hw[name] <= spec.writable_occupancy_bound, name


# --------------------------------------------------------------------------- #
# Injected faults: named like the reference, on every backend.
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("fault", sorted(FAULTS))
def test_injected_fault_named_like_reference(nets, ref_faults, backend, fault):
    net = nets[1]
    prog = net.compile(ExecutionPlan(**_kw(backend, guards=True, trace=True)))
    with pytest.raises(NetworkFaultError) as exc:
        prog.run(_inject(fi, net, fault))
    diag = exc.value.diagnostics
    hit = {f.fifo: f for f in diag.faults}
    assert "f_in" in hit, diag.summary()
    assert set(fault_names(FAULTS[fault][2])) <= set(hit["f_in"].faults)
    assert (hit["f_in"].src_actor, hit["f_in"].dst_actor) == ("source", "fork")
    assert "f_in" in str(exc.value) and exc.value.result.state is not None
    ref_res, ref_diag = ref_faults(backend, fault)
    assert _diag_tuple(diag) == _diag_tuple(ref_diag)
    got = exc.value.result
    assert got.sweeps == int(ref_res.sweeps)
    assert got.fire_counts == {k: int(v) for k, v in ref_res.fire_counts.items()}
    np.testing.assert_array_equal(got.trace.events, np.asarray(ref_res.trace.events))


@pytest.mark.parametrize("fault", sorted(FAULTS))
def test_faulty_partial_state_agrees_across_backends(nets, ref_faults, fault):
    """Bit for bit across the port's three backends; within hazard C2's
    float tolerance of the reference's (NaN where it has NaN)."""
    net = nets[1]
    states = []
    for backend in BACKENDS:
        prog = net.compile(ExecutionPlan(**_kw(backend, guards=True)))
        res, _ = _outcome(prog, _inject(fi, net, fault), NetworkFaultError)
        states.append(res.state)
    assert _bits(states[0]) == _bits(states[1]) == _bits(states[2])
    _assert_partial_states_match(ref_faults("dynamic", fault)[0].state, states[0])


@pytest.mark.parametrize("backend", BACKENDS)
def test_poison_is_pure_nonfinite(nets, backend):
    net = nets[1]
    prog = net.compile(ExecutionPlan(**_kw(backend, guards=True)))
    with pytest.raises(NetworkFaultError) as exc:
        prog.run(fi.poison_tokens(net, net.init_state(), "f_in"))
    assert exc.value.diagnostics.faults
    for f in exc.value.diagnostics.faults:
        assert f.faults == ("NONFINITE",), f.describe()


# --------------------------------------------------------------------------- #
# DOMAIN on a data channel (C11): DPD's f_in declares a domain every clean
# sample lies in, and one finite window outside it is appended.
# --------------------------------------------------------------------------- #
F_IN_DOMAIN = (-16.0, 16.0)


def with_domain(net, fifo, domain, network_cls, **kw):
    """``net`` with channel ``fifo`` declaring ``domain`` (either framework's
    Network class; ``kw`` its extra arguments)."""
    import dataclasses
    fifos = [dataclasses.replace(s, domain=domain) if n == fifo else s
             for n, s in net.fifos.items()]
    return network_cls(list(net.actors.values()), fifos, list(net.edges),
                       initial_tokens=net.initial_tokens, **kw)


@pytest.fixture(scope="module")
def domain_nets(nets):
    from repro.core.network import Network as RefNetwork
    from repro_torch.core import Network
    return (with_domain(nets[0], "f_in", F_IN_DOMAIN, RefNetwork),
            with_domain(nets[1], "f_in", F_IN_DOMAIN, Network, device="cpu"))


@pytest.fixture(scope="module")
def ref_domain(domain_nets):
    cache = {}

    def get(backend):
        if backend not in cache:
            net = domain_nets[0]
            prog = net.compile(RefPlan(**_kw(backend, guards=True, trace=True)))
            cache[backend] = _outcome(
                prog, ref_fi.poison_tokens(net, net.init_state(), "f_in", value=1e3),
                RefFaultError)
        return cache[backend]

    return get


@pytest.mark.parametrize("backend", BACKENDS)
def test_data_channel_domain_named_like_reference(domain_nets, ref_domain, backend):
    """The host dynamic executor and B2's plain version at cores 1 and 2
    flag DOMAIN on f_in where the reference does, with its diagnostics,
    structure and trace; a clean guarded run of the network is healthy."""
    net = domain_nets[1]
    prog = net.compile(ExecutionPlan(**_kw(backend, guards=True, trace=True)))
    assert prog.run().diagnostics.ok
    with pytest.raises(NetworkFaultError) as exc:
        prog.run(fi.poison_tokens(net, net.init_state(), "f_in", value=1e3))
    diag = exc.value.diagnostics
    hit = {f.fifo: f for f in diag.faults}
    assert "DOMAIN" in hit["f_in"].faults and "NONFINITE" not in hit["f_in"].faults
    ref_res, ref_diag = ref_domain(backend)
    assert _diag_tuple(diag) == _diag_tuple(ref_diag)
    got = exc.value.result
    assert got.sweeps == int(ref_res.sweeps)
    assert got.fire_counts == {k: int(v) for k, v in ref_res.fire_counts.items()}
    np.testing.assert_array_equal(got.trace.events, np.asarray(ref_res.trace.events))


def test_data_channel_domain_partial_state_agrees_across_backends(domain_nets, ref_domain):
    net = domain_nets[1]
    states = []
    for backend in BACKENDS:
        prog = net.compile(ExecutionPlan(**_kw(backend, guards=True)))
        res, diag = _outcome(prog, fi.poison_tokens(net, net.init_state(), "f_in",
                                                    value=1e3), NetworkFaultError)
        assert any("DOMAIN" in f.faults for f in diag.faults)
        states.append(res.state)
    assert _bits(states[0]) == _bits(states[1]) == _bits(states[2])
    _assert_partial_states_match(ref_domain("dynamic")[0].state, states[0])


# --------------------------------------------------------------------------- #
# Stall: loud, with forensics.
# --------------------------------------------------------------------------- #
@pytest.fixture(scope="module")
def ref_stalls(nets):
    cache = {}

    def get(backend):
        if backend not in cache:
            prog = nets[0].compile(RefPlan(**_kw(backend, guards=True, max_sweeps=1)))
            cache[backend] = _outcome(prog, None, RefFaultError)[1]
        return cache[backend]

    return get


@pytest.mark.parametrize("backend", BACKENDS)
def test_stall_guarded_raises_with_forensics(nets, ref_stalls, backend):
    net = nets[1]
    prog = net.compile(ExecutionPlan(**_kw(backend, guards=True, max_sweeps=1)))
    with pytest.raises(NetworkFaultError, match="STALL") as exc:
        prog.run()
    diag = exc.value.diagnostics
    assert diag.stalled and diag.stall is not None
    assert diag.stall.runnable or diag.stall.blocked
    assert set(diag.stall.occupancy) == set(net.fifos)
    assert _diag_tuple(diag) == _diag_tuple(ref_stalls(backend))


@pytest.mark.parametrize("backend", BACKENDS)
def test_stall_unguarded_warns_not_silent(nets, backend):
    net = nets[1]
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        r = net.compile(ExecutionPlan(**_kw(backend, max_sweeps=1))).run()
    assert r.diagnostics.stalled and r.stalled
    assert any("sweep budget" in str(w.message) for w in caught)
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        r = net.compile(ExecutionPlan(**_kw(backend))).run()
    assert not r.diagnostics.stalled and not caught


def test_guards_and_trace_rejected_on_sweepless_modes(nets):
    net = nets[1]
    for mode in ("static", "interpreted"):
        with pytest.raises(ValueError, match="guards"):
            net.compile(ExecutionPlan(mode=mode, n_iterations=4, guards=True))
        with pytest.raises(ValueError, match="trace"):
            net.compile(ExecutionPlan(mode=mode, n_iterations=4, trace=True))


# --------------------------------------------------------------------------- #
# Motion detection (u8 tokens, the Fig. 2 delay channel).
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("backend", BACKENDS)
def test_motion_detection_guarded_matches_reference(backend):
    ref_net = _ref_build(ref_make_md, 12, rate=4, frame_hw=MD_HW)
    net, _ = make_motion_detection(12, rate=4, frame_hw=MD_HW, device="cpu")
    kw = {"dynamic": dict(mode="dynamic"), "megakernel": dict(mode="megakernel"),
          "grid2": dict(mode="megakernel", cores=2)}[backend]
    ref = ref_net.compile(RefPlan(guards=True, **kw)).run()
    got = net.compile(ExecutionPlan(guards=True, **kw)).run()
    off = net.compile(ExecutionPlan(**kw)).run()
    assert _diag_tuple(got.diagnostics) == _diag_tuple(ref.diagnostics)
    assert states_equal(got.state, off.state) and got.sweeps == off.sweeps


# --------------------------------------------------------------------------- #
# Build-time bound proofs.
# --------------------------------------------------------------------------- #
def _gated_builders():
    import jax.numpy as jnp
    from repro.core import NetworkBuilder as RefBuilder
    from repro.core import dynamic_actor as ref_dynamic
    from repro.core import static_actor as ref_static

    rb = RefBuilder()
    rb.actor(ref_static("src", (), ("out",),
                        lambda st, ins, rates: (st, {"out": jnp.zeros((2, 4))})))
    rb.actor(ref_static("ctl", (), ("c",),
                        lambda st, ins, rates: (st, {"c": jnp.zeros((1, 1), jnp.int32)})))
    rb.actor(ref_dynamic("gate", "cp", lambda tok: {"in": (tok[0] > 0).astype(jnp.int32)},
                         ("in",), (), lambda st, ins, rates: (st, {})))
    rb.connect("src.out", "gate.in", rate=2, token_shape=(4,), name="f_data")
    rb.connect("ctl.c", "gate.cp", name="f_ctl")

    pb = NetworkBuilder()
    pb.actor(static_actor("src", (), ("out",),
                          lambda st, ins, rates: (st, {"out": torch.zeros((2, 4))})))
    pb.actor(static_actor("ctl", (), ("c",),
                          lambda st, ins, rates: (st, {"c": torch.zeros((1, 1),
                                                                        dtype=torch.int32)})))
    pb.actor(dynamic_actor("gate", "cp", lambda tok: {"in": int(tok[0] > 0)},
                           ("in",), (), lambda st, ins, rates: (st, {})))
    pb.connect("src.out", "gate.in", rate=2, token_shape=(4,), name="f_data")
    pb.connect("ctl.c", "gate.cp", name="f_ctl")
    return rb, pb


BOUNDS_CASES = {
    "undecided": [],
    "unbounded": [("gate.in", 0.25, 0.5)],
    "starved": [("src.out", 0.0, 0.5), ("gate.in", 1.0, 1.0)],
    "balanced": [("gate.in", 1.0, 1.0)],
}


@pytest.mark.parametrize("case", sorted(BOUNDS_CASES))
def test_check_bounds_gives_the_reference_verdicts(jax_literal, case):
    rb, pb = _gated_builders()
    for ep, lo, hi in BOUNDS_CASES[case]:
        rb.rate_bounds(ep, lo, hi)
        pb.rate_bounds(ep, lo, hi)
    want, got = rb.check_bounds(), pb.check_bounds()
    assert [(c.fifo, c.src, c.dst, c.src_bounds, c.dst_bounds, c.verdict)
            for c in got.channels] == \
        [(c.fifo, c.src, c.dst, c.src_bounds, c.dst_bounds, c.verdict)
         for c in want.channels]
    assert got.describe() == want.describe() and pb.bounds_report is got
    if want.violations():
        with pytest.raises(ValueError) as ref_err:
            rb.build(check_bounds=True)
        with pytest.raises(ValueError) as got_err:
            pb.build(device="cpu", check_bounds=True)
        assert str(got_err.value) == str(ref_err.value)
    else:
        pb.build(device="cpu", check_bounds=True)


def test_rate_bounds_validation_and_static_chain(jax_literal):
    _, pb = _gated_builders()
    with pytest.raises(ValueError, match="no port"):
        pb.rate_bounds("gate.nope", 0.0, 1.0)
    with pytest.raises(ValueError, match="0 <= lo <= hi <= 1"):
        pb.rate_bounds("gate.in", 0.8, 0.2)
    b = NetworkBuilder()
    b.actor(static_actor("src", (), ("out",),
                         lambda st, ins, rates: (st, {"out": torch.zeros((2, 4))})))
    b.actor(static_actor("sink", ("in",), (), lambda st, ins, rates: (st, {})))
    b.connect("src.out", "sink.in", rate=2, token_shape=(4,))
    assert all(c.verdict == "balanced" for c in b.check_bounds().channels)
    b.build(device="cpu", check_bounds=True)

"""The port's megakernel backend (``ExecutionPlan(mode="megakernel")``) on
the CPU, where it runs the plain PyTorch version of kernel B2 (``ref.py``)
on the device program.

Against the reference's ``compile_megakernel`` (Pallas interpret mode) on
the same DPD: fire counts, sweeps, cursors and integer leaves exactly,
floats within ``1e-5 * max|y|`` per plane; on the same motion detection
network (u8 tokens, the Fig. 2 delay channel): every leaf exactly.
Against the port's own host dynamic executor: every leaf bit for bit, as
the reference's megakernel is held to its dynamic executor
(``tests/test_megakernel.py``).
"""
from __future__ import annotations

import dataclasses
import random

import jax
import numpy as np
import pytest
import torch

from repro.core import ExecutionPlan as RefPlan
from repro.graphs.factories import make_dpd as ref_make_dpd
from repro.graphs.factories import make_motion_detection as ref_make_md
from repro_torch.core.megakernel import compile_megakernel, megakernel_cuda
from repro_torch.core import NetworkBuilder, static_actor
from repro_torch.core.actor import DeviceOp
from repro_torch.core.fifo import FifoSpec
from repro_torch.core.megakernel.program import (F_BOUND, F_CAP, F_DELAY, F_NPH,
                                                 F_TOKB, fifo_row)
from repro_torch.core.megakernel.kernel import CLOCK_SPLIT_DEFINE, decode_clock_split
from repro_torch.core.megakernel.program import (M_CLK_KIND, M_CLK_LOOP, M_CLK_SCHED,
                                                 M_CLK_STALL, META_WORDS, stage,
                                                 unstage)
from repro_torch.core.megakernel.ref import (HAZARDS, copy_back, execute,
                                             hazard_waits, permitted_order,
                                             read_offset, schedule, write_offset,
                                             zero_forwarded)
from repro_torch.core.network import Network
from repro_torch.graphs.factories import (make_dpd, make_motion_detection,
                                         states_equal)
from repro_torch.kernels import _build
from test_torch_harness import assert_runs_match, jax_literal  # noqa: F401

# One scrambled core map of DPD's 15 actors (config first).
SCRAMBLED = {"config": 2, "source": 0, "fork": 3, "poly0": 1, "poly1": 0,
             "poly2": 2, "poly3": 3, "poly4": 1, "poly5": 0, "poly6": 2,
             "poly7": 3, "poly8": 1, "poly9": 0, "adder": 2, "sink": 3}

REF_PLANS = {
    "default": dict(),
    "single": dict(multi_firing=False),
    "cores2": dict(cores=2),
    "cores4": dict(cores=4),
    "scrambled": dict(cores=4, assign=SCRAMBLED),
}


@pytest.fixture(scope="module")
def ref_runs():
    """Reference megakernel programs on DPD(4, block 128), compiled and run
    on first use (about 6 s each).  ``jax.core.Literal`` is aliased for the
    graph build only, and restored before any test body runs."""
    with pytest.MonkeyPatch.context() as mp:
        if not hasattr(jax.core, "Literal"):
            from jax.extend.core import Literal
            mp.setattr(jax.core, "Literal", Literal, raising=False)
        ref_net, _ = ref_make_dpd(4, block_l=128)
    cache = {}

    def get(name):
        if name not in cache:
            prog = ref_net.compile(RefPlan(mode="megakernel", **REF_PLANS[name]))
            cache[name] = (prog, prog.run())
        return cache[name]

    return get


@pytest.fixture(scope="module")
def ref_md_runs():
    """Reference megakernel programs on motion detection (12 frames of
    48 x 64 at rate 4), at cores 1 and 2, compiled and run on first use;
    ``jax.core.Literal`` is aliased for the graph build only."""
    with pytest.MonkeyPatch.context() as mp:
        if not hasattr(jax.core, "Literal"):
            from jax.extend.core import Literal
            mp.setattr(jax.core, "Literal", Literal, raising=False)
        ref_net, _ = ref_make_md(12, rate=4, frame_hw=MD_HW)
    cache = {}

    def get(cores):
        if cores not in cache:
            prog = ref_net.compile(RefPlan(mode="megakernel", cores=cores))
            cache[cores] = (prog, prog.run())
        return cache[cores]

    return get


MD_HW = (48, 64)


def _port(n_firings=4, **kw):
    net, _ = make_dpd(n_firings, block_l=128, device="cpu", **kw)
    return net


def test_megakernel_matches_reference(ref_runs):
    _, ref = ref_runs("default")
    got = _port().compile(mode="megakernel").run()
    assert got.sweeps == int(ref.sweeps) == 3
    assert_runs_match(ref, got)


@pytest.mark.parametrize("static_all_active", [False, True])
@pytest.mark.parametrize("n_firings", [4, 5, 6])
def test_megakernel_bit_identical_to_port_dynamic(n_firings, static_all_active):
    net = _port(n_firings, static_all_active=static_all_active)
    dyn = net.compile(mode="dynamic").run()
    mega = net.compile(mode="megakernel").run()
    assert states_equal(dyn.state, mega.state)
    assert mega.fire_counts == dyn.fire_counts
    assert mega.sweeps == dyn.sweeps and not mega.stalled


def test_single_firing_sweeps_match_reference(ref_runs):
    _, ref = ref_runs("single")
    net = _port()
    single = net.compile(mode="megakernel", multi_firing=False).run()
    dyn = net.compile(mode="dynamic", multi_firing=False).run()
    assert single.sweeps == int(ref.sweeps) == dyn.sweeps
    assert states_equal(single.state, dyn.state)
    multi = net.compile(mode="megakernel").run()
    assert multi.sweeps < single.sweeps
    assert states_equal(multi.state, single.state)


@pytest.mark.parametrize("plan", ["cores2", "cores4", "scrambled"])
def test_grid_plans_give_the_single_core_state(ref_runs, plan):
    _, ref = ref_runs(plan)
    net = _port()
    one = net.compile(mode="megakernel").run()
    got = net.compile(mode="megakernel", **REF_PLANS[plan]).run()
    assert states_equal(got.state, one.state)
    assert got.fire_counts == one.fire_counts
    assert got.sweeps == int(ref.sweeps)
    assert_runs_match(ref, got)


def test_stats_megakernel_fields_equal_reference(ref_runs):
    ref_prog, _ = ref_runs("default")
    prog = _port().compile(mode="megakernel")
    assert prog.stats().hbm_state_bytes is None              # nothing ran yet
    prog.run()
    got, ref = prog.stats(), ref_prog.stats()
    for field in ("scratch_bytes", "transient_scratch_bytes", "forwarded_fifos",
                  "reclaimed_scratch_bytes", "hbm_state_bytes", "grid_cores",
                  "partition_actors", "core_scratch_bytes",
                  "shared_scratch_bytes", "shared_fifos", "core_cursor_rows",
                  "cut_objective", "partition_fire_counts", "last_sweeps"):
        assert getattr(got, field) == getattr(ref, field), field
    assert got.mode == "megakernel" and got.scratch_bytes == 408


def test_stats_of_a_grid_plan_equal_reference(ref_runs):
    ref_prog, _ = ref_runs("cores2")
    prog = _port().compile(mode="megakernel", cores=2)
    prog.run()
    got, ref = prog.stats(), ref_prog.stats()
    for field in ("scratch_bytes", "forwarded_fifos", "shared_scratch_bytes",
                  "shared_fifos", "core_cursor_rows", "core_scratch_bytes",
                  "partition_actors", "partition_fire_counts"):
        assert getattr(got, field) == getattr(ref, field), field


def test_megakernel_resumes_from_partial_state():
    """A quiescent state fires nothing (one empty sweep); forwarded
    channels restart from zeros (the dead-slot rule), every other byte and
    every cursor carries over."""
    prog = _port().compile(mode="megakernel")
    forwarded = prog.stats().forwarded_fifos
    assert len(forwarded) == 34
    r1 = prog.run()
    r2 = prog.run(r1.state)
    assert r2.sweeps == 1 and set(r2.fire_counts.values()) == {0}
    for a, b in zip(r1.state.actors, r2.state.actors):
        assert _leaf_equal(a, b)
    for name in forwarded:
        f1, f2 = r1.state.fifo(name), r2.state.fifo(name)
        assert (f1.rd, f1.wr, f1.occ) == (f2.rd, f2.wr, f2.occ)
        assert f2.occ == 0 and not torch.any(f2.buf)


def _leaf_equal(a, b) -> bool:
    if isinstance(a, tuple):
        return all(_leaf_equal(x, y) for x, y in zip(a, b))
    if isinstance(a, torch.Tensor):
        return torch.equal(a, b)
    return a == b


def test_megakernel_unspecialized_resume_keeps_every_byte():
    prog = _port().compile(mode="megakernel", specialize=False)
    assert prog.stats().forwarded_fifos == ()
    assert prog.stats().reclaimed_scratch_bytes == 0
    r1 = prog.run()
    r2 = prog.run(r1.state)
    assert r2.sweeps == 1
    assert states_equal(r1.state, r2.state)


def test_megakernel_forwarding_rejects_undrained_entry():
    net = _port()
    state = net.init_state()
    state.fifo("f_in").occ, state.fifo("f_in").wr = 1, 1
    with pytest.raises(ValueError, match="must be drained"):
        net.compile(mode="megakernel").run(state)
    # The escape hatch: the unspecialized program takes the same state.
    net.compile(mode="megakernel", specialize=False).run(state)


def test_control_rings_are_back_in_host_memory():
    net = _port()
    dyn = net.compile(mode="dynamic").run()
    mega = net.compile(mode="megakernel", specialize=False).run()
    for name, spec in net.fifos.items():
        if spec.is_control:
            buf = mega.state.fifo(name).buf
            assert buf.device.type == "cpu" and buf.dtype == torch.int32
            assert torch.equal(buf, dyn.state.fifo(name).buf)
    assert isinstance(mega.state.actor("source")[1], int)
    assert mega.state.actor("config") == 4


def test_rate_table_is_control_over_domain():
    """Named for the rate table the device program held until the actors
    declared their enables: the rates it computes from the declared forms
    are ``control``'s over the domain (2..10) and outside it."""
    net = _port()
    prog = compile_megakernel(net).device_program
    dynamic = [n for n, a in net.actors.items() if a.is_dynamic]
    assert sorted(prog.enables) == sorted(dynamic)
    for name in dynamic:
        a = net.actors[name]
        for v in (-2 ** 31, -1, 0, 1, *range(2, 11), 11, 42, 2 ** 31 - 1):
            assert prog.rates(name, [v]) == {p: int(bool(e))
                                             for p, e in a.rates_for([v]).items()}


def _inject_fork_token(state, value):
    """One extra control token ``value`` ahead of the config's on
    ``f_c_fork`` (port state)."""
    ring = state.fifo("f_c_fork")
    ring.buf[0, 0] = value
    ring.occ, ring.wr = 1, 1
    return state


def test_control_token_outside_domain_raises(jax_literal):
    """Named for the refusal this checked while B2 tabulated rates over the
    declared domain.  A fork token of 42, outside DPD's domain 2..10, now
    runs as the reference runs it: the unguarded megakernel run equals the
    port's host dynamic run bit for bit and the reference's
    ``compile_dynamic`` in every count, cursor and integer leaf (floats
    within REL_TOL); the guarded runs flag DOMAIN on ``f_c_fork`` and
    complete, with the host's diagnostics."""
    from repro.core.faultinject import _replace_fifo
    import jax.numpy as jnp
    net = _port()
    mega = net.compile(mode="megakernel", specialize=False).run(
        _inject_fork_token(net.init_state(), 42))
    dyn = net.compile(mode="dynamic").run(_inject_fork_token(net.init_state(), 42))
    assert states_equal(mega.state, dyn.state)
    assert (mega.sweeps, mega.fire_counts) == (dyn.sweeps, dyn.fire_counts)
    ref_net, _ = ref_make_dpd(4, block_l=128)
    ref_state = ref_net.init_state()
    fi = list(ref_net.fifos).index("f_c_fork")
    spec = ref_net.fifos["f_c_fork"]
    ref_state = _replace_fifo(ref_state, fi, spec.write(
        ref_state.fifos[fi], jnp.full((1, 1), 42, jnp.int32)))
    ref = ref_net.compile(RefPlan(mode="dynamic")).run(ref_state)
    assert_runs_match(ref, mega)
    from repro_torch.core.health import DOMAIN, NetworkFaultError
    diags = []
    for mode in ("dynamic", "megakernel"):
        kw = dict(specialize=False) if mode == "megakernel" else {}
        with pytest.raises(NetworkFaultError) as err:
            net.compile(mode=mode, guards=True, **kw).run(
                _inject_fork_token(net.init_state(), 42))
        d = err.value.diagnostics
        bits = {f.fifo: int(f.bits) for f in d.faults}
        assert bits["f_c_fork"] & DOMAIN
        assert err.value.result.fire_counts == dyn.fire_counts
        diags.append((bits, dict(d.high_water)))
    assert diags[0] == diags[1]


def _rebuilt(net: Network, actors=None, fifos=None) -> Network:
    return Network(list((actors or net.actors).values()),
                   list((fifos or net.fifos).values()), list(net.edges),
                   device="cpu")


def test_actor_without_device_op_raises_naming_a6_and_a8():
    """Named for the items it named while motion detection (ROADMAP A6) and
    MoE (A8) had no device ops; every network of the port has them now, and
    an actor without one is still refused, as is a dynamic actor that
    declares no enable forms."""
    net = _port()
    actors = dict(net.actors)
    actors["adder"] = dataclasses.replace(actors["adder"], device_op=None)
    with pytest.raises(NotImplementedError, match="declare no DeviceOp") as err:
        _rebuilt(net, actors=actors).compile(mode="megakernel")
    assert "MoE" not in str(err.value)
    actors = dict(net.actors)
    actors["adder"] = dataclasses.replace(actors["adder"], enables=None)
    with pytest.raises(NotImplementedError, match="declare no enable forms"):
        _rebuilt(net, actors=actors).compile(mode="megakernel")


def test_delay_channel_raises_naming_a6():
    """Named for the raise it checked until B2 learnt the Fig. 2 delay
    channel (ROADMAP A6): motion detection's delay ring now compiles and
    runs, bit-identical to the host dynamic run, while a cut that splits
    its endpoints still raises."""
    net, _ = make_motion_detection(12, rate=4, frame_hw=(24, 32), device="cpu")
    row = fifo_row(net.fifos["f_gauss_thres_d"])
    assert [row[F_CAP], row[F_BOUND], row[F_NPH], row[F_DELAY], row[F_TOKB]] == \
        [13, 9, 3, 1, 24 * 32]
    prog = net.compile(mode="megakernel")
    assert "f_gauss_thres_d" not in prog.stats().forwarded_fifos
    got, dyn = prog.run(), net.compile(mode="dynamic").run()
    assert states_equal(got.state, dyn.state) and got.fire_counts == dyn.fire_counts
    assert got.state.fifo("f_gauss_thres_d").wr == 3
    split = {"source": 0, "gauss": 0, "thres": 1, "med": 1, "sink": 1}
    with pytest.raises(ValueError, match="may not cross"):
        net.compile(mode="megakernel", cores=2, assign=split)


def test_control_channel_without_domain_raises():
    """Named for the refusal it checked while B2 needed a domain to
    tabulate rates: without domains the declared enables still give the
    rates, and the run equals the host dynamic run."""
    net = _port()
    fifos = {n: dataclasses.replace(f, domain=None) if f.is_control else f
             for n, f in net.fifos.items()}
    bare = _rebuilt(net, fifos=fifos)
    got = bare.compile(mode="megakernel").run()
    want = net.compile(mode="dynamic").run()
    assert states_equal(got.state, want.state)
    assert (got.sweeps, got.fire_counts) == (want.sweeps, want.fire_counts)


def test_cpu_run_launches_no_kernel_and_collects_the_sink():
    net = _port()
    before = megakernel_cuda.launches
    prog = net.compile(mode="megakernel")
    prog.run()
    assert megakernel_cuda.launches == before
    dyn = net.compile(mode="dynamic")
    assert torch.equal(prog.collect("sink"), dyn.collect("sink", dyn.run().state))
    with pytest.raises(ValueError, match="CUDA tensor"):
        megakernel_cuda(torch.zeros(4, dtype=torch.int32),
                        torch.zeros(4, dtype=torch.int64), 1, 10, True)
    assert megakernel_cuda.launches == before


def test_sweep_budget_exhaustion_warns_like_dynamic():
    net = _port()
    with pytest.warns(RuntimeWarning, match="max_sweeps"):
        res = net.compile(mode="megakernel", max_sweeps=1).run()
    dyn = net.compile(mode="dynamic", max_sweeps=1)
    with pytest.warns(RuntimeWarning):
        ref = dyn.run()
    assert res.stalled and res.sweeps == 1
    assert states_equal(res.state, ref.state)


# --------------------------------------------------------------------------- #
# Motion detection: u8 tokens, the delay channel, the gauss/thres/med bodies.
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("cores", [1, 2])
def test_motion_detection_equals_reference_exactly(ref_md_runs, cores):
    ref_prog, ref = ref_md_runs(cores)
    net, _ = make_motion_detection(12, rate=4, frame_hw=MD_HW, device="cpu")
    prog = net.compile(mode="megakernel", cores=cores)
    got = prog.run()
    assert got.sweeps == int(ref.sweeps) == 3
    assert_runs_match(ref, got, rel=0.0)
    dyn = net.compile(mode="dynamic").run()
    assert states_equal(got.state, dyn.state)
    assert got.fire_counts == dyn.fire_counts and got.sweeps == dyn.sweeps
    ours, theirs = prog.stats(), ref_prog.stats()
    for field in ("scratch_bytes", "forwarded_fifos", "hbm_state_bytes",
                  "partition_actors", "shared_fifos", "core_cursor_rows",
                  "partition_fire_counts", "last_sweeps"):
        assert getattr(ours, field) == getattr(theirs, field), field


@pytest.mark.parametrize("cores", [1, 2])
@pytest.mark.parametrize("rate", [1, 2, 4])
def test_motion_detection_bit_identical_to_port_dynamic(rate, cores):
    net, n = make_motion_detection(12, rate=rate, frame_hw=(20, 28), seed=rate,
                                   device="cpu")
    dyn = net.compile(mode="dynamic").run()
    mega = net.compile(mode="megakernel", cores=cores).run()
    assert states_equal(dyn.state, mega.state)
    assert mega.fire_counts == dyn.fire_counts == {a: n for a in net.actors}
    assert mega.sweeps == dyn.sweeps and not mega.stalled
    single = net.compile(mode="megakernel", multi_firing=False).run()
    assert states_equal(single.state, dyn.state)


@pytest.mark.parametrize("rate", [1, 2, 3, 4])
def test_delay_ring_helpers_equal_fifo_write_masked(rate):
    """B2's plain ring arithmetic on a delay channel's table row (shifted
    writes, the Fig. 2 copy-back) against ``FifoSpec`` itself, over a
    random sequence of masked writes and reads."""
    spec = FifoSpec("d", rate, (3,), torch.uint8, delay=1)
    row = fifo_row(spec)
    st = spec.init_state(torch.device("cpu"), initial_token=[7, 8, 9])
    ring, rd, wr, occ = st.buf.clone(), 0, 0, 1
    rng = np.random.default_rng(rate)
    copied_back = 0
    for _ in range(200):
        en = int(rng.random() < 0.8)
        if occ + rate <= spec.writable_occupancy_bound and rng.random() < 0.55:
            tokens = torch.tensor(rng.integers(0, 256, (rate, 3)), dtype=torch.uint8)
            spec.write_masked(st, tokens, en)
            if en:
                off = write_offset(row, wr)
                ring[off:off + rate] = tokens
                copy_back(ring, row, wr)
                copied_back += wr % 3 == 2
                wr, occ = wr + 1, occ + rate
        elif occ >= rate:
            want = spec.read_masked(st, en)
            off = read_offset(row, rd)
            assert torch.equal(ring[off:off + rate], want)
            if en:
                rd, occ = rd + 1, occ - rate
        assert torch.equal(ring, st.buf)
        assert (rd, wr, occ) == (st.rd, st.wr, st.occ)
    assert copied_back > 3


def test_staging_refuses_a_slab_of_another_type():
    net, _ = make_motion_detection(8, rate=4, frame_hw=(16, 16), device="cpu")
    state = net.init_state()
    slab, idx = state.actor("sink")
    state.actors[net.actor_index["sink"]] = (slab.to(torch.float32), idx)
    with pytest.raises(ValueError, match="torch.uint8 slab"):
        net.compile(mode="megakernel").run(state)


# --------------------------------------------------------------------------- #
# B2's command list: the scheduler's hazard rule, replayed in every order the
# kernel's dependency waits permit.
# --------------------------------------------------------------------------- #
def _delay_line(n_frames=12, rate=1, hw=(4, 8), seed=3):
    """Source -> fork -> (delay channel) -> sink on u8 frames: the sink
    reads the delay channel alone, so a read of its slot 0 depends on the
    copy-back and on nothing else."""
    rng = np.random.default_rng(seed)
    video = torch.tensor(rng.integers(1, 256, (n_frames, *hw)), dtype=torch.uint8)
    n_iter = n_frames // rate

    def src_fire(st, inputs, rates):
        data, idx = st
        return (data, idx + 1), {"out": data[idx * rate:(idx + 1) * rate]}

    def sink_fire(st, inputs, rates):
        data, idx = st
        data[idx * rate:(idx + 1) * rate] = inputs["in"]
        return (data, idx + 1), {}

    source = static_actor("source", (), ("out",), src_fire, init=lambda: (video, 0),
                          ready=lambda st: st[1] < n_iter,
                          device_op=DeviceOp("source", {"n_firings": n_iter, "planes": 1}))
    fork = static_actor("fork", ("in",), ("out",),
                        lambda st, inputs, rates: (st, {"out": inputs["in"]}),
                        device_op=DeviceOp("fork"))
    # One window more than the source sends: the delay token comes first.
    sink = static_actor("sink", ("in",), (), sink_fire,
                        init=lambda: (torch.zeros((n_frames + rate, *hw),
                                                  dtype=torch.uint8), 0),
                        finish=lambda st: st[0],
                        device_op=DeviceOp("sink", {"planes": 1}))
    b = NetworkBuilder()
    b.actors(source, fork, sink)
    b.connect("source.out", "fork.in", rate=rate, token_shape=hw, dtype=torch.uint8)
    b.connect("fork.out", "sink.in", rate=rate, token_shape=hw, dtype=torch.uint8,
              delay=1)
    return b.build(device="cpu")


REPLAY_NETS = {
    "dpd_default": lambda: _port(8),
    "dpd_min_active2": lambda: _port(8, active_schedule=np.full(8, 2, np.int32)),
    "dpd_all10": lambda: _port(8, active_schedule=np.full(8, 10, np.int32)),
    "dpd_static_all10": lambda: _port(8, static_all_active=True),
    "md_rate1": lambda: make_motion_detection(8, rate=1, frame_hw=(12, 16), seed=1,
                                              device="cpu")[0],
    "md_rate4": lambda: make_motion_detection(24, rate=4, frame_hw=(12, 16), seed=4,
                                              device="cpu")[0],
    "delay_line_rate1": _delay_line,
    "delay_line_rate3": lambda: _delay_line(12, rate=3),
}


def _replay(net, order, hazards=HAZARDS):
    """One run of B2's plain version on a fresh state with its commands'
    waits under ``hazards``, run in ``order(commands)``."""
    prog = compile_megakernel(net).device_program
    table = prog.table.tolist()
    state = net.init_state()
    tensors, io = stage(prog, state, torch.device("cpu"), [t for _, t in prog.consts])
    zero_forwarded(table, tensors)
    commands = schedule(table, tensors, io, 1_000_000, True)
    hazard_waits(commands, hazards)
    execute(table, tensors, order(commands))
    unstage(prog, state, io)
    return state, commands


def _orders():
    """The latest-ready-first order, then random permitted orders."""
    yield "latest", permitted_order
    for seed in range(4):
        yield f"seed{seed}", lambda c, s=seed: permitted_order(c, random.Random(s))


@pytest.mark.parametrize("name", list(REPLAY_NETS))
def test_permitted_orders_give_the_sequential_state(name):
    net = REPLAY_NETS[name]()
    want, commands = _replay(net, list)
    dyn = net.compile(mode="dynamic").run()
    assert states_equal(want, dyn.state)
    # The rule leaves room to reorder: some commands wait for none of the
    # commands just before them.
    assert sum(c.wait_for < c.seq - 1 for c in commands) > len(commands) // 4
    for label, order in _orders():
        got, _ = _replay(net, order)
        reordered = [c.seq for c in order(commands)] != sorted(c.seq for c in commands)
        assert reordered, label
        assert states_equal(got, want), label


@pytest.mark.parametrize("hazard,name", [
    ("raw", "dpd_default"), ("war", "dpd_default"), ("raw", "md_rate4"),
    ("war", "md_rate4"), ("raw", "delay_line_rate3"), ("war", "delay_line_rate1"),
    ("delay", "delay_line_rate1")])
def test_replay_sees_a_missing_hazard_class(hazard, name):
    """With one hazard class dropped from the rule, some permitted order
    gives another state: the replay test can see a missing edge.  (At a
    rate above 1 the copy-back's edges are implied by others: a read of
    slot 0 also reads slots 1 .. r-1, which a write after the copy-back
    filled, so the delay class is shown on the rate-1 delay line.)"""
    net = REPLAY_NETS[name]()
    want, _ = _replay(net, list)
    differs = [label for label, order in _orders()
               if not states_equal(_replay(net, order, HAZARDS - {hazard})[0], want)]
    assert differs, f"dropping {hazard} changed no replay"


def test_commands_carry_the_kernels_segments():
    """Delay-free windows are one segment each; the delay channel's read
    and write windows are cut by the one-slot shift, and its phase-2 write
    also writes segment 0 (the copy-back)."""
    net = REPLAY_NETS["md_rate4"]()
    prog = compile_megakernel(net).device_program
    _, commands = _replay(net, list)
    delay = prog.fifo_names.index(next(n for n, s in net.fifos.items() if s.delay))
    writes = [c for c in commands if any(f == delay for f, _ in c.writes)]
    reads = [c for c in commands if any(f == delay for f, _ in c.reads)]
    assert writes and reads
    assert {tuple(s for f, s in c.writes if f == delay) for c in writes} == {
        (1, 2), (3, 4), (5, 6)}
    assert {tuple(s for f, s in c.reads if f == delay) for c in reads} == {
        (0, 1), (2, 3), (4, 5)}
    assert all(bool(c.copy_back_writes) == ((5, 6) == tuple(
        s for f, s in c.writes if f == delay)) for c in writes)
    for c in commands:
        assert c.wait_for < c.seq


def test_clock_split_words_decode_and_key_their_own_build():
    """The split build's meta words: body-thread stalls, the loop and its
    waits, the scheduler warp's time, body time by kind; and a build with
    the split define is a library of its own."""
    meta = [0] * META_WORDS
    meta[M_CLK_STALL] = 123 | (456 << 32)
    meta[M_CLK_LOOP] = 10_000 | (7 << 40)
    meta[M_CLK_SCHED] = 9_000 | (800 << 32)
    meta[M_CLK_KIND + 2] = 4_321 | (398 << 40)          # poly (config has no word)
    got = decode_clock_split(meta)
    assert (got["stall_sched"], got["stall_wait"], got["loop"], got["waits"]) == (
        123, 456, 10_000, 7)
    assert (got["sched_busy"], got["sched_full"]) == (9_000, 800)
    assert got["bodies"]["poly"] == {"cycles": 4_321, "count": 398}
    assert "config" not in got["bodies"] and got["bodies"]["source"]["count"] == 0
    assert (_build.library_path("megakernel", (CLOCK_SPLIT_DEFINE,))
            != _build.library_path("megakernel"))

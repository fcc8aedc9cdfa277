"""The port's firing trace (``core/trace.py``, ``ExecutionPlan(trace=True)``)
and the profile cut against the JAX package's, on the CPU, for the host
dynamic executor and the megakernel backend (B2's plain version) at
``cores=1`` and ``cores=2``, on DPD and motion detection.

Mirrors ``tests/test_trace.py``.  Structure is exact: every event (actor,
sweep, fired, every occupancy), the attempt and firing counts, the core of
each actor, the ``Profile`` weights and the partition they cut.  A traced
run is bit-identical to an untraced one, the ring keeps the newest events,
a Perfetto export validates, and ``ProgramStats.to_json`` round-trips.
"""
from __future__ import annotations

import dataclasses
import json

import jax
import numpy as np
import pytest

from repro.core import ExecutionPlan as RefPlan
from repro.graphs.factories import make_dpd as ref_make_dpd
from repro.graphs.factories import make_motion_detection as ref_make_md
from repro_torch.core import ExecutionPlan
from repro_torch.core.trace import (COL_SWEEP, TRACE_CAPACITY_DEFAULT, Trace, init_trace,
                                    merge_traces, validate_chrome_trace)
from repro_torch.graphs.factories import make_dpd, make_motion_detection, states_equal

BACKENDS = ("dynamic", "megakernel", "grid2")
MD_HW = (48, 64)


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
def graphs():
    return {
        "dpd": (_ref_build(ref_make_dpd, n_firings=6, block_l=64),
                make_dpd(n_firings=6, block_l=64, device="cpu")[0]),
        "md": (_ref_build(ref_make_md, 12, rate=4, frame_hw=MD_HW),
               make_motion_detection(12, rate=4, frame_hw=MD_HW, device="cpu")[0]),
    }


@pytest.fixture(scope="module")
def ref_traces(graphs):
    """The reference's traced runs per (graph, backend, capacity), run on
    first use."""
    cache = {}

    def get(graph, backend, cap=None):
        key = (graph, backend, cap)
        if key not in cache:
            cache[key] = graphs[graph][0].compile(
                RefPlan(**_kw(backend, trace=True, trace_capacity=cap))).run()
        return cache[key]

    return get


def _events(trace):
    return np.asarray(trace.events)


# --------------------------------------------------------------------------- #
# The trace observes, it never schedules; its events are the reference's.
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("graph", ("dpd", "md"))
def test_trace_off_path_bit_identical(graphs, graph, backend):
    net = graphs[graph][1]
    off = net.compile(ExecutionPlan(**_kw(backend))).run()
    on = net.compile(ExecutionPlan(**_kw(backend, trace=True))).run()
    assert states_equal(off.state, on.state)
    assert (off.sweeps, off.fire_counts) == (on.sweeps, on.fire_counts)
    assert off.trace is None and on.trace.n_events > 0


@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("graph", ("dpd", "md"))
def test_trace_events_equal_the_reference(graphs, ref_traces, graph, backend):
    got = graphs[graph][1].compile(ExecutionPlan(**_kw(backend, trace=True))).run()
    want = ref_traces(graph, backend)
    np.testing.assert_array_equal(got.trace.events, _events(want.trace))
    assert got.trace.attempt_counts() == want.trace.attempt_counts()
    assert got.trace.firing_counts() == want.trace.firing_counts() == got.fire_counts
    assert got.trace.actor_cores == want.trace.actor_cores
    assert (got.trace.actor_names, got.trace.fifo_names, got.trace.capacity,
            got.trace.dropped, got.trace.actor_flops, got.trace.fifo_token_bytes) == \
        (want.trace.actor_names, want.trace.fifo_names, want.trace.capacity,
         want.trace.dropped, want.trace.actor_flops, want.trace.fifo_token_bytes)
    att = got.trace.attempt_counts()
    assert all(att[k] >= v for k, v in got.fire_counts.items())


def test_visits_record_the_skipped_attempts(graphs):
    """A visit stops at its first failed attempt but records every one of
    its attempts: the skipped ones repeat the failed one's occupancies."""
    tr = graphs["dpd"][1].compile(ExecutionPlan(mode="dynamic", trace=True)).run().trace
    ev = tr.events
    runs = [(i, j) for i in range(len(ev)) for j in (i + 1,)
            if j < len(ev) and ev[i, 0] == ev[j, 0] and ev[i, 1] == ev[j, 1]
            and ev[i, 2] == 0 and ev[j, 2] == 0]
    assert runs, "no visit with two skipped attempts"
    for i, j in runs:
        np.testing.assert_array_equal(ev[i, 3:], ev[j, 3:])


# --------------------------------------------------------------------------- #
# Perfetto export.
# --------------------------------------------------------------------------- #
def test_perfetto_firing_events_equal_fire_counts(graphs):
    res = graphs["dpd"][1].compile(ExecutionPlan(**_kw("megakernel", trace=True))).run()
    doc = res.trace.to_perfetto()
    names = res.trace.actor_names
    fired = {nm: 0 for nm in names}
    for ev in doc["traceEvents"]:
        if ev["ph"] == "X":
            fired[names[ev["tid"] - 1]] += 1
    assert fired == res.fire_counts


def test_perfetto_export_validates_and_writes(graphs, tmp_path):
    res = graphs["dpd"][1].compile(ExecutionPlan(mode="dynamic", trace=True)).run()
    path = tmp_path / "dpd.trace.json"
    res.trace.to_perfetto(str(path))
    doc = json.loads(path.read_text())
    assert validate_chrome_trace(doc) == []
    assert {"M", "X", "C"} <= {ev["ph"] for ev in doc["traceEvents"]}
    counters = {ev["name"] for ev in doc["traceEvents"] if ev["ph"] == "C"}
    assert counters == {f"occ:{f}" for f in res.trace.fifo_names}
    assert doc["otherData"]["dropped_events"] == 0


def test_validate_chrome_trace_flags_garbage():
    bad = {"traceEvents": [
        {"name": "a", "ph": "X", "pid": 0, "tid": 1, "ts": 5.0, "dur": 1.0},
        {"name": "a", "ph": "X", "pid": 0, "tid": 1, "ts": 2.0, "dur": 1.0},
        {"name": "b", "ph": "C", "pid": 0, "ts": 0.0},
    ]}
    problems = validate_chrome_trace(bad)
    assert any("ts" in p for p in problems) and any("args" in p for p in problems)
    assert validate_chrome_trace({"nope": 1}) != []


def test_grid_trace_carries_core_assignment(graphs):
    tr = graphs["dpd"][1].compile(ExecutionPlan(**_kw("grid2", trace=True))).run().trace
    assert set(tr.actor_cores) == {0, 1}
    names = [ev["args"]["name"] for ev in tr.to_perfetto()["traceEvents"]
             if ev["ph"] == "M" and ev["name"] == "thread_name"]
    assert any("[core 1]" in n for n in names)


# --------------------------------------------------------------------------- #
# The ring: fixed capacity, the newest events kept.
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("backend", BACKENDS)
def test_trace_ring_wraps_keeping_newest(graphs, ref_traces, backend):
    net = graphs["dpd"][1]
    full = net.compile(ExecutionPlan(**_kw(backend, trace=True))).run().trace
    assert full.dropped == 0 and full.capacity == TRACE_CAPACITY_DEFAULT
    small = net.compile(ExecutionPlan(**_kw(backend, trace=True, trace_capacity=8))).run().trace
    assert small.n_events == 8 and small.dropped == full.n_events - 8
    np.testing.assert_array_equal(small.events, full.events[-8:])
    np.testing.assert_array_equal(small.events, _events(ref_traces("dpd", backend, 8).trace))


def test_merge_traces_offsets_sweeps():
    st = init_trace(2, 4)
    st.record(0, 0, 1, [1, 0])
    st.record(1, 1, 0, [1, 0])
    t = Trace(actor_names=("a", "b"), fifo_names=("f", "g"),
              events=st.ring[:st.count].copy(), capacity=4)
    merged = merge_traces([t, None, t])
    assert merged.n_events == 4
    assert merged.events[:, COL_SWEEP].tolist() == [0, 1, 2, 3]
    assert merge_traces([]) is None


# --------------------------------------------------------------------------- #
# Profiles drive the partition cut.
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("cores", (2, 4))
def test_profile_cut_matches_reference_and_is_bit_identical(graphs, ref_traces, cores):
    ref_net, net = graphs["dpd"]
    prof = net.compile(ExecutionPlan(mode="dynamic", trace=True)).run().trace.profile()
    ref_prof = ref_traces("dpd", "dynamic").trace.profile()
    w = prof.as_cut_weights()
    assert w == ref_prof.as_cut_weights()
    assert set(w) == {"actors", "channels"} and all(v >= 1 for v in w["actors"].values())
    base = net.compile(ExecutionPlan(mode="megakernel", specialize=False, cores=1)).run()
    prog = net.compile(ExecutionPlan(mode="megakernel", specialize=False, cores=cores,
                                     cut_objective="profile", profile=prof))
    res = prog.run()
    assert states_equal(base.state, res.state) and base.fire_counts == res.fire_counts
    st = prog.stats()
    assert st.cut_objective == "profile" and st.grid_cores == cores
    assert all(st.partition_actors)
    assert tuple(nm for g in st.partition_actors for nm in g) == tuple(net.actors)
    ref_st = ref_net.compile(RefPlan(mode="megakernel", specialize=False, cores=cores,
                                     cut_objective="profile", profile=ref_prof)).stats()
    assert st.partition_actors == ref_st.partition_actors


def test_profile_plan_validation(graphs):
    net = graphs["dpd"][1]
    with pytest.raises(ValueError, match="trace"):
        net.compile(ExecutionPlan(mode="static", n_iterations=4, trace=True))
    with pytest.raises(ValueError, match="trace_capacity"):
        net.compile(ExecutionPlan(mode="dynamic", trace_capacity=64))
    with pytest.raises(ValueError, match="trace_capacity"):
        ExecutionPlan(mode="dynamic", trace=True, trace_capacity=0)
    with pytest.raises(ValueError, match="profile"):
        net.compile(ExecutionPlan(mode="megakernel", cores=2, cut_objective="profile"))
    with pytest.raises(ValueError, match="profile"):
        net.compile(ExecutionPlan(mode="megakernel", cores=2, profile={"actors": {"a": 1}}))
    with pytest.raises(ValueError, match="profile"):
        ExecutionPlan(mode="megakernel", profile={"nodes": {}})
    plan = ExecutionPlan(mode="megakernel", cores=2, cut_objective="profile",
                         profile={"actors": {"a": 2}, "channels": {}})
    assert dataclasses.replace(plan, cores=4).profile == plan.profile


# --------------------------------------------------------------------------- #
# ProgramStats.to_json.
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("backend", ("dynamic", "grid2"))
def test_stats_to_json_roundtrip(graphs, backend):
    prog = graphs["dpd"][1].compile(ExecutionPlan(**_kw(backend, trace=True)))
    prog.run()
    stats = prog.stats()
    doc = stats.to_json()
    assert doc["schema_version"] == 2
    assert {f.name for f in dataclasses.fields(stats)} <= set(doc)
    assert {"schema_version", "mode", "grid_cores", "partition_actors",
            "cut_objective"} <= set(doc)
    assert json.loads(json.dumps(doc)) == doc
    if backend == "grid2":
        assert doc["grid_cores"] == 2 and isinstance(doc["partition_actors"], list)


# --------------------------------------------------------------------------- #
# The serving network (tests/test_trace.py:78-90): the trace observes the
# megakernel's yields too.
# --------------------------------------------------------------------------- #
@pytest.fixture(scope="module")
def serving_net():
    from repro_torch.configs import smoke_config
    from repro_torch.models import LM
    from repro_torch.serve import ActorEngine, Request, ServeConfig
    cfg = smoke_config("granite-8b")
    rng = np.random.default_rng(1)
    reqs = [Request(prompt=rng.integers(1, cfg.vocab, size=int(n)).astype(np.int32),
                    max_new=m) for n, m in [(5, 3), (3, 2), (6, 3)]]
    eng = ActorEngine(cfg, LM(cfg, device="cpu", seed=0),
                      ServeConfig(batch_size=2, max_prompt=8, max_new=3, eos_id=7))
    return eng.build_network(reqs)


@pytest.mark.parametrize("backend", BACKENDS)
def test_serving_trace_off_path_bit_identical(serving_net, backend):
    """Tracing the serving network changes no state, sweep or fire count in
    any backend (in megakernel mode a B2 run per decode step, its attempt
    recorded once before the yield), and every backend records the host
    dynamic run's events."""
    off = serving_net.compile(ExecutionPlan(**_kw(backend))).run()
    on = serving_net.compile(ExecutionPlan(**_kw(backend, trace=True))).run()
    assert states_equal(off.state, on.state)
    assert (off.sweeps, off.fire_counts) == (on.sweeps, on.fire_counts)
    assert off.trace is None and on.trace.n_events > 0
    assert on.trace.firing_counts() == on.fire_counts
    dyn = serving_net.compile(ExecutionPlan(**_kw("dynamic", trace=True))).run()
    np.testing.assert_array_equal(on.trace.events, dyn.trace.events)

"""Heterogeneous placement and ``Program.stream`` on the port, held to the
JAX package on the same feeds (CPU).

Counterparts of the reference's ``test_core_executors.py::
test_heterogeneous_split``, the eight stream tests of
``test_program_api.py``, the four of ``test_faults.py``,
``test_trace.py::test_stream_merges_chunk_traces`` and
``test_resilience.py::test_stream_feed_domain_error_names_chunk_and_request``.
Structure is held exactly (fire counts, sweeps, report entries, staged
bytes, the chunk and request ids of errors); DPD's floats within
``1e-5 * max|y|`` per (re, im) plane (``test_torch_harness.REL_TOL``), motion
detection's u8 frames and the toy graphs' floats exactly.
"""
from __future__ import annotations

import numpy as np
import pytest
import torch

from test_torch_harness import assert_leaves_match, jax_literal  # noqa: F401 (fixture)

from repro_torch.core import (ExecutionPlan, NetworkBuilder, NetworkFaultError,
                              collect_sink, heterogeneous_split, stage_feed,
                              static_actor, truncate_feed)
from repro_torch.graphs.factories import make_dpd, make_motion_detection

MD_HW = (48, 64)
MD_ACCEL = ("gauss", "thres", "med")


def _dpd_accel(net):
    return tuple(n for n in net.actors if n not in ("source", "sink"))


def _dpd_windows(n_firings: int, block_l: int, rows: int = 2) -> np.ndarray:
    """The reference tests' feed: seed-0 normal signal cut into windows."""
    sig = np.random.default_rng(0).normal(size=(rows, n_firings * block_l)).astype(np.float32)
    return np.stack([sig[:2, i * block_l:(i + 1) * block_l]
                     for i in range(n_firings)])[:, None]


def _video(n_frames: int, seed: int = 1) -> np.ndarray:
    rng = np.random.default_rng(seed)
    return np.clip(np.round(rng.uniform(0, 255, (n_frames,) + MD_HW)), 0,
                   255).astype(np.uint8)


def _raises_alike(ref_call, port_call, exc=ValueError, match=None) -> str:
    """Both calls raise ``exc`` (matching ``match``); returns the port's
    message after checking it equals the reference's."""
    with pytest.raises(exc, match=match) as want:
        ref_call()
    with pytest.raises(exc, match=match) as got:
        port_call()
    assert str(got.value) == str(want.value)
    return str(got.value)


# --------------------------------------------------------------------------- #
# heterogeneous_split (test_core_executors.py:137).
# --------------------------------------------------------------------------- #
def _chain(ref: bool):
    rate, n_iter = 2, 8
    if ref:
        import jax
        import jax.numpy as jnp
        from repro.core import NetworkBuilder as B, map_fire, static_actor as sa

        def src_fire(state, inputs, rates):
            data, idx = state
            return (data, idx + 1), {"out": jax.lax.dynamic_slice_in_dim(
                data, idx * rate, rate, 0)}
        src = sa("src", (), ("out",), src_fire,
                 init=lambda: (jnp.arange(n_iter * rate * 3, dtype=jnp.float32)
                               .reshape(n_iter * rate, 3), jnp.int32(0)),
                 ready=lambda st: st[1] < n_iter)
        dbl = sa("dbl", ("in",), ("out",), map_fire(lambda w: w * 2.0, "in", "out"))
        snk = sa("snk", ("in",), (), lambda st, ins, r: (st, {}))
        b = B()
    else:
        def src_fire(state, inputs, rates):
            data, idx = state
            return (data, idx + 1), {"out": data[idx * rate:(idx + 1) * rate]}
        src = static_actor("src", (), ("out",), src_fire,
                           init=lambda: (torch.arange(n_iter * rate * 3, dtype=torch.float32)
                                         .reshape(n_iter * rate, 3), 0),
                           ready=lambda st: st[1] < n_iter)
        dbl = static_actor("dbl", ("in",), ("out",),
                           lambda st, ins, r: (st, {"out": ins["in"] * 2.0}))
        snk = static_actor("snk", ("in",), (), lambda st, ins, r: (st, {}))
        b = NetworkBuilder()
    b.actors(src, dbl, snk)
    b.connect("src.out", "dbl.in", rate=rate, token_shape=(3,), name="f1")
    b.connect("dbl.out", "snk.in", rate=rate, token_shape=(3,), name="f2")
    return b.build() if ref else b.build(device="cpu")


def test_heterogeneous_split(jax_literal):
    import jax.numpy as jnp
    from repro.core import collect_sink as ref_collect
    from repro.core import heterogeneous_split as ref_split, stage_feed as ref_stage
    ref_net, net = _chain(True), _chain(False)
    rsub, rfeeds, rfetches = ref_split(ref_net, ["dbl"], n_iterations=8)
    sub, feeds, fetches = heterogeneous_split(net, ["dbl"], n_iterations=8)
    assert (feeds, fetches) == (rfeeds, rfetches) == (["__feed_f1"], ["__fetch_f2"])
    assert list(sub.actors) == list(rsub.actors)
    assert list(sub.fifos) == list(rsub.fifos)
    assert sub.register_fifos == rsub.register_fifos
    data = np.arange(8 * 2 * 3, dtype=np.float32).reshape(8, 2, 3)
    rst = ref_stage(rsub.init_state(), "__feed_f1", jnp.asarray(data))
    want = np.asarray(ref_collect(rsub, rsub.compile(mode="static", n_iterations=8)
                                  .run(rst).state, "__fetch_f2"))
    state = sub.init_state()
    staged = stage_feed(state, "__feed_f1", data)
    assert state.actor("__feed_f1")[0].abs().sum() == 0      # left as it was
    got = collect_sink(sub, sub.compile(mode="static", n_iterations=8)
                       .run(staged).state, "__fetch_f2")
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(got.numpy().reshape(-1, 3), 2 * data.reshape(-1, 3))
    # The feed and fetch declare B2's source and sink on one plane.
    assert sub.actors["__feed_f1"].device_op.kind == "source"
    assert sub.actors["__feed_f1"].device_op.params == {"n_firings": 8, "planes": 1}
    assert sub.actors["__fetch_f2"].device_op.kind == "sink"


# --------------------------------------------------------------------------- #
# The stream tests of test_program_api.py:203-321.
# --------------------------------------------------------------------------- #
def _md_pair(n_frames, rate=4):
    from repro.graphs.factories import make_motion_detection as ref_make_md
    ref_net, n_iter = ref_make_md(n_frames=n_frames, rate=rate, frame_hw=MD_HW)
    net, n = make_motion_detection(n_frames, rate=rate, frame_hw=MD_HW, device="cpu")
    assert n == n_iter
    return ref_net, net, n_iter


def test_plan_rejects_unknown_accelerated_actor(jax_literal):
    ref_net, net, _ = _md_pair(12)
    _raises_alike(
        lambda: ref_net.compile(mode="static", n_iterations=3, accelerated=("nosuch",)),
        lambda: net.compile(mode="static", n_iterations=3, accelerated=("nosuch",)),
        match="unknown actors.*nosuch")
    _raises_alike(
        lambda: ref_net.compile(mode="dynamic", accelerated=("gauss",)),
        lambda: net.compile(mode="dynamic", accelerated=("gauss",)),
        match="n_iterations")


def test_stream_requires_heterogeneous_plan(jax_literal):
    ref_net, net, n_iter = _md_pair(12)
    _raises_alike(lambda: ref_net.compile(mode="static", n_iterations=n_iter).stream({}),
                  lambda: net.compile(mode="static", n_iterations=n_iter).stream({}),
                  match="accelerated")


def test_stream_rejects_period_misaligned_chunk_up_front(jax_literal):
    ref_net, net, _ = _md_pair(16)
    feed = np.zeros((4, 4) + MD_HW, np.uint8)
    _raises_alike(
        lambda: ref_net.compile(mode="static", n_iterations=1,
                                accelerated=MD_ACCEL).stream({"f_src_gauss": feed}),
        lambda: net.compile(mode="static", n_iterations=1,
                            accelerated=MD_ACCEL).stream({"f_src_gauss": feed}),
        match="phase-unroll period")
    # specialize=False has no alignment rule: the same chunking streams.
    want = ref_net.compile(mode="static", n_iterations=1, specialize=False,
                           accelerated=MD_ACCEL).stream({"f_src_gauss": feed})
    got = net.compile(mode="static", n_iterations=1, specialize=False,
                      accelerated=MD_ACCEL).stream({"f_src_gauss": feed})
    np.testing.assert_array_equal(got["f_med_sink"].numpy(), np.asarray(want["f_med_sink"]))
    assert tuple(got["f_med_sink"].shape) == (4, 4) + MD_HW


def test_stream_equals_single_run_md(jax_literal):
    n_frames, rate = 24, 4
    ref_net, net, n_iter = _md_pair(n_frames, rate)
    feeds = {"f_src_gauss": _video(n_frames).reshape(n_iter, rate, *MD_HW)}
    want = ref_net.compile(mode="static", n_iterations=6, accelerated=MD_ACCEL).stream(feeds)
    prog = net.compile(mode="static", n_iterations=6, accelerated=MD_ACCEL)
    outs = prog.stream(feeds)
    assert set(outs) == {"f_med_sink"}
    assert tuple(outs["f_med_sink"].shape) == (n_iter, rate) + MD_HW
    np.testing.assert_array_equal(outs["f_med_sink"].numpy(), np.asarray(want["f_med_sink"]))
    # The concatenation invariant: one long run of the whole network on the
    # same frames (the delay token carries across chunks).
    from repro_torch.graphs.motion_detection import build_motion_detection
    whole = build_motion_detection(n_frames, rate=rate, frame_hw=MD_HW,
                                   video=_video(n_frames).astype(np.float32), device="cpu")
    full = whole.compile(mode="static", n_iterations=n_iter)
    np.testing.assert_array_equal(outs["f_med_sink"].numpy().reshape(n_frames, *MD_HW),
                                  full.collect("sink", full.run().state).numpy())


def test_stream_accepts_flat_feed_and_checks_shapes(jax_literal):
    ref_net, net, _ = _md_pair(24)
    rprog = ref_net.compile(mode="static", n_iterations=6, accelerated=MD_ACCEL)
    prog = net.compile(mode="static", n_iterations=6, accelerated=MD_ACCEL)
    for feeds, match in (({"nope": np.zeros((6, 4) + MD_HW)}, "unknown feed channels"),
                         ({}, "missing feeds"),
                         ({"f_src_gauss": np.zeros((6, 3) + MD_HW)}, "expected"),
                         ({"f_src_gauss": np.zeros((4, 4) + MD_HW)}, "do not divide")):
        _raises_alike(lambda: rprog.stream(feeds), lambda: prog.stream(feeds), match=match)
    flat = np.zeros((24,) + MD_HW, np.uint8)
    outs = prog.stream({"f_src_gauss": flat})
    assert tuple(outs["f_med_sink"].shape) == (6, 4) + MD_HW
    np.testing.assert_array_equal(outs["f_med_sink"].numpy(),
                                  np.asarray(rprog.stream({"f_src_gauss": flat})["f_med_sink"]))


def test_stream_dynamic_mode_dpd(jax_literal):
    import jax.numpy as jnp
    from repro.graphs.factories import make_dpd as ref_make_dpd
    ref_net, nf = ref_make_dpd(n_firings=4, block_l=128)
    net, _ = make_dpd(n_firings=4, block_l=128, device="cpu")
    wins = _dpd_windows(nf, 128)
    rprog = ref_net.compile(mode="dynamic", n_iterations=2, accelerated=_dpd_accel(ref_net))
    want = rprog.stream({"f_in": jnp.asarray(wins)})
    prog = net.compile(mode="dynamic", n_iterations=2, accelerated=_dpd_accel(net))
    outs = prog.stream({"f_in": wins})
    assert_leaves_match([np.asarray(want["f_out"])], [outs["f_out"].numpy()])
    assert prog.last_stream_fire_counts == {k: int(v) for k, v in
                                            rprog.last_stream_fire_counts.items()}
    assert prog.last_stream_sweeps == rprog.last_stream_sweeps
    assert prog.stats().to_json()["last_stream_staged_bytes_per_chunk"] == \
        rprog.stats().to_json()["last_stream_staged_bytes_per_chunk"]
    # The concatenation invariant against the port's own whole run.
    full = net.compile(mode="dynamic").run()
    got = torch.cat(list(outs["f_out"][:, 0]), dim=1)
    assert torch.equal(got, full.state.actor("sink")[0])


def test_stream_per_chunk_feeds_validated_across_chunks(jax_literal):
    ref_net, net, _ = _md_pair(48)
    rprog = ref_net.compile(mode="static", n_iterations=6, accelerated=MD_ACCEL)
    prog = net.compile(mode="static", n_iterations=6, accelerated=MD_ACCEL)
    video = _video(48).reshape(12, 4, *MD_HW)
    whole = prog.stream({"f_src_gauss": video})
    parts = prog.stream({"f_src_gauss": [video[:6], video[6:]]})
    assert torch.equal(whole["f_med_sink"], parts["f_med_sink"])
    np.testing.assert_array_equal(
        parts["f_med_sink"].numpy(),
        np.asarray(rprog.stream({"f_src_gauss": [video[:6], video[6:]]})["f_med_sink"]))
    for feed, match in (([video[:6], video[6:].astype(np.float32)],
                         r"chunk 1 carries dtype float32"),
                        ([video[:6], video[6:9]], r"chunk 1 has window shape"),
                        ([video[:3], video[3:6]], r"chunk 0 covers 3 windows"),
                        ([], "empty per-chunk list")):
        _raises_alike(lambda: rprog.stream({"f_src_gauss": feed}),
                      lambda: prog.stream({"f_src_gauss": feed}), match=match)


def test_stream_persistent_feed_identical_and_stages_less(jax_literal, tmp_path):
    import jax.numpy as jnp
    from repro.core import ExecutionPlan as RefPlan
    from repro.graphs.factories import make_dpd as ref_make_dpd
    ref_net, nf = ref_make_dpd(n_firings=8, block_l=128)
    net, _ = make_dpd(n_firings=8, block_l=128, device="cpu")
    wins = _dpd_windows(nf, 128, rows=8)
    rprog = ref_net.compile(RefPlan(mode="megakernel", n_iterations=4,
                                    accelerated=_dpd_accel(ref_net), specialize=False))
    prog = net.compile(ExecutionPlan(mode="megakernel", n_iterations=4,
                                     accelerated=_dpd_accel(net), specialize=False))
    ref_chunked = rprog.stream({"f_in": jnp.asarray(wins)})
    rc = rprog.stats()
    chunked = prog.stream({"f_in": wins})
    c = prog.stats()
    assert_leaves_match([np.asarray(ref_chunked["f_out"])], [chunked["f_out"].numpy()])
    for field in ("last_stream_chunks", "last_stream_persistent",
                  "last_stream_staged_bytes_per_chunk", "last_stream_total_staged_bytes"):
        assert getattr(c, field) == getattr(rc, field), field
    assert c.last_stream_chunks == 2 and c.last_stream_persistent is False
    counts = dict(prog.last_stream_fire_counts)
    assert counts == {k: int(v) for k, v in rprog.last_stream_fire_counts.items()}
    assert prog.last_stream_sweeps == rprog.last_stream_sweeps
    # Persistent: one run, bit-identical to the chunked loop, fewer bytes.
    rprog.stream({"f_in": jnp.asarray(wins)}, persistent=True)
    rp = rprog.stats()
    outs = prog.stream({"f_in": wins}, persistent=True)
    p = prog.stats()
    assert torch.equal(outs["f_out"], chunked["f_out"])
    for field in ("last_stream_chunks", "last_stream_persistent",
                  "last_stream_staged_bytes_per_chunk", "last_stream_total_staged_bytes"):
        assert getattr(p, field) == getattr(rp, field), field
    assert p.last_stream_persistent is True
    assert p.last_stream_staged_bytes_per_chunk < c.last_stream_staged_bytes_per_chunk
    assert p.last_stream_total_staged_bytes < c.last_stream_total_staged_bytes
    assert prog.last_stream_fire_counts == counts
    assert prog.last_stream_sweeps == rprog.last_stream_sweeps
    outs2 = prog.stream({"f_in": wins}, persistent=True, on_fault="skip")
    assert torch.equal(outs2["f_out"], chunked["f_out"])
    _raises_alike(
        lambda: rprog.stream({"f_in": jnp.asarray(wins)}, persistent=True,
                             checkpoint_dir=str(tmp_path / "a")),
        lambda: prog.stream({"f_in": wins}, persistent=True,
                            checkpoint_dir=str(tmp_path / "b")),
        match="persistent=True.*checkpoint_dir")
    with pytest.raises(ValueError, match="stream"):
        prog.collect("sink")


def test_megakernel_stream_with_forwarded_transients_refused_up_front():
    """B2 is not re-entered with forwarded transients: a chunked stream
    (and a persistent one that may fall back to chunks) is refused before
    any chunk runs, naming the item; one chunk, or a persistent stream
    that raises on faults, runs."""
    net, nf = make_dpd(n_firings=4, block_l=64, device="cpu")
    wins = _dpd_windows(nf, 64)
    prog = net.compile(mode="megakernel", n_iterations=2, accelerated=_dpd_accel(net))
    assert prog.stats().forwarded_fifos
    with pytest.raises(ValueError, match="ROADMAP A11.*specialize=False"):
        prog.stream({"f_in": wins})
    with pytest.raises(ValueError, match="forwarded channels"):
        prog.stream({"f_in": wins}, persistent=True, on_fault="skip")
    with pytest.raises(ValueError, match="ROADMAP A11"):
        net.compile(mode="megakernel").run_checkpointed("unused", every_sweeps=2)
    outs = prog.stream({"f_in": wins}, persistent=True)
    ref = net.compile(mode="megakernel", n_iterations=2, accelerated=_dpd_accel(net),
                      specialize=False).stream({"f_in": wins})
    assert torch.equal(outs["f_out"], ref["f_out"])
    one = net.compile(mode="megakernel", n_iterations=4, accelerated=_dpd_accel(net))
    assert torch.equal(one.stream({"f_in": wins})["f_out"], ref["f_out"])


# --------------------------------------------------------------------------- #
# The fault policies (test_faults.py:194-240) and the merged trace
# (test_trace.py:244), on the amp toy graph.
# --------------------------------------------------------------------------- #
def _amp_net(ref: bool, token=(8,), domain=None, row_id_col=None):
    if ref:
        import jax.numpy as jnp
        from repro.core import NetworkBuilder as B, map_fire, static_actor as sa
        zeros = jnp.zeros((4,) + token)
        amp = sa("amp", ("in",), ("out",), map_fire(lambda w: 2.0 * w, "in", "out"))
        b = B()
    else:
        sa = static_actor
        zeros = torch.zeros((4,) + token)
        amp = sa("amp", ("in",), ("out",), lambda st, ins, r: (st, {"out": 2.0 * ins["in"]}))
        b = NetworkBuilder()
    b.actor(sa("src", (), ("out",), lambda st, ins, r: (st, {"out": zeros})))
    b.actor(amp)
    b.actor(sa("sink", ("in",), (), lambda st, ins, r: (st, {})))
    kw = {} if domain is None else {"domain": domain, "row_id_col": row_id_col}
    b.connect("src.out", "amp.in", rate=4, token_shape=token, name="f_in", **kw)
    b.connect("amp.out", "sink.in", rate=4, token_shape=token, name="f_out")
    return b.build() if ref else b.build(device="cpu")


def _amp_progs(**plan):
    from repro.core import ExecutionPlan as RefPlan
    kw = dict(mode="dynamic", n_iterations=2, accelerated=("amp",), **plan)
    return (_amp_net(True).compile(RefPlan(**kw)),
            _amp_net(False).compile(ExecutionPlan(**kw)))


def _ref_fault():
    from repro.core import NetworkFaultError as RefFaultError
    return RefFaultError


@pytest.fixture
def stream_setup(jax_literal):
    rprog, prog = _amp_progs(guards=True)
    feeds = np.arange(6 * 4 * 8, dtype=np.float32).reshape(6, 4, 8)
    poisoned = feeds.copy()
    poisoned[3, 1, 2] = np.nan          # chunk 1 of 3 (windows 2..3)
    return rprog, prog, feeds, poisoned


def _report_key(report):
    """Report entries without the fault text (the two packages word a
    fault's channel list alike but not its high-water marks)."""
    return [(e["chunk"], e["attempts"], e["action"], e["fault"] is None) for e in report]


def test_stream_clean_and_raise_policy(stream_setup):
    rprog, prog, feeds, poisoned = stream_setup
    outs = prog.stream({"f_in": feeds})
    np.testing.assert_array_equal(outs["f_out"].numpy(), 2 * feeds)
    np.testing.assert_array_equal(
        outs["f_out"].numpy(), np.asarray(rprog.stream({"f_in": feeds})["f_out"]))
    assert prog.last_stream_report == rprog.last_stream_report == []
    with pytest.raises(NetworkFaultError, match="chunk 1 of 3") as exc:
        prog.stream({"f_in": poisoned})
    assert "f_in" in str(exc.value)
    with pytest.raises(_ref_fault(), match="chunk 1 of 3"):
        rprog.stream({"f_in": poisoned})
    assert _report_key(prog.last_stream_report) == _report_key(rprog.last_stream_report)


def test_stream_skip_policy_degrades_gracefully(stream_setup):
    rprog, prog, feeds, poisoned = stream_setup
    got = prog.stream({"f_in": poisoned}, on_fault="skip")["f_out"].numpy()
    want = np.asarray(rprog.stream({"f_in": poisoned}, on_fault="skip")["f_out"])
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got[:2], 2 * feeds[:2])
    assert np.all(got[2:4] == 0)
    np.testing.assert_array_equal(got[4:], 2 * feeds[4:])
    (entry,) = prog.last_stream_report
    assert entry["chunk"] == 1 and entry["action"] == "skip"
    assert "NONFINITE" in entry["fault"]
    assert _report_key(prog.last_stream_report) == _report_key(rprog.last_stream_report)


def test_stream_resume_policy_bounded_retries(stream_setup):
    rprog, prog, _, poisoned = stream_setup
    with pytest.raises(NetworkFaultError, match=r"after 3 attempt"):
        prog.stream({"f_in": poisoned}, on_fault="resume", max_retries=2)
    with pytest.raises(_ref_fault(), match=r"after 3 attempt"):
        rprog.stream({"f_in": poisoned}, on_fault="resume", max_retries=2)
    assert _report_key(prog.last_stream_report) == _report_key(rprog.last_stream_report)
    _raises_alike(lambda: rprog.stream({"f_in": poisoned}, on_fault="retry"),
                  lambda: prog.stream({"f_in": poisoned}, on_fault="retry"),
                  match="on_fault")


def test_stream_feed_validation_names_actor(stream_setup):
    rprog, prog, feeds, _ = stream_setup
    with pytest.raises(ValueError, match="__feed_f_in.*complex64"):
        prog.stream({"f_in": feeds.astype(np.complex64)})
    ints = np.arange(6 * 4 * 8, dtype=np.int32).reshape(6, 4, 8)
    outs = prog.stream({"f_in": ints})
    np.testing.assert_array_equal(outs["f_out"].numpy(), 2.0 * ints.astype(np.float32))
    _raises_alike(lambda: rprog.stream({"f_in": np.zeros((6, 3, 8), np.float32)}),
                  lambda: prog.stream({"f_in": np.zeros((6, 3, 8), np.float32)}),
                  match="__feed_f_in")
    truncated = truncate_feed({"f_in": feeds}, "f_in", drop=1)
    with pytest.raises(ValueError, match="windows do not divide"):
        prog.stream(truncated)


def test_stream_merges_chunk_traces(jax_literal):
    rprog, prog = _amp_progs(trace=True)
    feeds = np.arange(6 * 4 * 8, dtype=np.float32).reshape(6, 4, 8)
    prog.stream({"f_in": feeds})
    rprog.stream({"f_in": feeds})
    tr, rtr = prog.last_stream_trace, rprog.last_stream_trace
    assert tr is not None and tr.firing_counts()["amp"] == 6
    assert (np.diff(tr.events[:, 1]) >= 0).all()
    np.testing.assert_array_equal(tr.events, np.asarray(rtr.events))
    assert tr.actor_names == rtr.actor_names
    _, untraced = _amp_progs()
    untraced.stream({"f_in": feeds})
    assert untraced.last_stream_trace is None


def test_stream_feed_domain_error_names_chunk_and_request(jax_literal):
    from repro.core import ExecutionPlan as RefPlan
    kw = dict(mode="dynamic", n_iterations=2, accelerated=("amp",))
    rprog = _amp_net(True, (2, 8), (0.0, 100.0), 0).compile(RefPlan(**kw))
    prog = _amp_net(False, (2, 8), (0.0, 100.0), 0).compile(ExecutionPlan(**kw))
    feeds = np.ones((6, 4, 2, 8), np.float32)
    feeds[:, :, :, 0] = 7.0            # the row id column
    np.testing.assert_array_equal(prog.stream({"f_in": feeds})["f_out"].numpy(), 2 * feeds)
    bad = feeds.copy()
    bad[3, 1, 0, 2] = -5.0             # window 3 -> chunk 1; row id 7
    for p in (rprog, prog):
        with pytest.raises(ValueError, match=r"window 3 \(chunk 1\).*request id 7"):
            p.stream({"f_in": bad})
    nan = feeds.copy()
    nan[0, 0, 1, 3] = np.nan
    for p in (rprog, prog):
        with pytest.raises(ValueError, match=r"window 0 \(chunk 0\)"):
            p.stream({"f_in": nan})


def test_dpd_megakernel_stream_equals_dynamic_stream_bit_for_bit():
    """B2's plain version re-entered at every chunk boundary equals the host
    dynamic stream, bit for bit, at cores 1 and 2."""
    net, nf = make_dpd(n_firings=8, block_l=64, device="cpu")
    wins = _dpd_windows(nf, 64)
    dyn = net.compile(mode="dynamic", n_iterations=2, accelerated=_dpd_accel(net))
    want = dyn.stream({"f_in": wins})
    for cores in (1, 2):
        mk = net.compile(mode="megakernel", n_iterations=2, cores=cores,
                         accelerated=_dpd_accel(net), specialize=False)
        got = mk.stream({"f_in": wins})
        assert torch.equal(got["f_out"], want["f_out"])
        assert mk.last_stream_fire_counts == dyn.last_stream_fire_counts
        assert mk.last_stream_sweeps == dyn.last_stream_sweeps

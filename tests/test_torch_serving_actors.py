"""Serving as actors on the port (``graphs/serving.py``,
``serve/actor_engine.py``) against the port's ``Engine`` and the JAX
package's ``ActorEngine``, at ``smoke_config("granite-8b")`` with the
reference's weights converted by ``lm_params_from_numpy``.

* The reference's own tests (``tests/test_serving_actors.py``) on the
  port, with the port's ``Engine`` as the oracle: the actor engine gives
  its tokens, token for token, guarded or not, whatever the arrivals.
* Structure against the JAX ``ActorEngine`` exactly, on
  ``benchmarks/bench_serving.py``'s fast workload (R 6, B 2, P 8, N 6,
  budgets alternating 6 and 1, ``poisson_trace(6, 2.0, seed=7)``): sweeps,
  fire counts, latency steps, statuses, high-water marks and every trace
  event.  With eos_id None they depend on budgets and arrivals only.
* Tokens against the JAX ``ActorEngine`` where the two frameworks'
  ``Engine``s agree (greedy tokens across frameworks may flip on near-ties,
  ROADMAP C3).
* Resilience against the reference: ``expire_deadline``, shedding at
  ``queue_depth=0``, ``poison_request`` with ``faulted_requests`` and the
  quarantine loop.
* The same in megakernel mode (kernel B2's plain version on the CPU, a
  launch a decode step plus one) against the JAX ``ActorEngine`` in
  megakernel mode: structure on the bench workload, high-water marks and
  trace events of the guarded, traced run, and the resilience matrix
  (``tests/test_resilience.py:94-135``, unspecialized as there).

The reference's ``NetworkBuilder.build`` reads ``jax.core.Literal`` (C1);
the module-scoped ``ref`` fixture aliases it while it runs the reference
and restores jax after.
"""
from __future__ import annotations

import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro.configs import smoke_config as ref_smoke_config
from repro.core import ExecutionPlan as RefPlan
from repro.core import NetworkFaultError as RefFaultError
from repro.core import expire_deadline as ref_expire_deadline
from repro.core import poison_request as ref_poison_request
from repro.graphs import serving as ref_serving
from repro.models import init_params as ref_init_params
from repro.serve import ActorEngine as RefActorEngine
from repro.serve import Engine as RefEngine
from repro.serve import Request as RefRequest
from repro.serve import ServeConfig as RefServeConfig
from repro_torch.configs import smoke_config
from repro_torch.convert import lm_params_from_numpy
from repro_torch.core import (ExecutionPlan, FifoSpec, NetworkFaultError, expire_deadline,
                              poison_request)
from repro_torch.core.faultinject import POISON_VALUE
from repro_torch.core.network import tree_leaves
from repro_torch.graphs import serving
from repro_torch.models import LM
from repro_torch.serve import ActorEngine, Engine, Request, Result, ServeConfig

ARCH = "granite-8b"
# bench_serving.py's fast workload.
BENCH_R, BENCH = 6, dict(batch_size=2, max_prompt=8, max_new=6, eos_id=None)
GUARDED_TRACED = dict(mode="dynamic", guards=True, trace=True)
#: The reference's resilience tests run megakernel plans unspecialized.
MK_PLAN = dict(mode="megakernel", specialize=False)


def _port_model(arch, params=None, **overrides):
    jcfg = ref_smoke_config(arch)
    if params is None:
        params = ref_init_params(jax.random.PRNGKey(0), jcfg)
    cfg = dataclasses.replace(smoke_config(arch), **overrides)
    model = LM(cfg, device="cpu", seed=None)
    model.load_state_dict(lm_params_from_numpy(cfg, jax.tree.map(np.asarray, params)))
    return cfg, model, params


@pytest.fixture(scope="module")
def lm():
    cfg, model, params = _port_model(ARCH)
    return ref_smoke_config(ARCH), params, cfg, model


def _bench_prompts(vocab):
    rng = np.random.default_rng(9)
    budgets = [BENCH["max_new"] if i % 2 == 0 else 1 for i in range(BENCH_R)]
    prompts = [rng.integers(1, vocab, size=BENCH["max_prompt"] - 1 - (i % 3)).astype(np.int32)
               for i in range(BENCH_R)]
    return prompts, budgets


@pytest.fixture(scope="module")
def bench(lm):
    _, _, cfg, _ = lm
    prompts, budgets = _bench_prompts(cfg.vocab)
    return ([Request(p, m) for p, m in zip(prompts, budgets)],
            serving.poisson_trace(BENCH_R, 2.0, seed=7))


def _ref_diag(err):
    return sorted(f.fifo for f in err.diagnostics.faults if "DOMAIN" in f.faults)


@pytest.fixture(scope="module")
def ref(lm):
    """Every reference run this file compares with, made once (under the
    ``jax.core.Literal`` alias, restored after)."""
    jcfg, params, cfg, _ = lm
    prompts, budgets = _bench_prompts(cfg.vocab)
    reqs = [RefRequest(p, m) for p, m in zip(prompts, budgets)]
    arrivals = ref_serving.poisson_trace(BENCH_R, 2.0, seed=7)
    scfg = RefServeConfig(**BENCH)
    out = {}
    with pytest.MonkeyPatch.context() as mp:
        if not hasattr(jax.core, "Literal"):
            from jax.extend.core import Literal
            mp.setattr(jax.core, "Literal", Literal, raising=False)
        eng = RefActorEngine(jcfg, params, scfg)
        toks = eng.generate(reqs, arrivals=arrivals)
        out["bench"] = dict(tokens=[r.tokens.tolist() for r in toks],
                            sweeps=eng.last_sweeps, counts=eng.last_fire_counts,
                            lat=eng.last_latency_steps.tolist(), status=eng.last_status)
        out["engine"] = [r.tokens.tolist() for r in RefEngine(jcfg, params, scfg)
                         .generate(reqs)]
        wl, _ = eng._stage(reqs, arrivals, None)
        # The bench workload guarded and traced: high-water marks, events.
        net = ref_serving.build_serving_network(
            jcfg, params, wl, batch_size=2, max_prompt=8, max_new=6)
        res = net.compile(RefPlan(**GUARDED_TRACED)).run()
        out["traced"] = dict(high_water=res.diagnostics.high_water,
                             events=np.asarray(res.trace.events))
        out["matched"] = {n for n, s in net.fifos.items() if s.matched_rates}
        # Resilience.
        dl = ref_expire_deadline(wl, 2).deadlines
        eng.generate(reqs, arrivals=arrivals, deadlines=dl)
        out["expire"] = dict(status=eng.last_status, lat=eng.last_latency_steps.tolist(),
                             counts=eng.last_fire_counts, sweeps=eng.last_sweeps)
        shed = RefActorEngine(jcfg, params, scfg, queue_depth=0)
        shed.generate(reqs)
        out["shed"] = dict(status=shed.last_status, lat=shed.last_latency_steps.tolist(),
                           counts=shed.last_fire_counts, sweeps=shed.last_sweeps)
        pw = ref_poison_request(wl, 3)
        pnet = ref_serving.build_serving_network(
            jcfg, params, pw, batch_size=2, max_prompt=8, max_new=6)
        with pytest.raises(RefFaultError) as ei:
            pnet.compile(RefPlan(mode="dynamic", guards=True)).run()
        out["poison"] = dict(domain=_ref_diag(ei.value),
                             culprits=ref_serving.faulted_requests(pnet, ei.value, pw))
        bad = list(reqs)
        bad[3] = RefRequest(np.full(4, POISON_VALUE, np.int32), budgets[3])
        q = RefActorEngine(jcfg, params, scfg, plan=RefPlan(mode="dynamic", guards=True))
        qt = q.generate(bad, arrivals=arrivals, on_fault="quarantine")
        out["quarantine"] = dict(status=q.last_status, retries=q.last_retries,
                                 tokens=[r.tokens.tolist() for r in qt])
        # Megakernel mode.
        mk = RefActorEngine(jcfg, params, scfg, plan=RefPlan(mode="megakernel"))
        mk.generate(reqs, arrivals=arrivals)
        out["bench_mk"] = dict(sweeps=mk.last_sweeps, counts=mk.last_fire_counts,
                               lat=mk.last_latency_steps.tolist(), status=mk.last_status)
        res = net.compile(RefPlan(mode="megakernel", **{
            k: v for k, v in GUARDED_TRACED.items() if k != "mode"})).run()
        out["traced_mk"] = dict(high_water=res.diagnostics.high_water,
                                events=np.asarray(res.trace.events))
        mk = RefActorEngine(jcfg, params, scfg, plan=RefPlan(**MK_PLAN))
        mk.generate(reqs, arrivals=arrivals, deadlines=dl)
        out["expire_mk"] = dict(status=mk.last_status, lat=mk.last_latency_steps.tolist(),
                                counts=mk.last_fire_counts, sweeps=mk.last_sweeps)
        mk = RefActorEngine(jcfg, params, scfg, plan=RefPlan(**MK_PLAN), queue_depth=0)
        mk.generate(reqs)
        out["shed_mk"] = dict(status=mk.last_status, lat=mk.last_latency_steps.tolist(),
                              counts=mk.last_fire_counts, sweeps=mk.last_sweeps)
        mk = RefActorEngine(jcfg, params, scfg, plan=RefPlan(guards=True, **MK_PLAN))
        mk.generate(bad, arrivals=arrivals, on_fault="quarantine")
        out["quarantine_mk"] = dict(status=mk.last_status, retries=mk.last_retries)
    return out


# --------------------------------------------------------------------------- #
# The reference's tests/test_serving_actors.py on the port.
# --------------------------------------------------------------------------- #
@pytest.fixture(scope="module")
def requests(lm):
    _, _, cfg, _ = lm
    rng = np.random.default_rng(1)
    return [Request(prompt=rng.integers(1, cfg.vocab, size=int(n)).astype(np.int32),
                    max_new=m)
            for n, m in [(5, 4), (3, 2), (7, 4), (4, 3), (6, 4)]]


@pytest.fixture(scope="module")
def scfg():
    # eos_id inside the argmax range, so slots retire by EOS and by budget.
    return ServeConfig(batch_size=2, max_prompt=8, max_new=4, eos_id=7)


@pytest.fixture(scope="module")
def engine_tokens(lm, requests, scfg):
    _, _, cfg, model = lm
    return [r.tokens for r in Engine(cfg, model, scfg).generate(requests)]


@pytest.mark.parametrize("mode,guards", [("dynamic", False), ("dynamic", True),
                                         ("megakernel", False), ("megakernel", True)])
def test_actor_engine_matches_engine(lm, requests, scfg, engine_tokens, mode, guards):
    _, _, cfg, model = lm
    eng = ActorEngine(cfg, model, scfg, plan=ExecutionPlan(mode=mode, guards=guards))
    got = eng.generate(requests)
    for want, have in zip(engine_tokens, got):
        np.testing.assert_array_equal(want, have.tokens)
        assert have.status == "ok"
    # Idle and EOS firings are real rate-0 firings, not skips.
    counts = eng.last_fire_counts
    assert counts["decode"] == counts["admission"] == counts["merge"] == counts["retire"]


def test_admission_timing_does_not_change_tokens(lm, requests, scfg, engine_tokens):
    _, _, cfg, model = lm
    eng = ActorEngine(cfg, model, scfg)
    got = eng.generate(requests, arrivals=np.array([0, 1, 2, 5, 9], np.int32))
    for want, have in zip(engine_tokens, got):
        np.testing.assert_array_equal(want, have.tokens)
    assert eng.last_latency_steps is not None and (eng.last_latency_steps >= 0).all()


def test_idle_steps_are_rate0_firings_in_fire_counts(lm, scfg):
    """An arrival gap leaves steps with no active slot: decode still fires
    (its control token consumed, its body skipped)."""
    _, _, cfg, model = lm
    reqs = [Request(prompt=np.array([3, 4, 5], np.int32), max_new=2),
            Request(prompt=np.array([6, 8, 9], np.int32), max_new=2)]
    eng = ActorEngine(cfg, model, scfg)
    got = eng.generate(reqs, arrivals=np.array([0, 6], np.int32))
    assert eng.last_fire_counts["decode"] > sum(len(r.tokens) for r in got)
    assert eng.last_fire_counts["retire"] == eng.last_fire_counts["decode"]


def test_no_request_starves_under_bursty_arrivals(lm, scfg):
    _, _, cfg, model = lm
    rng = np.random.default_rng(3)
    R = 7                                   # vs batch_size=2
    reqs = [Request(prompt=rng.integers(1, cfg.vocab, size=4).astype(np.int32), max_new=3)
            for _ in range(R)]
    eng = ActorEngine(cfg, model, scfg)
    got = eng.generate(reqs, arrivals=serving.poisson_trace(R, rate=1.5, seed=11))
    assert len(got) == R
    for r, res in zip(reqs, got):
        assert 1 <= len(res.tokens) <= r.max_new
    assert (eng.last_latency_steps >= 1).all()


def test_serving_bounds_all_balanced(lm, requests, scfg, ref):
    _, _, cfg, model = lm
    slab, lens = serving.left_pad_prompts([r.prompt for r in requests], scfg.max_prompt)
    wl = serving.ServingWorkload(
        prompts=slab, prompt_lens=lens,
        budgets=np.array([r.max_new for r in requests], np.int32),
        arrivals=np.zeros(len(requests), np.int32))
    net, report = serving.build_serving_network(
        cfg, model, wl, batch_size=scfg.batch_size, max_prompt=scfg.max_prompt,
        max_new=scfg.max_new, eos_id=scfg.eos_id, check_bounds=True, return_bounds=True)
    assert {c.fifo: c.verdict for c in report.channels} == {
        n: "balanced" for n in ("fb", "table", "x", "fin", "xa", "y", "fina",
                                "ctl_gate", "ctl_decode", "ctl_merge", "ctl_retire")}
    # The matched-rates proof marks the channels the reference's build marks.
    assert {n for n, s in net.fifos.items() if s.matched_rates} == ref["matched"]


def test_plans_and_families_the_engine_refuses(lm, scfg):
    _, _, cfg, model = lm
    # Megakernel mode runs (kernel B2's plain version on the CPU).
    eng = ActorEngine(cfg, model, scfg, plan=ExecutionPlan(mode="megakernel"))
    out = eng.generate([Request(np.array([1, 2], np.int32), 2)])
    assert out[0].status == "ok" and out[0].tokens.size == 2
    assert eng.last_program.plan.mode == "megakernel"
    with pytest.raises(ValueError, match="quiescence"):
        ActorEngine(cfg, model, scfg, plan=ExecutionPlan(mode="static", n_iterations=2))
    with pytest.raises(ValueError, match="guarded plan"):
        ActorEngine(cfg, model, scfg).generate(
            [Request(np.array([1, 2], np.int32), 2)], on_fault="quarantine")
    wcfg = smoke_config("whisper-small")
    with pytest.raises(ValueError, match="audio"):
        ActorEngine(wcfg, LM(wcfg, device="cpu", seed=0), scfg)
    assert Result(np.zeros(0, np.int32), 0).status == "ok"


# --------------------------------------------------------------------------- #
# Against the JAX ActorEngine on bench_serving.py's fast workload.
# --------------------------------------------------------------------------- #
@pytest.fixture(scope="module")
def port_bench(lm, bench):
    _, _, cfg, model = lm
    reqs, arrivals = bench
    eng = ActorEngine(cfg, model, ServeConfig(**BENCH))
    toks = eng.generate(reqs, arrivals=arrivals)
    engine = Engine(cfg, model, ServeConfig(**BENCH)).generate(reqs)
    return eng, [r.tokens.tolist() for r in toks], [r.tokens.tolist() for r in engine]


def test_bench_structure_equals_reference(ref, port_bench):
    eng, _, _ = port_bench
    want = ref["bench"]
    assert eng.last_sweeps == want["sweeps"] == 15
    assert eng.last_fire_counts == {k: int(v) for k, v in want["counts"].items()} \
        == {a: 14 for a in ("admission", "gate", "decode", "merge", "retire")}
    assert eng.last_latency_steps.tolist() == want["lat"] == [5, 0, 5, 5, 11, 4]
    assert eng.last_status == want["status"] == ["ok"] * BENCH_R


def test_bench_guarded_trace_equals_reference(lm, bench, ref):
    """High-water marks and every trace event of the guarded, traced run."""
    _, _, cfg, model = lm
    reqs, arrivals = bench
    eng = ActorEngine(cfg, model, ServeConfig(**BENCH), plan=ExecutionPlan(**GUARDED_TRACED))
    eng.generate(reqs, arrivals=arrivals)
    res = eng.last_program._last
    assert res.diagnostics.ok
    assert res.diagnostics.high_water == {k: int(v) for k, v in
                                          ref["traced"]["high_water"].items()}
    np.testing.assert_array_equal(eng.last_trace.events, ref["traced"]["events"])


def test_bench_tokens_equal_reference_where_engines_agree(ref, port_bench):
    _, actor, engine = port_bench
    assert actor == engine                          # the identity within the port
    agree = [i for i in range(BENCH_R) if engine[i] == ref["engine"][i]]
    assert agree, "the two frameworks' Engines agree on no request"
    for i in agree:
        assert actor[i] == ref["bench"]["tokens"][i], i


# --------------------------------------------------------------------------- #
# Resilience against the reference.
# --------------------------------------------------------------------------- #
def _stage(eng, bench):
    reqs, arrivals = bench
    return eng._stage(reqs, arrivals, None)[0]


def test_expire_deadline_retires_as_timeout_as_reference(lm, bench, ref, port_bench):
    _, _, cfg, model = lm
    reqs, arrivals = bench
    eng = ActorEngine(cfg, model, ServeConfig(**BENCH))
    dl = expire_deadline(_stage(eng, bench), 2).deadlines
    out = eng.generate(reqs, arrivals=arrivals, deadlines=dl)
    want = ref["expire"]
    assert eng.last_status == want["status"] and eng.last_status[2] == "timeout"
    assert eng.last_latency_steps.tolist() == want["lat"]
    assert eng.last_fire_counts == {k: int(v) for k, v in want["counts"].items()}
    assert eng.last_sweeps == want["sweeps"]
    assert out[2].tokens.size == 0
    for i in (0, 1, 3, 4, 5):
        assert out[i].tokens.tolist() == port_bench[1][i], i


def test_queue_depth_zero_sheds_as_reference(lm, bench, ref, port_bench):
    _, _, cfg, model = lm
    reqs, _ = bench
    eng = ActorEngine(cfg, model, ServeConfig(**BENCH), queue_depth=0)
    out = eng.generate(reqs)
    want = ref["shed"]
    # B 2: two shed records ride the fin rows of a firing, the rest wait.
    assert eng.last_status == want["status"] == ["ok", "ok", "shed", "shed", "ok", "shed"]
    assert eng.last_latency_steps.tolist() == want["lat"]
    assert eng.last_fire_counts == {k: int(v) for k, v in want["counts"].items()}
    assert eng.last_sweeps == want["sweeps"]
    for i, st in enumerate(eng.last_status):
        assert out[i].tokens.tolist() == (port_bench[1][i] if st == "ok" else []), i


def test_poison_request_faults_and_maps_as_reference(lm, bench, ref):
    """A guarded run flags DOMAIN on the same channels as the reference's,
    and ``faulted_requests`` names the same request."""
    _, _, cfg, model = lm
    eng = ActorEngine(cfg, model, ServeConfig(**BENCH))
    wl = poison_request(_stage(eng, bench), 3)
    net = serving.build_serving_network(cfg, model, wl, batch_size=2, max_prompt=8,
                                        max_new=6)
    with pytest.raises(NetworkFaultError) as ei:
        net.compile(ExecutionPlan(mode="dynamic", guards=True)).run()
    assert _ref_diag(ei.value) == ref["poison"]["domain"]
    assert "table" in ref["poison"]["domain"]
    assert serving.faulted_requests(net, ei.value, wl) == ref["poison"]["culprits"] == [3]


def test_quarantine_retires_the_poisoned_request_as_reference(lm, bench, ref, port_bench):
    _, _, cfg, model = lm
    reqs, arrivals = bench
    bad = list(reqs)
    bad[3] = Request(np.full(4, POISON_VALUE, np.int32), reqs[3].max_new)
    eng = ActorEngine(cfg, model, ServeConfig(**BENCH),
                      plan=ExecutionPlan(mode="dynamic", guards=True))
    out = eng.generate(bad, arrivals=arrivals, on_fault="quarantine")
    want = ref["quarantine"]
    assert eng.last_status == want["status"] and eng.last_status[3] == "fault"
    assert eng.last_retries == want["retries"] == 1
    assert out[3].tokens.size == 0
    for i in (0, 1, 2, 4, 5):
        assert out[i].tokens.tolist() == port_bench[1][i], i
    with pytest.raises(NetworkFaultError):
        eng.generate(bad, arrivals=arrivals, on_fault="quarantine", max_retries=0)


def test_injector_validation(lm, bench):
    _, _, cfg, model = lm
    wl = _stage(ActorEngine(cfg, model, ServeConfig(**BENCH)), bench)
    with pytest.raises(ValueError, match="out of range"):
        poison_request(wl, 99)
    with pytest.raises(ValueError, match="not a poison"):
        poison_request(wl, 0, value=3)
    with pytest.raises(ValueError, match="out of range"):
        expire_deadline(wl, -1)
    pw = poison_request(wl, 1)
    assert (pw.prompts[1] == POISON_VALUE).all()
    assert np.array_equal(np.delete(pw.prompts, 1, 0), np.delete(wl.prompts, 1, 0))
    ew = expire_deadline(wl, 2, at=5)
    assert wl.deadlines is None and int(ew.deadlines[2]) == 4
    assert (np.delete(ew.deadlines, 2) == serving.NO_DEADLINE).all()


# --------------------------------------------------------------------------- #
# Megakernel mode against the JAX ActorEngine in megakernel mode.
# --------------------------------------------------------------------------- #
def test_bench_structure_equals_reference_in_megakernel_mode(lm, bench, ref, port_bench):
    """Sweeps, fire counts, latency steps and statuses of the bench workload
    equal the reference megakernel's exactly, and the tokens the port's
    dynamic mode gives."""
    _, _, cfg, model = lm
    reqs, arrivals = bench
    eng = ActorEngine(cfg, model, ServeConfig(**BENCH), plan=ExecutionPlan(mode="megakernel"))
    toks = eng.generate(reqs, arrivals=arrivals)
    want = ref["bench_mk"]
    assert eng.last_sweeps == want["sweeps"] == ref["bench"]["sweeps"]
    assert eng.last_fire_counts == {k: int(v) for k, v in want["counts"].items()}
    assert eng.last_latency_steps.tolist() == want["lat"]
    assert eng.last_status == want["status"]
    assert [r.tokens.tolist() for r in toks] == port_bench[1]


@pytest.mark.parametrize("cores", [1, 2])
def test_bench_guarded_trace_equals_reference_in_megakernel_mode(lm, bench, ref, cores):
    """High-water marks and every trace event of the guarded, traced run in
    megakernel mode (the decode step's attempt recorded once, before its
    yield) equal the reference megakernel's, at one core and two."""
    _, _, cfg, model = lm
    reqs, arrivals = bench
    eng = ActorEngine(cfg, model, ServeConfig(**BENCH), plan=ExecutionPlan(
        mode="megakernel", guards=True, trace=True, cores=cores))
    eng.generate(reqs, arrivals=arrivals)
    res = eng.last_program._last
    assert res.diagnostics.ok
    want = ref["traced_mk"]
    assert res.diagnostics.high_water == {k: int(v) for k, v in want["high_water"].items()}
    np.testing.assert_array_equal(eng.last_trace.events, want["events"])
    np.testing.assert_array_equal(want["events"], ref["traced"]["events"])


@pytest.mark.parametrize("case", ["expire", "shed", "quarantine"])
def test_resilience_in_megakernel_mode_as_reference(lm, bench, ref, port_bench, case):
    """The reference's chaos matrix in megakernel mode (unspecialized, as
    ``tests/test_resilience.py`` runs it): an expired deadline retires as a
    timeout, ``queue_depth=0`` sheds, a poisoned request is quarantined after
    one retry; statuses (and latency steps, fire counts and sweeps) equal
    the reference megakernel's, survivors keep their tokens."""
    _, _, cfg, model = lm
    reqs, arrivals = bench
    plan = ExecutionPlan(**MK_PLAN, guards=case == "quarantine")
    eng = ActorEngine(cfg, model, ServeConfig(**BENCH), plan=plan,
                      queue_depth=0 if case == "shed" else None)
    want = ref[f"{case}_mk"]
    if case == "quarantine":
        bad = list(reqs)
        bad[3] = Request(np.full(4, POISON_VALUE, np.int32), reqs[3].max_new)
        out = eng.generate(bad, arrivals=arrivals, on_fault="quarantine")
        assert (eng.last_status, eng.last_retries) == (want["status"], want["retries"]) \
            == (ref["quarantine"]["status"], 1)
        keep = [i for i in range(BENCH_R) if i != 3]
    else:
        kw = dict(arrivals=arrivals, deadlines=expire_deadline(_stage(eng, bench), 2).deadlines) \
            if case == "expire" else {}
        out = eng.generate(reqs, **kw)
        assert eng.last_status == want["status"] == ref[case]["status"]
        assert eng.last_latency_steps.tolist() == want["lat"]
        assert eng.last_fire_counts == {k: int(v) for k, v in want["counts"].items()}
        assert eng.last_sweeps == want["sweeps"]
        keep = [i for i, st in enumerate(eng.last_status) if st == "ok"]
    assert all(out[i].tokens.tolist() == port_bench[1][i] for i in keep)
    assert all(out[i].tokens.size == 0 for i in range(BENCH_R) if i not in keep)


# --------------------------------------------------------------------------- #
# The helpers and the channel declaration.
# --------------------------------------------------------------------------- #
def test_left_pad_and_poisson_trace_equal_reference():
    rng = np.random.default_rng(4)
    prompts = [rng.integers(0, 50, n).astype(np.int32) for n in (3, 9, 1, 6)]
    for P in (4, 8):
        want = ref_serving.left_pad_prompts(prompts, P)
        got = serving.left_pad_prompts(prompts, P)
        for w, g in zip(want, got):
            assert g.dtype == w.dtype
            np.testing.assert_array_equal(g, w)
    for n, rate, seed in ((6, 2.0, 7), (8, 0.25, 7), (20, 1.5, 11)):
        want = ref_serving.poisson_trace(n, rate, seed)
        got = serving.poisson_trace(n, rate, seed)
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)
    assert (serving.NO_DEADLINE, serving.SLOT_DOMAIN, serving.HEADER) == \
        (ref_serving.NO_DEADLINE, ref_serving.SLOT_DOMAIN, ref_serving.HEADER)


@pytest.mark.parametrize("arch,overrides", [
    ("granite-8b", {}), ("granite-8b", {"kv_quant_int8": True}),
    ("recurrentgemma-2b", {}), ("mamba2-780m", {}), ("internvl2-1b", {}),
    ("olmoe-1b-7b", {})])
def test_cache_template_equals_prefill_caches(arch, overrides):
    cfg = dataclasses.replace(smoke_config(arch), **overrides)
    model = LM(cfg, device="cpu", seed=0)
    B, P, N = 3, 8, 6
    template, axes = serving.cache_template(model, B, P + N)
    toks = torch.from_numpy(np.random.default_rng(0).integers(0, cfg.vocab, (B, P)))
    _, caches = model.prefill(toks, max_cache_len=P + N)
    want, got = list(tree_leaves(caches)), list(tree_leaves(template))
    assert len(got) == len(want) == len(axes)
    for w, g, ax in zip(want, got, axes):
        assert g.is_meta and tuple(g.shape) == tuple(w.shape) and g.dtype == w.dtype
        assert g.shape[ax] == B


@pytest.mark.parametrize("arch", ["internvl2-1b", "olmoe-1b-7b"])
def test_vision_serves_as_text_and_moe_retires_every_request(arch):
    """A vision model serves as text with the Engine's tokens; an MoE model
    runs (rows couple through expert capacity, so no token identity)."""
    cfg, model, _ = _port_model(arch)
    rng = np.random.default_rng(2)
    reqs = [Request(rng.integers(1, cfg.vocab, int(n)).astype(np.int32), m)
            for n, m in ((5, 3), (7, 1), (4, 3))]
    scfg = ServeConfig(batch_size=2, max_prompt=8, max_new=3)
    eng = ActorEngine(cfg, model, scfg)
    got = eng.generate(reqs, arrivals=np.array([0, 0, 2], np.int32))
    assert eng.last_status == ["ok"] * 3
    assert [len(r.tokens) for r in got] == [3, 1, 3]
    if cfg.moe is None:
        want = Engine(cfg, model, scfg).generate(reqs)
        for w, g in zip(want, got):
            np.testing.assert_array_equal(w.tokens, g.tokens)


def test_row_id_col_validates_as_reference():
    from repro.core.fifo import FifoSpec as RefFifoSpec
    for shape, col in (((4,), 0), ((2, 5), 5), ((2, 5), -1)):
        with pytest.raises(ValueError) as want:
            RefFifoSpec("f", 1, shape, row_id_col=col)
        with pytest.raises(ValueError) as got:
            FifoSpec("f", 1, shape, row_id_col=col)
        assert str(got.value) == str(want.value)
    assert FifoSpec("f", 1, (2, 5), row_id_col=4).row_id_col == 4

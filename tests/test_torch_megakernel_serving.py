"""The LM actors in megakernel mode on the CPU: kernel B2's serving bodies
(admission, gate, merge, retire) and its yield at step firings, through
B2's plain version (``core/megakernel/ref.py``).

* Each plain body equals its actor's own ``fire`` in ``graphs/serving.py``
  bit for bit (all int32) on seeded numpy slot tables: finished, expired,
  shed, timed-out and overflowing rows, EOS and budget ends, R > B.
* The yield protocol: a run cut at every yield (the io words and tensors
  copied and the run continued from the copies) equals the uninterrupted
  run and the host dynamic run; the scheduler's command lists replay in
  every order the kernel's dependency waits permit; the LM stage network
  stops once a stage firing.
* What the program packs: kind codes, the slot table's columns, admission's
  ready limit, scalar and taken words, the extended instance, and the
  refusals (bf16 channels beside a body that computes, serving parameters
  that do not fit their channels); any actor runs as a step.  The guarded
  build on bf16 channels is in ``tests/test_torch_megakernel_half_guards.py``.

Structure against the JAX package's megakernel (sweeps, fire counts,
latency steps, statuses, high-water marks, trace events) is in
``tests/test_torch_serving_actors.py``.
"""
from __future__ import annotations

import dataclasses
import random

import numpy as np
import pytest
import torch

from repro_torch.configs import smoke_config
from repro_torch.core import Network
from repro_torch.core.executor import run_dynamic
from repro_torch.core.megakernel import compile_megakernel, lower_network, partition_layout
from repro_torch.core.megakernel.kernel import run_step
from repro_torch.core.megakernel.program import (A_AUX, A_READY, ACTOR_FIELDS, H_ACTOR_OFF,
                                                 H_MOE, H_SCRATCH, KIND_CODES, SLOT_HEADER,
                                                 Y_PENDING, stage, unstage)
from repro_torch.core.megakernel.ref import (C_ACTIVE, C_AGE, C_BUDGET, C_DEADLINE, C_FIN,
                                             C_LAST, C_LAT, C_NEW, C_POS, C_PROD, C_REQ,
                                             C_STATUS, execute, hazard_waits,
                                             permitted_order, run_program, schedule,
                                             serving_admission, serving_merge,
                                             serving_retire, zero_forwarded)
from repro_torch.graphs import serving
from repro_torch.graphs.factories import states_equal
from repro_torch.graphs.lm_pipeline import build_lm_stage_network
from repro_torch.models import LM
from repro_torch.serve import ActorEngine, Request, ServeConfig

CPU = torch.device("cpu")


@pytest.fixture(scope="module")
def lm():
    cfg = smoke_config("granite-8b")
    return cfg, LM(cfg, device="cpu", seed=0)


def _workload(rng, R, P, N, deadlines=True):
    prompts = rng.integers(-3, 50, (R, P)).astype(np.int32)
    return serving.ServingWorkload(
        prompts=prompts, prompt_lens=np.full(R, P, np.int32),
        budgets=rng.integers(1, N + 1, R).astype(np.int32),
        arrivals=np.sort(rng.integers(0, 6, R)).astype(np.int32),
        deadlines=rng.integers(-1, 12, R).astype(np.int32) if deadlines else None)


def _slot_table(rng, B, P, N, R, t):
    """B slots in every state admission meets: empty, active (some past
    their deadline), finished last step (EOS or budget)."""
    W = SLOT_HEADER + P + N
    tbl = np.zeros((B, W), np.int32)
    for b in range(B):
        kind = rng.integers(0, 4)
        if kind == 0:
            continue
        tbl[b, C_ACTIVE] = 1 if kind < 3 else 0
        tbl[b, C_REQ] = rng.integers(0, R)
        tbl[b, C_PROD] = rng.integers(0, N)
        tbl[b, C_POS] = P - 1 + tbl[b, C_PROD]
        tbl[b, C_BUDGET] = rng.integers(1, N + 1)
        tbl[b, C_FIN] = int(kind == 3)
        tbl[b, C_LAST] = rng.integers(0, 50)
        tbl[b, C_LAT] = rng.integers(0, 9) if kind == 3 else 0
        tbl[b, C_DEADLINE] = rng.integers(t - 3, t + 4) if kind == 2 else serving.NO_DEADLINE
        tbl[b, C_AGE] = rng.integers(0, 5)
        tbl[b, SLOT_HEADER:] = rng.integers(0, 50, P + N)
    return tbl


CASES = [(seed, B, R) for seed in range(6) for B, R in ((2, 6), (3, 9), (4, 3))]


@pytest.mark.parametrize("seed,B,R", CASES)
def test_admission_body_equals_its_fire(lm, seed, B, R):
    """Freed, admitted, shed (queue depth 0..2 or unbounded), timed out
    waiting and in flight, at most B - n_fin records riding the rows that
    did not finish: table, finished rows, control token and taken flags."""
    cfg, model = lm
    rng = np.random.default_rng(seed)
    P, N = 4, 5
    wl = _workload(rng, R, P, N)
    qd = [0, 1, 2, None][seed % 4]
    net = serving.build_serving_network(cfg, model, wl, batch_size=B, max_prompt=P,
                                        max_new=N, queue_depth=qd, check_bounds=False)
    fire = net.actors["admission"].fire
    for step in range(4):
        t = int(rng.integers(0, 8))
        retired = int(rng.integers(0, R))
        taken = rng.integers(0, 2, R).astype(np.int32)
        fb = _slot_table(rng, B, P, N, R, t)
        (taken2, t2, retired2), outs = fire(
            (torch.from_numpy(taken), t, retired), {"fb": torch.from_numpy(fb)[None]},
            {"fb": 1})
        tbl, fins, ctl, want_taken = serving_admission(
            fb.tolist(), taken.tolist(), t, wl.prompts.tolist(), wl.budgets.tolist(),
            wl.arrivals.tolist(), (wl.deadlines.tolist()), P, N, B + R if qd is None else qd)
        assert outs["table"].tolist() == outs["x"].tolist() == tbl, step
        assert outs["fin"].tolist() == fins, step
        assert outs["c_gate"].tolist() == ctl, step
        assert taken2.tolist() == want_taken, step
        assert (t2, retired2) == (t + 1, retired + ctl[1]), step


@pytest.mark.parametrize("seed", range(8))
def test_merge_body_equals_its_fire(lm, seed):
    """EOS and budget ends, inactive rows with a stale token, rows at
    their last generated column."""
    cfg, model = lm
    rng = np.random.default_rng(100 + seed)
    B, P, N, R = 3, 4, 5, 6
    eos = [None, 7, 0][seed % 3]
    net = serving.build_serving_network(cfg, model, _workload(rng, R, P, N, deadlines=False),
                                        batch_size=B, max_prompt=P, max_new=N,
                                        eos_id=eos, check_bounds=False)
    fire = net.actors["merge"].fire
    tbl = _slot_table(rng, B, P, N, R, 3)
    tbl[:, C_PROD] = rng.integers(0, N + 1, B)
    y = rng.integers(0, 10, B).astype(np.int32)
    _, outs = fire((), {"table": torch.from_numpy(tbl)[None], "y": torch.from_numpy(y)[None]},
                   {"table": 1, "y": 1, "fb": 1})
    want = serving_merge(tbl.tolist(), y.tolist(), -1 if eos is None else eos, P, N)
    assert outs["fb"].tolist() == want


@pytest.mark.parametrize("seed", range(6))
def test_retire_body_equals_its_fire(lm, seed):
    cfg, model = lm
    rng = np.random.default_rng(200 + seed)
    B, P, N, R = 4, 3, 4, 7
    net = serving.build_serving_network(cfg, model, _workload(rng, R, P, N, deadlines=False),
                                        batch_size=B, max_prompt=P, max_new=N,
                                        check_bounds=False)
    spec = net.actors["retire"]
    st = tuple(t + int(rng.integers(0, 3)) for t in spec.init())
    rows = _slot_table(rng, B, P, N, R, 3)
    rows[:, C_REQ] = rng.permutation(R)[:B]
    got, _ = spec.fire(st, {"fin": torch.from_numpy(rows)[None]}, {"fin": 1})
    want = [t.clone() for t in st]
    for req, toks, n, lat, status in serving_retire(rows.tolist(), R, P):
        want[0][req] = torch.tensor(toks)
        for buf, v in zip(want[1:], (n, lat, status, 1)):
            buf[req] = v
    for g, w in zip(got, want):
        assert torch.equal(g, w)


def test_slot_table_layout_is_the_serving_networks():
    assert (SLOT_HEADER, C_ACTIVE, C_REQ, C_POS, C_PROD, C_BUDGET, C_FIN, C_LAST, C_NEW,
            C_LAT, C_STATUS, C_DEADLINE, C_AGE) == (
        serving.HEADER, serving.C_ACTIVE, serving.C_REQ, serving.C_POS, serving.C_PROD,
        serving.C_BUDGET, serving.C_FIN, serving.C_LAST, serving.C_NEW, serving.C_LAT,
        serving.C_STATUS, serving.C_DEADLINE, serving.C_AGE)


# --------------------------------------------------------------------------- #
# The network, the yield and the command lists.
# --------------------------------------------------------------------------- #
def _requests(cfg, n=6, seed=9):
    rng = np.random.default_rng(seed)
    return [Request(rng.integers(1, cfg.vocab, size=7 - (i % 3)).astype(np.int32),
                    6 if i % 2 == 0 else 1) for i in range(n)]


NETS = {
    "bench": dict(arrivals=serving.poisson_trace(6, 2.0, seed=7)),
    "shed": dict(queue_depth=0),
    "burst": dict(n=9, batch_size=3, eos_id=5, arrivals=serving.poisson_trace(9, 1.5, seed=11)),
}


def _net(lm, case):
    cfg, model = lm
    kw = dict(NETS[case])
    reqs = _requests(cfg, kw.pop("n", 6))
    scfg = ServeConfig(batch_size=kw.pop("batch_size", 2), max_prompt=8, max_new=6,
                       eos_id=kw.pop("eos_id", None))
    return ActorEngine(cfg, model, scfg, queue_depth=kw.pop("queue_depth", None)) \
        .build_network(reqs, **kw)


def test_serving_program_packs_the_network(lm):
    net = _net(lm, "burst")
    runner = compile_megakernel(net)
    prog = runner.device_program
    kinds = {n: s.kind for n, s in zip(prog.actor_names, prog.slots)}
    assert kinds == {"admission": "admission", "gate": "gate", "decode": "step",
                     "merge": "merge", "retire": "retire"}
    t = prog.table.tolist()
    adm = t[t[H_ACTOR_OFF]:][:ACTOR_FIELDS]
    assert adm[0] == KIND_CODES["admission"] and adm[A_READY] == 9
    assert t[H_MOE] == 1 and t[H_SCRATCH] == 2 * 3
    sl = prog.slots[0]
    assert sl.scalar == 0 and sl.words == adm[A_AUX] == 4 * 2 * 3  # after 4 rings
    state = net.init_state()
    state.actors[0] = (torch.arange(9, dtype=torch.int32) % 2, 5, 4)
    tensors, io = stage(prog, state, CPU, [c for _, c in prog.consts])
    assert io[prog.io_scalars:prog.io_scalars + 2] == [4, 5]
    assert io[prog.io_ctrl + sl.words:prog.io_ctrl + sl.words + 9] == [0, 1] * 4 + [0]
    unstage(prog, state, io)
    assert state.actors[0][0].tolist() == [0, 1] * 4 + [0] and state.actors[0][1:] == (5, 4)


def _drive(net, cores=1, specialize=True, cut=False):
    """B2's plain version over the whole run, a launch a segment as the
    runner drives it; with ``cut`` each segment starts from copies of the io
    words and tensors the last one left.  Returns (state, counts, sweeps,
    segments)."""
    layout = lower_network(net)
    part = partition_layout(net, layout, cores, forward_transients=specialize)
    prog = compile_megakernel(net, layout=layout, partition=part).device_program
    table = prog.table.tolist()
    state = net.init_state()
    tensors, io = stage(prog, state, CPU, [c for _, c in prog.consts])
    segments = 0
    while True:
        run_program(table, tensors, io, 1_000_000, True)
        segments += 1
        if not io[prog.io_yield + Y_PENDING]:
            break
        if cut:
            io = list(io)
            tensors = [None if x is None else x.clone() for x in tensors]
            for i, f in enumerate(state.fifos):
                if tensors[i] is not None:
                    f.buf = tensors[i]
            for j, sl in enumerate(prog.slots):
                if sl.kind == "retire":
                    st = tuple(x.clone() for x in state.actors[j])
                    state.actors[j] = st
                    for slot, x in zip(sl.ptrs, st):
                        tensors[prog.n_fifos + slot] = x
        run_step(net, prog, table, state, tensors, io)
    counts, sweeps, _ = unstage(prog, state, io)
    return state, counts, sweeps, segments


@pytest.mark.parametrize("cut", [False, True])
@pytest.mark.parametrize("cores,specialize", [(1, True), (1, False), (2, True)])
@pytest.mark.parametrize("case", sorted(NETS))
def test_run_cut_at_every_yield_equals_dynamic(lm, case, cores, specialize, cut):
    """A segment per decode firing that runs the model, plus one; cut or
    not, the state, fire counts and sweeps equal the host dynamic run's
    (every ring, cursor, control token and decode cache)."""
    net = _net(lm, case)
    steps = [0]
    model = lm[1]
    step = model.decode_step

    def counted(*a, **kw):
        steps[0] += 1
        return step(*a, **kw)
    model.decode_step = counted
    try:
        state, counts, sweeps, segments = _drive(net, cores, specialize, cut)
        n_steps, steps[0] = steps[0], 0
        dyn = run_dynamic(net, net.init_state(), 1_000_000, True)
    finally:
        del model.decode_step
    assert segments == n_steps + 1 == steps[0] + 1
    assert (counts, sweeps) == (dyn[1], dyn[2])
    assert states_equal(state, dyn[0])


@pytest.mark.parametrize("seed", range(4))
@pytest.mark.parametrize("case", sorted(NETS))
def test_permitted_orders_over_the_serving_program(lm, case, seed):
    """Each segment's commands run in a random order the kernel's waits
    permit (where the scheduler waits for admission's body, the commands
    up to it first, in such an order): the state equals the host dynamic
    run's."""
    net = _net(lm, case)
    prog = compile_megakernel(net).device_program
    table = prog.table.tolist()
    state = net.init_state()
    tensors, io = stage(prog, state, CPU, [c for _, c in prog.consts])
    zero_forwarded(table, tensors)
    rng = random.Random(seed)
    ran = [0]                # every command up to it has run
    reordered = [0]

    def run_upto(commands, upto):
        hazard_waits(commands)
        todo = [c for c in commands if ran[0] < c.seq <= upto]
        if not todo:
            return
        order = permitted_order(todo, rng, done_before=ran[0])
        reordered[0] += [c.seq for c in order] != [c.seq for c in todo]
        execute(table, tensors, order, None, io)
        ran[0] = max(c.last for c in todo)

    while True:
        commands = schedule(table, tensors, io, 1_000_000, True, flush=run_upto)
        if commands:
            run_upto(commands, commands[-1].last)
        if not io[prog.io_yield + Y_PENDING]:
            break
        run_step(net, prog, table, state, tensors, io)
    counts, sweeps, _ = unstage(prog, state, io)
    dyn = net.compile(mode="dynamic").run()
    assert (counts, sweeps) == (dyn.fire_counts, dyn.sweeps)
    assert states_equal(state, dyn.state)
    assert reordered[0] > 0


def test_lm_stage_network_stops_once_a_stage_firing():
    cfg = smoke_config("mamba2-780m")
    model = LM(cfg, device="cpu", seed=0)
    tokens = torch.from_numpy(np.random.default_rng(0).integers(0, cfg.vocab, (3, 8)))
    net = build_lm_stage_network(model, cfg, tokens, 2)
    state, counts, _, segments = _drive(net)
    assert segments == 2 * 3 + 1
    static = net.compile(mode="static", n_iterations=3)
    assert torch.equal(state.actor("sink")[0], static.collect("sink", static.run().state))
    assert counts == {"source": 3, "stage0": 3, "stage1": 3, "sink": 3}


def test_megakernel_refusals_on_step_and_half_channels(lm):
    cfg = smoke_config("mamba2-780m")
    model = LM(cfg, device="cpu", seed=0)
    tokens = torch.zeros((2, 8), dtype=torch.int64)
    net = build_lm_stage_network(model, cfg, tokens, 2)
    assert next(iter(net.fifos.values())).dtype == torch.bfloat16
    # A bf16 channel into a body that computes is refused.
    actors = dict(net.actors)
    actors["stage0"] = dataclasses.replace(actors["stage0"],
                                           device_op=type(actors["stage0"].device_op)("adder",
                                                                                      {"terms": ["in"]}))
    bad = Network(list(actors.values()), list(net.fifos.values()), list(net.edges),
                  device="cpu")
    with pytest.raises(NotImplementedError, match="only copy bodies"):
        bad.compile(mode="megakernel")
    # A serving body whose parameters do not fit its channels is refused.
    snet = _net(lm, "bench")
    actors = dict(snet.actors)
    op = actors["admission"].device_op
    actors["admission"] = dataclasses.replace(
        actors["admission"], device_op=type(op)("admission", {**op.params, "B": 3}))
    with pytest.raises(ValueError, match="do not fit"):
        Network(list(actors.values()), list(snet.fifos.values()), list(snet.edges),
                initial_tokens=snet.initial_tokens, device="cpu").compile(mode="megakernel")


def test_any_actor_runs_as_a_step(lm):
    """A step is the actor's own fire between launches: merge declared a
    step instead of its body gives the host dynamic run's state."""
    snet = _net(lm, "burst")
    actors = dict(snet.actors)
    actors["merge"] = dataclasses.replace(actors["merge"],
                                          device_op=actors["decode"].device_op)
    net = Network(list(actors.values()), list(snet.fifos.values()), list(snet.edges),
                  initial_tokens=snet.initial_tokens, device="cpu")
    mk = net.compile(mode="megakernel", specialize=False).run()
    dyn = net.compile(mode="dynamic").run()
    assert (mk.fire_counts, mk.sweeps) == (dyn.fire_counts, dyn.sweeps)
    assert states_equal(mk.state, dyn.state)


@pytest.mark.parametrize("cores", [1, 2])
def test_guarded_traced_serving_equals_dynamic(lm, cores):
    """Guards and trace across the yields: fault words, high-water marks and
    every trace event (the decode step's attempt once) equal the host
    dynamic run's."""
    net = _net(lm, "burst")
    kw = dict(guards=True, trace=True)
    dyn = net.compile(mode="dynamic", **kw).run()
    mk = net.compile(mode="megakernel", cores=cores, specialize=False, **kw).run()
    assert (mk.fire_counts, mk.sweeps) == (dyn.fire_counts, dyn.sweeps)
    assert mk.diagnostics.ok and mk.diagnostics.high_water == dyn.diagnostics.high_water
    np.testing.assert_array_equal(mk.trace.events, dyn.trace.events)
    assert states_equal(mk.state, dyn.state)


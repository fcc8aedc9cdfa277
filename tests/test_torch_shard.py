"""The multi-device runtime on the port (``core/shard.py``,
``ExecutionPlan(devices=k)``) against the JAX package's (``src/repro/core/
shard.py``), on the CPU.

* The reference's validation tests (``tests/test_shard.py``) in one
  process: field checks, every cross-field rule, and the mode x guards x
  trace x cores x devices matrix, one case a test.  Without a process
  group a sharded plan is refused naming ``init_process_group`` (the
  reference names ``XLA_FLAGS``).
* Sharded runs in gloo groups of 2 and 4 spawned processes
  (``repro_torch.launch.group.spawn_group``: a ``file://`` rendezvous
  under ``tmp_path`` and a deadline that kills the group): DPD and MoE at
  devices 1, 2 and 4 bit-identical to the port's own ``devices=1`` run on
  every rank, with fire counts, rounds, collective bytes and device
  partitions exactly the reference's; guards, trace, ``device_assign``,
  ``run_checkpointed`` killed after a segment and resumed in a fresh
  group; the ``ActorEngine`` at devices 2.
* The reference's readings come from one child process of the unchanged
  JAX package with ``XLA_FLAGS=--xla_force_host_platform_device_count=4``
  and the ``jax.core.Literal`` alias (ROADMAP C1), set in the child only.
  It runs while the port's groups run.

This module imports neither jax nor the JAX package at import time: the
ranks import it to find their bodies.
"""
from __future__ import annotations

import itertools
import os
import pickle
import subprocess
import sys

import numpy as np
import pytest
import torch

from repro_torch.convert import state_to_numpy
from repro_torch.core import ExecutionPlan, Program, Trace, merge_device_traces
from repro_torch.graphs.factories import make_dpd, make_motion_detection
from repro_torch.launch.group import GroupError, spawn_group

REPO_SRC = os.path.join(os.path.dirname(__file__), "..", "src")
#: The reference's make_dpd(n_firings=6) and make_moe(n_firings=3,
#: n_tokens=16, d_model=32).  The port's make_dpd stages the reference's
#: signal exactly; its MoE network is built on the reference's weights and
#: token stream (``moe_inputs``), which jax.random draws.
GRAPHS = {"dpd": dict(n_firings=6), "moe": dict(n_firings=3, n_tokens=16, d_model=32)}
MOE = dict(n_experts=4, top_k=2, d_ff=64, capacity_factor=2.0)
#: granite-8b's smoke config through the ActorEngine: the reference's
#: test_sharded_serving_tokens_identical workload.
SERVE = dict(batch_size=2, max_prompt=8, max_new=4, eos_id=7)
SERVE_SHAPES = [(5, 4), (3, 2), (7, 4), (4, 3), (6, 4)]
GROUP_TIMEOUT = 240


def _spawn(name, world, tmp, *args):
    return spawn_group(f"test_torch_shard:{name}", world, str(tmp), args=args,
                       timeout=GROUP_TIMEOUT, threads=1)


# --------------------------------------------------------------------------- #
# The reference's readings (a child process of the JAX package).
# --------------------------------------------------------------------------- #
_REF_CHILD = r"""
import os, pickle, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
import jax
if not hasattr(jax.core, "Literal"):
    from jax.extend.core import Literal
    jax.core.Literal = Literal
import jax.numpy as jnp
import numpy as np
from repro.configs import smoke_config
from repro.core import ExecutionPlan
from repro.graphs.factories import make_dpd, make_moe
from repro.models import decode_step, init_params, prefill
from repro.serve import ActorEngine, Engine, Request, ServeConfig

graphs, serve, shapes, path = pickle.load(open(sys.argv[1], "rb"))
out = {}
for label, kw in graphs.items():
    net, _ = (make_dpd if label == "dpd" else make_moe)(**kw)
    for k in (1, 2, 4):
        prog = net.compile(ExecutionPlan(mode="dynamic", devices=k))
        r = prog.run()
        st = prog.stats()
        out[(label, k)] = dict(
            rounds=int(r.sweeps), counts={n: int(v) for n, v in r.fire_counts.items()},
            coll=st.collective_bytes_per_sweep, parts=st.device_partition_actors,
            leaves=[np.asarray(x) for x in jax.tree.leaves(r.state)] if k == 1 else None)
    r = net.compile(ExecutionPlan(mode="dynamic", devices=2, guards=True,
                                  trace=True)).run()
    out[(label, "trace")] = dict(ok=r.diagnostics.ok, fired=r.trace.firing_counts())
    if label == "dpd":
        names = list(net.actors)
        cut = {n: (0 if i < len(names) // 2 else 1) for i, n in enumerate(names)}
        prog = net.compile(ExecutionPlan(mode="dynamic", devices=2, device_assign=cut))
        prog.run()
        out["assign"] = dict(cut=cut, parts=prog.stats().device_partition_actors)

cfg = smoke_config("granite-8b")
params = init_params(jax.random.PRNGKey(0), cfg)
rng = np.random.default_rng(1)
reqs = [Request(prompt=rng.integers(1, cfg.vocab, size=n).astype(np.int32), max_new=m)
        for n, m in shapes]
scfg = ServeConfig(**serve)
eng = ActorEngine(cfg, params, scfg, plan=ExecutionPlan(mode="dynamic", devices=2))
got = eng.generate(reqs)
# The fixed-batch Engine's greedy trajectory per batch, with its logits, for
# the margin rule (ROADMAP C3).
B, P, N = serve["batch_size"], serve["max_prompt"], serve["max_new"]
traj = []
for lo in range(0, len(reqs), B):
    group = reqs[lo:lo + B]
    toks = np.zeros((B, P), np.int32)
    for i, r in enumerate(group):
        toks[i, P - len(r.prompt):] = r.prompt
    logits, caches = prefill(params, cfg, {"tokens": jnp.asarray(toks)},
                             max_cache_len=P + N)
    steps = []
    for step in range(N):
        lg = np.asarray(logits, np.float32)
        nxt = lg.argmax(-1).astype(np.int32)
        steps.append((lg, nxt))
        if step < N - 1:
            pos = np.full((B,), P + step, np.int32)
            logits, caches = decode_step(params, cfg, jnp.asarray(nxt[:, None]),
                                         jnp.asarray(pos), caches)
    traj.append((toks, steps))
out["serve"] = dict(
    prompts=[r.prompt for r in reqs], tokens=[r.tokens.tolist() for r in got],
    engine=[r.tokens.tolist() for r in Engine(cfg, params, scfg).generate(reqs)],
    coll=eng.last_collective_bytes_per_sweep,
    counts={n: int(v) for n, v in eng.last_fire_counts.items()},
    traj=traj)
pickle.dump(out, open(path, "wb"))
"""


class _RefChild:
    """The reference child, started when the module's fixture is first
    asked for and joined when its readings are."""

    def __init__(self, tmp):
        self.path = os.path.join(tmp, "ref.pkl")
        args = os.path.join(tmp, "ref_args.pkl")
        with open(args, "wb") as f:
            pickle.dump((GRAPHS, SERVE, SERVE_SHAPES, self.path), f)
        env = dict(os.environ, PYTHONPATH=os.path.abspath(REPO_SRC), JAX_PLATFORMS="cpu")
        env.pop("XLA_FLAGS", None)
        self.log = open(os.path.join(tmp, "ref.log"), "wb")
        self.proc = subprocess.Popen([sys.executable, "-c", _REF_CHILD, args],
                                     stdout=self.log, stderr=subprocess.STDOUT, env=env)
        self._out = None

    def readings(self):
        if self._out is None:
            try:
                code = self.proc.wait(timeout=600)
            finally:
                if self.proc.poll() is None:
                    self.proc.kill()
                    self.proc.wait()
                self.log.close()
            with open(self.log.name, "rb") as f:
                assert code == 0, f.read().decode(errors="replace")[-4000:]
            with open(self.path, "rb") as f:
                self._out = pickle.load(f)
        return self._out


@pytest.fixture(scope="module")
def ref_child(tmp_path_factory):
    child = _RefChild(str(tmp_path_factory.mktemp("shard_ref")))
    yield child
    if child.proc.poll() is None:
        child.proc.kill()
        child.proc.wait()


@pytest.fixture(scope="module")
def ref(ref_child, k2, k4, k2_serve):
    # Asking for the groups first lets them run while the reference child
    # computes.
    return ref_child.readings()


# --------------------------------------------------------------------------- #
# Rank bodies (run in the spawned processes).
# --------------------------------------------------------------------------- #
def _record(res, prog):
    return dict(leaves=state_to_numpy(res.state), counts=dict(res.fire_counts),
                rounds=res.sweeps, stats=prog.stats().to_json(),
                diag_ok=None if res.diagnostics is None else res.diagnostics.ok)


def _graph(label, moe_inputs=None):
    if label == "dpd":
        return make_dpd(device="cpu", **GRAPHS["dpd"])[0]
    from repro_torch.convert import tensor_from_numpy
    from repro_torch.graphs.moe_as_actors import build_moe_network
    params, xs = moe_inputs
    kw = GRAPHS["moe"]
    return build_moe_network({k: tensor_from_numpy(v) for k, v in params.items()},
                             kw["n_tokens"], kw["d_model"], MOE["top_k"],
                             MOE["capacity_factor"], kw["n_firings"],
                             tensor_from_numpy(xs), device="cpu")


def body_main(rank, world, ckpt_dir, moe_inputs):
    """Everything one group of ``world`` ranks checks."""
    out = {}
    for label in GRAPHS:
        net = _graph(label, moe_inputs)
        prog = net.compile(ExecutionPlan(mode="dynamic", devices=world))
        out[label] = _record(prog.run(), prog)
        if world != 2:
            continue
        prog = net.compile(ExecutionPlan(mode="dynamic", devices=2, guards=True,
                                         trace=True))
        res = prog.run()
        t = res.trace
        out[label + "_trace"] = dict(
            _record(res, prog), fired=t.firing_counts(), dropped=t.dropped,
            sweeps=t.events[:, 1].copy(), cores=t.actor_cores)
    if world != 2:
        return out
    net = _graph("dpd")
    names = list(net.actors)
    cut = {n: (0 if i < len(names) // 2 else 1) for i, n in enumerate(names)}
    prog = net.compile(ExecutionPlan(mode="dynamic", devices=2, device_assign=cut))
    out["assign"] = _record(prog.run(), prog)
    try:
        net.compile(ExecutionPlan(mode="dynamic", devices=4))
        out["too_many"] = None
    except RuntimeError as err:
        out["too_many"] = str(err)
    from repro_torch.checkpoint import load_stream_checkpoint
    prog = net.compile(ExecutionPlan(mode="dynamic", devices=2))
    out["ckpt"] = _record(prog.run_checkpointed(ckpt_dir, every_sweeps=2), prog)
    out["ckpt_meta"] = load_stream_checkpoint(ckpt_dir)[1]
    return out


def body_serve(rank, world, serve_params):
    """The ActorEngine at devices=world on the reference's weights."""
    from repro_torch.configs import smoke_config
    from repro_torch.convert import lm_params_from_numpy
    from repro_torch.models import LM
    from repro_torch.serve import ActorEngine, Request, ServeConfig
    params, prompts = serve_params
    cfg = smoke_config("granite-8b")
    model = LM(cfg, device="cpu", seed=None)
    model.load_state_dict(lm_params_from_numpy(cfg, params))
    eng = ActorEngine(cfg, model, ServeConfig(**SERVE),
                      plan=ExecutionPlan(mode="dynamic", devices=world))
    got = eng.generate([Request(p, m) for p, (_, m) in zip(prompts, SERVE_SHAPES)])
    return dict(tokens=[r.tokens.tolist() for r in got], counts=eng.last_fire_counts,
                coll=eng.last_collective_bytes_per_sweep)


def body_kill(rank, world, ckpt_dir):
    """run_checkpointed at devices=2, every rank ended at the start of its
    second segment, after the first segment's snapshot was committed."""
    calls = [0]
    orig = Program._run_one_segment

    def hooked(seg_prog, state):
        calls[0] += 1
        if calls[0] == 2:
            os._exit(17)
        return orig(seg_prog, state)

    Program._run_one_segment = staticmethod(hooked)
    prog = _graph("dpd").compile(ExecutionPlan(mode="dynamic", devices=2))
    prog.run_checkpointed(ckpt_dir, every_sweeps=2)
    return "not killed"


def body_resume(rank, world, ckpt_dir):
    prog = _graph("dpd").compile(ExecutionPlan(mode="dynamic", devices=2))
    return _record(prog.resume_run(ckpt_dir), prog)


# --------------------------------------------------------------------------- #
# The groups.
# --------------------------------------------------------------------------- #
@pytest.fixture(scope="module")
def moe_inputs():
    """The reference make_moe's weights and token stream, as numpy (drawn
    here; no network is built, so no alias is needed)."""
    import jax
    import jax.numpy as jnp
    from repro.models.moe import moe_init
    kw = GRAPHS["moe"]
    key = jax.random.PRNGKey(0)
    params = moe_init(key, kw["d_model"], MOE["n_experts"], MOE["d_ff"])
    xs = jax.random.normal(key, (kw["n_firings"] * kw["n_tokens"], kw["d_model"]),
                           jnp.float32)
    return {k: np.asarray(v) for k, v in params.items()}, np.asarray(xs)


@pytest.fixture(scope="module")
def k2(tmp_path_factory, moe_inputs):
    tmp = tmp_path_factory.mktemp("shard_k2")
    return _spawn("body_main", 2, tmp, str(tmp / "ckpt"), moe_inputs)


@pytest.fixture(scope="module")
def k4(tmp_path_factory, moe_inputs):
    tmp = tmp_path_factory.mktemp("shard_k4")
    return _spawn("body_main", 4, tmp, None, moe_inputs)


@pytest.fixture(scope="module")
def serve_inputs():
    """The reference's granite-8b smoke weights and the workload's prompts,
    drawn here as the reference child draws them."""
    import jax
    from repro.configs import smoke_config as ref_smoke_config
    from repro.models import init_params
    cfg = ref_smoke_config("granite-8b")
    params = jax.tree.map(np.asarray, init_params(jax.random.PRNGKey(0), cfg))
    rng = np.random.default_rng(1)
    prompts = [rng.integers(1, cfg.vocab, size=n).astype(np.int32) for n, _ in SERVE_SHAPES]
    return params, prompts


@pytest.fixture(scope="module")
def k2_serve(tmp_path_factory, serve_inputs):
    """The ActorEngine group of two ranks."""
    return _spawn("body_serve", 2, tmp_path_factory.mktemp("shard_serve"), serve_inputs)


@pytest.fixture(scope="module")
def port1(moe_inputs):
    """The port's own devices=1 runs (the plain dynamic path)."""
    out = {}
    for label in GRAPHS:
        prog = _graph(label, moe_inputs).compile(ExecutionPlan(mode="dynamic", devices=1))
        out[label] = _record(prog.run(), prog)
    return out


def _by_k(k2, k4, port1, k):
    return {1: [port1], 2: k2, 4: k4}[k]


# --------------------------------------------------------------------------- #
# Validation (one process).
# --------------------------------------------------------------------------- #
@pytest.fixture(scope="module")
def dpd():
    return make_dpd(n_firings=4, block_l=128, device="cpu")[0]


def test_devices_field_value_checks():
    for bad in (0, -1, 1.5, "2", True):
        with pytest.raises(ValueError, match="devices must be"):
            ExecutionPlan(mode="dynamic", devices=bad)
    assert ExecutionPlan(mode="dynamic", devices=64).devices == 64


def test_device_assign_freezes_to_sorted_tuple():
    plan = ExecutionPlan(mode="dynamic", devices=2, device_assign={"b": 1, "a": 0})
    assert plan.device_assign == (("a", 0), ("b", 1))


def test_validate_rejects_devices_with_cores(dpd):
    with pytest.raises(ValueError, match="exclusive"):
        ExecutionPlan(mode="megakernel", cores=2, devices=2).validate(dpd)


def test_validate_rejects_device_assign_without_devices(dpd):
    with pytest.raises(ValueError, match="requires devices > 1"):
        ExecutionPlan(mode="dynamic", device_assign={"src": 0}).validate(dpd)


def test_validate_rejects_devices_off_dynamic(dpd):
    with pytest.raises(ValueError, match="dynamic executor per device"):
        ExecutionPlan(mode="static", n_iterations=4, devices=2).validate(dpd)
    with pytest.raises(ValueError, match="dynamic executor per device"):
        ExecutionPlan(mode="megakernel", devices=2).validate(dpd)


def test_validate_rejects_devices_with_accelerated(dpd):
    with pytest.raises(ValueError, match="mesh IS the accelerator"):
        ExecutionPlan(mode="dynamic", devices=2, n_iterations=2,
                      accelerated=tuple(dpd.actors)[:1]).validate(dpd)


def test_validate_device_assign_totality_and_range(dpd):
    names = list(dpd.actors)
    with pytest.raises(ValueError, match="every actor to a device"):
        ExecutionPlan(mode="dynamic", devices=2,
                      device_assign={names[0]: 0}).validate(dpd)
    bad = {n: 0 for n in names}
    bad[names[-1]] = 2
    with pytest.raises(ValueError, match=r"devices outside \[0, 2\)"):
        ExecutionPlan(mode="dynamic", devices=2, device_assign=bad).validate(dpd)
    with pytest.raises(ValueError, match="unknown actors"):
        ExecutionPlan(mode="dynamic", devices=2,
                      device_assign={**{n: 0 for n in names}, "ghost": 1}).validate(dpd)


def test_validate_rejects_delay_channel_crossing_devices():
    net, _ = make_motion_detection(n_frames=12, rate=4, frame_hw=(48, 64), device="cpu")
    assign = {"source": 0, "gauss": 0, "thres": 1, "med": 1, "sink": 1}
    with pytest.raises(ValueError, match="may not cross partitions.*one device"):
        ExecutionPlan(mode="dynamic", devices=2, device_assign=assign).validate(net)


def test_compile_routes_through_validate_and_checks_the_group(dpd):
    with pytest.raises(ValueError, match="exclusive"):
        dpd.compile(ExecutionPlan(mode="megakernel", cores=2, devices=2))
    # No process group in this process: the port's counterpart of the
    # reference's XLA_FLAGS message.
    with pytest.raises(RuntimeError, match="init_process_group"):
        dpd.compile(ExecutionPlan(mode="dynamic", devices=2))


def test_devices_one_is_the_plain_dynamic_path(dpd):
    prog = dpd.compile(ExecutionPlan(mode="dynamic", devices=1))
    prog.run()
    st = prog.stats()
    assert st.devices == 1
    assert st.device_partition_actors is None
    assert st.collective_bytes_per_sweep is None
    assert st.quiescence_allreduces is None
    assert st.to_json()["devices"] == 1


def _plan_legal(mode, guards, trace, cores, devices):
    if cores != 1 and mode != "megakernel":
        return False
    if (guards or trace) and mode not in ("dynamic", "megakernel"):
        return False
    if devices > 1 and (cores != 1 or mode != "dynamic"):
        return False
    return True


@pytest.mark.parametrize("mode,guards,trace,cores,devices", list(itertools.product(
    ("dynamic", "static", "megakernel"), (False, True), (False, True), (1, 2), (1, 2))))
def test_plan_validation_matrix(dpd, mode, guards, trace, cores, devices):
    """validate() accepts exactly the legal corner of the plan space, and
    every rejection is one ValueError naming plan fields."""
    plan = ExecutionPlan(mode=mode, guards=guards, trace=trace, cores=cores,
                         devices=devices, n_iterations=4)
    if _plan_legal(mode, guards, trace, cores, devices):
        assert plan.validate(dpd) is plan
    else:
        with pytest.raises(ValueError) as err:
            plan.validate(dpd)
        msg = str(err.value)
        assert "ExecutionPlan" in msg and "\n\n" not in msg


def test_merge_device_traces_interleaves_by_round():
    def trace(rows, dropped):
        return Trace(actor_names=("a", "b"), fifo_names=("f",),
                     events=np.asarray(rows, np.int32), capacity=8, dropped=dropped)
    t0 = trace([[0, 0, 1, 1], [0, 2, 1, 0]], 1)
    t1 = trace([[1, 0, 0, 1], [1, 1, 1, 0], [1, 2, 1, 1]], 2)
    m = merge_device_traces([t0, None, t1])
    assert m.events[:, 1].tolist() == [0, 0, 1, 2, 2]
    assert m.events[:, 0].tolist() == [0, 1, 1, 0, 1]      # device order on ties
    assert m.dropped == 3 and m.firing_counts() == {"a": 2, "b": 2}
    assert merge_device_traces([]) is None
    with pytest.raises(ValueError, match="different networks"):
        merge_device_traces([t0, Trace(("x",), ("f",), t0.events, 8)])


# --------------------------------------------------------------------------- #
# Sharded runs against the reference and the port's own devices=1.
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("k", [1, 2, 4])
@pytest.mark.parametrize("label", list(GRAPHS))
def test_sharded_runs_match_reference(ref, k2, k4, port1, label, k):
    from test_torch_harness import assert_leaves_match
    want = ref[(label, k)]
    one = port1[label]
    for rec in _by_k(k2, k4, port1, k):
        r = rec[label]
        # Every rank returns the port's devices=1 state, bit for bit.
        assert len(r["leaves"]) == len(one["leaves"])
        assert all(np.array_equal(a, b) and a.dtype == b.dtype
                   for a, b in zip(r["leaves"], one["leaves"]))
        assert r["counts"] == want["counts"]
        assert r["rounds"] == want["rounds"]
        st = r["stats"]
        assert st["schema_version"] == 2 and st["devices"] == k
        assert st["collective_bytes_per_sweep"] == want["coll"]
        assert st["device_partition_actors"] == (
            None if want["parts"] is None else [list(p) for p in want["parts"]])
        assert st["quiescence_allreduces"] == (want["rounds"] if k > 1 else None)
    # Float leaves within the harness's tolerance, integers exactly (C2).
    assert_leaves_match(ref[(label, 1)]["leaves"], one["leaves"])


def test_reference_rounds_and_bytes_are_the_expected_table(ref):
    """The readings the port is held to: the reference's rounds and bytes
    at devices 1, 2 and 4."""
    got = {(lb, k): (ref[(lb, k)]["rounds"], ref[(lb, k)]["coll"])
           for lb in GRAPHS for k in (1, 2, 4)}
    assert got == {("dpd", 1): (4, None), ("dpd", 2): (7, 41108), ("dpd", 4): (10, 53468),
                   ("moe", 1): (3, None), ("moe", 2): (5, 17036), ("moe", 4): (8, 29380)}


@pytest.mark.parametrize("label", list(GRAPHS))
def test_guards_and_trace_at_devices_2(ref, k2, port1, label):
    for rec in k2:
        r = rec[label + "_trace"]
        assert r["diag_ok"] and ref[(label, "trace")]["ok"]
        assert all(np.array_equal(a, b) for a, b in zip(r["leaves"], port1[label]["leaves"]))
        assert r["fired"] == r["counts"] == ref[(label, "trace")]["fired"]
        assert r["dropped"] == 0
        assert (np.diff(r["sweeps"]) >= 0).all()
        parts = r["stats"]["device_partition_actors"]
        names = list(r["counts"])
        assert list(r["cores"]) == [next(d for d, p in enumerate(parts) if n in p)
                                    for n in names]


def test_device_assign_is_honoured(ref, k2, port1):
    cut = ref["assign"]["cut"]
    for rec in k2:
        r = rec["assign"]
        assert all(np.array_equal(a, b) for a, b in zip(r["leaves"], port1["dpd"]["leaves"]))
        parts = r["stats"]["device_partition_actors"]
        assert set(parts[0]) == {n for n, d in cut.items() if d == 0}
        assert parts == [list(p) for p in ref["assign"]["parts"]]


def test_world_other_than_devices_is_refused(k2):
    for rec in k2:
        assert rec["too_many"] is not None
        assert "has 2 rank(s)" in rec["too_many"] and "world_size=4" in rec["too_many"]


def test_replicated_result_on_every_rank(k2, k4):
    for group in (k2, k4):
        for rec in group[1:]:
            for label in GRAPHS:
                assert all(np.array_equal(a, b) for a, b in
                           zip(rec[label]["leaves"], group[0][label]["leaves"]))


def test_kill_resume_run_checkpointed_at_devices_2(tmp_path, k2):
    from repro_torch.checkpoint import load_stream_checkpoint
    ckpt = str(tmp_path / "ckpt")
    with pytest.raises(GroupError) as err:
        _spawn("body_kill", 2, tmp_path / "kill", ckpt)
    assert 17 in err.value.exitcodes
    _, meta, step = load_stream_checkpoint(ckpt)
    assert (step, meta["devices"], meta["done"]) == (1, 2, False)
    resumed = _spawn("body_resume", 2, tmp_path / "resume", ckpt)
    whole = k2[0]["ckpt"]
    assert (k2[0]["ckpt_meta"]["devices"], k2[0]["ckpt_meta"]["done"]) == (2, True)
    for r in resumed:
        assert all(np.array_equal(a, b) for a, b in zip(r["leaves"], whole["leaves"]))
        assert r["counts"] == whole["counts"] and r["rounds"] == whole["rounds"]
    # The uninterrupted segmented run equals the plain sharded run.
    assert all(np.array_equal(a, b) for a, b in zip(whole["leaves"], k2[0]["dpd"]["leaves"]))
    assert whole["counts"] == k2[0]["dpd"]["counts"]
    assert whole["rounds"] == k2[0]["dpd"]["rounds"]


# --------------------------------------------------------------------------- #
# Serving at devices = 2.
# --------------------------------------------------------------------------- #
def _port_engine(params):
    from repro_torch.configs import smoke_config
    from repro_torch.convert import lm_params_from_numpy
    from repro_torch.models import LM
    cfg = smoke_config("granite-8b")
    model = LM(cfg, device="cpu", seed=None)
    model.load_state_dict(lm_params_from_numpy(cfg, params))
    return cfg, model


def test_sharded_actor_engine_tokens(ref, k2_serve, serve_inputs):
    """The sharded engine's tokens equal the port's Engine's exactly on
    every rank, and the reference's under the margin rule (C3): along the
    reference's greedy trajectory the port's logits are computed on the
    same tokens; where the reference's top-2 margin exceeds twice the
    largest logit difference the tokens must agree, and a request is
    compared up to its first step below that."""
    from repro_torch.serve import Engine, Request, ServeConfig
    want = ref["serve"]
    params, prompts = serve_inputs
    assert all(np.array_equal(a, b) for a, b in zip(prompts, want["prompts"]))
    cfg, model = _port_engine(params)
    reqs = [Request(p, m) for p, (_, m) in zip(prompts, SERVE_SHAPES)]
    engine = [r.tokens.tolist() for r in Engine(cfg, model, ServeConfig(**SERVE)).generate(reqs)]
    for rec in k2_serve:
        assert rec["tokens"] == engine
    assert want["tokens"] == want["engine"]
    B, P, N = SERVE["batch_size"], SERVE["max_prompt"], SERVE["max_new"]
    compared = 0
    for g, (toks, steps) in enumerate(want["traj"]):
        with torch.inference_mode():
            logits, caches = model.prefill(torch.tensor(toks, dtype=torch.int64),
                                           max_cache_len=P + N)
            for step, (lg, nxt) in enumerate(steps):
                err = np.abs(logits.float().numpy() - lg).max(-1)
                top2 = np.sort(lg, -1)[:, -2:]
                margin = top2[:, 1] - top2[:, 0]
                for i in range(B):
                    j = g * B + i
                    if (j >= len(reqs) or step >= len(engine[j])
                            or step >= len(want["engine"][j])):
                        continue
                    if margin[i] <= 2 * err[i] or any(
                            want["engine"][j][s] != engine[j][s] for s in range(step)):
                        continue
                    assert engine[j][step] == want["engine"][j][step], (j, step)
                    compared += 1
                if step < N - 1:
                    pos = torch.full((B,), P + step, dtype=torch.int64)
                    logits, caches = model.decode_step(
                        torch.tensor(nxt[:, None], dtype=torch.int64), pos, caches)
    assert compared >= 2, f"only {compared} tokens had a margin above the rule's"


def test_sharded_actor_engine_telemetry(ref, k2_serve):
    want = ref["serve"]
    for got in k2_serve:
        assert got["coll"] == want["coll"] and got["coll"] > 0
        c = got["counts"]
        assert c["decode"] == c["admission"] == c["merge"]
        assert {n: c[n] for n in ("decode", "admission", "merge")} == {
            n: want["counts"][n] for n in ("decode", "admission", "merge")}


def test_spawn_group_reports_a_failing_rank(tmp_path):
    with pytest.raises(GroupError, match="exit codes") as err:
        spawn_group("test_torch_shard:body_fail", 2, str(tmp_path), timeout=60)
    assert err.value.exitcodes[1] == 3


def body_fail(rank, world):
    if rank == 1:
        sys.exit(3)
    import torch.distributed as dist
    dist.barrier()


def test_spawn_group_kills_a_group_past_its_deadline(tmp_path):
    with pytest.raises(GroupError, match="still running"):
        spawn_group("test_torch_shard:body_hang", 2, str(tmp_path), timeout=4)


def body_hang(rank, world):
    import time
    time.sleep(600)

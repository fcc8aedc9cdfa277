"""Checkpoints and durable runs on the port (CPU): ``repro_torch.checkpoint``
on the JAX package's on-disk format, ``stream(checkpoint_dir=...)`` /
``resume_stream`` and ``run_checkpointed`` / ``resume_run``.

Counterparts of the reference's ``test_fault_tolerance.py:18,29,39``
(the ``Checkpointer``), ``test_resilience.py:414,436,460`` (torn snapshots,
mismatched resumes, resuming a finished run) and its kill/resume tests
(``:280-370``): a child process is killed with a real SIGKILL from a hook
on ``repro_torch.core.program.save_stream_checkpoint`` and a fresh child
resumes.  The format is held byte for byte: the same payload written by
both packages gives the same manifest and the same leaf files, and each
package loads the other's snapshot leaf for leaf (a bf16 leaf among
them).  Resumed runs are held to the port's uninterrupted run exactly.
"""
from __future__ import annotations

import os
import signal
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

from test_torch_harness import jax_literal  # noqa: F401 (fixture)

from repro_torch.checkpoint import (CheckpointIntegrityError, Checkpointer,
                                    load_stream_checkpoint, save_stream_checkpoint)
from repro_torch.core import ExecutionPlan
from repro_torch.graphs.factories import make_dpd, states_equal

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _bf16(values) -> np.ndarray:
    """float32 values that bf16 holds exactly (high halves only)."""
    a = np.asarray(values, np.float32)
    return (a.view(np.uint32) & np.uint32(0xFFFF0000)).view(np.float32)


def _payload(torch_leaves: bool):
    """One payload with every kind of node: nested dict/list/tuple, JSON
    scalars, int32/float32/uint8 and a bf16 leaf."""
    import jax.numpy as jnp
    rng = np.random.default_rng(0)
    f32 = rng.normal(size=(3, 4)).astype(np.float32)
    i32 = np.arange(6, dtype=np.int32).reshape(2, 3)
    u8 = rng.integers(0, 256, (5,)).astype(np.uint8)
    bf = _bf16(rng.normal(size=(2, 5)))
    if torch_leaves:
        leaves = (torch.from_numpy(f32), torch.from_numpy(i32), torch.from_numpy(u8),
                  torch.from_numpy(bf).to(torch.bfloat16), torch.tensor(7, dtype=torch.int32))
    else:
        leaves = (f32, i32, u8, np.asarray(jnp.asarray(bf, jnp.bfloat16)),
                  np.asarray(7, np.int32))
    return {"state": {"a": leaves[0], "b": [leaves[1], (leaves[2], leaves[3])]},
            "scalar": leaves[4], "n": 3, "x": 1.5, "name": "dpd", "none": None,
            "flag": True}


def _files(root: str) -> dict:
    out = {}
    for dirpath, _, names in os.walk(root):
        for n in names:
            p = os.path.join(dirpath, n)
            with open(p, "rb") as f:
                out[os.path.relpath(p, root)] = f.read()
    return out


def _leaf_list(payload) -> list:
    """Every array leaf as float64 numpy, depth first."""
    out = []

    def walk(x):
        if isinstance(x, dict):
            for k in x:
                walk(x[k])
        elif isinstance(x, (list, tuple)):
            for v in x:
                walk(v)
        elif isinstance(x, torch.Tensor):
            out.append(x.float().numpy().astype(np.float64))
        elif isinstance(x, np.ndarray):
            out.append(np.asarray(x, np.float64))
    walk(payload)
    return out


# --------------------------------------------------------------------------- #
# The snapshot format.
# --------------------------------------------------------------------------- #
def test_snapshot_format_is_the_references_byte_for_byte(jax_literal, tmp_path):
    from repro.checkpoint import load_stream_checkpoint as ref_load
    from repro.checkpoint import save_stream_checkpoint as ref_save
    meta = {"kind": "stream", "chunk": 2, "fifos": ["f_in", "f_out"]}
    ref_save(str(tmp_path / "ref"), 2, _payload(False), meta)
    save_stream_checkpoint(str(tmp_path / "port"), 2, _payload(True), meta)
    want, got = _files(str(tmp_path / "ref")), _files(str(tmp_path / "port"))
    assert sorted(got) == sorted(want)
    for name in want:
        assert got[name] == want[name], name          # manifest and leaves
    # Each package loads the other's snapshot, leaf for leaf.
    p_from_ref, m1, s1 = load_stream_checkpoint(str(tmp_path / "ref"))
    r_from_port, m2, s2 = ref_load(str(tmp_path / "port"))
    assert (m1, s1) == (m2, s2) == (meta, 2)
    assert p_from_ref["state"]["b"][1][1].dtype == torch.bfloat16
    assert str(r_from_port["state"]["b"][1][1].dtype) == "bfloat16"
    for a, b in zip(_leaf_list(p_from_ref), _leaf_list(r_from_port)):
        np.testing.assert_array_equal(a, b)
    for a, b in zip(_leaf_list(p_from_ref), _leaf_list(_payload(True))):
        np.testing.assert_array_equal(a, b)
    assert {k: p_from_ref[k] for k in ("n", "x", "name", "none", "flag")} == \
        {"n": 3, "x": 1.5, "name": "dpd", "none": None, "flag": True}
    assert isinstance(p_from_ref["state"]["b"][1], tuple)


def test_torn_snapshot_falls_back_to_previous(tmp_path):
    d = str(tmp_path / "ck")
    save_stream_checkpoint(d, 1, {"x": np.arange(4)}, {"kind": "t"})
    save_stream_checkpoint(d, 2, {"x": torch.arange(8)}, {"kind": "t"})
    leaf = os.path.join(d, "chunk_00000002", "leaf_0000.npy")
    with open(leaf, "r+b") as f:
        f.seek(0, 2)
        f.truncate(f.tell() - 3)
    payload, meta, step = load_stream_checkpoint(d)
    assert step == 1 and tuple(payload["x"].shape) == (4,)
    leaf1 = os.path.join(d, "chunk_00000001", "leaf_0000.npy")
    with open(leaf1, "r+b") as f:
        f.write(b"\xff" * 8)
    with pytest.raises(CheckpointIntegrityError):
        load_stream_checkpoint(d)


# --------------------------------------------------------------------------- #
# The Checkpointer (test_fault_tolerance.py:18-50).
# --------------------------------------------------------------------------- #
def _tree():
    return {"a": torch.arange(12.0).reshape(3, 4),
            "b": {"c": torch.tensor(7, dtype=torch.int32),
                  "d": torch.ones((5,), dtype=torch.bfloat16) * 1.5}}


def test_checkpoint_roundtrip(tmp_path):
    ckpt = Checkpointer(str(tmp_path), keep=2)
    tree = _tree()
    ckpt.save(3, tree, blocking=True)
    target = {"a": torch.empty(3, 4, device="meta"),
              "b": {"c": torch.empty((), dtype=torch.int32, device="meta"),
                    "d": torch.empty(5, dtype=torch.bfloat16, device="meta")}}
    restored = ckpt.restore(3, target)
    for k in ("a",):
        assert torch.equal(restored[k], tree[k])
    assert torch.equal(restored["b"]["c"], tree["b"]["c"])
    assert restored["b"]["d"].dtype == torch.bfloat16
    assert torch.equal(restored["b"]["d"], tree["b"]["d"])
    # A shardings tree of None places no leaf: every leaf comes back whole,
    # as without one (placed restores are in test_torch_train_mesh.py).
    none = ckpt.restore(3, target, shardings={"a": None, "b": {"c": None, "d": None}})
    assert all(torch.equal(none[k], restored[k]) for k in ("a",))
    assert torch.equal(none["b"]["d"], restored["b"]["d"])


def test_checkpoint_store_interoperates_with_the_reference(jax_literal, tmp_path):
    import jax
    import jax.numpy as jnp
    from repro.checkpoint import Checkpointer as RefCheckpointer
    port_dir, ref_dir = str(tmp_path / "port"), str(tmp_path / "ref")
    Checkpointer(port_dir).save(3, _tree(), blocking=True)
    ref_tree = {"a": jnp.arange(12.0).reshape(3, 4),
                "b": {"c": jnp.int32(7), "d": jnp.ones((5,), jnp.bfloat16) * 1.5}}
    spec = jax.tree.map(lambda x: jax.ShapeDtypeStruct(x.shape, x.dtype), ref_tree)
    from_port = RefCheckpointer(port_dir).restore(3, spec)
    for a, b in zip(jax.tree.leaves(ref_tree), jax.tree.leaves(from_port)):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(np.asarray(a, np.float64), np.asarray(b, np.float64))
    RefCheckpointer(ref_dir).save(3, ref_tree, blocking=True)
    from_ref = Checkpointer(ref_dir).restore(3, _tree())
    for k, v in (("a", from_ref["a"]), ("c", from_ref["b"]["c"]), ("d", from_ref["b"]["d"])):
        want = _tree()["a"] if k == "a" else _tree()["b"][k]
        assert v.dtype == want.dtype and torch.equal(v, want), k


def test_checkpoint_async_and_retention(tmp_path):
    ckpt = Checkpointer(str(tmp_path), keep=2)
    tree = {"x": torch.ones((4, 4))}
    for s in [1, 2, 3, 4]:
        ckpt.save(s, tree)
    ckpt.wait()
    assert ckpt.all_steps() == [3, 4]
    assert ckpt.latest_step() == 4


def test_checkpoint_atomic_commit(tmp_path):
    ckpt = Checkpointer(str(tmp_path), keep=3)
    ckpt.save(1, {"x": torch.ones(3)}, blocking=True)
    os.makedirs(os.path.join(str(tmp_path), "step_00000002.tmp"))
    assert ckpt.latest_step() == 1


# --------------------------------------------------------------------------- #
# Durable streams and runs in process.
# --------------------------------------------------------------------------- #
def _dpd_stream(n_firings=8, block_l=64, **plan):
    net, nf = make_dpd(n_firings=n_firings, block_l=block_l, device="cpu")
    accel = tuple(n for n in net.actors if n not in ("source", "sink"))
    sig = np.random.default_rng(0).normal(size=(2, nf * block_l)).astype(np.float32)
    wins = np.stack([sig[:, i * block_l:(i + 1) * block_l] for i in range(nf)])[:, None]
    return net, ExecutionPlan(n_iterations=2, accelerated=accel, **plan), {"f_in": wins}


def test_resume_rejects_mismatched_kind_and_geometry(tmp_path):
    net, splan, feeds = _dpd_stream(n_firings=4)
    ck = str(tmp_path / "ck")
    net.compile(mode="dynamic").run_checkpointed(ck, every_sweeps=100)
    sprog = net.compile(splan, mode="dynamic")
    with pytest.raises(ValueError, match="resume via Program.resume_run"):
        sprog.resume_stream(ck, feeds)
    sck = str(tmp_path / "sck")
    sprog.stream(feeds, checkpoint_dir=sck)
    with pytest.raises(ValueError, match="resume via Program.resume_stream"):
        net.compile(mode="dynamic").resume_run(sck)
    other = net.compile(splan, mode="dynamic", n_iterations=4)
    with pytest.raises(ValueError, match="snapshot covers chunks of 2 windows"):
        other.resume_stream(sck, feeds)


def test_resume_run_of_completed_run_returns_final_result(tmp_path):
    net, _ = make_dpd(n_firings=4, block_l=64, device="cpu")
    ck = str(tmp_path / "ck")
    ref = net.compile(mode="dynamic").run()
    got = net.compile(mode="dynamic").run_checkpointed(ck, every_sweeps=2)
    assert got.sweeps == ref.sweeps and got.fire_counts == ref.fire_counts
    assert states_equal(got.state, ref.state)
    again = net.compile(mode="dynamic").resume_run(ck)
    assert again.sweeps == ref.sweeps and again.fire_counts == ref.fire_counts
    assert states_equal(again.state, ref.state)


@pytest.mark.parametrize("mode", ["dynamic", "megakernel"])
def test_run_checkpointed_segments_equal_the_run(tmp_path, mode):
    """Every segment boundary re-enters the executor (B2's plain version in
    megakernel mode) mid-run; the sum equals one run, bit for bit, and a
    resume from each snapshot ends the same."""
    net, _ = make_dpd(n_firings=6, block_l=64, device="cpu")
    plan = ExecutionPlan(mode=mode, specialize=False)
    ref = net.compile(plan).run()
    ck = str(tmp_path / "ck")
    got = net.compile(plan).run_checkpointed(ck, every_sweeps=1, keep=None)
    assert got.sweeps == ref.sweeps and got.fire_counts == ref.fire_counts
    assert states_equal(got.state, ref.state)
    steps = sorted(int(d.split("_")[1]) for d in os.listdir(ck))
    assert len(steps) == ref.sweeps >= 3
    for s in steps[:-1]:
        part = str(tmp_path / f"from{s}")
        os.makedirs(part)
        import shutil
        shutil.copytree(os.path.join(ck, f"chunk_{s:08d}"),
                        os.path.join(part, f"chunk_{s:08d}"))
        res = net.compile(plan).resume_run(part)
        assert res.sweeps == ref.sweeps and res.fire_counts == ref.fire_counts
        assert states_equal(res.state, ref.state)


# --------------------------------------------------------------------------- #
# Kill -> resume in fresh processes (a real SIGKILL).
# --------------------------------------------------------------------------- #
def _run_child(body: str, expect_kill: bool = False, timeout: int = 300) -> str:
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"))
    out = subprocess.run([sys.executable, "-c", textwrap.dedent(body)],
                         capture_output=True, text=True, timeout=timeout, env=env)
    if expect_kill:
        assert out.returncode == -signal.SIGKILL, (
            f"child exited {out.returncode}, expected SIGKILL\n"
            f"stdout:\n{out.stdout}\nstderr:\n{out.stderr}")
    else:
        assert out.returncode == 0, f"stdout:\n{out.stdout}\nstderr:\n{out.stderr}"
    return out.stdout


_KILL_HOOK = """
import os, signal
import repro_torch.core.program as P
_orig_save = P.save_stream_checkpoint
_n = [0]
def _hooked(*a, **k):
    r = _orig_save(*a, **k)
    _n[0] += 1
    if _n[0] == @KILL_AFTER@:
        os.kill(os.getpid(), signal.SIGKILL)
    return r
P.save_stream_checkpoint = _hooked
"""

_DPD_SETUP = """
import numpy as np, torch
from repro_torch.core import ExecutionPlan
from repro_torch.graphs.factories import make_dpd
net, nf = make_dpd(n_firings=8, block_l=64, device="cpu")
accel = tuple(n for n in net.actors if n not in ("source", "sink"))
rng = np.random.default_rng(0)
sig = rng.normal(size=(2, nf * 64)).astype(np.float32)
wins = np.stack([sig[:, i * 64:(i + 1) * 64] for i in range(nf)])[:, None]
feeds = {"f_in": wins}
plan = @PLAN@
prog = net.compile(plan)
"""

_SERVING_SETUP = """
import numpy as np, torch
from repro_torch.configs import smoke_config
from repro_torch.models import LM
from repro_torch.serve import ActorEngine, Request, ServeConfig
from repro_torch.core import ExecutionPlan
from repro_torch.graphs.factories import states_equal
cfg = smoke_config("granite-8b")
model = LM(cfg, device="cpu", seed=0)
scfg = ServeConfig(batch_size=2, max_prompt=6, max_new=3, eos_id=7)
rng = np.random.default_rng(5)
reqs = [Request(prompt=rng.integers(1, cfg.vocab, size=4).astype(np.int32),
                max_new=3) for _ in range(4)]
net = ActorEngine(cfg, model, scfg).build_network(reqs)
plan = @PLAN@
prog = net.compile(plan)
"""

DPD_STREAM_PLANS = {
    "dynamic": "ExecutionPlan(mode='dynamic', n_iterations=2, accelerated=accel, trace=True)",
    "megakernel": "ExecutionPlan(mode='megakernel', n_iterations=2, "
                  "accelerated=accel, specialize=False)",
}


@pytest.mark.parametrize("mode", sorted(DPD_STREAM_PLANS))
def test_kill_resume_stream_dpd_bit_identical(tmp_path, mode):
    """Killed after chunk 2 of 4; a fresh process resumes, and its outputs,
    fire counts, sweeps and merged trace equal the uninterrupted stream."""
    ck = str(tmp_path / "ck")
    setup = _DPD_SETUP.replace("@PLAN@", DPD_STREAM_PLANS[mode])
    _run_child(setup + _KILL_HOOK.replace("@KILL_AFTER@", "2") + f"""
prog.stream(feeds, checkpoint_dir={ck!r}, checkpoint_every=1)
raise SystemExit("stream finished without being killed")
""", expect_kill=True)
    assert sorted(os.listdir(ck)) == ["chunk_00000001", "chunk_00000002"]
    out = _run_child(setup + f"""
ref = prog.stream(feeds)
ref_fc, ref_sw, ref_tr = prog.last_stream_fire_counts, prog.last_stream_sweeps, prog.last_stream_trace
prog2 = net.compile(plan)
got = prog2.resume_stream({ck!r}, feeds, checkpoint_every=1)
for f in ref:
    assert torch.equal(ref[f], got[f]), f
assert prog2.last_stream_fire_counts == ref_fc
assert prog2.last_stream_sweeps == ref_sw
if ref_tr is not None:
    np.testing.assert_array_equal(ref_tr.events, prog2.last_stream_trace.events)
    assert ref_tr.actor_names == prog2.last_stream_trace.actor_names
print("RESUME_STREAM_OK")
""")
    assert "RESUME_STREAM_OK" in out


def test_kill_resume_run_serving_bit_identical(tmp_path):
    """The serving network through run_checkpointed (segments of 5 sweeps),
    killed after the first snapshot, resumed in a fresh process: final
    state, fire counts and sweeps equal the uninterrupted run."""
    ck = str(tmp_path / "ck")
    setup = _SERVING_SETUP.replace("@PLAN@", "ExecutionPlan(mode='dynamic')")
    _run_child(setup + _KILL_HOOK.replace("@KILL_AFTER@", "1") + f"""
prog.run_checkpointed({ck!r}, every_sweeps=5)
raise SystemExit("run finished without being killed")
""", expect_kill=True)
    assert os.listdir(ck) == ["chunk_00000001"]
    out = _run_child(setup + f"""
ref = prog.run()
got = net.compile(plan).resume_run({ck!r})
assert got.sweeps == ref.sweeps > 5, (got.sweeps, ref.sweeps)
assert got.fire_counts == ref.fire_counts
assert states_equal(got.state, ref.state)
print("RESUME_RUN_OK")
""")
    assert "RESUME_RUN_OK" in out


def test_serving_megakernel_and_devices_plans_raise_naming_their_items(tmp_path):
    """The reference's other two kill/resume cells
    (``tests/test_resilience.py:347-351``).  Megakernel mode (unspecialized,
    as there): the serving network through run_checkpointed in segments of
    5 sweeps, each segment a B2 run with its yields at the decode steps
    (its plain version here), killed after the first snapshot and resumed
    in a fresh process: final state, fire counts and sweeps bit for bit the
    uninterrupted run's and the dynamic run's.  ``devices=2`` is ported
    (kill/resume at devices=2 is in test_torch_shard.py) and, with no
    process group started, refused naming how to start one."""
    ck = str(tmp_path / "ck")
    setup = _SERVING_SETUP.replace(
        "@PLAN@", "ExecutionPlan(mode='megakernel', specialize=False)")
    _run_child(setup + _KILL_HOOK.replace("@KILL_AFTER@", "1") + f"""
prog.run_checkpointed({ck!r}, every_sweeps=5)
raise SystemExit("run finished without being killed")
""", expect_kill=True)
    assert os.listdir(ck) == ["chunk_00000001"]
    out = _run_child(setup + f"""
ref = prog.run()
dyn = net.compile(ExecutionPlan(mode="dynamic")).run()
got = net.compile(plan).resume_run({ck!r})
assert got.sweeps == ref.sweeps == dyn.sweeps > 5, (got.sweeps, ref.sweeps)
assert got.fire_counts == ref.fire_counts == dyn.fire_counts
assert states_equal(got.state, ref.state) and states_equal(ref.state, dyn.state)
print("RESUME_RUN_OK")
""")
    assert "RESUME_RUN_OK" in out
    from repro_torch.configs import smoke_config
    from repro_torch.models import LM
    from repro_torch.serve import ActorEngine, Request, ServeConfig
    cfg = smoke_config("granite-8b")
    eng = ActorEngine(cfg, LM(cfg, device="cpu", seed=0),
                      ServeConfig(batch_size=2, max_prompt=6, max_new=3, eos_id=7))
    net = eng.build_network([Request(prompt=np.arange(1, 5, dtype=np.int32), max_new=3)])
    with pytest.raises(RuntimeError, match="init_process_group"):
        net.compile(ExecutionPlan(mode="dynamic", devices=2))

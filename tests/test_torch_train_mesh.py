"""The sharded train step and checkpoints across meshes, on gloo CPU groups
(``repro_torch.launch.group.spawn_group``, ``device_type="cpu"``).

* (data 2, model 2), 4 ranks, ``smoke_config("granite-8b")``: the step
  with ``zero1`` on and off, grads in float32 and bf16, and once with
  error feedback, equals the single-process step with ``microbatches=2``
  bit for bit: the gathered params, ``m``, ``v``, ``count``, ``feedback``
  and every metric.  Two planted faults (the data-parallel reduction
  skipped; the norm summed shard by shard from bf16-rounded gradients)
  break that equality, and the test asserts that they do.  In the same
  group: a checkpoint saved on (2, 2) restores on (4, 1) and with no
  ``shardings``, every full tensor
  identical, the placements the ones requested; a checkpoint the JAX
  package wrote from a tree sharded on its 8-device CPU mesh restores.
* A world of 1: the 1x1 mesh's step equals today's step bit for bit, and
  the (2, 2) checkpoint restores on (1, 1).
* (data 4, model 2), 8 ranks: ``tests/test_distribution.py:51-86`` on the
  port (loss finite, params changed, every rank's ``embed.w`` shard has
  vocab / 2 rows), and every leaf's local shape against the reference's
  spec.
* ``launch/train.py --smoke --device cpu --zero1 --mesh 2x1`` in a group
  of 2 runs, then resumes from its own sharded checkpoint.

The JAX package's readings (its checkpoint, its specs) come from one child
process with ``XLA_FLAGS=--xla_force_host_platform_device_count=8``, run
while the port's first group runs.  This module imports neither jax nor
the JAX package at import time: the ranks import it to find their bodies.
"""
from __future__ import annotations

import os
import pickle
import subprocess
import sys

import numpy as np
import pytest
import torch

from repro_torch.launch.group import spawn_group

REPO_SRC = os.path.join(os.path.dirname(__file__), "..", "src")
ARCH = "granite-8b"
SEQ, BATCH = 16, 4
GROUP_TIMEOUT = 300
#: (zero1, grad_dtype, error_feedback) of the exact cases.
CASES = [(False, "f32", False), (True, "f32", False), (False, "bf16", False),
         (True, "bf16", False), (True, "bf16", True)]
FAULTS = ["skip_dp_reduction", "norm_from_shards"]


def _spawn(name, world, tmp, *args):
    return spawn_group(f"test_torch_train_mesh:{name}", world, str(tmp), args=args,
                       timeout=GROUP_TIMEOUT, threads=1)


# --------------------------------------------------------------------------- #
# Shared pieces (ranks and the test process).
# --------------------------------------------------------------------------- #
def _setup(feedback: bool):
    from repro_torch.configs import smoke_config
    from repro_torch.data import DataConfig, SyntheticLM
    from repro_torch.optim import init_opt_state
    from repro_torch.train import init_params
    cfg = smoke_config(ARCH)
    params = init_params(cfg, device="cpu", seed=0)
    opt = init_opt_state(params)
    if feedback:
        gen = torch.Generator().manual_seed(1)
        opt["feedback"] = {k: torch.randn(p.shape, generator=gen) * 1e-3
                           for k, p in params.items()}
    data = SyntheticLM(DataConfig(vocab=cfg.vocab, seq_len=SEQ, global_batch=BATCH))
    batch = {k: torch.from_numpy(v.astype(np.int64)) for k, v in data.batch(0).items()}
    return cfg, params, opt, batch


def _opts(zero1, gdt, fb, microbatches=1):
    from repro_torch.optim import AdamWConfig
    from repro_torch.train import TrainOptions
    return (AdamWConfig(lr=1e-3, warmup_steps=0),
            TrainOptions(microbatches=microbatches, zero1=zero1, grad_dtype=gdt,
                         error_feedback=fb))


def _digest(tree) -> dict:
    """Full tensors' bits as bytes, by dotted name."""
    out = {}

    def walk(x, prefix):
        if isinstance(x, dict):
            for k, v in x.items():
                walk(v, f"{prefix}{k}.")
        else:
            t = x.detach().contiguous()
            out[prefix[:-1]] = (str(t.dtype), tuple(t.shape), t.view(torch.uint8).numpy().tobytes()
                                if t.dim() else t.reshape(1).view(torch.uint8).numpy().tobytes())
    walk(tree, "")
    return out


def _full(tree):
    from torch.distributed.tensor import DTensor
    from repro_torch.train.sharding import gather_full
    if isinstance(tree, dict):
        return {k: _full(v) for k, v in tree.items()}
    return gather_full(tree) if isinstance(tree, DTensor) else tree


def _sharded_case(mesh, zero1, gdt, fb):
    """One sharded step from the seeded state: (full state, metrics, local
    shapes against the specs)."""
    from repro_torch.train import make_train_step, shard_batch, shard_train_state
    from repro_torch.train import sharding as shd
    cfg, params, opt, batch = _setup(fb)
    opt_cfg, opts = _opts(zero1, gdt, fb)
    specs = _specs(cfg, mesh, params, opt, batch, opts)
    p, o = shard_train_state(params, opt, specs, mesh)
    step = make_train_step(cfg, opt_cfg, opts, mesh=mesh)
    p2, o2, m = step(p, o, shard_batch(batch, mesh))
    shapes_ok = all(
        tuple(x.to_local().shape) == tuple(
            s.stop - s.start for s in shd.local_region(
                x.shape, shd.placements(spec, mesh), tuple(mesh.mesh.shape),
                shd.mesh_coordinate(mesh)))
        for tree, sp in ((p2, specs[0]), (o2["m"], specs[1]["m"]), (o2["v"], specs[1]["v"]))
        for x, spec in ((tree[k], sp[k]) for k in tree))
    full = {"params": _full(p2), "opt": _full(o2)}
    return full, {k: v.clone() for k, v in m.items()}, shapes_ok, step.stats


def _specs(cfg, mesh, params, opt, batch, opts):
    """``train_shardings``' specs; under ``zero1`` the moments sharded over
    ``data`` from any size (the smoke leaves are all under 2^16, so the
    default would leave them whole)."""
    from repro_torch.train import train_shardings
    from repro_torch.train import sharding as shd
    specs, _ = train_shardings(cfg, mesh, params, opt, batch, opts)
    if opts.zero1:
        for key in ("m", "v"):
            specs[1][key] = shd.shard_over_data(specs[0], params, mesh, min_size=1)
    return specs


def single_step(zero1, gdt, fb, microbatches):
    """The single-process step on the same state and batch."""
    from repro_torch.train import make_train_step
    cfg, params, opt, batch = _setup(fb)
    opt_cfg, opts = _opts(zero1, gdt, fb, microbatches)
    p2, o2, m = make_train_step(cfg, opt_cfg, opts)(params, opt, batch)
    return {"params": p2, "opt": o2}, m


# --------------------------------------------------------------------------- #
# Rank bodies.
# --------------------------------------------------------------------------- #
def body_2x2(rank, world, ckpt_dir, ref_ckpt):
    """(data 2, model 2): the exact cases, the planted faults, checkpoints
    saved on (2, 2) and restored on (4, 1) and whole."""
    import repro_torch.train.sharding as shd
    import repro_torch.train.train_step as ts
    from repro_torch.checkpoint import Checkpointer
    from repro_torch.launch.mesh import make_test_mesh
    mesh = make_test_mesh((2, 2), device_type="cpu")
    out = {"cases": {}, "faults": {}}
    # constrain: a full tensor is sliced, a DTensor redistributed.
    x = torch.arange(16.0).reshape(4, 4)
    a = shd.constrain(x, mesh, ("data", None))
    b = shd.constrain(a, mesh, (None, "model"))
    out["constrain"] = (tuple(a.to_local().shape), tuple(b.to_local().shape),
                        bool(torch.equal(_full(b), x)),
                        tuple(b.placements) == tuple(shd.named(mesh, (None, "model"))[1]))
    for case in CASES:
        full, m, shapes_ok, stats = _sharded_case(mesh, *case)
        out["cases"][case] = {"state": _digest(full) if rank == 0 else None,
                              "metrics": _digest(m), "shapes_ok": shapes_ok,
                              "bytes": stats["bytes_sent"],
                              "same": _digest(full)["params.embed.w"]}
    gather_list, global_norm = shd.gather_list, ts.global_norm

    def skip(x, group, account=None, kind="all_gather"):
        if kind == "all_gather_grads":
            return [x] * torch.distributed.get_world_size(group)
        return gather_list(x, group, account, kind)

    def from_shards(tensors):
        # The squares summed shard by shard, of the gradients rounded to
        # bf16 first: a norm a few parts in 10^4 off.  (The reorder alone
        # leaves the float32 sum's bits as they were on some gradients.)
        sq = []
        for x in tensors:
            for part in x.to(torch.bfloat16).to(torch.float32).chunk(2, dim=0):
                sq.append(torch.sum(torch.square(part)))
        return torch.sqrt(torch.sum(torch.stack(sq)))

    for fault in FAULTS:
        if fault == "skip_dp_reduction":
            shd.gather_list = skip
        else:
            ts.global_norm = from_shards
        try:
            full, m, _, _ = _sharded_case(mesh, False, "f32", False)
        finally:
            shd.gather_list, ts.global_norm = gather_list, global_norm
        out["faults"][fault] = {"state": _digest(full), "metrics": _digest(m)}

    # Checkpoints: save the zero1 bf16 state on (2, 2); restore it on (4, 1),
    # with no shardings, and (4, 1) from the JAX package's 8-device writer.
    from repro_torch.train import shard_train_state
    cfg, params, opt, batch = _setup(False)
    _, opts = _opts(True, "bf16", False)
    specs = _specs(cfg, mesh, params, opt, batch, opts)
    p, o = shard_train_state(params, opt, specs, mesh)
    o["m"] = {k: shd.distribute(torch.randn(x.shape, generator=torch.Generator()
                                            .manual_seed(7)), mesh, specs[1]["m"][k])
              for k, x in o["m"].items()}
    ck = Checkpointer(ckpt_dir)
    ck.save(3, {"params": p, "opt": o})
    from repro_torch.checkpoint.checkpointer import _flatten
    root = os.path.join(ckpt_dir, "step_00000003")
    leaves, _ = _flatten({"params": p, "opt": o})
    files = [(len(os.listdir(os.path.join(root, f"leaf_{i:04d}"))) // 2,
              int(np.prod([mesh.mesh.shape[j] for j, pl in enumerate(x.placements)
                           if pl.is_shard()])))
             for i, x in enumerate(leaves)]
    want = _digest({"params": _full(p), "opt": _full(o)})
    mesh41 = make_test_mesh((4, 1), device_type="cpu")
    specs41 = _specs(cfg, mesh41, params, opt, batch, opts)
    target = {"params": params, "opt": opt}
    r41 = ck.restore(3, target, shardings={"params": specs41[0], "opt": specs41[1]},
                     mesh=mesh41)
    named = shd.named(mesh41, {"params": specs41[0], "opt": specs41[1]})
    r41b = ck.restore(3, target, shardings=named)
    whole = ck.restore(3, target)
    placed = all(r41["params"][k].placements == tuple(shd.placements(specs41[0][k], mesh41))
                 for k in params) and all(
        r41["opt"]["m"][k].placements == tuple(shd.placements(specs41[1]["m"][k], mesh41))
        for k in params)
    out["ckpt"] = {"files": files, "r41": _digest({"params": _full(r41["params"]),
                                                    "opt": _full(r41["opt"])}) == want,
                   "r41_named": _digest(_full(r41b)) == want,
                   "whole": _digest(whole) == want, "placed": placed,
                   "want": want if rank == 0 else None}
    if ref_ckpt is not None:
        with open(os.path.join(ref_ckpt, "tree.pkl"), "rb") as f:
            ref = pickle.load(f)
        tgt = {k: torch.empty(v.shape, dtype=torch.float32, device="meta")
               for k, v in ref["tree"].items()}
        got = Checkpointer(ref_ckpt).restore(
            1, tgt, shardings={k: tuple(s) for k, s in ref["specs41"].items()}, mesh=mesh41)
        out["ref_ckpt"] = {k: (np.array_equal(_full(got[k]).numpy(), v),
                               tuple(got[k].to_local().shape))
                           for k, v in ref["tree"].items()}
    return out


def body_1x1(rank, world, ckpt_dir):
    """A world of 1: the 1x1 mesh's step against today's step, and the
    (2, 2) checkpoint restored on (1, 1)."""
    from repro_torch.checkpoint import Checkpointer
    from repro_torch.launch.mesh import make_test_mesh
    mesh = make_test_mesh((1, 1), device_type="cpu")
    out = {}
    for case in [(False, "bf16", False), (True, "f32", True)]:
        full, m, _, _ = _sharded_case(mesh, *case)
        want, wm = single_step(*case, microbatches=1)
        out[case] = _digest(full) == _digest(want) and _digest(m) == _digest(wm)
    cfg, params, opt, batch = _setup(False)
    _, opts = _opts(True, "bf16", False)
    specs = _specs(cfg, mesh, params, opt, batch, opts)
    r = Checkpointer(ckpt_dir).restore(3, {"params": params, "opt": opt},
                                       shardings={"params": specs[0], "opt": specs[1]},
                                       mesh=mesh)
    out["ckpt"] = _digest({"params": _full(r["params"]), "opt": _full(r["opt"])})
    return out


def body_4x2(rank, world, ref_specs):
    """tests/test_distribution.py:51-86 on (data 4, model 2)."""
    from repro_torch.configs import smoke_config
    from repro_torch.data import DataConfig, SyntheticLM
    from repro_torch.launch.mesh import make_test_mesh
    from repro_torch.optim import AdamWConfig, init_opt_state
    from repro_torch.train import (TrainOptions, init_params, make_train_step, shard_batch,
                                   shard_train_state, train_shardings)
    cfg = smoke_config(ARCH)
    mesh = make_test_mesh((4, 2), device_type="cpu")
    params = init_params(cfg, device="cpu", seed=0)
    opt = init_opt_state(params)
    data = SyntheticLM(DataConfig(vocab=cfg.vocab, seq_len=32, global_batch=8))
    batch = data.batch(0)
    specs, dropped = train_shardings(cfg, mesh, params, opt, batch, TrainOptions())
    p, o = shard_train_state(params, opt, specs, mesh)
    step = make_train_step(cfg, AdamWConfig(lr=1e-3), TrainOptions(), mesh=mesh)
    p2, o2, m = step(p, o, shard_batch(batch, mesh))
    emb = p2["embed.w"]
    local = {k: tuple(x.to_local().shape) for k, x in p2.items()}
    changed = any(not torch.equal(_full(p2[k]), params[k]) for k in params)
    return {"loss": float(m["loss"]), "emb_rows": emb.to_local().shape[0],
            "vocab_rows": emb.shape[0], "local": local, "changed": changed,
            "batch_rows": {k: tuple(x.to_local().shape) for k, x in
                           shard_batch(batch, mesh).items()}}


def body_launcher(rank, world, ckpt_dir):
    """launch/train.py --zero1 --mesh 2x1 twice: the second run resumes."""
    import contextlib
    import io
    from repro_torch.launch import train as launch_train
    outs = []
    for steps in (2, 10):
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            launch_train.main(["--arch", ARCH, "--smoke", "--device", "cpu", "--zero1",
                               "--mesh", "2x1", "--steps", str(steps), "--seq", "16",
                               "--batch", "4", "--ckpt-dir", ckpt_dir])
        outs.append(buf.getvalue())
    return outs


# --------------------------------------------------------------------------- #
# The JAX package's readings (one child process, 8 CPU devices).
# --------------------------------------------------------------------------- #
_REF_CHILD = r"""
import os, pickle, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
import jax, jax.numpy as jnp, numpy as np
from jax.sharding import NamedSharding, PartitionSpec as P
from repro.checkpoint import Checkpointer
from repro.configs import smoke_config
from repro.models import init_params
from repro.train import sharding as shd

out_dir = sys.argv[1]
mesh = jax.make_mesh((4, 2), ("data", "model"))
# A tree sharded on the 8-device mesh, as the reference's trainer holds it.
rng = np.random.default_rng(3)
tree = {"a": rng.standard_normal((16, 8)).astype(np.float32),
        "b": rng.standard_normal((8, 12)).astype(np.float32),
        "c": rng.standard_normal((6,)).astype(np.float32)}
specs = {"a": P("data", "model"), "b": P(None, "model"), "c": P()}
arrs = {k: jax.device_put(v, NamedSharding(mesh, specs[k])) for k, v in tree.items()}
Checkpointer(out_dir).save(1, arrs, blocking=True)
# The reference's specs of granite-8b's smoke params on (4, 2).
cfg = smoke_config("granite-8b")
params = init_params(jax.random.PRNGKey(0), cfg)
p_specs, _ = shd.param_specs(params, mesh)
flat = {"/".join(str(getattr(e, "key", getattr(e, "idx", e))) for e in path): tuple(s)
        for path, s in jax.tree_util.tree_flatten_with_path(
            p_specs, is_leaf=lambda x: isinstance(x, P))[0]}
shapes = {"/".join(str(getattr(e, "key", getattr(e, "idx", e))) for e in path): x.shape
          for path, x in jax.tree_util.tree_flatten_with_path(params)[0]}
with open(os.path.join(out_dir, "tree.pkl"), "wb") as f:
    pickle.dump({"tree": tree, "specs41": {"a": ("data", None), "b": (None, "data"),
                                           "c": (None,)},
                 "p_specs": flat, "shapes": shapes}, f)
"""


def _ref_child(out_dir):
    env = dict(os.environ, PYTHONPATH=os.path.abspath(REPO_SRC))
    env.pop("XLA_FLAGS", None)
    return subprocess.Popen([sys.executable, "-c", _REF_CHILD, out_dir], env=env,
                            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)


@pytest.fixture(scope="module")
def groups(tmp_path_factory):
    """Every group of this module, run once: the reference child first
    (its checkpoint feeds the (2, 2) group), then the groups."""
    tmp = tmp_path_factory.mktemp("train_mesh")
    ref_dir = str(tmp / "ref_ckpt")
    child = _ref_child(ref_dir)
    log, _ = child.communicate(timeout=GROUP_TIMEOUT)
    assert child.returncode == 0, log
    with open(os.path.join(ref_dir, "tree.pkl"), "rb") as f:
        ref = pickle.load(f)
    ckpt = str(tmp / "ckpt22")
    out = {"ref": ref}
    out["2x2"] = _spawn("body_2x2", 4, tmp, ckpt, ref_dir)
    out["1x1"] = _spawn("body_1x1", 1, tmp, ckpt)
    out["4x2"] = _spawn("body_4x2", 8, tmp, ref["p_specs"])
    out["launcher"] = _spawn("body_launcher", 2, tmp, str(tmp / "launch"))
    return out


# --------------------------------------------------------------------------- #
# Tests.
# --------------------------------------------------------------------------- #
@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("case", CASES, ids=lambda c: f"zero1={c[0]}-{c[1]}-fb={c[2]}")
def test_sharded_step_equals_single_process_microbatches(groups, case):
    ranks = groups["2x2"]
    want, wm = single_step(*case, microbatches=2)
    got = ranks[0]["cases"][case]
    assert got["state"] == _digest(want)
    for r in ranks:
        assert r["cases"][case]["metrics"] == _digest(wm)
        assert r["cases"][case]["shapes_ok"]
        assert r["cases"][case]["same"] == got["state"]["params.embed.w"]
    assert got["bytes"]["all_gather_params"] > 0 and got["bytes"]["all_gather_grads"] > 0
    if case[0]:
        assert got["bytes"]["all_gather_update"] > 0


def test_constrain_slices_and_redistributes(groups):
    for r in groups["2x2"]:
        assert r["constrain"] == ((2, 4), (4, 2), True, True)


@pytest.mark.parametrize("fault", FAULTS)
def test_planted_fault_breaks_the_equality(groups, fault):
    want, wm = single_step(False, "f32", False, microbatches=2)
    got = groups["2x2"][0]["faults"][fault]
    assert got["state"] != _digest(want) or got["metrics"] != _digest(wm)
    if fault == "norm_from_shards":
        assert got["metrics"]["grad_norm"] != _digest(wm)["grad_norm"]


def test_one_by_one_mesh_is_the_one_device_step(groups):
    r = groups["1x1"][0]
    assert r[(False, "bf16", False)] and r[(True, "f32", True)]


def test_checkpoint_restores_across_meshes(groups):
    ranks = groups["2x2"]
    want = ranks[0]["ckpt"]["want"]
    for r in ranks:
        c = r["ckpt"]
        assert c["r41"] and c["r41_named"] and c["whole"] and c["placed"]
    assert groups["1x1"][0]["ckpt"] == want


def test_checkpoint_shard_files(groups):
    """Each distinct shard once: as many shard files as the mesh splits the
    leaf into (replicated mesh dims write no copies)."""
    files = groups["2x2"][0]["ckpt"]["files"]
    assert all(got == want for got, want in files), files
    assert max(w for _, w in files) == 4


def test_reference_written_sharded_checkpoint_restores(groups):
    for r in groups["2x2"]:
        got = r["ref_ckpt"]
        assert got["a"] == (True, (4, 8)) and got["b"] == (True, (8, 3)) \
            and got["c"] == (True, (6,))


def test_train_step_on_a_4x2_mesh(groups):
    """tests/test_distribution.py:51-86 on the port."""
    ref = groups["ref"]
    from repro_torch.configs import smoke_config
    from repro_torch.models.lm import layer_plan
    cfg = smoke_config(ARCH)
    cycle, n_groups, _ = layer_plan(cfg)
    for r in groups["4x2"]:
        assert np.isfinite(r["loss"]) and r["changed"]
        assert r["emb_rows"] == r["vocab_rows"] // 2
        assert r["batch_rows"]["tokens"] == (2, 32)
        for name, shape in r["local"].items():
            parts = name.split(".")
            if parts[0] == "layers":
                i = int(parts[1])
                path = f"groups/c{i % len(cycle)}/" + "/".join(parts[2:])
                spec, full = ref["p_specs"][path], ref["shapes"][path][1:]
                spec = (tuple(spec) + (None,) * (len(full) + 1))[1:len(full) + 1]
            else:
                path = "/".join(parts)
                spec, full = ref["p_specs"][path], ref["shapes"][path]
                spec = (tuple(spec) + (None,) * len(full))[:len(full)]
            sizes = {"data": 4, "model": 2}
            want = tuple(n // (sizes[s] if s else 1) for n, s in zip(full, spec))
            assert shape == want, (name, shape, want, spec)


def test_launcher_runs_and_resumes_a_sharded_run(groups):
    first, second = groups["launcher"][0]
    assert "mesh: {'data': 2, 'model': 1}" in first and "done: loss" in first
    assert "[trainer] restoring step 2" in second and "done: loss" in second

"""The port's dry run (``repro_torch.launch.dryrun``) and production mesh
(``repro_torch.launch.mesh``), on the host, in this process's fake group.

* ``tests/test_distribution.py:91-125`` on the port: granite-8b's smoke
  config, a (data 4, model 2) mesh of a fake group of 8, ``train_4k``
  shrunk to (64, 8): FLOPs above 0 and collective bytes above 0.
* The same mini cell's per-device argument bytes against the reference's
  ``compiled.memory_analysis().argument_size_in_bytes``, computed in a
  child process of the JAX package with 8 CPU devices.
* ``tests/test_distribution.py:128-136``: a fake group of 512 gives
  ``{"pod": 2, "data": 16, "model": 16}``, 256 ``{"data": 16, "model":
  16}``; a group of the wrong size is refused, naming torchrun.
* Every registry arch's smoke config runs through every shape on the
  16x16 mesh with no error record (``main(["--smoke", ...])``, exit 0).

Every test leaves no process group behind.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys

import pytest
import torch.distributed as dist

from repro_torch.configs import smoke_config
from repro_torch.launch import dryrun as dr
from repro_torch.launch.mesh import make_production_mesh, make_test_mesh

REPO_SRC = os.path.join(os.path.dirname(__file__), "..", "src")
MINI = (64, 8)


@pytest.fixture
def no_group_after():
    yield
    if dist.is_initialized():
        dist.destroy_process_group()


@pytest.fixture
def mini_shapes(monkeypatch):
    """train_4k shrunk for the mini run (the reference's test does the same
    to its SHAPES table)."""
    from repro_torch.configs import base
    monkeypatch.setitem(base.SHAPES, "train_4k", MINI)


def mini_cell():
    dr.fake_group(8)
    mesh = make_test_mesh((4, 2), device_type="cpu")
    fn, args, specs, dropped, account = dr.build_cell(smoke_config("granite-8b"),
                                                      "train_4k", mesh)
    return dr._measure(fn, args), account, dropped


_REF_CHILD = r"""
import os, json, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
import jax
from jax.sharding import NamedSharding, PartitionSpec as P
import repro.launch.dryrun as dr
import repro.configs.base as base
from repro.configs import smoke_config
# Auto axes: jax 0.9's make_mesh defaults to Explicit ones, which the
# reference's with_sharding_constraint refuses.
mesh = jax.make_mesh((4, 2), ("data", "model"),
                     axis_types=(jax.sharding.AxisType.Auto,) * 2)
base.SHAPES["train_4k"] = (64, 8)
dr.SHAPES["train_4k"] = (64, 8)
fn, args, shardings, dropped = dr.build_cell(smoke_config("granite-8b"), "train_4k", mesh)
with mesh:
    in_sh = jax.tree.map(lambda s: NamedSharding(mesh, s), shardings,
                         is_leaf=lambda x: isinstance(x, P))
    compiled = jax.jit(fn, in_shardings=in_sh).lower(*args).compile()
mem = compiled.memory_analysis()
print(json.dumps({"argument_bytes": mem.argument_size_in_bytes}))
"""


def test_dryrun_cell_mini_mesh(mini_shapes, no_group_after):
    """tests/test_distribution.py:91-125 on the port."""
    m, account, _ = mini_cell()
    assert m["flops"] > 0
    assert sum(account.values()) > 0, "the sharded step must send collectives"
    assert account["all_gather_params"] > 0 and account["all_gather_grads"] > 0
    assert m["peak_bytes"] >= m["argument_bytes"] > 0


def test_mini_cell_argument_bytes_match_the_reference(mini_shapes, no_group_after):
    env = dict(os.environ, PYTHONPATH=os.path.abspath(REPO_SRC))
    env.pop("XLA_FLAGS", None)
    child = subprocess.Popen([sys.executable, "-c", _REF_CHILD], env=env, text=True,
                             stdout=subprocess.PIPE, stderr=subprocess.PIPE)
    m, _, _ = mini_cell()
    out, err = child.communicate(timeout=300)
    assert child.returncode == 0, err[-3000:]
    ref = json.loads(out.strip().splitlines()[-1])
    # granite-8b's smoke leaves have no stacked-leaf departure: equal.
    assert m["argument_bytes"] == ref["argument_bytes"]


def test_multipod_mesh_axes(no_group_after):
    """tests/test_distribution.py:128-136 on the port."""
    dr.fake_group(512)
    m = make_production_mesh(multi_pod=True, device_type="cpu")
    assert dict(zip(m.mesh_dim_names, m.mesh.shape)) == {"pod": 2, "data": 16, "model": 16}
    dr.fake_group(256)
    m2 = make_production_mesh(device_type="cpu")
    assert dict(zip(m2.mesh_dim_names, m2.mesh.shape)) == {"data": 16, "model": 16}
    with pytest.raises(RuntimeError, match="torchrun") as err:
        make_production_mesh(multi_pod=True, device_type="cpu")
    assert "512" in str(err.value) and "fake" in str(err.value)


def test_mesh_without_a_group_is_refused():
    assert not dist.is_initialized()
    with pytest.raises(RuntimeError, match="no process group"):
        make_test_mesh((2, 2), device_type="cpu")


def test_every_smoke_config_runs_every_shape(tmp_path, no_group_after, capsys):
    out = str(tmp_path / "dryrun.json")
    assert dr.main(["--smoke", "--mesh", "single", "--no-probes", "--out", out]) == 0
    assert "no device" in capsys.readouterr().out
    with open(out) as f:
        recs = json.load(f)
    from repro_torch.configs import REGISTRY, SHAPES
    assert len(recs) == len(REGISTRY) * len(SHAPES)
    assert not [r for r in recs if r["status"] == "error"]
    ok = [r for r in recs if r["status"] == "ok"]
    assert len(ok) == len(recs) - sum(
        len(smoke_config(a).skip_shapes) for a in REGISTRY)
    for r in ok:
        assert r["memory"]["argument_bytes"] > 0 and r["flops_per_device"] > 0
        assert r["step_time_bound_s"] == max(r["roofline"].values())
        assert r["bottleneck"] in r["roofline"]
        assert "H100" in r["hardware"] and r["n_chips"] == 256
    train = [r for r in ok if r["shape"] == "train_4k"]
    assert all(r["collective_bytes_per_device"]["all_gather_grads"] > 0 for r in train)
    # A second run with the same --out resumes: every cell is done.
    assert dr.main(["--smoke", "--mesh", "single", "--out", out]) == 0
    with open(out) as f:
        assert len(json.load(f)) == len(recs)

"""The port's sharding rules (``repro_torch.train.sharding``) against the
JAX package's (``repro.train.sharding``), specs only, in the main test
process on ``AbstractMesh((16, 16), ("data", "model"))``: no devices, no
process group.

* The six tests of ``tests/test_sharding_rules.py``, on the port's leaves.
* For every registry arch: every port leaf's spec equals the reference's
  on the trailing dims (the reference stacks a cycle slot's layers on a
  leading axis, the port keeps one leaf per layer); ``dropped`` has the
  same entries up to the path spelling; ``shard_over_data`` shards the
  same leaves with the same per-device bytes except the listed departures.
* ``batch_specs`` on ``input_specs`` and ``cache_specs`` on the serving
  state of recurrentgemma-2b and qwen2-72b at decode_32k and long_500k.
"""
from __future__ import annotations

import re

import jax
import numpy as np
import pytest
import torch
from jax.sharding import AbstractMesh
from jax.sharding import PartitionSpec as P

from repro_torch.configs import REGISTRY, get_config, input_specs
from repro_torch.configs.base import SHAPES
from repro_torch.models import LM
from repro_torch.models.lm import layer_plan
from repro_torch.train import sharding as shd

ARCHS = sorted(REGISTRY)


@pytest.fixture(scope="module")
def mesh():
    return AbstractMesh((16, 16), ("data", "model"))


def port_params(arch):
    cfg = get_config(arch)
    return cfg, LM(cfg, device="meta", seed=None).state_dict()


def ref_params(arch):
    from repro.configs import get_config as ref_config
    from repro.models import abstract_params
    return abstract_params(ref_config(arch))


def ref_items(tree):
    """("/"-joined path, leaf) of a reference pytree."""
    out = []
    for path, leaf in jax.tree_util.tree_flatten_with_path(
            tree, is_leaf=lambda x: isinstance(x, P))[0]:
        out.append(("/".join(str(getattr(e, "key", getattr(e, "idx", e))) for e in path),
                    leaf))
    return out


def port_names(cfg, ref_path):
    """The port leaves of one reference leaf, and whether it is stacked."""
    cycle, n_groups, _ = layer_plan(cfg)
    parts = ref_path.split("/")
    if parts[0] == "groups":
        i = int(parts[1][1:])
        rest = ".".join(parts[2:])
        return [f"layers.{g * len(cycle) + i}.{rest}" for g in range(n_groups)], True
    if parts[0] == "rest":
        return [f"layers.{n_groups * len(cycle) + int(parts[1])}.{'.'.join(parts[2:])}"], False
    if parts[:2] == ["encoder", "blocks"]:
        rest = ".".join(parts[2:])
        return [f"encoder.blocks.{j}.{rest}" for j in range(cfg.encoder.n_layers)], True
    return [".".join(parts)], False


def pad(spec, ndim):
    """A spec as a tuple of ``ndim`` entries, a one-axis tuple as its name
    (``PartitionSpec`` spells ``("data",)`` as ``"data"``)."""
    spec = tuple(e[0] if isinstance(e, tuple) and len(e) == 1 else e for e in spec)
    return spec + (None,) * (ndim - len(spec))


def axes_of(entry):
    return () if entry is None else (entry,) if isinstance(entry, str) else tuple(entry)


def per_device_bytes(shape, itemsize, spec, sizes):
    n = int(np.prod(shape)) * itemsize
    for e in spec:
        for a in axes_of(e):
            n //= sizes[a]
    return n


def pairs(arch, ref_specs, port_specs):
    """(reference path, reference spec, stacked, port name, port spec)."""
    cfg = get_config(arch)
    out = []
    for path, spec in ref_items(ref_specs):
        names, stacked = port_names(cfg, path)
        for n in names:
            out.append((path, spec, stacked, n, port_specs[n]))
    return out


# --------------------------------------------------------------------------- #
# tests/test_sharding_rules.py, on the port's leaves.
# --------------------------------------------------------------------------- #
def test_param_specs_qwen(mesh):
    _, params = port_params("qwen2-72b")
    specs, dropped = shd.param_specs(params, mesh)
    assert specs["embed.w"] == ("model", None)
    assert specs["layers.0.attn.wq"] == (None, "model")
    assert specs["layers.79.attn.wk"] == (None, None)      # GQA KV replicated
    assert specs["layers.5.attn.wo"] == ("model", None)
    assert specs["layers.5.mlp.w_gate"] == (None, "model")
    assert not dropped


def test_param_specs_moe_expert_parallel(mesh):
    _, params = port_params("olmoe-1b-7b")
    specs, _ = shd.param_specs(params, mesh)
    assert specs["layers.0.mlp.we_gate"] == ("model", None, None)
    assert specs["layers.0.mlp.router"] == (None, None)


def test_divisibility_drops_are_recorded(mesh):
    fake = {"attn": {"wq": torch.empty(100, 33, device="meta")}}
    specs, dropped = shd.param_specs(fake, mesh)
    assert specs["attn"]["wq"] == (None, None)
    assert dropped and "33" in dropped[0]
    assert dropped[0] == "attn.wq: dim 1 (33) % model (16) != 0 -> replicated"


def test_batch_specs(mesh):
    batch = {"tokens": torch.empty(256, 4096, dtype=torch.int32, device="meta")}
    assert shd.batch_specs(batch, mesh)["tokens"] == (("data",), None)
    odd = {"tokens": torch.empty(3, 7, dtype=torch.int32, device="meta")}
    assert shd.batch_specs(odd, mesh)["tokens"] == (None, None)


def test_cache_specs_batch_vs_seq_fallback(mesh):
    caches = [{"k": torch.empty(128, 32768, 8, 128, device="meta")}]
    assert shd.cache_specs(caches, mesh)[0]["k"] == (("data",), None, None, None)
    caches2 = [{"k": torch.empty(1, 524288, 8, 128, device="meta")}]
    assert shd.cache_specs(caches2, mesh)[0]["k"] == (None, "data", None, None)
    seq = shd.cache_specs(caches, mesh, seq_axes=("model",))
    assert seq[0]["k"] == (("data",), "model", None, None)


def test_zero1_and_fsdp_upgrade(mesh):
    cfg, params = port_params("qwen2-72b")
    specs, _ = shd.param_specs(params, mesh)
    up = shd.shard_over_data(specs, params, mesh, cfg=cfg)
    assert up["layers.0.attn.wk"] != specs["layers.0.attn.wk"]
    assert up["final_norm.scale"] == (None,)
    # Judged stacked: one layer's (8192,) norm alone is under 2^16, its 80
    # stacked copies are not; the reference puts data on the stacked axis,
    # the port on the leaf's own dim.
    assert up["layers.0.norm1.scale"] == ("data",)
    assert shd.shard_over_data(specs, params, mesh)["layers.0.norm1.scale"] == (None,)


# --------------------------------------------------------------------------- #
# Every registry arch against the reference.
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("arch", ARCHS)
def test_param_specs_match_the_reference(arch, mesh):
    from repro.train import sharding as ref_shd
    cfg, params = port_params(arch)
    ref_abs = ref_params(arch)
    ref_specs, ref_dropped = ref_shd.param_specs(ref_abs, mesh)
    specs, dropped = shd.param_specs(params, mesh)
    seen = set()
    for path, rspec, stacked, name, spec in pairs(arch, ref_specs, specs):
        ndim = params[name].dim()
        full = pad(rspec, ndim + stacked)
        if stacked:
            assert full[0] is None, (path, rspec)
        assert spec == full[stacked:], (arch, path, name, rspec, spec)
        seen.add(name)
    assert seen == set(params), set(params) ^ seen
    # dropped: the same entries up to the path spelling and the stacked dim.
    norm_port = {re.sub(r"^\S+: dim \d+", "", d) for d in dropped}
    norm_ref = {re.sub(r"^\S+: dim \d+", "", d) for d in ref_dropped}
    assert norm_port == norm_ref
    paths_ref = {d.split(":")[0] for d in ref_dropped}
    paths_port = set()
    for d in dropped:
        name = d.split(":")[0]
        for path, *_ in ((p, None) for p, _ in ref_items(ref_specs)):
            if name in port_names(cfg, path)[0]:
                paths_port.add(path)
    assert paths_port == paths_ref


@pytest.mark.parametrize("arch", ARCHS)
def test_shard_over_data_matches_the_reference(arch, mesh):
    from repro.train import sharding as ref_shd
    cfg, params = port_params(arch)
    ref_abs = ref_params(arch)
    ref_specs, _ = ref_shd.param_specs(ref_abs, mesh)
    ref_up = ref_shd.shard_over_data(ref_specs, ref_abs, mesh)
    specs, _ = shd.param_specs(params, mesh)
    departures = []
    up = shd.shard_over_data(specs, params, mesh, cfg=cfg, departures=departures)
    sizes = {"data": 16, "model": 16}
    leaves = dict(ref_items(ref_abs))
    departed = {d.split(":")[0] for d in departures}
    per_ref, per_port = {}, {}
    for path, rspec, stacked, name, spec in pairs(arch, ref_up, up):
        leaf = leaves[path]
        ndim = len(leaf.shape)
        rfull = pad(rspec, ndim)
        ref_data = "data" in rfull
        port_data = "data" in spec
        if name in departed:
            assert ref_data and rfull[0] == "data" and stacked and not port_data, name
            continue
        assert ref_data == port_data, (arch, path, name, rspec, spec)
        if stacked and rfull[0] is None:
            assert spec == rfull[1:], (path, name, rspec, spec)
        elif not stacked:
            assert spec == rfull, (path, name, rspec, spec)
        itemsize = params[name].element_size()
        per_ref[path] = per_device_bytes(leaf.shape, itemsize, rfull, sizes)
        per_port[path] = per_port.get(path, 0) + per_device_bytes(
            params[name].shape, itemsize, spec, sizes)
    assert per_port == per_ref


def departure_counts(mesh):
    """Leaves the stacked-leaf rule leaves replicated, per registry arch."""
    out = {}
    for arch in ARCHS:
        cfg, params = port_params(arch)
        specs, _ = shd.param_specs(params, mesh)
        dep = []
        shd.shard_over_data(specs, params, mesh, cfg=cfg, departures=dep)
        out[arch] = len(dep)
    return out


def test_departure_count_at_16x16(mesh):
    """The count ROADMAP C's departures give for the stacked-leaf rule."""
    counts = {k: v for k, v in departure_counts(mesh).items() if v}
    # mamba2-780m's conv_w (4, 3328) and conv_b (3328,), qwen2-72b's bq
    # (8192,): their one free dim is `model`'s or is 4 long.
    assert counts == {"mamba2-780m": 96, "qwen2-72b": 80}, counts


def test_batch_specs_match_the_reference_on_input_specs(mesh):
    from repro.configs import get_config as ref_config
    from repro.configs import input_specs as ref_inputs
    from repro.train import sharding as ref_shd
    for arch in ARCHS:
        cfg = get_config(arch)
        for shape in cfg.shapes():
            port = shd.batch_specs(input_specs(cfg, shape), mesh)
            ref = ref_shd.batch_specs(ref_inputs(ref_config(arch), shape), mesh)
            for k, leaf in input_specs(cfg, shape).items():
                assert pad(port[k], leaf.dim()) == pad(ref[k], leaf.dim()), (arch, shape, k)


@pytest.mark.parametrize("arch", ["recurrentgemma-2b", "qwen2-72b"])
@pytest.mark.parametrize("shape", ["decode_32k", "long_500k"])
@pytest.mark.parametrize("seq_axes", [(), ("model",)])
def test_cache_specs_match_the_reference(arch, shape, seq_axes, mesh):
    from repro.configs import get_config as ref_config
    from repro.models import lm as ref_lm
    from repro.train import sharding as ref_shd
    cfg = get_config(arch)
    seq, batch = SHAPES[shape]
    caches = LM(cfg, device="meta", seed=None).serve_state(batch, seq, device="meta")
    port = shd.cache_specs(caches, mesh, seq_axes=seq_axes)
    ref_caches = ref_lm.serve_state(ref_config(arch), batch, seq, abstract=True)
    ref = ref_shd.cache_specs(ref_caches, mesh, seq_axes=seq_axes)
    cycle, n_groups, _ = layer_plan(cfg)
    n = 0
    for path, rspec in ref_items(ref):
        parts = path.split("/")
        stacked = parts[0] == "groups"
        layers = ([g * len(cycle) + int(parts[1][1:]) for g in range(n_groups)] if stacked
                  else [n_groups * len(cycle) + int(parts[1])])
        for li in layers:
            node = caches[li]
            for key in parts[2:]:
                node = node[key]
            pnode = port[li]
            for key in parts[2:]:
                pnode = pnode[key]
            full = pad(rspec, node.dim() + stacked)
            assert pad(pnode, node.dim()) == full[stacked:], (arch, shape, path, rspec, pnode)
            n += 1
    assert n == sum(len(shd._items(c)) for c in caches)

"""LM blocks as pipeline stages on the port (``graphs/lm_pipeline.py``,
``core/pipeline.py``), held to the JAX package at the smoke configs (CPU).

Counterpart of the reference's ``test_graphs_paper.py::
test_lm_pipeline_stage_network_matches_reference``: the same weights
(the JAX package's ``init_params`` through ``convert``) and tokens from a
numpy seed give logits within that test's ``2e-2`` (rtol = atol) of the
reference's stage network at its model, granite-8b.  mamba2-780m (the card
path's model, which that test does not run) is held at the port's LM
parity bar, ``3e-2`` (``tests/test_torch_lm.py``): its SSD layers amplify
the frameworks' bf16 rounding differences (ROADMAP hazard C3), and one
logit in 32 768 reads 0.025 against 2e-2's 0.022 there.  Inside the port
the stage network, its stream (chunked, persistent, resumed from a
snapshot) and ``pipeline_forward_reference`` agree bit for bit.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_harness import jax_literal  # noqa: F401 (fixture)

from repro_torch.configs import smoke_config
from repro_torch.convert import lm_params_from_numpy
from repro_torch.core import ExecutionPlan, pipeline_reference, pipeline_spmd
from repro_torch.graphs.lm_pipeline import (build_lm_stage_network,
                                            lm_stage_network_forward, pipeline_forward,
                                            pipeline_forward_reference, stack_stage_params)
from repro_torch.models import LM

#: Logit bars (rtol = atol): tests/test_graphs_paper.py:121 for its model,
#: tests/test_torch_lm.py's TOL for mamba2-780m.
TOL = {"granite-8b": 2e-2, "mamba2-780m": 3e-2}
STAGES = ("stage0", "stage1")


def _models(arch):
    from repro.configs import smoke_config as ref_smoke_config
    from repro.models.lm import init_params
    jcfg, cfg = ref_smoke_config(arch), smoke_config(arch)
    params = init_params(jax.random.PRNGKey(0), jcfg)
    model = LM(cfg, device="cpu", seed=None)
    model.load_state_dict(lm_params_from_numpy(cfg, jax.tree.map(np.asarray, params)))
    tokens = np.random.default_rng(0).integers(0, cfg.vocab, (4, 16)).astype(np.int32)
    return jcfg, params, cfg, model, tokens


@pytest.mark.parametrize("arch", ["granite-8b", "mamba2-780m"])
def test_lm_pipeline_stage_network_matches_reference(jax_literal, arch):
    from repro.graphs.lm_pipeline import build_lm_stage_network as ref_build
    from repro.graphs.lm_pipeline import lm_stage_network_forward as ref_forward
    jcfg, params, cfg, model, tokens = _models(arch)
    want = np.asarray(ref_forward(params, jcfg, jnp.asarray(tokens), n_stages=2))
    got = lm_stage_network_forward(model, cfg, torch.from_numpy(tokens), n_stages=2)
    tol = TOL[arch]
    np.testing.assert_allclose(got.numpy(), want, rtol=tol, atol=tol)
    oracle = pipeline_forward_reference(model, cfg, torch.from_numpy(tokens), n_stages=2)
    assert torch.equal(got, oracle)
    # Streamed: the stages accelerated, activations fed and fetched chunk
    # by chunk, as the reference streams them.  The staged embeddings are
    # equal; the fetched activations (bf16, a few units in size) are held
    # through the same final norm and unembedding, at the logits' bar.
    ref_net = ref_build(params, jcfg, jnp.asarray(tokens), n_stages=2)
    rprog = ref_net.compile(mode="static", n_iterations=2, accelerated=STAGES)
    rx = ref_net.actors["source"].init()[0]
    ref_outs = rprog.stream({"f_s0": np.asarray(rx)[:, None]})["f_out"]
    net = build_lm_stage_network(model, cfg, torch.from_numpy(tokens), n_stages=2)
    x = net.actors["source"].init()[0]
    np.testing.assert_array_equal(x.float().numpy(), np.asarray(rx, np.float32))
    outs = net.compile(mode="static", n_iterations=2, accelerated=STAGES).stream(
        {"f_s0": x[:, None]})
    from repro.models import lm as ref_lm
    from repro.models.layers import rmsnorm as ref_rmsnorm
    head = params["embed"]["w"] if jcfg.tie_embeddings else params["lm_head"]["w"]
    ref_stream_logits = np.asarray(ref_lm._unembed_masked(
        ref_rmsnorm(params["final_norm"], ref_outs[:, 0], jcfg.rms_eps), head, jcfg))
    with torch.no_grad():
        stream_logits = model._logits(outs["f_out"][:, 0])
    np.testing.assert_allclose(stream_logits.numpy(), ref_stream_logits, rtol=tol, atol=tol)
    full = net.compile(mode="static", n_iterations=4)
    assert torch.equal(outs["f_out"][:, 0], full.collect("sink", full.run().state))
    assert torch.equal(stream_logits, got)


def test_stage_stream_chunked_persistent_and_resumed_agree(tmp_path):
    """The card path's shape at smoke size: dynamic mode, 2 chunks, chunked
    and persistent, and a durable stream resumed by a fresh program from
    its chunk-1 snapshot; all bit-identical to the static run and to
    pipeline_forward_reference's activations."""
    cfg = smoke_config("mamba2-780m")
    model = LM(cfg, device="cpu", seed=0)
    tokens = torch.from_numpy(np.random.default_rng(0).integers(0, cfg.vocab, (4, 16)))
    net = build_lm_stage_network(model, cfg, tokens, n_stages=4)
    accel = tuple(f"stage{s}" for s in range(4))
    x = net.actors["source"].init()[0]
    feeds = {"f_s0": x[:, None]}
    prog = net.compile(mode="dynamic", n_iterations=2, accelerated=accel)
    chunked = prog.stream(feeds)["f_out"]
    assert prog.stats().last_stream_chunks == 2
    assert prog.last_stream_fire_counts["stage3"] == 4
    persistent = prog.stream(feeds, persistent=True)["f_out"]
    assert torch.equal(chunked, persistent)
    full = net.compile(mode="static", n_iterations=4)
    y = full.collect("sink", full.run().state)
    assert torch.equal(chunked[:, 0], y)
    stages = stack_stage_params(model, cfg, 4)
    want = pipeline_reference(lambda layers, v: _stage(model, layers, v), stages, x)
    assert torch.equal(y, want)
    ck = str(tmp_path / "ck")
    prog.stream(feeds, checkpoint_dir=str(tmp_path / "whole"))
    import shutil
    from repro_torch.checkpoint import stream_checkpoint_steps
    assert stream_checkpoint_steps(str(tmp_path / "whole")) == [1, 2]
    shutil.copytree(str(tmp_path / "whole" / "chunk_00000001"),
                    str(tmp_path / "ck" / "chunk_00000001"))
    fresh = net.compile(mode="dynamic", n_iterations=2, accelerated=accel)
    resumed = fresh.resume_stream(ck, feeds)["f_out"]
    assert resumed.dtype == torch.bfloat16 and torch.equal(resumed, chunked)
    assert fresh.last_stream_fire_counts == prog.last_stream_fire_counts


def _stage(model, layers, x):
    with torch.no_grad():
        for blk in layers:
            x = model._block(blk, x[None], mode="train")[0][0]
    return x


def test_unported_and_refused_plans_name_their_items():
    cfg = smoke_config("granite-8b")
    model = LM(cfg, device="cpu", seed=0)
    tokens = torch.zeros((2, 8), dtype=torch.int64)
    # Ported (ROADMAP A12, test_torch_pipeline_mesh.py): without a mesh
    # both refuse, naming what they need.
    with pytest.raises(ValueError, match="DeviceMesh"):
        pipeline_forward(model, cfg, tokens, mesh=None, n_stages=2)
    with pytest.raises(ValueError, match="DeviceMesh"):
        pipeline_spmd(lambda p, v: v, [None], tokens[:, None], mesh=None)
    net = build_lm_stage_network(model, cfg, tokens, n_stages=2)
    # Megakernel mode runs (ported): a B2 run that stops at each stage firing.
    full = net.compile(mode="static", n_iterations=2)
    mk = net.compile(mode="megakernel", specialize=False)
    assert torch.equal(mk.collect("sink", mk.run().state),
                       full.collect("sink", full.run().state))
    with pytest.raises(ValueError, match="accelerated"):
        lm_stage_network_forward(model, cfg, tokens, 2,
                                 plan=ExecutionPlan(mode="static", n_iterations=2,
                                                    accelerated=STAGES))
    with pytest.raises(ValueError, match="not divisible into 3 stages"):
        stack_stage_params(model, cfg, 3)


@pytest.mark.parametrize("arch", ["granite-8b", "mamba2-780m"])
def test_lm_stage_network_in_megakernel_mode_is_the_static_run(arch):
    """The stage network in megakernel mode (kernel B2's plain version on
    the CPU: the source and sink as B2's copy bodies on bf16 windows, each
    stage a step the runner fires between launches), specialized or not
    and at two grid cores, and its megakernel stream, chunked and
    persistent: activations bit for bit the static run's, every stage
    firing once a microbatch."""
    cfg, model = _models(arch)[2:4]
    tokens = torch.from_numpy(np.random.default_rng(3).integers(0, cfg.vocab, (4, 8)))
    net = build_lm_stage_network(model, cfg, tokens, n_stages=2)
    full = net.compile(mode="static", n_iterations=4)
    want = full.collect("sink", full.run().state)
    for kw in (dict(), dict(specialize=False), dict(cores=2)):
        prog = net.compile(ExecutionPlan(mode="megakernel", **kw))
        res = prog.run()
        assert res.fire_counts == dict.fromkeys(("source", "stage0", "stage1", "sink"), 4)
        assert torch.equal(prog.collect("sink", res.state), want), kw
    prog = net.compile(mode="megakernel", n_iterations=2, accelerated=STAGES,
                       specialize=False)
    feeds = {"f_s0": net.actors["source"].init()[0][:, None]}
    for persistent in (False, True):
        got = prog.stream(feeds, persistent=persistent)["f_out"][:, 0]
        assert got.dtype == torch.bfloat16 and torch.equal(got, want), persistent


def test_rest_plans_refused_as_the_reference(jax_literal):
    """A layer plan with a remainder (recurrentgemma-2b: 26 layers in a
    cycle of 3) is refused by both packages; at smoke widths with 5
    layers here, and at the published config's plan."""
    import dataclasses
    from repro.configs import smoke_config as ref_smoke_config
    from repro.graphs.lm_pipeline import stack_stage_params as ref_stack
    from repro.models.lm import layer_plan as ref_plan
    from repro_torch.configs import get_config
    from repro_torch.models import layer_plan
    assert layer_plan(get_config("recurrentgemma-2b"))[1:] == (8, ["rec", "rec"])
    jcfg = dataclasses.replace(ref_smoke_config("recurrentgemma-2b"), n_layers=5)
    cfg = dataclasses.replace(smoke_config("recurrentgemma-2b"), n_layers=5)
    assert ref_plan(jcfg)[1:] == layer_plan(cfg)[1:] == (1, ["rec", "rec"])
    with pytest.raises(ValueError, match="rest-free"):
        ref_stack({}, jcfg, 1)
    with pytest.raises(ValueError, match="rest-free"):
        stack_stage_params(LM(cfg, device="cpu", seed=0), cfg, 1)

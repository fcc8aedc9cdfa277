"""``pipeline_spmd`` and ``pipeline_forward`` over a process group on the
port (``core/pipeline.py``, ``graphs/lm_pipeline.py``), against the JAX
package's ``pipeline_reference`` and ``pipeline_forward_reference`` on
the CPU.

One gloo group of 4 spawned ranks (``spawn_group``, a ``file://``
rendezvous under ``tmp_path`` and a deadline), each holding a
``DeviceMesh`` whose dimension ``"stage"`` names the pipeline:

* ``pipeline_spmd`` on the reference test's own inputs
  (``tests/test_distribution.py::test_pipeline_spmd_matches_reference``:
  ``tanh(x @ w + b)`` over 4 stages, 8 microbatches) within its 1e-5 of the
  reference's ``pipeline_reference``, and bit for bit the port's;
* ``pipeline_forward`` on granite-8b's smoke config cut to 4 layers, in 4
  stages with 6 microbatches (``test_lm_pipeline_parallel_matches_
  reference``), within that test's 3e-2 of the reference's
  ``pipeline_forward_reference`` on the same weights, and bit for bit the
  port's ``pipeline_forward_reference``.

Every rank returns the whole result.  This module imports neither jax nor
the JAX package at import time: the ranks import it to find their body.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.launch.group import spawn_group

N_STAGES = 4


def _granite(params):
    from repro_torch.configs import smoke_config
    from repro_torch.convert import lm_params_from_numpy
    from repro_torch.models import LM
    cfg = dataclasses.replace(smoke_config("granite-8b"), n_layers=4)
    model = LM(cfg, device="cpu", seed=None)
    model.load_state_dict(lm_params_from_numpy(cfg, params))
    return cfg, model


def _stage_fn(p, x):
    return torch.tanh(x @ p["w"] + p["b"])


def body_pipelines(rank, world, spmd, lm):
    from torch.distributed.device_mesh import init_device_mesh
    from repro_torch.core import pipeline_spmd
    from repro_torch.graphs.lm_pipeline import pipeline_forward
    mesh = init_device_mesh("cpu", (world,), mesh_dim_names=("stage",))
    params, mb = spmd
    got = pipeline_spmd(_stage_fn, {k: torch.tensor(v) for k, v in params.items()},
                        torch.tensor(mb), mesh, axis="stage")
    lm_params, tokens = lm
    cfg, model = _granite(lm_params)
    logits = pipeline_forward(model, cfg, torch.tensor(tokens), mesh,
                              n_stages=world, axis="stage")
    return got.numpy(), logits.float().numpy()


@pytest.fixture(scope="module")
def inputs():
    """The reference tests' inputs, drawn with jax.random as they draw
    them, and the reference's outputs on them."""
    import jax
    import jax.numpy as jnp
    from repro.configs import smoke_config as ref_smoke_config
    from repro.core.pipeline import pipeline_reference
    from repro.graphs.lm_pipeline import pipeline_forward_reference
    from repro.models import init_params
    key = jax.random.PRNGKey(0)
    params = {"w": jax.random.normal(key, (4, 16, 16)) * 0.5, "b": jnp.zeros((4, 16))}
    mb = jax.random.normal(key, (8, 16))
    want_spmd = pipeline_reference(lambda p, x: jnp.tanh(x @ p["w"] + p["b"]), params, mb)
    jcfg = dataclasses.replace(ref_smoke_config("granite-8b"), n_layers=4)
    lm_params = init_params(key, jcfg)
    toks = jax.random.randint(key, (6, 16), 0, jcfg.vocab)
    want_lm = pipeline_forward_reference(lm_params, jcfg, toks, n_stages=N_STAGES)
    spmd = ({k: np.asarray(v) for k, v in params.items()}, np.asarray(mb))
    lm = (jax.tree.map(np.asarray, lm_params), np.asarray(toks))
    return spmd, lm, np.asarray(want_spmd), np.asarray(want_lm, np.float32)


@pytest.fixture(scope="module")
def ranks(inputs, tmp_path_factory):
    spmd, lm, _, _ = inputs
    return spawn_group("test_torch_pipeline_mesh:body_pipelines", N_STAGES,
                       str(tmp_path_factory.mktemp("pipeline_mesh")), args=(spmd, lm),
                       timeout=240, threads=1)


def test_pipeline_spmd_matches_reference(inputs, ranks):
    (params, mb), _, want, _ = inputs
    from repro_torch.core import pipeline_reference
    port = pipeline_reference(_stage_fn, {k: torch.tensor(v) for k, v in params.items()},
                              torch.tensor(mb)).numpy()
    for got, _ in ranks:
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
        np.testing.assert_array_equal(got, port)


def test_pipeline_forward_matches_reference(inputs, ranks):
    _, (lm_params, tokens), _, want = inputs
    from repro_torch.graphs.lm_pipeline import pipeline_forward_reference
    cfg, model = _granite(lm_params)
    port = pipeline_forward_reference(model, cfg, torch.tensor(tokens),
                                      n_stages=N_STAGES).float().numpy()
    assert port.shape == want.shape and port.shape[:2] == (6, 16)
    for _, got in ranks:
        np.testing.assert_allclose(got, want, rtol=3e-2, atol=3e-2)
        np.testing.assert_array_equal(got, port)


def test_stage_slice_reads_lists_and_stacked_trees():
    from repro_torch.core.pipeline import stage_slice
    stacked = {"w": torch.arange(6).reshape(3, 2), "b": (torch.arange(3),)}
    s1 = stage_slice(stacked, 1)
    assert s1["w"].tolist() == [2, 3] and s1["b"][0].item() == 1
    assert stage_slice(["a", "b"], 1) == "b"

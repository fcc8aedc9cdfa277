"""The port's MoE actor network (``graphs/moe_as_actors.py``) against the
JAX package's, on the reference's own weights and token stream
(``make_moe``'s: ``moe_init`` and a normal stream from ``PRNGKey(seed)``).

* dynamic mode against the reference's ``compile_dynamic``, and megakernel
  mode (kernel B2's plain version, ``core/megakernel/ref.py``) against the
  reference's ``compile_megakernel`` (Pallas interpret mode), at
  ``make_moe(2)`` and ``make_moe(3)``: fire counts, sweeps, cursors and
  integer tokens (slots, counts, the packed token) exactly, floats within
  ``REL_TOL`` of the leaf's largest magnitude per plane;
* the structure: the register set with the three data channels the
  matched-rates proof finds (``f_out``, ``f_slot``, ``f_w``), the
  megakernel's 3 sweeps, 37 148 scratch bytes and 8 forwarded channels at
  ``make_moe(3)``, at cores 1 and 2;
* the network's output against ``moe_layer``'s (the reference's own
  consistency test, ``tests/test_models_consistency.py``);
* B2's plain version against the host dynamic run: the same structure,
  floats within ``REL_TOL`` (its products sum term by term in float32,
  where the host bodies use ``torch.matmul``), and at a middle width;
* every dynamic actor's declared enables against its ``control``.
"""
from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import ExecutionPlan as RefPlan
from repro.graphs.moe_as_actors import build_moe_network as ref_build_moe
from repro.models.moe import moe_init as ref_moe_init
from repro.models.moe import moe_layer as ref_moe_layer
from repro_torch.convert import tensor_from_numpy
from repro_torch.core.builder import check_declared_enables
from repro_torch.graphs.factories import make_dpd, make_moe
from repro_torch.graphs.moe_as_actors import build_moe_network
from repro_torch.models.moe import moe_layer
from test_torch_harness import REL_TOL, assert_runs_match, jax_literal  # noqa: F401

DEFAULTS = dict(n_tokens=16, d_model=32, n_experts=4, top_k=2, d_ff=64,
                capacity_factor=2.0)


def _ref_inputs(n_firings, seed=0, n_tokens=16, d_model=32, n_experts=4, d_ff=64, **_):
    key = jax.random.PRNGKey(seed)
    params = ref_moe_init(key, d_model, n_experts, d_ff)
    xs = jax.random.normal(key, (n_firings * n_tokens, d_model), jnp.float32)
    return params, xs


def _pair(n_firings, **kw):
    """(reference network, port network on the CPU) on the same weights;
    the caller aliases ``jax.core.Literal`` (``jax_literal``)."""
    cfg = {**DEFAULTS, **kw}
    params, xs = _ref_inputs(n_firings, **cfg)
    args = (cfg["n_tokens"], cfg["d_model"], cfg["top_k"], cfg["capacity_factor"],
            n_firings)
    ref = ref_build_moe(params, *args, xs)
    port = build_moe_network({k: tensor_from_numpy(np.asarray(v)) for k, v in params.items()},
                             *args, tensor_from_numpy(np.asarray(xs)), device="cpu")
    return ref, port


@pytest.fixture(scope="module")
def pairs():
    cache = {}

    def get(n_firings):
        if n_firings not in cache:
            with pytest.MonkeyPatch.context() as mp:
                if not hasattr(jax.core, "Literal"):
                    from jax.extend.core import Literal
                    mp.setattr(jax.core, "Literal", Literal, raising=False)
                cache[n_firings] = _pair(n_firings)
        return cache[n_firings]

    return get


def test_structure_equals_reference(pairs):
    ref, port = pairs(3)
    assert list(port.actors) == list(ref.actors)
    assert list(port.fifos) == list(ref.fifos)
    for name, rs in ref.fifos.items():
        ps = port.fifos[name]
        assert (ps.rate, tuple(ps.token_shape), ps.is_control, ps.delay,
                ps.capacity_tokens, ps.token_size_bytes) == \
            (rs.rate, tuple(rs.token_shape), rs.is_control, rs.delay,
             rs.capacity_tokens, rs.token_size_bytes), name
        assert str(ps.dtype).split(".")[-1] == str(jnp.dtype(rs.dtype)), name
    for name, a in ref.actors.items():
        assert port.actors[name].in_ports == a.in_ports
        assert port.actors[name].out_ports == a.out_ports
        assert port.actors[name].control_port == a.control_port
    assert port.register_fifos == ref.register_fifos
    assert {"f_out", "f_slot", "f_w"} <= port.register_fifos
    assert len(port.register_fifos) == 8


@pytest.mark.parametrize("n_firings", [2, 3])
def test_dynamic_matches_reference(pairs, n_firings):
    ref, port = pairs(n_firings)
    assert_runs_match(ref.compile(RefPlan(mode="dynamic")).run(),
                      port.compile(mode="dynamic").run())


@pytest.mark.parametrize("cores", [1, 2])
@pytest.mark.parametrize("n_firings", [2, 3])
def test_megakernel_matches_reference(pairs, n_firings, cores):
    ref, port = pairs(n_firings)
    rprog = ref.compile(RefPlan(mode="megakernel", cores=cores))
    rres = rprog.run()
    pprog = port.compile(mode="megakernel", cores=cores)
    pres = pprog.run()
    assert_runs_match(rres, pres)
    rst, pst = rprog.stats(), pprog.stats()
    for field in ("scratch_bytes", "forwarded_fifos", "register_fifos",
                  "shared_scratch_bytes", "reclaimed_scratch_bytes",
                  "partition_actors", "last_sweeps"):
        assert getattr(pst, field) == getattr(rst, field), field
    if n_firings == 3 and cores == 1:
        assert (pst.last_sweeps, pst.scratch_bytes, len(pst.forwarded_fifos)) == \
            (3, 37148, 8)


@pytest.mark.parametrize("cores", [1, 2])
def test_megakernel_plain_version_against_port_dynamic(cores):
    net, n = make_moe(3, device="cpu")
    dyn = net.compile(mode="dynamic").run()
    mega = net.compile(mode="megakernel", cores=cores).run()
    assert (mega.sweeps, mega.fire_counts) == (dyn.sweeps, dyn.fire_counts)
    for a, b in zip(dyn.state.leaves(), mega.state.leaves()):
        if isinstance(a, torch.Tensor) and a.dtype.is_floating_point:
            assert (a - b).abs().max() <= REL_TOL * max(float(a.abs().max()), 1e-30)
        elif isinstance(a, torch.Tensor):
            assert torch.equal(a, b)
        else:
            assert a == b


def test_middle_width_plain_version_against_port_dynamic():
    """D 256, E 8 (the width the card test holds B2 to its plain version
    at), with tokens that leave one expert idle."""
    net, n = make_moe(2, d_model=256, n_experts=8, seed=3, device="cpu")
    dyn = net.compile(mode="dynamic").run()
    mega = net.compile(mode="megakernel").run()
    assert (mega.sweeps, mega.fire_counts) == (dyn.sweeps, dyn.fire_counts)
    y, z = dyn.state.actor("sink")[0], mega.state.actor("sink")[0]
    assert (y - z).abs().max() <= REL_TOL * float(y.abs().max())


def test_network_equals_moe_layer(pairs):
    """As ``tests/test_models_consistency.py`` holds the reference: the
    actor network's output is ``moe_layer`` window by window."""
    ref, port = pairs(3)
    params, xs = _ref_inputs(3)
    tp = {k: tensor_from_numpy(np.asarray(v)) for k, v in params.items()}
    tx = tensor_from_numpy(np.asarray(xs))
    want = torch.cat([moe_layer(tp, tx[f * 16:(f + 1) * 16][None], top_k=2,
                                capacity_factor=2.0)[0][0] for f in range(3)])
    ref_want = np.concatenate([np.asarray(ref_moe_layer(
        params, xs[f * 16:(f + 1) * 16][None], top_k=2, capacity_factor=2.0)[0][0])
        for f in range(3)])
    np.testing.assert_allclose(want.numpy(), ref_want, rtol=1e-5, atol=1e-5)
    for mode, kw in (("static", dict(n_iterations=3)), ("dynamic", {}),
                     ("megakernel", {})):
        res = port.compile(mode=mode, **kw).run()
        got = res.state.actor("sink")[0]
        np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-5, atol=1e-5)


def test_declared_enables_agree_with_control():
    moe, _ = make_moe(2, device="cpu")
    dpd, _ = make_dpd(4, block_l=64, device="cpu")
    for net in (moe, dpd):
        for a in net.actors.values():
            if a.is_dynamic:
                check_declared_enables(a, net.control_specs[a.name][0])
    a = moe.actors["combine"]
    bad = dataclasses.replace(a, enables={**a.enables, "y1": (1, 1)})
    with pytest.raises(ValueError, match="declares enable"):
        check_declared_enables(bad, moe.control_specs["combine"][0])
    a = dpd.actors["poly3"]
    bad = dataclasses.replace(a, enables={"in": (0, 3), "out": (0, 4)})
    with pytest.raises(ValueError, match="declares enable"):
        check_declared_enables(bad, dpd.control_specs["poly3"][0])


def test_guarded_and_traced_megakernel_equal_dynamic():
    net, _ = make_moe(3, device="cpu")
    dyn = net.compile(mode="dynamic", guards=True, trace=True).run()
    for cores in (1, 2):
        mk = net.compile(mode="megakernel", cores=cores, specialize=False,
                         guards=True, trace=True).run()
        assert (mk.sweeps, mk.fire_counts) == (dyn.sweeps, dyn.fire_counts)
        assert mk.diagnostics.ok and dyn.diagnostics.ok
        assert mk.diagnostics.high_water == dyn.diagnostics.high_water
        assert mk.trace.n_events == dyn.trace.n_events
        assert mk.trace.attempt_counts() == dyn.trace.attempt_counts()
        for name in net.fifos:
            assert np.array_equal(mk.trace.occupancy(name), dyn.trace.occupancy(name))


def test_control_token_stream_is_exact():
    """The counts and the packed token on the host control rings, and the
    slots, are integers: equal across host and megakernel runs."""
    net, _ = make_moe(3, device="cpu")
    dyn = net.compile(mode="dynamic", specialize=False).run()
    mk = net.compile(mode="megakernel", specialize=False).run()
    for name, spec in net.fifos.items():
        if spec.dtype == torch.int32:
            assert torch.equal(dyn.state.fifo(name).buf, mk.state.fifo(name).buf), name

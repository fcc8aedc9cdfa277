"""B2's guarded build (``ExecutionPlan(mode="megakernel", guards=True)``)
on bf16 and f16 data channels, on the CPU (B2's plain version,
``core/megakernel/ref.py``).

* The LM stage network (mamba2-780m's smoke config, 2 stages, bf16
  channels) as the reference runs it: its megakernel's ``Diagnostics`` with
  guards (ok, faults by channel and kind, high-water marks), clean and with
  a NaN planted in one embedding row, equal the port's megakernel and
  dynamic mode's; the clean guarded state is the unguarded run's bit for
  bit.
* Copy bodies (source -> fork -> two sinks) on bf16 and f16 channels, at
  cores 1 and 2: an Inf token is NONFINITE on every channel it crosses; a
  declared domain is compared in the channel's type, so a bf16 token
  1.0078125 against ``hi = 1.006`` (which rounds up to it) is in the domain,
  as the reference's ``_domain_bit`` judges it, and the next token up is
  not.  Tokens of 3, 6 and 8 halves (windows moved in 2-, 4- and 16-byte
  words; a window of an odd count of halves ends mid-word).  The network
  and its cases are ``tests/test_torch_kernels_cuda.py``'s, which runs
  them on the card (``-k half_guards``).
"""
from __future__ import annotations

from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_harness import jax_literal  # noqa: F401 (fixture)
from test_torch_health import _diag_tuple, _outcome
from test_torch_kernels_cuda import (HALF_CASES, HALF_IDS, HALF_ROUNDING, HALF_WANT,
                                     half_copy_chain, half_values)

from repro_torch.configs import smoke_config
from repro_torch.convert import lm_params_from_numpy
from repro_torch.core import ExecutionPlan, NetworkFaultError
from repro_torch.graphs.factories import states_equal
from repro_torch.graphs.lm_pipeline import build_lm_stage_network
from repro_torch.models import LM

ARCH = "mamba2-780m"
#: The planted NaN: microbatch 1, position 3's token has a NaN in its row.
NAN_AT = (1, 3)


@pytest.fixture(scope="module")
def lm_models():
    from repro.configs import smoke_config as ref_smoke_config
    from repro.models.lm import init_params
    jcfg, cfg = ref_smoke_config(ARCH), smoke_config(ARCH)
    params = jax.tree.map(np.asarray, init_params(jax.random.PRNGKey(0), jcfg))
    tokens = np.random.default_rng(0).integers(0, cfg.vocab, (3, 8)).astype(np.int32)
    return jcfg, cfg, params, tokens


@pytest.mark.parametrize("planted", [False, True], ids=["clean", "nan_embedding"])
def test_lm_stage_network_guarded_megakernel_equals_reference(jax_literal, lm_models,
                                                              planted):
    from repro.core import ExecutionPlan as RefPlan
    from repro.core import NetworkFaultError as RefFaultError
    from repro.graphs.lm_pipeline import build_lm_stage_network as ref_build
    jcfg, cfg, params, tokens = lm_models
    if planted:
        w = params["embed"]["w"].copy()
        w[tokens[NAN_AT]] = np.nan
        params = {**params, "embed": {**params["embed"], "w": w}}
    ref_net = ref_build(jax.tree.map(jnp.asarray, params), jcfg, jnp.asarray(tokens), 2)
    _, ref_diag = _outcome(ref_net.compile(RefPlan(mode="megakernel", guards=True)), None,
                           RefFaultError)
    model = LM(cfg, device="cpu", seed=None)
    model.load_state_dict(lm_params_from_numpy(cfg, params))
    net = build_lm_stage_network(model, cfg, torch.from_numpy(tokens), 2)
    assert {s.dtype for s in net.fifos.values()} == {torch.bfloat16}
    mk, mk_diag = _outcome(net.compile(ExecutionPlan(mode="megakernel", guards=True)), None,
                           NetworkFaultError)
    dyn, dyn_diag = _outcome(net.compile(ExecutionPlan(mode="dynamic", guards=True)), None,
                             NetworkFaultError)
    assert _diag_tuple(mk_diag) == _diag_tuple(dyn_diag) == _diag_tuple(ref_diag)
    assert (mk.fire_counts, mk.sweeps) == (dyn.fire_counts, dyn.sweeps)
    if planted:
        assert {f.fifo: f.faults for f in mk_diag.faults} == {
            n: ("NONFINITE",) for n in ("f_s0", "f_s1", "f_out")}
    else:
        assert mk_diag.ok and mk_diag.high_water == {"f_s0": 2, "f_s1": 2, "f_out": 2}
        plain = net.compile(mode="megakernel").run()
        assert states_equal(mk.state, plain.state)
        assert states_equal(mk.state, dyn.state)


@pytest.mark.parametrize("cores", [1, 2])
@pytest.mark.parametrize("dt,width,case", HALF_CASES, ids=HALF_IDS)
def test_copy_bodies_guarded_on_half_channels(dt, width, case, cores):
    _, hi = HALF_ROUNDING[dt]
    values = half_values(dt, width, case)
    net = half_copy_chain(values, (-1.0, hi) if case.startswith("domain") else None)
    mk, mk_diag = _outcome(net.compile(ExecutionPlan(mode="megakernel", guards=True,
                                                     cores=cores)), None, NetworkFaultError)
    dyn, dyn_diag = _outcome(net.compile(ExecutionPlan(mode="dynamic", guards=True)), None,
                             NetworkFaultError)
    assert _diag_tuple(mk_diag) == _diag_tuple(dyn_diag)
    want = HALF_WANT[case]
    assert {f.fifo: f.faults for f in mk_diag.faults} == (
        {} if want is None else {f: (want,) for f in ("f_in", "f_a", "f_b")})
    plain = net.compile(ExecutionPlan(mode="megakernel", cores=cores)).run()
    assert states_equal(mk.state, plain.state) and states_equal(mk.state, dyn.state)
    for sink in ("sink_a", "sink_b"):
        assert torch.equal(mk.state.actor(sink)[0].view(torch.int16), values.view(torch.int16))


@pytest.mark.parametrize("dt", list(HALF_ROUNDING), ids=["bf16", "f16"])
def test_rounded_bound_is_the_references_judgment(dt):
    """The bound rounds up to ``t`` in the channel's type: the reference's
    ``_domain_bit`` reads ``t`` in the domain and the next token up out."""
    from repro.core.health import DOMAIN, _domain_bit
    t, hi = HALF_ROUNDING[dt]
    jdt = {torch.bfloat16: jnp.bfloat16, torch.float16: jnp.float16}[dt]
    spec = SimpleNamespace(domain=(-1.0, hi))
    inside = _domain_bit(spec, jnp.asarray([t], jdt), jnp.bool_(True))
    above = _domain_bit(spec, jnp.asarray([2 * t - 1], jdt), jnp.bool_(True))
    assert (int(inside), int(above)) == (0, DOMAIN)
    assert float(np.float32(hi)) < t   # float32 bits of hi would read t outside

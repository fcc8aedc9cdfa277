"""The port's MoE layer (``models/moe.py``) and MoE language models against
the JAX package's, on the reference's weights (``moe_init``,
``init_params``) and numpy-seeded inputs.

* ``moe_layer`` on float32 tokens, with and without ``local_groups``:
  the routing (experts, ranks, kept assignments) exactly, the output and
  the aux within 1e-5;
* on bf16 tokens: the logits within one bf16 step of their largest
  magnitude (the reference, run op by op, rounds them to bf16; jitted, as
  in its LM, it keeps them in float32 as the port does), the routing exactly wherever the
  k-th to (k+1)-th logit margin exceeds twice the two backends' largest
  logit difference, and the dispatch, experts and combine fed the
  reference's routing within the bf16 bar (3e-2, as
  ``tests/test_torch_lm.py``);
* olmoe-1b-7b's and granite-moe-3b-a800m's smoke configs against the
  JAX package's ``lm``: each MoE layer's router logits, computed by the
  port on the reference's own layer input, within 1e-5 of the
  reference's, and its routing equal wherever the k-th to (k+1)-th logit
  margin exceeds twice their largest difference; then the whole model
  (train logits and the load-balance aux, prefill logits, every
  serving-state leaf, two decode steps) within the bf16 bar, fed the
  reference's routing layer by layer (``LM.forward(routing=)``): the
  rounding differences the layers carry would otherwise flip near-ties
  in later layers' top-k, and a flip moves a token's output by far more
  than any rounding bar.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import moe as ref_moe
from repro.models.lm import forward as ref_forward
from repro_torch.configs import smoke_config
from repro_torch.convert import tensor_from_numpy
from repro_torch.models import LM
from repro_torch.models import moe
from test_torch_lm import close, models, np_tree

MOE_ARCHS = ["olmoe-1b-7b", "granite-moe-3b-a800m"]


def _params(D=32, E=8, F=48, seed=0):
    p = ref_moe.moe_init(jax.random.PRNGKey(seed), D, E, F)
    return p, {k: tensor_from_numpy(np.asarray(v)) for k, v in p.items()}


def _ref_routing(params, xt, k):
    """The reference's routing steps (``_dispatch_combine``'s first lines)."""
    logits = (xt @ params["router"]).astype(jnp.float32)
    probs = jax.nn.softmax(logits, axis=-1)
    gate_w, gate_e = jax.lax.top_k(probs, k)
    gate_w = gate_w / jnp.maximum(gate_w.sum(-1, keepdims=True), 1e-9)
    E = logits.shape[-1]
    onehot = jax.nn.one_hot(gate_e, E, dtype=jnp.int32)
    lead = logits.shape[:-2]
    N = logits.shape[-2]
    flat = onehot.reshape(*lead, N * k, E)
    ranks = (jnp.cumsum(flat, axis=-2) - flat).reshape(*lead, N, k, E)
    rank = jnp.sum(ranks * onehot, axis=-1)
    return logits, probs, gate_e, gate_w, rank


@pytest.mark.parametrize("groups", [0, 4])
@pytest.mark.parametrize("cf", [1.25, 0.5])
def test_moe_layer_float32_matches_reference(groups, cf):
    jp, tp = _params()
    x = np.random.default_rng(1).normal(size=(2, 32, 32)).astype(np.float32)
    want, want_aux = ref_moe.moe_layer(jp, jnp.asarray(x), top_k=2, capacity_factor=cf,
                                       local_groups=groups)
    got, got_aux = moe.moe_layer(tp, torch.tensor(x), top_k=2, capacity_factor=cf,
                                 local_groups=groups)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)
    for key in ("load_balance_loss", "dropped_frac"):
        np.testing.assert_allclose(float(got_aux[key]), float(want_aux[key]),
                                   rtol=1e-5, atol=1e-6)
    # The routing itself, exactly.
    xt = x.reshape(64, 32)
    if groups:
        xt = xt.reshape(groups, 64 // groups, 32)
    _, _, ge, _, rk = _ref_routing(jp, jnp.asarray(xt), 2)
    r = moe.route(moe.router_logits(tp["router"], torch.tensor(xt)), 2)
    assert np.array_equal(r.gate_e.numpy(), np.asarray(ge))
    assert np.array_equal(r.rank.numpy(), np.asarray(rk))


def test_capacity_matches_reference():
    for n, e, k, cf in ((16, 4, 2, 2.0), (512, 64, 8, 1.25), (16384, 64, 8, 1.25),
                        (7, 3, 1, 0.1)):
        assert moe.capacity_for(n, e, k, cf) == ref_moe.capacity_for(n, e, k, cf)
    assert moe.capacity_for(512, 64, 8, 1.25) == 80
    assert moe.capacity_for(4 * 4096, 64, 8, 1.25) == 2560


def _assert_routing_under_margin(lt, lj, ge, k, tol=1e-5):
    """Port logits ``lt`` within ``tol`` of the reference's ``lj`` (scaled
    to their largest magnitude),
    and the port's top-k equal to the reference's ``ge`` at every token
    whose k-th to (k+1)-th logit margin exceeds twice the largest logit
    difference; returns the number of tokens under the margin."""
    lj = np.asarray(lj, np.float32)
    diff = np.abs(lt.numpy() - lj).max()
    assert diff <= tol * np.abs(lj).max()
    srt = np.sort(lj, axis=-1)[..., ::-1]
    clear = srt[..., k - 1] - srt[..., k] > 2 * diff
    same = (moe.route(lt, k).gate_e.numpy() == np.asarray(ge)).all(-1)
    assert same[clear].all()
    return int((~clear).sum())


@pytest.mark.parametrize("groups", [0, 2])
def test_moe_layer_bf16_under_the_margin_rule(groups):
    jp, tp = _params(seed=2)
    x = np.random.default_rng(3).normal(size=(2, 24, 32)).astype(np.float32)
    jx, tx = jnp.asarray(x, jnp.bfloat16), torch.tensor(x).to(torch.bfloat16)
    xt_j = jx.reshape(48, 32)
    xt_t = tx.reshape(48, 32)
    if groups:
        xt_j, xt_t = xt_j.reshape(groups, -1, 32), xt_t.reshape(groups, -1, 32)
    lj, pj, ge, gw, rk = _ref_routing(jp, xt_j, 2)
    lt = moe.router_logits(tp["router"], xt_t)
    # Run op by op, the reference rounds the logits to bf16 before its cast
    # (under jit XLA keeps them in float32, as the port does): one step.
    _assert_routing_under_margin(lt, lj, ge, 2, tol=2.0 ** -7)
    # Dispatch, experts and combine fed the reference's routing.
    want, _ = ref_moe.moe_layer(jp, jx, top_k=2, capacity_factor=1.25,
                                local_groups=groups)
    fed = moe.Routing(torch.tensor(np.asarray(pj)), torch.tensor(np.asarray(ge)).long(),
                      torch.tensor(np.asarray(gw)), torch.tensor(np.asarray(rk)))
    got, _ = moe.moe_layer(tp, tx, top_k=2, capacity_factor=1.25, local_groups=groups,
                           routing=fed)
    assert got.dtype == torch.bfloat16
    close(got, want)


def test_moe_init_draws_the_reference_shapes_and_scales():
    gen = torch.Generator().manual_seed(0)
    p = moe.moe_init(256, 8, 64, gen)
    ref = ref_moe.moe_init(jax.random.PRNGKey(0), 256, 8, 64)
    for k, v in ref.items():
        assert tuple(p[k].shape) == v.shape and p[k].dtype == torch.bfloat16
        assert abs(float(p[k].float().std()) / float(np.asarray(v, np.float32).std())
                   - 1) < 0.1, k


def record_ref_routing(monkeypatch):
    """Records every reference ``moe_layer`` call's input and routing, in
    call (layer) order, through ``jax.debug.callback``; returns the list of
    records and a function turning a slice of them into the port's
    per-layer ``routing=`` list."""
    calls = []
    orig = ref_moe.moe_layer

    def recorded(params, x, *, top_k, capacity_factor=1.25, local_groups=0):
        assert not local_groups
        B, S, D = x.shape
        logits, probs, ge, gw, rk = _ref_routing(params, x.reshape(B * S, D), top_k)
        jax.debug.callback(lambda *a: calls.append([np.asarray(v) for v in a]),
                           x.reshape(B * S, D).astype(jnp.float32), params["router"],
                           logits, probs, ge, gw, rk, ordered=True)
        return orig(params, x, top_k=top_k, capacity_factor=capacity_factor,
                    local_groups=local_groups)

    monkeypatch.setattr(ref_moe, "moe_layer", recorded)

    def fed(records):
        return [moe.Routing(torch.tensor(p), torch.tensor(ge).long(), torch.tensor(gw),
                            torch.tensor(rk)) for _, _, _, p, ge, gw, rk in records]

    return calls, fed


@pytest.fixture
def ref_routing(monkeypatch):
    return record_ref_routing(monkeypatch)


def _check_router_logits(records, k):
    """Each layer's port router logits on the reference's own layer input."""
    under = 0
    for h, router, lj, _, ge, _, _ in records:
        lt = moe.router_logits(torch.tensor(np.asarray(router, np.float32)).to(torch.bfloat16),
                               torch.tensor(h).to(torch.bfloat16))
        under += _assert_routing_under_margin(lt, lj, ge, k)
    return under


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_moe_model_prefill_and_decode_match_reference(arch, ref_routing):
    from repro.models import decode_step as ref_decode_step
    from repro.models import prefill as ref_prefill
    from repro_torch.convert import serve_state_from_numpy, serve_state_to_numpy
    from test_torch_lm import leaves_close
    calls, fed = ref_routing
    jcfg, params, cfg, model = models(arch)
    B, S, budget = 2, 40, 8
    rng = np.random.default_rng(12)
    toks = rng.integers(0, cfg.vocab, (B, S)).astype(np.int32)
    want, want_c = ref_prefill(params, jcfg, {"tokens": jnp.asarray(toks)},
                               kernel_impl="pallas", max_cache_len=S + budget)
    jax.effects_barrier()
    n = cfg.n_layers
    assert len(calls) == n
    _check_router_logits(calls, cfg.moe.top_k)
    got, got_c = model.prefill(torch.tensor(toks), max_cache_len=S + budget,
                               routing=fed(calls))
    close(got, want)
    leaves_close(jax.tree.leaves(serve_state_to_numpy(cfg, got_c)),
                 jax.tree.leaves(np_tree(want_c)))
    caches, jc = serve_state_from_numpy(cfg, np_tree(want_c)), want_c
    for step in range(2):
        nt = rng.integers(0, cfg.vocab, (B, 1)).astype(np.int32)
        pos = np.full((B,), S + step, np.int32)
        want_d, jc = ref_decode_step(params, jcfg, jnp.asarray(nt), jnp.asarray(pos), jc,
                                     kernel_impl="pallas")
        jax.effects_barrier()
        got_d, caches = model.decode_step(torch.tensor(nt), torch.tensor(pos), caches,
                                          routing=fed(calls[-n:]))
        close(got_d, want_d)
    leaves_close(jax.tree.leaves(serve_state_to_numpy(cfg, caches)),
                 jax.tree.leaves(np_tree(jc)))


def assert_train_logits_and_aux_match(arch, monkeypatch):
    """The smoke model's train logits and load-balance aux against the
    reference's forward, each MoE layer's router checked on the
    reference's input and the model fed the reference's routing."""
    calls, fed = record_ref_routing(monkeypatch)
    jcfg, params, cfg, model = models(arch)
    toks = np.random.default_rng(5).integers(0, cfg.vocab, (2, 24)).astype(np.int32)
    want, _, want_aux = ref_forward(params, jcfg, {"tokens": jnp.asarray(toks)},
                                    mode="train", kernel_impl="pallas")
    jax.effects_barrier()
    assert len(calls) == cfg.n_layers
    _check_router_logits(calls, cfg.moe.top_k)
    with torch.inference_mode():
        got, none, aux = model(torch.tensor(toks), mode="train", return_aux=True,
                               routing=fed(calls))
    assert none is None
    close(got, want)
    np.testing.assert_allclose(float(aux), float(want_aux), rtol=1e-3)


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_moe_model_train_logits_and_aux_match_reference(arch, monkeypatch):
    assert_train_logits_and_aux_match(arch, monkeypatch)


def test_moe_parameter_count_matches_reference():
    from repro.configs import smoke_config as ref_smoke_config
    from repro.models import init_params as ref_init_params
    for arch in MOE_ARCHS:
        ref = jax.tree.leaves(ref_init_params(jax.random.PRNGKey(0), ref_smoke_config(arch)))
        model = LM(smoke_config(arch), device="cpu", seed=None)
        assert sum(p.numel() for p in model.parameters()) == sum(x.size for x in ref)


# ---------------------------------------------------------------------- #
# Remat and fixed experts in the port alone.
# ---------------------------------------------------------------------- #
@pytest.fixture
def one_thread():
    """The smoke models' many small ops run fastest on one thread."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _recorded_routes(monkeypatch) -> list:
    """Every routing's top-k experts from now on, in call order."""
    seen, own = [], moe.route

    def recorded(logits, top_k, gate_e=None):
        r = own(logits, top_k, gate_e)
        seen.append(r.gate_e.clone())
        return r
    monkeypatch.setattr(moe, "route", recorded)
    return seen


def test_remat_reproduces_routing_and_gradients(monkeypatch, one_thread):
    """granite-moe-3b-a800m's smoke config at 1 x 2304 (the unwindowed
    scan, each key block's scores under a checkpoint inside the layer
    remat's): ``train_loss`` gives the same ce and every gradient bit for
    bit with remat on and off, and the experts each layer's recompute
    chose in the backward pass equal its forward's."""
    from repro_torch.models import attention as att
    cfg = smoke_config("granite-moe-3b-a800m")
    model = LM(cfg, device="cpu", seed=0)
    for p in model.parameters():
        p.requires_grad_(True)
    rng = np.random.default_rng(0)
    tokens, labels = (torch.from_numpy(rng.integers(0, cfg.vocab, (1, 2304))) for _ in range(2))
    seen = _recorded_routes(monkeypatch)
    scans, scan = [], att._flash_scan
    monkeypatch.setattr(att, "_flash_scan", lambda *a, **k: scans.append(1) or scan(*a, **k))
    out = {}
    for remat in (True, False):
        model.zero_grad(set_to_none=True)
        total, parts = model.train_loss(tokens, labels, remat=remat)
        total.backward()
        out[remat] = (parts["ce"].detach(), {n: p.grad for n, p in model.named_parameters()})
    n = cfg.n_layers
    assert len(scans) == 3 * n                  # remat: forward and recompute; then forward
    assert len(seen) == 3 * n
    forward, recompute, plain = seen[:n], seen[n:2 * n][::-1], seen[2 * n:]
    assert all(torch.equal(a, b) for a, b in zip(forward, recompute))
    assert all(torch.equal(a, b) for a, b in zip(forward, plain))
    assert torch.equal(out[True][0], out[False][0])
    for name, g in out[True][1].items():
        assert torch.equal(g, out[False][1][name]), name


def test_prefill_takes_fixed_experts(monkeypatch, one_thread):
    """``LM.prefill(experts=)``: the experts a prefill chose, fed back,
    give its logits bit for bit; other experts are the ones routed to, and
    move the logits."""
    cfg = smoke_config("granite-moe-3b-a800m")
    model = LM(cfg, device="cpu", seed=0)
    tokens = torch.from_numpy(np.random.default_rng(0).integers(0, cfg.vocab, (2, 64)))
    seen = _recorded_routes(monkeypatch)
    logits = model.prefill(tokens)[0]
    chosen = list(seen)
    assert len(chosen) == cfg.n_layers
    assert torch.equal(model.prefill(tokens, experts=chosen)[0], logits)
    other = [(e + 1) % cfg.moe.n_experts for e in chosen]
    seen.clear()
    moved = model.prefill(tokens, experts=other)[0]
    assert all(torch.equal(a, b) for a, b in zip(seen, other))
    assert not torch.equal(moved, logits)

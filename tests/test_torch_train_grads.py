"""``LM.train_loss`` and its gradient against the JAX package's, for every
arch of the registry at smoke size, on the CPU: the reference's
``init_params`` (carried over by ``convert.lm_params_from_numpy``) and the
reference's ``_batch`` shapes (``tests/test_models_smoke.py``) made with
numpy, batch 2 x 32.

Gradient bar.  Both packages keep weights and activations in bf16, so a
gradient leaf may differ by several percent.  So each gradient row (a
leaf's slice along its first axis; a 1-D leaf is one row) is held to the
reference's own sensitivity there: within ``GRAD_ROW_SENS`` times the
change of that row of the reference's gradient when the embedded input
moves by one bf16 step (each element one step up or down, signs from
numpy seed 1), the rule ``PERF.md`` section 2 uses for logits, row by row.
In the MoE archs the reference's routing is pinned for that second run
(its ``top_k`` returns the recorded experts), and the port is fed the
reference's routing decisions (``LM.train_loss(experts=)``): a
near-tied top-k flips under a bf16 step, and a flipped expert would change
the gradient by far more than rounding does.  ``GRAD_ROW_SENS`` is the
smallest power of two at least twice the largest sound reading (2.47, the
granite-moe router; ``PERF.md``); the planted faults (the head's gradient
dropped, untied and tied, and the MoE aux weight set to 0) read 48 and
more.  ce and aux within ``CE_REL`` and ``AUX_REL`` of the reference's,
by the same power-of-two rule (readings 1.1e-4 and 1.06e-3).
"""
from __future__ import annotations

import contextlib
import functools

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

import repro.models.lm as ref_lm
from repro.configs import REGISTRY
from repro.configs import smoke_config as ref_smoke_config
from repro.models import init_params as ref_init_params
from repro.models import train_loss as ref_train_loss
from repro_torch.configs import smoke_config
from repro_torch.convert import lm_params_from_numpy, tensor_from_numpy
from repro_torch.models import LM
from repro_torch.models import lm as lm_mod

ARCHS = sorted(REGISTRY)
GRAD_ROW_SENS = 8.0
CE_REL = 2.0 ** -11
AUX_REL = 2.0 ** -8


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """Smoke-size steps are many tiny ops, which run fastest on one thread
    and slow down badly when the suite's workers share the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ---------------------------------------------------------------------- #
# train_loss and its gradient, every arch.
# ---------------------------------------------------------------------- #
def _np_batch(cfg, rng, B=2, S=32):
    """The reference's ``_batch`` (tests/test_models_smoke.py) with numpy."""
    n_txt = S - cfg.n_vision_tokens if cfg.family == "vlm" else S
    batch = {"tokens": rng.integers(0, cfg.vocab, (B, n_txt)).astype(np.int32),
             "labels": rng.integers(0, cfg.vocab, (B, n_txt)).astype(np.int32)}
    if cfg.family == "vlm":
        batch["vision_embeds"] = rng.normal(
            size=(B, cfg.n_vision_tokens, cfg.d_model)).astype(ml_dtypes.bfloat16)
    if cfg.family == "audio":
        batch["frames"] = rng.normal(
            size=(B, cfg.encoder.n_ctx, cfg.encoder.d_model)).astype(ml_dtypes.bfloat16)
    return batch


def _stepped_embed(w, tokens, *, sign, orig):
    """The reference's embedding moved one bf16 step per element (the
    gradient passes as through the plain lookup)."""
    x = orig(w, tokens).astype(jnp.bfloat16)
    y = jax.lax.bitcast_convert_type(jax.lax.bitcast_convert_type(x, jnp.int16) + sign,
                                     jnp.bfloat16)
    return x + jax.lax.stop_gradient(y - x)


@contextlib.contextmanager
def pinned_top_k(record):
    """The reference's routing recorded over ``record()`` (a jitted run of
    the unrolled model: each MoE layer's top-k experts, in layer order),
    then pinned inside the block: ``jax.lax.top_k`` returns the recorded
    experts, layer by layer in trace order.  Yields the recorded experts."""
    top_k, gates, calls = jax.lax.top_k, [], [0]

    def recorded(x, k):
        out = top_k(x, k)
        jax.debug.callback(lambda e: gates.append(np.asarray(e)), out[1], ordered=True)
        return out

    def pinned(x, k):
        e = jnp.asarray(gates[calls[0] % len(gates)])
        calls[0] += 1
        return jnp.take_along_axis(x, e, -1), e
    try:
        jax.lax.top_k = recorded
        record()
        jax.lax.top_k = pinned
        yield gates
    finally:
        jax.lax.top_k = top_k


@functools.lru_cache(maxsize=None)
def _reference(arch: str):
    """The reference's params, batch, ce, aux and gradient (by the port's
    names), its gradient with the embedded input one bf16 step off, and
    its routing (each MoE layer's top-k experts, in layer order)."""
    cfg = ref_smoke_config(arch)
    params = ref_init_params(jax.random.PRNGKey(0), cfg)
    batch = _np_batch(cfg, np.random.default_rng(0))
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    orig_embed = ref_lm.embed_lookup
    pin = contextlib.nullcontext([]) if cfg.moe is None else pinned_top_k(
        lambda: jax.block_until_ready(jax.jit(lambda p: ref_train_loss(
            p, cfg, jb, remat=False, unroll=True))(params)))
    with pin as gates:
        def loss(p, sign):
            ref_lm.embed_lookup = functools.partial(_stepped_embed, sign=sign, orig=orig_embed)
            return ref_train_loss(p, cfg, jb, remat=False, unroll=True)

        try:
            vg = jax.jit(jax.value_and_grad(loss, has_aux=True))
            n_txt = batch["tokens"].shape[1]
            zero = jnp.zeros((2, n_txt, cfg.d_model), jnp.int16)
            sign = jnp.asarray(np.random.default_rng(1).choice([-1, 1], size=zero.shape)
                               .astype(np.int16))
            (_, parts), g = vg(params, zero)
            _, g_step = vg(params, sign)
        finally:
            ref_lm.embed_lookup = orig_embed
    pcfg = smoke_config(arch)
    return {"params": lm_params_from_numpy(pcfg, jax.tree.map(np.asarray, params)),
            "batch": batch, "ce": float(parts["ce"]), "aux": float(parts["aux"]),
            "g": lm_params_from_numpy(pcfg, jax.tree.map(np.asarray, g)),
            "g_step": lm_params_from_numpy(pcfg, jax.tree.map(np.asarray, g_step)),
            "gates": gates}


def _port(arch: str, ref, aux_weight: float = 0.01):
    """The port's (ce, aux) and every parameter's gradient through
    ``LM.train_loss`` on the reference's weights and batch."""
    cfg = smoke_config(arch)
    model = LM(cfg, device="cpu", seed=None)
    model.load_state_dict(ref["params"])
    for p in model.parameters():
        p.requires_grad_(True)
    batch = ref["batch"]
    extra = {k: tensor_from_numpy(batch[k]) for k in ("frames", "vision_embeds")
             if k in batch}
    experts = [torch.tensor(e).long() for e in ref["gates"]] or None
    total, parts = model.train_loss(torch.from_numpy(batch["tokens"]).long(),
                                    torch.from_numpy(batch["labels"]).long(),
                                    aux_weight=aux_weight, experts=experts, **extra)
    total.backward()
    grads = {n: p.grad for n, p in model.named_parameters()}
    return {k: float(v.detach()) for k, v in parts.items()}, grads


def _row_readings(ref, grads):
    """Per leaf: the largest ratio, over its rows, of the port's error to
    the reference's own one-bf16-step change (0 where the error is 0)."""
    out = {}
    for name, g in ref["g"].items():
        rows = g.shape[0] if g.dim() > 1 else 1
        want = g.float().reshape(rows, -1)
        got = grads[name]
        got = torch.zeros_like(want) if got is None else got.float().reshape(rows, -1)
        err = (got - want).norm(dim=1)
        sens = (ref["g_step"][name].float().reshape(rows, -1) - want).norm(dim=1)
        out[name] = float(torch.where(err == 0, 0.0, err / sens).max())
    return out


@pytest.mark.parametrize("arch", ARCHS)
def test_train_loss_and_gradients_match_the_reference(arch):
    ref = _reference(arch)
    parts, grads = _port(arch, ref)
    assert abs(parts["ce"] - ref["ce"]) <= CE_REL * abs(ref["ce"])
    assert abs(parts["aux"] - ref["aux"]) <= AUX_REL * abs(ref["aux"])
    assert all(g is not None for g in grads.values())       # every leaf, the head too
    readings = _row_readings(ref, grads)
    worst = max(readings, key=readings.get)
    assert readings[worst] <= GRAD_ROW_SENS, (worst, readings[worst])


@pytest.mark.parametrize("arch,fault", [("granite-8b", "head"), ("recurrentgemma-2b", "head"),
                                        ("olmoe-1b-7b", "aux")])
def test_planted_faults_read_above_the_bar(arch, fault, monkeypatch):
    """The head's gradient dropped (the cached, detached table; tied in
    recurrentgemma-2b, where only the unembedding half goes) and the MoE
    load-balance loss left out must break the gradient bar."""
    ref = _reference(arch)
    if fault == "head":
        monkeypatch.setattr(lm_mod.LM, "head_f32", lambda self: (
            self.embed if self.cfg.tie_embeddings else self.lm_head).w.detach().float())
        leaf = "embed.w" if smoke_config(arch).tie_embeddings else "lm_head.w"
        _, grads = _port(arch, ref)
    else:
        leaf = "layers.0.mlp.router"
        _, grads = _port(arch, ref, aux_weight=0.0)
    assert _row_readings(ref, grads)[leaf] > GRAD_ROW_SENS

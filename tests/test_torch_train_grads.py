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
by the same power-of-two rule (readings 1.1e-4 and 1.06e-3).  whisper's
encoder block and an ``xdec`` block's cross attention are also held alone,
values and gradient rows (of their weights and their inputs) at these bars.
"""
from __future__ import annotations

import contextlib
import functools
import types

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

import repro.models.lm as ref_lm
from repro.configs import REGISTRY
from repro.configs import smoke_config as ref_smoke_config
from repro.models import attention as ref_att
from repro.models import init_params as ref_init_params
from repro.models import layers as ref_layers
from repro.models import train_loss as ref_train_loss
from repro_torch.configs import smoke_config
from repro_torch.convert import lm_params_from_numpy, tensor_from_numpy
from repro_torch.models import LM
from repro_torch.models import attention as att_mod
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
                                        ("olmoe-1b-7b", "aux"), ("qwen2-72b", "bias")])
def test_planted_faults_read_above_the_bar(arch, fault, monkeypatch):
    """The head's gradient dropped (the cached, detached table; tied in
    recurrentgemma-2b, where only the unembedding half goes), the MoE
    load-balance loss left out and the QKV bias detached in the
    projection must break the gradient bar."""
    ref = _reference(arch)
    if fault == "bias":
        project = att_mod._project_qkv
        monkeypatch.setattr(att_mod, "_project_qkv", lambda p, *a: project(
            types.SimpleNamespace(wq=p.wq, wk=p.wk, wv=p.wv, bq=p.bq.detach(),
                                  bk=p.bk.detach(), bv=p.bv.detach()), *a))
        leaf = "layers.0.attn.bk"
        _, grads = _port(arch, ref)
    elif fault == "head":
        monkeypatch.setattr(lm_mod.LM, "head_f32", lambda self: (
            self.embed if self.cfg.tie_embeddings else self.lm_head).w.detach().float())
        leaf = "embed.w" if smoke_config(arch).tie_embeddings else "lm_head.w"
        _, grads = _port(arch, ref)
    else:
        leaf = "layers.0.mlp.router"
        _, grads = _port(arch, ref, aux_weight=0.0)
    assert _row_readings(ref, grads)[leaf] > GRAD_ROW_SENS


# ---------------------------------------------------------------------- #
# whisper's encoder block and an xdec block's cross attention alone.
# ---------------------------------------------------------------------- #
def _ref_whisper_part(cfg, part: str, params, x, enc):
    """The reference's encoder block 0 (``encode``'s body: attention,
    non-causal, then the GELU MLP on the residual sum; the two branches
    added in float32) or layer 0's cross attention (``_block_apply``'s:
    ``normx``, ``cross_kv`` of the encoder output, ``cross_attention``):
    the mean square of its float32 output."""
    if part == "encoder":
        e = cfg.encoder
        bp = jax.tree.map(lambda a: a[0], params["encoder"]["blocks"])
        y1 = ref_att.attention(bp["attn"], ref_layers.rmsnorm(bp["norm1"], x, cfg.rms_eps),
                               n_heads=e.n_heads, n_kv_heads=e.n_heads,
                               head_dim=e.d_model // e.n_heads, rope_theta=cfg.rope_theta,
                               causal=False)
        y = y1.astype(jnp.float32) + ref_layers.gelu_mlp(
            bp["mlp"], ref_layers.rmsnorm(bp["norm2"], x + y1, cfg.rms_eps)).astype(jnp.float32)
    else:
        bp = jax.tree.map(lambda a: a[0], params["groups"]["c0"])
        xkv = ref_att.cross_kv(bp["xattn"], enc, n_heads=cfg.n_heads, head_dim=cfg.hd)
        y = ref_att.cross_attention(bp["xattn"], ref_layers.rmsnorm(bp["normx"], x, cfg.rms_eps),
                                    xkv, n_heads=cfg.n_heads, head_dim=cfg.hd)
    return jnp.mean(jnp.square(y.astype(jnp.float32)))


def _port_whisper_part(model, part: str, ins: dict):
    """The port's part on the same inputs, as ``chip_smoke.part_grads``
    computes it: (value, gradients by the part's parameters, named as the
    state dict, and by its inputs)."""
    blk = model.encoder.blocks[0] if part == "encoder" else model.layers[0]
    pre = "encoder.blocks.0." if part == "encoder" else "layers.0."
    x = ins["input"]
    if part == "encoder":
        y1 = model._enc_attn(blk, x, kernel_impl="xla")
        y = y1.float() + model._enc_mlp(blk, x + y1).float()
    else:
        y = model._cross(blk, x, model._cross_kv(blk, ins["encoder_output"]))
    value = y.float().square().mean()
    value.backward()
    grads = {pre + n: p.grad for n, p in blk.named_parameters() if p.grad is not None}
    return float(value.detach()), {**grads, **{k: t.grad for k, t in ins.items()}}


@pytest.mark.parametrize("part", ["encoder", "cross"])
def test_whisper_encoder_block_and_cross_attention_match_the_reference(part):
    """Each part alone on the reference's weights, at smoke size: its value
    within CE_REL, every gradient row (the part's weights and its inputs:
    the encoder's frames (2, n_ctx, d), or the decoder's hidden states (2,
    32, d) and the encoder output) within GRAD_ROW_SENS times the
    reference's own change when every input moves one bf16 step."""
    arch = "whisper-small"
    rcfg, cfg = ref_smoke_config(arch), smoke_config(arch)
    params = ref_init_params(jax.random.PRNGKey(0), rcfg)
    rng = np.random.default_rng(0)
    e = rcfg.encoder
    shapes = {"input": (2, e.n_ctx, e.d_model)} if part == "encoder" else \
        {"input": (2, 32, rcfg.d_model), "encoder_output": (2, e.n_ctx, e.d_model)}
    ins = {k: rng.normal(size=s).astype(ml_dtypes.bfloat16) for k, s in shapes.items()}
    signs = {k: np.random.default_rng(1).choice([-1, 1], size=s).astype(np.int16)
             for k, s in shapes.items()}

    def ref_value(p, xs):
        return _ref_whisper_part(rcfg, part, p, xs["input"], xs.get("encoder_output"))
    vg = jax.jit(jax.value_and_grad(ref_value, argnums=(0, 1)))
    step = {k: jax.lax.bitcast_convert_type(
        jax.lax.bitcast_convert_type(jnp.asarray(a), jnp.int16) + signs[k], jnp.bfloat16)
        for k, a in ins.items()}
    want, (g_p, g_x) = vg(params, {k: jnp.asarray(a) for k, a in ins.items()})
    _, (s_p, s_x) = vg(params, step)
    pre = "encoder.blocks.0." if part == "encoder" else "layers.0."

    def by_name(gp, gx):
        flat = lm_params_from_numpy(cfg, jax.tree.map(np.asarray, gp))
        return {**{k: v for k, v in flat.items() if k.startswith(pre)
                   and ("xattn" in k or "normx" in k or part == "encoder")},
                **{k: tensor_from_numpy(np.asarray(v)) for k, v in gx.items()}}
    ref = {"g": by_name(g_p, g_x), "g_step": by_name(s_p, s_x)}

    model = LM(cfg, device="cpu", seed=None)
    model.load_state_dict(lm_params_from_numpy(cfg, jax.tree.map(np.asarray, params)))
    for p in model.parameters():
        p.requires_grad_(True)
    got, grads = _port_whisper_part(
        model, part, {k: tensor_from_numpy(a).requires_grad_(True) for k, a in ins.items()})
    assert abs(got - float(want)) <= CE_REL * abs(float(want))
    assert grads.keys() == ref["g"].keys()
    readings = _row_readings(ref, grads)
    worst = max(readings, key=readings.get)
    assert readings[worst] <= GRAD_ROW_SENS, (worst, readings[worst])

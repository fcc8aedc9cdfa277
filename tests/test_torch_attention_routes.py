"""The reference's two XLA attention routes in the port, against the JAX
package on the CPU: the blocked online-softmax scan (``_flash_scan``, the
route above ``FLASH_SCAN_THRESHOLD`` = 2048 positions and under
``kernel_impl="flash_scan"``) and the dense einsum, whose softmax
probabilities are cast to v's type before the value product
(``src/repro/models/attention.py:144-182``).  Inputs are bf16 from numpy
seeds.

Bar.  Both routes compute in float32 and round once to bf16 at the end,
so every element is held within one bf16 step of the reference's value,
the step taken at ``max(|want|, 2^-8 * rms(want))``: near zero an output
is a cancellation of float32 terms, where one bf16 step at the value
itself is far finer than float32's rounding of the terms (readings there
are 1e-8 to 3e-8 absolute, at values of 1e-7 to 4e-6).  The planted
fault, B5's plain version (float32 probabilities into the value
product) standing in for the dense route, reads many steps over it.

The whole model at more than 2048 positions (recurrentgemma-2b's smoke
config cut to its first (rec, rec, local attention) group,
h2o-danube-3-4b's, granite-moe-3b-a800m's, whose unwindowed scan runs
inside the layer remat beside MoE layers, gemma3-12b's grown to its first
5:1 group of local and global layers, and qwen2-72b's with its QKV biases
drawn, batch 1 x 2304): ``LM.train_loss``
and its gradient against the reference's ``train_loss`` under
``tests/test_torch_train_grads.py``'s rule (the MoE layers fed the
reference's experts, its stepped run pinned to them).  ``kernel_impl="flash_scan"``
reaches every layer kind through ``LM.forward`` (local attention,
RG-LRU, the encoder and ``xdec``, whose self-attention is the global
layers' call: each model's logits within
``tests/test_torch_lm.py``'s bar of the reference's; SSD: its plain
route, bit for bit), and through ``make_train_step``.  One local-attention layer at recurrentgemma-2b's
widths, S 4096, window 2048, counts the reference dry run's per-pass
term ``4 B S min(W + bq, S) H hd`` (``src/repro/launch/dryrun.py:120-124``)
beside its projections.
"""
from __future__ import annotations

import contextlib
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

import repro.models.lm as ref_lm
from repro.configs import smoke_config as ref_smoke_config
from repro.models import attention as ref_att
from repro.models import forward as ref_forward
from repro.models import init_params as ref_init_params
from repro.models import train_loss as ref_train_loss
from repro_torch.configs import get_config, smoke_config
from repro_torch.convert import lm_params_from_numpy, tensor_from_numpy, tensor_to_numpy
from repro_torch.kernels.flash_attention import flash_attention_ref
from repro_torch.models import LM
from repro_torch.models import attention as att
from repro_torch.optim import AdamWConfig, init_opt_state
from repro_torch.train import TrainOptions, make_train_step
from test_torch_lm import TOL, close, load, np_tree
from test_torch_registry import _with_bias
from test_torch_train_grads import (AUX_REL, CE_REL, GRAD_ROW_SENS, _np_batch,
                                    _row_readings, _stepped_embed, pinned_top_k)

# The reference's init_params in one compiled call (its eager init costs
# seconds of small compiles a model); any seeded weights serve here.
ref_params = jax.jit(ref_init_params, static_argnums=1)
LONG = 2304                 # over the threshold, and not a multiple of 512
ATT_KW = dict(n_heads=4, n_kv_heads=2, head_dim=16, rope_theta=10000.0)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """The smoke models' many small ops run fastest on one thread, and
    slow down badly when the suite's workers share the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def bf16(rng, shape) -> np.ndarray:
    return rng.normal(size=shape).astype(jnp.bfloat16)


def steps_over(got, want) -> float:
    """The largest |got - want| in units of one bf16 step at
    ``max(|want|, 2^-8 rms(want))`` (the module's bar is 1)."""
    g = np.asarray(tensor_to_numpy(got) if isinstance(got, torch.Tensor) else got, np.float64)
    w = np.asarray(want, np.float64)
    mag = np.maximum(np.abs(w), 2.0 ** -8 * np.sqrt(np.mean(w * w)))
    step = np.ldexp(1.0, np.frexp(mag)[1] - 8)
    return float((np.abs(g - w) / step).max())


# ---------------------------------------------------------------------- #
# _flash_scan against the reference's.
# ---------------------------------------------------------------------- #
@pytest.mark.parametrize("B,S,H,Hkv,causal,window,block", [
    (1, LONG, 1, 1, True, None, 512),          # bq = bk = 384: S % 512 != 0
    (1, LONG, 4, 1, False, None, 512),
    (1, 2560, 4, 1, True, 512, 512),
    (1, 2560, 1, 1, False, 512, 512),          # windowed: causal whatever ``causal`` says
    (1, 4096, 1, 1, True, 2048, 512),
    (1, 4096, 4, 1, False, 2048, 512),
    (2, 256, 4, 2, True, 64, 64),              # tests/test_models_consistency.py:82's blocks
    (2, 256, 4, 2, False, None, 64),
])
def test_flash_scan_matches_the_reference(B, S, H, Hkv, causal, window, block):
    rng = np.random.default_rng(S + H + (window or 0))
    q, k, v = bf16(rng, (B, S, H, 32)), bf16(rng, (B, S, Hkv, 32)), bf16(rng, (B, S, Hkv, 32))
    want = ref_att._flash_scan(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=causal,
                               window=window, bq=block, bk=block)
    got = att._flash_scan(tensor_from_numpy(q), tensor_from_numpy(k), tensor_from_numpy(v),
                          causal=causal, window=window, bq=block, bk=block)
    assert got.dtype == torch.bfloat16 and got.shape == (B, S, H, 32)
    assert steps_over(got, np.asarray(want)) <= 1.0


def _case(*args, hd: int = 32):
    """A case of the scan's gradient test, its id without the default head
    dim (the ids its cases had before the head dim was a column)."""
    return pytest.param(*args, hd, id="-".join(map(str, args + ((hd,) if hd != 32 else ()))))


@pytest.mark.parametrize("B,S,H,Hkv,causal,window,block,hd", [
    _case(2, 256, 4, 2, True, None, 64),
    _case(2, 256, 4, 2, False, None, 64),
    _case(2, 256, 4, 2, True, 64, 64),
    _case(1, LONG, 4, 1, True, None, 512),     # bq = bk = 384
    _case(1, 2560, 2, 1, True, 1024, 512, hd=240),  # gemma3-12b's local layers: span 1536
])
def test_flash_scan_gradient_matches_the_reference(B, S, H, Hkv, causal, window, block, hd):
    """q's, k's and v's gradients of a fixed weighting of the output (the
    unwindowed branch recomputes its key blocks' scores in the backward
    pass) against ``jax.grad`` of the reference's scan, every element
    within one bf16 step; the windowed branch also at gemma3-12b's window
    and head dim (1024, 240: not a power of two)."""
    rng = np.random.default_rng(S + H + (window or 0) + 1)
    q, k, v = bf16(rng, (B, S, H, hd)), bf16(rng, (B, S, Hkv, hd)), bf16(rng, (B, S, Hkv, hd))
    w = rng.normal(size=(B, S, H, hd)).astype(np.float32)

    def loss(q, k, v):
        o = ref_att._flash_scan(q, k, v, causal=causal, window=window, bq=block, bk=block)
        return jnp.sum(o.astype(jnp.float32) * w)
    want = jax.grad(loss, argnums=(0, 1, 2))(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    ts = [tensor_from_numpy(x).requires_grad_(True) for x in (q, k, v)]
    o = att._flash_scan(*ts, causal=causal, window=window, bq=block, bk=block)
    (o.float() * torch.from_numpy(w)).sum().backward()
    for t, g in zip(ts, want):
        assert t.grad.dtype == torch.bfloat16
        assert steps_over(t.grad, np.asarray(g).astype(np.float32)) <= 1.0


def test_unwindowed_scan_keeps_no_block_scores():
    """Under grad mode autograd saves nothing as large as a key block's
    (S, bk) scores: the backward pass recomputes them."""
    B, S, H, bk = 1, 1024, 4, 256
    rng = np.random.default_rng(3)
    q, k, v = (tensor_from_numpy(bf16(rng, (B, S, h, 32))).requires_grad_(True)
               for h in (H, 1, 1))
    sizes = []

    def pack(t):
        sizes.append(t.numel())
        return t
    with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
        o = att._flash_scan(q, k, v, causal=True, window=None, bq=bk, bk=bk)
    assert sizes and max(sizes) < B * H * S * bk
    o.float().sum().backward()
    assert all(bool(torch.isfinite(t.grad.float()).all()) for t in (q, k, v))


# ---------------------------------------------------------------------- #
# attention(kernel_impl=...) on both sides of the threshold.
# ---------------------------------------------------------------------- #
@pytest.fixture
def bare_layers(monkeypatch):
    """RoPE off in both packages' attention modules.  Layers built by
    :func:`_layer` then hand their input to the route unchanged: the two
    frameworks' projections and RoPE round a few elements of q, k and v to
    neighbouring bf16 values, which moves an attention output by several of
    its own steps whatever the route."""
    for mod in (ref_att, att):
        monkeypatch.setattr(mod, "apply_rope", lambda x, pos, theta: x)


def _layer(S: int, window, impl: str):
    """An attention layer (d 64, 4 heads on 2 of 16) whose projections are
    slices of the identity (q = x, k = x[..., :32], v = x[..., 32:], wo =
    I, all exact in bf16), and the reference's output under ``impl`` on
    the same bf16 input."""
    rng = np.random.default_rng(S)
    x = rng.normal(size=(1, S, 64)).astype(np.float32)
    eye = jnp.eye(64, dtype=jnp.bfloat16)
    p = {"wq": eye, "wk": eye[:, :32], "wv": eye[:, 32:], "wo": eye}
    mod = load(att.Attention(64, 4, 2, 16, device="cpu"), p)
    want = ref_att.attention(p, jnp.asarray(x, jnp.bfloat16), window=window, kernel_impl=impl,
                             **ATT_KW)
    return mod, torch.tensor(x).bfloat16(), np.asarray(want)


@pytest.mark.parametrize("S,window,impl", [(256, None, "xla"), (256, 64, "xla"),
                                           (LONG, None, "xla"), (LONG, 512, "xla"),
                                           (256, None, "flash_scan"),
                                           (256, 64, "flash_scan")])
def test_attention_routes_match_the_reference(S, window, impl, bare_layers):
    mod, x, want = _layer(S, window, impl)
    got = att.attention(mod, x, window=window, kernel_impl=impl, **ATT_KW)
    assert got.dtype == torch.bfloat16
    assert steps_over(got, want) <= 1.0


@pytest.mark.parametrize("window", [None, 64])
def test_float32_probabilities_read_over_the_bar(window, bare_layers, monkeypatch):
    """The planted fault: at S <= 2048 the plain version of B5 (float32
    probabilities into the value product) in place of the dense route."""
    mod, x, want = _layer(256, window, "xla")
    monkeypatch.setattr(att, "_dense_attention", flash_attention_ref)
    got = att.attention(mod, x, window=window, kernel_impl="xla", **ATT_KW)
    assert steps_over(got, want) > 1.0


def test_routes_by_length_and_impl(monkeypatch):
    """Which route each ``kernel_impl`` takes on each side of 2048."""
    seen = []
    for name in ("_flash_scan", "_dense_attention"):
        real = getattr(att, name)
        monkeypatch.setattr(att, name, functools.partial(
            lambda real, name, *a, **kw: seen.append(name) or real(*a, **kw), real, name))
    monkeypatch.setattr(att, "flash_attention", lambda *a, **kw: seen.append("b5") or
                        flash_attention_ref(*a, causal=kw["causal"], window=kw["window"]))
    mod = att.Attention(64, 4, 2, 16, gen=torch.Generator().manual_seed(0), device="cpu")
    for S in (att.FLASH_SCAN_THRESHOLD, att.FLASH_SCAN_THRESHOLD + 8):
        x = torch.zeros((1, S, 64), dtype=torch.bfloat16)
        for impl in ("xla", "flash_scan", None, "pallas"):
            att.attention(mod, x, kernel_impl=impl, window=16, **ATT_KW)
    assert seen == ["_dense_attention", "_flash_scan", "b5", "b5",
                    "_flash_scan", "_flash_scan", "b5", "b5"]


# ---------------------------------------------------------------------- #
# The whole model above the threshold: train_loss and its gradient.
# ---------------------------------------------------------------------- #
# Depths other than the smoke config's: recurrentgemma-2b cut to its first
# group of layers (rec, rec, local attention), for the reference's compile
# time; gemma3-12b's 4 local layers grown to its first 5:1 group, so its
# global layer 5 (the unwindowed scan) runs beside the windowed ones;
# qwen2-72b's cut to one layer, as the smoke script trains it (its 16
# query heads' unwindowed scan took 48 s a model of 4 on one core);
# granite-8b and olmoe-1b-7b to 2 of their 4 for the tier-1 run's time (43
# and 34 s at 4, 26 and 21 s at 2 on one core).
LONG_LAYERS = {"recurrentgemma-2b": 3, "gemma3-12b": 6, "qwen2-72b": 1, "granite-8b": 2,
               "olmoe-1b-7b": 2}


def _long_config(smoke, arch: str):
    """``smoke(arch)`` at its ``LONG_LAYERS`` depth."""
    cfg = smoke(arch)
    return dataclasses.replace(cfg, n_layers=LONG_LAYERS.get(arch, cfg.n_layers))


def _reference_long(arch: str):
    """The reference's params, batch (1 x LONG), ce, aux and gradient, and
    its gradient with the embedded input one bf16 step off (by the port's
    names); an MoE arch's routing is recorded, pinned for the stepped run
    (``pinned_top_k``, on the unrolled model) and returned as "gates".
    QKV biases are drawn non-zero (both packages initialise them to 0,
    which hides their part of the forward)."""
    cfg = _long_config(ref_smoke_config, arch)
    params = ref_params(jax.random.PRNGKey(0), cfg)
    if cfg.qkv_bias:
        params = _with_bias(params, 100)
    batch = _np_batch(cfg, np.random.default_rng(0), B=1, S=LONG)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    orig = ref_lm.embed_lookup
    unroll = cfg.moe is not None
    pin = contextlib.nullcontext([]) if cfg.moe is None else pinned_top_k(
        lambda: jax.block_until_ready(jax.jit(lambda p: ref_train_loss(
            p, cfg, jb, remat=False, unroll=True))(params)))

    def loss(p, sign):
        ref_lm.embed_lookup = functools.partial(_stepped_embed, sign=sign, orig=orig)
        return ref_train_loss(p, cfg, jb, remat=False, unroll=unroll)
    with pin as gates:
        try:
            vg = jax.jit(jax.value_and_grad(loss, has_aux=True))
            shape = (1, LONG, cfg.d_model)
            sign = np.random.default_rng(1).choice([-1, 1], size=shape).astype(np.int16)
            (_, parts), g = vg(params, jnp.zeros(shape, jnp.int16))
            _, g_step = vg(params, jnp.asarray(sign))
        finally:
            ref_lm.embed_lookup = orig
    pcfg = _long_config(smoke_config, arch)
    return {"params": lm_params_from_numpy(pcfg, np_tree(params)), "batch": batch,
            "ce": float(parts["ce"]), "aux": float(parts["aux"]),
            "g": lm_params_from_numpy(pcfg, np_tree(g)),
            "g_step": lm_params_from_numpy(pcfg, np_tree(g_step)), "gates": gates}


@pytest.mark.parametrize("arch", ["recurrentgemma-2b", "h2o-danube-3-4b",
                                  "granite-moe-3b-a800m", "gemma3-12b", "qwen2-72b",
                                  "granite-8b", "olmoe-1b-7b"])
def test_train_loss_and_gradients_above_the_threshold(arch):
    ref = _reference_long(arch)
    model = LM(_long_config(smoke_config, arch), device="cpu", seed=None)
    model.load_state_dict(ref["params"])
    for p in model.parameters():
        p.requires_grad_(True)
    tokens, labels = (torch.from_numpy(ref["batch"][k]).long() for k in ("tokens", "labels"))
    # granite-moe: the unwindowed scan inside the layer remat, and the MoE
    # layers fed the reference's experts (its stepped run pinned to them).
    experts = [torch.from_numpy(e).long() for e in ref["gates"]] or None
    total, parts = model.train_loss(tokens, labels, experts=experts)
    total.backward()
    ce, aux = (float(parts[k].detach()) for k in ("ce", "aux"))
    assert abs(ce - ref["ce"]) <= CE_REL * abs(ref["ce"])
    assert abs(aux - ref["aux"]) <= AUX_REL * abs(ref["aux"])
    readings = _row_readings(ref, {n: p.grad for n, p in model.named_parameters()})
    worst = max(readings, key=readings.get)
    assert readings[worst] <= GRAD_ROW_SENS, (worst, readings[worst])


# ---------------------------------------------------------------------- #
# kernel_impl="flash_scan" end to end.
# ---------------------------------------------------------------------- #
@pytest.mark.parametrize("arch", ["recurrentgemma-2b", "whisper-small"])
def test_forward_takes_flash_scan_in_every_layer_kind(arch):
    jcfg, cfg = ref_smoke_config(arch), smoke_config(arch)
    params = ref_params(jax.random.PRNGKey(0), jcfg)
    model = LM(cfg, device="cpu", seed=None)
    model.load_state_dict(lm_params_from_numpy(cfg, np_tree(params)))
    rng = np.random.default_rng(5)
    toks = rng.integers(0, cfg.vocab, (2, 40)).astype(np.int32)
    batch, kw = {"tokens": jnp.asarray(toks)}, {}
    if cfg.family == "audio":
        frames = rng.normal(size=(2, cfg.encoder.n_ctx, cfg.encoder.d_model))
        batch["frames"] = jnp.asarray(frames, jnp.bfloat16)
        kw["frames"] = torch.tensor(frames).to(torch.bfloat16)
    want, _, _ = jax.jit(ref_forward, static_argnums=1, static_argnames=("mode", "kernel_impl"))(
        params, jcfg, batch, mode="train", kernel_impl="flash_scan")
    with torch.no_grad():
        got, _ = model(torch.from_numpy(toks).long(), kernel_impl="flash_scan", **kw)
    close(got[..., :cfg.vocab], np.asarray(want)[..., :cfg.vocab], TOL)


def test_flash_scan_runs_ssd_layers_through_their_plain_version():
    """mamba2-780m has no attention: under ``"flash_scan"`` its SSD layers
    take the plain route, so the logits equal ``"xla"``'s bit for bit."""
    cfg = smoke_config("mamba2-780m")
    model = LM(cfg, device="cpu", seed=0)
    toks = torch.from_numpy(np.random.default_rng(5).integers(0, cfg.vocab, (2, 40))).long()
    with torch.no_grad():
        got, _ = model(toks, kernel_impl="flash_scan")
        want, _ = model(toks, kernel_impl="xla")
    assert torch.equal(got, want)


def test_train_step_takes_flash_scan():
    cfg = dataclasses.replace(smoke_config("recurrentgemma-2b"), n_layers=3)
    model = LM(cfg, device="cpu", seed=0)
    params = {k: v.detach() for k, v in model.state_dict().items()}
    rng = np.random.default_rng(2)
    batch = {k: torch.from_numpy(rng.integers(0, cfg.vocab, (2, 40))).long()
             for k in ("tokens", "labels")}
    step = make_train_step(cfg, AdamWConfig(lr=1e-3, warmup_steps=0),
                           TrainOptions(kernel_impl="flash_scan"))
    new, _, metrics = step(params, init_opt_state(params), batch)
    with torch.no_grad():
        total, _ = model.train_loss(batch["tokens"], batch["labels"], kernel_impl="flash_scan")
    assert float(metrics["loss"]) == float(total)
    assert any(not torch.equal(new[k], params[k]) for k in params)


# ---------------------------------------------------------------------- #
# The dry run's count of one local-attention layer.
# ---------------------------------------------------------------------- #
def test_local_attention_flops_are_the_reference_scan_term():
    cfg = get_config("recurrentgemma-2b")
    B, S, W, bq = 1, 4096, cfg.swa_window, 512
    H, Hkv, hd, D = cfg.n_heads, cfg.n_kv_heads, cfg.hd, cfg.d_model
    mod = att.Attention(D, H, Hkv, hd, device="meta")
    x = torch.empty((B, S, D), dtype=torch.bfloat16, device="meta")
    with FlopCounterMode(display=False) as fc:
        att.attention(mod, x, n_heads=H, n_kv_heads=Hkv, head_dim=hd,
                      rope_theta=cfg.rope_theta, window=W, kernel_impl="xla")
    projections = 2 * B * S * D * (2 * H * hd + 2 * Hkv * hd)
    assert fc.get_total_flops() == projections + 4 * B * S * min(W + bq, S) * H * hd

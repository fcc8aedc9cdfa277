"""The audio and vision families, the int8 KV cache and ``input_specs``
against the JAX package, at smoke size, on the same weights (the JAX
package's ``init_params`` through ``convert.lm_params_from_numpy``) and
the same numpy-seeded inputs.

whisper-small: the encoder (``encode``), one ``xdec`` block in train,
prefill and decode mode, prefill logits and every serving-state leaf (the
``{"kv", "cross"}`` layer state), decode logits and train logits.
internvl2-1b: the same with ``vision_embeds`` and without.  The int8 cache
on h2o-danube-3-4b's smoke config with ``kv_quant_int8=True`` (the
reference's ``tests/test_perf_variants.py`` variant).  The JAX side runs
B5 through its ``pallas`` route in interpret mode, as
``tests/test_torch_lm.py`` does.

Tolerances are ``tests/test_torch_lm.py``'s: bf16 outputs and logits
within rtol = atol = 3e-2, float serving-state leaves within 3e-2 of the
leaf's largest magnitude, integer leaves exactly.  int8 cache values are
held exactly where the two sides quantize the same bf16 input
(``_quantize`` fed one tensor); inside a model the bf16 k and v may differ
by one rounding step across frameworks (ROADMAP C2), which can move an
int8 value across a .5 boundary: one layer's int8 values fed the same
input are held within 1, a whole model's caches dequantized (value times
scale) as float leaves.  ``input_specs`` must give the reference's
keys, shapes and dtypes for every arch and shape.
"""
from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_lm import T, close, f32, leaves_close, load, np_tree

from repro.configs import REGISTRY as REF_REGISTRY
from repro.configs import input_specs as ref_input_specs
from repro.configs import smoke_config as ref_smoke_config
from repro.models import attention as ref_att
from repro.models import decode_step as ref_decode_step
from repro.models import forward as ref_forward
from repro.models import init_params as ref_init_params
from repro.models import prefill as ref_prefill
from repro.models import serve_state as ref_serve_state
from repro.models.lm import _block_apply as ref_block_apply
from repro.models.lm import encode as ref_encode
from repro_torch.configs import REGISTRY, SHAPES, input_specs, smoke_config
from repro_torch.convert import (lm_params_from_numpy, serve_state_from_numpy,
                                 serve_state_to_numpy, tensor_to_numpy)
from repro_torch.models import LM
from repro_torch.models import attention as att
from repro_torch.serve import Engine, ServeConfig

FAMILIES = ["whisper-small", "internvl2-1b"]


def models(arch, int8=False, seed=0):
    """The reference's params and config, and the port's LM holding them."""
    jcfg, cfg = ref_smoke_config(arch), smoke_config(arch)
    if int8:
        jcfg = dataclasses.replace(jcfg, kv_quant_int8=True)
        cfg = dataclasses.replace(cfg, kv_quant_int8=True)
    params = ref_init_params(jax.random.PRNGKey(seed), jcfg)
    model = LM(cfg, device="cpu", seed=None)
    model.load_state_dict(lm_params_from_numpy(cfg, np_tree(params)))
    return jcfg, params, cfg, model


def inputs(cfg, B, S, seed, vision=True):
    """Tokens and the family's frontend stub (bf16, numpy seed): the
    reference's batch dict and the port's keyword tensors."""
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab, (B, S)).astype(np.int32)
    batch, kw = {"tokens": jnp.asarray(toks)}, {}
    if cfg.family == "audio":
        e = cfg.encoder
        frames = rng.normal(size=(B, e.n_ctx, e.d_model)).astype(np.float32)
        batch["frames"] = jnp.asarray(frames, jnp.bfloat16)
        kw["frames"] = torch.tensor(frames).to(torch.bfloat16)
    elif cfg.family == "vlm" and vision:
        ve = rng.normal(size=(B, cfg.n_vision_tokens, cfg.d_model)).astype(np.float32)
        batch["vision_embeds"] = jnp.asarray(ve)      # float32: the model casts
        kw["vision_embeds"] = torch.tensor(ve)
    return toks, batch, kw


def int8_leaves_close(got, want):
    """Serving-state leaves as ``leaves_close``, int8 values within 1 (one
    layer's k and v: inputs within one bf16 step)."""
    assert len(got) == len(want)
    for g, w in zip(got, want):
        g, w = np.asarray(g), np.asarray(w)
        if w.dtype == np.int8:
            assert g.dtype == np.int8 and g.shape == w.shape
            assert np.abs(g.astype(np.int32) - w.astype(np.int32)).max() <= 1
        else:
            leaves_close([g], [w])


def dequantized(tree):
    """Every int8 cache in a grouped serving state replaced by its float32
    k and v (value times scale), the rest as it is."""
    if isinstance(tree, dict) and "k_scale" in tree:
        return {"k": tree["k"].astype(np.float32) * tree["k_scale"][..., None],
                "v": tree["v"].astype(np.float32) * tree["v_scale"][..., None],
                "pos": tree["pos"], "k_scale": tree["k_scale"], "v_scale": tree["v_scale"]}
    if isinstance(tree, dict):
        return {k: dequantized(v) for k, v in tree.items()}
    if isinstance(tree, tuple):
        return tuple(dequantized(v) for v in tree)
    return tree


def state_close(got, want, int8):
    """Grouped serving states (numpy): one structure, then every leaf by
    ``leaves_close``; an int8 cache's k and v compared dequantized (across
    layers the bf16 inputs drift by more than one rounding step, and an int8
    value moves with them)."""
    assert jax.tree.structure(got) == jax.tree.structure(want)
    if int8:
        for g, w in zip(jax.tree.leaves(got), jax.tree.leaves(want)):
            assert np.asarray(g).dtype == np.asarray(w).dtype
        got, want = dequantized(got), dequantized(want)
    leaves_close(jax.tree.leaves(got), jax.tree.leaves(want))


# ---------------------------------------------------------------------- #
# The encoder and one xdec block.
# ---------------------------------------------------------------------- #
def test_encode_matches_reference():
    jcfg, params, cfg, model = models("whisper-small")
    _, batch, kw = inputs(cfg, 2, 8, 20)
    want = ref_encode(params, jcfg, batch["frames"], kernel_impl="pallas")
    with torch.inference_mode():
        got = model.encode(kw["frames"])
    assert got.dtype == torch.bfloat16 and got.shape == (2, cfg.encoder.n_ctx, 64)
    close(got, want)


def test_xdec_block_matches_reference_in_each_mode():
    jcfg, params, cfg, model = models("whisper-small")
    bp = jax.tree.map(lambda leaf: leaf[0], params["groups"]["c0"])
    blk = model.layers[0]
    B, S, budget = 2, 20, 6
    rng = np.random.default_rng(21)
    x = rng.normal(size=(B, S, 64)).astype(np.float32)
    enc = rng.normal(size=(B, cfg.encoder.n_ctx, 64)).astype(np.float32)
    jx, jenc = jnp.asarray(x, jnp.bfloat16), jnp.asarray(enc, jnp.bfloat16)
    tx, tenc = torch.tensor(x).bfloat16(), torch.tensor(enc).bfloat16()
    with torch.inference_mode():
        for mode in ("train", "prefill"):
            want, want_c, _ = ref_block_apply(jcfg, "xdec", bp, jx, mode=mode, enc_kv=jenc,
                                              kernel_impl="pallas", max_cache_len=S + budget)
            got, got_c, _ = model._block(blk, tx, mode=mode, enc_out=tenc,
                                         max_cache_len=S + budget)
            close(got, want)
        assert set(got_c) == {"kv", "cross"} and set(got_c["cross"]) == {"k", "v"}
        leaves_close(jax.tree.leaves(jax.tree.map(tensor_to_numpy, got_c)),
                     jax.tree.leaves(np_tree(want_c)))
        # Decode from the reference's state; the cross cache is only read.
        state = jax.tree.map(T, np_tree(want_c))
        cross = {k: v.clone() for k, v in state["cross"].items()}
        jt = rng.normal(size=(B, 1, 64)).astype(np.float32)
        pos = np.full((B,), S, np.int32)
        want, want_c, _ = ref_block_apply(jcfg, "xdec", bp, jnp.asarray(jt, jnp.bfloat16),
                                          mode="decode", cache=want_c,
                                          pos=jnp.asarray(pos), kernel_impl="pallas")
        got, got_c, _ = model._block(blk, torch.tensor(jt).bfloat16(), mode="decode",
                                     cache=state, pos=torch.tensor(pos))
    close(got, want)
    assert all(torch.equal(got_c["cross"][k], cross[k]) for k in cross)
    leaves_close(jax.tree.leaves(jax.tree.map(tensor_to_numpy, got_c)),
                 jax.tree.leaves(np_tree(want_c)))


# ---------------------------------------------------------------------- #
# Whole models.
# ---------------------------------------------------------------------- #
def assert_prefill_and_decode_match(arch, int8=False, vision=True):
    jcfg, params, cfg, model = models(arch, int8)
    B, S, budget = 2, 24, 6
    toks, batch, kw = inputs(cfg, B, S, 22, vision)
    P = S + (cfg.n_vision_tokens if "vision_embeds" in kw else 0)
    want, want_c = ref_prefill(params, jcfg, batch, kernel_impl="pallas",
                               max_cache_len=P + budget)
    got, got_c = model.prefill(torch.tensor(toks), max_cache_len=P + budget, **kw)
    assert got.shape == (B, cfg.vocab_padded) and got.dtype == torch.float32
    close(got, want)
    state_close(serve_state_to_numpy(cfg, got_c), np_tree(want_c), int8)
    # Decode two steps from the reference's caches.
    caches, jc = serve_state_from_numpy(cfg, np_tree(want_c)), want_c
    rng = np.random.default_rng(23)
    for step in range(2):
        nt = rng.integers(0, cfg.vocab, (B, 1)).astype(np.int32)
        pos = np.full((B,), P + step, np.int32)
        want_d, jc = ref_decode_step(params, jcfg, jnp.asarray(nt), jnp.asarray(pos), jc,
                                     kernel_impl="pallas")
        got_d, caches = model.decode_step(torch.tensor(nt), torch.tensor(pos), caches)
        close(got_d, want_d)
    state_close(serve_state_to_numpy(cfg, caches), np_tree(jc), int8)


@pytest.mark.parametrize("arch,vision", [("whisper-small", True), ("internvl2-1b", True),
                                         ("internvl2-1b", False)])
def test_prefill_caches_and_decode_match_reference(arch, vision):
    assert_prefill_and_decode_match(arch, vision=vision)


def assert_train_logits_match(arch):
    """The smoke model's train logits against the reference's forward."""
    jcfg, params, cfg, model = models(arch)
    toks, batch, kw = inputs(cfg, 2, 16, 24)
    want, _, _ = ref_forward(params, jcfg, batch, mode="train", kernel_impl="pallas")
    with torch.inference_mode():
        got, none = model(torch.tensor(toks), mode="train", **kw)
    assert none is None and got.shape == want.shape
    close(got, want)


@pytest.mark.parametrize("arch", FAMILIES)
def test_train_logits_match_reference(arch):
    assert_train_logits_match(arch)


@pytest.mark.parametrize("arch", FAMILIES)
def test_decode_matches_full_forward(arch):
    """The port's own prefill -> decode_step equals the last position of a
    full forward over prompt + token (bar 3e-2, as the reference's
    ``tests/test_models_consistency.py``)."""
    cfg = smoke_config(arch)
    model = LM(cfg, device="cpu", seed=1)
    toks, _, kw = inputs(cfg, 2, 13, 25)
    t = torch.tensor(toks, dtype=torch.int64)
    P = 12 + (cfg.n_vision_tokens if "vision_embeds" in kw else 0)
    _, caches = model.prefill(t[:, :-1], max_cache_len=P + 4, **kw)
    lg_dec, _ = model.decode_step(t[:, -1:], torch.full((2,), P), caches)
    with torch.inference_mode():
        lg_full, _ = model(t, mode="train", **kw)
    close(lg_dec, lg_full[:, -1])


# ---------------------------------------------------------------------- #
# The int8 KV cache.
# ---------------------------------------------------------------------- #
def test_quantize_equals_the_reference_on_equal_inputs():
    rng = np.random.default_rng(26)
    x = rng.normal(size=(3, 7, 2, 16)).astype(np.float32)
    x[0, 0, 0] = 0.0                              # an all-zero row: scale 0
    x[1, 1, 1, :4] = [127.0, 63.5, -0.5, 1.5]     # .5 ties: half to even
    jx = jnp.asarray(x, jnp.bfloat16)
    want_q, want_s = ref_att._quantize(jx)
    got_q, got_s = att._quantize(T(np.asarray(jx)))
    assert got_q.dtype == torch.int8 and got_s.dtype == torch.float32
    assert np.array_equal(got_q.numpy(), np.asarray(want_q))
    assert np.array_equal(got_s.numpy(), np.asarray(want_s))
    cache = {"k": got_q, "v": got_q, "k_scale": got_s, "v_scale": got_s}
    jc = {"k": want_q, "v": want_q, "k_scale": want_s, "v_scale": want_s}
    assert np.array_equal(att._deq_k(cache).numpy(), np.asarray(ref_att._deq_k(jc)))
    assert np.array_equal(f32(att._deq_v(cache)), f32(ref_att._deq_v(jc)))


def test_int8_cache_init_and_decode_fed_a_reference_cache():
    kw = dict(n_heads=4, n_kv_heads=2, head_dim=16, rope_theta=10000.0)
    c = att.cache_init(2, 9, 2, 16, quant=True)
    want = ref_att.cache_init(2, 9, 2, 16, quant=True)
    assert set(c) == set(want)
    for k in c:
        assert np.array_equal(tensor_to_numpy(c[k]), np.asarray(want[k]))
    p = ref_att.attn_init(jax.random.PRNGKey(27), 64, 4, 2, 16)
    mod = load(att.Attention(64, 4, 2, 16, device="cpu"), p)
    rng = np.random.default_rng(28)
    jx = jnp.asarray(rng.normal(size=(2, 30, 64)), jnp.bfloat16)
    jc = ref_att.cache_prefill(p, jx, cache_len=40, quant=True, **kw)
    _, k, v = att.attention(mod, T(np.asarray(jx)), return_kv=True, **kw)
    int8_leaves_close([tensor_to_numpy(x) for x in att.cache_from_kv(k, v, 40, quant=True)
                       .values()], [np.asarray(jc[n]) for n in ("k", "v", "pos",
                                                                "k_scale", "v_scale")])
    jt = jnp.asarray(rng.normal(size=(2, 1, 64)), jnp.bfloat16)
    pos = np.array([30, 30], np.int32)
    want_o, want_c = ref_att.attention_decode(p, jt, jc, jnp.asarray(pos), **kw)
    cache = {n: T(v) for n, v in np_tree(jc).items()}
    got_o, got_c = att.attention_decode(mod, T(np.asarray(jt)), cache, torch.tensor(pos), **kw)
    close(got_o, want_o)
    assert got_c is cache                      # written in place
    int8_leaves_close([tensor_to_numpy(got_c[n]) for n in sorted(got_c)],
                      [np.asarray(want_c[n]) for n in sorted(want_c)])


def test_int8_kv_cache_close_to_the_bf16_cache():
    """The reference's ``test_int8_kv_cache_close_to_fp`` on the port
    (qwen2-72b's smoke config, the same 0.15 bar on the decode logits), and
    the int8 cache's bytes: under 3/4 of the bf16 cache's."""
    cfg = smoke_config("qwen2-72b")
    cfgq = dataclasses.replace(cfg, kv_quant_int8=True)
    model, modelq = LM(cfg, device="cpu", seed=1), LM(cfgq, device="cpu", seed=None)
    modelq.load_state_dict(model.state_dict())
    B, S = 2, 24
    toks = torch.tensor(np.random.default_rng(29).integers(0, cfg.vocab, (B, S + 1)))
    lg = []
    for m in (model, modelq):
        _, c = m.prefill(toks[:, :-1], max_cache_len=S + 8)
        lg.append(m.decode_step(toks[:, -1:], torch.full((B,), S), c)[0])
    assert c[0]["k"].dtype == torch.int8 and "k_scale" in c[0]
    assert float((lg[0] - lg[1]).abs().max()) < 0.15

    def nbytes(state):
        return sum(t.numel() * t.element_size() for layer in state for t in layer.values())
    assert nbytes(modelq.serve_state(4, 128)) < 0.75 * nbytes(model.serve_state(4, 128))


@pytest.mark.parametrize("arch", ["whisper-small", "internvl2-1b", "h2o-danube-3-4b"])
def test_serve_state_matches_reference_layout(arch):
    for int8 in (False, True):
        jcfg, cfg = ref_smoke_config(arch), smoke_config(arch)
        jcfg = dataclasses.replace(jcfg, kv_quant_int8=int8)
        cfg = dataclasses.replace(cfg, kv_quant_int8=int8)
        want = np_tree(ref_serve_state(jcfg, 2, 30))
        got = serve_state_to_numpy(cfg, LM(cfg, device="cpu", seed=None).serve_state(2, 30))
        assert jax.tree.structure(want) == jax.tree.structure(got)
        for g, w in zip(jax.tree.leaves(got), jax.tree.leaves(want)):
            assert g.dtype == w.dtype and np.array_equal(g, w)
        back = serve_state_to_numpy(cfg, serve_state_from_numpy(cfg, want))
        for g, w in zip(jax.tree.leaves(back), jax.tree.leaves(want)):
            assert np.array_equal(g, w)


def test_parameter_counts_match_reference():
    for arch in FAMILIES:
        ref = jax.tree.leaves(ref_init_params(jax.random.PRNGKey(0), ref_smoke_config(arch)))
        model = LM(smoke_config(arch), device="cpu", seed=None)
        assert sum(p.numel() for p in model.parameters()) == sum(x.size for x in ref)


def test_audio_needs_frames_and_the_engine_refuses_it():
    cfg = smoke_config("whisper-small")
    model = LM(cfg, device="cpu", seed=0)
    with pytest.raises(ValueError, match="frames="):
        model.prefill(torch.zeros((1, 4), dtype=torch.int64))
    with pytest.raises(ValueError, match="LM.prefill"):
        Engine(cfg, model, ServeConfig(batch_size=1))


# ---------------------------------------------------------------------- #
# input_specs.
# ---------------------------------------------------------------------- #
@pytest.mark.parametrize("shape", list(SHAPES))
@pytest.mark.parametrize("arch", sorted(REGISTRY))
def test_input_specs_match_reference(arch, shape):
    cfg, jcfg = REGISTRY[arch], REF_REGISTRY[arch]
    if shape in jcfg.skip_shapes:
        with pytest.raises(ValueError, match="skipped"):
            ref_input_specs(jcfg, shape)
        with pytest.raises(ValueError, match="skipped"):
            input_specs(cfg, shape)
        return
    want, got = ref_input_specs(jcfg, shape), input_specs(cfg, shape)
    assert list(got) == list(want)
    for name, spec in want.items():
        t = got[name]
        assert t.device.type == "meta" and tuple(t.shape) == spec.shape
        assert str(t.dtype).removeprefix("torch.") == str(spec.dtype)

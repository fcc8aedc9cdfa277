"""The port's model stack against the JAX package's, on the same weights
(the JAX package's ``init_params`` carried over by
``repro_torch.convert.lm_params_from_numpy``) and the same numpy-seeded
inputs: the layers and blocks one by one (prefill and decode), then whole
smoke-size models' prefill logits, every serving-state leaf and
``decode_step`` logits against JAX ``kernel_impl="pallas"`` (its Pallas
kernels in interpret mode), with prompts longer than the smoke SWA window
of 16 so the ring caches wrap.

Tolerances.  Everything is bf16 with float32 islands, and the two
frameworks round bf16 at the same places but sum in other orders, so a
bf16 result may differ by one rounding step (2^-8 relative) that later
layers carry on.  bf16 outputs and logits are held within rtol = atol =
3e-2, the reference's own bf16 bar (``tests/test_kernels.py``,
``tests/test_models_consistency.py``); float leaves of the serving state
within 3e-2 of the leaf's largest magnitude; integer leaves (cache
positions) exactly; float32-only arithmetic (RoPE) within 1e-4.
"""
from __future__ import annotations

from typing import Any, Dict

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import smoke_config as ref_smoke_config
from repro.models import attention as ref_att
from repro.models import decode_step as ref_decode_step
from repro.models import init_params as ref_init_params
from repro.models import layers as ref_layers
from repro.models import prefill as ref_prefill
from repro.models import rglru as ref_rg
from repro.models import ssm as ref_ssm
from repro_torch.configs import get_config, smoke_config
from repro_torch.convert import (lm_params_from_numpy, serve_state_from_numpy,
                                 serve_state_to_numpy, tensor_from_numpy,
                                 tensor_to_numpy)
from repro_torch.models import LM, layer_kinds, layer_plan
from repro_torch.models import attention as att
from repro_torch.models import layers
from repro_torch.models import rglru as rg
from repro_torch.models import ssm

TOL = 3e-2
ARCHS = ["recurrentgemma-2b", "mamba2-780m", "h2o-danube-3-4b"]


def np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def T(a) -> torch.Tensor:
    return tensor_from_numpy(np.asarray(a))


def f32(a) -> np.ndarray:
    return np.asarray(a, np.float32) if not isinstance(a, torch.Tensor) \
        else a.float().numpy()


def close(got, want, tol=TOL):
    np.testing.assert_allclose(f32(got), f32(want), rtol=tol, atol=tol)


def leaves_close(got, want, tol=TOL):
    """Serving-state leaves: integers exactly, floats within ``tol`` of the
    leaf's largest magnitude."""
    assert len(got) == len(want)
    for i, (g, w) in enumerate(zip(got, want)):
        g, w = np.asarray(g), np.asarray(w)
        assert g.shape == w.shape and g.dtype == w.dtype, (i, g.shape, w.shape, g.dtype, w.dtype)
        if w.dtype.kind in "iu":
            assert np.array_equal(g, w), f"leaf {i}: integers differ"
            continue
        g, w = g.astype(np.float64), w.astype(np.float64)
        bound = tol * max(1.0, np.abs(w).max())
        assert np.abs(g - w).max() <= bound, (i, np.abs(g - w).max(), bound)


def load(module: torch.nn.Module, params: Dict[str, Any]) -> torch.nn.Module:
    """``module`` holding the JAX block params ``params`` (same names)."""
    flat = {}

    def walk(tree, prefix):
        for k, v in tree.items():
            if isinstance(v, dict):
                walk(v, f"{prefix}{k}.")
            else:
                flat[prefix + k] = T(v)
    walk(np_tree(params), "")
    module.load_state_dict(flat)
    return module


def bf16_input(shape, seed, scale=1.0):
    x = np.random.default_rng(seed).normal(scale=scale, size=shape).astype(np.float32)
    return jnp.asarray(x, jnp.bfloat16), torch.tensor(x).to(torch.bfloat16)


# ---------------------------------------------------------------------- #
# Layers.
# ---------------------------------------------------------------------- #
def test_rmsnorm_matches_reference():
    jx, tx = bf16_input((2, 5, 64), 0, 3.0)
    scale = np.random.default_rng(1).normal(scale=0.1, size=64).astype(np.float32)
    want = ref_layers.rmsnorm({"scale": jnp.asarray(scale, jnp.bfloat16)}, jx)
    got = layers.rmsnorm(tx, torch.tensor(scale).to(torch.bfloat16))
    assert got.dtype == torch.bfloat16
    close(got, want, 1e-2)   # one bf16 rounding step at most


def test_apply_rope_matches_reference():
    x = np.random.default_rng(2).normal(size=(2, 40, 3, 16)).astype(np.float32)
    pos = np.arange(40, dtype=np.int32)[None, :]
    want = ref_layers.apply_rope(jnp.asarray(x), jnp.asarray(pos), 10000.0)
    got = layers.apply_rope(torch.tensor(x), torch.tensor(pos), 10000.0)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4, atol=1e-4)
    assert torch.allclose(layers.rope_freqs(16, 10000.0),
                          torch.tensor(np.asarray(ref_layers.rope_freqs(16, 10000.0))))


def test_swiglu_and_gelu_mlp_match_reference():
    jx, tx = bf16_input((2, 6, 64), 3)
    p = ref_layers.swiglu_init(jax.random.PRNGKey(0), 64, 128)
    mlp = load(layers.SwiGLU(64, 128, device="cpu"), p)
    close(mlp(tx), ref_layers.swiglu(p, jx))
    g = np_tree(ref_layers.gelu_mlp_init(jax.random.PRNGKey(1), 64, 128))
    want = ref_layers.gelu_mlp(g, jx)
    got = layers.gelu_mlp(tx, T(g["w_in"]), T(g["b_in"]), T(g["w_out"]), T(g["b_out"]))
    close(got, want)


def test_embed_and_unembed_match_reference():
    w = np.random.default_rng(4).normal(size=(50, 64)).astype(np.float32)
    toks = np.array([[3, 0, 49], [7, 7, 1]])
    jw = jnp.asarray(w, jnp.bfloat16)
    tw = torch.tensor(w).to(torch.bfloat16)
    e = layers.embed_lookup(tw, torch.tensor(toks))
    assert torch.equal(e, T(ref_layers.embed_lookup(jw, jnp.asarray(toks))))
    close(layers.unembed(e, tw.float()), ref_layers.unembed(ref_layers.embed_lookup(
        jw, jnp.asarray(toks)), jw), 1e-5)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_embed_lookup_out_of_range_ids_fill_nan_as_reference(dtype):
    """``jnp.take``'s "fill" mode: ids in [-V, V) index the table (negative
    from the end), any other id a NaN row; no IndexError on the CPU."""
    V = 10
    w = np.random.default_rng(5).normal(size=(V, 4)).astype(np.float32)
    toks = np.array([[-2 ** 20, -V, -1, 0], [V - 1, V, 2 ** 20, 5]])
    jdt = jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32
    want = np.asarray(ref_layers.embed_lookup(jnp.asarray(w, jdt), jnp.asarray(toks)),
                      np.float32)
    got = layers.embed_lookup(torch.tensor(w).to(dtype), torch.tensor(toks))
    assert got.dtype == dtype and tuple(got.shape) == want.shape
    got = got.float().numpy()
    assert np.array_equal(np.isnan(got), np.isnan(want))
    assert np.isnan(want[0, 0]).all() and np.isnan(want[1, 1:3]).all()
    np.testing.assert_array_equal(got[~np.isnan(want)], want[~np.isnan(want)])
    # argmax over NaN logits picks the first NaN, as jnp.argmax does.
    lg = np.array([[1.0, np.nan, 3.0], [np.nan, np.nan, np.nan]], np.float32)
    assert torch.argmax(torch.tensor(lg), dim=-1).tolist() == \
        np.asarray(jnp.argmax(jnp.asarray(lg), axis=-1)).tolist() == [1, 0]


# ---------------------------------------------------------------------- #
# Blocks, prefill and decode.
# ---------------------------------------------------------------------- #
ATT_KW = dict(n_heads=4, n_kv_heads=2, head_dim=16, rope_theta=10000.0)


@pytest.mark.parametrize("window", [None, 16])
def test_attention_and_cache_prefill_match_reference(window):
    S, cache_len = 40, 16 if window else 48
    jx, tx = bf16_input((2, S, 64), 5)
    p = ref_att.attn_init(jax.random.PRNGKey(2), 64, 4, 2, 16)
    mod = load(att.Attention(64, 4, 2, 16, device="cpu"), p)
    want = ref_att.attention(p, jx, window=window, kernel_impl="pallas", **ATT_KW)
    got, k, v = att.attention(mod, tx, window=window, return_kv=True, **ATT_KW)
    close(got, want)
    # The port builds the ring from attention's own k and v, as the LM does.
    want_c = ref_att.cache_prefill(p, jx, cache_len=cache_len, **ATT_KW)
    cache = att.cache_from_kv(k, v, cache_len)
    leaves_close([tensor_to_numpy(cache[n]) for n in ("k", "pos", "v")],
                 [np.asarray(want_c[n]) for n in ("k", "pos", "v")])


@pytest.mark.parametrize("window", [None, 16])
def test_attention_decode_fed_a_reference_cache(window):
    S, cache_len = 40, 16 if window else 48
    jx, _ = bf16_input((2, S, 64), 6)
    jt, tt = bf16_input((2, 1, 64), 7)
    p = ref_att.attn_init(jax.random.PRNGKey(3), 64, 4, 2, 16)
    mod = load(att.Attention(64, 4, 2, 16, device="cpu"), p)
    jc = ref_att.cache_prefill(p, jx, cache_len=cache_len, **ATT_KW)
    pos = np.array([S, S], np.int32)
    want, want_c = ref_att.attention_decode(p, jt, jc, jnp.asarray(pos), window=window,
                                            **ATT_KW)
    cache = {k: T(v) for k, v in np_tree(jc).items()}
    got, got_c = att.attention_decode(mod, tt, cache, torch.tensor(pos), window=window,
                                      **ATT_KW)
    close(got, want)
    leaves_close([tensor_to_numpy(got_c[n]) for n in ("k", "pos", "v")],
                 [np.asarray(want_c[n]) for n in ("k", "pos", "v")])


def test_rglru_block_prefill_and_decode_match_reference():
    cfg = smoke_config("recurrentgemma-2b").rglru
    p = ref_rg.rglru_block_init(jax.random.PRNGKey(4), 64, cfg)
    mod = load(rg.RGLRUBlock(64, cfg, device="cpu"), p)
    jx, tx = bf16_input((2, 40, 64), 8)
    want, want_s = ref_rg.rglru_block(p, jx, cfg, mode="prefill", kernel_impl="pallas")
    got, got_s = rg.rglru_block(mod, tx, mode="prefill")
    close(got, want)
    leaves_close([tensor_to_numpy(got_s[n]) for n in ("conv", "h")],
                 [np.asarray(want_s[n]) for n in ("conv", "h")])
    jt, tt = bf16_input((2, 1, 64), 9)
    want2, want_s2 = ref_rg.rglru_block(p, jt, cfg, mode="decode", state=want_s)
    got2, got_s2 = rg.rglru_block(mod, tt, mode="decode",
                                  state={k: T(v) for k, v in np_tree(want_s).items()})
    close(got2, want2)
    leaves_close([tensor_to_numpy(got_s2[n]) for n in ("conv", "h")],
                 [np.asarray(want_s2[n]) for n in ("conv", "h")])


def test_mamba2_block_prefill_and_decode_match_reference():
    s = smoke_config("mamba2-780m").ssm
    p = ref_ssm.mamba2_init(jax.random.PRNGKey(5), 64, s)
    mod = load(ssm.Mamba2Block(64, s, device="cpu"), p)
    jx, tx = bf16_input((2, 37, 64), 10)   # 37 % chunk 8 != 0: padded tail
    want, want_s = ref_ssm.mamba2_block(p, jx, s, mode="prefill", kernel_impl="pallas")
    got, got_s = ssm.mamba2_block(mod, tx, s, mode="prefill")
    close(got, want)
    leaves_close([tensor_to_numpy(got_s[n]) for n in ("conv", "ssm")],
                 [np.asarray(want_s[n]) for n in ("conv", "ssm")])
    jt, tt = bf16_input((2, 1, 64), 11)
    want2, want_s2 = ref_ssm.mamba2_block(p, jt, s, mode="decode", state=want_s)
    got2, got_s2 = ssm.mamba2_block(mod, tt, s, mode="decode",
                                    state={k: T(v) for k, v in np_tree(want_s).items()})
    close(got2, want2)
    leaves_close([tensor_to_numpy(got_s2[n]) for n in ("conv", "ssm")],
                 [np.asarray(want_s2[n]) for n in ("conv", "ssm")])


# ---------------------------------------------------------------------- #
# Whole models.
# ---------------------------------------------------------------------- #
def models(arch, seed=0):
    """The reference's params and config, and the port's LM holding them."""
    jcfg, cfg = ref_smoke_config(arch), smoke_config(arch)
    params = ref_init_params(jax.random.PRNGKey(seed), jcfg)
    model = LM(cfg, device="cpu", seed=None)
    model.load_state_dict(lm_params_from_numpy(cfg, np_tree(params)))
    return jcfg, params, cfg, model


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_caches_and_decode_match_reference(arch):
    jcfg, params, cfg, model = models(arch)
    B, S, budget = 2, 40, 8
    rng = np.random.default_rng(12)
    toks = rng.integers(0, cfg.vocab, (B, S)).astype(np.int32)
    want, want_c = ref_prefill(params, jcfg, {"tokens": jnp.asarray(toks)},
                               kernel_impl="pallas", max_cache_len=S + budget)
    got, got_c = model.prefill(torch.tensor(toks), max_cache_len=S + budget)
    assert got.shape == (B, cfg.vocab_padded) and got.dtype == torch.float32
    close(got, want)
    got_np = serve_state_to_numpy(cfg, got_c)
    leaves_close(jax.tree.leaves(got_np), jax.tree.leaves(np_tree(want_c)))

    # Decode two steps from the reference's caches.
    caches, jc = serve_state_from_numpy(cfg, np_tree(want_c)), want_c
    for step in range(2):
        nt = rng.integers(0, cfg.vocab, (B, 1)).astype(np.int32)
        pos = np.full((B,), S + step, np.int32)
        want_d, jc = ref_decode_step(params, jcfg, jnp.asarray(nt), jnp.asarray(pos), jc,
                                     kernel_impl="pallas")
        got_d, caches = model.decode_step(torch.tensor(nt), torch.tensor(pos), caches)
        close(got_d, want_d)
    leaves_close(jax.tree.leaves(serve_state_to_numpy(cfg, caches)),
                 jax.tree.leaves(np_tree(jc)))


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_matches_full_forward(arch):
    """The port's own prefill -> decode_step equals the last position of a
    full forward over prompt + token (bar 3e-2, as the reference's
    ``tests/test_models_consistency.py``); the window of 16 wraps."""
    cfg = smoke_config(arch)
    model = LM(cfg, device="cpu", seed=1)
    B, S = 2, 24
    toks = torch.tensor(np.random.default_rng(13).integers(0, cfg.vocab, (B, S + 1)))
    _, caches = model.prefill(toks[:, :-1], max_cache_len=S + 8)
    lg_dec, _ = model.decode_step(toks[:, -1:], torch.full((B,), S), caches)
    with torch.inference_mode():
        lg_full, none = model(toks, mode="train")
    assert none is None and lg_full.shape == (B, S + 1, cfg.vocab_padded)
    close(lg_dec, lg_full[:, -1])


def test_serve_state_matches_reference_layout():
    from repro.models import serve_state as ref_serve_state
    for arch in ARCHS:
        cfg = smoke_config(arch)
        model = LM(cfg, device="cpu", seed=None)
        want = np_tree(ref_serve_state(ref_smoke_config(arch), 2, 40))
        got = serve_state_to_numpy(cfg, model.serve_state(2, 40))
        assert jax.tree.structure(want) == jax.tree.structure(got)
        for g, w in zip(jax.tree.leaves(got), jax.tree.leaves(want)):
            assert g.dtype == w.dtype and np.array_equal(g, w)
        back = serve_state_to_numpy(cfg, serve_state_from_numpy(cfg, want))
        for g, w in zip(jax.tree.leaves(back), jax.tree.leaves(want)):
            assert np.array_equal(g, w)


def test_full_width_plans_and_parameter_counts():
    rg_kinds = layer_kinds(get_config("recurrentgemma-2b"))
    assert layer_plan(get_config("recurrentgemma-2b")) == (["rec", "rec", "attn_local"], 8,
                                                           ["rec", "rec"])
    assert rg_kinds.count("rec") == 18 and rg_kinds.count("attn_local") == 8
    assert layer_kinds(get_config("mamba2-780m")) == ["ssd"] * 48
    assert get_config("mamba2-780m").vocab_padded == 50432
    for arch in ARCHS:   # the port's modules hold what the reference's init holds
        cfg = smoke_config(arch)
        ref = jax.tree.leaves(ref_init_params(jax.random.PRNGKey(0), ref_smoke_config(arch)))
        model = LM(cfg, device="cpu", seed=None)
        assert sum(p.numel() for p in model.parameters()) == sum(x.size for x in ref)


def test_gemma_embedding_scale_is_rounded_to_bf16():
    _, params, cfg, model = models("recurrentgemma-2b")
    toks = torch.tensor([[1, 2, 3]])
    x = model._embed(toks)
    scale = torch.tensor(8.0).to(torch.bfloat16)   # sqrt(64) is exact
    assert torch.equal(x, model.embed.w[toks] * scale)
    assert float(torch.tensor(2560 ** 0.5).to(torch.bfloat16)) == 50.5


@pytest.mark.parametrize("arch", ["olmoe-1b-7b", "granite-moe-3b-a800m",
                                  "whisper-small", "internvl2-1b"])
def test_unported_families_raise_naming_the_roadmap(arch, monkeypatch):
    """The MoE, audio and vision families, which raised until ROADMAP
    A8b's slices ported them, build and hold their train logits to the
    JAX package (``tests/test_torch_moe.py`` and
    ``tests/test_torch_families.py`` hold them in full)."""
    if smoke_config(arch).family == "moe":
        from test_torch_moe import assert_train_logits_and_aux_match
        assert_train_logits_and_aux_match(arch, monkeypatch)
        return
    from test_torch_families import assert_train_logits_match
    assert_train_logits_match(arch)


def test_model_runs_on_the_card_unless_told_otherwise():
    if torch.cuda.is_available():
        pytest.skip("a card is visible: the default device is valid here")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        LM(smoke_config("mamba2-780m"))


def test_int8_kv_cache_raises_naming_the_roadmap():
    """The int8 KV cache, which raised until ROADMAP A8b ported it: the
    h2o-danube-3-4b smoke model with ``kv_quant_int8=True`` (the reference's
    ``tests/test_perf_variants.py`` variant) holds its prefill logits, every
    cache leaf (int8 values dequantized) and its decode logits to the JAX
    package's (``tests/test_torch_families.py`` states the bars)."""
    from test_torch_families import assert_prefill_and_decode_match
    assert_prefill_and_decode_match("h2o-danube-3-4b", int8=True)

"""The registry's dense and MoE models that the card now serves
(gemma3-12b, granite-8b, h2o-danube-3-4b, granite-moe-3b-a800m, qwen2-72b)
against the JAX package, on the same weights and numpy-seeded inputs.

Each side builds the same narrow config with ``dataclasses.replace`` of
its own package's ``smoke_config``, keeping what sets the arch apart:

* gemma3-12b: 6 layers, so its first global layer (index 5 of the 5:1
  pattern) is built, at its head dim of 240; its window stays at the smoke
  config's 16, so prompts of 40 tokens wrap the local rings;
* h2o-danube-3-4b: its head dim of 120 (uniform window 16);
* qwen2-72b: its QKV bias, drawn non-zero here (both packages initialise
  it to 0, which would hide it);
* every arch keeps its published GQA group: 2 (gemma3-12b), 4
  (h2o-danube-3-4b, granite-8b), 3 (granite-moe-3b-a800m), 8 (qwen2-72b).

Bars as ``tests/test_torch_lm.py`` (bf16, rtol = atol = 3e-2) and the
Engine's margin rule of ``tests/test_torch_serve.py``.  The full-width
tests run on ``meta`` tensors: parameter counts and the cache bytes of a
32 768-token gemma3-12b request.
"""
from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import smoke_config as ref_smoke_config
from repro.models import decode_step as ref_decode_step
from repro.models import init_params as ref_init_params
from repro.models import prefill as ref_prefill
from repro.serve import Engine as RefEngine
from repro.serve import Request as RefRequest
from repro.serve import ServeConfig as RefServeConfig
from repro_torch.configs import get_config, smoke_config
from repro_torch.convert import (lm_params_from_numpy, serve_state_from_numpy,
                                 serve_state_to_numpy)
from repro_torch.models import LM, layer_kinds
from repro_torch.serve import Engine, Request, ServeConfig
from test_torch_lm import TOL, close, leaves_close, np_tree
from test_torch_serve import _requests, _trajectory

# The narrow config of each arch: fields replaced in both packages'
# smoke configs.
NARROW = {
    "gemma3-12b": dict(n_layers=6, head_dim=240, n_kv_heads=2),
    "h2o-danube-3-4b": dict(head_dim=120, n_kv_heads=2),
    "granite-8b": dict(n_kv_heads=2),
    "granite-moe-3b-a800m": dict(n_kv_heads=2),
    "qwen2-72b": dict(n_kv_heads=2),
}
DENSE = ["gemma3-12b", "h2o-danube-3-4b", "granite-8b", "qwen2-72b"]
REGISTRY_ARCHS = DENSE + ["granite-moe-3b-a800m"]
# Published GQA groups (query heads per KV head) the narrow configs keep.
GROUPS = {"gemma3-12b": 2, "h2o-danube-3-4b": 4, "granite-8b": 4,
          "granite-moe-3b-a800m": 3, "qwen2-72b": 8}


def narrow(arch: str):
    """(the JAX package's narrow config, the port's)."""
    return (dataclasses.replace(ref_smoke_config(arch), **NARROW[arch]),
            dataclasses.replace(smoke_config(arch), **NARROW[arch]))


def _with_bias(params, seed: int):
    """``params`` with every QKV bias leaf drawn from N(0, 0.5^2) in bf16."""
    rng = np.random.default_rng(seed)

    def walk(tree):
        if isinstance(tree, dict):
            return {k: (jnp.asarray(rng.normal(0.0, 0.5, np.shape(v)).astype(np.float32),
                                    jnp.bfloat16)
                        if k in ("bq", "bk", "bv") else walk(v))
                    for k, v in tree.items()}
        if isinstance(tree, (list, tuple)):
            return type(tree)(walk(v) for v in tree)
        return tree
    return walk(params)


def models(arch: str, seed: int = 0):
    """The reference's params and narrow config, and the port's LM holding
    them."""
    jcfg, cfg = narrow(arch)
    params = ref_init_params(jax.random.PRNGKey(seed), jcfg)
    if cfg.qkv_bias:
        params = _with_bias(params, seed + 100)
    model = LM(cfg, device="cpu", seed=None)
    model.load_state_dict(lm_params_from_numpy(cfg, np_tree(params)))
    return jcfg, params, cfg, model


@pytest.mark.parametrize("arch", REGISTRY_ARCHS)
def test_narrow_configs_keep_what_sets_each_arch_apart(arch):
    jcfg, cfg = narrow(arch)
    assert dataclasses.asdict(jcfg) == dataclasses.asdict(cfg)
    assert cfg.n_heads // cfg.n_kv_heads == GROUPS[arch]
    full = get_config(arch)
    assert full.n_heads // full.n_kv_heads == GROUPS[arch]
    assert cfg.hd == full.hd or arch not in ("gemma3-12b", "h2o-danube-3-4b")
    kinds = layer_kinds(cfg)
    if arch == "gemma3-12b":
        assert kinds == ["attn_local"] * 5 + ["attn_global"]
    # The port's modules hold what the reference's init holds.
    ref = jax.tree.leaves(ref_init_params(jax.random.PRNGKey(0), jcfg))
    model = LM(cfg, device="cpu", seed=None)
    assert sum(p.numel() for p in model.parameters()) == sum(x.size for x in ref)


@pytest.mark.parametrize("arch", DENSE)
def test_prefill_caches_and_decode_match_reference(arch):
    """Prefill logits, every serving-state leaf and two decode steps from
    the reference's caches (``tests/test_torch_lm.py``'s test, on the
    narrow configs); 40 prompt tokens wrap the windowed rings of 16."""
    jcfg, params, cfg, model = models(arch)
    B, S, budget = 2, 40, 8
    rng = np.random.default_rng(12)
    toks = rng.integers(0, cfg.vocab, (B, S)).astype(np.int32)
    want, want_c = ref_prefill(params, jcfg, {"tokens": jnp.asarray(toks)},
                               kernel_impl="pallas", max_cache_len=S + budget)
    got, got_c = model.prefill(torch.tensor(toks), max_cache_len=S + budget)
    assert got.shape == (B, cfg.vocab_padded) and got.dtype == torch.float32
    close(got, want)
    leaves_close(jax.tree.leaves(serve_state_to_numpy(cfg, got_c)),
                 jax.tree.leaves(np_tree(want_c)))
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


def test_qkv_bias_reaches_the_logits():
    """qwen2-72b's drawn biases move its prefill logits: the test above
    holds a path that uses them."""
    _, _, cfg, model = models("qwen2-72b")
    toks = torch.tensor(np.random.default_rng(4).integers(0, cfg.vocab, (1, 12)))
    with_bias, _ = model.prefill(toks, max_cache_len=12)
    for blk in model.layers:
        for name in ("bq", "bk", "bv"):
            getattr(blk.attn, name).data.zero_()
    without, _ = model.prefill(toks, max_cache_len=12)
    assert float((with_bias - without)[:, :cfg.vocab].abs().max()) > 10 * TOL


@pytest.mark.parametrize("arch", REGISTRY_ARCHS)
def test_engine_matches_reference_engine_under_the_margin_rule(arch, monkeypatch):
    """The Engine's greedy tokens against the reference Engine's under the
    margin rule (``tests/test_torch_serve.py``): along the reference's
    trajectory the port's logits within TOL, tokens equal wherever the
    reference's top-2 margin exceeds twice the step's logit difference.

    granite-moe-3b-a800m: every reference MoE call's routing is recorded
    (``tests/test_torch_moe.py``), the port's router logits on the
    reference's input held to it under the routing margin rule, and the
    port's MoE calls, in the same order, fed it: a near-tied top-k that
    goes the other way moves a token's logits by far more than the bar."""
    jcfg, params, cfg, model = models(arch)
    if cfg.moe is not None:
        _replay_reference_routing(cfg, monkeypatch)
    max_prompt, max_new, B = 32, 8, 2
    reqs = _requests(cfg.vocab, [20, 40, 9, 28], [8, 8, 4, 8], 3)   # 40 > max_prompt: cut
    ref = RefEngine(jcfg, params, RefServeConfig(batch_size=B, max_prompt=max_prompt,
                                                 max_new=max_new, kernel_impl="pallas"))
    want = ref.generate([RefRequest(p, m) for p, m in reqs])
    got = Engine(cfg, model, ServeConfig(batch_size=B, max_prompt=max_prompt,
                                         max_new=max_new)).generate(
        [Request(p, m) for p, m in reqs])
    assert [len(r.tokens) for r in got] == [len(r.tokens) for r in want] == [8, 8, 4, 8]
    compared = 0
    for lo in range(0, len(reqs), B):
        group = reqs[lo:lo + B] + [(np.zeros(1, np.int32), 0)] * (B - len(reqs[lo:lo + B]))
        toks = np.zeros((B, max_prompt), np.int32)
        for i, (p, _) in enumerate(group):
            p = p[-max_prompt:]
            toks[i, max_prompt - len(p):] = p
        ref_toks, margins, errs = _trajectory(jcfg, params, model, toks, max_new,
                                              max_prompt + max_new)
        assert errs.max() <= TOL, errs.max()
        for i in range(min(B, len(reqs) - lo)):
            w, g = want[lo + i].tokens, got[lo + i].tokens
            assert np.array_equal(w, ref_toks[i, :len(w)])
            for step in range(len(w)):
                if margins[i, step] <= 2 * errs[i, step]:
                    break
                assert g[step] == w[step], (arch, lo + i, step, margins[i, step])
                compared += 1
    assert compared >= 2, f"only {compared} tokens had a margin above the rule's"


def _replay_reference_routing(cfg, monkeypatch):
    """Record the reference's MoE routing, call by call, and make the
    port's ``moe.route`` return the recorded routing of the same call (the
    reference's call always runs first); each recorded layer's router
    logits are held to the port's on the reference's own input."""
    from repro_torch.models import moe
    from test_torch_moe import record_ref_routing
    calls, fed = record_ref_routing(monkeypatch)
    own, at = moe.route, [0]

    def replayed(logits, k, gate_e=None):
        jax.effects_barrier()
        h, router, lj, _, ge, _, _ = calls[at[0]]
        lt = moe.router_logits(torch.tensor(np.asarray(router, np.float32)).to(torch.bfloat16),
                               torch.tensor(h).to(torch.bfloat16)).numpy()
        diff = np.abs(lt - lj).max()
        assert diff <= 1e-5 * np.abs(lj).max()
        srt = np.sort(lj, axis=-1)[..., ::-1]
        clear = srt[..., k - 1] - srt[..., k] > 2 * diff
        assert (own(torch.tensor(lt), k).gate_e.numpy() == ge).all(-1)[clear].all()
        (r,) = fed(calls[at[0]:at[0] + 1])
        at[0] += 1
        assert tuple(r.probs.shape) == tuple(logits.shape), "routing replay out of step"
        return r
    monkeypatch.setattr(moe, "route", replayed)


@pytest.mark.parametrize("arch", ["gemma3-12b", "h2o-danube-3-4b"])
def test_decode_after_the_ring_wraps_matches_full_forward(arch):
    """The port's prefill of 24 tokens, then 12 decode steps: the windowed
    rings of 16 slots wrap in the prefill and again in decode; every step's
    logits equal the same position of one forward over prompt + tokens
    (bar 3e-2)."""
    _, cfg = narrow(arch)
    model = LM(cfg, device="cpu", seed=1)
    B, S, n = 2, 24, 12
    toks = torch.tensor(np.random.default_rng(13).integers(0, cfg.vocab, (B, S + n)))
    lg, caches = model.prefill(toks[:, :S], max_cache_len=S + n)
    steps = [lg]
    for t in range(n - 1):
        lg, caches = model.decode_step(toks[:, S + t:S + t + 1],
                                       torch.full((B,), S + t), caches)
        steps.append(lg)
    local = [c for c, k in zip(caches, model.kinds) if k == "attn_local"]
    assert local and all(c["k"].shape[1] == cfg.swa_window for c in local)
    assert all(int(c["pos"].max()) == S + n - 2 for c in local)
    with torch.inference_mode():
        full, _ = model(toks[:, :S + n - 1], mode="train")
    for t, got in enumerate(steps):
        close(got, full[:, S - 1 + t])


def _cache_bytes(cfg, batch: int, max_seq: int) -> int:
    """The ring caches' bytes as ``attention.cache_init`` lays them out:
    bf16 k and v (B, slots, Hkv, hd) and an int32 position a slot; a local
    ring holds min(window, max_seq) slots, a global one max_seq."""
    total = 0
    for kind in layer_kinds(cfg):
        slots = min(cfg.swa_window, max_seq) if kind == "attn_local" else max_seq
        total += batch * slots * (2 * cfg.n_kv_heads * cfg.hd * 2 + 4)
    return total


def test_full_width_gemma3_plan_parameters_and_long_context_cache():
    """gemma3-12b at its published widths on ``meta`` tensors: 40 local and
    8 global layers, 11.62 B parameters (one tied table of 262 144 rows,
    already a multiple of 256), and the serving state of one
    32 768-token request with 32 new tokens: 40 local rings of 1 024 slots,
    8 global rings of 32 800, 2 331 018 240 bytes."""
    cfg = get_config("gemma3-12b")
    kinds = layer_kinds(cfg)
    assert kinds.count("attn_local") == 40 and kinds.count("attn_global") == 8
    assert kinds[5] == "attn_global"
    model = LM(cfg, device="meta", seed=None)
    n = sum(p.numel() for p in model.parameters())
    assert n == cfg.param_count() == 11_623_837_440
    state = model.serve_state(1, 32768 + 32, device="meta")
    got = sum(t.numel() * t.element_size() for c in state for t in c.values())
    assert got == _cache_bytes(cfg, 1, 32800) == 2_331_018_240
    slots = sorted({c["k"].shape[1] for c in state})
    assert slots == [1024, 32800]


@pytest.mark.parametrize("arch,params", [
    ("granite-8b", 8_254_689_280), ("h2o-danube-3-4b", 3_961_839_360),
    ("granite-moe-3b-a800m", 3_374_295_552), ("qwen2-72b", 72_706_203_648)])
def test_full_width_parameter_counts(arch, params):
    """Each arch at its published widths on ``meta`` tensors holds what its
    config counts (padded vocab rows aside)."""
    cfg = get_config(arch)
    model = LM(cfg, device="meta", seed=None)
    n = sum(p.numel() for p in model.parameters())
    tables = 1 if cfg.tie_embeddings else 2
    assert n == cfg.param_count() + tables * (cfg.vocab_padded - cfg.vocab) * cfg.d_model
    assert cfg.param_count() == params


@pytest.mark.parametrize("arch", REGISTRY_ARCHS)
def test_launcher_serves_each_registry_arch_on_the_cpu(arch, capsys):
    from repro_torch.launch.serve import main
    main(["--arch", arch, "--smoke", "--device", "cpu", "--requests", "3",
          "--max-new", "2", "--max-prompt", "8", "--batch-size", "2"])
    assert f"{arch} on cpu: 3 requests -> 6 tokens" in capsys.readouterr().out

"""The port's serving ``Engine`` against the JAX package's ``Engine``
(``kernel_impl="pallas"``) on the same weights (converted with
``lm_params_from_numpy``) and requests, and the engine's own contract:
left padding, the early stop and ``last_decode_steps``, EOS truncation.

Greedy tokens across frameworks can flip on near-ties (ROADMAP C3), so
tokens are held under the margin rule.  Along the reference's greedy
trajectory the port's logits are computed too (the same tokens fed to
both) and held within TOL = 3e-2 (``tests/test_torch_lm.py``); where the
reference's top-2 margin exceeds twice the largest logit difference of
that step, the argmax cannot move and the tokens must be identical.  A
slot is compared up to its first step with a smaller margin, after which a
flip is allowed and the continuation may differ.  At smoke size the
logits are small (|logit| < 1, margins of 0.0005-0.1), so only some steps
qualify; the test demands that some do.
"""
from __future__ import annotations

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
from repro_torch.configs import smoke_config
from repro_torch.convert import lm_params_from_numpy
from repro_torch.models import LM
from repro_torch.serve import Engine, Request, ServeConfig

TOL = 3e-2


def _setup(arch):
    jcfg, cfg = ref_smoke_config(arch), smoke_config(arch)
    params = ref_init_params(jax.random.PRNGKey(0), jcfg)
    model = LM(cfg, device="cpu", seed=None)
    model.load_state_dict(lm_params_from_numpy(cfg, jax.tree.map(np.asarray, params)))
    return jcfg, params, cfg, model


def _requests(vocab, lengths, max_new, seed):
    rng = np.random.default_rng(seed)
    return [(rng.integers(0, vocab, n).astype(np.int32), m)
            for n, m in zip(lengths, max_new)]


def _trajectory(jcfg, params, model, toks, max_new, cache_len):
    """The reference's greedy run of one padded batch, with the port fed
    the same tokens: (reference tokens, its top-2 margins, the largest
    logit difference), each (B, max_new)."""
    logits, caches = ref_prefill(params, jcfg, {"tokens": jnp.asarray(toks)},
                                 kernel_impl="pallas", max_cache_len=cache_len)
    p_logits, p_caches = model.prefill(torch.tensor(toks), max_cache_len=cache_len)
    B, P = toks.shape
    out, margins, errs = [], [], []
    for step in range(max_new):
        lg = np.asarray(logits)
        top2 = np.sort(lg, axis=-1)[:, -2:]
        margins.append(top2[:, 1] - top2[:, 0])
        errs.append(np.abs(p_logits.numpy() - lg).max(axis=-1))
        nxt = lg.argmax(-1).astype(np.int32)
        out.append(nxt)
        if step < max_new - 1:
            pos = np.full((B,), P + step, np.int32)
            logits, caches = ref_decode_step(params, jcfg, jnp.asarray(nxt[:, None]),
                                             jnp.asarray(pos), caches, kernel_impl="pallas")
            p_logits, p_caches = model.decode_step(torch.tensor(nxt[:, None]),
                                                   torch.tensor(pos), p_caches)
    return np.stack(out, 1), np.stack(margins, 1), np.stack(errs, 1)


# internvl2-1b: the vision model served as text, as both engines serve it.
@pytest.mark.parametrize("arch", ["recurrentgemma-2b", "mamba2-780m", "h2o-danube-3-4b",
                                  "internvl2-1b"])
def test_engine_matches_reference_engine_under_the_margin_rule(arch):
    jcfg, params, cfg, model = _setup(arch)
    max_prompt, max_new, B = 32, 6, 2
    reqs = _requests(cfg.vocab, [20, 40, 9], [6, 6, 4], 3)   # 40 > max_prompt: cut
    ref = RefEngine(jcfg, params, RefServeConfig(batch_size=B, max_prompt=max_prompt,
                                                 max_new=max_new, kernel_impl="pallas"))
    want = ref.generate([RefRequest(p, m) for p, m in reqs])
    eng = Engine(cfg, model, ServeConfig(batch_size=B, max_prompt=max_prompt,
                                         max_new=max_new))
    got = eng.generate([Request(p, m) for p, m in reqs])
    assert [len(r.tokens) for r in got] == [len(r.tokens) for r in want] == [6, 6, 4]
    assert [r.prompt_len for r in got] == [20, 40, 9]

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
            assert np.array_equal(w, ref_toks[i, :len(w)])   # the trajectory replayed
            for step in range(len(w)):
                if margins[i, step] <= 2 * errs[i, step]:
                    break
                assert g[step] == w[step], (arch, lo + i, step, margins[i, step])
                compared += 1
    assert compared >= 2, f"only {compared} tokens had a margin above the rule's"


def test_left_padding_and_truncation():
    cfg = smoke_config("mamba2-780m")
    model = LM(cfg, device="cpu", seed=0)
    eng = Engine(cfg, model, ServeConfig(batch_size=3, max_prompt=6, max_new=2))
    toks = eng._pad_batch([Request(np.array([5, 6, 7], np.int32), 2),
                           Request(np.arange(1, 10, dtype=np.int32), 2),
                           Request(np.zeros(1, np.int32), 0)])
    assert toks.tolist() == [[0, 0, 0, 5, 6, 7], [4, 5, 6, 7, 8, 9], [0] * 6]


def test_early_stop_same_tokens_fewer_steps():
    cfg = smoke_config("recurrentgemma-2b")
    model = LM(cfg, device="cpu", seed=0)
    reqs = [Request(p, 2) for p, _ in _requests(cfg.vocab, [5, 5], [2, 2], 5)]
    base = dict(batch_size=2, max_prompt=8, max_new=8, eos_id=None)
    slow = Engine(cfg, model, ServeConfig(early_stop=False, **base))
    want = slow.generate(reqs)
    assert slow.last_decode_steps == 7
    fast = Engine(cfg, model, ServeConfig(early_stop=True, **base))
    got = fast.generate(reqs)
    assert fast.last_decode_steps == 1      # budgets of 2 end after one step
    for a, b in zip(want, got):
        assert np.array_equal(a.tokens, b.tokens) and a.prompt_len == b.prompt_len


def test_eos_truncates_and_stops_the_batch():
    cfg = smoke_config("h2o-danube-3-4b")
    model = LM(cfg, device="cpu", seed=0)
    reqs = [Request(p, 6) for p, _ in _requests(cfg.vocab, [7, 4], [6, 6], 6)]
    free = Engine(cfg, model, ServeConfig(batch_size=2, max_prompt=8, max_new=6))
    first = [r.tokens for r in free.generate(reqs)]
    eos = int(first[0][1])
    eng = Engine(cfg, model, ServeConfig(batch_size=2, max_prompt=8, max_new=6, eos_id=eos))
    got = [r.tokens for r in eng.generate(reqs)]
    for f, g in zip(first, got):
        stop = np.where(f == eos)[0]
        want = f[:stop[0] + 1] if len(stop) else f
        assert np.array_equal(g, want)


def test_engine_runs_under_inference_mode_and_keeps_no_grad():
    cfg = smoke_config("mamba2-780m")
    model = LM(cfg, device="cpu", seed=0)
    eng = Engine(cfg, model, ServeConfig(batch_size=1, max_prompt=4, max_new=2))
    (res,) = eng.generate([Request(np.array([1, 2], np.int32), 2)])
    assert res.tokens.dtype == np.int32 and res.tokens.shape == (2,)
    assert all(not p.requires_grad for p in model.parameters())
    assert not torch.is_inference_mode_enabled()


def test_launcher_serves_on_the_cpu_when_asked(capsys):
    from repro_torch.launch.serve import main
    main(["--arch", "mamba2-780m", "--smoke", "--device", "cpu", "--requests", "3",
          "--max-new", "2", "--max-prompt", "8", "--batch-size", "2"])
    assert "mamba2-780m on cpu: 3 requests -> 6 tokens" in capsys.readouterr().out

"""The port's training against the JAX package's, on the CPU.

First the JAX package's own training tests (``tests/test_train.py``) on
the port, each held to the reference's bar: the schedule, the loss going
down (default, microbatched, float32 grads), microbatch equivalence, error
feedback and deterministic replay.  Then each port value against the
reference's on the same inputs: batches bit for bit; ``schedule`` within
one float32 ulp plus one ulp of its cosine carried through;
``adamw_update`` (m and v within 1e-6 of the leaf's largest magnitude,
bf16 params within one bf16 step, float32 params within 1e-6);
``rglru_scan`` within B7's bar (1e-5); ``make_train_step`` of the audio and
vision families (stub inputs, 2 microbatches, bf16 grads) within
``STEP_REL``.  ``LM.train_loss`` with its
gradient for every arch of the registry is in
``test_torch_train_grads.py``.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.data import DataConfig as RefDataConfig
from repro.data import FileTokens as RefFileTokens
from repro.data import SyntheticLM as RefSyntheticLM
from repro.configs import smoke_config as ref_smoke_config
from repro.models import init_params as ref_init_params
from repro.models.rglru import rglru_scan as ref_rglru_scan
from repro.optim.adamw import AdamWConfig as RefAdamWConfig
from repro.optim.adamw import adamw_update as ref_adamw_update
from repro.optim.adamw import init_opt_state as ref_init_opt_state
from repro.optim.adamw import schedule as ref_schedule
from repro.train import TrainOptions as RefTrainOptions
from repro.train import make_train_step as ref_make_train_step
from repro_torch.configs import smoke_config
from repro_torch.convert import lm_params_from_numpy, tensor_from_numpy, tensor_to_numpy
from repro_torch.data import DataConfig, FileTokens, SyntheticLM
from repro_torch.kernels.rglru import rglru_scan
from repro_torch.optim import AdamWConfig, adamw_update, init_opt_state, schedule
from repro_torch.optim import adamw as adamw_mod
from repro_torch.train import TrainOptions, init_params, make_train_step
from test_torch_registry import _with_bias

@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """Smoke-size steps are many tiny ops, which run fastest on one thread
    and slow down badly when the suite's workers share the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# The train step's loss, ce and grad_norm against the reference's, each
# the smallest power of two at least twice its largest sound reading
# (loss and ce 9.1e-5, internvl2-1b's ce; grad_norm 1.49e-3, internvl2-1b's:
# bf16 gradients summed in other orders).
STEP_REL = {"loss": 2.0 ** -12, "ce": 2.0 ** -12, "grad_norm": 2.0 ** -8}


def _to_dev(b):
    return {k: torch.from_numpy(v.astype(np.int64)) for k, v in b.items()}


def _stub_inputs(cfg, n: int) -> dict:
    """The frontend stub's inputs for n rows, bf16 from numpy seed 0:
    whisper's frames, internvl's vision embeddings; nothing otherwise."""
    if cfg.family == "audio":
        key, shape = "frames", (n, cfg.encoder.n_ctx, cfg.encoder.d_model)
    elif cfg.family == "vlm":
        key, shape = "vision_embeds", (n, cfg.n_vision_tokens, cfg.d_model)
    else:
        return {}
    return {key: tensor_from_numpy(np.random.default_rng(0).normal(size=shape)
                                   .astype(ml_dtypes.bfloat16))}


# ---------------------------------------------------------------------- #
# The reference's tests/test_train.py, on the port.
# ---------------------------------------------------------------------- #
def test_schedule_warmup_cosine():
    cfg = AdamWConfig(lr=1e-3, warmup_steps=10, total_steps=100, min_lr_frac=0.1)
    assert float(schedule(cfg, torch.tensor(0, dtype=torch.int32))) == 0.0
    assert abs(float(schedule(cfg, torch.tensor(10, dtype=torch.int32))) - 1e-3) < 1e-9
    assert abs(float(schedule(cfg, torch.tensor(100, dtype=torch.int32))) - 1e-4) < 1e-9


@pytest.mark.parametrize("opts", [
    TrainOptions(),
    TrainOptions(microbatches=2),
    TrainOptions(grad_dtype="f32"),
], ids=["default", "microbatched", "f32-grads"])
def test_loss_decreases(opts):
    cfg = smoke_config("granite-8b")
    params = init_params(cfg, device="cpu", seed=0)
    step = make_train_step(cfg, AdamWConfig(lr=3e-3, warmup_steps=5, total_steps=60), opts)
    opt_state = init_opt_state(params)
    data = SyntheticLM(DataConfig(vocab=cfg.vocab, seq_len=32, global_batch=4))
    losses = []
    for i in range(25):
        params, opt_state, m = step(params, opt_state, _to_dev(data.batch(i)))
        losses.append(float(m["loss"]))
    assert np.isfinite(losses).all()
    assert np.mean(losses[-5:]) < np.mean(losses[:5]) - 0.2, losses


@pytest.mark.parametrize("arch", ["granite-8b", "whisper-small", "internvl2-1b"])
def test_microbatch_equivalence(arch):
    """Grad accumulation over 2 microbatches ~= one big batch; the step
    leaves its inputs as they were, so both start from the same params.
    whisper's frames and internvl's vision embeddings are split row for
    row with the tokens."""
    cfg = smoke_config(arch)
    params = init_params(cfg, device="cpu", seed=0)
    before = {k: v.clone() for k, v in params.items()}
    data = SyntheticLM(DataConfig(vocab=cfg.vocab, seq_len=16, global_batch=4))
    batch = {**_to_dev(data.batch(0)), **_stub_inputs(cfg, 4)}
    s1 = make_train_step(cfg, AdamWConfig(lr=1e-3), TrainOptions(grad_dtype="f32"))
    s2 = make_train_step(cfg, AdamWConfig(lr=1e-3),
                         TrainOptions(microbatches=2, grad_dtype="f32"))
    p1, _, _ = s1(params, init_opt_state(params), batch)
    p2, _, _ = s2(params, init_opt_state(params), batch)
    assert all(torch.equal(before[k], params[k]) for k in params)
    d = max(float((p1[k].float() - p2[k].float()).abs().max()) for k in p1)
    assert d < 5e-2


def test_error_feedback_state_threads():
    cfg = smoke_config("granite-8b")
    params = init_params(cfg, device="cpu", seed=0)
    step = make_train_step(cfg, AdamWConfig(),
                           TrainOptions(grad_dtype="bf16", error_feedback=True))
    opt_state = init_opt_state(params)
    opt_state["feedback"] = {k: torch.zeros(p.shape) for k, p in params.items()}
    data = SyntheticLM(DataConfig(vocab=cfg.vocab, seq_len=16, global_batch=2))
    params, opt_state, m = step(params, opt_state, _to_dev(data.batch(0)))
    assert "feedback" in opt_state
    assert np.isfinite(float(m["loss"]))


def test_data_pipeline_deterministic_replay():
    """Batch i is a pure function of (seed, i): restart replay safety."""
    cfg = DataConfig(vocab=1000, seq_len=64, global_batch=8, seed=3)
    a, b = SyntheticLM(cfg), SyntheticLM(cfg)
    for i in [0, 5, 17]:
        np.testing.assert_array_equal(a.batch(i)["tokens"], b.batch(i)["tokens"])
    assert not np.array_equal(a.batch(0)["tokens"], a.batch(1)["tokens"])
    ba = a.batch(2)
    np.testing.assert_array_equal(ba["tokens"][:, 1:], ba["labels"][:, :-1])


def test_zero1_is_refused_naming_a13b():
    """``zero1`` is no longer refused: without a mesh it has nothing to shard
    and the step equals the ``zero1=False`` step bit for bit (the sharded
    step is in test_torch_train_mesh.py)."""
    cfg = smoke_config("granite-8b")
    params = init_params(cfg, device="cpu", seed=0)
    batch = _to_dev(SyntheticLM(DataConfig(vocab=cfg.vocab, seq_len=16,
                                           global_batch=2)).batch(0))
    outs = [make_train_step(cfg, AdamWConfig(), TrainOptions(zero1=z))(
        params, init_opt_state(params), batch) for z in (True, False)]
    for k in params:
        assert torch.equal(outs[0][0][k], outs[1][0][k])
        assert torch.equal(outs[0][1]["m"][k], outs[1][1]["m"][k])
    assert torch.equal(outs[0][2]["loss"], outs[1][2]["loss"])


def test_donated_step_equals_the_functional_step():
    """``TrainOptions(donate=True)``: the step writes its AdamW update into
    the params and moments it was given and returns those tensors, bit for
    bit the functional step's (two steps, microbatched, bf16 grads)."""
    cfg = smoke_config("granite-moe-3b-a800m")
    data = SyntheticLM(DataConfig(vocab=cfg.vocab, seq_len=16, global_batch=4))
    opt = AdamWConfig(lr=1e-3, warmup_steps=1, total_steps=4)
    runs = []
    for donate in (False, True):
        step = make_train_step(cfg, opt, TrainOptions(microbatches=2, donate=donate))
        params = init_params(cfg, device="cpu", seed=0)
        state = init_opt_state(params)
        for i in range(2):
            given = (params, state["m"], state["v"])
            params, state, metrics = step(params, state, _to_dev(data.batch(i)))
            if donate:
                assert all(params[k] is given[0][k] and state["m"][k] is given[1][k]
                           and state["v"][k] is given[2][k] for k in params)
        runs.append((params, state, metrics))
    (pf, sf, mf), (pd, sd, md) = runs
    for k in pf:
        assert torch.equal(pf[k], pd[k]), k
        assert torch.equal(sf["m"][k], sd["m"][k]) and torch.equal(sf["v"][k], sd["v"][k]), k
    assert int(sf["count"]) == int(sd["count"]) == 2
    assert all(torch.equal(mf[k], md[k]) for k in mf)


def test_in_place_update_in_slices_equals_the_functional_update(rng, monkeypatch):
    """``adamw_update(in_place=True)`` runs over each leaf in slices of
    ``IN_PLACE_SLICE`` elements; at 7 a slice (slices that cross rows, a
    leaf shorter than one, a 0-d leaf) its params, moments and count are
    the functional update's bit for bit, written into the given tensors."""
    monkeypatch.setattr(adamw_mod, "IN_PLACE_SLICE", 7)
    shapes = {"a": ((8, 16), ml_dtypes.bfloat16), "b": ((5,), np.float32),
              "c": ((), np.float32), "d": ((3, 4), ml_dtypes.bfloat16)}
    T = lambda a: tensor_from_numpy(np.asarray(a))  # noqa: E731
    params = {k: rng.normal(size=s).astype(t) for k, (s, t) in shapes.items()}
    grads = {k: rng.normal(size=s).astype(ml_dtypes.bfloat16) for k, (s, _) in shapes.items()}
    m = {k: (rng.normal(size=s) * 0.01).astype(np.float32) for k, (s, _) in shapes.items()}
    v = {k: (rng.uniform(size=s) * 1e-4).astype(np.float32) for k, (s, _) in shapes.items()}
    cfg = AdamWConfig(lr=1e-3, warmup_steps=2, total_steps=10, weight_decay=0.1)

    def run(in_place):
        state = {"m": {k: T(a) for k, a in m.items()}, "v": {k: T(a) for k, a in v.items()},
                 "count": torch.tensor(3, dtype=torch.int32)}
        given = {k: T(a) for k, a in params.items()}
        out = adamw_update(cfg, given, {k: T(a) for k, a in grads.items()}, state,
                           in_place=in_place)
        return given, state, out
    _, _, (fp, fs, fm) = run(False)
    given, state, (ip, is_, im) = run(True)
    for k in shapes:
        assert ip[k] is given[k] and is_["m"][k] is state["m"][k] and is_["v"][k] is state["v"][k]
        assert torch.equal(ip[k], fp[k]) and ip[k].dtype == fp[k].dtype, k
        assert torch.equal(is_["m"][k], fs["m"][k]) and torch.equal(is_["v"][k], fs["v"][k]), k
    assert int(is_["count"]) == int(fs["count"]) == 4
    assert all(torch.equal(fm[key], im[key]) for key in fm)


# ---------------------------------------------------------------------- #
# Values against the reference's.
# ---------------------------------------------------------------------- #
@pytest.mark.parametrize("kw", [dict(vocab=503, seq_len=32, global_batch=4),
                                dict(vocab=50280, seq_len=64, global_batch=8, seed=3),
                                dict(vocab=1000, seq_len=16, global_batch=8, host_id=1,
                                     n_hosts=2)])
def test_batches_match_the_reference_bit_for_bit(kw, tmp_path):
    mine, ref = SyntheticLM(DataConfig(**kw)), RefSyntheticLM(RefDataConfig(**kw))
    for i in (0, 1, 7):
        a, b = mine.batch(i), ref.batch(i)
        assert a.keys() == b.keys()
        for k in a:
            assert a[k].dtype == b[k].dtype and np.array_equal(a[k], b[k])
    path = tmp_path / "tokens.bin"
    np.random.default_rng(0).integers(0, kw["vocab"], 4000).astype(np.uint32).tofile(path)
    mine = FileTokens(DataConfig(**kw, path=str(path)))
    ref = RefFileTokens(RefDataConfig(**kw, path=str(path)))
    for i in (0, 3):
        for k in ("tokens", "labels"):
            assert np.array_equal(mine.batch(i)[k], ref.batch(i)[k])


@pytest.mark.parametrize("kw", [dict(lr=1e-3, warmup_steps=10, total_steps=100),
                                dict(lr=3e-4, warmup_steps=2, total_steps=8, min_lr_frac=0.0),
                                dict()])
def test_schedule_within_one_ulp_of_the_reference(kw):
    """One ulp of the result, plus one float32 ulp of cos(pi t) carried
    through: torch's and XLA's float32 cos differ by an ulp at some t, and
    1 + cos cancels near t = 1 (readings up to 3 ulp of the result)."""
    cfg = AdamWConfig(**kw)
    got = np.array([float(schedule(cfg, torch.tensor(s, dtype=torch.int32)))
                    for s in range(121)], np.float32)
    want = np.array([np.asarray(ref_schedule(RefAdamWConfig(**kw), jnp.int32(s)))
                     for s in range(121)], np.float32)
    t = np.clip((np.arange(121) - cfg.warmup_steps)
                / max(cfg.total_steps - cfg.warmup_steps, 1), 0.0, 1.0)
    cos_ulp = np.spacing(np.abs(np.cos(np.pi * t)).astype(np.float32))
    bar = np.spacing(np.abs(want)) + cfg.lr * (1 - cfg.min_lr_frac) * 0.5 * cos_ulp
    assert np.all(np.abs(got.astype(np.float64) - want) <= bar)


@pytest.mark.parametrize("gscale", [0.01, 10.0], ids=["unclipped", "clipped"])
def test_adamw_update_matches_the_reference(rng, gscale):
    shapes = {"a": ((8, 16), ml_dtypes.bfloat16), "b": ((5,), np.float32),
              "c.d": ((3, 4), ml_dtypes.bfloat16)}
    params = {k: rng.normal(size=s).astype(t) for k, (s, t) in shapes.items()}
    grads = {k: (rng.normal(size=s) * gscale).astype(ml_dtypes.bfloat16)
             for k, (s, _) in shapes.items()}
    m = {k: (rng.normal(size=s) * 0.01).astype(np.float32) for k, (s, _) in shapes.items()}
    v = {k: (rng.uniform(size=s) * 1e-4).astype(np.float32) for k, (s, _) in shapes.items()}
    cfg = dict(lr=1e-3, warmup_steps=2, total_steps=10, weight_decay=0.1)
    state = {"m": m, "v": v, "count": np.int32(3)}
    rp, rs, rm = ref_adamw_update(RefAdamWConfig(**cfg), jax.tree.map(jnp.asarray, params),
                                  jax.tree.map(jnp.asarray, grads),
                                  jax.tree.map(jnp.asarray, state))
    T = lambda tree: {k: tensor_from_numpy(a) for k, a in tree.items()}  # noqa: E731
    tp, ts, tm = adamw_update(AdamWConfig(**cfg), T(params), T(grads),
                              {"m": T(m), "v": T(v), "count": torch.tensor(3, dtype=torch.int32)})
    assert int(ts["count"]) == 4 and ts["count"].dtype == torch.int32
    for k in shapes:
        for mine, ref in ((ts["m"][k], rs["m"][k]), (ts["v"][k], rs["v"][k])):
            ref = np.asarray(ref)
            assert mine.dtype == torch.float32
            assert np.abs(mine.numpy() - ref).max() <= 1e-6 * np.abs(ref).max()
        ref_p = np.asarray(rp[k])
        if ref_p.dtype == np.float32:
            assert np.abs(tp[k].numpy() - ref_p).max() <= 1e-6 * np.abs(ref_p).max()
        else:
            steps = np.abs(tensor_to_numpy(tp[k]).view(np.int16).astype(np.int32)
                           - ref_p.view(np.int16).astype(np.int32))
            assert tp[k].dtype == torch.bfloat16 and steps.max() <= 1
    for key in ("grad_norm", "lr"):
        assert abs(float(tm[key]) - float(rm[key])) <= 1e-6 * abs(float(rm[key]))


@pytest.mark.parametrize("arch", ["whisper-small", "internvl2-1b", "gemma3-12b", "qwen2-72b"])
def test_train_step_matches_the_reference(arch):
    """``make_train_step`` against the reference's on the same numpy
    params and batch (4 rows with their stub inputs, 2 microbatches, bf16
    grads): loss, ce and grad_norm each within its STEP_REL of the
    reference's.  gemma3-12b: the tied head and gemma scaling; qwen2-72b:
    its QKV biases drawn non-zero (both packages initialise them to 0)."""
    rcfg, cfg = ref_smoke_config(arch), smoke_config(arch)
    ref_params = ref_init_params(jax.random.PRNGKey(0), rcfg)
    if cfg.qkv_bias:
        ref_params = _with_bias(ref_params, 100)
    data = SyntheticLM(DataConfig(vocab=cfg.vocab, seq_len=16, global_batch=4))
    batch = {**_to_dev(data.batch(0)), **_stub_inputs(cfg, 4)}
    np_batch = {k: tensor_to_numpy(v) if v.is_floating_point() else v.numpy().astype(np.int32)
                for k, v in batch.items()}
    opt = dict(lr=1e-3, warmup_steps=1, total_steps=4)
    ref_step = ref_make_train_step(rcfg, RefAdamWConfig(**opt),
                                   RefTrainOptions(microbatches=2, grad_dtype="bf16"))
    _, _, want = jax.jit(ref_step)(ref_params, ref_init_opt_state(ref_params),
                                   jax.tree.map(jnp.asarray, np_batch))
    step = make_train_step(cfg, AdamWConfig(**opt), TrainOptions(microbatches=2))
    params = lm_params_from_numpy(cfg, jax.tree.map(np.asarray, ref_params))
    _, _, got = step(params, init_opt_state(params), batch)
    for key, bar in STEP_REL.items():
        w = float(want[key])
        assert abs(float(got[key]) - w) <= bar * abs(w), (key, float(got[key]), w)


@pytest.mark.parametrize("B,L,W", [(2, 64, 32), (1, 100, 8), (3, 33, 16)])
def test_rglru_scan_matches_the_reference(rng, B, L, W):
    la = -rng.uniform(0.01, 2.0, (B, L, W)).astype(np.float32)
    gx = rng.normal(size=(B, L, W)).astype(np.float32)
    hs, hT = rglru_scan(torch.tensor(la), torch.tensor(gx))
    rs, rT = ref_rglru_scan(jnp.asarray(la), jnp.asarray(gx))
    np.testing.assert_allclose(hs.numpy(), np.asarray(rs), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(hT.numpy(), np.asarray(rT), rtol=1e-5, atol=1e-5)

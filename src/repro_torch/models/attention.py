"""GQA attention with RoPE, causal and sliding-window masks, ring KV
caches, the optional int8 KV cache, and the whisper decoder's cross
attention.

Every layer's KV cache is a ring of ``cache_len`` slots: full-attention
layers size it to the longest context, sliding-window layers to the
window.  Slot = ``pos % cache_len``; a ``pos`` plane records the absolute
position each slot holds (-1 = empty).  Keys are stored RoPE'd at their
absolute position, so the ring never needs re-rotation.  The int8 cache
(``kv_quant_int8``) stores k and v as int8 with one float32 absmax scale
per (slot, kv head), as the JAX package's does.

Prefill attention, causal or not (the whisper encoder is bidirectional),
takes one of the reference's three routes (:func:`attention`): kernel B5
(:func:`repro_torch.kernels.flash_attention.flash_attention`), or one of
its two plain routes, the dense einsum with probabilities in v's type
(:func:`_dense_attention`) and the blocked online-softmax scan above
``FLASH_SCAN_THRESHOLD`` positions (:func:`_flash_scan`), which training
differentiates.  The one-token decode, the caches and cross attention
are plain PyTorch, as the JAX package computes them outside any Pallas
kernel.  Decode writes its token into the cache in place; a
cross-attention cache is read only.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch.kernels.flash_attention import NEG_INF, attention_mask, flash_attention
from repro_torch.models.layers import DTYPE, F32, apply_rope, dense, filled


class Attention(nn.Module):
    """Projection weights of one attention layer, named as the JAX
    package's ``attn_init`` names them."""

    def __init__(self, d_model: int, n_heads: int, n_kv_heads: int, head_dim: int,
                 qkv_bias: bool = False, gen=None, device=None):
        super().__init__()
        self.wq = dense(d_model, n_heads * head_dim, gen, device)
        self.wk = dense(d_model, n_kv_heads * head_dim, gen, device)
        self.wv = dense(d_model, n_kv_heads * head_dim, gen, device)
        self.wo = dense(n_heads * head_dim, d_model, gen, device)
        if qkv_bias:
            self.bq = filled((n_heads * head_dim,), 0.0, device=device)
            self.bk = filled((n_kv_heads * head_dim,), 0.0, device=device)
            self.bv = filled((n_kv_heads * head_dim,), 0.0, device=device)


def _project_qkv(p, x, n_heads, n_kv_heads, head_dim):
    B, S, _ = x.shape
    q = x @ p.wq
    k = x @ p.wk
    v = x @ p.wv
    if hasattr(p, "bq"):
        q = q + p.bq
        k = k + p.bk
        v = v + p.bv
    return (q.reshape(B, S, n_heads, head_dim),
            k.reshape(B, S, n_kv_heads, head_dim),
            v.reshape(B, S, n_kv_heads, head_dim))


# Above this many query positions the plain route replaces the dense
# (S, S) scores by the blocked scan, whose memory is O(S * block).
FLASH_SCAN_THRESHOLD = 2048


def _divisor_block(b: int, S: int) -> int:
    """``b`` capped at S, else the largest divisor of S below it."""
    b = min(b, S)
    return next(d for d in range(b, 0, -1) if S % d == 0)


def _flash_scan(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *, causal: bool,
                window: Optional[int], bq: int = 512, bk: int = 512) -> torch.Tensor:
    """The reference's ``_flash_scan``: blocked attention (GQA) in float32,
    cast to q's type at the end.  A windowed layer attends, per block of
    ``bq`` queries, only the ``min(window + bq, S)`` keys that can be in
    its window (keys left-padded by that span; the mask is causal and
    windowed whatever ``causal`` says, as the reference's), so it is
    O(S * window) in memory and work.  Otherwise an online softmax runs
    over blocks of ``bk`` keys; every query row takes the reference's
    steps, so all ``S // bq`` query blocks go through each key block at
    once, which leaves S // bk Python steps instead of (S // bq) * (S //
    bk).  Under grad mode each key block's scores run under
    ``torch.utils.checkpoint``: autograd holds O(S) a block (and q, k and
    v once), not the O(S * bk) scores.  q: (B, S, H, hd); k/v: (B, S,
    Hkv, hd).  Plain loops over blocks, so autograd differentiates it."""
    B, S, H, hd = q.shape
    Hkv = k.shape[2]
    G = H // Hkv
    dev = q.device
    scale = 1.0 / torch.sqrt(torch.tensor(float(hd), dtype=F32, device=dev))
    neg = torch.tensor(NEG_INF, dtype=F32, device=dev)
    if window is not None:
        bq = _divisor_block(bq, S)
        span = min(window + bq, S)
        qb = q.reshape(B, S // bq, bq, Hkv, G, hd).to(F32)
        kp = torch.nn.functional.pad(k.to(F32), (0, 0, 0, 0, span, 0))
        vp = torch.nn.functional.pad(v.to(F32), (0, 0, 0, 0, span, 0))
        blocks = []
        for i in range(S // bq):
            start = i * bq + bq                         # in the padded keys
            rows = i * bq + torch.arange(bq, device=dev)[:, None]
            cols = (i * bq + bq - span) + torch.arange(span, device=dev)[None, :]
            mask = (cols >= 0) & (cols <= rows) & (rows - cols < window)
            s = torch.einsum("bqkgh,btkh->bkgqt", qb[:, i], kp[:, start:start + span]) * scale
            probs = torch.softmax(torch.where(mask, s, neg), dim=-1)
            blocks.append(torch.einsum("bkgqt,btkh->bqkgh", probs, vp[:, start:start + span]))
        return torch.stack(blocks, 1).reshape(B, S, H, hd).to(q.dtype)

    bk = _divisor_block(bk, S)
    qg = q.reshape(B, S, Hkv, G, hd).to(F32)
    kb = k.reshape(B, S // bk, bk, Hkv, hd)
    vb = v.reshape(B, S // bk, bk, Hkv, hd)
    rows = torch.arange(S, device=dev)[:, None]

    def block(j, qg, kj, vj, m):
        """Key block j against every query row: the new row maxima, and
        the block's probability sums and value product at those maxima."""
        s = torch.einsum("bqkgh,btkh->bkgqt", qg, kj.to(F32)) * scale
        if causal:
            cols = j * bk + torch.arange(bk, device=dev)[None, :]
            s = torch.where(cols <= rows, s, neg)
        m_new = torch.maximum(m, s.amax(-1))
        probs = torch.exp(s - m_new[..., None])
        return m_new, probs.sum(-1), torch.einsum("bkgqt,btkh->bkgqh", probs, vj.to(F32))

    m = torch.full((B, Hkv, G, S), NEG_INF, dtype=F32, device=dev)
    l = torch.zeros((B, Hkv, G, S), dtype=F32, device=dev)
    acc = torch.zeros((B, Hkv, G, S, hd), dtype=F32, device=dev)
    for j in range(S // bk):
        if torch.is_grad_enabled():
            # Autograd keeps the block's inputs (float32 q, k and v in
            # their own type, the row maxima), not its (S, bk) scores,
            # which the backward pass recomputes.
            m_new, p_sum, pv = checkpoint(block, j, qg, kb[:, j], vb[:, j], m,
                                          use_reentrant=False)
        else:
            m_new, p_sum, pv = block(j, qg, kb[:, j], vb[:, j], m)
        alpha = torch.exp(m - m_new)
        l = alpha * l + p_sum
        acc = acc * alpha[..., None] + pv
        m = m_new
    o = acc / torch.clamp(l, min=1e-20)[..., None]       # (B, Hkv, G, S, hd)
    return o.permute(0, 3, 1, 2, 4).reshape(B, S, H, hd).to(q.dtype)


def _dense_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *, causal: bool,
                    window: Optional[int]) -> torch.Tensor:
    """The reference's dense route: float32 scores and softmax over the
    (S, S) mask, the probabilities cast to v's type for the value product
    (B5's plain version keeps them in float32).  Shapes as
    :func:`_flash_scan`; returns v's type."""
    B, S, H, hd = q.shape
    Hkv = k.shape[2]
    qg = q.reshape(B, S, Hkv, H // Hkv, hd).to(F32)
    scores = torch.einsum("bskgh,btkh->bkgst", qg, k.to(F32)) \
        / torch.sqrt(torch.tensor(float(hd), dtype=F32, device=q.device))
    scores = torch.where(attention_mask(S, causal, window, q.device), scores,
                         torch.tensor(NEG_INF, dtype=F32, device=q.device))
    probs = torch.softmax(scores, dim=-1)
    return torch.einsum("bkgst,btkh->bskgh", probs.to(v.dtype), v).reshape(B, S, H, hd)


def attention(p, x: torch.Tensor, *, n_heads: int, n_kv_heads: int, head_dim: int,
              rope_theta: float, causal: bool = True, window: Optional[int] = None,
              return_kv: bool = False, kernel_impl: Optional[str] = None):
    """Attention of positions 0..S-1, x: (B, S, D) -> (B, S, D); causal
    unless ``causal=False`` (the encoder); ``window``: SWA size (None =
    full).  ``kernel_impl`` picks the reference's route: None (the device
    rule) and ``"pallas"`` go to B5's entry; ``"flash_scan"``, or
    ``"xla"`` above ``FLASH_SCAN_THRESHOLD`` positions, to
    :func:`_flash_scan`; ``"xla"`` at or below it to
    :func:`_dense_attention`.  Any other value is refused by B5's entry.
    With ``return_kv`` also returns the RoPE'd keys and the values, which
    :func:`cache_from_kv` turns into the layer's ring cache."""
    B, S, _ = x.shape
    q, k, v = _project_qkv(p, x, n_heads, n_kv_heads, head_dim)
    pos = torch.arange(S, dtype=torch.int32, device=x.device)[None, :]
    q = apply_rope(q, pos, rope_theta)
    k = apply_rope(k, pos, rope_theta)
    if kernel_impl == "flash_scan" or (kernel_impl == "xla" and S > FLASH_SCAN_THRESHOLD):
        o = _flash_scan(q, k, v, causal=causal, window=window)
    elif kernel_impl == "xla":
        o = _dense_attention(q, k, v, causal=causal, window=window)
    else:
        o = flash_attention(q, k, v, causal=causal, window=window, impl=kernel_impl)
    out = o.reshape(B, S, n_heads * head_dim) @ p.wo
    return (out, k, v) if return_kv else out


# ---------------------------------------------------------------------- #
# Ring KV cache.
# ---------------------------------------------------------------------- #
def cache_init(batch: int, cache_len: int, n_kv_heads: int, head_dim: int,
               dtype=DTYPE, quant: bool = False, device=None) -> Dict[str, torch.Tensor]:
    """An empty ring; ``quant``: int8 k and v with float32 scales."""
    kv_dtype = torch.int8 if quant else dtype
    c = {
        "k": torch.zeros((batch, cache_len, n_kv_heads, head_dim), dtype=kv_dtype,
                         device=device),
        "v": torch.zeros((batch, cache_len, n_kv_heads, head_dim), dtype=kv_dtype,
                         device=device),
        "pos": torch.full((batch, cache_len), -1, dtype=torch.int32, device=device),
    }
    if quant:
        c["k_scale"] = torch.zeros((batch, cache_len, n_kv_heads), dtype=F32, device=device)
        c["v_scale"] = torch.zeros((batch, cache_len, n_kv_heads), dtype=F32, device=device)
    return c


_INT8_MAX: Dict[torch.device, torch.Tensor] = {}


def _quantize(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: (..., hd) -> (int8 values, float32 absmax scale over hd); the
    rounding is half to even, as ``jnp.round``'s.  The divisor is a tensor
    on x's device, made once per device: PyTorch's CUDA division by a host
    scalar multiplies by its reciprocal, which can miss the quotient's last
    bit."""
    xf = x.to(F32)
    if x.device not in _INT8_MAX:
        with torch.inference_mode(False):       # usable outside inference mode too
            _INT8_MAX[x.device] = torch.tensor(127.0, dtype=F32, device=x.device)
    scale = xf.abs().amax(-1) / _INT8_MAX[x.device]
    q = torch.round(xf / torch.clamp(scale, min=1e-9)[..., None])
    return q.to(torch.int8), scale


def _deq_k(cache: Dict[str, torch.Tensor]) -> torch.Tensor:
    if "k_scale" in cache:
        return cache["k"].to(F32) * cache["k_scale"][..., None]
    return cache["k"].to(F32)


def _deq_v(cache: Dict[str, torch.Tensor]) -> torch.Tensor:
    if "v_scale" in cache:
        return (cache["v"].to(F32) * cache["v_scale"][..., None]).to(DTYPE)
    return cache["v"]


def cache_from_kv(k: torch.Tensor, v: torch.Tensor, cache_len: int,
                  quant: bool = False) -> Dict[str, torch.Tensor]:
    """The ring cache of a prefill (the JAX package's ``cache_prefill``,
    fed the k and v that :func:`attention` returns instead of projecting
    twice): k (RoPE'd) and v (B, S, Hkv, hd) of positions 0..S-1; keeps
    the last ``cache_len`` tokens at slots ``pos % cache_len``, quantized
    to int8 under ``quant``."""
    B, S, Hkv, hd = k.shape
    keep = min(S, cache_len)
    cache = cache_init(B, cache_len, Hkv, hd, k.dtype, quant=quant, device=k.device)
    pos = torch.arange(S - keep, S, dtype=torch.int32, device=k.device)
    slots = (pos % cache_len).long()
    k_keep, v_keep = k[:, S - keep:], v[:, S - keep:]
    if quant:
        k_keep, k_scale = _quantize(k_keep)
        v_keep, v_scale = _quantize(v_keep)
        cache["k_scale"][:, slots] = k_scale
        cache["v_scale"][:, slots] = v_scale
    cache["k"][:, slots] = k_keep
    cache["v"][:, slots] = v_keep
    cache["pos"][:, slots] = pos
    return cache


def attention_decode(p, x: torch.Tensor, cache: Dict[str, torch.Tensor], pos: torch.Tensor,
                     *, n_heads, n_kv_heads, head_dim, rope_theta,
                     window: Optional[int] = None
                     ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """One-token decode step, plain PyTorch.  x: (B, 1, D); pos: (B,)
    absolute position of the new token.  Writes the token into ``cache``
    in place and returns (out (B, 1, D), cache)."""
    B = x.shape[0]
    cache_len = cache["k"].shape[1]
    q, k_new, v_new = _project_qkv(p, x, n_heads, n_kv_heads, head_dim)
    q = apply_rope(q, pos[:, None], rope_theta)
    k_new = apply_rope(k_new, pos[:, None], rope_theta)

    slot = (pos % cache_len).long()
    bidx = torch.arange(B, device=x.device)
    k_new, v_new = k_new[:, 0], v_new[:, 0]
    if "k_scale" in cache:
        k_new, k_scale = _quantize(k_new)
        v_new, v_scale = _quantize(v_new)
        cache["k_scale"][bidx, slot] = k_scale
        cache["v_scale"][bidx, slot] = v_scale
    cache["k"][bidx, slot] = k_new
    cache["v"][bidx, slot] = v_new
    cache["pos"][bidx, slot] = pos.to(torch.int32)

    G = n_heads // n_kv_heads
    qg = q.reshape(B, n_kv_heads, G, head_dim)
    scores = torch.einsum("bkgh,btkh->bkgt", qg.to(F32), _deq_k(cache)) \
        / torch.sqrt(torch.tensor(head_dim, dtype=F32))
    cpos = cache["pos"]
    valid = (cpos >= 0) & (cpos <= pos[:, None])
    if window is not None:
        valid &= cpos > (pos[:, None] - window)
    scores = torch.where(valid[:, None, None, :], scores,
                         torch.tensor(NEG_INF, dtype=F32, device=x.device))
    probs = torch.softmax(scores, dim=-1)
    vv = _deq_v(cache)
    og = torch.einsum("bkgt,btkh->bkgh", probs.to(vv.dtype), vv)
    o = og.reshape(B, 1, n_heads * head_dim)
    return o @ p.wo, cache


# ---------------------------------------------------------------------- #
# Cross attention (whisper decoder): the encoder's k and v are projected
# once at prefill and read by every decode step.
# ---------------------------------------------------------------------- #
class XAttention(nn.Module):
    """Cross-attention weights, named as the JAX package's ``xattn_init``
    names them."""

    def __init__(self, d_model: int, n_heads: int, head_dim: int, gen=None, device=None):
        super().__init__()
        self.wq = dense(d_model, n_heads * head_dim, gen, device)
        self.wk = dense(d_model, n_heads * head_dim, gen, device)
        self.wv = dense(d_model, n_heads * head_dim, gen, device)
        self.wo = dense(n_heads * head_dim, d_model, gen, device)


def cross_kv(p, enc_out: torch.Tensor, *, n_heads: int, head_dim: int
             ) -> Dict[str, torch.Tensor]:
    """The encoder output (B, T, D) projected to k and v (B, T, H, hd)."""
    B, T, _ = enc_out.shape
    return {"k": (enc_out @ p.wk).reshape(B, T, n_heads, head_dim),
            "v": (enc_out @ p.wv).reshape(B, T, n_heads, head_dim)}


def cross_attention(p, x: torch.Tensor, enc_kv: Dict[str, torch.Tensor], *,
                    n_heads: int, head_dim: int) -> torch.Tensor:
    """x: (B, S, D) attends every one of the T encoder positions of
    ``enc_kv`` (k/v (B, T, H, hd)); the softmax in float32 over float32
    scores, its weights cast to v's type for the value product, as the
    reference's casts go."""
    B, S, _ = x.shape
    q = (x @ p.wq).reshape(B, S, n_heads, head_dim)
    scores = torch.einsum("bshd,bthd->bhst", q.to(F32), enc_kv["k"].to(F32)) \
        / torch.sqrt(torch.tensor(head_dim, dtype=F32))
    probs = torch.softmax(scores, dim=-1)
    v = enc_kv["v"]
    o = torch.einsum("bhst,bthd->bshd", probs.to(v.dtype), v)
    return o.reshape(B, S, n_heads * head_dim) @ p.wo

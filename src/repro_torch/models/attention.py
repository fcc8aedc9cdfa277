"""GQA attention with RoPE, causal and sliding-window masks, ring KV caches.

Every layer's KV cache is a ring of ``cache_len`` slots: full-attention
layers size it to the longest context, sliding-window layers to the
window.  Slot = ``pos % cache_len``; a ``pos`` plane records the absolute
position each slot holds (-1 = empty).  Keys are stored RoPE'd at their
absolute position, so the ring never needs re-rotation.

Prefill attention runs through kernel B5
(:func:`repro_torch.kernels.flash_attention.flash_attention`); the
one-token decode and the caches are plain PyTorch, as the JAX package
computes them outside any Pallas kernel.  Decode writes its token into the
cache in place.  The int8 KV cache (``kv_quant_int8``) and cross attention
are not ported (ROADMAP A8b).
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
from torch import nn

from repro_torch.kernels.flash_attention import NEG_INF, flash_attention
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


def attention(p, x: torch.Tensor, *, n_heads: int, n_kv_heads: int, head_dim: int,
              rope_theta: float, window: Optional[int] = None, return_kv: bool = False):
    """Causal attention of positions 0..S-1, x: (B, S, D) -> (B, S, D),
    through B5.  ``window``: SWA size (None = full).  With ``return_kv``
    also returns the RoPE'd keys and the values, which
    :func:`cache_from_kv` turns into the layer's ring cache."""
    B, S, _ = x.shape
    q, k, v = _project_qkv(p, x, n_heads, n_kv_heads, head_dim)
    pos = torch.arange(S, dtype=torch.int32, device=x.device)[None, :]
    q = apply_rope(q, pos, rope_theta)
    k = apply_rope(k, pos, rope_theta)
    o = flash_attention(q, k, v, causal=True, window=window)
    out = o.reshape(B, S, n_heads * head_dim) @ p.wo
    return (out, k, v) if return_kv else out


# ---------------------------------------------------------------------- #
# Ring KV cache.
# ---------------------------------------------------------------------- #
def cache_init(batch: int, cache_len: int, n_kv_heads: int, head_dim: int,
               dtype=DTYPE, quant: bool = False, device=None) -> Dict[str, torch.Tensor]:
    if quant:
        raise NotImplementedError("the int8 KV cache (kv_quant_int8) is not ported "
                                  "yet (ROADMAP A8b)")
    return {
        "k": torch.zeros((batch, cache_len, n_kv_heads, head_dim), dtype=dtype, device=device),
        "v": torch.zeros((batch, cache_len, n_kv_heads, head_dim), dtype=dtype, device=device),
        "pos": torch.full((batch, cache_len), -1, dtype=torch.int32, device=device),
    }


def cache_from_kv(k: torch.Tensor, v: torch.Tensor, cache_len: int) -> Dict[str, torch.Tensor]:
    """The ring cache of a prefill (the JAX package's ``cache_prefill``,
    fed the k and v that :func:`attention` returns instead of projecting
    twice): k (RoPE'd) and v (B, S, Hkv, hd) of positions 0..S-1; keeps
    the last ``cache_len`` tokens at slots ``pos % cache_len``."""
    B, S, Hkv, hd = k.shape
    keep = min(S, cache_len)
    cache = cache_init(B, cache_len, Hkv, hd, k.dtype, device=k.device)
    pos = torch.arange(S - keep, S, dtype=torch.int32, device=k.device)
    slots = (pos % cache_len).long()
    cache["k"][:, slots] = k[:, S - keep:]
    cache["v"][:, slots] = v[:, S - keep:]
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
    cache["k"][bidx, slot] = k_new[:, 0]
    cache["v"][bidx, slot] = v_new[:, 0]
    cache["pos"][bidx, slot] = pos.to(torch.int32)

    G = n_heads // n_kv_heads
    qg = q.reshape(B, n_kv_heads, G, head_dim)
    scores = torch.einsum("bkgh,btkh->bkgt", qg.to(F32), cache["k"].to(F32)) \
        / torch.sqrt(torch.tensor(head_dim, dtype=F32))
    cpos = cache["pos"]
    valid = (cpos >= 0) & (cpos <= pos[:, None])
    if window is not None:
        valid &= cpos > (pos[:, None] - window)
    scores = torch.where(valid[:, None, None, :], scores,
                         torch.tensor(NEG_INF, dtype=F32, device=x.device))
    probs = torch.softmax(scores, dim=-1)
    vv = cache["v"]
    og = torch.einsum("bkgt,btkh->bkgh", probs.to(vv.dtype), vv)
    o = og.reshape(B, 1, n_heads * head_dim)
    return o @ p.wo, cache

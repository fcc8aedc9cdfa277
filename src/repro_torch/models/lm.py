"""The language model: a stack of blocks in a cyclic layer pattern.

Uniform models have a cycle of one kind; recurrentgemma has (rec, rec,
attn_local).  :func:`layer_plan` gives the cycle, the number of full
cycles (groups) and the remainder, as in the JAX package; the port keeps
the layers in one ``nn.ModuleList`` in layer order, group by group, then
the remainder (the JAX package stacks each group's parameters on a
leading axis instead; ``repro_torch.convert`` maps one to the other).

Block kinds: ``attn_local`` / ``attn_global`` (attention + SwiGLU MLP, or
the MoE layer in the MoE family), ``rec`` (RG-LRU + MLP), ``ssd``
(mamba2) and ``xdec`` (the whisper decoder: causal self-attention, cross
attention on the encoder's output, a GELU MLP).  The audio family runs
:meth:`LM.encode` (a bidirectional transformer over the frontend stub's
frame embeddings, ``frames=``) first; the vision family prepends the
frontend stub's patch embeddings (``vision_embeds=``) to the token
embeddings.

Entry points: :meth:`LM.forward` (modes "train" and "prefill", with the
MoE layers' load-balance aux on request), :meth:`LM.train_loss` (the
causal LM loss, differentiated by ``repro_torch.train``),
:meth:`LM.prefill`, :meth:`LM.decode_step`, :meth:`LM.encode` and
:meth:`LM.serve_state`.  Serving state is a list with one dict per
layer: ``{k, v, pos}`` ring caches (int8 with ``k_scale`` / ``v_scale``
under ``kv_quant_int8``), RG-LRU ``{conv, h}``, Mamba2 ``{conv, ssm}``,
and for ``xdec`` ``{"kv": ring cache, "cross": {k, v}}``, the cross
cache written by prefill and only read by decode.
"""
from __future__ import annotations

import functools
import math
from typing import Dict, List, Optional, Tuple

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ArchConfig
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.models import attention as att
from repro_torch.models import moe as moe_mod
from repro_torch.models import rglru as rg_mod
from repro_torch.models import ssm as ssm_mod
from repro_torch.models.layers import (DTYPE, F32, GeluMLP, RMSNorm, SwiGLU, cross_entropy,
                                       embed_lookup, init_normal_, param, rmsnorm, swiglu,
                                       unembed)

Cache = Dict[str, torch.Tensor]


def layer_plan(cfg: ArchConfig) -> Tuple[List[str], int, List[str]]:
    """(cycle kinds, n_groups, remainder kinds)."""
    if cfg.family == "ssm":
        cycle = ["ssd"]
    elif cfg.rglru is not None:
        cycle = ["rec" if p == 0 else "attn_local" for p in cfg.rglru.pattern]
    elif cfg.family == "audio":
        cycle = ["xdec"]
    else:
        cycle = ["attn_global" if p == 1 else "attn_local" for p in cfg.attn_pattern]
    n_groups, rest = divmod(cfg.n_layers, len(cycle))
    return cycle, n_groups, cycle[:rest]


def layer_kinds(cfg: ArchConfig) -> List[str]:
    """Every layer's kind, in layer order."""
    cycle, n_groups, rest = layer_plan(cfg)
    return cycle * n_groups + rest


def _cache_len(cfg: ArchConfig, kind: str, max_seq: int) -> int:
    if kind == "attn_local" and cfg.swa_window is not None:
        return min(cfg.swa_window, max_seq)
    return max_seq


class Table(nn.Module):
    """An embedding table (V, D), bf16."""

    def __init__(self, vocab: int, dim: int, gen=None, device=None):
        super().__init__()
        self.w = param((vocab, dim), device=device)
        init_normal_(self.w, gen, 0.02)


class Block(nn.Module):
    """One layer; submodules named as the JAX package's block params."""

    def __init__(self, cfg: ArchConfig, kind: str, gen=None, device=None):
        super().__init__()
        d = cfg.d_model
        self.kind = kind
        if kind == "ssd":
            self.norm = RMSNorm(d, device)
            self.mixer = ssm_mod.Mamba2Block(d, cfg.ssm, gen, device)
            return
        self.norm1 = RMSNorm(d, device)
        if kind == "rec":
            self.mixer = rg_mod.RGLRUBlock(d, cfg.rglru, gen, device)
        else:
            self.attn = att.Attention(d, cfg.n_heads, cfg.n_kv_heads, cfg.hd,
                                      cfg.qkv_bias, gen, device)
        if kind == "xdec":
            self.normx = RMSNorm(d, device)
            self.xattn = att.XAttention(d, cfg.n_heads, cfg.hd, gen, device)
        self.norm2 = RMSNorm(d, device)
        if kind == "xdec":
            self.mlp = GeluMLP(d, cfg.d_ff, gen, device)
        elif cfg.moe is not None:
            self.mlp = moe_mod.MoE(d, cfg.moe.n_experts, cfg.moe.d_ff_expert, gen,
                                   device)
        else:
            self.mlp = SwiGLU(d, cfg.d_ff, gen, device)


class EncoderBlock(nn.Module):
    """One whisper encoder layer (the JAX package's ``_enc_block_init``):
    multi-head attention with as many kv heads as query heads, a GELU
    MLP."""

    def __init__(self, cfg: ArchConfig, gen=None, device=None):
        super().__init__()
        e = cfg.encoder
        self.norm1 = RMSNorm(e.d_model, device)
        self.attn = att.Attention(e.d_model, e.n_heads, e.n_heads, e.d_model // e.n_heads,
                                  gen=gen, device=device)
        self.norm2 = RMSNorm(e.d_model, device)
        self.mlp = GeluMLP(e.d_model, e.d_ff, gen, device)


class Encoder(nn.Module):
    """The audio family's encoder: its layers, then a final norm."""

    def __init__(self, cfg: ArchConfig, gen=None, device=None):
        super().__init__()
        self.blocks = nn.ModuleList(EncoderBlock(cfg, gen, device)
                                    for _ in range(cfg.encoder.n_layers))
        self.norm = RMSNorm(cfg.encoder.d_model, device)


class LM(nn.Module):
    """The model of ``cfg`` on ``device`` (the CUDA card by default).

    ``seed`` draws the weights from a seeded ``torch.Generator`` on the
    device (normal draws scaled as the JAX package's initialisers scale
    them; the values are not ``jax.random``'s); ``seed=None`` leaves them
    uninitialised for :meth:`load_state_dict`."""

    def __init__(self, cfg: ArchConfig, *, device: DeviceLike = None,
                 seed: Optional[int] = 0):
        super().__init__()
        self.cfg = cfg
        dev = resolve_device(device)
        self.device = dev
        gen = None
        if seed is not None:
            gen = torch.Generator(device=dev)
            gen.manual_seed(seed)
        self.embed = Table(cfg.vocab_padded, cfg.d_model, gen, dev)
        if not cfg.tie_embeddings:
            self.lm_head = Table(cfg.vocab_padded, cfg.d_model, gen, dev)
        self.final_norm = RMSNorm(cfg.d_model, dev)
        self.kinds = layer_kinds(cfg)
        self.layers = nn.ModuleList(Block(cfg, kind, gen, dev) for kind in self.kinds)
        if cfg.family == "audio":
            self.encoder = Encoder(cfg, gen, dev)
        self._head_key = None
        self._head = None

    # ------------------------------------------------------------------ #
    def head_f32(self) -> torch.Tensor:
        """The unembedding table in float32, cast once and kept until the
        weights change (tied recurrentgemma-2b: 256 000 x 2560 floats,
        2.62 GB beside the 1.31 GB bf16 table).  A table that is being
        differentiated (grad mode on, the weight requiring grad) is cast
        afresh and not kept, so the gradient reaches it."""
        w = (self.embed if self.cfg.tie_embeddings else self.lm_head).w
        if torch.is_grad_enabled() and w.requires_grad:
            return w.to(F32)
        key = (w.data_ptr(), 0 if w.is_inference() else w._version)
        if self._head_key != key:
            self._head = w.detach().to(F32)
            self._head_key = key
        return self._head

    def _embed(self, tokens: torch.Tensor,
               vision_embeds: Optional[torch.Tensor] = None) -> torch.Tensor:
        """Token embeddings, the vision family's patch embeddings (cast to
        bf16) before them, then gemma scaling, in the reference's order."""
        x = embed_lookup(self.embed.w, tokens).to(DTYPE)
        if self.cfg.family == "vlm" and vision_embeds is not None:
            x = torch.cat([vision_embeds.to(device=x.device, dtype=DTYPE), x], dim=1)
        if self.cfg.tie_embeddings:
            # gemma scaling: sqrt(d) rounded to bf16 first (50.5 at d 2560)
            x = x * torch.tensor(math.sqrt(self.cfg.d_model), dtype=F32).to(DTYPE)
        return x

    def _logits(self, x: torch.Tensor) -> torch.Tensor:
        """Logits over the padded vocab, padding columns forced to -1e30."""
        logits = unembed(rmsnorm(x, self.final_norm.scale, self.cfg.rms_eps),
                         self.head_f32())
        if self.cfg.vocab_padded != self.cfg.vocab:
            logits[..., self.cfg.vocab:] = -1e30
        return logits

    def _attn_kw(self, kind: str):
        cfg = self.cfg
        return dict(n_heads=cfg.n_heads, n_kv_heads=cfg.n_kv_heads, head_dim=cfg.hd,
                    rope_theta=cfg.rope_theta,
                    window=cfg.swa_window if kind == "attn_local" else None)

    def _mixer(self, blk: Block, x: torch.Tensor, *, mode: str, cache=None, pos=None,
               max_cache_len: Optional[int] = None, kernel_impl: Optional[str] = None):
        """The block's norm and mixer (attention, RG-LRU or Mamba2): (y, new
        cache), y before the residual add."""
        cfg = self.cfg
        kind = blk.kind
        if kind == "ssd":
            h = rmsnorm(x, blk.norm.scale, cfg.rms_eps)
            return ssm_mod.mamba2_block(blk.mixer, h, cfg.ssm, mode=mode, state=cache,
                                        kernel_impl=kernel_impl)
        h = rmsnorm(x, blk.norm1.scale, cfg.rms_eps)
        if kind == "rec":
            return rg_mod.rglru_block(blk.mixer, h, mode=mode, state=cache,
                                      kernel_impl=kernel_impl)
        if mode == "decode":
            return att.attention_decode(blk.attn, h, cache, pos, **self._attn_kw(kind))
        y, k, v = att.attention(blk.attn, h, return_kv=True, kernel_impl=kernel_impl,
                                **self._attn_kw(kind))
        new_cache = None
        if mode == "prefill":
            new_cache = att.cache_from_kv(
                k, v, _cache_len(cfg, kind, max_cache_len or x.shape[1]),
                quant=cfg.kv_quant_int8)
        return y, new_cache

    def _cross(self, blk: Block, x: torch.Tensor, xkv: Cache) -> torch.Tensor:
        """An ``xdec`` block's cross attention on the encoder's k and v,
        before the residual add."""
        cfg = self.cfg
        h = rmsnorm(x, blk.normx.scale, cfg.rms_eps)
        return att.cross_attention(blk.xattn, h, xkv, n_heads=cfg.n_heads, head_dim=cfg.hd)

    def _cross_kv(self, blk: Block, enc_out: torch.Tensor) -> Cache:
        """An ``xdec`` block's cross cache: the encoder output projected."""
        return att.cross_kv(blk.xattn, enc_out, n_heads=self.cfg.n_heads,
                            head_dim=self.cfg.hd)

    def _mlp(self, blk: Block, x: torch.Tensor, routing=None, experts=None
             ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
        """The block's second norm and its SwiGLU MLP or MoE layer, before
        the residual add (every kind but ``ssd``): (y, the MoE layer's
        load-balance loss or None).  ``routing`` replaces the MoE layer's
        own and ``experts`` fixes its experts (``moe.moe_layer``'s
        ``routing`` and ``gate_e``)."""
        cfg = self.cfg
        h = rmsnorm(x, blk.norm2.scale, cfg.rms_eps)
        if blk.kind == "xdec":
            return blk.mlp(h), None
        if cfg.moe is not None:
            y, aux = moe_mod.moe_layer(blk.mlp.params(), h, top_k=cfg.moe.top_k,
                                       capacity_factor=cfg.moe.capacity_factor,
                                       local_groups=cfg.moe.local_groups,
                                       routing=routing, gate_e=experts)
            return y, aux["load_balance_loss"]
        return swiglu(h, blk.mlp.w_gate, blk.mlp.w_up, blk.mlp.w_down), None

    def _block(self, blk: Block, x: torch.Tensor, *, mode: str, cache=None, pos=None,
               max_cache_len: Optional[int] = None, routing=None, experts=None,
               enc_out: Optional[torch.Tensor] = None, kernel_impl: Optional[str] = None):
        """(x, new cache, the MoE load-balance loss or None).  An ``xdec``
        block reads the encoder output ``enc_out`` (train, prefill) or its
        cross cache (decode)."""
        xdec = blk.kind == "xdec"
        y, new_cache = self._mixer(blk, x, mode=mode,
                                   cache=cache["kv"] if xdec and mode == "decode" else cache,
                                   pos=pos, max_cache_len=max_cache_len,
                                   kernel_impl=kernel_impl)
        x = x + y
        if xdec:
            xkv = cache["cross"] if mode == "decode" else self._cross_kv(blk, enc_out)
            if mode != "train":
                new_cache = {"kv": new_cache, "cross": xkv}
            x = x + self._cross(blk, x, xkv)
        aux = None
        if blk.kind != "ssd":
            y, aux = self._mlp(blk, x, routing, experts)
            x = x + y
        return x, new_cache, aux

    # ------------------------------------------------------------------ #
    def encode(self, frames: torch.Tensor, kernel_impl: Optional[str] = None
               ) -> torch.Tensor:
        """The audio family's encoder: frames (B, T, D) from the frontend
        stub -> (B, T, D) bf16, bidirectional attention through B5 at
        positions 0..T-1 (``kernel_impl`` as :meth:`forward`), then the
        encoder's final norm."""
        x = frames.to(device=self.embed.w.device, dtype=DTYPE)
        for bp in self.encoder.blocks:
            x = x + self._enc_attn(bp, x, kernel_impl)
            x = x + self._enc_mlp(bp, x)
        return rmsnorm(x, self.encoder.norm.scale, self.cfg.rms_eps)

    def _enc_attn(self, bp: EncoderBlock, x: torch.Tensor,
                  kernel_impl: Optional[str] = None) -> torch.Tensor:
        cfg = self.cfg
        e = cfg.encoder
        h = rmsnorm(x, bp.norm1.scale, cfg.rms_eps)
        return att.attention(bp.attn, h, n_heads=e.n_heads, n_kv_heads=e.n_heads,
                             head_dim=e.d_model // e.n_heads, rope_theta=cfg.rope_theta,
                             causal=False, kernel_impl=kernel_impl)

    def _enc_mlp(self, bp: EncoderBlock, x: torch.Tensor) -> torch.Tensor:
        return bp.mlp(rmsnorm(x, bp.norm2.scale, self.cfg.rms_eps))

    def _encode_if_audio(self, frames: Optional[torch.Tensor],
                         kernel_impl: Optional[str] = None) -> Optional[torch.Tensor]:
        if self.cfg.family != "audio":
            return None
        if frames is None:
            raise ValueError(f"{self.cfg.name}: the audio family needs frames= "
                             "(B, n_ctx, d_model), the frontend stub's embeddings")
        return self.encode(frames, kernel_impl)

    def forward(self, tokens: torch.Tensor, *, mode: str = "train",
                max_cache_len: Optional[int] = None, return_aux: bool = False,
                routing: Optional[List] = None, frames: Optional[torch.Tensor] = None,
                vision_embeds: Optional[torch.Tensor] = None,
                kernel_impl: Optional[str] = None, remat: bool = False,
                experts: Optional[List] = None):
        """tokens (B, S) -> (logits f32, caches).  "train": logits at every
        position, caches None; "prefill": logits (B, 1, V) of the last
        position and the serving state.  ``return_aux`` appends the MoE
        layers' load-balance losses summed (float32 0 without MoE), as the
        reference's forward returns them.  ``routing``, one
        ``moe.Routing`` (or None) per layer, replaces the MoE layers' own:
        the way to hold the rest of the model to another backend's whose
        near-tied top-k may have gone the other way.  ``experts``, one
        int64 top-k tensor (or None) per layer, fixes the MoE layers'
        experts only (``moe.moe_layer``'s ``gate_e``), so a gradient still
        reaches their routers.  The audio family
        takes ``frames`` (B, n_ctx, d_model); the vision family takes
        ``vision_embeds`` (B, n_vision_tokens, d_model), placed before the
        tokens (its logits cover both).

        ``kernel_impl`` picks the routes of B5-B7: None the device rule
        (the kernels on the card), ``"xla"`` the reference's plain routes
        (attention's dense einsum, or its blocked scan above
        ``attention.FLASH_SCAN_THRESHOLD`` positions), ``"flash_scan"``
        the scan at every length, both differentiated by autograd (the
        kernels have no backward, and their entries refuse operands that
        require grad).
        ``remat`` (mode "train" under grad mode) recomputes each block in
        the backward pass (``torch.utils.checkpoint``) instead of keeping
        its activations.  The device is the weights'."""
        if mode not in ("train", "prefill"):
            raise ValueError(f"forward: mode {mode!r} is 'train' or 'prefill'")
        dev = self.embed.w.device
        enc_out = self._encode_if_audio(frames, kernel_impl)
        x = self._embed(tokens.to(dev), vision_embeds)
        caches = []
        aux = torch.zeros((), dtype=F32, device=dev)
        remat = remat and mode == "train" and torch.is_grad_enabled()
        for i, blk in enumerate(self.layers):
            block = functools.partial(
                self._block, blk, mode=mode, max_cache_len=max_cache_len,
                routing=None if routing is None else routing[i],
                experts=None if experts is None else experts[i], enc_out=enc_out,
                kernel_impl=kernel_impl)
            x, c, a = checkpoint(block, x, use_reentrant=False) if remat else block(x)
            caches.append(c)
            if a is not None:
                aux = aux + a
        out = (self._logits(x[:, -1:]), caches) if mode == "prefill" \
            else (self._logits(x), None)
        return out + (aux,) if return_aux else out

    def train_loss(self, tokens: torch.Tensor, labels: torch.Tensor, *,
                   kernel_impl: Optional[str] = "xla", remat: bool = True,
                   aux_weight: float = 0.01, frames: Optional[torch.Tensor] = None,
                   vision_embeds: Optional[torch.Tensor] = None,
                   routing: Optional[List] = None, experts: Optional[List] = None
                   ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """The reference's ``train_loss``: the mean cross entropy of the
        logits against ``labels`` (the vision family's logits past its
        ``n_vision_tokens`` embeddings), plus ``aux_weight`` times the MoE
        layers' load-balance losses.  Returns ``(total, {"ce", "aux"})``.
        ``kernel_impl`` defaults to the plain versions, as the reference's
        training does; ``"pallas"`` or None on operands that require grad
        is refused by the kernel entries.  ``routing`` and ``experts`` as
        :meth:`forward`."""
        logits, _, aux = self.forward(tokens, mode="train", return_aux=True,
                                      kernel_impl=kernel_impl, remat=remat,
                                      frames=frames, vision_embeds=vision_embeds,
                                      routing=routing, experts=experts)
        if self.cfg.family == "vlm":
            logits = logits[:, self.cfg.n_vision_tokens:]
        ce = cross_entropy(logits, labels.to(logits.device))
        return ce + aux_weight * aux, {"ce": ce, "aux": aux}

    @torch.inference_mode()
    def prefill(self, tokens: torch.Tensor, *, max_cache_len: Optional[int] = None,
                routing: Optional[List] = None, frames: Optional[torch.Tensor] = None,
                vision_embeds: Optional[torch.Tensor] = None,
                kernel_impl: Optional[str] = None, experts: Optional[List] = None
                ) -> Tuple[torch.Tensor, List[Cache]]:
        """``max_cache_len``: ring size of full-attention layers; it must
        cover the prompt (the vision embeddings included) and the decode
        budget (defaults to the prompt length, which leaves no room to
        decode).  ``routing``, ``frames``, ``vision_embeds``,
        ``kernel_impl`` and ``experts`` as :meth:`forward`."""
        logits, caches = self.forward(tokens, mode="prefill", max_cache_len=max_cache_len,
                                      routing=routing, frames=frames,
                                      vision_embeds=vision_embeds, kernel_impl=kernel_impl,
                                      experts=experts)
        return logits[:, 0], caches

    @torch.inference_mode()
    def decode_step(self, tokens: torch.Tensor, pos: torch.Tensor, caches: List[Cache],
                    routing: Optional[List] = None) -> Tuple[torch.Tensor, List[Cache]]:
        """tokens (B, 1), pos (B,) -> (logits (B, V) f32, new caches).  Ring
        KV caches are updated in place; cross caches are read.  ``routing``
        as :meth:`forward`."""
        x = self._embed(tokens.to(self.device))
        pos = pos.to(self.device)
        new = []
        for i, (blk, c) in enumerate(zip(self.layers, caches)):
            x, nc, _ = self._block(blk, x, mode="decode", cache=c, pos=pos,
                                   routing=None if routing is None else routing[i])
            new.append(nc)
        return self._logits(x)[:, 0], new

    def serve_state(self, batch: int, max_seq: int,
                    device: DeviceLike = None) -> List[Cache]:
        """Empty ring caches and recurrent states for every layer (zero
        cross caches of the encoder's n_ctx positions for ``xdec``), on
        ``device`` (the model's when None; ``"meta"`` gives shapes and
        types only)."""
        cfg = self.cfg
        dev = self.device if device is None else torch.device(device)
        out = []
        for kind in self.kinds:
            if kind == "ssd":
                out.append(ssm_mod.mamba2_state_init(batch, cfg.d_model, cfg.ssm, dev))
            elif kind == "rec":
                out.append(rg_mod.rglru_state_init(batch, cfg.d_model, cfg.rglru, dev))
            else:
                c = att.cache_init(batch, _cache_len(cfg, kind, max_seq), cfg.n_kv_heads,
                                   cfg.hd, quant=cfg.kv_quant_int8, device=dev)
                if kind == "xdec":
                    shape = (batch, cfg.encoder.n_ctx, cfg.n_heads, cfg.hd)
                    c = {"kv": c, "cross": {
                        "k": torch.zeros(shape, dtype=DTYPE, device=dev),
                        "v": torch.zeros(shape, dtype=DTYPE, device=dev)}}
                out.append(c)
        return out

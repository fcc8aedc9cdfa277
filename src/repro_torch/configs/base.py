"""Architecture configs: plain dataclasses, the same data as the JAX
package's ``configs/base.py``.

Every supported architecture is a declarative :class:`ArchConfig`; the
model in ``repro_torch.models`` consumes it and the serving launcher picks
one with ``--arch <id>``.  :func:`input_specs` gives the model's data
inputs for each of the four assigned shapes as ``meta`` tensors (shape and
dtype, no storage: the PyTorch form of the reference's
``ShapeDtypeStruct``).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import torch

# The four assigned LM shapes (seq_len, global_batch).
SHAPES: Dict[str, Tuple[int, int]] = {
    "train_4k": (4096, 256),
    "prefill_32k": (32768, 32),
    "decode_32k": (32768, 128),
    "long_500k": (524288, 1),
}
DECODE_SHAPES = ("decode_32k", "long_500k")


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    n_experts: int
    top_k: int
    d_ff_expert: int
    capacity_factor: float = 1.25
    local_groups: int = 0


@dataclasses.dataclass(frozen=True)
class SSMConfig:
    state_dim: int = 128
    head_dim: int = 64
    expand: int = 2
    conv_width: int = 4
    chunk: int = 256

    def d_inner(self, d_model: int) -> int:
        return self.expand * d_model

    def n_heads(self, d_model: int) -> int:
        return self.d_inner(d_model) // self.head_dim


@dataclasses.dataclass(frozen=True)
class RGLRUConfig:
    """RecurrentGemma recurrent block (RG-LRU + conv)."""
    lru_width: Optional[int] = None   # defaults to d_model
    conv_width: int = 4
    # layer pattern entry codes: 0 = recurrent block, 1 = local attention
    pattern: Tuple[int, ...] = (0, 0, 1)


@dataclasses.dataclass(frozen=True)
class EncoderConfig:
    """Audio/vision frontend stub: precomputed embeddings enter here."""
    n_layers: int
    n_ctx: int
    d_model: int
    n_heads: int
    d_ff: int


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str              # dense | moe | hybrid | ssm | audio | vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    head_dim: Optional[int] = None
    qkv_bias: bool = False
    rope_theta: float = 10000.0
    rms_eps: float = 1e-6
    tie_embeddings: bool = False
    # Sliding-window attention: window size, and the cyclic layer pattern
    # (1 = global/full attention, 0 = local/SWA).
    swa_window: Optional[int] = None
    attn_pattern: Tuple[int, ...] = (1,)
    moe: Optional[MoEConfig] = None
    ssm: Optional[SSMConfig] = None
    rglru: Optional[RGLRUConfig] = None
    encoder: Optional[EncoderConfig] = None
    n_vision_tokens: int = 0
    kv_quant_int8: bool = False
    act_seq_shard: bool = False
    skip_shapes: Tuple[str, ...] = ()
    notes: str = ""

    @property
    def hd(self) -> int:
        return self.head_dim if self.head_dim is not None else self.d_model // self.n_heads

    @property
    def vocab_padded(self) -> int:
        """Vocab rounded up to a multiple of 256; the padding columns of
        the logits are forced to -1e30."""
        return -(-self.vocab // 256) * 256

    @property
    def is_attention_free(self) -> bool:
        return self.family == "ssm"

    def param_count(self) -> int:
        """Total parameter count N, as the JAX package counts it."""
        d, L = self.d_model, self.n_layers
        n = self.vocab * d
        if not self.tie_embeddings:
            n += self.vocab * d
        if self.family == "ssm":
            s = self.ssm
            di = s.d_inner(d)
            nh = s.n_heads(d)
            conv_dim = di + 2 * s.state_dim
            per = (d * (2 * di + 2 * s.state_dim + nh) + conv_dim * s.conv_width
                   + nh + nh + nh + di + di * d + d)
            return n + L * per
        attn = d * self.n_heads * self.hd + d * 2 * self.n_kv_heads * self.hd \
            + self.n_heads * self.hd * d
        if self.qkv_bias:
            attn += (self.n_heads + 2 * self.n_kv_heads) * self.hd
        if self.moe is not None:
            mlp = self.moe.n_experts * 3 * d * self.moe.d_ff_expert + d * self.moe.n_experts
        else:
            mlp = 3 * d * self.d_ff
        total = n + L * (attn + mlp + 2 * d) + d
        if self.encoder is not None:
            e = self.encoder
            enc_per = (4 * e.d_model * e.d_model + 2 * e.d_model * e.d_ff + 2 * e.d_model)
            total += e.n_layers * enc_per + e.n_ctx * e.d_model
            if self.family == "audio":
                total += L * 4 * d * d
        return total

    def active_param_count(self) -> int:
        if self.moe is None:
            return self.param_count()
        d, L = self.d_model, self.n_layers
        all_experts = L * self.moe.n_experts * 3 * d * self.moe.d_ff_expert
        active = L * self.moe.top_k * 3 * d * self.moe.d_ff_expert
        return self.param_count() - all_experts + active

    def shapes(self) -> Dict[str, Tuple[int, int]]:
        return {k: v for k, v in SHAPES.items() if k not in self.skip_shapes}


# ---------------------------------------------------------------------- #
# Input specs (meta tensors) per (arch, shape).
# ---------------------------------------------------------------------- #
def _meta(shape, dtype) -> torch.Tensor:
    return torch.empty(tuple(shape), dtype=dtype, device="meta")


def input_specs(cfg: ArchConfig, shape_name: str) -> Dict[str, torch.Tensor]:
    """The model's data inputs for an assigned shape, as ``meta`` tensors.

    Train and prefill shapes feed token ids (plus the frontend stubs'
    embeddings for audio and vlm); decode shapes feed one token per
    sequence and its position (the caches are serving state).  A shape the
    config skips raises ``ValueError``.
    """
    if shape_name in cfg.skip_shapes:
        raise ValueError(f"{cfg.name}: shape {shape_name} is skipped: {cfg.notes}")
    seq, batch = SHAPES[shape_name]
    specs: Dict[str, torch.Tensor] = {}
    if shape_name in DECODE_SHAPES:
        specs["tokens"] = _meta((batch, 1), torch.int32)
        specs["pos"] = _meta((batch,), torch.int32)
    else:
        n_txt = seq
        if cfg.family == "vlm":
            n_txt = seq - cfg.n_vision_tokens
            specs["vision_embeds"] = _meta((batch, cfg.n_vision_tokens, cfg.d_model),
                                           torch.bfloat16)
        specs["tokens"] = _meta((batch, n_txt), torch.int32)
        if shape_name == "train_4k":
            specs["labels"] = _meta((batch, n_txt), torch.int32)
    if cfg.family == "audio":
        e = cfg.encoder
        specs["frames"] = _meta((batch, e.n_ctx, e.d_model), torch.bfloat16)
    return specs

"""Config registry: ``--arch <id>`` resolves here (the same data as the
JAX package's registry)."""
from __future__ import annotations

import dataclasses
from typing import Dict

from repro_torch.configs.base import (DECODE_SHAPES, SHAPES, ArchConfig,
                                      EncoderConfig, MoEConfig, RGLRUConfig,
                                      SSMConfig, input_specs)
from repro_torch.configs.gemma3_12b import CONFIG as _gemma3
from repro_torch.configs.granite_8b import CONFIG as _granite
from repro_torch.configs.granite_moe_3b_a800m import CONFIG as _granite_moe
from repro_torch.configs.h2o_danube_3_4b import CONFIG as _danube
from repro_torch.configs.internvl2_1b import CONFIG as _internvl
from repro_torch.configs.mamba2_780m import CONFIG as _mamba2
from repro_torch.configs.olmoe_1b_7b import CONFIG as _olmoe
from repro_torch.configs.qwen2_72b import CONFIG as _qwen2
from repro_torch.configs.recurrentgemma_2b import CONFIG as _rgemma
from repro_torch.configs.whisper_small import CONFIG as _whisper

REGISTRY: Dict[str, ArchConfig] = {c.name: c for c in [
    _gemma3, _danube, _qwen2, _granite, _whisper,
    _granite_moe, _olmoe, _rgemma, _internvl, _mamba2,
]}


def get_config(name: str) -> ArchConfig:
    if name not in REGISTRY:
        raise KeyError(f"unknown arch {name!r}; available: {sorted(REGISTRY)}")
    return REGISTRY[name]


def smoke_config(name: str) -> ArchConfig:
    """Reduced same-family config for CPU tests (small layers and width,
    few experts, tiny vocab), equal to the JAX package's ``smoke_config``."""
    cfg = get_config(name)
    kw = dict(
        n_layers=min(cfg.n_layers, 4) if cfg.rglru is None else 6,
        d_model=64,
        n_heads=max(cfg.n_heads // 4, 2) if cfg.n_heads else 0,
        n_kv_heads=max(min(cfg.n_kv_heads, cfg.n_heads // 4 or 1), 1) if cfg.n_heads else 0,
        d_ff=128,
        vocab=503,
        head_dim=16 if cfg.n_heads else None,
        swa_window=16 if cfg.swa_window else None,
        n_vision_tokens=8 if cfg.n_vision_tokens else 0,
    )
    if cfg.moe is not None:
        kw["moe"] = MoEConfig(n_experts=8, top_k=2, d_ff_expert=32,
                              capacity_factor=8.0)
        kw["d_ff"] = 32
    if cfg.ssm is not None:
        kw["ssm"] = SSMConfig(state_dim=16, head_dim=16, expand=2, conv_width=4, chunk=8)
        kw["n_heads"] = 0
        kw["n_kv_heads"] = 0
        kw["head_dim"] = None
        kw["d_ff"] = 0
    if cfg.rglru is not None:
        kw["rglru"] = RGLRUConfig(lru_width=64, conv_width=4, pattern=cfg.rglru.pattern)
    if cfg.encoder is not None:
        kw["encoder"] = EncoderConfig(n_layers=2, n_ctx=24, d_model=64,
                                      n_heads=2, d_ff=128)
    if cfg.n_kv_heads and cfg.n_heads and kw["n_heads"] % kw["n_kv_heads"]:
        kw["n_kv_heads"] = 1
    return dataclasses.replace(cfg, **kw)


__all__ = ["ArchConfig", "MoEConfig", "SSMConfig", "RGLRUConfig",
           "EncoderConfig", "REGISTRY", "get_config", "smoke_config",
           "SHAPES", "DECODE_SHAPES", "input_specs"]

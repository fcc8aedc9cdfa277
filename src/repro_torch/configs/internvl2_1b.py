"""internvl2-1b [vlm] — InternViT frontend (stub) + InternLM2 backbone.
[arXiv:2404.16821; hf]"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="internvl2-1b",
    family="vlm",
    n_layers=24,
    d_model=896,
    n_heads=14,
    n_kv_heads=2,
    d_ff=4864,
    vocab=151655,
    head_dim=64,
    rope_theta=1_000_000.0,
    attn_pattern=(1,),
    n_vision_tokens=256,          # ViT patch-embedding stub, prepended
    skip_shapes=("long_500k",),
    notes="full-attention LM backbone -> long_500k skipped; vision frontend "
          "is a stub supplying precomputed patch embeddings",
)

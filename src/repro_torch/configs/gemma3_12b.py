"""gemma3-12b [dense] — 5:1 local:global attention, 128k context.
[hf:google/gemma-3-1b-pt; unverified]"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="gemma3-12b",
    family="dense",
    n_layers=48,
    d_model=3840,
    n_heads=16,
    n_kv_heads=8,
    d_ff=15360,
    vocab=262144,
    head_dim=240,                  # d_model / n_heads
    rope_theta=1_000_000.0,
    tie_embeddings=True,           # gemma family ties embeddings
    swa_window=1024,
    attn_pattern=(0, 0, 0, 0, 0, 1),   # 5 local : 1 global
    # SWA-dominant -> sub-quadratic decode; long_500k runs.
    notes="5:1 local:global; long_500k served by SWA ring caches + sparse "
          "global layers (8 of 48 full)",
)

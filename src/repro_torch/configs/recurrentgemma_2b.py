"""recurrentgemma-2b [hybrid] — RG-LRU + local attention, 1 attn : 2
recurrent pattern. [arXiv:2402.19427; hf]

The RG-LRU recurrence is the paper's delay-token feedback FIFO (IIR
example); the 2:1 layer cycle is a CSDF rate table."""
from repro_torch.configs.base import ArchConfig, RGLRUConfig

CONFIG = ArchConfig(
    name="recurrentgemma-2b",
    family="hybrid",
    n_layers=26,
    d_model=2560,
    n_heads=10,
    n_kv_heads=1,
    d_ff=7680,
    vocab=256000,
    head_dim=256,
    rope_theta=10000.0,
    tie_embeddings=True,
    swa_window=2048,
    # pattern entries: 0 = RG-LRU recurrent block, 1 = local attention
    rglru=RGLRUConfig(lru_width=2560, conv_width=4, pattern=(0, 0, 1)),
    attn_pattern=(0,),            # its attention layers are all local (SWA)
    notes="hybrid (recurrent + SWA) -> sub-quadratic; long_500k runs",
)

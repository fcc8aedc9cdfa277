"""olmoe-1b-7b [moe] — 64 experts top-8. [arXiv:2409.02060; hf]"""
from repro_torch.configs.base import ArchConfig, MoEConfig

CONFIG = ArchConfig(
    name="olmoe-1b-7b",
    family="moe",
    n_layers=16,
    d_model=2048,
    n_heads=16,
    n_kv_heads=16,
    d_ff=1024,
    vocab=50304,
    head_dim=128,
    rope_theta=10000.0,
    attn_pattern=(1,),
    moe=MoEConfig(n_experts=64, top_k=8, d_ff_expert=1024),
    skip_shapes=("long_500k",),
    notes="full attention -> long_500k skipped; experts = dynamic actors",
)

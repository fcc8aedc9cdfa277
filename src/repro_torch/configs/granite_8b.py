"""granite-8b [dense] — llama-arch code model. [arXiv:2405.04324; hf]"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="granite-8b",
    family="dense",
    n_layers=36,
    d_model=4096,
    n_heads=32,
    n_kv_heads=8,
    d_ff=14336,
    vocab=49152,
    head_dim=128,
    rope_theta=10000.0,
    attn_pattern=(1,),
    skip_shapes=("long_500k",),
    notes="pure full attention -> long_500k skipped per assignment rules",
)

"""h2o-danube-3-4b [dense] — llama+mistral mix, sliding-window attention.
[arXiv:2401.16818; unverified]"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="h2o-danube-3-4b",
    family="dense",
    n_layers=24,
    d_model=3840,
    n_heads=32,
    n_kv_heads=8,
    d_ff=10240,
    vocab=32000,
    head_dim=120,                 # d_model / n_heads
    rope_theta=10000.0,
    swa_window=4096,
    attn_pattern=(0,),            # uniform SWA (mistral-style)
    notes="uniform SWA window 4096 -> sub-quadratic; long_500k runs",
)

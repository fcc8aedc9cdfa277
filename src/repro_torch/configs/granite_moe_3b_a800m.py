"""granite-moe-3b-a800m [moe] — 40 experts top-8, d_ff_expert=512.
[hf:ibm-granite/granite-3.0-1b-a400m-base; hf]

Dynamic-rate showcase: the router is the paper's control actor; every
expert is a dynamic actor with per-firing token rate 0..capacity
(the JAX package's graphs/moe_as_actors.py)."""
from repro_torch.configs.base import ArchConfig, MoEConfig

CONFIG = ArchConfig(
    name="granite-moe-3b-a800m",
    family="moe",
    n_layers=32,
    d_model=1536,
    n_heads=24,
    n_kv_heads=8,
    d_ff=512,                     # per-expert ff (assignment block)
    vocab=49155,
    head_dim=64,
    rope_theta=10000.0,
    attn_pattern=(1,),
    moe=MoEConfig(n_experts=40, top_k=8, d_ff_expert=512),
    skip_shapes=("long_500k",),
    notes="full attention -> long_500k skipped; experts = dynamic actors",
)

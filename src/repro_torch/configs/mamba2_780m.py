"""mamba2-780m [ssm] — SSD (state-space duality), attention-free.
[arXiv:2405.21060; unverified]

The paper's dynamic-rate mechanism is inapplicable to an attention-free
SSM (no routing, no variable consumption); it appears only as the
delay-token state-feedback FIFO of the recurrence."""
from repro_torch.configs.base import ArchConfig, SSMConfig

CONFIG = ArchConfig(
    name="mamba2-780m",
    family="ssm",
    n_layers=48,
    d_model=1536,
    n_heads=0,                    # attention-free
    n_kv_heads=0,
    d_ff=0,
    vocab=50280,
    ssm=SSMConfig(state_dim=128, head_dim=64, expand=2, conv_width=4, chunk=256),
    notes="SSM -> sub-quadratic; long_500k runs (O(1) decode state)",
)

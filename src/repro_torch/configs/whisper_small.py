"""whisper-small [audio] — enc-dec transformer backbone; conv frontend is a
STUB (input_specs provides precomputed frame embeddings).
[arXiv:2212.04356; unverified]"""
from repro_torch.configs.base import ArchConfig, EncoderConfig

CONFIG = ArchConfig(
    name="whisper-small",
    family="audio",
    n_layers=12,                  # decoder layers
    d_model=768,
    n_heads=12,
    n_kv_heads=12,                # GQA kv=12 == MHA
    d_ff=3072,
    vocab=51865,
    head_dim=64,
    rope_theta=10000.0,           # backbone uses RoPE in this repro (learned
                                  # pos-emb in the original)
    attn_pattern=(1,),
    encoder=EncoderConfig(n_layers=12, n_ctx=1500, d_model=768, n_heads=12,
                          d_ff=3072),
    skip_shapes=("long_500k",),
    notes="enc-dec audio; decode_32k runs (it is enc-dec, not encoder-only); "
          "512k text decode out of domain -> long_500k skipped",
)

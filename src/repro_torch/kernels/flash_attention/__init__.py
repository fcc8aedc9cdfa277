from repro_torch.kernels.flash_attention.kernel import flash_attention_cuda
from repro_torch.kernels.flash_attention.ops import flash_attention
from repro_torch.kernels.flash_attention.ref import (NEG_INF, attention_mask,
                                                     flash_attention_ref,
                                                     masked_attention_ref)

__all__ = ["flash_attention", "flash_attention_cuda", "flash_attention_ref",
           "masked_attention_ref", "attention_mask", "NEG_INF"]

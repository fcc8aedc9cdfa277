from repro_torch.kernels.gauss5x5.kernel import gauss5x5_cuda
from repro_torch.kernels.gauss5x5.ops import gauss5x5, gauss5x5_u8
from repro_torch.kernels.gauss5x5.ref import (KERNEL_1D, KERNEL_2D, gauss5x5_ref,
                                              gauss5x5_u8_ref, to_u8)

__all__ = ["gauss5x5", "gauss5x5_u8", "gauss5x5_cuda", "gauss5x5_ref",
           "gauss5x5_u8_ref", "to_u8", "KERNEL_1D", "KERNEL_2D"]

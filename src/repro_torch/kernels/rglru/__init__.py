from repro_torch.kernels.rglru.kernel import rglru_cuda
from repro_torch.kernels.rglru.ops import rglru
from repro_torch.kernels.rglru.ref import rglru_ref, rglru_scan

__all__ = ["rglru", "rglru_cuda", "rglru_ref", "rglru_scan"]

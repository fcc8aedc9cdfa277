from repro_torch.kernels.ssd.kernel import ssd_cuda
from repro_torch.kernels.ssd.ops import ssd
from repro_torch.kernels.ssd.ref import ssd_naive, ssd_ref

__all__ = ["ssd", "ssd_cuda", "ssd_ref", "ssd_naive"]

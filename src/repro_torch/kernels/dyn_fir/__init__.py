from repro_torch.kernels.dyn_fir.kernel import dpd_branch_cuda
from repro_torch.kernels.dyn_fir.ops import dpd_branch, poly_branch
from repro_torch.kernels.dyn_fir.ref import (N_BRANCHES, N_TAPS, basis_ref,
                                             branch_ref, fir_ref, poly_ref)

__all__ = ["dpd_branch", "dpd_branch_cuda", "poly_branch", "branch_ref",
           "basis_ref", "fir_ref", "poly_ref", "N_TAPS", "N_BRANCHES"]

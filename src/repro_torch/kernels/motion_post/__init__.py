from repro_torch.kernels.motion_post.kernel import motion_post_cuda
from repro_torch.kernels.motion_post.ops import motion_post
from repro_torch.kernels.motion_post.ref import (DEFAULT_THRESHOLD, med_ref,
                                                 median5, motion_post_ref,
                                                 thres_ref)

__all__ = ["motion_post", "motion_post_cuda", "motion_post_ref", "thres_ref",
           "med_ref", "median5", "DEFAULT_THRESHOLD"]

"""repro_torch.core.megakernel — device-resident dynamic actor scheduling.

The megakernel backend (``ExecutionPlan(mode="megakernel")``): the network
is lowered (``lower.py``: layout, firing table, grid cut), packed into a
device program (``program.py``) and run to quiescence by ONE launch of the
persistent Hopper kernel B2 (``kernel.py``, ``csrc/megakernel.cu``), or by
its plain PyTorch version (``ref.py``) for a state on the CPU.
"""
from repro_torch.core.megakernel.kernel import compile_megakernel, megakernel_cuda
from repro_torch.core.megakernel.lower import (CUT_OBJECTIVES, SHARED, FiringRow,
                                               GridPartition, MegakernelLayout,
                                               PortBinding, default_assignment,
                                               entry_staging_bytes, lower_network,
                                               partition_layout, state_hbm_bytes)
from repro_torch.core.megakernel.program import DeviceProgram, build_device_program

__all__ = [
    "CUT_OBJECTIVES", "SHARED", "DeviceProgram", "FiringRow", "GridPartition",
    "MegakernelLayout", "PortBinding", "build_device_program",
    "compile_megakernel", "default_assignment", "entry_staging_bytes",
    "lower_network", "megakernel_cuda", "partition_layout", "state_hbm_bytes",
]

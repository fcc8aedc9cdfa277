"""Production mesh construction (the port of ``src/repro/launch/mesh.py``).

Functions, not module constants: importing this module touches no process
group.  A mesh is a ``DeviceMesh`` over the default ``torch.distributed``
group, which must hold exactly as many ranks as the mesh has devices:
start them with ``torchrun --nproc-per-node N``, or, for a dry run on the
host, join a fake group (``repro_torch.launch.dryrun.fake_group``).
"""
from __future__ import annotations

from typing import Optional, Sequence, Tuple


def _mesh(shape: Tuple[int, ...], axes: Tuple[str, ...], device_type: Optional[str]):
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    need = 1
    for n in shape:
        need *= n
    world = dist.get_world_size() if dist.is_available() and dist.is_initialized() else None
    if world != need:
        have = "no process group" if world is None else f"a group of {world} ranks"
        raise RuntimeError(
            f"a {dict(zip(axes, shape))} mesh needs a torch.distributed group of exactly "
            f"{need} ranks, and this process has {have}: start the ranks with "
            f"`torchrun --nproc-per-node {need}` (or init_process_group), or, for a dry run "
            f"on the host, join a fake group of {need} ranks "
            "(repro_torch.launch.dryrun.fake_group)")
    return init_device_mesh(device_type or "cuda", tuple(shape), mesh_dim_names=tuple(axes))


def make_production_mesh(*, multi_pod: bool = False, device_type: Optional[str] = None):
    """Single pod: (data=16, model=16) = 256 devices.  Multi-pod:
    (pod=2, data=16, model=16) = 512; the ``pod`` axis is pure data
    parallel.  ``device_type`` None is ``"cuda"``."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return _mesh(shape, axes, device_type)


def make_test_mesh(shape: Sequence[int] = (2, 2), axes: Sequence[str] = ("data", "model"),
                   device_type: Optional[str] = None):
    """A small mesh for multi-process tests (``device_type="cpu"`` there)."""
    return _mesh(tuple(shape), tuple(axes), device_type)

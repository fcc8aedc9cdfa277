"""Build the port's CUDA sources into shared libraries and load them.

Each ``csrc/<name>.cu`` (``dyn_fir`` B1, ``megakernel`` B2, ``gauss5x5``
B3, ``motion_post`` B4, ``flash_attention`` B5, ``ssd`` B6, ``rglru`` B7)
has a plain C interface and is compiled by its own ``nvcc`` for Hopper
(``sm_90a``) into ``_build/lib<name>-<hash>.so`` on first use, keyed by a
hash of the source, the shared headers and the flags (a build with extra
``-D`` defines, such as B2's clock split, is a library of its own), then
loaded with ``ctypes``.
``_build/`` is listed in ``.gitignore``.  A missing ``nvcc`` or a failed
compile raises; nothing falls back.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Dict, Tuple

_PKG = Path(__file__).resolve().parents[1]
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v")


def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found is None and os.path.exists("/usr/local/cuda/bin/nvcc"):
        found = "/usr/local/cuda/bin/nvcc"
    if found is None:
        raise RuntimeError(
            "nvcc not found (PATH or /usr/local/cuda/bin); the port's CUDA "
            "kernels are built from csrc/ at first use on a machine with "
            "the CUDA toolkit")
    return found


def library_path(name: str, defines: Tuple[str, ...] = ()) -> Path:
    """Where ``csrc/<name>.cu`` builds to: keyed by the sources and flags,
    ``defines`` (``-D`` flags) included."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS + tuple(defines)).encode())
    h.update((CSRC / f"{name}.cu").read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        h.update(header.read_bytes())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def build(*names: str, defines: Tuple[str, ...] = ()) -> Dict[str, str]:
    """Compile each ``csrc/<name>.cu`` that is not built yet (with the
    ``-D`` flags ``defines``), one ``nvcc`` per library, all started
    together; return each library's ``nvcc`` output (ptxas registers, shared
    memory, spills), empty when there was nothing to build.  Raises if a
    compile fails."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in names:
        lib = library_path(name, defines)
        if lib.exists():
            continue
        tmp = lib.with_suffix(f".{os.getpid()}.tmp")
        procs[name] = (tmp, lib, subprocess.Popen(
            [nvcc_path(), *NVCC_FLAGS, *defines, "-o", str(tmp),
             str(CSRC / f"{name}.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    out = {name: "" for name in names}
    failed = []
    for name, (tmp, lib, proc) in procs.items():
        out[name] = proc.communicate()[0]
        if proc.returncode != 0:
            failed.append(f"building {name}.cu failed (nvcc exit "
                          f"{proc.returncode}):\n{out[name]}")
        else:
            os.replace(tmp, lib)
    if failed:
        raise RuntimeError("\n".join(failed))
    return out


@functools.lru_cache(maxsize=None)
def load(name: str, defines: Tuple[str, ...] = ()) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu`` (built with ``defines``),
    built first if needed."""
    build(name, defines=defines)
    return ctypes.CDLL(str(library_path(name, defines)))

"""Checkpoints on the reference's on-disk format (``src/repro/checkpoint/
checkpointer.py``), byte for byte, so either package loads what the other
wrote.

Two stores:

* :class:`Checkpointer`, a store for trees of tensors (dicts, lists and
  tuples; dict keys in sorted order, as the reference's pytrees)::

      ckpt_dir/step_00000123/
          manifest.json           # step, tree structure, n_leaves, shapes/dtypes
          leaf_0000/shard_0.npy   # the leaf
          leaf_0000/shard_0.idx.json

  Saves snapshot the leaves to host memory at once and write them on a
  thread (``wait()`` joins it); ``step_XXXX.tmp`` -> ``os.replace`` makes
  a save atomic, and the newest ``keep`` steps are kept.  A tensor leaf is
  saved as one shard.  A tree with DTensor leaves (a sharded train state)
  is saved by every rank of the process group together, in the caller's
  thread: each distinct shard is written once, with its global index, by
  the rank at coordinate 0 on the mesh dims where the shard is replicated
  (``shard_j``, ``j`` the shard's row-major position over the mesh dims
  that split it); rank 0 commits the step after a barrier.
  ``restore(..., shardings=)`` places each leaf on a mesh, reading only
  the stored chunks that cover this rank's shard, whatever mesh wrote them
  (the reference's elastic restore).

* The durable stream snapshots (:func:`save_stream_checkpoint`,
  :func:`load_stream_checkpoint`): ``chunk_%08d/manifest.json`` with
  ``format_version``, a JSON ``skeleton`` of the payload's plain
  containers, one ``leaf_%04d.npy`` per array leaf with its CRC32 over the
  file's bytes, shape and dtype, and ``meta``.  A torn snapshot fails its
  CRC and the next older one is loaded.

Tensors go through ``.cpu()`` on save and come back as CPU tensors on
load (the caller moves them to its device).  bf16 leaves are written as
float32 ``.npy`` files under the dtype name ``"bfloat16"``, as the
reference writes them; the port maps that name to ``torch.bfloat16``
itself (numpy has no bf16).
"""
from __future__ import annotations

import json
import os
import shutil
import threading
import zlib
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

PyTree = Any

#: Version of the stream snapshot manifest (the reference's).
STREAM_CKPT_VERSION = 1


class CheckpointIntegrityError(RuntimeError):
    """No intact stream checkpoint could be loaded from a directory."""


# --------------------------------------------------------------------------- #
# Leaves: tensors and numpy arrays <-> .npy files.
# --------------------------------------------------------------------------- #
def _dtype_name(x: Any) -> str:
    """The reference's dtype name of a leaf (``str(np.dtype)``, and
    ``"bfloat16"`` for bf16)."""
    if isinstance(x, torch.Tensor):
        return str(x.dtype).split(".")[-1]
    return str(x.dtype)


def _host_array(x: Any) -> np.ndarray:
    """A leaf as the numpy array written to its file: bf16 (a torch bf16
    tensor, or a numpy extension type) as float32, losslessly."""
    if isinstance(x, torch.Tensor):
        t = x.detach().cpu()
        if t.dtype == torch.bfloat16:
            t = t.float()
        return np.asarray(t.numpy(), order="C")
    arr = np.asarray(x)
    if arr.dtype.kind == "V" or arr.dtype.name not in np.sctypeDict:
        arr = np.asarray(arr, np.float32)
    return np.asarray(arr, order="C")


def _torch_dtype(name: str) -> torch.dtype:
    dt = getattr(torch, name, None)
    if not isinstance(dt, torch.dtype):
        raise CheckpointIntegrityError(f"unsupported leaf dtype {name!r}")
    return dt


def _load_leaf(path: str, dtype_name: str) -> torch.Tensor:
    """A leaf file as a CPU tensor of ``dtype_name``."""
    arr = np.load(path)
    if dtype_name == "bfloat16":
        return torch.from_numpy(np.asarray(arr, np.float32, order="C")).to(torch.bfloat16)
    return torch.from_numpy(np.asarray(arr, np.dtype(dtype_name), order="C"))


def _is_leaf(x: Any) -> bool:
    return isinstance(x, (torch.Tensor, np.ndarray))


def _flatten(tree: PyTree) -> Tuple[List[Any], Any]:
    """Leaves in the reference's pytree order (dict keys sorted) and a JSON
    description of the containers (``{"__leaf__": i}`` at each leaf)."""
    leaves: List[Any] = []

    def walk(x: Any) -> Any:
        if isinstance(x, dict):
            return {"__dict__": {str(k): walk(x[k]) for k in sorted(x)}}
        if isinstance(x, (list, tuple)):
            return {"__tuple__" if isinstance(x, tuple) else "__list__":
                    [walk(v) for v in x]}
        leaves.append(x)
        return {"__leaf__": len(leaves) - 1}

    return leaves, walk(tree)


def _unflatten(template: PyTree, leaves: List[Any]) -> PyTree:
    it = iter(leaves)

    def walk(x: Any) -> Any:
        if isinstance(x, dict):
            return {k: walk(x[k]) for k in sorted(x)}
        if isinstance(x, (list, tuple)):
            return type(x)(walk(v) for v in x)
        return next(it)

    return walk(template)


# --------------------------------------------------------------------------- #
# Checkpointer: a store for trees of tensors.
# --------------------------------------------------------------------------- #
def _leaf_dirname(i: int) -> str:
    return f"leaf_{i:04d}"


class Checkpointer:
    """Atomic, asynchronous saves of trees of tensors under ``directory``,
    keeping the newest ``keep`` steps."""

    def __init__(self, directory: str, keep: int = 3):
        self.dir = directory
        self.keep = keep
        os.makedirs(directory, exist_ok=True)
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None

    def save(self, step: int, tree: PyTree, blocking: bool = False) -> None:
        """Snapshot every leaf to host memory now, write on a thread (or
        here with ``blocking=True``)."""
        self.wait()
        leaves, skeleton = _flatten(tree)
        if any(_is_dtensor(leaf) for leaf in leaves):
            self._save_sharded(step, leaves, skeleton)
            return
        # Host copies taken now, so the caller may update its tensors while
        # the writer runs.
        snaps = [(_host_array(leaf).copy(), _dtype_name(leaf)) for leaf in leaves]
        manifest = {
            "step": step,
            "treedef": json.dumps(skeleton),
            "n_leaves": len(leaves),
            "leaves": [{"shape": list(a.shape), "dtype": name} for a, name in snaps],
        }

        def write() -> None:
            tmp = os.path.join(self.dir, f"step_{step:08d}.tmp")
            final = os.path.join(self.dir, f"step_{step:08d}")
            if os.path.exists(tmp):
                shutil.rmtree(tmp)
            os.makedirs(tmp)
            for i, (arr, _) in enumerate(snaps):
                d = os.path.join(tmp, _leaf_dirname(i))
                os.makedirs(d)
                np.save(os.path.join(d, "shard_0.npy"), arr)
                with open(os.path.join(d, "shard_0.idx.json"), "w") as f:
                    json.dump({"index": [[0, n] for n in arr.shape]}, f)
            with open(os.path.join(tmp, "manifest.json"), "w") as f:
                json.dump(manifest, f)
            if os.path.exists(final):
                shutil.rmtree(final)
            os.replace(tmp, final)
            self._gc()

        if blocking:
            write()
            return

        def guarded() -> None:
            try:
                write()
            except Exception as e:          # re-raised by wait()
                self._error = e

        self._thread = threading.Thread(target=guarded, daemon=True)
        self._thread.start()

    def _save_sharded(self, step: int, leaves: List[Any], skeleton: Any) -> None:
        """Every rank writes the shards it owns into one ``.tmp`` directory;
        rank 0 writes the manifest and commits after a barrier."""
        import torch.distributed as dist
        rank = dist.get_rank()
        shards = []      # per leaf: [(j, index, host array)] this rank writes
        metas = []
        for leaf in leaves:
            metas.append({"shape": list(leaf.shape), "dtype": _dtype_name(leaf)})
            if _is_dtensor(leaf):
                owns, j, region = _shard_of(leaf)
                arr = _host_array(leaf.to_local()).copy() if owns else None
                shards.append([(j, [[r.start, r.stop] for r in region], arr)] if owns else [])
            elif rank == 0:
                arr = _host_array(leaf).copy()
                shards.append([(0, [[0, n] for n in arr.shape], arr)])
            else:
                shards.append([])
        tmp = os.path.join(self.dir, f"step_{step:08d}.tmp")
        final = os.path.join(self.dir, f"step_{step:08d}")
        if rank == 0:
            if os.path.exists(tmp):
                shutil.rmtree(tmp)
            os.makedirs(tmp)
        dist.barrier()
        for i, owned in enumerate(shards):
            d = os.path.join(tmp, _leaf_dirname(i))
            os.makedirs(d, exist_ok=True)
            for j, index, arr in owned:
                np.save(os.path.join(d, f"shard_{j}.npy"), arr)
                with open(os.path.join(d, f"shard_{j}.idx.json"), "w") as f:
                    json.dump({"index": index}, f)
        dist.barrier()
        if rank == 0:
            manifest = {"step": step, "treedef": json.dumps(skeleton),
                        "n_leaves": len(leaves), "leaves": metas}
            with open(os.path.join(tmp, "manifest.json"), "w") as f:
                json.dump(manifest, f)
            if os.path.exists(final):
                shutil.rmtree(final)
            os.replace(tmp, final)
            self._gc()
        dist.barrier()

    def wait(self) -> None:
        """Join the writer; raise what it raised."""
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            err, self._error = self._error, None
            raise err

    def _gc(self) -> None:
        steps = self.all_steps()
        for s in steps[:-self.keep] if self.keep else []:
            shutil.rmtree(os.path.join(self.dir, f"step_{s:08d}"), ignore_errors=True)

    def all_steps(self) -> List[int]:
        """Committed steps, ascending (``.tmp`` directories are not)."""
        out = []
        for name in os.listdir(self.dir):
            if name.startswith("step_") and not name.endswith(".tmp"):
                out.append(int(name.split("_")[1]))
        return sorted(out)

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def restore(self, step: int, target: PyTree, shardings: Optional[PyTree] = None,
                mesh: Any = None) -> PyTree:
        """Restore into the structure of ``target`` (tensors, ``meta``
        tensors included, giving shapes) with the stored dtypes.

        Without ``shardings`` each leaf is assembled whole from its stored
        shards, whatever their split, on its target leaf's device (the CPU
        for ``meta``).  ``shardings`` is a tree shaped like ``target`` of
        ``(mesh, placements)`` pairs, or of specs (``train.sharding``) with
        ``mesh``; a ``None`` there restores that leaf whole.  A placed leaf
        comes back as a DTensor on the mesh's device whose local shard is
        read from the stored chunks that cover it.
        """
        root = os.path.join(self.dir, f"step_{step:08d}")
        with open(os.path.join(root, "manifest.json")) as f:
            manifest = json.load(f)
        leaves, _ = _flatten(target)
        if manifest["n_leaves"] != len(leaves):
            raise ValueError(
                f"checkpoint has {manifest['n_leaves']} leaves, target has "
                f"{len(leaves)} — structure mismatch")
        places = (_leaves_like(target, shardings) if shardings is not None
                  else [None] * len(leaves))
        out = []
        for i, (leaf, meta, place) in enumerate(zip(leaves, manifest["leaves"], places)):
            d = os.path.join(root, _leaf_dirname(i))
            shape = tuple(meta["shape"])
            if tuple(leaf.shape) != shape:
                raise ValueError(f"leaf {i}: stored {shape} != target {tuple(leaf.shape)}")
            if place is not None:
                out.append(_restore_placed(d, meta, place, mesh))
                continue
            full = _read_region(d, meta, tuple(slice(0, n) for n in shape))
            dev = getattr(leaf, "device", None)
            if isinstance(dev, torch.device) and dev.type != "meta":
                full = full.to(dev)
            out.append(full)
        return _unflatten(target, out)


def _is_dtensor(x: Any) -> bool:
    from torch.distributed.tensor import DTensor
    return isinstance(x, DTensor)


def _shard_of(x: Any) -> Tuple[bool, int, Tuple[slice, ...]]:
    """(whether this rank writes a DTensor's local shard, the shard's
    number, its global region)."""
    from repro_torch.train.sharding import local_region, mesh_coordinate
    mesh = x.device_mesh
    sizes = tuple(mesh.mesh.shape)
    coord = mesh_coordinate(mesh)
    owns = all(c == 0 for c, p in zip(coord, x.placements) if not p.is_shard())
    j = 0
    for i, p in enumerate(x.placements):
        if p.is_shard():
            j = j * sizes[i] + coord[i]
    return owns, j, local_region(x.shape, x.placements, sizes, coord)


def _leaves_like(target: PyTree, tree: PyTree) -> List[Any]:
    """The nodes of ``tree`` at ``target``'s leaves, in ``_flatten`` order
    (a spec or a ``(mesh, placements)`` pair is a leaf of ``tree``)."""
    out: List[Any] = []

    def walk(t: Any, s: Any) -> None:
        if isinstance(t, dict):
            for k in sorted(t):
                walk(t[k], None if s is None else s[k])
        elif isinstance(t, (list, tuple)):
            for i, v in enumerate(t):
                walk(v, None if s is None else s[i])
        else:
            out.append(s)

    walk(target, tree)
    return out


def _from_host(arr: np.ndarray, dtype_name: str) -> torch.Tensor:
    """A (memory-mapped) stored chunk as a tensor of the leaf's dtype."""
    if dtype_name == "bfloat16":
        return torch.from_numpy(np.array(arr, np.float32, order="C")).to(torch.bfloat16)
    return torch.from_numpy(np.array(arr, np.dtype(dtype_name), order="C"))


def _read_region(d: str, meta: Dict[str, Any], region: Tuple[slice, ...]) -> torch.Tensor:
    """The stored leaf's values in ``region`` (a CPU tensor), read from the
    shards whose index meets it."""
    out = torch.empty(tuple(r.stop - r.start for r in region),
                      dtype=_torch_dtype(meta["dtype"]))
    j = 0
    while os.path.exists(os.path.join(d, f"shard_{j}.npy")):
        with open(os.path.join(d, f"shard_{j}.idx.json")) as f:
            idx = json.load(f)["index"]
        meet = [(max(a, r.start), min(b, r.stop)) for (a, b), r in zip(idx, region)]
        if all(lo < hi for lo, hi in meet):
            arr = np.load(os.path.join(d, f"shard_{j}.npy"), mmap_mode="r")
            src = tuple(slice(lo - a, hi - a) for (lo, hi), (a, _) in zip(meet, idx))
            dst = tuple(slice(lo - r.start, hi - r.start) for (lo, hi), r in zip(meet, region))
            out[dst] = _from_host(arr[src], meta["dtype"])
        j += 1
    return out


def _restore_placed(d: str, meta: Dict[str, Any], place: Any, mesh: Any) -> Any:
    """One leaf as a DTensor at ``place`` (a spec with ``mesh``, or a
    ``(mesh, placements)`` pair)."""
    from torch.distributed.tensor import DTensor
    from repro_torch.train.sharding import local_region, mesh_coordinate, placements
    if mesh is not None:
        m, pl = mesh, placements(place, mesh)
    else:
        m, pl = place
        pl = list(pl)
    shape = tuple(meta["shape"])
    region = local_region(shape, pl, tuple(m.mesh.shape), mesh_coordinate(m))
    local = _read_region(d, meta, region)
    dev = (torch.device("cuda", torch.cuda.current_device()) if m.device_type == "cuda"
           else torch.device(m.device_type))
    return DTensor.from_local(local.to(dev), m, pl, run_check=False)


# --------------------------------------------------------------------------- #
# Durable stream snapshots.
# --------------------------------------------------------------------------- #
def _skeletonize(obj: Any, leaves: List[Any]) -> Any:
    """Split a plain-container payload into (JSON skeleton, array leaves)."""
    if _is_leaf(obj):
        leaves.append(obj)
        return {"__leaf__": len(leaves) - 1}
    if isinstance(obj, dict):
        return {"__dict__": {str(k): _skeletonize(v, leaves) for k, v in obj.items()}}
    if isinstance(obj, (list, tuple)):
        kind = "__tuple__" if isinstance(obj, tuple) else "__list__"
        return {kind: [_skeletonize(v, leaves) for v in obj]}
    if obj is None or isinstance(obj, (bool, int, float, str)):
        return {"__val__": obj}
    if isinstance(obj, (np.integer, np.floating, np.bool_)):
        return {"__val__": obj.item()}
    raise TypeError(
        f"stream checkpoint payload holds a {type(obj).__name__}; only "
        "tensors, arrays, dicts, lists/tuples and JSON scalars are serializable")


def _unskeletonize(skel: Any, leaves: List[torch.Tensor]) -> Any:
    if "__leaf__" in skel:
        return leaves[skel["__leaf__"]]
    if "__dict__" in skel:
        return {k: _unskeletonize(v, leaves) for k, v in skel["__dict__"].items()}
    if "__list__" in skel:
        return [_unskeletonize(v, leaves) for v in skel["__list__"]]
    if "__tuple__" in skel:
        return tuple(_unskeletonize(v, leaves) for v in skel["__tuple__"])
    return skel["__val__"]


def _step_dir(directory: str, step: int) -> str:
    return os.path.join(directory, f"chunk_{step:08d}")


def save_stream_checkpoint(directory: str, step: int, payload: PyTree,
                           meta: Optional[Dict[str, Any]] = None,
                           keep: Optional[int] = 3) -> str:
    """Write one durable snapshot; returns its committed path.

    ``payload`` is plain containers (dict/list/tuple) of tensors, numpy
    arrays and JSON scalars.  ``keep`` bounds retention (None keeps every
    snapshot; the default 3 leaves history for the CRC fallback).
    """
    leaves: List[Any] = []
    skel = _skeletonize(payload, leaves)
    tmp = _step_dir(directory, step) + ".tmp"
    final = _step_dir(directory, step)
    os.makedirs(directory, exist_ok=True)
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp)
    leaf_meta = []
    for i, leaf in enumerate(leaves):
        fname = f"leaf_{i:04d}.npy"
        arr = _host_array(leaf)
        np.save(os.path.join(tmp, fname), arr)
        with open(os.path.join(tmp, fname), "rb") as f:
            crc = zlib.crc32(f.read())
        leaf_meta.append({"file": fname, "crc32": crc, "shape": list(arr.shape),
                          "dtype": _dtype_name(leaf)})
    manifest = {"format_version": STREAM_CKPT_VERSION, "step": step,
                "skeleton": skel, "leaves": leaf_meta, "meta": dict(meta or {})}
    with open(os.path.join(tmp, "manifest.json"), "w") as f:
        json.dump(manifest, f)
    if os.path.exists(final):
        shutil.rmtree(final)
    os.replace(tmp, final)
    if keep:
        for s in stream_checkpoint_steps(directory)[:-keep]:
            shutil.rmtree(_step_dir(directory, s), ignore_errors=True)
    return final


def stream_checkpoint_steps(directory: str) -> List[int]:
    """Committed (non-tmp) snapshot steps, ascending."""
    if not os.path.isdir(directory):
        return []
    out = []
    for name in os.listdir(directory):
        if name.startswith("chunk_") and not name.endswith(".tmp"):
            try:
                out.append(int(name.split("_")[1]))
            except ValueError:
                continue
    return sorted(out)


def _load_one(directory: str, step: int) -> Tuple[PyTree, Dict[str, Any]]:
    root = _step_dir(directory, step)
    with open(os.path.join(root, "manifest.json")) as f:
        manifest = json.load(f)
    ver = manifest.get("format_version")
    if ver != STREAM_CKPT_VERSION:
        raise CheckpointIntegrityError(
            f"{root}: format_version {ver} != supported {STREAM_CKPT_VERSION}")
    leaves = []
    for m in manifest["leaves"]:
        path = os.path.join(root, m["file"])
        with open(path, "rb") as f:
            crc = zlib.crc32(f.read())
        if crc != m["crc32"]:
            raise CheckpointIntegrityError(
                f"{path}: CRC32 {crc:#010x} != manifest {m['crc32']:#010x} "
                "(bit rot or torn write)")
        leaves.append(_load_leaf(path, m["dtype"]))
    return _unskeletonize(manifest["skeleton"], leaves), manifest["meta"]


def load_stream_checkpoint(directory: str, step: Optional[int] = None
                           ) -> Tuple[PyTree, Dict[str, Any], int]:
    """Load the newest intact snapshot (or exactly ``step``); returns
    ``(payload, meta, step)`` with every array leaf a CPU tensor.

    A snapshot failing its CRC or version check is skipped for the next
    older one; :class:`CheckpointIntegrityError` when none is intact.
    """
    steps = ([step] if step is not None
             else list(reversed(stream_checkpoint_steps(directory))))
    if not steps:
        raise CheckpointIntegrityError(f"{directory}: no stream checkpoints found")
    errors = []
    for s in steps:
        try:
            payload, meta = _load_one(directory, s)
            return payload, meta, s
        except (CheckpointIntegrityError, OSError, KeyError, ValueError,
                json.JSONDecodeError) as e:
            errors.append(f"chunk_{s:08d}: {e}")
    raise CheckpointIntegrityError(
        f"{directory}: every snapshot failed integrity checks:\n  "
        + "\n  ".join(errors))

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
  a save atomic, and the newest ``keep`` steps are kept.  The port has one
  device, so a leaf is one shard; the reference's restore onto a different
  mesh is ROADMAP A12/A13.

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

    def restore(self, step: int, target: PyTree, shardings: Optional[PyTree] = None
                ) -> PyTree:
        """Restore into the structure of ``target`` (tensors, ``meta``
        tensors included, giving shapes): each leaf lands on its target
        leaf's device (the CPU for ``meta``) with the stored dtype.  Stored
        shards are assembled from their index files, whatever their split.

        ``shardings`` (a restore onto a different mesh) is ROADMAP A12/A13.
        """
        if shardings is not None:
            raise NotImplementedError(
                "Checkpointer.restore(shardings=...): restoring onto a mesh is "
                "not ported yet: ROADMAP A12 (multi-device) and A13 (training)")
        root = os.path.join(self.dir, f"step_{step:08d}")
        with open(os.path.join(root, "manifest.json")) as f:
            manifest = json.load(f)
        leaves, _ = _flatten(target)
        if manifest["n_leaves"] != len(leaves):
            raise ValueError(
                f"checkpoint has {manifest['n_leaves']} leaves, target has "
                f"{len(leaves)} — structure mismatch")
        out = []
        for i, (leaf, meta) in enumerate(zip(leaves, manifest["leaves"])):
            d = os.path.join(root, _leaf_dirname(i))
            shape = tuple(meta["shape"])
            if tuple(leaf.shape) != shape:
                raise ValueError(f"leaf {i}: stored {shape} != target {tuple(leaf.shape)}")
            full = torch.empty(shape, dtype=_torch_dtype(meta["dtype"]))
            j = 0
            while os.path.exists(os.path.join(d, f"shard_{j}.npy")):
                data = _load_leaf(os.path.join(d, f"shard_{j}.npy"), meta["dtype"])
                with open(os.path.join(d, f"shard_{j}.idx.json")) as f:
                    idx = json.load(f)["index"]
                full[tuple(slice(a, b) for a, b in idx)] = data
                j += 1
            dev = getattr(leaf, "device", None)
            if isinstance(dev, torch.device) and dev.type != "meta":
                full = full.to(dev)
            out.append(full)
        return _unflatten(target, out)


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

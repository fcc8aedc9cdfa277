"""Sharding rules: parameter-name patterns -> per-dim mesh-axis specs (the
port of ``src/repro/train/sharding.py``).

A *spec* is the ``PartitionSpec`` analogue: a tuple with one entry per dim
of the leaf, each ``None`` (replicated), a mesh axis name, or a tuple of
axis names (the data-parallel axes of a batch dim).  :func:`placements`
turns a spec into DTensor ``Shard``/``Replicate`` placements for a
``DeviceMesh``.

Rules are name-pattern based, with an explicit divisibility check: a mesh
axis that does not divide the dim is dropped (replicated) and recorded,
never padded.  The rules are the reference's, unchanged.  The port keeps
one leaf per layer (``layers.3.attn.wq``) where the reference stacks a
cycle slot's layers on a leading axis (``groups/c0/attn/wq``); a leaf is
matched with its layer index removed and ``/`` as the separator
(``attn/wq``; ``encoder.blocks.2.mlp.w_in`` as ``encoder/blocks/mlp/w_in``),
and the right-aligned templates then give the reference's specs on the
trailing dims.

:func:`shard_over_data` judges ``min_size`` on the stacked size (the
leaf's numel times the number of layers in its cycle slot), so the same
leaves get the ``data`` axis as in the reference.  Where the reference
puts ``data`` on the stacked axis, the port puts it on the first
replicated trailing dim that ``data`` divides; a leaf with no such dim
stays replicated and is listed as a departure.

A mesh argument is a ``DeviceMesh``, or anything with axis names and sizes
(a JAX ``AbstractMesh``, a ``{name: size}`` dict): the spec functions need
no process group.  The collectives at the end (:func:`gather_full`,
:func:`gather_list`) do, and keep an account of the bytes each rank sends.
"""
from __future__ import annotations

import re
from typing import Any, Dict, List, Mapping, Optional, Sequence, Tuple, Union

import torch

PyTree = Any
Axis = Union[None, str, Tuple[str, ...]]
Spec = Tuple[Axis, ...]

# (regex on the "/"-joined path, spec template applied to the *trailing*
# dims), the reference's list unchanged.  Templates may be shorter than the
# rank: missing leading dims replicate.
PARAM_RULES: List[Tuple[str, Tuple[Optional[str], ...]]] = [
    (r"embed/w$",              ("model", None)),      # vocab-sharded
    (r"lm_head/w$",            ("model", None)),
    (r"attn/wq$",              (None, "model")),      # q heads TP
    (r"attn/wo$",              ("model", None)),
    (r"attn/wk$",              (None, None)),         # GQA KV replicated
    (r"attn/wv$",              (None, None)),
    (r"attn/bq$",              ("model",)),
    (r"attn/b[kv]$",           (None,)),
    (r"xattn/w[qkv]$",         (None, "model")),
    (r"xattn/wo$",             ("model", None)),
    (r"mlp/w_gate$",           (None, "model")),
    (r"mlp/w_up$",             (None, "model")),
    (r"mlp/w_down$",           ("model", None)),
    (r"mlp/w_in$",             (None, "model")),
    (r"mlp/b_in$",             ("model",)),
    (r"mlp/w_out$",            ("model", None)),
    (r"mlp/b_out$",            (None,)),
    (r"mlp/router$",           (None, None)),
    # MoE experts: expert-parallel over `model` (E, D, F).
    (r"mlp/we_(gate|up|down)$", ("model", None, None)),
    # Mamba2
    (r"mixer/in_proj$",        (None, "model")),
    (r"mixer/out_proj$",       ("model", None)),
    (r"mixer/conv_w$",         (None, "model")),
    (r"mixer/conv_b$",         ("model",)),
    # RG-LRU
    (r"mixer/in_x$",           (None, "model")),
    (r"mixer/in_gate$",        (None, "model")),
    (r"mixer/w_[ax]$",         (None, "model")),
    (r"mixer/b_[ax]$",         ("model",)),
    (r"mixer/lam$",            ("model",)),
    (r"mixer/out$",            ("model", None)),
]

_LAYER = re.compile(r"^layers\.(\d+)\.")
_ENCODER = re.compile(r"^encoder\.blocks\.(\d+)\.")


# --------------------------------------------------------------------------- #
# Meshes and leaves.
# --------------------------------------------------------------------------- #
def mesh_axes(mesh: Any) -> Dict[str, int]:
    """``{axis name: size}`` of a ``DeviceMesh``, a JAX mesh or a dict."""
    names = getattr(mesh, "mesh_dim_names", None)
    if names is not None:
        return dict(zip(names, tuple(mesh.mesh.shape)))
    names = getattr(mesh, "axis_names", None)
    if names is not None:
        shape = mesh.shape
        return dict(shape) if isinstance(shape, Mapping) else dict(zip(names, shape))
    if isinstance(mesh, Mapping):
        return {str(k): int(v) for k, v in mesh.items()}
    raise TypeError(f"not a mesh: {type(mesh).__name__} (a DeviceMesh, a JAX mesh "
                    "or a {axis: size} dict)")


def rule_path(name: str) -> str:
    """A port leaf name as the rules see it: the layer index removed, ``/``
    as the separator (``layers.3.attn.wq`` -> ``attn/wq``)."""
    name = _LAYER.sub("", name)
    name = _ENCODER.sub("encoder.blocks.", name)
    return name.replace(".", "/")


def stack_counts(cfg, names: Sequence[str]) -> Dict[str, int]:
    """For each leaf name, the number of layers the reference stacks it
    with: a cycle slot's ``n_groups`` for a grouped layer, the encoder's
    depth for an encoder block, 1 for the rest."""
    from repro_torch.models.lm import layer_plan
    cycle, n_groups, _ = layer_plan(cfg)
    grouped = n_groups * len(cycle)
    out = {}
    for n in names:
        m = _LAYER.match(n)
        e = _ENCODER.match(n)
        if m:
            out[n] = n_groups if int(m.group(1)) < grouped else 1
        elif e:
            out[n] = cfg.encoder.n_layers
        else:
            out[n] = 1
    return out


def _items(tree: PyTree, prefix: str = "") -> List[Tuple[str, Any]]:
    """(dotted name, leaf) of a tree of dicts, lists and tuples."""
    if isinstance(tree, Mapping):
        out = []
        for k, v in tree.items():
            out += _items(v, f"{prefix}{k}.")
        return out
    if isinstance(tree, (list, tuple)):
        out = []
        for i, v in enumerate(tree):
            out += _items(v, f"{prefix}{i}.")
        return out
    return [(prefix[:-1], tree)]


def _map(fn, tree: PyTree, prefix: str = "") -> PyTree:
    """``fn(dotted name, leaf)`` over a tree of dicts, lists and tuples."""
    if isinstance(tree, Mapping):
        return {k: _map(fn, v, f"{prefix}{k}.") for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map(fn, v, f"{prefix}{i}.") for i, v in enumerate(tree))
    return fn(prefix[:-1], tree)


def _map2(fn, specs: PyTree, tree: PyTree, prefix: str = "") -> PyTree:
    """``fn(name, spec, leaf)`` over a spec tree and its leaf tree."""
    if isinstance(tree, Mapping):
        return {k: _map2(fn, specs[k], v, f"{prefix}{k}.") for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map2(fn, s, v, f"{prefix}{i}.")
                          for i, (s, v) in enumerate(zip(specs, tree)))
    return fn(prefix[:-1], specs, tree)


def _prod(xs) -> int:
    n = 1
    for x in xs:
        n *= int(x)
    return n


# --------------------------------------------------------------------------- #
# The rules.
# --------------------------------------------------------------------------- #
def dp_axes(mesh: Any) -> Tuple[str, ...]:
    """Data-parallel axes: (pod, data) when present."""
    axes = mesh_axes(mesh)
    return tuple(a for a in ("pod", "data") if a in axes)


def _apply_template(shape: Tuple[int, ...], template: Sequence[Optional[str]],
                    axes: Dict[str, int], dropped: List[str], path: str) -> Spec:
    spec: List[Axis] = [None] * len(shape)
    off = len(shape) - len(template)
    for i, ax in enumerate(template):
        if ax is None:
            continue
        d = off + i
        if d < 0:
            continue
        if shape[d] % axes[ax] == 0:
            spec[d] = ax
        else:
            dropped.append(f"{path}: dim {d} ({shape[d]}) % {ax} "
                           f"({axes[ax]}) != 0 -> replicated")
    return tuple(spec)


def param_specs(params: PyTree, mesh: Any, verbose: bool = False
                ) -> Tuple[PyTree, List[str]]:
    """A spec tree for a parameter tree (tensors, ``meta`` tensors
    included) and the list of mesh axes dropped for divisibility, in the
    reference's message format with the port's leaf name and dim."""
    axes = mesh_axes(mesh)
    dropped: List[str] = []

    def spec_for(name: str, leaf) -> Spec:
        path = rule_path(name)
        shape = tuple(leaf.shape)
        for pat, tmpl in PARAM_RULES:
            if re.search(pat, path):
                return _apply_template(shape, tmpl, axes, dropped, name)
        return (None,) * len(shape)   # norms, biases, scalars: replicated

    specs = _map(spec_for, params)
    if verbose:
        for d in dropped:
            print(f"[sharding] {d}")
    return specs, dropped


def shard_over_data(specs: PyTree, tree: PyTree, mesh: Any, min_size: int = 2 ** 16,
                    *, cfg=None, departures: Optional[List[str]] = None) -> PyTree:
    """Additionally shard each large-enough leaf over the ``data`` axis on
    the first dim that is still replicated and divisible.

    Applied to the optimizer moments this is ZeRO-1; applied to the params
    it is FSDP.  With ``cfg`` a leaf's size is judged stacked, as the
    reference's stacked leaf (:func:`stack_counts`), and a leaf whose
    stacked axis would take ``data`` in the reference takes it on its first
    replicated divisible dim instead; a leaf with none stays replicated and
    is appended to ``departures``."""
    axes = mesh_axes(mesh)
    if "data" not in axes:
        return specs
    n = axes["data"]
    names = [k for k, _ in _items(tree)]
    stacked = stack_counts(cfg, names) if cfg is not None else {k: 1 for k in names}

    def upgrade(name: str, spec: Spec, leaf) -> Spec:
        shape = tuple(getattr(leaf, "shape", ()))
        if not shape:
            return spec
        k = stacked[name]
        if _prod(shape) * k < min_size:
            return spec   # tiny tensors: all-gather latency > memory win
        parts = list(spec) + [None] * (len(shape) - len(spec))
        for d in range(len(parts)):
            if parts[d] is None and shape[d] % n == 0 and shape[d] >= n:
                parts[d] = "data"
                return tuple(parts)
        if k > 1 and k % n == 0 and k >= n and departures is not None:
            departures.append(f"{name}: the reference shards the stacked axis ({k}) "
                              f"over data ({n}); no replicated dim of {shape} divides "
                              "it -> replicated")
        return spec

    return _map2(upgrade, specs, tree)


def zero1_specs(opt_specs: PyTree, params: PyTree, mesh: Any, *, cfg=None,
                departures: Optional[List[str]] = None) -> PyTree:
    """ZeRO-1: shard optimizer moments over the data axis."""
    return shard_over_data(opt_specs, params, mesh, cfg=cfg, departures=departures)


def batch_specs(batch: PyTree, mesh: Any) -> PyTree:
    """Shard every batch input's leading (batch) dim over the DP axes."""
    axes = mesh_axes(mesh)
    dp = dp_axes(mesh)

    def spec_for(name: str, leaf) -> Spec:
        shape = tuple(leaf.shape)
        rest = (None,) * (len(shape) - 1)
        if dp and shape[0] % _prod(axes[a] for a in dp) == 0:
            return (dp,) + rest
        return (None,) + rest

    return _map(spec_for, batch)


def cache_specs(caches: PyTree, mesh: Any, seq_axes: Tuple[str, ...] = ()) -> PyTree:
    """Serving-state sharding (the port's list of one dict per layer, the
    batch on dim 0 of every leaf): shard the batch dim over the DP axes
    when it divides; otherwise (long_500k: batch 1) shard the longest
    divisible dim (the KV sequence) over ``data``, sequence-parallel.

    ``seq_axes``: also shard the KV sequence dim (dim 1 of a ring cache)
    over these axes."""
    axes = mesh_axes(mesh)
    dp = dp_axes(mesh)
    dp_size = _prod(axes[a] for a in dp)
    data_size = axes["data"]

    def spec_for(name: str, leaf) -> Spec:
        shape = tuple(leaf.shape)
        parts: List[Axis] = [None] * len(shape)
        if len(shape) > 0 and shape[0] % dp_size == 0 and shape[0] > 1:
            parts[0] = dp
            if seq_axes and len(shape) > 2:   # k/v/pos rings only
                size = _prod(axes[a] for a in seq_axes)
                if shape[1] % size == 0 and shape[1] >= 4 * size:
                    parts[1] = seq_axes if len(seq_axes) > 1 else seq_axes[0]
            return tuple(parts)
        for d in sorted(range(1, len(shape)), key=lambda d: -shape[d]):
            if shape[d] % data_size == 0 and shape[d] >= 4 * data_size:
                parts[d] = "data"
                return tuple(parts)
        return tuple(parts)

    return _map(spec_for, caches)


# --------------------------------------------------------------------------- #
# Placements on a DeviceMesh.
# --------------------------------------------------------------------------- #
def _axis_names(entry: Axis) -> Tuple[str, ...]:
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


def placements(spec: Spec, mesh: Any) -> list:
    """DTensor placements (one per mesh dim, in mesh order) of a spec:
    ``Shard(d)`` on the mesh dims that shard dim ``d``, ``Replicate()``
    elsewhere."""
    from torch.distributed.tensor import Replicate, Shard
    names = list(mesh_axes(mesh))
    out: list = [Replicate()] * len(names)
    for d, entry in enumerate(spec):
        for ax in _axis_names(entry):
            out[names.index(ax)] = Shard(d)
    return out


def _is_spec(x: Any) -> bool:
    return isinstance(x, tuple) and all(
        e is None or isinstance(e, str)
        or (isinstance(e, tuple) and all(isinstance(a, str) for a in e)) for e in x)


def map_specs(fn, specs: PyTree) -> PyTree:
    """``fn(spec)`` over a tree of specs (tuples of axis entries are leaves)."""
    if _is_spec(specs):
        return fn(specs)
    if isinstance(specs, Mapping):
        return {k: map_specs(fn, v) for k, v in specs.items()}
    return type(specs)(map_specs(fn, v) for v in specs)


def named(mesh: Any, specs: PyTree) -> PyTree:
    """``(mesh, placements)`` for every spec of a tree."""
    return map_specs(lambda s: (mesh, placements(s, mesh)), specs)


def local_region(shape: Sequence[int], placements_: Sequence, sizes: Sequence[int],
                 coord: Sequence[int]) -> Tuple[slice, ...]:
    """The slices of a global tensor of ``shape`` that the rank at mesh
    coordinate ``coord`` holds under ``placements_`` (mesh dims in order,
    each ``Shard`` splitting its dim evenly; outer mesh dims first)."""
    start = [0] * len(shape)
    size = list(shape)
    for i, p in enumerate(placements_):
        if p.is_shard():
            d = p.dim
            if size[d] % sizes[i]:
                raise ValueError(f"dim {d} of {tuple(shape)} does not split evenly over "
                                 f"mesh dim {i} ({sizes[i]})")
            size[d] //= sizes[i]
            start[d] += coord[i] * size[d]
    return tuple(slice(a, a + n) for a, n in zip(start, size))


def mesh_coordinate(mesh) -> List[int]:
    coord = mesh.get_coordinate()
    if coord is None:
        raise RuntimeError("this rank is not in the mesh")
    return list(coord)


def distribute(full: torch.Tensor, mesh, spec_or_placements) -> Any:
    """A DTensor at ``spec_or_placements`` whose local shard is this rank's
    slice of ``full`` (every rank holds the same ``full``; no collective)."""
    from torch.distributed.tensor import DTensor
    pl = (placements(spec_or_placements, mesh) if _is_spec(spec_or_placements)
          else list(spec_or_placements))
    region = local_region(full.shape, pl, tuple(mesh.mesh.shape), mesh_coordinate(mesh))
    return DTensor.from_local(full[region].contiguous(), mesh, pl, run_check=False)


def constrain(x: Any, mesh, spec: Spec) -> Any:
    """``x`` at ``spec``: a DTensor is redistributed, a plain tensor (the
    same on every rank) is sliced."""
    from torch.distributed.tensor import DTensor
    if isinstance(x, DTensor):
        return x.redistribute(mesh, placements(spec, mesh))
    return distribute(x, mesh, spec)


# --------------------------------------------------------------------------- #
# Collectives with an account of the bytes sent.
# --------------------------------------------------------------------------- #
def _stage(x: torch.Tensor, group) -> torch.Tensor:
    """What a collective is given: gloo takes host tensors (a CUDA tensor is
    staged through host memory) and no bf16 (sent as its bytes)."""
    import torch.distributed as dist
    if x.device.type == "cuda" and dist.get_backend(group) == "gloo":
        x = x.cpu()
    x = x.contiguous()
    if x.dtype == torch.bfloat16:
        x = x.reshape(-1).view(torch.uint8)
    return x


def gather_list(x: torch.Tensor, group, account: Optional[Dict[str, float]] = None,
                kind: str = "all_gather") -> List[torch.Tensor]:
    """Every rank's ``x`` in ``group``, in group-rank order (exact for every
    dtype).  ``account[kind]`` gains the bytes this rank sends in a ring
    all-gather, ``(n - 1) * nbytes``."""
    import torch.distributed as dist
    n = dist.get_world_size(group)
    if account is not None:
        account[kind] = account.get(kind, 0.0) + (n - 1) * x.numel() * x.element_size()
    if n == 1:
        return [x]
    staged = _stage(x, group)
    outs = [torch.empty_like(staged) for _ in range(n)]
    dist.all_gather(outs, staged, group=group)
    if x.dtype == torch.bfloat16:
        outs = [o.view(torch.bfloat16).reshape(x.shape) for o in outs]
    return [o.to(x.device) for o in outs]


def gather_dims(x: torch.Tensor, mesh, dims: Sequence[int], tensor_dims: Sequence[int],
                account: Optional[Dict[str, float]] = None,
                kind: str = "all_gather") -> torch.Tensor:
    """Concatenate ``x`` over the mesh dims ``dims`` (each splitting tensor
    dim ``tensor_dims[i]``), inner mesh dims first, so nested splits of one
    dim come back in order."""
    for i, d in sorted(zip(dims, tensor_dims), reverse=True):
        x = torch.cat(gather_list(x, mesh.get_group(i), account, kind), dim=d)
    return x


def gather_full(x: Any, account: Optional[Dict[str, float]] = None,
                kind: str = "all_gather") -> torch.Tensor:
    """A DTensor's full value on every rank (a plain tensor passes)."""
    from torch.distributed.tensor import DTensor
    if not isinstance(x, DTensor):
        return x
    sh = [(i, p.dim) for i, p in enumerate(x.placements) if p.is_shard()]
    return gather_dims(x.to_local(), x.device_mesh, [i for i, _ in sh],
                       [d for _, d in sh], account, kind)

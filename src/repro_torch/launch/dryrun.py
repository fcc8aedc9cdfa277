"""Multi-pod dry run: build and run every (arch x shape x mesh) cell on
``meta`` tensors, on the host (the port of ``src/repro/launch/dryrun.py``).

A dry run touches no device: one process joins a fake ``torch.distributed``
group of 256 or 512 ranks (:func:`fake_group`), builds the production mesh
on it (``make_production_mesh(device_type="cpu")``) and runs rank 0's step
on ``meta`` tensors at rank 0's local shapes.  For each cell it records:

* ``memory.argument_bytes``: exact, the local bytes of the params,
  optimizer state, batch and caches at their placements;
* ``memory.peak_bytes``: the most bytes of tensor storage alive at once
  during the rank's step, its arguments included (a dispatch mode that
  sees every storage made and frees it with a finalizer; the caching
  allocator's rounding is not counted);
* ``flops_per_device``: the rank's step's FLOPs by
  ``torch.utils.flop_counter``'s table (matmuls, convolutions, attention;
  elementwise work is not counted);
* ``hbm_bytes_per_device``: every aten op's tensor inputs and outputs,
  views excluded (no fusion: an upper bound);
* ``collective_bytes_per_device``: the bytes the rank's step sends, by
  kind, from the step's own account (a ring all-gather sends
  ``(n - 1)`` times the local shard);
* ``model_flops_global``, ``roofline``, ``bottleneck``,
  ``useful_flops_frac`` and ``step_time_bound_s``, as the reference, from
  the NVIDIA H100 80GB HBM3 (SXM, 700 W) data sheet: 989 TFLOP/s bf16
  dense, 3.35 TB/s HBM, NVLink 450 GB/s each way.  These are computed, not
  measured.

The rank's step is the port's: a train cell runs the sharded step
(``make_train_step(..., mesh=)``, ``zero1``, FSDP params), whose every rank
gathers the params and computes its rows' forward and backward whole (ranks
along ``model`` repeat it); prefill and decode cells gather the params (and
a sequence-split cache) and run ``LM.prefill`` / ``LM.decode_step`` on the
rank's rows, with the plain versions of the kernels.  The port has no layer
scan, so the reference's depth probes and attention-scan correction are not
needed: ``--no-probes`` is taken and has no effect.

Usage:
    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch all --shape all \\
        --mesh both --out results/dryrun_torch.json
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import time
import traceback
import weakref
from typing import Any, Dict, Optional

import torch
from torch import nn
from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch.configs import REGISTRY, get_config, input_specs, smoke_config
from repro_torch.configs.base import DECODE_SHAPES, SHAPES, ArchConfig
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.models import LM
from repro_torch.optim import AdamWConfig, abstract_opt_state
from repro_torch.train import sharding as shd
from repro_torch.train.train_step import TrainOptions, make_train_step

# NVIDIA H100 80GB HBM3 (SXM, 700 W), data sheet (roofline; computed).
HARDWARE = "NVIDIA H100 80GB HBM3 (SXM, 700 W), data sheet"
PEAK_FLOPS = 989e12        # bf16 FLOP/s per card, dense
HBM_BW = 3.35e12           # bytes/s per card
LINK_BW = 450e9            # NVLink bytes/s per card, each way


def fake_group(world: int) -> None:
    """Join a fake process group of ``world`` ranks as rank 0 (no peers, no
    device; collectives return at once), leaving any other group first."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore
    if dist.is_initialized():
        if dist.get_world_size() == world and dist.get_backend() == "fake":
            return
        dist.destroy_process_group()
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=world)


def apply_variant(cfg: ArchConfig, variant: str) -> ArchConfig:
    """The reference's hillclimb variants (composable with '+'):
      moe_local16  — per-data-shard MoE dispatch (local_groups=16)
      kv_int8      — int8 ring KV caches
      cf1          — MoE capacity factor 1.0 (was 1.25)
    """
    for v in variant.split("+"):
        if v in ("", "base"):
            continue
        elif v == "moe_local16":
            cfg = dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe, local_groups=16))
        elif v == "kv_int8":
            cfg = dataclasses.replace(cfg, kv_quant_int8=True)
        elif v == "actseq":
            cfg = dataclasses.replace(cfg, act_seq_shard=True)
        elif v == "cf1":
            cfg = dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe, capacity_factor=1.0))
        elif v in ("seqshard", "mb4", "mb8", "noremat", "f32grads"):
            pass  # handled in build_cell
        else:
            raise ValueError(f"unknown variant {v}")
    return cfg


class _Call(nn.Module):
    """An ``LM`` method as a module's forward, for ``functional_call``."""

    def __init__(self, lm: LM, method: str):
        super().__init__()
        self.lm = lm
        self.method = method

    def forward(self, *args, **kwargs):
        return getattr(self.lm, self.method)(*args, **kwargs)


def _placed(meta: torch.Tensor, spec, mesh) -> Any:
    """A DTensor at ``spec`` whose local shard is a ``meta`` tensor of rank
    0's local shape."""
    from torch.distributed.tensor import DTensor
    pl = shd.placements(spec, mesh)
    region = shd.local_region(meta.shape, pl, tuple(mesh.mesh.shape),
                              shd.mesh_coordinate(mesh))
    local = torch.empty(tuple(r.stop - r.start for r in region), dtype=meta.dtype,
                        device="meta")
    return DTensor.from_local(local, mesh, pl, run_check=False)


def _place_tree(tree, specs, mesh):
    if isinstance(tree, dict):
        return {k: _place_tree(v, specs[k], mesh) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_place_tree(v, s, mesh) for v, s in zip(tree, specs))
    return _placed(tree, specs, mesh)


def _local_leaves(tree) -> list:
    from torch.distributed.tensor import DTensor
    return [x.to_local() if isinstance(x, DTensor) else x for _, x in shd._items(tree)]


def build_cell(cfg: ArchConfig, shape_name: str, mesh, opts: Optional[TrainOptions] = None,
               variant: str = "base"):
    """Returns ``(fn, args, specs, dropped, account)``: ``fn(*args)`` runs
    rank 0's step on ``args`` (DTensors on ``meta`` at ``specs``), and
    ``account`` collects the bytes its collectives send."""
    from torch.distributed.tensor import DTensor
    cfg = apply_variant(cfg, variant)
    vset = set(variant.split("+"))
    seq, batch = SHAPES[shape_name]
    lm = LM(cfg, device="meta", seed=None)
    params_abs = dict(lm.state_dict())
    p_specs, dropped = shd.param_specs(params_abs, mesh)
    data = input_specs(cfg, shape_name)
    b_specs = shd.batch_specs(data, mesh)
    account: Dict[str, float] = {}

    if shape_name == "train_4k":
        opts = opts or TrainOptions(
            microbatches=4 if "mb4" in vset else 8 if "mb8" in vset else 1,
            remat="noremat" not in vset,
            grad_dtype="f32" if "f32grads" in vset else "bf16", zero1=True)
        p_train = shd.shard_over_data(p_specs, params_abs, mesh, cfg=cfg)
        o_specs = {"m": shd.shard_over_data(p_specs, params_abs, mesh, cfg=cfg),
                   "v": shd.shard_over_data(p_specs, params_abs, mesh, cfg=cfg), "count": ()}
        step = make_train_step(cfg, AdamWConfig(total_steps=10000), opts, mesh=mesh)
        args = (_place_tree(params_abs, p_train, mesh),
                _place_tree(abstract_opt_state(params_abs), o_specs, mesh),
                _place_tree(data, b_specs, mesh))

        def fn(p, o, b):
            # The ids arrive as the reference's int32; the loss takes int64.
            b = {k: DTensor.from_local(v.to_local().long(), mesh, v.placements, run_check=False)
                 if k in ("tokens", "labels") else v for k, v in b.items()}
            out = step(p, o, b)
            account.update(step.stats["bytes_sent"])
            return out
        return fn, args, (p_train, o_specs, b_specs), dropped, account

    def gathered(tree):
        return {k: shd.gather_full(v, account, "all_gather_params") for k, v in tree.items()}

    def rows(tree):
        return {k: v.to_local() for k, v in tree.items()}

    if shape_name == "prefill_32k":
        call = _Call(lm, "prefill")

        def fn(p, bt):
            full = {f"lm.{k}": v for k, v in gathered(p).items()}
            loc = rows(bt)
            extra = {k: v for k, v in loc.items() if k != "tokens"}
            return torch.func.functional_call(call, full, (loc["tokens"].long(),),
                                              dict(max_cache_len=seq, kernel_impl="xla",
                                                   **extra))
        return (fn, (_place_tree(params_abs, p_specs, mesh), _place_tree(data, b_specs, mesh)),
                (p_specs, b_specs), dropped, account)

    caches = lm.serve_state(batch, seq, device="meta")
    c_specs = shd.cache_specs(caches, mesh, seq_axes=("model",) if "seqshard" in vset else ())
    call = _Call(lm, "decode_step")
    io = {"tokens": data["tokens"], "pos": data["pos"]}
    io_specs = shd.batch_specs(io, mesh)

    def fn(p, tokens, pos, cs):
        full = {f"lm.{k}": v for k, v in gathered(p).items()}
        local = shd._map(lambda _, x: shd.gather_full(x, account, "all_gather_cache")
                         if _seq_split(x) else x.to_local(), cs)
        return torch.func.functional_call(call, full, (tokens.to_local().long(),
                                                       pos.to_local().long(), local))
    args = (_place_tree(params_abs, p_specs, mesh), _placed(io["tokens"], io_specs["tokens"], mesh),
            _placed(io["pos"], io_specs["pos"], mesh), _place_tree(caches, c_specs, mesh))
    return fn, args, (p_specs, io_specs["tokens"], io_specs["pos"], c_specs), dropped, account


def _seq_split(x) -> bool:
    """A cache leaf split on a dim other than the batch's (sequence
    parallel): the port's decode step reads it whole."""
    return any(p.is_shard() and p.dim != 0 for p in x.placements)


class _Count(TorchDispatchMode):
    """Over every aten op: its FLOPs (``torch.utils.flop_counter``'s table:
    matmuls, convolutions, attention), the bytes of its tensor inputs and
    outputs (views excluded), and the most bytes of tensor storage alive at
    once (every output's storage counted from its creation until a
    finalizer sees it freed; ``tensors`` alive from the start)."""

    def __init__(self, tensors):
        super().__init__()
        from torch.utils.flop_counter import flop_registry
        self.registry = flop_registry
        self.flops = 0
        self.bytes = 0
        self.sizes: Dict[int, int] = {}
        self.live = self.peak = 0
        for t in tensors:
            self._track(t)

    def _free(self, key: int) -> None:
        self.live -= self.sizes.pop(key)

    def _track(self, t: torch.Tensor) -> None:
        st = t.untyped_storage()
        key = id(st)
        if key in self.sizes:
            return
        self.sizes[key] = st.nbytes()
        self.live += self.sizes[key]
        self.peak = max(self.peak, self.live)
        weakref.finalize(st, self._free, key)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if func.overloadpacket not in self.registry:
            # A composite op (matmul, einsum under inference mode) is seen
            # whole: count the ops it decomposes into.
            with self:
                r = func.decompose(*args, **kwargs)
            if r is not NotImplemented:
                return r
        out = func(*args, **kwargs)
        if func.overloadpacket in self.registry:
            self.flops += self.registry[func.overloadpacket](*args, **kwargs, out_val=out)
        outs = [x for x in torch.utils._pytree.tree_leaves(out) if isinstance(x, torch.Tensor)]
        if not func.is_view:
            for x in torch.utils._pytree.tree_leaves((args, kwargs)) + outs:
                if isinstance(x, torch.Tensor):
                    self.bytes += x.numel() * x.element_size()
        for x in outs:
            self._track(x)
        return out


def _measure(fn, args) -> Dict[str, Any]:
    local = _local_leaves(args)
    with _Count(local) as c:
        fn(*args)
    return {"argument_bytes": sum(x.numel() * x.element_size() for x in local),
            "peak_bytes": c.peak, "flops": float(c.flops), "bytes": float(c.bytes)}


def run_cell(arch: str, shape_name: str, multi_pod: bool, probes: bool = True,
             variant: str = "base", smoke: bool = False) -> Dict[str, Any]:
    """One cell's record (``smoke``: the arch's smoke config, same shapes).
    ``probes`` is taken and has no effect (no layer scan to probe)."""
    cfg = smoke_config(arch) if smoke else get_config(arch)
    rec: Dict[str, Any] = {
        "arch": arch, "shape": shape_name,
        "mesh": "2x16x16" if multi_pod else "16x16",
        "variant": variant,
        "device": "none: a host dry run on meta tensors in a fake process group",
    }
    if smoke:
        rec["config"] = "smoke"
    if shape_name in cfg.skip_shapes:
        rec["status"] = "skipped"
        rec["reason"] = cfg.notes
        return rec
    t0 = time.time()
    try:
        n_chips = 512 if multi_pod else 256
        fake_group(n_chips)
        mesh = make_production_mesh(multi_pod=multi_pod, device_type="cpu")
        fn, args, specs, dropped, account = build_cell(cfg, shape_name, mesh, variant=variant)
        departures: list = []
        if shape_name == "train_4k":
            params_abs = LM(apply_variant(cfg, variant), device="meta", seed=None).state_dict()
            shd.shard_over_data(shd.param_specs(params_abs, mesh)[0], params_abs, mesh,
                                cfg=cfg, departures=departures)
        m = _measure(fn, args)
        coll = {k: float(v) for k, v in account.items()}
        coll["total"] = float(sum(account.values()))
        seq, batch = SHAPES[shape_name]
        n_param = cfg.param_count()
        n_active = cfg.active_param_count()
        d_tokens = batch * (1 if shape_name in DECODE_SHAPES else seq)
        mult = 6 if shape_name == "train_4k" else 2
        model_flops = mult * n_active * d_tokens
        flops_pd = m["flops"]
        rec.update({
            "status": "ok",
            "n_chips": n_chips,
            "compile_s": round(time.time() - t0, 1),
            "dropped_shardings": dropped,
            "departures": departures,
            "memory": {"argument_bytes": m["argument_bytes"], "output_bytes": None,
                       "temp_bytes": None, "peak_bytes": m["peak_bytes"]},
            "flops_per_device": flops_pd,
            "hbm_bytes_per_device": m["bytes"],
            "collective_bytes_per_device": coll,
            "model_flops_global": model_flops,
            "params": n_param,
            "active_params": n_active,
            "hardware": HARDWARE,
            "roofline": {
                "compute_s": flops_pd / PEAK_FLOPS,
                "memory_s": m["bytes"] / HBM_BW,
                "collective_s": coll["total"] / LINK_BW,
            },
        })
        terms = rec["roofline"]
        rec["bottleneck"] = max(terms, key=terms.get)
        rec["useful_flops_frac"] = (model_flops / (flops_pd * n_chips) if flops_pd else None)
        rec["step_time_bound_s"] = max(terms.values())
    except Exception as e:  # noqa: BLE001
        rec["status"] = "error"
        rec["error"] = f"{type(e).__name__}: {e}"
        rec["traceback"] = traceback.format_exc()[-2000:]
    return rec


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="all")
    ap.add_argument("--shape", default="all")
    ap.add_argument("--mesh", default="both", choices=["single", "multi", "both"])
    ap.add_argument("--no-probes", action="store_true",
                    help="taken and without effect: the port has no layer scan to probe")
    ap.add_argument("--smoke", action="store_true",
                    help="each arch's smoke config at the same shapes")
    ap.add_argument("--out", default="results/dryrun_torch.json")
    args = ap.parse_args(argv)

    archs = list(REGISTRY) if args.arch == "all" else args.arch.split(",")
    shapes = list(SHAPES) if args.shape == "all" else args.shape.split(",")
    meshes = {"single": [False], "multi": [True], "both": [False, True]}[args.mesh]

    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    results = []
    if os.path.exists(args.out):
        with open(args.out) as f:
            results = json.load(f)
    # Retry errored cells on resume; keep ok/skipped.
    results = [r for r in results if r["status"] != "error"]
    done = {(r["arch"], r["shape"], r["mesh"]) for r in results}
    print("[dryrun] a host dry run: meta tensors in a fake process group, no device",
          flush=True)
    for arch in archs:
        for shape in shapes:
            for mp in meshes:
                key = (arch, shape, "2x16x16" if mp else "16x16")
                if key in done:
                    continue
                print(f"[dryrun] {key} ...", flush=True)
                rec = run_cell(arch, shape, mp, probes=not args.no_probes, smoke=args.smoke)
                results.append(rec)
                with open(args.out, "w") as f:
                    json.dump(results, f, indent=1)
                status = rec["status"]
                extra = (f" bottleneck={rec.get('bottleneck')} build={rec.get('compile_s')}s"
                         if status == "ok" else f" {rec.get('error', '')[:160]}")
                print(f"[dryrun] {key} -> {status}{extra}", flush=True)

    n_ok = sum(r["status"] == "ok" for r in results)
    n_skip = sum(r["status"] == "skipped" for r in results)
    n_err = sum(r["status"] == "error" for r in results)
    print(f"[dryrun] done: {n_ok} ok, {n_skip} skipped, {n_err} errors")
    return 0 if n_err == 0 else 1


if __name__ == "__main__":
    raise SystemExit(main())

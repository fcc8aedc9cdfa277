"""Training launcher: ``--arch <id>``, on the CUDA card unless ``--device
cpu`` is given, on one device or over a mesh.

    PYTHONPATH=src python -m repro_torch.launch.train --arch granite-8b --smoke --device cpu --steps 20
    PYTHONPATH=src torchrun --nproc-per-node 4 -m repro_torch.launch.train --arch granite-8b \\
        --smoke --device cpu --zero1 --mesh 2x2

Weights are drawn from a seeded generator (seed 0), the data is
``SyntheticLM`` (seed 0), and the run checkpoints every 25 steps and at
its end into ``--ckpt-dir`` (a run finds the newest checkpoint there and
goes on from it).  Under ``torchrun`` (a ``torch.distributed`` group
exists or its environment names one) the run is sharded: a ``--mesh
DATAxMODEL`` mesh (default ``WORLDx1``) over a gloo group, the sharded
step (``make_train_step(..., mesh=)``), each batch placed by
``batch_specs`` and a resume through ``restore(shardings=)``.  ``--zero1``
shards the AdamW moments over ``data``.
"""
from __future__ import annotations

import argparse
import os
import tempfile

from repro_torch.configs import get_config, smoke_config
from repro_torch.data import DataConfig, SyntheticLM
from repro_torch.device import resolve_device
from repro_torch.optim import AdamWConfig, init_opt_state
from repro_torch.train import (Trainer, TrainerConfig, TrainOptions, init_params,
                               make_train_step, shard_batch, shard_train_state,
                               train_shardings)


def _group() -> int:
    """The world size of the process group, joining the one ``torchrun``
    describes; 0 when the run is not distributed."""
    import torch.distributed as dist
    if not dist.is_available():
        return 0
    if not dist.is_initialized():
        if "WORLD_SIZE" not in os.environ:
            return 0
        dist.init_process_group("gloo")
    return dist.get_world_size()


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true", help="the reduced CPU-size config")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--ckpt-dir",
                    default=os.path.join(tempfile.gettempdir(), "repro_torch_launch_train"))
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--zero1", action="store_true",
                    help="shard the optimizer moments over the data axis")
    ap.add_argument("--mesh", default=None,
                    help="DATAxMODEL (default WORLDx1); needs a process group (torchrun)")
    ap.add_argument("--device", default=None, help="default: the CUDA card")
    args = ap.parse_args(argv)

    cfg = smoke_config(args.arch) if args.smoke else get_config(args.arch)
    dev = resolve_device(args.device)
    world = _group()
    if args.mesh is not None:
        shape = tuple(int(n) for n in args.mesh.lower().split("x"))
    else:
        shape = (max(world, 1), 1)
    opts = TrainOptions(microbatches=args.microbatches, zero1=args.zero1)
    opt_cfg = AdamWConfig(lr=1e-3, warmup_steps=10, total_steps=args.steps)
    print(f"mesh: {{'data': {shape[0]}, 'model': {shape[1]}}}  device: {dev}  "
          f"arch: {cfg.name} ({cfg.param_count()/1e6:.1f}M params)")
    data = SyntheticLM(DataConfig(vocab=cfg.vocab, seq_len=args.seq, global_batch=args.batch))
    tcfg = TrainerConfig(total_steps=args.steps, checkpoint_every=25,
                         checkpoint_dir=args.ckpt_dir, log_every=10)

    if not world:
        if shape != (1, 1):
            raise RuntimeError(f"--mesh {args.mesh} needs a process group of "
                               f"{shape[0] * shape[1]} ranks: start the run with torchrun")
        step = make_train_step(cfg, opt_cfg, opts)

        def init_state():
            p = init_params(cfg, device=dev, seed=0)
            return {"params": p, "opt": init_opt_state(p)}

        trainer = Trainer(tcfg, step, data, init_state)
    else:
        from repro_torch.launch.mesh import make_test_mesh
        mesh = make_test_mesh(shape, device_type=dev.type)
        skeleton = init_params(cfg, device="meta", seed=None)
        specs, dropped = train_shardings(cfg, mesh, skeleton, init_opt_state(skeleton),
                                         data.batch(0), opts)
        for d in dropped:
            print(f"[sharding] {d}")
        step = make_train_step(cfg, opt_cfg, opts, mesh=mesh)

        def init_state():
            p = init_params(cfg, device=dev, seed=0)
            p, o = shard_train_state(p, init_opt_state(p), specs, mesh)
            return {"params": p, "opt": o}

        trainer = Trainer(tcfg, step, data, init_state,
                          to_device=lambda b: shard_batch(b, mesh, dev),
                          shardings={"params": specs[0], "opt": specs[1]}, mesh=mesh)
    trainer.run()
    h = trainer.metrics_history
    print(f"done: loss {h[0]['loss']:.3f} -> {h[-1]['loss']:.3f}" if h
          else f"done: step {args.steps} (no step logged)")


if __name__ == "__main__":
    main()

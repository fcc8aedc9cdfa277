"""Training launcher on one device: ``--arch <id>``, on the CUDA card
unless ``--device cpu`` is given.

    PYTHONPATH=src python -m repro_torch.launch.train --arch granite-8b --smoke --device cpu --steps 20

Weights are drawn from a seeded generator (seed 0), the data is
``SyntheticLM`` (seed 0), and the run checkpoints every 25 steps into
``--ckpt-dir`` (a run finds the newest checkpoint there and goes on from
it).  ``--zero1`` needs a mesh and is refused (ROADMAP A13b).
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
                               make_train_step)


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
                    help="refused: the sharded train step is ROADMAP A13b")
    ap.add_argument("--device", default=None, help="default: the CUDA card")
    args = ap.parse_args(argv)

    cfg = smoke_config(args.arch) if args.smoke else get_config(args.arch)
    dev = resolve_device(args.device)
    opts = TrainOptions(microbatches=args.microbatches, zero1=args.zero1)
    opt_cfg = AdamWConfig(lr=1e-3, warmup_steps=10, total_steps=args.steps)
    step = make_train_step(cfg, opt_cfg, opts)
    print(f"device: {dev}  arch: {cfg.name} ({cfg.param_count()/1e6:.1f}M params)")

    def init_state():
        p = init_params(cfg, device=dev, seed=0)
        return {"params": p, "opt": init_opt_state(p)}

    data = SyntheticLM(DataConfig(vocab=cfg.vocab, seq_len=args.seq, global_batch=args.batch))
    trainer = Trainer(TrainerConfig(total_steps=args.steps, checkpoint_every=25,
                                    checkpoint_dir=args.ckpt_dir, log_every=10),
                      step, data, init_state)
    trainer.run()
    h = trainer.metrics_history
    print(f"done: loss {h[0]['loss']:.3f} -> {h[-1]['loss']:.3f}")


if __name__ == "__main__":
    main()

"""Serving launcher: batched greedy generation with ``--arch <id>``, on the
CUDA card unless ``--device cpu`` is given.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch recurrentgemma-2b
    PYTHONPATH=src python -m repro_torch.launch.serve --arch mamba2-780m --smoke --device cpu
    PYTHONPATH=src python -m repro_torch.launch.serve --arch olmoe-1b-7b

Weights are drawn from a seeded generator (``--seed``); prompts are random
token ids from ``numpy.random.default_rng(0)``.  ``--arch internvl2-1b``
serves the vision model as text, as the JAX package's engine does; an
audio arch (whisper-small) is refused by the engine, which feeds tokens
only: it serves through ``LM.prefill(tokens, frames=...)`` and
``LM.decode_step``.
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch.configs import get_config, smoke_config
from repro_torch.models import LM
from repro_torch.serve import Engine, Request, ServeConfig


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true", help="the reduced CPU-size config")
    ap.add_argument("--device", default=None, help="default: the CUDA card")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--max-prompt", type=int, default=32)
    ap.add_argument("--batch-size", type=int, default=4)
    args = ap.parse_args(argv)

    cfg = smoke_config(args.arch) if args.smoke else get_config(args.arch)
    model = LM(cfg, device=args.device, seed=args.seed)
    engine = Engine(cfg, model, ServeConfig(batch_size=args.batch_size,
                                            max_prompt=args.max_prompt,
                                            max_new=args.max_new))
    rng = np.random.default_rng(0)
    reqs = [Request(rng.integers(0, cfg.vocab, rng.integers(3, args.max_prompt))
                    .astype(np.int32), args.max_new)
            for _ in range(args.requests)]
    t0 = time.perf_counter()
    results = engine.generate(reqs)
    if model.device.type == "cuda":
        torch.cuda.synchronize(model.device)
    dt = time.perf_counter() - t0
    n = sum(len(r.tokens) for r in results)
    print(f"{cfg.name} on {model.device}: {len(reqs)} requests -> {n} tokens in {dt:.2f}s")


if __name__ == "__main__":
    main()

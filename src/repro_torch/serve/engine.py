"""Batched serving engine: prefill, then greedy decode, over request
batches (the JAX package's ``serve/engine.py``).

Requests are grouped into batches of ``batch_size``; prompts are
left-padded with token 0 to ``max_prompt`` (the padding is attended to:
there is no padding mask, as in the reference).  Each batch runs one
prefill and up to ``max_new - 1`` decode steps, under
``torch.inference_mode``.

The engine feeds tokens only, as the reference's does: it serves the
vision family as a text model (no ``vision_embeds``), and refuses the
audio family, whose prefill needs the encoder's ``frames``; whisper serves
through ``LM.prefill(tokens, frames=...)`` and ``LM.decode_step``.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional

import numpy as np
import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.models.lm import LM


@dataclasses.dataclass
class ServeConfig:
    batch_size: int = 8
    max_prompt: int = 64
    max_new: int = 32
    eos_id: Optional[int] = None
    # Stop the decode loop as soon as every slot in the batch is done
    # (emitted EOS or exhausted its budget).  Tokens past a slot's first
    # EOS or budget are discarded anyway, so outputs are identical; only
    # the step count drops.
    early_stop: bool = True


@dataclasses.dataclass
class Request:
    prompt: np.ndarray          # (prompt_len,) int32
    max_new: int


@dataclasses.dataclass
class Result:
    tokens: np.ndarray          # generated ids
    prompt_len: int
    # Retirement status: "ok" | "timeout" | "shed" | "fault".  The
    # fixed-batch engine always finishes its requests; only the actor
    # engine's deadlines, shedding and quarantine set another value.
    status: str = "ok"


class Engine:
    def __init__(self, cfg: ArchConfig, model: LM, scfg: ServeConfig):
        if cfg.family == "audio":
            raise ValueError(
                f"Engine: {cfg.name} is an audio model and the engine feeds tokens "
                "only; serve it through LM.prefill(tokens, frames=...) and "
                "LM.decode_step")
        self.cfg = cfg
        self.model = model
        self.scfg = scfg
        #: decode_step calls of the last batch (below max_new - 1 when the
        #: early stop ends a batch whose slots all finished).
        self.last_decode_steps = 0

    def _pad_batch(self, reqs: List[Request]) -> torch.Tensor:
        B, P = self.scfg.batch_size, self.scfg.max_prompt
        toks = np.zeros((B, P), np.int64)
        for i, r in enumerate(reqs):
            p = r.prompt[-P:]
            toks[i, P - len(p):] = p      # left-pad: prompts end together
        return torch.from_numpy(toks).to(self.model.device)

    def generate(self, requests: List[Request]) -> List[Result]:
        out: List[Result] = []
        B = self.scfg.batch_size
        for lo in range(0, len(requests), B):
            group = requests[lo:lo + B]
            pad = group + [Request(np.zeros(1, np.int32), 0)] * (B - len(group))
            out.extend(self._generate_batch(pad)[:len(group)])
        return out

    @torch.inference_mode()
    def _generate_batch(self, reqs: List[Request]) -> List[Result]:
        scfg, model = self.scfg, self.model
        logits, caches = model.prefill(self._pad_batch(reqs),
                                       max_cache_len=scfg.max_prompt + scfg.max_new)
        next_tok = torch.argmax(logits, dim=-1)[:, None]
        pos = torch.full((scfg.batch_size,), scfg.max_prompt, dtype=torch.int64,
                         device=model.device)
        produced = [next_tok]
        # Host-side done tracking for the early stop: a slot is done once it
        # has emitted EOS or produced its budget.
        budgets = np.array([min(max(r.max_new, 0), scfg.max_new) for r in reqs], np.int64)
        seen_eos = np.zeros(scfg.batch_size, bool)
        if scfg.eos_id is not None:
            seen_eos |= next_tok[:, 0].cpu().numpy() == scfg.eos_id
        self.last_decode_steps = 0
        for _ in range(scfg.max_new - 1):
            if scfg.early_stop and bool((seen_eos | (len(produced) >= budgets)).all()):
                break
            logits, caches = model.decode_step(next_tok, pos, caches)
            next_tok = torch.argmax(logits, dim=-1)[:, None]
            pos = pos + 1
            produced.append(next_tok)
            self.last_decode_steps += 1
            if scfg.eos_id is not None:
                seen_eos |= next_tok[:, 0].cpu().numpy() == scfg.eos_id
        gen = torch.cat(produced, dim=1).cpu().numpy().astype(np.int32)
        if gen.shape[1] < scfg.max_new:   # early stop: pad the dead tail
            gen = np.concatenate(
                [gen, np.zeros((scfg.batch_size, scfg.max_new - gen.shape[1]), np.int32)],
                axis=1)
        results = []
        for i, r in enumerate(reqs):
            toks = gen[i][:r.max_new]
            if scfg.eos_id is not None:
                stop = np.where(toks == scfg.eos_id)[0]
                if len(stop):
                    toks = toks[:stop[0] + 1]
            results.append(Result(tokens=toks, prompt_len=len(r.prompt)))
        return results

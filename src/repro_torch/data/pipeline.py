"""Deterministic, index-seeded token data pipeline: the port's own copy of
the JAX package's ``data/pipeline.py`` (numpy only), which gives the same
batches bit for bit.

Restart discipline (fault tolerance): the pipeline is **stateless** — batch
``i`` is a pure function of ``(seed, i)`` — so a trainer restored from a
step-``k`` checkpoint replays batch ``k`` exactly, with no iterator state
to checkpoint.  Sources:

  * ``SyntheticLM``   — a fixed-seed Markov-ish token stream (benchmarks,
    smoke tests, the 100M example run);
  * ``FileTokens``    — memory-mapped token file (one uint32 stream),
    sharded per host: host h of H reads only its slice (the multi-host
    ingestion path; one host here).

Each batch is {"tokens": (B, S) i32, "labels": (B, S) i32} with labels =
next token.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Iterator, Optional

import numpy as np


@dataclasses.dataclass(frozen=True)
class DataConfig:
    vocab: int
    seq_len: int
    global_batch: int
    seed: int = 0
    host_id: int = 0
    n_hosts: int = 1
    path: Optional[str] = None    # None -> synthetic


class SyntheticLM:
    """Deterministic pseudo-text: tokens follow a power-law unigram with a
    position-mixed hash — structured enough that a model visibly learns."""

    def __init__(self, cfg: DataConfig):
        self.cfg = cfg
        rng = np.random.default_rng(cfg.seed)
        # Fixed power-law unigram distribution.
        ranks = np.arange(1, cfg.vocab + 1, dtype=np.float64)
        self.probs = (1.0 / ranks) / np.sum(1.0 / ranks)
        self.mix = rng.integers(1, cfg.vocab, 8)

    def batch(self, index: int) -> Dict[str, np.ndarray]:
        cfg = self.cfg
        per_host = cfg.global_batch // cfg.n_hosts
        rng = np.random.default_rng(
            (cfg.seed, index, cfg.host_id))          # pure fn of (seed, i, host)
        toks = rng.choice(cfg.vocab, size=(per_host, cfg.seq_len + 1),
                          p=self.probs).astype(np.int64)
        # Inject learnable bigram structure: every odd position repeats a
        # hash of its predecessor.
        h = (toks[:, :-1] * int(self.mix[0]) + int(self.mix[1])) % cfg.vocab
        odd = np.arange(1, cfg.seq_len + 1, 2)
        toks[:, odd] = h[:, odd - 1]
        return {"tokens": toks[:, :-1].astype(np.int32),
                "labels": toks[:, 1:].astype(np.int32)}

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        i = 0
        while True:
            yield self.batch(i)
            i += 1


class FileTokens:
    """Memory-mapped uint32 token stream, deterministic strided batching."""

    def __init__(self, cfg: DataConfig):
        if cfg.path is None:
            raise ValueError("FileTokens needs a path")
        self.cfg = cfg
        self.data = np.memmap(cfg.path, dtype=np.uint32, mode="r")
        self.n_windows = (len(self.data) - 1) // cfg.seq_len

    def batch(self, index: int) -> Dict[str, np.ndarray]:
        cfg = self.cfg
        per_host = cfg.global_batch // cfg.n_hosts
        rng = np.random.default_rng((cfg.seed, index))
        win = rng.permutation(self.n_windows)[:cfg.global_batch]
        win = win[cfg.host_id * per_host:(cfg.host_id + 1) * per_host]
        toks = np.stack([
            self.data[w * cfg.seq_len:w * cfg.seq_len + cfg.seq_len + 1]
            for w in win]).astype(np.int64)
        return {"tokens": toks[:, :-1].astype(np.int32),
                "labels": toks[:, 1:].astype(np.int32)}


def make_source(cfg: DataConfig):
    return FileTokens(cfg) if cfg.path else SyntheticLM(cfg)

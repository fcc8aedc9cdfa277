"""Fault-tolerant training loop: checkpoint and restart, straggler
monitoring (the port of ``src/repro/train/trainer.py``, on the port's
``Checkpointer``).

A step may raise (a device fault, a preemption).  The trainer catches it,
restores the last committed checkpoint, and goes on from the restored
step with the stateless, index-seeded data source, replaying the same
batches.  Tests inject failures through ``failure_hook``.

Per-step wall times feed an online z-score monitor; a step (or, across
hosts, a host) whose time is a ``zmax`` outlier is flagged.
"""
from __future__ import annotations

import collections
import dataclasses
import os
import tempfile
import time
from typing import Any, Callable, Dict, List, Optional

import numpy as np
import torch

from repro_torch.checkpoint import Checkpointer

PyTree = Any


class StragglerMonitor:
    """Online per-host step-time tracker with z-score flagging."""

    def __init__(self, n_hosts: int = 1, window: int = 20, zmax: float = 3.0):
        self.n_hosts = n_hosts
        self.window = window
        self.zmax = zmax
        self.times: List[collections.deque] = [
            collections.deque(maxlen=window) for _ in range(n_hosts)]
        self.flagged: List[int] = []

    def record(self, host: int, dt: float) -> None:
        self.times[host].append(dt)

    def check(self) -> List[int]:
        """Hosts whose mean step time is a zmax outlier against the other
        hosts (leave-one-out, so a straggler does not dilute its own
        baseline); with one host, the last step against its history."""
        means = np.array([np.mean(t) if t else 0.0 for t in self.times])
        if self.n_hosts < 2 or np.all(means == 0):
            t = list(self.times[0])
            if len(t) >= 3:
                hist = np.array(t[:-1])
                mu, sd = hist.mean(), hist.std() + 1e-6 * max(hist.mean(), 1e-9)
                if t[-1] > mu + self.zmax * max(sd, 0.05 * mu):
                    self.flagged.append(0)
                    return [0]
            return []
        out = []
        for h, m in enumerate(means):
            others = np.delete(means, h)
            mu, sd = others.mean(), others.std()
            if m > mu + self.zmax * max(sd, 0.05 * mu, 1e-9):
                out.append(h)
        self.flagged.extend(out)
        return out


@dataclasses.dataclass
class TrainerConfig:
    total_steps: int = 100
    checkpoint_every: int = 20
    checkpoint_dir: str = os.path.join(tempfile.gettempdir(), "repro_torch_ckpt")
    keep: int = 3
    max_restarts: int = 3
    log_every: int = 10


def _first_tensor(tree: PyTree) -> torch.Tensor:
    return tree if isinstance(tree, torch.Tensor) else _first_tensor(next(iter(tree.values())))


class Trainer:
    def __init__(self, cfg: TrainerConfig, step_fn, data_source,
                 init_state_fn: Callable[[], Dict[str, PyTree]],
                 failure_hook: Optional[Callable[[int], None]] = None,
                 to_device: Optional[Callable[[Dict], Dict]] = None,
                 log: Callable[[str], None] = print,
                 shardings: Optional[PyTree] = None, mesh: Any = None):
        """``step_fn(params, opt_state, batch) -> (params, opt_state,
        metrics)``; ``init_state_fn() -> {"params", "opt"}``;
        ``failure_hook(step)`` may raise to simulate a failure.
        ``to_device`` turns a numpy batch into the step's; by default each
        array becomes an int64 tensor (float arrays keep their type) on the
        params' device.  ``shardings`` (and ``mesh``), a sharded run's
        placements of ``{"params", "opt"}``, are passed to
        ``Checkpointer.restore`` when the run resumes."""
        self.cfg = cfg
        self.step_fn = step_fn
        self.data = data_source
        self.init_state_fn = init_state_fn
        self.failure_hook = failure_hook
        self.to_device = to_device
        self.log = log
        self.shardings = shardings
        self.mesh = mesh
        self.ckpt = Checkpointer(cfg.checkpoint_dir, keep=cfg.keep)
        self.monitor = StragglerMonitor()
        self.restarts = 0
        self.metrics_history: List[Dict[str, float]] = []

    def _restore_or_init(self):
        latest = self.ckpt.latest_step()
        if latest is None:
            state = self.init_state_fn()
            return 0, state["params"], state["opt"]
        self.log(f"[trainer] restoring step {latest}")
        template = self.init_state_fn()
        tree = {"params": template["params"], "opt": template["opt"]}
        restored = self.ckpt.restore(latest, tree, shardings=self.shardings, mesh=self.mesh)
        return latest, restored["params"], restored["opt"]

    def _batch(self, step: int, device: torch.device) -> Dict:
        batch = self.data.batch(step)
        if self.to_device is not None:
            return self.to_device(batch)
        return {k: torch.from_numpy(np.asarray(v, np.int64) if v.dtype.kind in "iu"
                                    else np.asarray(v)).to(device)
                for k, v in batch.items()}

    def run(self):
        step, params, opt_state = self._restore_or_init()
        while step < self.cfg.total_steps:
            try:
                dev = _first_tensor(params).device
                batch = self._batch(step, dev)
                t0 = time.perf_counter()
                if self.failure_hook is not None:
                    self.failure_hook(step)
                params, opt_state, metrics = self.step_fn(params, opt_state, batch)
                if metrics["loss"].is_cuda:
                    torch.cuda.synchronize(metrics["loss"].device)
                dt = time.perf_counter() - t0
                self.monitor.record(0, dt)
                self.monitor.check()
                step += 1
                if step % self.cfg.log_every == 0 or step == 1:
                    m = {k: float(v) for k, v in metrics.items()}
                    m["step"] = step
                    m["dt"] = dt
                    self.metrics_history.append(m)
                    self.log(f"[trainer] step {step} loss {m['loss']:.4f} "
                             f"({dt*1e3:.0f} ms)")
                if step % self.cfg.checkpoint_every == 0:
                    self.ckpt.save(step, {"params": params, "opt": opt_state})
            except KeyboardInterrupt:
                raise
            except Exception as e:  # noqa: BLE001 — any step failure restarts
                self.restarts += 1
                self.log(f"[trainer] step {step} FAILED ({type(e).__name__}: "
                         f"{e}); restart {self.restarts}/{self.cfg.max_restarts}")
                if self.restarts > self.cfg.max_restarts:
                    raise
                self.ckpt.wait()
                step, params, opt_state = self._restore_or_init()
        self.ckpt.wait()
        self.ckpt.save(step, {"params": params, "opt": opt_state}, blocking=True)
        return params, opt_state

"""Continuous-batching serving engine on the dynamic-rate actor runtime (the
JAX package's ``serve/actor_engine.py``).

Counterpart of :class:`repro_torch.serve.Engine` that runs the
admission/gate/decode/merge/retire network of
:mod:`repro_torch.graphs.serving` under the host dynamic executor.  Where
the fixed-batch engine spends a ``decode_step`` on every slot until the
*batch* finishes, the actor engine admits requests into slots as they
arrive and admits again into a slot the moment its request retires (EOS or
budget).  Greedy tokens equal the fixed-batch engine's, token for token,
for dense model families (the rows of ``prefill`` and ``decode_step`` are
computed independently of their batchmates at the same (B, P) and (B, 1)
shapes).

``generate`` takes an optional open-loop ``arrivals`` trace (one arrival
step per request, ascending, e.g. ``poisson_trace``); without one every
request is there at step 0.

Resilience: per-request ``deadlines`` and an engine-level ``queue_depth``
turn overload into timeout and shed retirements, and
``generate(on_fault="quarantine")`` (guarded plans only) maps a
``NetworkFaultError`` back to the offending requests with
``faulted_requests``, retires them with ``status="fault"`` and runs the
survivors again from the initial state, with bounded retries.

``plan=ExecutionPlan(mode="dynamic", devices=k)`` shards the network
across the ``k`` ranks of a process group (every rank builds the engine
and calls ``generate`` with the same requests; every rank returns the same
results).

The serving network in megakernel mode is not ported (ROADMAP A9b): the
reference traces the whole LM into its megakernel, while the port's B2
runs a fixed set of device bodies, of which a decode step is none.
"""
from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.configs.base import ArchConfig
from repro_torch.core import ExecutionPlan, Network
from repro_torch.core.health import NetworkFaultError
from repro_torch.graphs.serving import (STATUS_FAULT, STATUS_OK, STATUS_SHED,
                                        STATUS_TIMEOUT, ServingWorkload,
                                        build_serving_network, faulted_requests,
                                        left_pad_prompts)
from repro_torch.models.lm import LM
from repro_torch.serve.engine import Request, Result, ServeConfig

_STATUS_STR = {STATUS_OK: "ok", STATUS_TIMEOUT: "timeout",
               STATUS_SHED: "shed", STATUS_FAULT: "fault"}


class ActorEngine:
    """Serving engine backed by the dynamic-rate actor network."""

    def __init__(self, cfg: ArchConfig, model: LM, scfg: ServeConfig,
                 plan: Optional[ExecutionPlan] = None,
                 queue_depth: Optional[int] = None):
        if cfg.family == "audio":
            raise ValueError(
                f"ActorEngine: {cfg.name} is an audio model and the engine feeds "
                "tokens only; serve it through LM.prefill(tokens, frames=...) and "
                "LM.decode_step")
        self.cfg = cfg
        self.model = model
        self.scfg = scfg
        self.queue_depth = queue_depth
        self.plan = plan if plan is not None else ExecutionPlan(mode="dynamic")
        if self.plan.mode == "megakernel":
            raise NotImplementedError(
                "ActorEngine: the serving network in megakernel mode is not "
                "ported: ROADMAP A9b (kernel B2 runs a fixed set of device "
                "bodies, and an LM decode step is not one of them); use "
                "ExecutionPlan(mode='dynamic')")
        if self.plan.mode != "dynamic":
            raise ValueError(
                f"ActorEngine: plan mode {self.plan.mode!r} cannot run the "
                "serving feedback loop to data-dependent quiescence; use "
                "'dynamic' or 'megakernel'")
        #: Telemetry of the last generate() call.
        self.last_fire_counts: Optional[dict] = None
        self.last_sweeps: Optional[int] = None
        self.last_latency_steps: Optional[np.ndarray] = None
        self.last_program = None
        #: Per-request retirement status of the last generate() call ("ok" |
        #: "timeout" | "shed" | "fault"), aligned with the requests.
        self.last_status: Optional[List[str]] = None
        #: Quarantine retries the last generate() call spent.
        self.last_retries: int = 0
        #: Decoded firing trace of the last generate() call (None unless
        #: the plan says trace=True).
        self.last_trace = None
        #: Sharding telemetry of the last generate() call (None unless the
        #: plan says devices > 1): bytes each sweep-barrier exchange moves
        #: across devices, from Program.stats().
        self.last_collective_bytes_per_sweep: Optional[int] = None

    # ------------------------------------------------------------------ #
    def _stage(self, requests: Sequence[Request], arrivals: Optional[np.ndarray],
               deadlines: Optional[np.ndarray]) -> Tuple[ServingWorkload, Network]:
        scfg = self.scfg
        slab, lens = left_pad_prompts([r.prompt for r in requests], scfg.max_prompt)
        budgets = np.array([min(r.max_new, scfg.max_new) for r in requests], np.int32)
        if arrivals is None:
            arrivals = np.zeros(len(requests), np.int32)
        arrivals = np.asarray(arrivals, np.int32)
        if arrivals.shape != (len(requests),):
            raise ValueError(
                f"ActorEngine: arrivals shape {arrivals.shape} != ({len(requests)},)")
        dl = None if deadlines is None else np.asarray(deadlines, np.int32)
        if dl is not None and dl.shape != (len(requests),):
            raise ValueError(
                f"ActorEngine: deadlines shape {dl.shape} != ({len(requests)},)")
        wl = ServingWorkload(prompts=slab, prompt_lens=lens, budgets=budgets,
                             arrivals=arrivals, deadlines=dl)
        net = build_serving_network(
            self.cfg, self.model, wl, batch_size=scfg.batch_size,
            max_prompt=scfg.max_prompt, max_new=scfg.max_new, eos_id=scfg.eos_id,
            queue_depth=self.queue_depth)
        return wl, net

    def build_network(self, requests: Sequence[Request],
                      arrivals: Optional[np.ndarray] = None,
                      deadlines: Optional[np.ndarray] = None) -> Network:
        """The serving network with these requests staged."""
        return self._stage(requests, arrivals, deadlines)[1]

    def generate(self, requests: List[Request], arrivals: Optional[np.ndarray] = None,
                 deadlines: Optional[np.ndarray] = None, on_fault: str = "raise",
                 max_retries: int = 2) -> List[Result]:
        if on_fault not in ("raise", "quarantine"):
            raise ValueError(
                f"ActorEngine: on_fault={on_fault!r}; pick 'raise' or 'quarantine'")
        if on_fault == "quarantine" and not self.plan.guards:
            raise ValueError(
                "ActorEngine: on_fault='quarantine' needs a guarded plan "
                "(ExecutionPlan(guards=True)): without fault flags there is no "
                "NetworkFaultError to map back to a request")
        live = [(i, r) for i, r in enumerate(requests) if r.max_new > 0]
        out: List[Optional[Result]] = [
            None if r.max_new > 0 else
            Result(tokens=np.zeros((0,), np.int32), prompt_len=len(r.prompt))
            for r in requests]
        self.last_retries = 0
        arr_all = None if arrivals is None else np.asarray(arrivals, np.int32)
        dl_all = None if deadlines is None else np.asarray(deadlines, np.int32)
        quarantined: List[int] = []      # original request indices
        if live:
            # Quarantine loop: each retry runs the survivors from the initial
            # state with the culprits left out; each round removes >= 1
            # request, so it ends within min(max_retries, len(live)) rounds.
            cur = list(live)
            while True:
                idxs = [i for i, _ in cur]
                arr = None if arr_all is None else arr_all[idxs]
                dl = None if dl_all is None else dl_all[idxs]
                wl, net = self._stage([r for _, r in cur], arr, dl)
                prog = net.compile(self.plan)
                try:
                    res = prog.run()
                    break
                except NetworkFaultError as err:
                    if on_fault != "quarantine":
                        raise
                    culprits = faulted_requests(net, err, wl)
                    if (not culprits or self.last_retries >= max_retries
                            or len(culprits) >= len(cur)):
                        raise
                    self.last_retries += 1
                    quarantined.extend(cur[j][0] for j in culprits)
                    cur = [cr for j, cr in enumerate(cur) if j not in set(culprits)]
            self.last_program = prog
            self.last_fire_counts = dict(res.fire_counts)
            self.last_sweeps = int(res.sweeps)
            self.last_trace = res.trace
            self.last_collective_bytes_per_sweep = (
                prog.stats().collective_bytes_per_sweep
                if self.plan.devices > 1 else None)
            sink = prog.collect("retire", res.state)
            done = sink["done"].cpu().numpy()
            if not done.all():
                raise RuntimeError(
                    f"ActorEngine: {int((1 - done).sum())} request(s) never "
                    "retired (network quiesced early); check max_sweeps")
            gen = sink["gen"].cpu().numpy()
            lens = sink["lens"].cpu().numpy()
            status = sink["status"].cpu().numpy()
            self.last_latency_steps = sink["lat"].cpu().numpy()
            for j, (i, r) in enumerate(cur):
                st = _STATUS_STR.get(int(status[j]), "ok")
                # Timeouts keep the tokens produced before the deadline;
                # sheds never ran.
                n = int(lens[j]) if st in ("ok", "timeout") else 0
                out[i] = Result(tokens=gen[j, :n].astype(np.int32),
                                prompt_len=len(r.prompt), status=st)
        for i in quarantined:
            out[i] = Result(tokens=np.zeros((0,), np.int32),
                            prompt_len=len(requests[i].prompt), status="fault")
        self.last_status = [r.status for r in out]
        return out

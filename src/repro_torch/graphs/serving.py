"""Continuous-batching LM serving as a dynamic-rate actor network (the JAX
package's ``graphs/serving.py``).

The serving loop is the paper's adaptive-application pattern (§2.2/§4.3)
applied to the LM stack: requests arrive mid-flight, decode lengths are
data-dependent, and a slot that hits EOS (or its budget) is a **rate-0
firing** whose freed slot is admitted again on the next sweep.  The
graph::

            +--------------------- fb (delay=1) ------------------+
            v                                                     |
      admission ---- table ------------------------------> merge -+
       (static) ---- x -----> gate ---- xa ----> decode --- y ---^
            |                  |      (dynamic: skips the model
            |                  |       when no slot is active)
            |                  +---- fina ----> retire (dynamic sink)
            +-- c_gate / c_dec / c_merge / c_ret  (one control token
                broadcast to every dynamic actor, MoC rate 1)

* **admission** (static, the loop head): takes the slot table back,
  frees the slots the previous step finished, admits 0..k waiting
  arrivals into free slots, sheds or times out what it must, and
  broadcasts ONE control token ``[n_active, n_finished, n_admitted]``.
  Its ``ready`` retires the network once every request is collected.
* **gate** (dynamic): forwards the slot table to decode and the finished
  rows to retire, each only when its count is non-zero, so both ends of
  ``xa`` and ``fina`` are enabled by the same control value.
* **decode** (dynamic): one ``LM.decode_step`` over the B slots per
  firing, plus an ``LM.prefill`` on firings that admit new requests; the
  caches are its state.  With no active slot every port is rate 0 and the
  body is skipped (the firing still counts).
* **merge** (dynamic): folds the tokens into the slot table (append,
  advance pos, EOS or budget) and writes the feedback token.
* **retire** (dynamic sink): collects finished sequences keyed by request.

The actors declare their enables (``ActorSpec.enables``): ``gate.xa``,
``decode.x``, ``decode.y`` and ``merge.y`` are ``(0, 0)`` (``tok[0] >
0``), ``gate.fina`` and ``retire.fin`` ``(1, 0)``, the others 1.  All four
control channels are fed by one tensor object, so the build proves every
channel ``balanced``.

For the megakernel backend each actor declares its device function
(``ActorSpec.device_op``): admission, gate, merge and retire are kernel
B2's bodies of those names, bit for bit these ``fire`` functions (all
int32); decode is a ``"step"``: B2 stops at its enabled firings and the
runner calls ``decode_fire`` on the card between launches.

Token identity: per-request greedy tokens equal the port ``Engine``'s.
Both engines call the same ``prefill`` and ``decode_step`` at the same
(B, P) and (B, 1) shapes, and the rows of a dense model are computed
independently of their batchmates, so *when* a request is admitted cannot
change its tokens.  (MoE models couple rows through expert capacity; the
identity holds for dense families only.)
"""
from __future__ import annotations

import dataclasses
from typing import Any, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.core import DeviceOp, Network, NetworkBuilder, dynamic_actor, static_actor
from repro_torch.core.network import tree_leaves, tree_map

# Slot-table header columns (one row per slot, int32).  After the header:
# P prompt columns (left-padded), then max_new generated-token columns.
C_ACTIVE = 0    # slot holds a live request
C_REQ = 1       # request id (index into the staged request slabs)
C_POS = 2       # next decode_step position (P + produced - 1)
C_PROD = 3      # tokens produced so far (includes the prefill token)
C_BUDGET = 4    # per-request max_new
C_FIN = 5       # finished last step (freed + collected next firing)
C_LAST = 6      # last produced token (decode_step input)
C_NEW = 7       # admitted this firing (decode runs prefill for the row)
C_LAT = 8       # scratch: completion latency in steps (finish extraction)
C_STATUS = 9    # retirement status code (STATUS_*)
C_DEADLINE = 10  # absolute retire-by step (NO_DEADLINE = unconstrained)
C_AGE = 11      # decode steps survived in a slot (admission resets to 0)
HEADER = 12

# Retirement status codes carried in C_STATUS and collected per request.
STATUS_OK = 0        # finished normally (EOS or budget)
STATUS_TIMEOUT = 1   # deadline expired (in flight or while waiting)
STATUS_SHED = 2      # shed by admission under queue overflow
STATUS_FAULT = 3     # quarantined after a guarded-run fault

# Every slot-table value is a non-negative int32 below 2**30; the channels
# declare it as their domain, so a poisoned row trips DOMAIN in a guarded run.
NO_DEADLINE = 2**30 - 1
SLOT_DOMAIN = (0.0, float(2**30))

I32 = torch.int32


@dataclasses.dataclass(frozen=True)
class ServingWorkload:
    """The staged request set of one serving run (host-fed arrival queue)."""

    prompts: np.ndarray       # (R, P) int32, left-padded
    prompt_lens: np.ndarray   # (R,) int32
    budgets: np.ndarray       # (R,) int32 per-request max_new (>= 1)
    arrivals: np.ndarray      # (R,) int32 arrival step, ascending
    # Absolute retire-by step per request; None = no deadlines.
    deadlines: Optional[np.ndarray] = None


def left_pad_prompts(prompts: List[np.ndarray], max_prompt: int
                     ) -> Tuple[np.ndarray, np.ndarray]:
    """Left-pad prompts into an (R, P) slab as ``Engine._pad_batch`` does
    (prompts end together); returns (slab, lens)."""
    R, P = len(prompts), max_prompt
    slab = np.zeros((R, P), np.int32)
    lens = np.zeros((R,), np.int32)
    for i, p in enumerate(prompts):
        p = np.asarray(p, np.int32)[-P:]
        slab[i, P - len(p):] = p
        lens[i] = len(p)
    return slab, lens


def poisson_trace(n: int, rate: float, seed: int = 0) -> np.ndarray:
    """Seeded open-loop Poisson arrival trace: ``n`` ascending integer
    arrival steps with exponential gaps of mean ``1/rate``."""
    rng = np.random.default_rng(seed)
    gaps = rng.exponential(1.0 / rate, size=n)
    return np.floor(np.cumsum(gaps)).astype(np.int32)


# --------------------------------------------------------------------- #
# The decode actor's caches.
# --------------------------------------------------------------------- #
def cache_template(model, batch_size: int, cache_len: int) -> Tuple[list, List[int]]:
    """The caches ``LM.prefill`` returns for a (batch_size, P) batch with
    ``max_cache_len=cache_len``, as meta tensors (shapes and types, no
    memory), and each leaf's batch axis, found against the template at
    ``batch_size + 1`` (the reference's ``eval_shape`` at B and B + 1)."""
    small = model.serve_state(batch_size, cache_len, device="meta")
    big = model.serve_state(batch_size + 1, cache_len, device="meta")
    axes = []
    for s, b in zip(tree_leaves(small), tree_leaves(big)):
        diff = [i for i, (x, y) in enumerate(zip(s.shape, b.shape)) if x != y]
        if len(diff) != 1:
            raise ValueError(
                "serving: cannot locate the batch axis of a cache leaf "
                f"(shape {tuple(s.shape)} vs {tuple(b.shape)}); per-slot cache "
                "merging needs exactly one batch-dependent axis per leaf")
        axes.append(diff[0])
    return small, axes


def _select_rows(mask: torch.Tensor, axes: List[int], new: Any, old: Any) -> Any:
    """Per-row select over a cache tree: rows where ``mask`` take ``new``,
    the others keep ``old``."""
    out = []
    for n, o, ax in zip(tree_leaves(new), tree_leaves(old), axes):
        shape = [1] * n.dim()
        shape[ax] = mask.shape[0]
        out.append(torch.where(mask.reshape(shape), n, o))
    it = iter(out)
    return tree_map(lambda _: next(it), new)


def _scatter_drop(size: int, at: torch.Tensor, values: torch.Tensor) -> torch.Tensor:
    """``zeros(size).at[at].set(values, mode="drop")`` for indices in
    ``[0, size]``: index ``size`` is the drop row."""
    buf = torch.zeros((size + 1,), dtype=values.dtype, device=values.device)
    return buf.scatter_(0, at.long(), values)[:size]


# --------------------------------------------------------------------- #
# Graph construction.
# --------------------------------------------------------------------- #
def build_serving_network(cfg: ArchConfig, model, workload: ServingWorkload, *,
                          batch_size: int, max_prompt: int, max_new: int,
                          eos_id: Optional[int] = None,
                          queue_depth: Optional[int] = None,
                          check_bounds: bool = True,
                          return_bounds: bool = False) -> Network:
    """Build the admission/gate/decode/merge/retire serving network on
    ``model.device`` with ``workload`` staged as the arrival queue.

    ``queue_depth`` bounds the waiting queue: arrived requests that would
    queue deeper than ``queue_depth`` behind this firing's admissions are
    shed (``STATUS_SHED``); None queues without bound.  Requests whose
    deadline passes, waiting or in flight, retire as ``STATUS_TIMEOUT``.

    ``return_bounds=True`` returns ``(network, BoundsReport)``."""
    if cfg.family == "audio":
        raise ValueError(
            f"serving: {cfg.name} is an audio model and the serving network "
            "feeds tokens only; serve it through LM.prefill(tokens, frames=...) "
            "and LM.decode_step")
    B, P, N = batch_size, max_prompt, max_new
    W = HEADER + P + N
    R = int(workload.prompts.shape[0])
    if R == 0:
        raise ValueError("serving: empty workload; stage >= 1 request")
    if workload.prompts.shape[1] != P:
        raise ValueError(
            f"serving: prompt slab width {workload.prompts.shape[1]} != "
            f"max_prompt {P}")
    if (workload.budgets < 1).any() or (workload.budgets > N).any():
        raise ValueError(
            f"serving: per-request budgets must be in 1..max_new={N}")
    if (np.diff(workload.arrivals) < 0).any():
        raise ValueError("serving: arrival trace must be ascending")
    if queue_depth is not None and queue_depth < 0:
        raise ValueError(f"serving: queue_depth={queue_depth} must be >= 0")
    deadlines_np = (np.full((R,), NO_DEADLINE, np.int32)
                    if workload.deadlines is None
                    else np.asarray(workload.deadlines, np.int32))
    if deadlines_np.shape != (R,):
        raise ValueError(
            f"serving: deadlines shape {deadlines_np.shape} != ({R},)")
    dev = model.device
    eos = -1 if eos_id is None else int(eos_id)
    cache_len = P + N

    def staged(a) -> torch.Tensor:
        return torch.as_tensor(np.asarray(a, np.int32), device=dev)

    prompts, budgets = staged(workload.prompts), staged(workload.budgets)
    arrivals, deadlines = staged(workload.arrivals), staged(deadlines_np)
    qd = B + R if queue_depth is None else int(queue_depth)
    idx = torch.arange(R, dtype=I32, device=dev)
    zeros_b = torch.zeros((B,), dtype=I32, device=dev)
    ones_b = torch.ones((B,), dtype=I32, device=dev)
    zeros_pn = torch.zeros((B, P + N), dtype=I32, device=dev)
    zeros_n = torch.zeros((B, N), dtype=I32, device=dev)
    gen_cols = torch.arange(N, dtype=I32, device=dev)[None, :]

    def count(mask: torch.Tensor) -> torch.Tensor:
        return mask.sum(dtype=I32)

    def rank(mask: torch.Tensor) -> torch.Tensor:
        return mask.to(I32).cumsum(0, dtype=I32) - 1

    # -- admission: static loop head ---------------------------------------
    # State: (taken (R,) int32 on the device, step t, requests retired), the
    # two counters host ints (the control token comes to the host anyway).
    def admission_init():
        return (torch.zeros((R,), dtype=I32, device=dev), 0, 0)

    def admission_fire(st, ins, rates):
        del rates
        taken, t, retired = st
        tbl = ins["fb"][0].clone()
        # In-flight deadline expiry retires the slot like an EOS: FIN=1 with
        # TIMEOUT status, freed and collected this firing.
        expired_slot = (tbl[:, C_ACTIVE] > 0) & (tbl[:, C_DEADLINE] < t)
        tbl[:, C_FIN] = torch.where(expired_slot, 1, tbl[:, C_FIN])
        tbl[:, C_STATUS] = torch.where(expired_slot, STATUS_TIMEOUT, tbl[:, C_STATUS])
        fin_mask = tbl[:, C_FIN] > 0
        n_fin = count(fin_mask)
        # Completion latency: the finishing token was produced at step t-1;
        # the request waited since its (open-loop) arrival step.
        req = tbl[:, C_REQ].clamp(0, R - 1)
        fin_rows = tbl.clone()
        fin_rows[:, C_LAT] = (t - 1) - arrivals[req]
        fin_rows = torch.where(fin_mask[:, None], fin_rows, 0)
        tbl = torch.where(fin_mask[:, None], 0, tbl)          # free the slots
        free = tbl[:, C_ACTIVE] == 0

        # The waiting queue: arrived, not yet taken (sheds punch holes).
        waiting = (taken == 0) & (arrivals <= t)
        expired_wait = waiting & (deadlines < t)
        admissible = waiting & ~expired_wait
        adm_rank = rank(admissible)
        k = torch.minimum(count(admissible), count(free))
        admit_req = admissible & (adm_rank < k)
        # Queue overflow: admissible requests deeper than queue_depth behind
        # this firing's k admissions are shed.
        overflow = admissible & (adm_rank >= k + qd)

        # Shed and timeout records ride the free rows of the fin output, at
        # most B - n_fin per firing; the rest stay queued.
        to_shed = expired_wait | overflow
        shed_status = torch.where(expired_wait, STATUS_TIMEOUT, STATUS_SHED).to(I32)
        shed_rank = rank(to_shed)
        emit = to_shed & (shed_rank < B - n_fin)
        n_shed = count(emit)
        req_by_rank = _scatter_drop(B, torch.where(emit, shed_rank, B), idx)
        room = ~fin_mask
        room_rank = rank(room)
        take = room & (room_rank < n_shed)
        sreq = req_by_rank[room_rank.clamp(0, B - 1)]
        shed_header = torch.stack([
            zeros_b,                              # ACTIVE
            sreq,                                 # REQ
            zeros_b,                              # POS
            zeros_b,                              # PROD
            budgets[sreq],                        # BUDGET
            ones_b,                               # FIN (collected by retire)
            zeros_b,                              # LAST
            zeros_b,                              # NEW
            t - arrivals[sreq],                   # LAT: age at shed
            shed_status[sreq.clamp(0, R - 1)],    # STATUS
            deadlines[sreq],                      # DEADLINE
            zeros_b,                              # AGE
        ], dim=1)
        shed_rows = torch.cat([shed_header, zeros_pn], dim=1)
        fin_rows = torch.where(take[:, None], shed_rows, fin_rows)

        # The j-th free slot takes the j-th admissible request.
        free_rank = rank(free)
        admit = free & (free_rank < k)
        req_by_arank = _scatter_drop(B, torch.where(admit_req, adm_rank, B), idx)
        newreq = req_by_arank[free_rank.clamp(0, B - 1)].clamp(0, R - 1)
        header = torch.stack([
            ones_b,                               # ACTIVE
            newreq,                               # REQ
            torch.full((B,), P - 1, dtype=I32, device=dev),  # POS
            zeros_b,                              # PROD
            budgets[newreq],                      # BUDGET
            zeros_b,                              # FIN
            zeros_b,                              # LAST
            ones_b,                               # NEW
            zeros_b,                              # LAT
            torch.full((B,), STATUS_OK, dtype=I32, device=dev),  # STATUS
            deadlines[newreq],                    # DEADLINE
            zeros_b,                              # AGE
        ], dim=1)
        new_rows = torch.cat([header, prompts[newreq], zeros_n], dim=1)
        tbl = torch.where(admit[:, None], new_rows, tbl)
        # ONE broadcast token, one tensor object on every control port:
        # NetworkBuilder's feeder proof needs the very same object.
        ctl = torch.stack([count(tbl[:, C_ACTIVE] > 0), n_fin + n_shed, k]).cpu()
        taken = torch.where(admit_req | emit, 1, taken)
        st = (taken, t + 1, retired + int(ctl[1]))
        return st, {"table": tbl, "x": tbl, "fin": fin_rows,
                    "c_gate": ctl, "c_dec": ctl, "c_merge": ctl, "c_ret": ctl}

    admission = static_actor(
        "admission", ["fb"],
        ["table", "x", "fin", "c_gate", "c_dec", "c_merge", "c_ret"],
        admission_fire, init=admission_init, ready=lambda st: st[2] < R,
        device_op=DeviceOp("admission", dict(
            prompts=prompts, budgets=budgets, arrivals=arrivals, deadlines=deadlines,
            B=B, P=P, N=N, R=R, qd=qd)))

    # -- gate: rate-converts admission's static writes to dynamic reads ----
    def gate_control(tok):
        return {"x": 1, "fin": 1, "xa": int(tok[0] > 0), "fina": int(tok[1] > 0)}

    def gate_fire(st, ins, rates):
        del rates
        return st, {"xa": ins["x"][0], "fina": ins["fin"][0]}

    gate = dynamic_actor("gate", "c", gate_control, ["x", "fin"], ["xa", "fina"],
                         gate_fire, device_op=DeviceOp("gate"),
                         enables={"x": 1, "fin": 1, "xa": (0, 0), "fina": (1, 0)})

    # -- decode: the model actor (the caches are its state) ----------------
    template, cache_axes = cache_template(model, B, cache_len)

    def decode_init():
        return tree_map(lambda t: torch.zeros(t.shape, dtype=t.dtype, device=dev), template)

    def decode_control(tok):
        on = int(tok[0] > 0)
        return {"x": on, "y": on}

    def decode_fire(caches, ins, rates):
        del rates
        tbl = ins["x"][0]
        isnew = tbl[:, C_NEW] > 0
        fresh = None
        if bool(isnew.any()):
            lg, fresh = model.prefill(
                torch.where(isnew[:, None], tbl[:, HEADER:HEADER + P], 0),
                max_cache_len=cache_len)
            tok0 = torch.argmax(lg, dim=-1).to(I32)
        # decode_step runs on the pre-merge caches: newly prefilled rows keep
        # their fresh cache rows, not a decode write at a stale position.
        # decode_step writes ring KV slots in place, so the select below
        # takes whole rows of the fresh caches for the new slots.
        lg, dec = model.decode_step(tbl[:, C_LAST, None], tbl[:, C_POS], caches)
        y = torch.argmax(lg, dim=-1).to(I32)
        if fresh is None:
            return dec, {"y": y}
        return (_select_rows(isnew, cache_axes, fresh, dec),
                {"y": torch.where(isnew, tok0, y)})

    decode = dynamic_actor("decode", "c", decode_control, ["x"], ["y"], decode_fire,
                           init=decode_init, enables={"x": (0, 0), "y": (0, 0)},
                           device_op=DeviceOp("step"),
                           cost_flops=2 * cfg.d_model * cfg.d_model
                           * max(cfg.n_layers, 1) * B)

    # -- merge: fold tokens into the table, detect EOS/budget --------------
    def merge_control(tok):
        return {"table": 1, "y": int(tok[0] > 0), "fb": 1}

    def merge_fire(st, ins, rates):
        # With no active slot the y window is stale; the active flags mask it.
        del rates
        tbl = ins["table"][0]
        y = ins["y"][0]
        active = tbl[:, C_ACTIVE] > 0
        act = active.to(I32)
        produced = tbl[:, C_PROD]
        gen = torch.where(active[:, None] & (gen_cols == produced[:, None]),
                          y[:, None], tbl[:, HEADER + P:])
        produced = produced + act
        fin = active & ((y == eos) | (produced >= tbl[:, C_BUDGET]))
        header = torch.stack([
            (active & ~fin).to(I32),                       # ACTIVE
            tbl[:, C_REQ],
            tbl[:, C_POS] + act,                           # POS
            produced,
            tbl[:, C_BUDGET],
            fin.to(I32),                                   # FIN
            torch.where(active, y, tbl[:, C_LAST]),        # LAST
            zeros_b,                                       # NEW
            tbl[:, C_LAT],
            tbl[:, C_STATUS],                              # STATUS (OK on EOS fin)
            tbl[:, C_DEADLINE],
            tbl[:, C_AGE] + act,                           # AGE
        ], dim=1)
        return st, {"fb": torch.cat([header, tbl[:, HEADER:HEADER + P], gen], dim=1)}

    merge = dynamic_actor("merge", "c", merge_control, ["table", "y"], ["fb"],
                          merge_fire, enables={"table": 1, "y": (0, 0), "fb": 1},
                          device_op=DeviceOp("merge", dict(eos=eos, P=P, N=N)))

    # -- retire: dynamic sink collecting finished sequences ----------------
    # State: (gen (R, N), lens, lat, status, done (R,)), int32 on the device.
    def retire_init():
        return (torch.zeros((R, N), dtype=I32, device=dev),
                *(torch.zeros((R,), dtype=I32, device=dev) for _ in range(4)))

    def retire_control(tok):
        return {"fin": int(tok[1] > 0)}

    def retire_fire(st, ins, rates):
        del rates
        rows = ins["fin"][0]
        req = torch.where(rows[:, C_FIN] > 0, rows[:, C_REQ], R).long()

        def put(old: torch.Tensor, new: torch.Tensor) -> torch.Tensor:
            # .at[req].set(new, mode="drop"): row R is the drop row.
            buf = torch.cat([old, torch.zeros_like(old[:1])])
            buf[req] = new
            return buf[:R]
        gen, lens, lat, status, done = st
        return (put(gen, rows[:, HEADER + P:]), put(lens, rows[:, C_PROD]),
                put(lat, rows[:, C_LAT]), put(status, rows[:, C_STATUS]),
                put(done, ones_b)), {}

    retire = dynamic_actor(
        "retire", "c", retire_control, ["fin"], [], retire_fire, init=retire_init,
        enables={"fin": (1, 0)}, device_op=DeviceOp("retire", dict(R=R, P=P, N=N)),
        finish=lambda st: dict(zip(("gen", "lens", "lat", "status", "done"), st)))

    # -- wiring ------------------------------------------------------------
    b = NetworkBuilder()
    for spec in (admission, gate, decode, merge, retire):
        b.actor(spec)
    tbl_shape = (B, W)
    # The delay-token feedback FIFO carrying the per-slot decode state; its
    # initial token is the empty slot table.  Slot-table channels declare
    # SLOT_DOMAIN and the request-id column, so a guarded run flags a
    # poisoned row and a fault report can name its request.
    slot_kw = dict(token_shape=tbl_shape, dtype=I32, domain=SLOT_DOMAIN,
                   row_id_col=C_REQ)
    b.connect("merge.fb", "admission.fb", delay=1,
              initial_token=torch.zeros(tbl_shape, dtype=I32), name="fb", **slot_kw)
    b.connect("admission.table", "merge.table", name="table", **slot_kw)
    b.connect("admission.x", "gate.x", name="x", **slot_kw)
    b.connect("admission.fin", "gate.fin", name="fin", **slot_kw)
    b.connect("gate.xa", "decode.x", name="xa", **slot_kw)
    b.connect("decode.y", "merge.y", token_shape=(B,), dtype=I32,
              domain=SLOT_DOMAIN, name="y")
    b.connect("gate.fina", "retire.fin", name="fina", **slot_kw)
    for ctl_port, actor in (("c_gate", "gate"), ("c_dec", "decode"),
                            ("c_merge", "merge"), ("c_ret", "retire")):
        b.connect(f"admission.{ctl_port}", f"{actor}.c", token_shape=(3,),
                  dtype=I32, name=f"ctl_{actor}")
    # Declared accept/EOS rate bounds: the matched-rates proof tightens them
    # to "balanced"; the declaration keeps check_bounds decidable should a
    # wiring change drop a proof.
    for ep in ("gate.xa", "decode.x", "decode.y", "merge.y",
               "gate.fina", "retire.fin"):
        b.rate_bounds(ep, 0.0, 1.0)
    net = b.build(device=dev, check_bounds=check_bounds)
    if return_bounds:
        return net, (b.bounds_report if check_bounds else b.check_bounds(dev))
    return net


# --------------------------------------------------------------------- #
# Fault -> request mapping (the quarantine half of the resilience layer).
# --------------------------------------------------------------------- #
def faulted_requests(network: Network, err: Exception,
                     workload: ServingWorkload) -> List[int]:
    """Map a guarded serving fault back to the offending request ids.

    Only ``DOMAIN`` faults are mappable: a slot-table row held values
    outside ``SLOT_DOMAIN``, which for the faults the serving layer models
    (``faultinject.poison_request``) entered through the staged workload.
    The staged slabs are scanned first (the guarded run goes on to
    quiescence before it raises, so the row may have left every ring);
    then, if the partial state survived (``err.result.state``), the
    windows of each DOMAIN-faulting channel that declares a ``row_id_col``
    vote with their request-id column.  Returns sorted unique ids; empty
    without a DOMAIN fault (overflow or stall is no request's fault).
    """
    diag = getattr(err, "diagnostics", None)
    faults = diag.faults if diag is not None else ()
    dom = [f for f in faults if "DOMAIN" in f.faults]
    if not dom:
        return []
    lo, hi = SLOT_DOMAIN
    R = int(workload.prompts.shape[0])
    culprits: set = set()

    prompts = np.asarray(workload.prompts)
    bad_rows = np.any((prompts < lo) | (prompts > hi), axis=1)
    culprits.update(int(i) for i in np.nonzero(bad_rows)[0])
    for slab in (workload.budgets, workload.arrivals):
        vals = np.asarray(slab)
        bad = (vals < lo) | (vals > hi)
        culprits.update(int(i) for i in np.nonzero(bad)[0])

    state = getattr(getattr(err, "result", None), "state", None)
    if state is not None:
        for f in dom:
            spec = network.fifos.get(f.fifo)
            if spec is None or spec.row_id_col is None:
                continue
            buf = state.fifo(f.fifo).buf.cpu().numpy()
            if buf.ndim < 2:
                continue
            rows = buf.reshape(-1, buf.shape[-1])
            bad = np.any((rows < lo) | (rows > hi), axis=1)
            for r in np.nonzero(bad)[0]:
                rid = int(rows[r, spec.row_id_col])
                if 0 <= rid < R:
                    culprits.add(rid)
    return sorted(culprits)

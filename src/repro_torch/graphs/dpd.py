"""The Dynamic Predistortion application — paper §4.2, Fig. 5.

A configuration actor reconfigures which of the 10 parallel Poly branches
(basis + 10-tap complex FIR) are active; the adder sums the active
branches.  The number of active branches changes between 2 and 10 at run
time.

Wiring (22 complex data channels + 12 control channels):

    source --f_in--> fork --f_b{k}--> poly{k} --f_y{k}--> adder --f_out--> sink
    config --f_c_fork--> fork, --f_c{k}--> poly{k}, --f_c_add--> adder

Tokens are ``(2, L)`` float32 (re, im) planes on the network's device;
L = 32 768 makes Eq. 1 over the 22 data channels Table 1's 11.5 MB.  On the
card, in the host modes, every enabled Poly firing is one launch of the
Hopper kernel B1; a rate-0 firing launches nothing.  Every actor also
declares its :class:`~repro_torch.core.actor.DeviceOp`, which is what the
megakernel mode runs inside one launch of B2.  The control channels
declare the schedule's value range as their domain, which is what lets the
builder prove every data channel transient (``register_fifos``) and the
device program tabulate the dynamic actors' rates.
"""
from __future__ import annotations

from typing import Any, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core import NetworkBuilder, dynamic_actor, static_actor
from repro_torch.core.actor import DeviceOp, apply_rate_gate
from repro_torch.core.network import Network
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.kernels.dyn_fir import N_BRANCHES, N_TAPS, poly_branch

BLOCK_L = 32768                 # complex samples per token (256 KB)
RECONF_PERIOD_SAMPLES = 65536   # paper §4.2
RECONF_PERIOD_FIRINGS = RECONF_PERIOD_SAMPLES // BLOCK_L


def _branch_on(k: int, tok: Sequence[Any]) -> int:
    """0/1 enable of branch ``k`` given the configuration token — the one
    predicate behind fork.b_k, poly_k.in/out and adder.y_k."""
    return int(k < tok[0])


def _branch_form(k: int) -> Tuple[int, int]:
    """:func:`_branch_on` as a declared enable: ``tok[0] > k``."""
    return (0, k)


def default_active_schedule(n_firings: int, seed: int = 0,
                            lo: int = 2, hi: int = N_BRANCHES) -> np.ndarray:
    """Active filters per firing: a new value in [lo, hi] every
    reconfiguration period (paper: 2..10, externally defined)."""
    rng = np.random.default_rng(seed)
    n_periods = -(-n_firings // RECONF_PERIOD_FIRINGS)
    per = rng.integers(lo, hi + 1, n_periods)
    return np.repeat(per, RECONF_PERIOD_FIRINGS)[:n_firings].astype(np.int32)


def build_dpd(n_firings: int,
              active_schedule: Optional[np.ndarray] = None,
              block_l: int = BLOCK_L,
              n_branches: int = N_BRANCHES,
              signal: Optional[Any] = None,
              static_all_active: bool = False,
              device: DeviceLike = None) -> Network:
    """Build the DPD network on ``device`` (the CUDA card when None).

    ``static_all_active=True`` builds the static variant (every branch
    always on, no control ports): the DAL-compatible baseline of Table 4.
    ``signal`` is a ``(2, n_firings * block_l)`` array staged in the
    source (zeros when None).
    """
    dev = resolve_device(device)
    L = block_l
    tok = (2, L)
    if active_schedule is None:
        active_schedule = default_active_schedule(n_firings)
    sched = np.asarray(active_schedule, np.int32)
    if sched.size == 0:
        sched = np.zeros(1, np.int32)
    # Every control token is an entry of `sched`: this is its domain.
    domain = (int(sched.min()), int(sched.max()))

    # -- source / sink ------------------------------------------------ #
    def src_fire(state, inputs, rates):
        data, idx = state
        return (data, idx + 1), {"out": data[:, idx * L:(idx + 1) * L][None]}

    # Staged once; the source only reads it, so every init_state shares it.
    staged = (torch.zeros((2, n_firings * L), dtype=torch.float32, device=dev)
              if signal is None
              else torch.as_tensor(signal, dtype=torch.float32).to(dev))

    def src_init():
        return (staged, 0)

    source = static_actor("source", (), ("out",), src_fire, init=src_init,
                          ready=lambda st: st[1] < n_firings,
                          device_op=DeviceOp("source", {"n_firings": n_firings,
                                                        "planes": 2}))

    def sink_fire(state, inputs, rates):
        data, idx = state
        data[:, idx * L:(idx + 1) * L] = inputs["in"][0]
        return (data, idx + 1), {}

    sink = static_actor(
        "sink", ("in",), (), sink_fire,
        init=lambda: (torch.zeros((2, n_firings * L), dtype=torch.float32,
                                  device=dev), 0),
        finish=lambda st: st[0], device_op=DeviceOp("sink", {"planes": 2}))

    # -- configuration: one active-count token to 12 control ports ------ #
    ctrl_ports = ["c_fork", "c_add"] + [f"c{k}" for k in range(n_branches)]

    def config_fire(state, inputs, rates):
        idx = state
        n_active = int(sched[min(max(idx, 0), sched.shape[0] - 1)])
        tok_out = torch.tensor([[n_active]], dtype=torch.int32)
        return idx + 1, {p: tok_out for p in ctrl_ports}

    config_op = DeviceOp("config", {
        "schedule": torch.as_tensor(sched, dtype=torch.int32).to(dev),
        "n_firings": n_firings})
    config = static_actor("config", (), tuple(ctrl_ports), config_fire,
                          init=lambda: 0, ready=lambda st: st < n_firings,
                          device_op=config_op)

    # -- fork: the input window to the enabled branches ----------------- #
    fork_outs = tuple(f"b{k}" for k in range(n_branches))

    def fork_control(tok):
        d = {"in": 1}
        for k in range(n_branches):
            d[f"b{k}"] = _branch_on(k, tok)
        return d

    def fork_fire(state, inputs, rates):
        return state, {p: inputs["in"] for p in fork_outs}

    if static_all_active:
        fork = static_actor("fork", ("in",), fork_outs, fork_fire,
                            device_op=DeviceOp("fork"))
    else:
        fork = dynamic_actor("fork", "c", fork_control, ("in",), fork_outs,
                             fork_fire, device_op=DeviceOp("fork"),
                             enables={"in": 1, **{f"b{k}": _branch_form(k)
                                                  for k in range(n_branches)}})

    # -- Poly branches: basis + 10-tap complex FIR, 9-sample history ---- #
    def make_poly(k: int):
        order = k + 1

        def init():
            hist = torch.zeros((2, N_TAPS - 1), dtype=torch.float32, device=dev)
            rng = np.random.default_rng(100 + k)
            taps = torch.as_tensor(
                rng.normal(scale=0.3, size=(2, N_TAPS)).astype(np.float32)).to(dev)
            return (hist, taps)

        def fire(state, inputs, rates):
            hist, taps = state
            win = inputs["in"][0]                          # (2, L)
            y, new_hist = poly_branch(hist, win, taps, order)
            return (new_hist, taps), {"out": y[None]}

        def control(tok):
            on = _branch_on(k, tok)
            return {"in": on, "out": on}

        flops = 2 * L * (4 * N_TAPS + 2 * order)  # complex MACs + basis
        op = DeviceOp("poly", {"order": order})
        if static_all_active:
            return static_actor(f"poly{k}", ("in",), ("out",), fire, init=init,
                                cost_flops=flops, device_op=op)
        return dynamic_actor(f"poly{k}", "c", control, ("in",), ("out",), fire,
                             init=init, cost_flops=flops, device_op=op,
                             enables={"in": _branch_form(k),
                                      "out": _branch_form(k)})

    polys = [make_poly(k) for k in range(n_branches)]

    # -- adder: sum of the enabled branch outputs, k = 0..9 in order ---- #
    add_ins = tuple(f"y{k}" for k in range(n_branches))

    def adder_fire(state, inputs, rates):
        acc = torch.zeros((1, 2, L), dtype=torch.float32, device=dev)
        for k in range(n_branches):
            term = apply_rate_gate(rates[f"y{k}"], inputs[f"y{k}"])
            if term is not None:
                acc.add_(term)
        return state, {"out": acc}

    def adder_control(tok):
        d = {"out": 1}
        for k in range(n_branches):
            d[f"y{k}"] = _branch_on(k, tok)
        return d

    adder_op = DeviceOp("adder", {"terms": add_ins})
    if static_all_active:
        adder = static_actor("adder", add_ins, ("out",), adder_fire,
                             device_op=adder_op)
    else:
        adder = dynamic_actor("adder", "c", adder_control, add_ins, ("out",),
                              adder_fire, device_op=adder_op,
                              enables={"out": 1, **{f"y{k}": _branch_form(k)
                                                    for k in range(n_branches)}})

    # -- wiring (Eq. 1 capacities derived per channel) ------------------ #
    b = NetworkBuilder()
    if not static_all_active:
        b.actor(config)
    b.actors(source, fork, *polys, adder, sink)
    b.connect("source.out", "fork.in", token_shape=tok, name="f_in")
    b.connect("adder.out", "sink.in", token_shape=tok, name="f_out")
    for k in range(n_branches):
        b.connect(f"fork.b{k}", f"poly{k}.in", token_shape=tok, name=f"f_b{k}")
        b.connect(f"poly{k}.out", f"adder.y{k}", token_shape=tok, name=f"f_y{k}")
    if not static_all_active:
        b.connect("config.c_fork", "fork.c", name="f_c_fork", domain=domain)
        b.connect("config.c_add", "adder.c", name="f_c_add", domain=domain)
        for k in range(n_branches):
            b.connect(f"config.c{k}", f"poly{k}.c", name=f"f_c{k}", domain=domain)
    return b.build(device=dev)


def bench_workload(n_firings: int, block_l: int = BLOCK_L, seed: int = 1,
                   device: DeviceLike = None, **build_kw) -> Network:
    """DPD with a reproducible random signal staged and the
    ``default_active_schedule`` reconfiguration pattern (``n_firings *
    block_l`` complex samples end to end)."""
    from repro_torch.graphs.factories import make_dpd
    build_kw.setdefault("active_schedule", default_active_schedule(n_firings))
    net, _ = make_dpd(n_firings, block_l=block_l, seed=seed, device=device,
                      **build_kw)
    return net

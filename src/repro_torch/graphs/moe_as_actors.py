"""The MoE layer as a dynamic-data-rate actor network.

The port of ``src/repro/graphs/moe_as_actors.py``, with the same actors,
ports, channel names, shapes and types.  One *router* (static) actor and
``E`` *expert* (dynamic) actors; per firing (one window of ``N`` tokens):

* router: takes the token window and emits one control token per expert,
  that expert's count of tokens this firing (0..capacity: the paper's
  {0, r} restriction as a masked fixed-capacity window), the dispatched
  ``(C, D)`` slabs on its data ports, the slots and combine weights, and
  the counts again for the packer;
* expert ``e``: a dynamic actor whose control token disables the firing
  when no token was routed to it (no body: the paper's 5x mechanism);
  otherwise the SwiGLU FFN of its slab;
* packer: the counts as one ``(2E,)`` control token (twice over);
* combine: a dynamic actor whose ``y_e`` enables follow that token; it
  rebuilds the ``(N, D)`` output from the enabled experts' slabs with the
  combine weights.

Each actor declares its enables (``tok[0] > 0`` for an expert, ``tok[e] >
0`` for the combine's ``y_e``) and its :class:`DeviceOp`, so the network
runs in every mode, the megakernel (kernel B2) included.  The network
computes what ``models.moe.moe_layer`` computes on float32 tokens.
"""
from __future__ import annotations

from typing import Dict

import torch
from torch.nn import functional as F

from repro_torch.core import NetworkBuilder, dynamic_actor, static_actor
from repro_torch.core.actor import DeviceOp, apply_rate_gate
from repro_torch.core.network import Network
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.models.moe import scatter_rows, capacity_for, route, router_logits

F32 = torch.float32


def build_moe_network(params: Dict[str, torch.Tensor], n_tokens: int, d_model: int,
                      top_k: int, capacity_factor: float, n_firings: int,
                      token_stream: torch.Tensor, device: DeviceLike = None) -> Network:
    """The actor network of one MoE layer over ``n_firings`` windows of
    ``n_tokens`` tokens; ``token_stream`` (n_firings * n_tokens, D) float32
    and the bf16 ``params`` (``moe.moe_init``'s) are moved to ``device``
    (the card when None)."""
    dev = resolve_device(device)
    params = {k: v.to(dev) for k, v in params.items()}
    stream = torch.as_tensor(token_stream, dtype=F32).to(dev).contiguous()
    E = params["router"].shape[1]
    D, Fd = d_model, params["we_gate"].shape[2]
    C = capacity_for(n_tokens, E, top_k, capacity_factor)
    N, k = n_tokens, top_k
    shapes = dict(N=N, k=k, C=C, E=E, D=D, F=Fd)

    # -- source -------------------------------------------------------- #
    def src_fire(state, inputs, rates):
        data, idx = state
        return (data, idx + 1), {"out": data[idx * N:(idx + 1) * N][None]}

    source = static_actor(
        "source", (), ("out",), src_fire,
        init=lambda: (stream.clone(), 0), ready=lambda st: st[1] < n_firings,
        device_op=DeviceOp("source", {"n_firings": n_firings, "planes": 1}))

    # -- router: control actor ------------------------------------------ #
    rt_outs = (tuple(f"x{e}" for e in range(E)) + tuple(f"c{e}" for e in range(E))
               + ("slot", "w") + tuple(f"c{e}_p" for e in range(E)))

    def router_fire(state, inputs, rates):
        xt = inputs["in"][0]
        r = route(router_logits(params["router"], xt), k)
        keep = r.rank < C
        slot = torch.where(keep, r.gate_e * C + r.rank, torch.full_like(r.rank, E * C))
        disp = scatter_rows(slot.reshape(-1), xt.repeat_interleave(k, dim=0), E * C + 1)
        slabs = disp[:-1].reshape(E, C, D)
        counts = (F.one_hot(r.gate_e, E).to(torch.int32) * keep[..., None]).sum((0, 1))
        counts = counts.to(torch.int32)
        outs = {f"x{e}": slabs[e][None] for e in range(E)}
        outs.update({f"c{e}": counts[e].reshape(1, 1) for e in range(E)})
        outs.update({f"c{e}_p": counts[e].reshape(1, 1) for e in range(E)})
        outs["slot"] = slot[None].to(torch.int32)
        outs["w"] = (r.gate_w * keep.to(F32))[None]
        return state, outs

    router = static_actor("router", ("in",), rt_outs, router_fire,
                          device_op=DeviceOp("router", {"router": params["router"],
                                                        **shapes}))

    # -- experts: dynamic actors, rate 0 or r by the routed count -------- #
    def make_expert(e: int):
        wg, wu, wd = (params[n][e].contiguous() for n in ("we_gate", "we_up", "we_down"))

        def control(tok):
            on = int(tok[0] > 0)
            return {"in": on, "out": on}

        def fire(state, inputs, rates):
            slab = inputs["in"][0]                      # (C, D)
            g = F.silu(slab @ wg.to(F32))
            y = (g * (slab @ wu.to(F32))) @ wd.to(F32)
            return state, {"out": y[None]}

        op = DeviceOp("expert", {"we_gate": wg, "we_up": wu, "we_down": wd,
                                 "C": C, "D": D, "F": Fd})
        return dynamic_actor(f"expert{e}", "c", control, ("in",), ("out",), fire,
                             device_op=op, enables={"in": (0, 0), "out": (0, 0)})

    experts = [make_expert(e) for e in range(E)]

    # -- combine: dynamic, its y_e enables keyed on the packed counts ---- #
    def comb_control(tok):
        d = {f"y{e}": int(tok[e] > 0) for e in range(E)}
        d.update({"slot": 1, "w": 1, "out": 1})
        return d

    def comb_fire(state, inputs, rates):
        y_flat = torch.zeros((E * C + 1, D), dtype=F32, device=dev)
        for e in range(E):
            gated = apply_rate_gate(rates[f"y{e}"], inputs[f"y{e}"][0])
            if gated is not None:
                y_flat[e * C:(e + 1) * C] = gated
        slot = inputs["slot"][0].to(torch.int64)
        per_k = y_flat[slot.reshape(-1)].reshape(N, k, D)
        y = torch.einsum("nkd,nk->nd", per_k, inputs["w"][0])
        return state, {"out": y[None]}

    comb_ins = tuple(f"y{e}" for e in range(E)) + ("slot", "w")
    combine = dynamic_actor(
        "combine", "cc", comb_control, comb_ins, ("out",), comb_fire,
        device_op=DeviceOp("combine", shapes),
        enables={**{f"y{e}": (e, 0) for e in range(E)}, "slot": 1, "w": 1, "out": 1})

    # -- packer: the counts as one (2E,) control token ------------------- #
    def pack_fire(state, inputs, rates):
        vec = torch.cat([inputs[f"c{e}"][0] for e in range(E)] * 2)[:2 * E]
        return state, {"out": vec[None]}

    packer = static_actor("packer", tuple(f"c{e}" for e in range(E)), ("out",),
                          pack_fire, device_op=DeviceOp("packer", {"E": E}))

    # -- sink ------------------------------------------------------------ #
    def sink_fire(state, inputs, rates):
        data, idx = state
        data[idx * N:(idx + 1) * N] = inputs["in"][0]
        return (data, idx + 1), {}

    sink = static_actor(
        "sink", ("in",), (), sink_fire,
        init=lambda: (torch.zeros((n_firings * N, D), dtype=F32, device=dev), 0),
        finish=lambda st: st[0],
        device_op=DeviceOp("sink", {"planes": 1}))

    b = NetworkBuilder()
    b.actors(source, router, packer, *experts, combine, sink)
    b.connect("source.out", "router.in", token_shape=(N, D), name="f_in")
    b.connect("combine.out", "sink.in", token_shape=(N, D), name="f_out")
    b.connect("router.slot", "combine.slot", token_shape=(N, k),
              dtype=torch.int32, name="f_slot")
    b.connect("router.w", "combine.w", token_shape=(N, k), dtype=F32, name="f_w")
    b.connect("packer.out", "combine.cc", token_shape=(2 * E,), name="f_cpack")
    for e in range(E):
        b.connect(f"router.x{e}", f"expert{e}.in", token_shape=(C, D), name=f"f_x{e}")
        b.connect(f"expert{e}.out", f"combine.y{e}", token_shape=(C, D), name=f"f_y{e}")
        b.connect(f"router.c{e}", f"expert{e}.c", name=f"f_ce{e}")
        b.connect(f"router.c{e}_p", f"packer.c{e}", token_shape=(1,),
                  dtype=torch.int32, name=f"f_cp{e}")
    return b.build(device=dev)

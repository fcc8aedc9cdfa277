"""Mixture-of-Experts layer: the LM side of the paper's dynamic data rates.

The port of ``src/repro/models/moe.py``.  The router is the control actor
(its top-k decision is the control token); every expert is a dynamic
actor whose per-firing token rate is 0..capacity.  Capacity-and-drop
dispatch is the paper's {0, r} restriction: an expert takes at most
``capacity`` tokens a firing, and overflow tokens take the rate-0 path
(the residual carries them).  ``graphs/moe_as_actors.py`` expresses the
same layer as an actor network.

Scatter/gather dispatch on contiguous ``(E, C, D)`` expert slabs:

1. router logits -> top-k experts and normalised weights per token
   (:func:`route`, a function of its own so a test can feed one backend's
   routing to the other);
2. each (token, k) assignment ranked within its expert by a cumsum in
   token-major order; assignments past capacity are dropped;
3. tokens scattered (added into zeros) to ``(E C, D)`` slots, the expert
   SwiGLU FFNs as batched products, rows gathered back with the weights.
   The gather is an ``index_select``: its backward adds into each kept
   slot once, and every dropped assignment into the one zero row, whose
   gradient nothing reads (indexing's backward sorts the indices and walks
   that row's thousands of duplicates in one warp: 41 ms a layer at
   granite-moe-3b-a800m's 2 x 4096 tokens on an H100).

The arithmetic and its rounding follow the reference: logits in float32
(:func:`router_logits`); softmax, top-k (ties to the lower expert) and the
weights in float32; the experts' products in the activation type.  The large
products are ``torch.matmul`` / ``torch.bmm``: the reference computes them
outside any Pallas kernel.
"""
from __future__ import annotations

import math
from typing import Dict, NamedTuple, Optional, Tuple

import torch
from torch import nn
from torch.nn import functional as F

from repro_torch.models.layers import F32, dense, init_normal_, param


def moe_init(d_model: int, n_experts: int, d_ff: int,
             gen: Optional[torch.Generator] = None, device=None
             ) -> Dict[str, torch.Tensor]:
    """The layer's bf16 weights under the reference's names: ``router``
    (D, E), ``we_gate`` and ``we_up`` (E, D, F), ``we_down`` (E, F, D),
    drawn from ``gen`` as the reference scales them (1/sqrt(D) in, 1/sqrt(F)
    out); left uninitialised when ``gen`` is None."""
    out = {"router": dense(d_model, n_experts, gen, device)}
    for name, shape, fan_in in (("we_gate", (n_experts, d_model, d_ff), d_model),
                                ("we_up", (n_experts, d_model, d_ff), d_model),
                                ("we_down", (n_experts, d_ff, d_model), d_ff)):
        p = param(shape, device=device)
        init_normal_(p, gen, 1.0 / math.sqrt(fan_in))
        out[name] = p
    return out


def capacity_for(n_tokens: int, n_experts: int, top_k: int,
                 capacity_factor: float) -> int:
    """Tokens an expert takes a firing: the even share times the factor,
    rounded up to a multiple of 8, at least 8."""
    c = int(math.ceil(n_tokens * top_k * capacity_factor / n_experts))
    return max(8, -(-c // 8) * 8)


class Routing(NamedTuple):
    """One routing decision over ``(..., N)`` tokens: float32 ``probs``
    (..., N, E), the top-k ``gate_e`` (int64) and ``gate_w`` (float32,
    normalised), and each assignment's rank within its expert."""

    probs: torch.Tensor
    gate_e: torch.Tensor
    gate_w: torch.Tensor
    rank: torch.Tensor


def router_logits(router: torch.Tensor, xt: torch.Tensor) -> torch.Tensor:
    """``xt @ router`` as float32 logits.  The reference writes a product
    in the activation type followed by a cast to float32; XLA drops the
    rounding in between (excess precision, measured on its CPU backend:
    bf16 tokens give logits that no bf16 holds), so the port takes the
    product in float32 from the exact float32 values of both operands."""
    return xt.to(F32) @ router.to(F32)


def route(logits: torch.Tensor, top_k: int,
          gate_e: Optional[torch.Tensor] = None) -> Routing:
    """Softmax, top-k with ties to the lower expert (or the experts
    ``gate_e`` given), weights over their sum (at least 1e-9), and ranks by
    an exclusive cumsum over the assignments in token-major order, per
    leading group.  ``logits``: (..., N, E)."""
    E = logits.shape[-1]
    probs = torch.softmax(logits, dim=-1)
    if gate_e is None:
        gate_e = torch.sort(probs, dim=-1, descending=True, stable=True).indices[..., :top_k]
    gate_w = torch.gather(probs, -1, gate_e)
    gate_w = gate_w / torch.clamp(gate_w.sum(-1, keepdim=True), min=1e-9)
    return Routing(probs, gate_e, gate_w, _ranks(gate_e, E))


def _ranks(gate_e: torch.Tensor, E: int) -> torch.Tensor:
    """Each assignment's rank within its expert, ``gate_e`` (..., N, k)."""
    lead = gate_e.shape[:-2]
    N, top_k = gate_e.shape[-2:]
    # The reference's exclusive cumsum of one-hot rows, as a stable sort:
    # an assignment's rank is its place among its expert's assignments in
    # token-major order (the same integers, without the (N k, E) scan).
    fe = gate_e.reshape(*lead, N * top_k)
    order = torch.sort(fe, dim=-1, stable=True).indices
    cnt = torch.zeros((*lead, E), dtype=torch.int64, device=fe.device)
    cnt.scatter_add_(-1, fe, torch.ones_like(fe))
    start = torch.cumsum(cnt, -1) - cnt
    pos = (torch.arange(N * top_k, device=fe.device).expand_as(fe)
           - torch.gather(start, -1, torch.gather(fe, -1, order)))
    return torch.empty_like(fe).scatter_(-1, order, pos).reshape(*lead, N, top_k)


def _decide(params, xt: torch.Tensor, top_k: int, routing: Optional[Routing],
            gate_e: Optional[torch.Tensor]) -> Routing:
    """``routing`` as given, else :func:`route` of this layer's logits
    (with the experts ``gate_e``, where given)."""
    if routing is not None:
        return routing
    return route(router_logits(params["router"], xt), top_k, gate_e)


def _aux(probs: torch.Tensor, gate_e: torch.Tensor, keep: torch.Tensor
         ) -> Dict[str, torch.Tensor]:
    """Switch-style load-balance loss and the dropped share."""
    E = probs.shape[-1]
    lead = tuple(range(gate_e.dim() - 1))
    density = F.one_hot(gate_e[..., 0], E).to(F32).mean(dim=lead)
    router_prob = probs.reshape(-1, E).mean(0)
    return {"load_balance_loss": E * torch.sum(density * router_prob),
            "dropped_frac": 1.0 - keep.to(F32).mean()}


def _experts(params: Dict[str, torch.Tensor], slabs: torch.Tensor) -> torch.Tensor:
    """SwiGLU of every expert's slab: ``slabs`` (E, C', D) -> (E, C', D)."""
    dt = slabs.dtype
    g = F.silu(torch.bmm(slabs, params["we_gate"].to(dt)).to(F32)).to(dt)
    u = torch.bmm(slabs, params["we_up"].to(dt))
    return torch.bmm(g * u, params["we_down"].to(dt))


def scatter_rows(slot: torch.Tensor, rows: torch.Tensor, n: int, dummy: int = 0
             ) -> torch.Tensor:
    """The reference's scatter-add of ``rows`` into ``n`` zero rows at
    ``slot``: a kept slot takes one row, so its sum is the row plus 0
    (which turns -0 into +0), written by assignment; the dummy slots
    (the last row of each ``dummy``-row group, or the last row) sum the
    dropped rows, which nothing reads, and stay 0."""
    last = (slot + 1) % dummy == 0 if dummy else slot == n - 1
    # Dropped rows go to a spare row n, cut off after: no boolean indexing,
    # so the shapes do not depend on the routing (a meta-tensor dry run).
    out = torch.zeros((n + 1, rows.shape[1]), dtype=rows.dtype, device=rows.device)
    out.index_put_((torch.where(last, torch.full_like(slot, n), slot),), rows + 0.0)
    return out[:n]


def dispatch_combine(params: Dict[str, torch.Tensor], xt: torch.Tensor,
                     r: Routing, C: int) -> torch.Tensor:
    """Scatter, experts and gather of ``xt`` (N, D) under routing ``r``
    (one group): the layer's output (N, D) in ``xt``'s type."""
    N, D = xt.shape
    E = params["router"].shape[1]
    k = r.gate_e.shape[-1]
    keep = r.rank < C
    slot = torch.where(keep, r.gate_e * C + r.rank, torch.full_like(r.rank, E * C))
    flat = slot.reshape(-1)
    disp = scatter_rows(flat, xt.repeat_interleave(k, dim=0), E * C + 1)
    y_slabs = _experts(params, disp[:-1].reshape(E, C, D))
    y_flat = torch.cat([y_slabs.reshape(E * C, D),
                        torch.zeros((1, D), dtype=xt.dtype, device=xt.device)])
    per_k = y_flat.index_select(0, flat).reshape(N, k, D)
    w = (r.gate_w * keep.to(F32)).to(xt.dtype)
    return torch.einsum("nkd,nk->nd", per_k, w)


def _dispatch_combine(params, xt, top_k, C, routing: Optional[Routing] = None,
                      gate_e: Optional[torch.Tensor] = None):
    """The shared scatter/experts/gather core: ``xt`` (N, D) -> (y, aux)."""
    r = _decide(params, xt, top_k, routing, gate_e)
    y = dispatch_combine(params, xt, r, C)
    return y, _aux(r.probs, r.gate_e, r.rank < C)


def _dispatch_combine_grouped(params, xt, top_k, C, G,
                              routing: Optional[Routing] = None,
                              gate_e: Optional[torch.Tensor] = None):
    """Local dispatch: ranks and drops within ``G`` groups of tokens, each
    with capacity ``C // G`` rounded up to 8, the slabs of all groups in
    one batched product per weight."""
    N, D = xt.shape
    E = params["router"].shape[1]
    Ng = N // G
    Cg = max(8, -(-(C // G) // 8) * 8)
    xg = xt.reshape(G, Ng, D)
    r = _decide(params, xg, top_k, routing, gate_e)
    keep = r.rank < Cg
    stride = E * Cg + 1
    gidx = torch.arange(G, device=xt.device)[:, None, None]
    slot = torch.where(keep, gidx * stride + r.gate_e * Cg + r.rank,
                       gidx * stride + E * Cg)
    flat = slot.reshape(-1)
    disp = scatter_rows(flat, xg.reshape(G * Ng, D).repeat_interleave(top_k, dim=0),
                    G * stride, dummy=stride)
    slabs = disp.reshape(G, stride, D)[:, :E * Cg].reshape(G, E, Cg, D)
    # Every group's rows of expert e in one (E, G Cg, D) batch.
    y = _experts(params, slabs.transpose(0, 1).reshape(E, G * Cg, D))
    y_slabs = y.reshape(E, G, Cg, D).transpose(0, 1).reshape(G, E * Cg, D)
    pad = torch.zeros((G, 1, D), dtype=xt.dtype, device=xt.device)
    y_flat = torch.cat([y_slabs, pad], dim=1).reshape(G * stride, D)
    per_k = y_flat.index_select(0, flat).reshape(G, Ng, top_k, D)
    w = (r.gate_w * keep.to(F32)).to(xt.dtype)
    out = torch.einsum("gnkd,gnk->gnd", per_k, w).reshape(N, D)
    return out, _aux(r.probs, r.gate_e, keep)


def moe_layer(params: Dict[str, torch.Tensor], x: torch.Tensor, *, top_k: int,
              capacity_factor: float = 1.25, local_groups: int = 0,
              routing: Optional[Routing] = None, gate_e: Optional[torch.Tensor] = None
              ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """``x`` (B, S, D) -> (y, aux), aux holding the load-balance loss and
    the dropped share.  Capacity counts every token of the batch, padding
    included, as the reference does.  ``local_groups > 0`` (dividing B S)
    ranks and drops within that many groups.  ``routing`` replaces the
    layer's own (:func:`route` of :func:`router_logits`; grouped ``(G,
    N/G, ...)`` leaves with ``local_groups``).  ``gate_e`` (int64, shaped
    as ``routing.gate_e``) fixes the experts only: their probabilities,
    weights and ranks come from the layer's own logits, so a gradient
    reaches the router.  At most one of the two is given."""
    if routing is not None and gate_e is not None:
        raise ValueError("moe_layer: give routing= or gate_e=, not both")
    if gate_e is not None:
        gate_e = gate_e.to(x.device)
    B, S, D = x.shape
    N = B * S
    C = capacity_for(N, params["router"].shape[1], top_k, capacity_factor)
    xt = x.reshape(N, D)
    if local_groups and N % local_groups == 0:
        y, aux = _dispatch_combine_grouped(params, xt, top_k, C, local_groups,
                                           routing, gate_e)
    else:
        y, aux = _dispatch_combine(params, xt, top_k, C, routing, gate_e)
    return y.reshape(B, S, D), aux


class MoE(nn.Module):
    """A block's MoE MLP: the :func:`moe_init` weights as parameters."""

    def __init__(self, d_model: int, n_experts: int, d_ff: int, gen=None,
                 device=None):
        super().__init__()
        for name, p in moe_init(d_model, n_experts, d_ff, gen, device).items():
            setattr(self, name, p)

    def params(self) -> Dict[str, torch.Tensor]:
        return {n: getattr(self, n) for n in ("router", "we_gate", "we_up", "we_down")}

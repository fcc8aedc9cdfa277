"""Dataflow actors — paper §2.2 and §3.1.

An actor has the mandatory ``fire`` function and optional ``init``,
``control`` and ``finish`` functions.  *Static* actors consume/produce the
channel rate ``r`` on every port on every firing; *dynamic* actors have one
control port (rate 1) whose token pins every regular port to rate 0 or r
for that firing.

In the port a firing runs eagerly: ``control`` receives the control token
as a list of host numbers and returns host ints, so rates are concrete
and a rate-0 term is dropped instead of multiplied by 0.

A dynamic actor also declares the form of each enable (``enables``): the
constant 0 or 1, or ``int(tok[word] > threshold)`` as the pair ``(word,
threshold)``.  It is the port's counterpart of the reference's
canonicalised enable expressions (``src/repro/core/builder.py:150-153``):
the matched-rates proof compares forms, and the megakernel computes rates
from them for any token value, where evaluating ``control`` would need
every token enumerated.  ``NetworkBuilder.build`` checks each form against
``control``.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Mapping, Optional, Sequence, Tuple, Union

import torch

# fire(state, inputs: {port: (r, *tok_shape)}, rates: {port: 0/1}) ->
#     (new_state, outputs: {port: (r, *tok_shape)})
FireFn = Callable[[Any, Mapping[str, torch.Tensor], Mapping[str, int]],
                  Tuple[Any, Dict[str, torch.Tensor]]]
# control(token as a list of host numbers) -> {port: 0/1} for every regular port.
ControlFn = Callable[[Sequence[Any]], Dict[str, int]]
# A declared enable: the constant 0 or 1, or (word, threshold) for
# int(tok[word] > threshold).
EnableForm = Union[int, Tuple[int, int]]

#: Op kinds the persistent scheduler kernel (B2) runs as device functions.
DEVICE_OP_KINDS = ("source", "config", "fork", "poly", "adder", "sink",
                   "gauss", "thres", "med", "router", "expert", "combine",
                   "packer", "admission", "gate", "merge", "retire", "step")


@dataclasses.dataclass(frozen=True, eq=False)
class DeviceOp:
    """What an actor computes, declared for the megakernel backend.

    The reference's megakernel traces each actor's Python ``fire`` into a
    jaxpr and lifts the arrays its closure captures into kernel operands
    (``_hoist_consts``).  Torch has no jaxpr to lift closures from, so a
    graph declares here which device function of the persistent kernel
    runs its actor, with the closure data that function needs (tensors and
    ints in ``params``).  Everything else the function reads is the
    actor's state, as ``fire`` reads it.  The host executors ignore it.

    Kinds: ``"source"`` (``n_firings``, ``planes``: ready while its index
    ``idx`` is below ``n_firings``, copies window ``idx`` of its state's
    staged slab), ``"config"`` (``schedule``, an int32 tensor, and
    ``n_firings``: ready likewise, emits ``schedule[idx]`` on every
    output),
    ``"fork"`` (copies its input to each enabled output), ``"poly"``
    (``order``: basis and 10-tap FIR on its ``(hist, taps)`` state),
    ``"adder"`` (``terms``: its input ports in summation order),
    ``"sink"`` (``planes``: stores window ``idx`` into its state's slab),
    and motion detection's ``"gauss"`` (the blur of every u8 frame of its
    window, rounded to u8, to each output), ``"thres"`` (``threshold``:
    the motion map of its ``cur`` and ``prev`` windows) and ``"med"`` (the
    plus-shaped median of every frame), and the MoE layer's
    ``"router"`` (``router``, the bf16 ``(D, E)`` weight, and ``N``,
    ``k``, ``C``, ``E``, ``D``: logits, softmax, top-k, capacity ranks,
    the counts on its control outputs, the dispatched slabs, slots and
    combine weights), ``"expert"`` (``we_gate``, ``we_up``, ``we_down``,
    its bf16 ``(D, F)``, ``(D, F)`` and ``(F, D)`` weights, and ``C``,
    ``D``, ``F``: the SwiGLU FFN of its slab), ``"combine"`` (``N``,
    ``k``, ``C``, ``E``, ``D``: the weighted gather of the enabled experts'
    rows) and ``"packer"`` (``E``: the counts, twice, as one control
    token).

    The serving network's (``graphs/serving.py``): ``"admission"``
    (``prompts`` (R, P), ``budgets``, ``arrivals`` and ``deadlines`` (R,),
    int32 tensors, and ``B``, ``P``, ``N``, ``R``, ``qd``; its state is
    ``taken`` (R,) int32 and the ints ``t`` and ``retired``: frees the
    finished slots, admits, sheds and times out, writes the slot table to
    its first two outputs, the finished rows to its third and one control
    token ``[n_active, n_finished, n_admitted]`` to every other output; it
    is ready while ``retired < R``), ``"gate"`` (input k copied to output k
    under its enables), ``"merge"`` (``eos``, ``P``, ``N``: the decoded
    tokens folded into the slot table, EOS or an exhausted budget
    detected) and ``"retire"`` (``R``, ``P``, ``N``: the finished rows
    scattered into its five (R, .) int32 state tensors by request id, rows
    that are not finished dropped).  ``"step"`` runs no device body: the
    kernel stops at an enabled firing, the runner calls the actor's own
    ``fire`` on the staged windows, and the kernel goes on where it stopped
    (a decode step, an LM stage).

    A source's or sink's slab holds its windows in ``planes`` planes, each
    the run of every window's part of that plane: DPD's ``(2, k * L)``
    (re, im) slab has 2, motion detection's ``(n_frames, H, W)`` video 1.
    """

    kind: str
    params: Mapping[str, Any] = dataclasses.field(default_factory=dict)

    def __post_init__(self) -> None:
        if self.kind not in DEVICE_OP_KINDS:
            raise ValueError(f"DeviceOp kind must be one of {DEVICE_OP_KINDS}, "
                             f"got {self.kind!r}")
        object.__setattr__(self, "params", dict(self.params))


@dataclasses.dataclass(frozen=True)
class ActorSpec:
    """Static description of one actor.

    Attributes:
      name:         unique actor name.
      in_ports:     regular input ports (the control port excluded).
      out_ports:    output ports.
      fire:         the firing function (paper §3.1).
      control_port: name of the control input port; None for static actors.
      control:      control token -> per-port 0/1 enables; required iff
                    ``control_port``.
      init:         optional state constructor, run at ``init_state``.
      finish:       optional hook run on the final state (sinks).
      ready:        optional ``state -> bool`` readiness predicate on host
                    values (sources signal exhaustion with it).
      cost_flops:   per-firing FLOP estimate.
      device_op:    the :class:`DeviceOp` the megakernel backend runs for
                    this actor; None keeps the actor off that backend.
      enables:      a dynamic actor's declared enable form per regular
                    port (:data:`EnableForm`); None when undeclared.
    """

    name: str
    in_ports: Tuple[str, ...]
    out_ports: Tuple[str, ...]
    fire: FireFn
    control_port: Optional[str] = None
    control: Optional[ControlFn] = None
    init: Optional[Callable[[], Any]] = None
    finish: Optional[Callable[[Any], Any]] = None
    ready: Optional[Callable[[Any], bool]] = None
    cost_flops: int = 0
    device_op: Optional[DeviceOp] = None
    enables: Optional[Mapping[str, EnableForm]] = None

    def __post_init__(self) -> None:
        if self.control_port is not None and self.control is None:
            raise ValueError(f"actor {self.name}: dynamic actor needs a control function")
        if self.control_port is None and self.control is not None:
            raise ValueError(f"actor {self.name}: control function without control port")
        if self.control_port in self.in_ports:
            raise ValueError(
                f"actor {self.name}: control port {self.control_port!r} must "
                "not be listed among regular in_ports")
        names = list(self.in_ports) + list(self.out_ports)
        if len(set(names)) != len(names):
            raise ValueError(f"actor {self.name}: duplicate port names {names}")
        if self.enables is not None:
            if self.control_port is None:
                raise ValueError(f"actor {self.name}: enables declared on a "
                                 "static actor")
            if set(self.enables) != set(names):
                raise ValueError(
                    f"actor {self.name}: enables must declare every regular "
                    f"port {sorted(names)}, got {sorted(self.enables)}")
            forms = {}
            for p, form in self.enables.items():
                if isinstance(form, tuple):
                    word, thr = (int(x) for x in form)
                    if word < 0:
                        raise ValueError(f"actor {self.name}: port {p!r} "
                                         f"enable word {word} is negative")
                    forms[p] = (word, thr)
                elif int(form) in (0, 1):
                    forms[p] = int(form)
                else:
                    raise ValueError(
                        f"actor {self.name}: port {p!r} enable {form!r} is "
                        "neither 0, 1 nor a (word, threshold) pair")
            object.__setattr__(self, "enables", forms)

    @property
    def is_dynamic(self) -> bool:
        return self.control_port is not None

    @property
    def is_source(self) -> bool:
        """Zero input ports (paper §2.2); the control port counts as one."""
        return not self.in_ports and self.control_port is None

    @property
    def is_sink(self) -> bool:
        return not self.out_ports

    def all_in_ports(self) -> Tuple[str, ...]:
        if self.control_port is not None:
            return (self.control_port,) + tuple(self.in_ports)
        return tuple(self.in_ports)

    def rates_for(self, ctrl_token: Optional[Sequence[Any]]) -> Dict[str, int]:
        """Evaluate the control function -> {port: 0/1}; static actors
        enable every port."""
        if not self.is_dynamic:
            return {p: 1 for p in (*self.in_ports, *self.out_ports)}
        rates = {k: int(v) for k, v in self.control(ctrl_token).items()}
        missing = (set(self.in_ports) | set(self.out_ports)) - set(rates)
        if missing:
            raise ValueError(
                f"actor {self.name}: control() must set a rate for every "
                f"regular port; missing {sorted(missing)}")
        return rates

    def init_state(self) -> Any:
        return self.init() if self.init is not None else ()


def static_actor(name: str, in_ports, out_ports, fire: FireFn, **kw) -> ActorSpec:
    """Constructor for static-rate actors."""
    return ActorSpec(name=name, in_ports=tuple(in_ports),
                     out_ports=tuple(out_ports), fire=fire, **kw)


def dynamic_actor(name: str, control_port: str, control: ControlFn,
                  in_ports, out_ports, fire: FireFn, **kw) -> ActorSpec:
    """Constructor for dynamic-rate actors (the paper's contribution)."""
    return ActorSpec(name=name, in_ports=tuple(in_ports),
                     out_ports=tuple(out_ports), fire=fire,
                     control_port=control_port, control=control, **kw)


def eval_enable(form: EnableForm, tok: Sequence[Any]) -> int:
    """A declared enable on a control token (a list of host numbers)."""
    if isinstance(form, tuple):
        return int(tok[form[0]] > form[1])
    return form


def apply_rate_gate(rate: int, window: torch.Tensor) -> Optional[torch.Tensor]:
    """Gate a window by its 0/1 rate: the window for 1, ``None`` (drop the
    term) for 0.  On finite windows this gives the same bits as the
    reference's multiply by the traced 0/1 flag."""
    return window if rate else None

"""Declarative network construction — the paper's §3.1/§3.4 host API.

::

    b = NetworkBuilder()
    b.actors(source, amp, sink, ctl)
    b.connect("source.out", "amp.in", rate=2, token_shape=(4,))
    b.connect("ctl.out", "amp.c", domain=(0, 3))   # control: inferred
    net = b.build(device="cpu")

One ``connect`` declares a ``FifoSpec`` and its ``Edge``; Eq. 1 capacities
are derived, ``is_control`` is inferred from the destination port, and
``matched_rates`` (the transient-channel declaration behind register
allocation in the specialized static schedule) is derived at ``build()``
when provable.

**The matched-rates proof.**  The reference reads the control functions'
jaxprs; torch has none, so the port reads the enable forms a dynamic actor
declares (``ActorSpec.enables``: the constant 0 or 1, or ``int(tok[word]
> threshold)``), and falls back to evaluation for one that declares none:

* an enable of a static actor's port is the constant 1;
* a declared form is the constant it names, or the symbolic
  ``(word, threshold)``; ``build`` checks every declared form against
  ``control`` (over the control channel's declared domain where it has an
  enumerable one, else at each threshold, its two neighbours and the int32
  extremes) and raises on a mismatch;
* an undeclared enable is ``control(tok)[port]`` evaluated for every token
  value of the control channel's declared ``domain`` (single-element
  integer tokens): constant over the domain, that constant, else the
  table ``{value: enable}``; no declared domain, no proof;
* two constant enables match when equal; two forms when equal, two tables
  when they agree on every value both domains admit, and either only when
  their control channels are fed by ports of one actor that provably emit
  the same value;
* the feeder proof fires the feeding actor once from its initial state,
  on zero windows made on the network's device, and requires both ports
  to return the *same tensor object* — the eager analogue of the
  reference's "same jaxpr variable" rule, equally conservative on
  distinct-but-equal values.  Like the reference it assumes the body's
  aliasing does not depend on the data.

Channels between two static actors are never marked (the reference keeps
them buffered); static-producer control channels are register-allocated by
``Network`` itself.
"""
from __future__ import annotations

import dataclasses
import difflib
import math
from typing import Any, Dict, List, Optional, Sequence, Tuple

import torch

from repro_torch.core.actor import ActorSpec, eval_enable
from repro_torch.core.fifo import FifoSpec
from repro_torch.core.network import Edge, Network
from repro_torch.device import DeviceLike, resolve_device

# Largest control domain the proof enumerates.
_MAX_DOMAIN_VALUES = 1 << 16


def _suggest(name: str, known: Sequence[str]) -> str:
    close = difflib.get_close_matches(name, list(known), n=2)
    hint = f"; did you mean {' or '.join(map(repr, close))}?" if close else ""
    return f"known: {sorted(known)}{hint}"


@dataclasses.dataclass(frozen=True)
class _Connection:
    """One declared channel, pre-Network: spec + endpoint binding."""

    spec: FifoSpec
    edge: Edge
    matched_override: Optional[bool]   # None = derive at build()
    initial_token: Optional[Any]


# --------------------------------------------------------------------------- #
# matched_rates derivation.
# --------------------------------------------------------------------------- #
def domain_values(spec: FifoSpec) -> Optional[range]:
    """Every token value of a single-element integer control channel's
    declared domain, or None when it cannot be enumerated."""
    if spec.domain is None or tuple(spec.token_shape) != (1,):
        return None
    if spec.dtype.is_floating_point or spec.dtype.is_complex:
        return None
    lo, hi = math.ceil(spec.domain[0]), math.floor(spec.domain[1])
    if hi - lo + 1 > _MAX_DOMAIN_VALUES:
        return None
    return range(lo, hi + 1)


def _enable_expr(actor: ActorSpec, port: str,
                 ctl_spec: Optional[FifoSpec],
                 ctl_feed: Optional[Tuple[str, str]]):
    """Classify a port's enable as ``("const", v)``, ``("form", (word,
    threshold), feed)`` for a declared token-dependent one, or
    ``("table", {token value: enable}, feed)`` for an undeclared one; None
    when unprovable (no control channel yet, no declared form and no
    enumerable domain)."""
    if not actor.is_dynamic:
        return ("const", 1)
    if actor.enables is not None:
        form = actor.enables[port]
        if not isinstance(form, tuple):
            return ("const", form)
        return None if ctl_feed is None else ("form", form, ctl_feed)
    if ctl_spec is None or ctl_feed is None:
        return None
    values = domain_values(ctl_spec)
    if values is None or len(values) == 0:
        return None
    table = {v: int(actor.control([v])[port]) for v in values}
    enables = set(table.values())
    if len(enables) == 1:
        return ("const", enables.pop())
    return ("table", table, ctl_feed)


def _ports_provably_equal(actor: ActorSpec, p1: str, p2: str,
                          in_specs: Dict[str, FifoSpec],
                          device: torch.device) -> bool:
    """True when one firing of ``actor`` from its initial state returns the
    very same tensor object on ``p1`` and ``p2`` (inputs: zero windows where
    the channels keep their rings on ``device``, every port enabled)."""
    if p1 == p2:
        return True
    ins = {}
    for p in actor.in_ports:
        spec = in_specs.get(p)
        if spec is None:
            return False
        ins[p] = torch.zeros((spec.rate,) + tuple(spec.token_shape),
                             dtype=spec.dtype, device=spec.ring_device(device))
    ones = {p: 1 for p in (*actor.in_ports, *actor.out_ports)}
    _, outs = actor.fire(actor.init_state(), ins, ones)
    o1, o2 = outs.get(p1), outs.get(p2)
    return isinstance(o1, torch.Tensor) and o1 is o2


def derive_matched_rates(src: ActorSpec, dst: ActorSpec, src_env, dst_env,
                         feeder_equal) -> bool:
    """Whether a delay-free data channel's two ports are provably enabled
    together (the ``FifoSpec.matched_rates`` invariant); see the module
    docstring for the cases."""
    if not (src.is_dynamic or dst.is_dynamic):
        return False
    if src_env is None or dst_env is None:
        return False
    if src_env[0] == "const" and dst_env[0] == "const":
        return src_env[1] == dst_env[1]
    if src_env[0] == dst_env[0] == "form":
        _, s_form, (s_actor, s_port) = src_env
        _, d_form, (d_actor, d_port) = dst_env
        if s_form != d_form or s_actor != d_actor:
            return False
        return feeder_equal(s_actor, s_port, d_port)
    if src_env[0] == dst_env[0] == "table":
        _, s_table, (s_actor, s_port) = src_env
        _, d_table, (d_actor, d_port) = dst_env
        common = set(s_table) & set(d_table)
        if s_actor != d_actor or not common:
            return False
        if any(s_table[v] != d_table[v] for v in common):
            return False
        return feeder_equal(s_actor, s_port, d_port)
    return False  # const vs token-dependent, or form vs table: can diverge


_INT32 = (-2 ** 31, 2 ** 31 - 1)


def probe_tokens(actor: ActorSpec, spec: FifoSpec) -> List[List[int]]:
    """The control tokens the declared forms are checked on: every value
    of an enumerable declared domain; otherwise, for each word a form
    reads, each threshold, its two neighbours and the int32 extremes in
    that word (the others 0), and each such value in every word."""
    n = math.prod(spec.token_shape)
    values = domain_values(spec)
    if values is not None and len(values):
        return [[v] for v in values]
    probes = {_INT32[0], _INT32[1], 0}
    words = set()
    for form in actor.enables.values():
        if isinstance(form, tuple):
            words.add(form[0])
            probes.update(min(max(form[1] + d, _INT32[0]), _INT32[1])
                          for d in (-1, 0, 1))
    toks = [[v] * n for v in sorted(probes)]
    for w in sorted(words):
        for v in sorted(probes):
            t = [0] * n
            t[w] = v
            toks.append(t)
    return toks


def check_declared_enables(actor: ActorSpec, spec: FifoSpec) -> None:
    """Raise when a declared enable form disagrees with ``control`` on any
    probe token (:func:`probe_tokens`) or reads past the token."""
    n = math.prod(spec.token_shape)
    for p, form in actor.enables.items():
        if isinstance(form, tuple) and form[0] >= n:
            raise ValueError(
                f"actor {actor.name!r}: port {p!r} declares an enable on word "
                f"{form[0]} of its {n}-word control token")
    for tok in probe_tokens(actor, spec):
        got = {p: int(bool(e)) for p, e in actor.control(tok).items()}
        for p, form in actor.enables.items():
            want = eval_enable(form, tok)
            if got.get(p) != want:
                raise ValueError(
                    f"actor {actor.name!r}: port {p!r} declares enable "
                    f"{form!r}, which gives {want} on control token "
                    f"{tok[:8]}{'...' if len(tok) > 8 else ''}, but "
                    f"control() gives {got.get(p)}")


# --------------------------------------------------------------------------- #
# PRUNE-style buffer-bound analysis (arXiv:1802.06625): decide per channel,
# from declared or derived enable-fraction bounds, whether the Eq. 1
# capacity provably suffices.  Overflow and starvation become build errors
# for decidable graphs and stay runtime guard flags (core/health.py) for
# the rest.
# --------------------------------------------------------------------------- #
@dataclasses.dataclass(frozen=True)
class ChannelBounds:
    """One channel's enable-fraction bounds and the verdict they prove.

    ``src_bounds`` / ``dst_bounds`` are ``(lo, hi)`` fractions of firings
    in which the producing / consuming port is enabled (1.0: every
    firing).  Verdicts: ``"balanced"`` (production provably equals
    consumption), ``"unbounded"`` (the producer's floor exceeds the
    consumer's ceiling), ``"starved"`` (the consumer's floor exceeds the
    producer's ceiling), ``"undecided"`` (token-dependent enables with no
    declared bounds: the runtime guards own the channel).
    """

    fifo: str
    src: str
    dst: str
    src_bounds: Tuple[float, float]
    dst_bounds: Tuple[float, float]
    verdict: str

    def describe(self) -> str:
        return (f"channel {self.fifo!r} ({self.src} -> {self.dst}): "
                f"{self.verdict} [producer enabled "
                f"{self.src_bounds[0]:g}..{self.src_bounds[1]:g} of "
                f"firings, consumer {self.dst_bounds[0]:g}.."
                f"{self.dst_bounds[1]:g}]")


@dataclasses.dataclass(frozen=True)
class BoundsReport:
    """Per-channel verdicts of :meth:`NetworkBuilder.check_bounds`."""

    channels: Tuple[ChannelBounds, ...]

    def violations(self) -> Tuple[ChannelBounds, ...]:
        return tuple(c for c in self.channels
                     if c.verdict in ("unbounded", "starved"))

    def undecided(self) -> Tuple[ChannelBounds, ...]:
        return tuple(c for c in self.channels if c.verdict == "undecided")

    def describe(self) -> str:
        return "\n".join(c.describe() for c in self.channels)


# --------------------------------------------------------------------------- #
# The builder.
# --------------------------------------------------------------------------- #
class NetworkBuilder:
    """Incremental, validating construction surface for actor networks."""

    def __init__(self) -> None:
        self._actors: Dict[str, ActorSpec] = {}
        self._connections: List[_Connection] = []
        self._fifo_names: set = set()
        self._used_out: Dict[Tuple[str, str], str] = {}
        self._used_in: Dict[Tuple[str, str], str] = {}
        self._rate_bounds: Dict[Tuple[str, str], Tuple[float, float]] = {}
        self.bounds_report: Optional[BoundsReport] = None

    def actor(self, spec: ActorSpec) -> ActorSpec:
        """Register an actor; registration order is the network's actor
        order (and so the state layout and the dynamic visit order)."""
        if not isinstance(spec, ActorSpec):
            raise TypeError(
                f"NetworkBuilder.actor() takes an ActorSpec, got "
                f"{type(spec).__name__}; build one with static_actor(...) "
                "or dynamic_actor(...)")
        if spec.name in self._actors:
            raise ValueError(
                f"actor {spec.name!r} already registered; actor names must "
                "be unique within a network")
        self._actors[spec.name] = spec
        return spec

    def actors(self, *specs: ActorSpec) -> "NetworkBuilder":
        for s in specs:
            self.actor(s)
        return self

    def _parse(self, endpoint: str, kind: str) -> Tuple[str, str]:
        if not isinstance(endpoint, str) or endpoint.count(".") != 1:
            raise ValueError(
                f"{kind} endpoint {endpoint!r} must be an 'actor.port' "
                "string (exactly one dot)")
        actor, port = endpoint.split(".")
        if actor not in self._actors:
            raise ValueError(
                f"{kind} endpoint {endpoint!r}: unknown actor {actor!r} — "
                f"register it with b.actor(...) first; "
                f"{_suggest(actor, self._actors)}")
        return actor, port

    def connect(self, src: str, dst: str, *,
                rate: int = 1,
                token_shape: Optional[Tuple[int, ...]] = None,
                dtype: Any = None,
                capacity: Optional[int] = None,
                delay: int = 0,
                control: Optional[bool] = None,
                name: Optional[str] = None,
                matched_rates: Optional[bool] = None,
                initial_token: Optional[Any] = None,
                domain: Optional[Tuple[float, float]] = None,
                row_id_col: Optional[int] = None) -> str:
        """Declare one channel ``src("actor.port") -> dst("actor.port")``.

        ``name`` defaults to ``"src.port->dst.port"``; control channels
        (inferred from the destination port) default to a ``(1,)`` int32
        token; ``capacity`` is derived from Eq. 1 and only asserted;
        ``matched_rates=None`` defers to the derivation at ``build()``;
        ``domain=(lo, hi)`` declares the token values, which the
        derivation enumerates; ``row_id_col`` names the id column of
        record-row tokens (``FifoSpec.row_id_col``).  Returns the channel
        name.
        """
        src_actor, src_port = self._parse(src, "source")
        dst_actor, dst_port = self._parse(dst, "destination")
        sa, da = self._actors[src_actor], self._actors[dst_actor]
        if src_port not in sa.out_ports:
            raise ValueError(
                f"connect({src!r}, {dst!r}): actor {src_actor!r} has no "
                f"output port {src_port!r}; {_suggest(src_port, sa.out_ports)}")
        if dst_port not in da.all_in_ports():
            raise ValueError(
                f"connect({src!r}, {dst!r}): actor {dst_actor!r} has no "
                f"input port {dst_port!r}; "
                f"{_suggest(dst_port, da.all_in_ports())}")
        if (src_actor, src_port) in self._used_out:
            raise ValueError(
                f"connect({src!r}, {dst!r}): output port {src!r} is already "
                f"connected by channel {self._used_out[(src_actor, src_port)]!r}; "
                "the MoC allows exactly one reader per channel — add a fork "
                "actor to fan out")
        if (dst_actor, dst_port) in self._used_in:
            raise ValueError(
                f"connect({src!r}, {dst!r}): input port {dst!r} is already "
                f"connected by channel {self._used_in[(dst_actor, dst_port)]!r}; "
                "the MoC allows exactly one writer per channel — add a merge "
                "actor to fan in")
        is_control = dst_port == da.control_port
        if control is not None and bool(control) != is_control:
            raise ValueError(
                f"connect({src!r}, {dst!r}): control={control} but "
                f"{dst_port!r} {'is not' if control else 'IS'} the control "
                f"port of {dst_actor!r}; control channels are inferred from "
                "the destination port")
        if is_control:
            if rate != 1:
                raise ValueError(
                    f"connect({src!r}, {dst!r}): control channels must have "
                    f"token rate 1 (paper §2.2), got rate={rate}")
            if delay:
                raise ValueError(
                    f"connect({src!r}, {dst!r}): control channels cannot "
                    "carry delay tokens")
            token_shape = (1,) if token_shape is None else token_shape
            dtype = torch.int32 if dtype is None else dtype
        else:
            if token_shape is None:
                raise ValueError(
                    f"connect({src!r}, {dst!r}): data channels need an "
                    "explicit token_shape=")
            dtype = torch.float32 if dtype is None else dtype
        if name is None:
            name = f"{src}->{dst}"
        if name in self._fifo_names:
            raise ValueError(
                f"connect({src!r}, {dst!r}): channel name {name!r} already "
                "used; pass a unique name=")
        spec = FifoSpec(name, rate, tuple(token_shape), dtype, delay=delay,
                        is_control=is_control, domain=domain,
                        matched_rates=bool(matched_rates), row_id_col=row_id_col)
        if capacity is not None and capacity != spec.capacity_tokens:
            raise ValueError(
                f"connect({src!r}, {dst!r}): capacity={capacity} contradicts "
                f"the Eq. 1 law — rate {rate} with delay {delay} allocates "
                f"{spec.capacity_tokens} tokens "
                f"({'3r+1' if delay else '2r'}); capacities are derived, not "
                "chosen")
        if initial_token is not None and not delay:
            raise ValueError(
                f"connect({src!r}, {dst!r}): initial_token needs delay=1 "
                "(initial tokens live on delay channels, paper §2.2)")
        edge = Edge(name, src_actor, src_port, dst_actor, dst_port)
        self._connections.append(_Connection(spec, edge, matched_rates,
                                             initial_token))
        self._fifo_names.add(name)
        self._used_out[(src_actor, src_port)] = name
        self._used_in[(dst_actor, dst_port)] = name
        return name

    def dangling_ports(self) -> List[str]:
        """Every declared-but-unconnected port, as ``actor.port`` strings."""
        out = []
        for a in self._actors.values():
            for p in a.all_in_ports():
                if (a.name, p) not in self._used_in:
                    out.append(f"{a.name}.{p}")
            for p in a.out_ports:
                if (a.name, p) not in self._used_out:
                    out.append(f"{a.name}.{p}")
        return out

    def _control_feed(self, actor: ActorSpec):
        """(feeder (actor, port), control FifoSpec) of a dynamic actor."""
        for c in self._connections:
            e = c.edge
            if e.dst_actor == actor.name and e.dst_port == actor.control_port:
                return (e.src_actor, e.src_port), c.spec
        return None, None

    def _derive_matched(self, device: torch.device) -> Dict[str, bool]:
        in_specs: Dict[str, Dict[str, FifoSpec]] = {n: {} for n in self._actors}
        for c in self._connections:
            in_specs[c.edge.dst_actor][c.edge.dst_port] = c.spec
        env_cache: Dict[Tuple[str, str], Any] = {}

        def env(actor_name: str, port: str):
            key = (actor_name, port)
            if key not in env_cache:
                a = self._actors[actor_name]
                feed, cspec = self._control_feed(a)
                env_cache[key] = _enable_expr(a, port, cspec, feed)
            return env_cache[key]

        feeder_cache: Dict[Tuple[str, str, str], bool] = {}

        def feeder_equal(actor_name: str, pa: str, pb: str) -> bool:
            key = (actor_name, *sorted((pa, pb)))
            if key not in feeder_cache:
                feeder_cache[key] = _ports_provably_equal(
                    self._actors[actor_name], pa, pb, in_specs[actor_name], device)
            return feeder_cache[key]

        out: Dict[str, bool] = {}
        for c in self._connections:
            if c.matched_override is not None:
                out[c.spec.name] = c.matched_override
                continue
            if c.spec.is_control or c.spec.delay:
                out[c.spec.name] = False
                continue
            e = c.edge
            out[c.spec.name] = derive_matched_rates(
                self._actors[e.src_actor], self._actors[e.dst_actor],
                env(e.src_actor, e.src_port), env(e.dst_actor, e.dst_port),
                feeder_equal)
        return out

    # -- PRUNE-style bound proofs ----------------------------------------- #
    def rate_bounds(self, endpoint: str, lo: float,
                    hi: float) -> "NetworkBuilder":
        """Declare the fraction of firings in which the dynamic port
        ``endpoint`` ("actor.port") is enabled: ``(0.0, 1.0)`` is the
        vacuous default, ``(1.0, 1.0)`` pins the port always on.  Returns
        ``self``."""
        actor, port = self._parse(endpoint, "rate_bounds")
        a = self._actors[actor]
        ports = (*a.all_in_ports(), *a.out_ports)
        if port not in ports:
            raise ValueError(
                f"rate_bounds({endpoint!r}): actor {actor!r} has no port "
                f"{port!r}; {_suggest(port, ports)}")
        if not (0.0 <= lo <= hi <= 1.0):
            raise ValueError(
                f"rate_bounds({endpoint!r}): bounds must satisfy "
                f"0 <= lo <= hi <= 1 (fractions of firings), got "
                f"lo={lo}, hi={hi}")
        self._rate_bounds[(actor, port)] = (float(lo), float(hi))
        return self

    def _port_bounds(self, actor_name: str, port: str,
                     env) -> Tuple[float, float]:
        """Enable-fraction bounds of one port, most precise source first:
        declared ``rate_bounds``, control port, static actor, provably
        constant enable, else unknown."""
        a = self._actors[actor_name]
        declared = self._rate_bounds.get((actor_name, port))
        if declared is not None:
            return declared
        if port == a.control_port or not a.is_dynamic:
            return (1.0, 1.0)
        e = env(actor_name, port)
        if e is not None and e[0] == "const":
            v = 1.0 if e[1] > 0 else 0.0
            return (v, v)
        return (0.0, 1.0)

    def check_bounds(self, device: DeviceLike = None) -> BoundsReport:
        """The per-channel bound analysis, without building: matched-rates
        proofs (``"balanced"``), constant enables and declared
        :meth:`rate_bounds` give each channel a :class:`ChannelBounds`
        verdict.  ``device`` is where the feeder proof makes its zero
        windows: :meth:`build` passes the network's device; None makes them
        on the CPU.  The report is also kept as ``self.bounds_report``."""
        matched = self._derive_matched(torch.device("cpu") if device is None
                                       else torch.device(device))
        env_cache: Dict[Tuple[str, str], Any] = {}

        def env(actor_name: str, port: str):
            key = (actor_name, port)
            if key not in env_cache:
                a = self._actors[actor_name]
                feed, cspec = self._control_feed(a)
                env_cache[key] = _enable_expr(a, port, cspec, feed)
            return env_cache[key]

        channels = []
        for c in self._connections:
            e = c.edge
            src_b = self._port_bounds(e.src_actor, e.src_port, env)
            dst_b = self._port_bounds(e.dst_actor, e.dst_port, env)
            if matched.get(c.spec.name):
                verdict = "balanced"
            elif src_b[0] > dst_b[1]:
                verdict = "unbounded"
            elif dst_b[0] > src_b[1]:
                verdict = "starved"
            elif src_b == dst_b and src_b[0] == src_b[1]:
                verdict = "balanced"
            else:
                verdict = "undecided"
            channels.append(ChannelBounds(
                fifo=c.spec.name, src=f"{e.src_actor}.{e.src_port}",
                dst=f"{e.dst_actor}.{e.dst_port}", src_bounds=src_b,
                dst_bounds=dst_b, verdict=verdict))
        self.bounds_report = BoundsReport(channels=tuple(channels))
        return self.bounds_report

    def build(self, derive_matched: bool = True,
              device: DeviceLike = None,
              check_bounds: bool = False) -> Network:
        """Validate and emit the :class:`Network` on ``device`` (the CUDA
        card when None).  Dangling ports are reported with the missing
        ``connect`` calls; ``derive_matched`` runs the matched-rates
        proof for channels left at ``matched_rates=None``;
        ``check_bounds=True`` runs :meth:`check_bounds` and rejects a
        provably unbounded or starved channel."""
        dangling = self.dangling_ports()
        if dangling:
            raise ValueError(
                "network has dangling ports (every port connects to exactly "
                f"one channel, paper §3.2): {sorted(dangling)} — add a "
                "b.connect(...) for each")
        for a in self._actors.values():
            if a.enables is not None:
                check_declared_enables(a, self._control_feed(a)[1])
        dev = resolve_device(device)
        if check_bounds:
            bad = self.check_bounds(dev).violations()
            if bad:
                raise ValueError(
                    "NetworkBuilder.build(check_bounds=True): the declared/"
                    "derived rate bounds prove these channels violate their "
                    "Eq. 1 buffers:\n  "
                    + "\n  ".join(c.describe() for c in bad)
                    + "\n(fix the graph, adjust rate_bounds(...), or build "
                    "with check_bounds=False and rely on runtime guards)")
        matched = (self._derive_matched(dev) if derive_matched
                   else {c.spec.name: bool(c.matched_override)
                         for c in self._connections})
        fifos = [dataclasses.replace(c.spec, matched_rates=matched[c.spec.name])
                 if matched[c.spec.name] != c.spec.matched_rates else c.spec
                 for c in self._connections]
        initial = {c.spec.name: c.initial_token for c in self._connections
                   if c.initial_token is not None}
        return Network(list(self._actors.values()), fifos,
                       [c.edge for c in self._connections],
                       initial_tokens=initial or None, device=dev)

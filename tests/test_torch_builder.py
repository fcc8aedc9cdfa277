"""The port's matched-rates proof (control functions evaluated over the
control channel's declared domain, feeder ports proven equal by identity)
and the builder's validation, on small hand-made networks."""
from __future__ import annotations

import pytest
import torch

from repro_torch.core import NetworkBuilder, dynamic_actor, static_actor
from repro_torch.core.builder import _enable_expr


def _net(dst_threshold=0, domain=(0, 3), distinct_tokens=False, matched=None):
    """config --c_a--> a --data--> b <--c_b-- config.

    ``a`` produces iff tok > 0; ``b`` consumes iff tok > dst_threshold.
    """
    def cfg_fire(st, ins, rates):
        tok = torch.tensor([[2]], dtype=torch.int32)
        other = torch.tensor([[2]], dtype=torch.int32) if distinct_tokens else tok
        return st + 1, {"ca": tok, "cb": other}

    config = static_actor("config", (), ("ca", "cb"), cfg_fire, init=lambda: 0,
                          ready=lambda st: st < 3)
    a = dynamic_actor("a", "c", lambda tok: {"out": int(tok[0] > 0)}, (), ("out",),
                      lambda st, ins, rates: (st, {"out": torch.ones(1, 4)}))
    b = dynamic_actor("b", "c", lambda tok: {"in": int(tok[0] > dst_threshold)},
                      ("in",), (), lambda st, ins, rates: (st, {}))
    bld = NetworkBuilder()
    bld.actors(config, a, b)
    bld.connect("config.ca", "a.c", name="c_a", domain=domain)
    bld.connect("config.cb", "b.c", name="c_b", domain=domain)
    bld.connect("a.out", "b.in", token_shape=(4,), name="data",
                matched_rates=matched)
    return bld


def test_same_enable_on_one_feeder_value_is_matched():
    net = _net().build(device="cpu")
    assert net.fifos["data"].matched_rates
    assert net.register_fifos == {"data", "c_a", "c_b"}


def test_different_enables_are_not_matched():
    net = _net(dst_threshold=1).build(device="cpu")
    assert not net.fifos["data"].matched_rates
    assert "data" not in net.register_fifos


def test_no_declared_domain_is_no_proof():
    net = _net(domain=None).build(device="cpu")
    assert not net.fifos["data"].matched_rates


def test_distinct_feeder_tensors_are_not_proven_equal():
    net = _net(distinct_tokens=True).build(device="cpu")
    assert not net.fifos["data"].matched_rates


def test_enable_classification():
    bld = _net()
    a = bld._actors["a"]
    spec = bld._connections[0].spec
    kind, table, feed = _enable_expr(a, "out", spec, ("config", "ca"))
    assert kind == "table" and table == {0: 0, 1: 1, 2: 1, 3: 1} and feed == ("config", "ca")
    assert _enable_expr(bld._actors["config"], "ca", None, None) == ("const", 1)
    assert _enable_expr(a, "out", None, None) is None


def test_declared_matched_rates_override_the_derivation():
    assert _net(dst_threshold=1, matched=True).build(device="cpu").fifos["data"].matched_rates
    assert not _net(matched=False).build(device="cpu").fifos["data"].matched_rates


@pytest.mark.parametrize("call,msg", [
    (lambda b: b.connect("a.out", "b.nope", token_shape=(4,)), "no input port"),
    (lambda b: b.connect("zz.out", "b.in", token_shape=(4,)), "unknown actor"),
    (lambda b: b.connect("a.out", "b.in"), "explicit token_shape"),
    (lambda b: b.connect("config.ca", "a.c", rate=2), "rate 1"),
    (lambda b: b.connect("a.out", "b.in", token_shape=(4,), capacity=3), "Eq. 1"),
])
def test_connect_reports_the_offending_call(call, msg):
    def fire(st, ins, rates):
        return st, {}
    bld = NetworkBuilder()
    bld.actors(static_actor("config", (), ("ca",), fire),
               dynamic_actor("a", "c", lambda tok: {"out": 1}, (), ("out",), fire),
               static_actor("b", ("in",), (), fire))
    with pytest.raises(ValueError, match=msg):
        call(bld)


def test_dangling_ports_are_reported_at_build():
    def fire(st, ins, rates):
        return st, {}
    bld = NetworkBuilder()
    bld.actors(static_actor("src", (), ("out",), fire), static_actor("dst", ("in",), (), fire))
    with pytest.raises(ValueError, match="dangling"):
        bld.build(device="cpu")

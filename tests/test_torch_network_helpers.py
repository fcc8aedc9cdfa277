"""The port's ``Network`` helpers and ``runtime_mode`` against the JAX
package's, on DPD and motion detection (MD) built by both factories.

``to_dot`` must equal the reference's string exactly, with and without a
megakernel ``GridPartition`` (each side's own partition of its own
network; the two partitions are equal, ``tests/test_torch_megakernel_lower.py``).
``sources`` / ``sinks``, ``repetition_vector`` and ``iteration_token_flops``
are compared exactly; ``state_from_dict`` leaf by leaf, integers exactly
and floats within the harness's ``REL_TOL`` of each plane's largest
magnitude (the staged states are equal to the bit, ``rel=0``).
``runtime_mode=STATIC_DAL`` must refuse and accept the networks the
reference refuses and accepts, naming the same actors.
"""
from __future__ import annotations

import re

import pytest
from test_torch_harness import assert_leaves_match, jax_literal, port_leaves, ref_leaves

from repro_torch.core import (ExecutionPlan, RuntimeMode, iteration_token_flops,
                              repetition_vector)
from repro_torch.core.megakernel import lower_network, partition_layout
from repro_torch.graphs.factories import make_dpd, make_motion_detection

__all__ = ["jax_literal"]  # the fixture is used by name


def _pair(name, **kw):
    """(reference network, port network) built by the two factories."""
    if name == "dpd":
        from repro.graphs.factories import make_dpd as ref_make
        return ref_make(block_l=64, **kw)[0], make_dpd(block_l=64, device="cpu", **kw)[0]
    from repro.graphs.factories import make_motion_detection as ref_make
    args = dict(n_frames=12, rate=4, frame_hw=(48, 64))
    return ref_make(**args)[0], make_motion_detection(**args, device="cpu")[0]


@pytest.mark.parametrize("cores", [None, 1, 2, 3])
@pytest.mark.parametrize("name", ["dpd", "md"])
def test_to_dot_equals_the_reference(jax_literal, name, cores):
    from repro.core.megakernel.lower import lower_network as ref_lower
    from repro.core.megakernel.lower import partition_layout as ref_partition
    ref_net, net = _pair(name)
    if cores is None:
        want, got = ref_net.to_dot(), net.to_dot()
    else:
        want = ref_net.to_dot(ref_partition(ref_net, ref_lower(ref_net), cores=cores))
        got = net.to_dot(partition_layout(net, lower_network(net), cores))
        assert got.count("subgraph cluster_core") == cores
    assert got == want


def test_to_dot_refuses_another_networks_partition(jax_literal):
    _, dpd = _pair("dpd")
    _, md = _pair("md")
    part = partition_layout(dpd, lower_network(dpd), 2)
    with pytest.raises(ValueError, match="GridPartition built from"):
        md.to_dot(part)


@pytest.mark.parametrize("name", ["dpd", "md"])
def test_sources_sinks_repetition_and_flops_equal_the_reference(jax_literal, name):
    from repro.core.network import iteration_token_flops as ref_flops
    from repro.core.network import repetition_vector as ref_rep
    ref_net, net = _pair(name)
    assert net.sources() == ref_net.sources() and net.sinks() == ref_net.sinks()
    assert net.sources() and net.sinks()
    assert repetition_vector(net) == ref_rep(ref_net)
    assert list(repetition_vector(net)) == list(net.actors)
    assert iteration_token_flops(net) == ref_flops(ref_net) > 0


@pytest.mark.parametrize("name", ["dpd", "md"])
def test_state_from_dict_equals_the_reference(jax_literal, name):
    ref_net, net = _pair(name)
    ref_st, st = ref_net.init_state(), net.init_state()

    def as_dict(state, fifos, actors):
        # Insertion order reversed: the network's order must win.
        return {"fifos": dict(reversed(list(zip(fifos, state.fifos)))),
                "actors": dict(reversed(list(zip(actors, state.actors))))}

    want = ref_net.state_from_dict(as_dict(ref_st, ref_net.fifos, ref_net.actors))
    got = net.state_from_dict(as_dict(st, net.fifos, net.actors))
    assert got.fifo_names == tuple(net.fifos) and got.actor_names == tuple(net.actors)
    assert_leaves_match(ref_leaves(want), port_leaves(got), rel=0.0)
    assert net.state_from_dict(st) is st


def _refused_actors(err: BaseException) -> set:
    return set(re.findall(r"'([^']+)'", re.search(r"actors \[(.*?)\]", str(err)).group(1)))


@pytest.mark.parametrize("mode", ["static", "dynamic", "megakernel"])
def test_static_dal_refuses_and_accepts_as_the_reference(jax_literal, mode):
    from repro.core.executor import RuntimeMode as RefMode
    n_it = dict(n_iterations=2) if mode == "static" else {}
    ref_net, net = _pair("dpd")
    with pytest.raises(ValueError, match="STATIC_DAL mode") as want:
        ref_net.compile(mode=mode, runtime_mode=RefMode.STATIC_DAL, **n_it)
    with pytest.raises(ValueError, match="STATIC_DAL mode") as got:
        net.compile(mode=mode, runtime_mode=RuntimeMode.STATIC_DAL, **n_it)
    assert _refused_actors(got.value) == _refused_actors(want.value)
    assert {a for a in net.actors if net.actors[a].is_dynamic} == _refused_actors(got.value)
    # The static all-10 network of Table 4 is accepted, and runs as under
    # the default mode.
    ref_static, static = _pair("dpd", static_all_active=True)
    ref_static.compile(mode=mode, runtime_mode=RefMode.STATIC_DAL, **n_it)
    dal = static.compile(mode=mode, runtime_mode=RuntimeMode.STATIC_DAL, **n_it).run()
    plain = static.compile(mode=mode, **n_it).run()
    assert_leaves_match(port_leaves(plain.state), port_leaves(dal.state), rel=0.0)
    assert dal.fire_counts == plain.fire_counts and dal.sweeps == plain.sweeps


def test_static_dal_leaves_interpreted_mode_alone_as_the_reference(jax_literal):
    from repro.core.executor import RuntimeMode as RefMode
    ref_net, net = _pair("dpd")
    ref_net.compile(mode="interpreted", n_iterations=1, runtime_mode=RefMode.STATIC_DAL)
    net.compile(mode="interpreted", n_iterations=1, runtime_mode=RuntimeMode.STATIC_DAL)


def test_runtime_mode_defaults_to_proposed_and_refuses_unknown_values():
    assert ExecutionPlan(mode="dynamic").runtime_mode is RuntimeMode.PROPOSED
    assert ExecutionPlan(mode="dynamic", runtime_mode=RuntimeMode.STATIC_DAL).runtime_mode \
        is RuntimeMode.STATIC_DAL
    # Only the enum, as the reference's ``is`` test reads it: a value
    # string would pass there unchecked as PROPOSED.
    for bad in ("x", "static_dal", "proposed", "STATIC_DAL", 1, None):
        with pytest.raises(ValueError, match="runtime_mode must be one of"):
            ExecutionPlan(mode="dynamic", runtime_mode=bad)
    net = make_dpd(n_firings=2, block_l=32, device="cpu")[0]
    with pytest.raises(ValueError, match="runtime_mode must be one of"):
        net.compile(mode="dynamic", runtime_mode="x")

"""The port's megakernel lowering and grid partitioning against the
reference's (``src/repro/core/megakernel/lower.py``), on the same DPD and
motion detection networks built in both frameworks: every table and byte
count exactly equal."""
from __future__ import annotations

import pytest

from repro.core.megakernel import default_assignment as ref_default_assignment
from repro.core.megakernel import entry_staging_bytes as ref_entry_staging_bytes
from repro.core.megakernel import lower_network as ref_lower_network
from repro.core.megakernel import partition_layout as ref_partition_layout
from repro.core.megakernel import state_hbm_bytes as ref_state_hbm_bytes
from repro.graphs.factories import make_dpd as ref_make_dpd
from repro.graphs.factories import make_motion_detection as ref_make_md
from repro_torch.core.megakernel import (default_assignment, entry_staging_bytes,
                                         lower_network, partition_layout,
                                         state_hbm_bytes)
from repro_torch.graphs.factories import make_dpd, make_motion_detection
from test_torch_harness import jax_literal

__all__ = ["jax_literal"]  # the fixture is used by name


def _pair(static_all_active: bool = False):
    ref_net, _ = ref_make_dpd(4, block_l=128, static_all_active=static_all_active)
    net, _ = make_dpd(4, block_l=128, static_all_active=static_all_active,
                      device="cpu")
    return ref_net, net


def _layout_tables(layout):
    n = len(layout.fifo_specs)
    return dict(
        fifo_names=layout.fifo_names,
        rows=[(r.name, r.index, r.control,
               tuple((pb.port, pb.fifo) for pb in r.inputs),
               tuple((pb.port, pb.fifo) for pb in r.outputs),
               r.is_dynamic, r.has_ready) for r in layout.firing_table],
        transient=set(layout.transient_fifos),
        unroll_period=layout.unroll_period,
        ring_scratch_bytes=layout.ring_scratch_bytes,
        cursor_bytes=layout.cursor_bytes,
        scratch_bytes=layout.scratch_bytes,
        transient_scratch_bytes=layout.transient_scratch_bytes,
        shapes=[layout.scratch_shape(i) for i in range(n)])


def _partition_tables(part, layout):
    return dict(
        n_cores=part.n_cores, assignment=part.assignment,
        core_rows=part.core_rows, fifo_cores=part.fifo_cores,
        forwarded_fifos=part.forwarded_fifos, objective=part.objective,
        shared_fifos=part.shared_fifos, cursor_rows=part.cursor_rows,
        core_cursor_rows=part.core_cursor_rows,
        private_ring_bytes=part.private_ring_bytes(layout),
        shared_ring_bytes=part.shared_ring_bytes(layout),
        reclaimed_ring_bytes=part.reclaimed_ring_bytes(layout),
        scratch_bytes=part.scratch_bytes(layout),
        semaphore_bytes=part.semaphore_bytes())


@pytest.mark.parametrize("static_all_active", [False, True])
def test_lower_network_equals_reference(jax_literal, static_all_active):
    ref_net, net = _pair(static_all_active)
    ref, got = _layout_tables(ref_lower_network(ref_net)), _layout_tables(lower_network(net))
    assert got == ref
    if not static_all_active:
        assert got["scratch_bytes"] == 45152 + 408 and got["cursor_bytes"] == 408


@pytest.mark.parametrize("forward", [True, False])
@pytest.mark.parametrize("objective", ["crossing", "flops"])
@pytest.mark.parametrize("cores", [1, 2, 4])
@pytest.mark.parametrize("static_all_active", [False, True])
def test_partition_layout_equals_reference(jax_literal, static_all_active, cores,
                                           objective, forward):
    ref_net, net = _pair(static_all_active)
    ref_layout, layout = ref_lower_network(ref_net), lower_network(net)
    ref = ref_partition_layout(ref_net, ref_layout, cores, objective=objective,
                               forward_transients=forward)
    got = partition_layout(net, layout, cores, objective=objective,
                           forward_transients=forward)
    assert _partition_tables(got, layout) == _partition_tables(ref, ref_layout)
    assert (default_assignment(net, cores, layout=layout, objective=objective)
            == ref_default_assignment(ref_net, cores, layout=ref_layout,
                                      objective=objective))
    assert (entry_staging_bytes(layout, got)
            == ref_entry_staging_bytes(ref_layout, ref))


def test_partition_byte_counts_at_cores_1_2_4(jax_literal):
    """Scratch and shared ring bytes and forwarded counts at cores 1/2/4
    (crossing cut, forwarding on), as the reference gives them."""
    _, net = _pair()
    layout = lower_network(net)
    seen = []
    for cores in (1, 2, 4):
        part = partition_layout(net, layout, cores)
        seen.append((part.scratch_bytes(layout), part.shared_ring_bytes(layout),
                     len(part.forwarded_fifos)))
    assert seen == [(408, 0, 34), (20920, 20512, 20), (27088, 26680, 14)]


def test_explicit_assign_equals_reference(jax_literal):
    ref_net, net = _pair()
    names = list(net.actors)
    assign = {n: (3 * i) % 4 for i, n in enumerate(names)}
    ref = ref_partition_layout(ref_net, ref_lower_network(ref_net), 4, assign)
    got = partition_layout(net, lower_network(net), 4, assign)
    assert got.objective == ref.objective == "assign"
    assert _partition_tables(got, lower_network(net)) == \
        _partition_tables(ref, ref_lower_network(ref_net))


def test_state_hbm_bytes_equals_reference(jax_literal):
    ref_net, net = _pair()
    assert state_hbm_bytes(net.init_state()) == ref_state_hbm_bytes(ref_net.init_state())


@pytest.mark.parametrize("case", ["too_many_cores", "partial_assign",
                                  "out_of_range_assign", "unknown_objective",
                                  "unknown_actor"])
def test_rejections_match_reference(jax_literal, case):
    ref_net, net = _pair()
    names = list(net.actors)
    kw = {
        "too_many_cores": dict(cores=16),
        "partial_assign": dict(cores=2, assign={n: 0 for n in names[:-1]}),
        "out_of_range_assign": dict(cores=2, assign={n: 2 for n in names}),
        "unknown_objective": dict(cores=2, objective="latency"),
        "unknown_actor": dict(cores=2, assign={**{n: 0 for n in names}, "ghost": 1}),
    }[case]
    with pytest.raises(ValueError) as ref_err:
        ref_partition_layout(ref_net, ref_lower_network(ref_net), **kw)
    with pytest.raises(ValueError) as got_err:
        partition_layout(net, lower_network(net), **kw)
    assert str(got_err.value) == str(ref_err.value)


def test_profile_objective_raises_naming_a7():
    """The profile cut (ROADMAP A7) needs measured weights: without them it
    raises and says how to get them, as the reference does."""
    net, _ = make_dpd(4, block_l=32, device="cpu")
    with pytest.raises(ValueError, match="trace=True"):
        partition_layout(net, lower_network(net), 2, objective="profile")
    with pytest.raises(ValueError, match="profile"):
        net.compile(mode="megakernel", cores=2, cut_objective="profile")


# --------------------------------------------------------------------------- #
# Motion detection: byte tokens and the delay channel's partition glue.
# --------------------------------------------------------------------------- #
def _md_pair():
    ref_net, _ = ref_make_md(12, rate=4, frame_hw=(24, 32))
    net, _ = make_motion_detection(12, rate=4, frame_hw=(24, 32), device="cpu")
    return ref_net, net


@pytest.mark.parametrize("objective", ["crossing", "flops"])
@pytest.mark.parametrize("cores", [1, 2, 4])
def test_md_tables_equal_reference(jax_literal, cores, objective):
    ref_net, net = _md_pair()
    ref_layout, layout = ref_lower_network(ref_net), lower_network(net)
    assert _layout_tables(layout) == _layout_tables(ref_layout)
    ref = ref_partition_layout(ref_net, ref_layout, cores, objective=objective)
    got = partition_layout(net, layout, cores, objective=objective)
    assert _partition_tables(got, layout) == _partition_tables(ref, ref_layout)
    assert (entry_staging_bytes(layout, got)
            == ref_entry_staging_bytes(ref_layout, ref))
    assert state_hbm_bytes(net.init_state()) == ref_state_hbm_bytes(ref_net.init_state())
    # The delay channel (delay 1 < rate 4) glues gauss and thres together.
    names = list(net.actors)
    assert got.assignment[names.index("gauss")] == got.assignment[names.index("thres")]
    assert got.forwarded_fifos == ()    # no MD channel is transient


def test_md_splitting_assign_raises_as_reference(jax_literal):
    ref_net, net = _md_pair()
    split = {"source": 0, "gauss": 0, "thres": 1, "med": 1, "sink": 1}
    with pytest.raises(ValueError) as ref_err:
        ref_partition_layout(ref_net, ref_lower_network(ref_net), 2, split)
    with pytest.raises(ValueError) as got_err:
        partition_layout(net, lower_network(net), 2, split)
    assert str(got_err.value) == str(ref_err.value)
    assert "f_gauss_thres_d" in str(got_err.value)

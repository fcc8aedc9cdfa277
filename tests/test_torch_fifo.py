"""The port's FIFO channel against the reference's on the same random
operation sequences: windows and every ``buf/rd/wr/occ`` exactly."""
from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.fifo import FifoSpec as RefFifoSpec
from repro_torch.core.fifo import FifoSpec

CPU = torch.device("cpu")


def _assert_same(ref_st, st):
    assert np.array_equal(np.asarray(ref_st.buf), st.buf.numpy())
    assert (int(ref_st.rd), int(ref_st.wr), int(ref_st.occ)) == (st.rd, st.wr, st.occ)


@pytest.mark.parametrize("delay", [0, 1])
@pytest.mark.parametrize("rate", [1, 2, 3])
def test_random_sequences_match_reference(rate, delay):
    rng = np.random.default_rng(10 * rate + delay)
    ref = RefFifoSpec("f", rate, (2,), delay=delay)
    port = FifoSpec("f", rate, (2,), delay=delay)
    init = rng.normal(size=(2,)).astype(np.float32) if delay else None
    ref_st = ref.init_state(None if init is None else jnp.asarray(init))
    st = port.init_state(CPU, None if init is None else torch.tensor(init))
    _assert_same(ref_st, st)
    for _ in range(150):
        ops = []
        if port.can_write(st):
            ops += ["write", "write_masked"]
        if port.can_read(st):
            ops += ["read", "read_masked"]
        if port.can_peek(st):
            ops.append("peek")
        ops.append("masked_off")
        op = ops[rng.integers(len(ops))]
        tokens = rng.normal(size=(rate, 2)).astype(np.float32)
        if op == "write":
            ref_st = ref.write(ref_st, jnp.asarray(tokens))
            port.write(st, torch.tensor(tokens))
        elif op == "write_masked":
            ref_st = ref.write_masked(ref_st, jnp.asarray(tokens), jnp.bool_(True))
            port.write_masked(st, torch.tensor(tokens), 1)
        elif op == "masked_off":
            # Disabled ports: the write leaves everything untouched and the
            # read returns the window at the cursor without consuming it.
            ref_st = ref.write_masked(ref_st, jnp.asarray(tokens), jnp.bool_(False))
            port.write_masked(st, torch.tensor(tokens), 0)
            rw, ref_st = ref.read_masked(ref_st, jnp.bool_(False))
            assert np.array_equal(np.asarray(rw), port.read_masked(st, 0).numpy())
        elif op == "read":
            rw, ref_st = ref.read(ref_st)
            assert np.array_equal(np.asarray(rw), port.read(st).numpy())
        elif op == "read_masked":
            rw, ref_st = ref.read_masked(ref_st, jnp.bool_(True))
            assert np.array_equal(np.asarray(rw), port.read_masked(st, 1).numpy())
        else:
            assert np.array_equal(np.asarray(ref.peek(ref_st)), port.peek(st).numpy())
        _assert_same(ref_st, st)


@pytest.mark.parametrize("delay", [0, 1])
@pytest.mark.parametrize("rate", [1, 2, 3, 4])
def test_eq1_capacity_matches_reference(rate, delay):
    ref = RefFifoSpec("f", rate, (2, 8), delay=delay)
    port = FifoSpec("f", rate, (2, 8), delay=delay)
    assert port.capacity_tokens == ref.capacity_tokens
    assert port.token_size_bytes == ref.token_size_bytes
    assert port.capacity_bytes == ref.capacity_bytes
    assert port.writable_occupancy_bound == ref.writable_occupancy_bound
    assert port.n_write_phases == ref.n_write_phases


def test_read_window_is_a_view_of_the_ring():
    spec = FifoSpec("f", 1, (3,))
    st = spec.init_state(CPU)
    spec.write(st, torch.ones((1, 3)))
    win = spec.read(st)
    assert win.data_ptr() == st.buf.data_ptr()


def test_control_ring_lives_in_host_memory():
    spec = FifoSpec("c", 1, (1,), torch.int32, is_control=True)
    assert spec.ring_device(torch.device("meta")) == CPU
    assert FifoSpec("d", 1, (1,)).ring_device(torch.device("meta")).type == "meta"


@pytest.mark.parametrize("kw", [
    dict(rate=0), dict(rate=1, delay=2), dict(rate=2, is_control=True),
    dict(rate=1, is_control=True, delay=1), dict(rate=1, delay=1, matched_rates=True),
    dict(rate=1, domain=(3, 1))])
def test_invalid_specs_raise_like_reference(kw):
    with pytest.raises(ValueError):
        RefFifoSpec("f", token_shape=(1,), **kw)
    with pytest.raises(ValueError):
        FifoSpec("f", token_shape=(1,), **kw)


def test_initial_token_only_on_delay_channels():
    with pytest.raises(ValueError, match="delay-free"):
        FifoSpec("f", 1, (2,)).init_state(CPU, torch.ones(2))
    st = FifoSpec("f", 2, (2,), delay=1).init_state(CPU, torch.ones(2))
    assert st.occ == 1 and torch.equal(st.buf[0], torch.ones(2))

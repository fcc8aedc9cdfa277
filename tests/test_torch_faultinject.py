"""The port's fault injectors (``core/faultinject.py``) against the JAX
package's: the same corruption of the same state (every cursor and ring
leaf exactly, a poisoned window NaN where the reference's is), their input
left unchanged, and the same refusals."""
from __future__ import annotations

import jax
import numpy as np
import pytest
import torch

from repro.core import faultinject as ref_fi
from repro.graphs.factories import make_dpd as ref_make_dpd
from repro_torch.core import faultinject as fi
from repro_torch.graphs.factories import make_dpd, states_equal
from test_torch_harness import port_leaves, ref_leaves

INJECTIONS = {
    "overflow": ("inject_overflow", {}),
    "overflow_by3": ("inject_overflow", {"by": 3}),
    "underflow": ("inject_underflow", {}),
    "cursor_occ": ("corrupt_cursor", {"occ": 1}),
    "cursor_rd_wr": ("corrupt_cursor", {"rd": -1, "wr": 2}),
    "poison": ("poison_tokens", {}),
    "poison_inf": ("poison_tokens", {"value": float("inf")}),
}


@pytest.fixture(scope="module")
def nets():
    with pytest.MonkeyPatch.context() as mp:
        if not hasattr(jax.core, "Literal"):
            from jax.extend.core import Literal
            mp.setattr(jax.core, "Literal", Literal, raising=False)
        ref_net, _ = ref_make_dpd(n_firings=4, block_l=32)
    return ref_net, make_dpd(n_firings=4, block_l=32, device="cpu")[0]


@pytest.mark.parametrize("fifo", ["f_in", "f_b3"])
@pytest.mark.parametrize("case", sorted(INJECTIONS))
def test_injection_matches_reference_and_leaves_input(nets, case, fifo):
    ref_net, net = nets
    name, kw = INJECTIONS[case]
    before = net.init_state()
    keep = before.clone()
    got = getattr(fi, name)(net, before, fifo, **kw)
    want = getattr(ref_fi, name)(ref_net, ref_net.init_state(), fifo, **kw)
    assert states_equal(before, keep)                       # input unchanged
    for i, (r, p) in enumerate(zip(ref_leaves(want), port_leaves(got))):
        r, p = np.asarray(r), np.asarray(p)
        assert r.shape == p.shape and r.dtype.kind == p.dtype.kind, i
        assert np.array_equal(r, p, equal_nan=r.dtype.kind == "f"), i


def test_injectors_validate_targets(nets):
    _, net = nets
    st = net.init_state()
    with pytest.raises(ValueError, match="unknown channel"):
        fi.inject_overflow(net, st, "nosuch")
    with pytest.raises(ValueError, match="float channel"):
        fi.poison_tokens(net, st, "f_c_fork")
    full = fi.poison_tokens(net, fi.poison_tokens(net, st, "f_in"), "f_in")
    with pytest.raises(ValueError, match="no room"):
        fi.poison_tokens(net, full, "f_in")


@pytest.mark.parametrize("kind", ["numpy", "torch"])
def test_truncate_feed_matches_reference(kind):
    feeds = np.arange(6 * 4 * 8, dtype=np.float32).reshape(6, 4, 8)
    want = ref_fi.truncate_feed({"f_in": feeds, "g": feeds}, "f_in", drop=2)
    port_feeds = feeds if kind == "numpy" else torch.tensor(feeds)
    got = fi.truncate_feed({"f_in": port_feeds, "g": port_feeds}, "f_in", drop=2)
    assert np.array_equal(np.asarray(got["f_in"]), want["f_in"])
    assert got["g"] is port_feeds
    with pytest.raises(ValueError, match="no feed"):
        fi.truncate_feed({"f_in": port_feeds}, "nosuch")
    with pytest.raises(ValueError, match="cannot drop"):
        fi.truncate_feed({"f_in": port_feeds}, "f_in", drop=7)

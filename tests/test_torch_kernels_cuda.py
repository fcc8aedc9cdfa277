"""B1-B7 on the card against their plain versions at shapes the main
paths do not reach (B1: every order at window lengths around its
256-sample tiles and its 9-sample halo, the window 16-byte aligned and 4
bytes off; B2: DPD at two widths under four schedules, motion detection at
rates 1 and 4, a control token outside its domain mid-run, sweep budget
exhaustion, a resumed partial state, at cores 1 and 2; B3: u8 frames from
1 x 1 to 1080 x 1920, widths that are and are not a multiple of 16, a view
off 16 bytes, .5 ties and all-255 frames; B4: float32 and u8 frame pairs
from 1 x 1 to 1080 x 1920, widths that are and are not a multiple of 4,
bases off the vector width, NaN pixels, thresholds 0, -1, 12.5 and NaN, and other dtypes cast by
``motion_post``; B5-B7:
ragged lengths, other head widths and group sizes, float32 SSD inputs, B6
under strong decays), and the wrappers' launch counts and refusals.
These tests need a CUDA card and ``nvcc``; without one they skip.  Run
them on the card with

    python -m pytest -q -m cuda tests/test_torch_kernels_cuda.py

Bars: B1 bit for bit (``torch.equal`` on the output and the next history),
as in ``chip_smoke.py`` phase 2; B3 on u8 frames and B4 bit for bit, as in
phase 7; B2 bit for bit (every io word the plain version writes, every ring
and actor tensor); B5 within one bf16 step of |want| plus 2^-5 of the RMS of want's
(batch, position, head) row, the bar of ``chip_smoke.py`` phase 12 (set
from the readings of sound runs and planted faults there; PERF.md);
B6 within 3e-4 of the largest magnitude (``tests/test_kernels.py:92``),
plus one bf16 step of y for bf16 inputs, against its plain version, and
under strong decays against the step-by-step recurrence; B7 bit for bit
(``torch.equal``), as in ``chip_smoke.py`` phase 12.  B5's float32 and f16
route: float32 within rtol = atol = 2e-4 of its plain version (the
reference's float32 tolerance, ``tests/test_kernels.py``), f16 within one
f16 step of |want| plus 2^-10 of the row's RMS.  B6's SIMT route (any
(P, N)): 3e-4 of the largest magnitude, plus one f16 step of y
(2^-10 |y|) for f16 inputs.  B2's guarded and traced builds: every fault word, high-water mark
and trace event equal to its plain version's and the host dynamic run's,
and every ring, cursor and actor tensor bit for bit, clean and with each
injected fault.  B2 re-entered from every chunk boundary of a stream, and
its feed and fetch bodies (source and sink at one plane), bit for bit
against its plain version and the host dynamic run; B6 at batch 1 (the LM
stage network's microbatch) at its bar.
"""
from __future__ import annotations

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from repro_torch.core.megakernel import (compile_megakernel, lower_network,
                                         megakernel_cuda, partition_layout)
from repro_torch.core.executor import run_dynamic
from repro_torch.core.faultinject import (corrupt_cursor, inject_overflow,
                                          inject_underflow, poison_tokens)
from repro_torch.core.megakernel.program import (H_MOE, H_SCRATCH, M_BLOCKS, M_ERROR,
                                                 stage)
from repro_torch.core.megakernel.ref import run_program
from repro_torch.core.trace import decode_trace
from repro_torch.graphs.dpd import default_active_schedule
from repro_torch.graphs.factories import make_dpd, make_motion_detection
from repro_torch.kernels.dyn_fir import N_TAPS, dpd_branch_cuda, poly_branch, poly_ref
from repro_torch.kernels.gauss5x5 import gauss5x5_cuda, gauss5x5_u8, gauss5x5_u8_ref
from repro_torch.kernels.motion_post import motion_post, motion_post_cuda, motion_post_ref
from repro_torch.kernels.flash_attention import (flash_attention, flash_attention_cuda,
                                                 flash_attention_ref)
from repro_torch.kernels.rglru import rglru, rglru_cuda, rglru_ref
from repro_torch.kernels.ssd import ssd, ssd_cuda, ssd_naive, ssd_ref

pytestmark = pytest.mark.cuda

B5_ROW_TOL = 2.0 ** -5


@pytest.fixture
def gen():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels run only there")
    g = torch.Generator(device="cuda")
    g.manual_seed(0)
    return g


# B5's edges: S not a multiple of the kernel's 128-query or 64-key tile
# (63, 130, 257, 333, 517, 650, 700); windows shorter than a key tile and
# not a multiple of it (1, 37, 40); the full-length tile walk (S 4096,
# window 2048, B 1); Hkv 2 and 4 with G > 1; hd 16, 120 and 240 (zero fill
# past hd and the store mask); S = 1; non-causal with and without a window;
# the families' hd 64 instance: whisper-small's encoder (non-causal, S 1500,
# a partial last query and key tile with no causal mask to hide it), its
# decoder's prefill (causal, S 384, B 4), and internvl2-1b's prefill (14
# query heads on 2 KV heads, G = 7), also at an odd S and non-causal with
# G = 7.
@pytest.mark.parametrize("B,S,H,Hkv,hd,causal,window", [
    (1, 1, 1, 1, 16, True, None), (1, 63, 2, 1, 16, True, None),
    (2, 130, 6, 3, 120, False, None), (1, 96, 4, 4, 64, False, 40),
    (2, 300, 10, 1, 256, True, 64), (1, 257, 8, 2, 128, True, 100),
    (1, 200, 12, 4, 240, True, None), (1, 333, 10, 1, 256, True, None),
    (1, 700, 10, 1, 256, True, 37), (1, 650, 4, 2, 64, False, 100),
    (1, 4096, 10, 1, 256, True, 2048), (2, 333, 8, 4, 256, True, 90),
    (2, 190, 6, 2, 120, True, 50), (1, 517, 4, 2, 16, True, 70),
    (1, 150, 4, 1, 240, False, None), (2, 1, 10, 1, 256, True, 2048),
    (1, 129, 2, 2, 128, False, 1),
    (1, 1500, 12, 12, 64, False, None), (2, 1500, 4, 4, 64, False, None),
    (4, 384, 12, 12, 64, True, None), (1, 4096, 14, 2, 64, True, None), (2, 1001, 14, 2, 64, True, None),
    (1, 777, 7, 1, 64, False, None),
    # The registry's GQA groups with their windows, at reduced batch and
    # length: gemma3-12b's G 2 at hd 240 with window 1024 (and its global
    # layers' no window), h2o-danube-3-4b's G 4 at hd 120 with window 4096
    # over S above 4096, granite-moe-3b-a800m's G 3 at hd 64, qwen2-72b's G
    # 8 at hd 128 (granite-8b's G 4 at hd 128 too).
    (1, 2100, 4, 2, 240, True, 1024), (1, 1300, 4, 2, 240, True, None),
    (1, 4400, 8, 2, 120, True, 4096), (2, 700, 6, 2, 64, True, None),
    (1, 1100, 16, 2, 128, True, None), (1, 900, 8, 2, 128, True, None)])
def test_flash_attention_matches_plain(gen, B, S, H, Hkv, hd, causal, window):
    q = torch.randn((B, S, H, hd), generator=gen, device="cuda").bfloat16()
    k = torch.randn((B, S, Hkv, hd), generator=gen, device="cuda").bfloat16()
    v = torch.randn((B, S, Hkv, hd), generator=gen, device="cuda").bfloat16()
    before = flash_attention_cuda.launches
    got = flash_attention(q, k, v, causal=causal, window=window)
    assert flash_attention_cuda.launches == before + 1
    want = flash_attention_ref(q, k, v, causal=causal, window=window).float()
    rms = want.pow(2).mean(-1, keepdim=True).sqrt()
    excess = float((((got.float() - want).abs() - 2.0 ** -7 * want.abs()) / rms).max())
    assert bool(torch.isfinite(got).all()) and excess <= B5_ROW_TOL, excess


def _ssd_holds_the_bar(x, dt, A, Bm, Cm, oracle="plain"):
    """B6 within its bar of the plain version, or of the step-by-step
    recurrence ``ssd_naive`` (independent of the chunked algorithm)."""
    before = ssd_cuda.launches
    y, h = ssd(x, dt, A, Bm, Cm, chunk=256)
    assert ssd_cuda.launches == before + 1 and y.dtype == x.dtype
    if oracle == "plain":
        yr, hr = ssd_ref(x, dt, A, Bm, Cm, 256)
    else:
        yr, hr = ssd_naive(x, dt, A, Bm, Cm)
    bar = 3e-4 * yr.float().abs().max()
    if x.dtype == torch.bfloat16:
        bar = bar + 2.0 ** -7 * yr.float().abs()
    assert bool(torch.isfinite(y.float()).all()) and bool(torch.isfinite(h).all())
    assert bool(((y.float() - yr.float()).abs() <= bar).all())
    assert float((h - hr).abs().max()) <= 3e-4 * float(hr.abs().max())


# Lengths from 1 up to several chunks of the kernels' 256 steps, with ragged
# tails (1100, 513, 300), one chunk exactly (256), and head counts that
# are not a multiple of the kernels' head groups (3, 5, 11) at B > 1.
@pytest.mark.parametrize("B,L,H", [(1, 1, 1), (2, 31, 3), (1, 300, 48), (1, 1100, 48),
                                   (2, 513, 5), (1, 256, 4), (3, 300, 11)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_ssd_matches_plain(gen, B, L, H, dtype):
    x = torch.randn((B, L, H, 64), generator=gen, device="cuda").to(dtype)
    dt = F.softplus(torch.randn((B, L, H), generator=gen, device="cuda"))
    A = -torch.linspace(1.0, 16.0, H, device="cuda")
    Bm = torch.randn((B, L, 128), generator=gen, device="cuda").to(dtype)
    Cm = torch.randn((B, L, 128), generator=gen, device="cuda").to(dtype)
    _ssd_holds_the_bar(x, dt, A, Bm, Cm)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_ssd_strong_decay_gives_no_nan(gen, dtype):
    """dt up to 5 at A = -16: the chunk's cumsum reaches -1e4 and most decays
    underflow to 0, which must give no NaN and still hold the bar against
    the step-by-step recurrence, whose decays are each taken from one step's
    dt and so lose nothing to the cumsum's cancellation."""
    B, L, H = 1, 700, 6
    x = torch.randn((B, L, H, 64), generator=gen, device="cuda").to(dtype)
    dt = torch.rand((B, L, H), generator=gen, device="cuda") * 5.0
    A = torch.full((H,), -16.0, device="cuda")
    Bm = torch.randn((B, L, 128), generator=gen, device="cuda").to(dtype)
    Cm = torch.randn((B, L, 128), generator=gen, device="cuda").to(dtype)
    _ssd_holds_the_bar(x, dt, A, Bm, Cm, oracle="naive")


# B7's edges, against its ring of 4 stages of 64 steps and its tiles of 32
# channels: L below one stage (1, 17, 40, 63), L not a multiple of a stage
# (130, 1000), many laps of the ring (1000, 4096); W ending inside a tile
# (100), in whole tiles (96, 2560), below one tile (8) and not a multiple
# of 4 (1, 37), which loads by cp.async instead of TMA; and the serving
# shape.  Bit for bit: both sides take exp, the product and the sum
# each rounded on its own, in time order.
@pytest.mark.parametrize("B,L,W", [(1, 1, 1), (3, 17, 100), (2, 40, 2560),
                                   (1, 63, 8), (2, 130, 96), (2, 1000, 37),
                                   (1, 1000, 100), (4, 4096, 2560)])
def test_rglru_matches_plain(gen, B, L, W):
    la = -(torch.rand((B, L, W), generator=gen, device="cuda") * 2.0 + 0.01)
    gx = torch.randn((B, L, W), generator=gen, device="cuda")
    before = rglru_cuda.launches
    h, t = rglru(la, gx)
    assert rglru_cuda.launches == before + 1
    hr, tr = rglru_ref(la, gx)
    assert torch.equal(h, hr), float((h - hr).abs().max())
    assert torch.equal(t, tr), float((t - tr).abs().max())


def test_rglru_misaligned_operands_take_cp_async(gen):
    """W a multiple of 4 but the operands 4 bytes past a 16-byte boundary:
    no TMA map fits, so the kernel loads by cp.async; still bit for bit."""
    B, L, W = 2, 300, 64
    flat = torch.empty(2 * B * L * W + 2, device="cuda")
    la = flat[1:1 + B * L * W].view(B, L, W)
    gx = flat[2 + B * L * W:].view(B, L, W)
    assert la.data_ptr() % 16 and gx.data_ptr() % 16
    la.copy_(-(torch.rand((B, L, W), generator=gen, device="cuda") * 2.0 + 0.01))
    gx.copy_(torch.randn((B, L, W), generator=gen, device="cuda"))
    before = rglru_cuda.launches
    h, t = rglru(la, gx)
    assert rglru_cuda.launches == before + 1
    hr, tr = rglru_ref(la, gx)
    assert torch.equal(h, hr) and torch.equal(t, tr)


# B1's edges, against its tiles of 256 outputs and its 9-sample halo: L
# below the halo (1, 3), at it (9), around one tile (255, 256, 257),
# several tiles with a ragged tail (1000) and the main path's 32768; the
# window 16-byte aligned (a ring slot) or 4 bytes off, with a row stride
# that is not L.  Every order: orders 5..10 take powf.
@pytest.mark.parametrize("offset", [0, 1])
@pytest.mark.parametrize("L", [1, 3, 9, 255, 256, 257, 1000, 32768])
def test_dyn_fir_matches_plain(gen, L, offset):
    flat = torch.empty(2 * (L + 8), device="cuda")
    win = flat[offset:offset + 2 * (L + 4)].view(2, L + 4)[:, :L]
    assert (win.data_ptr() % 16 == 0) == (offset == 0)
    win.copy_(torch.randn((2, L), generator=gen, device="cuda"))
    hist = torch.randn((2, N_TAPS - 1), generator=gen, device="cuda")
    taps = torch.randn((2, N_TAPS), generator=gen, device="cuda") * 0.3
    for order in range(1, N_TAPS + 1):
        before = dpd_branch_cuda.launches
        y, nxt = poly_branch(hist, win, taps, order)
        assert dpd_branch_cuda.launches == before + 1
        yr, nr = poly_ref(hist, win, taps, order)
        assert torch.equal(y, yr), (order, float((y - yr).abs().max()))
        assert torch.equal(nxt, nr), order


def _tie_frame(n, H, W):
    """Zeros with isolated 128s and 64s: their blur holds exact .5 values."""
    f = torch.zeros((n, H, W), dtype=torch.uint8)
    f[:, 4::9, 4::11] = 128
    f[:, 8::9, 8::11] = 64
    return f


# B3's u8 edges, against its bands of 8 rows over up to 512 columns: every
# pixel border (1 x 1, 4 x 4), one interior pixel (5 x 5), widths not a
# multiple of 16 (33, 319: byte loads and stores), a ragged last band (17,
# 241), the main path's (4, 240, 320) and (2, 1080, 1920) (four column
# blocks); random, tie and all-255 frames.
@pytest.mark.parametrize("kind", ["random", "ties", "white"])
@pytest.mark.parametrize("shape", [(1, 1, 1), (1, 4, 4), (1, 5, 5), (3, 17, 33),
                                   (4, 240, 320), (5, 241, 319), (2, 1080, 1920)])
def test_gauss5x5_matches_plain(gen, shape, kind):
    if kind == "random":
        x = torch.randint(0, 256, shape, generator=gen, device="cuda", dtype=torch.uint8)
    elif kind == "ties":
        x = _tie_frame(*shape).cuda()
    else:
        x = torch.full(shape, 255, dtype=torch.uint8, device="cuda")
    before = gauss5x5_cuda.launches
    got = gauss5x5_u8(x)
    assert gauss5x5_cuda.launches == before + 1
    want = gauss5x5_u8_ref(x)
    assert got.dtype == torch.uint8 and torch.equal(got, want), \
        int((got != want).sum())


def test_gauss5x5_view_off_16_bytes(gen):
    """Frames starting 1 byte past a 16-byte boundary, W a multiple of 16:
    the kernel's byte loads and stores; still bit for bit."""
    n, H, W = 4, 240, 320
    flat = torch.empty(n * H * W + 1, dtype=torch.uint8, device="cuda")
    x = flat[1:].view(n, H, W)
    assert x.data_ptr() % 16
    x.copy_(torch.randint(0, 256, (n, H, W), generator=gen, device="cuda",
                          dtype=torch.uint8))
    x[0] = _tie_frame(1, H, W)[0].cuda()
    assert torch.equal(gauss5x5_u8(x), gauss5x5_u8_ref(x))


def _mp_pair(gen, shape, dtype, nan=False):
    """A frame pair that thresholds both ways at T = 40: uniform frames
    and a second one moved by up to +-80, clamped to 0..255."""
    cur = torch.randint(0, 256, shape, generator=gen, device="cuda").to(torch.float32)
    step = torch.randint(-80, 81, shape, generator=gen, device="cuda")
    prev = torch.clamp(cur + step, 0, 255)
    if dtype == torch.float32:
        cur = cur + torch.rand(shape, generator=gen, device="cuda")
    if nan:
        cur[torch.rand(shape, generator=gen, device="cuda") < 0.1] = float("nan")
        prev[torch.rand(shape, generator=gen, device="cuda") < 0.1] = float("nan")
    return cur.to(dtype), prev.to(dtype)


def _mp_check(cur, prev, threshold=40.0):
    before = motion_post_cuda.launches
    got = motion_post_cuda(cur, prev, threshold)
    assert motion_post_cuda.launches == before + 1
    want = motion_post_ref(cur.float(), prev.float(), threshold)
    assert got.dtype == torch.float32 and got.shape == cur.shape
    assert torch.equal(got, want), int((got != want).sum())
    return got


# B4's edges, against its warps of 32 strips of 4 columns over bands of R
# rows: 1 x 1, widths not a multiple of 4 (3, 5, 9, 13, 319: element loads
# and stores), heights that leave a ragged last band, a band's warp edge
# lanes (widths over 128), the main path's (4, 240, 320) and (2, 1080,
# 1920); float32 and u8 frames.
@pytest.mark.parametrize("dtype", [torch.float32, torch.uint8])
@pytest.mark.parametrize("shape", [(1, 1, 1), (1, 2, 3), (1, 3, 5), (2, 7, 9),
                                   (3, 17, 13), (2, 23, 260), (4, 240, 320),
                                   (5, 241, 319), (1, 5, 132), (2, 1080, 1920)])
def test_motion_post_matches_plain(gen, shape, dtype):
    got = _mp_check(*_mp_pair(gen, shape, dtype))
    if shape[-1] * shape[-2] > 100:
        assert 0 < int((got == 255).sum()) < got.numel()


@pytest.mark.parametrize("dtype,offset", [(torch.float32, 1), (torch.uint8, 1),
                                          (torch.uint8, 4)])
def test_motion_post_bases_off_the_vector_width(gen, dtype, offset):
    """Contiguous frames whose base is ``offset`` elements past an aligned
    buffer: 4 bytes off 16 (float32) or 1 byte off 4 (u8) take element
    loads; u8 4 bytes off 16 keeps its 4-byte words."""
    n, H, W = 4, 240, 320
    sides = []
    for src in _mp_pair(gen, (n, H, W), dtype):
        flat = torch.empty(n * H * W + offset, dtype=dtype, device="cuda")
        view = flat[offset:].view(n, H, W)
        view.copy_(src)
        sides.append(view)
    assert sides[0].data_ptr() % 16 and sides[0].is_contiguous()
    _mp_check(*sides)


@pytest.mark.parametrize("threshold", [0.0, -1.0, 12.5, float("nan")])
@pytest.mark.parametrize("dtype", [torch.float32, torch.uint8])
def test_motion_post_thresholds_and_nan(gen, dtype, threshold):
    for shape in [(2, 9, 13), (4, 240, 320)]:
        got = _mp_check(*_mp_pair(gen, shape, dtype, nan=dtype == torch.float32),
                        threshold)
        if threshold != threshold:                        # NaN: nothing moves
            assert not got.any()
        elif threshold < 0 and dtype == torch.uint8:      # everything moves
            assert torch.all(got == 255)


@pytest.mark.parametrize("dtype", [torch.int32, torch.float64, torch.int16])
def test_motion_post_casts_other_dtypes_then_launches_once(gen, dtype):
    cur, prev = _mp_pair(gen, (2, 48, 64), torch.float32)
    cur, prev = cur.to(dtype), prev.to(dtype)
    before = motion_post_cuda.launches
    got = motion_post(cur, prev)
    assert motion_post_cuda.launches == before + 1
    assert torch.equal(got, motion_post_ref(cur.float(), prev.float()))


def test_motion_post_u8_frames_launch_the_kernel_and_nothing_else(gen):
    cur, prev = _mp_pair(gen, (4, 240, 320), torch.uint8)
    before = motion_post_cuda.launches
    motion_post(cur, prev)
    torch.cuda.synchronize()
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(20):
            motion_post(cur, prev)
        torch.cuda.synchronize()
    assert motion_post_cuda.launches == before + 21
    names = [e.key for e in prof.key_averages()
             if e.device_type == torch.autograd.DeviceType.CUDA]
    assert names and all("motion_post" in k for k in names), names


def test_wrappers_refuse_what_the_kernels_do_not_take(gen):
    launches = (dpd_branch_cuda.launches, gauss5x5_cuda.launches)
    hist = torch.zeros((2, N_TAPS - 1), device="cuda")
    taps = torch.zeros((2, N_TAPS), device="cuda")
    win = torch.zeros((2, 64), device="cuda")
    with pytest.raises(ValueError, match="float32"):              # dtype
        dpd_branch_cuda(hist, win.double(), taps, 3)
    with pytest.raises(ValueError, match="float32 \\(2, 10\\)"):   # shape
        dpd_branch_cuda(hist, win, taps[:, :9], 3)
    with pytest.raises(ValueError, match="contiguous rows"):      # stride
        dpd_branch_cuda(hist, torch.zeros((2, 128), device="cuda")[:, ::2], taps, 3)
    with pytest.raises(ValueError, match="CUDA tensor"):          # device
        dpd_branch_cuda(hist, win, taps.cpu(), 3)
    with pytest.raises(ValueError, match="order"):
        dpd_branch_cuda(hist, win, taps, 11)
    with pytest.raises(ValueError, match="empty"):
        dpd_branch_cuda(hist, win[:, :0], taps, 3)
    frames = torch.zeros((2, 16, 32), dtype=torch.uint8, device="cuda")
    with pytest.raises(ValueError, match="float32 or"):           # dtype
        gauss5x5_cuda(frames.to(torch.int16))
    with pytest.raises(ValueError, match="float32 or"):           # shape
        gauss5x5_cuda(frames.view(1, 2, 16, 32))
    with pytest.raises(ValueError, match="float32 or"):           # stride
        gauss5x5_cuda(frames[:, :, ::2])
    with pytest.raises(ValueError, match="outside"):
        gauss5x5_cuda(frames[:0])
    with pytest.raises(ValueError, match="CUDA tensor"):          # device
        gauss5x5_cuda(frames.cpu())
    assert (dpd_branch_cuda.launches, gauss5x5_cuda.launches) == launches
    f = torch.zeros((2, 16, 32), device="cuda")
    b4 = motion_post_cuda.launches
    with pytest.raises(ValueError, match="CUDA tensor"):          # device
        motion_post_cuda(f, f.cpu(), 40.0)
    with pytest.raises(ValueError, match="CUDA tensor"):
        motion_post_cuda(f.cpu(), f.cpu(), 40.0)
    with pytest.raises(ValueError, match="differ"):               # shapes
        motion_post_cuda(f, f[:1], 40.0)
    with pytest.raises(ValueError, match="differ"):               # dtypes
        motion_post_cuda(f, frames, 40.0)
    with pytest.raises(ValueError, match="float32 or uint8"):     # bool
        motion_post_cuda(f.bool(), f.bool(), 40.0)
    with pytest.raises(ValueError, match="float32 or uint8"):     # stride
        motion_post_cuda(f[:, :, ::2], f[:, :, ::2], 40.0)
    with pytest.raises(ValueError, match="outside"):
        motion_post_cuda(f[:0], f[:0], 40.0)
    assert motion_post_cuda.launches == b4
    q = torch.randn((1, 8, 2, 16), generator=gen, device="cuda")
    b5 = flash_attention_cuda.launches
    with pytest.raises(ValueError, match="bf16"):
        flash_attention_cuda(q.double(), q.double(), q.double())   # float64
    with pytest.raises(ValueError, match="q's type"):
        flash_attention_cuda(q, q.half(), q)                       # mixed types
    with pytest.raises(ValueError, match="multiple of 8"):
        b = torch.zeros((1, 8, 2, 12), device="cuda", dtype=torch.bfloat16)
        flash_attention_cuda(b, b, b)
    assert flash_attention_cuda.launches == b5
    x = torch.zeros((1, 4, 2, 32), device="cuda", dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="SIMT route"):             # bf16, not (64, 128)
        ssd_cuda(x, torch.zeros((1, 4, 2), device="cuda"), torch.zeros(2, device="cuda"),
                 torch.zeros((1, 4, 16), device="cuda", dtype=torch.bfloat16),
                 torch.zeros((1, 4, 16), device="cuda", dtype=torch.bfloat16))
    with pytest.raises(ValueError, match="float32"):
        z = torch.zeros((1, 4, 8), device="cuda", dtype=torch.float64)
        rglru_cuda(z, z)


def _b2_and_plain(net, cores=1, max_sweeps=1_000_000, specialize=True, state=None,
                  edit_consts=None):
    """One B2 launch and one run of its plain version on the card from the
    same state: each side's io words and tensors (rings, then actor
    tensors) after the run, as the kernel's argument block holds them."""
    dev = torch.device("cuda", torch.cuda.current_device())
    layout = lower_network(net)
    part = partition_layout(net, layout, cores, forward_transients=specialize)
    dp = compile_megakernel(net, max_sweeps, layout=layout, partition=part).device_program
    consts = ([t.to(dev) for _, t in dp.consts]
              + [torch.zeros(n, device=dev) for _, n in dp.scratch])
    if edit_consts is not None:
        edit_consts(consts)
    sides = []
    for kernel in (True, False):
        st = (state if state is not None else net.init_state()).clone()
        tensors, io = stage(dp, st, dev, consts)
        if kernel:
            ptrs = [0 if t is None else t.data_ptr() for t in tensors]
            args = torch.tensor(ptrs + io, dtype=torch.int64, device=dev)
            before = megakernel_cuda.launches
            megakernel_cuda(dp.table.to(dev), args, dp.n_ptrs, max_sweeps, True,
                            n_actors=dp.n_actors, scratch_words=int(dp.table[H_SCRATCH]),
                            moe=bool(dp.table[H_MOE]))
            assert megakernel_cuda.launches == before + 1
            io = args[dp.n_ptrs:].cpu().tolist()
        else:
            run_program(dp.table.tolist(), tensors, io, max_sweeps, True)
        torch.cuda.synchronize()
        sides.append((io, [None if t is None else t.cpu() for t in tensors]))
    return dp, sides


def _assert_b2_bit_identical(dp, sides):
    (io_k, t_k), (io_p, t_p) = sides
    # The plain version writes every io word but the grid size.
    assert io_k[:dp.io_meta + M_BLOCKS] == io_p[:dp.io_meta + M_BLOCKS]
    for i, (a, b) in enumerate(zip(t_k, t_p)):
        assert (a is None) == (b is None), i
        assert a is None or torch.equal(a, b), i


@pytest.mark.parametrize("cores", [1, 2])
@pytest.mark.parametrize("schedule", ["default", "min_active2", "all10", "static"])
@pytest.mark.parametrize("block_l", [129, 4096, 32768])
def test_megakernel_dpd_bit_identical_to_plain(gen, block_l, schedule, cores):
    """129 samples: windows at 8-byte offsets, so the bodies move 4-byte
    words (the adder single floats)."""
    n = 64
    kw = {"default": dict(active_schedule=default_active_schedule(n, seed=0)),
          "min_active2": dict(active_schedule=np.full(n, 2, np.int32)),
          "all10": dict(active_schedule=np.full(n, 10, np.int32)),
          "static": dict(static_all_active=True)}[schedule]
    net, _ = make_dpd(n, block_l=block_l, seed=0, device="cuda", **kw)
    dp, sides = _b2_and_plain(net, cores)
    assert sides[0][0][dp.io_meta] > 1          # sweeps
    _assert_b2_bit_identical(dp, sides)


@pytest.mark.parametrize("cores", [1, 2])
@pytest.mark.parametrize("rate,frame_hw", [(1, (240, 320)), (4, (240, 320)),
                                           (4, (20, 322)), (4, (12, 1030))])
def test_megakernel_motion_detection_bit_identical_to_plain(gen, rate, frame_hw, cores):
    """(20, 322): staged rows and thres windows off 16-byte words; (12, 1030):
    rows too wide for a stencil's tile, read from L2."""
    net, _ = make_motion_detection(48, rate=rate, frame_hw=frame_hw, seed=rate,
                                   device="cuda")
    _assert_b2_bit_identical(*_b2_and_plain(net, cores))


@pytest.mark.parametrize("cores", [1, 2])
def test_megakernel_domain_error_mid_run(gen, cores):
    """Named for the error this checked while B2 tabulated rates over the
    declared domain: the config's 20th token, 11, is outside the fork's and
    the branches' domain 2..10, and the kernel now runs on with the
    reference's rates (every branch on), as its plain version does."""
    net, _ = make_dpd(64, block_l=4096, seed=0, device="cuda",
                      active_schedule=default_active_schedule(64, seed=0))

    def plant(consts):
        consts[0][19] = 11

    dp, sides = _b2_and_plain(net, cores, edit_consts=plant)
    assert sides[0][0][dp.io_meta + M_ERROR] == 0
    _assert_b2_bit_identical(dp, sides)


# ---- B2's MoE bodies: router, expert, combine, packer ----------------------- #
MOE_WIDTHS = {
    "default": dict(),                                           # make_moe's
    "middle": dict(d_model=256, n_experts=8),
    "off_tile": dict(d_model=100, n_experts=5, d_ff=50, n_tokens=24, top_k=3),
    "idle": dict(n_experts=16, top_k=1, n_tokens=8, d_ff=40),    # 8 of 16 get none
}


@pytest.mark.parametrize("cores", [1, 2])
@pytest.mark.parametrize("width", sorted(MOE_WIDTHS))
def test_megakernel_moe_bit_identical_to_plain(gen, width, cores):
    """B2 on the MoE actor network equals its plain version bit for bit:
    every ring (slabs, slots, weights, outputs), every cursor, count and
    control token; at make_moe's width, at D 256 / E 8, at widths off the
    16-column and 96-row tiles, and with experts that get no token."""
    from repro_torch.graphs.factories import make_moe
    net, _ = make_moe(3, seed=1, device="cuda", **MOE_WIDTHS[width])
    dp, sides = _b2_and_plain(net, cores)
    counts = sides[0][0][dp.io_counts:dp.io_counts + dp.n_actors]
    assert counts == sides[1][0][dp.io_counts:dp.io_counts + dp.n_actors]
    _assert_b2_bit_identical(dp, sides)


@pytest.mark.parametrize("build", ["guards", "trace", "both"])
@pytest.mark.parametrize("cores", [1, 2])
def test_megakernel_moe_guarded_traced_builds_match_plain_and_dynamic(gen, cores, build):
    from repro_torch.graphs.factories import make_moe
    net, _ = make_moe(3, d_model=256, n_experts=8, seed=2, device="cuda")
    kw = dict(guards=build in ("guards", "both"), trace=build in ("trace", "both"))
    dyn = net.compile(mode="dynamic", **kw).run()
    prog = net.compile(mode="megakernel", cores=cores, specialize=False, **kw)
    before = megakernel_cuda.launches
    got = prog.run()
    assert megakernel_cuda.launches == before + 1
    assert (got.sweeps, got.fire_counts) == (dyn.sweeps, dyn.fire_counts)
    if kw["guards"]:
        assert got.diagnostics.ok and got.diagnostics.high_water == dyn.diagnostics.high_water
    if kw["trace"]:
        assert got.trace.attempt_counts() == dyn.trace.attempt_counts()


@pytest.mark.parametrize("cores", [1, 2])
def test_megakernel_moe_data_domains_match_dynamic(gen, cores):
    """DOMAIN on the MoE network's data channels (C11, B2's wide path):
    int32 slots and counts, float weights, expert outputs and the combined
    output declaring domains they leave, an expert slab one it keeps.  B2's
    guarded build names the same channels with the same high-water marks
    as the host dynamic run."""
    from repro_torch.core import NetworkFaultError
    from repro_torch.graphs.factories import make_moe
    net, _ = make_moe(3, d_model=256, n_experts=8, seed=2, device="cuda")
    net = _with_domain(net, {"f_slot": (0.0, 7.0), "f_w": (0.0, 0.5), "f_out": (-1e-3, 1e-3),
                             "f_cp0": (0.0, 3.0), "f_x1": (-100.0, 100.0),
                             "f_y2": (-1e-3, 1e-3)})
    diags = []
    for kw in (dict(mode="dynamic"), dict(mode="megakernel", specialize=False, cores=cores)):
        with pytest.raises(NetworkFaultError) as exc:
            net.compile(guards=True, **kw).run()
        d = exc.value.diagnostics
        diags.append(([(f.fifo, f.faults) for f in d.faults], d.high_water))
    assert diags[0] == diags[1]
    assert {"f_slot", "f_w", "f_out", "f_y2"} <= {f for f, _ in diags[0][0]}
    assert "f_x1" not in {f for f, _ in diags[0][0]}


@pytest.mark.parametrize("cores", [1, 2])
@pytest.mark.parametrize("max_sweeps", [1, 3, 5])
def test_megakernel_sweep_budget_exhaustion(gen, max_sweeps, cores):
    net, _ = make_motion_detection(48, rate=4, frame_hw=(240, 320), seed=0,
                                   device="cuda")
    dp, sides = _b2_and_plain(net, cores, max_sweeps=max_sweeps)
    assert sides[0][0][dp.io_meta:dp.io_meta + 2] == [max_sweeps, 1]  # stalled
    _assert_b2_bit_identical(dp, sides)


@pytest.mark.parametrize("cores", [1, 2])
def test_megakernel_resumes_a_partial_state(gen, cores):
    """A DPD run stopped by its sweep budget, then resumed by both sides
    (the unspecialized program: no channel is forwarded, so every ring
    byte and cursor carries over)."""
    net, _ = make_dpd(64, block_l=4096, seed=0, device="cuda",
                      active_schedule=default_active_schedule(64, seed=0))
    prog = net.compile(mode="megakernel", specialize=False, max_sweeps=5, cores=cores)
    with pytest.warns(RuntimeWarning, match="max_sweeps"):
        partial = prog.run().state
    dp, sides = _b2_and_plain(net, cores, specialize=False, state=partial)
    assert sides[0][0][dp.io_meta] > 1 and not sides[0][0][dp.io_meta + 1]
    _assert_b2_bit_identical(dp, sides)


# ---- B5's float32 / f16 route (flash_fwd_ffma) ---------------------------- #
# hd 8 (a quarter of a lane's column block) and 256 (8 columns a lane), hd
# not a multiple of 4 (6, the padded rows), ragged S against the 64-query
# and 32-key tiles, GQA, causal and windowed (a window shorter than a key
# tile), non-causal.
@pytest.mark.parametrize("B,S,H,Hkv,hd,causal,window", [
    (1, 1, 1, 1, 8, True, None), (2, 100, 4, 2, 8, True, None),
    (1, 130, 2, 1, 6, False, None), (1, 300, 10, 1, 256, True, 64),
    (2, 97, 4, 4, 256, False, 40), (1, 257, 6, 3, 64, True, 7)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float16])
def test_flash_attention_float_route_matches_plain(gen, dtype, B, S, H, Hkv, hd, causal,
                                                   window):
    q, k, v = (torch.randn((B, S, n, hd), generator=gen, device="cuda").to(dtype)
               for n in (H, Hkv, Hkv))
    before = dict(flash_attention_cuda.route_launches)
    got = flash_attention(q, k, v, causal=causal, window=window)
    assert flash_attention_cuda.route_launches["ffma"] == before["ffma"] + 1
    assert flash_attention_cuda.route_launches["wgmma"] == before["wgmma"]
    assert got.dtype == dtype and bool(torch.isfinite(got).all())
    want = flash_attention_ref(q, k, v, causal=causal, window=window)
    if dtype == torch.float32:
        torch.testing.assert_close(got, want, rtol=2e-4, atol=2e-4)
    else:
        w = want.float()
        rms = w.pow(2).mean(-1, keepdim=True).sqrt()
        excess = float((((got.float() - w).abs() - 2.0 ** -10 * w.abs()) / rms).max())
        assert excess <= 2.0 ** -10, excess


# ---- B6's SIMT route: any (P, N) ------------------------------------------- #
@pytest.mark.parametrize("P,N", [(16, 16), (8, 24), (5, 7)])
@pytest.mark.parametrize("B,L,H", [(1, 1, 1), (2, 300, 3), (1, 600, 4)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float16])
def test_ssd_simt_route_matches_plain(gen, dtype, B, L, H, P, N):
    x = torch.randn((B, L, H, P), generator=gen, device="cuda").to(dtype)
    dt = F.softplus(torch.randn((B, L, H), generator=gen, device="cuda"))
    A = -torch.linspace(1.0, 16.0, H, device="cuda")
    Bm = torch.randn((B, L, N), generator=gen, device="cuda").to(dtype)
    Cm = torch.randn((B, L, N), generator=gen, device="cuda").to(dtype)
    before = dict(ssd_cuda.route_launches)
    y, h = ssd(x, dt, A, Bm, Cm)
    assert ssd_cuda.route_launches["simt"] == before["simt"] + 1
    assert ssd_cuda.route_launches["tensor_cores"] == before["tensor_cores"]
    assert y.dtype == dtype and h.dtype == torch.float32
    yr, hr = ssd_ref(x.float(), dt, A, Bm.float(), Cm.float(), 256)
    bar = 3e-4 * yr.abs().max()
    if dtype == torch.float16:
        bar = bar + 2.0 ** -10 * yr.abs()
    assert bool(torch.isfinite(y.float()).all()) and bool(torch.isfinite(h).all())
    assert bool(((y.float() - yr).abs() <= bar).all())
    assert float((h - hr).abs().max()) <= 3e-4 * float(hr.abs().max())


def test_ssd_f16_operands_at_mamba2_shape_run_in_float32(gen):
    """f16 x, B, C at (64, 128) are cast to float32 by the entry and take
    the tensor-core route's float32 kernels; y comes back in f16."""
    x = torch.randn((1, 300, 4, 64), generator=gen, device="cuda").half()
    dt = F.softplus(torch.randn((1, 300, 4), generator=gen, device="cuda")).half()
    A = -torch.linspace(1.0, 16.0, 4, device="cuda").double()
    Bm, Cm = (torch.randn((1, 300, 128), generator=gen, device="cuda").half() for _ in "BC")
    before = dict(ssd_cuda.route_launches)
    y, h = ssd(x, dt, A, Bm, Cm)
    assert ssd_cuda.route_launches["tensor_cores"] == before["tensor_cores"] + 1
    yr, hr = ssd_ref(x.float(), dt.float(), A.float(), Bm.float(), Cm.float(), 256)
    assert y.dtype == torch.float16
    assert bool(((y.float() - yr).abs() <= 3e-4 * yr.abs().max() + 2.0 ** -10 * yr.abs()).all())


# ---- B2's guarded and traced builds ---------------------------------------- #
FAULTS = {"clean": None,
          "overflow": inject_overflow,
          "underflow": inject_underflow,
          "cursor": lambda net, st, f: corrupt_cursor(net, st, f, occ=1),
          "nonfinite": poison_tokens}


def _bits(state):
    """Every leaf of a state as bytes (NaN compares by its bits)."""
    return [x.contiguous().view(torch.uint8).cpu().numpy().tobytes()
            if isinstance(x, torch.Tensor) else x for x in state.leaves()]


def _health_and_trace(net, state, run, guards, trace):
    st = state.clone()
    res = run(st)
    h = (res.health.fault_words().tolist(), list(res.health.high_water)) if guards else None
    t = decode_trace(net, res.trace) if trace else None
    return (_bits(res[0]), res[1], res[2], res[3], h,
            None if t is None else (t.events.tolist(), t.dropped))


@pytest.mark.parametrize("build", ["guards", "trace", "both"])
@pytest.mark.parametrize("cores", [1, 2])
@pytest.mark.parametrize("fault", sorted(FAULTS))
def test_megakernel_guarded_traced_builds_match_plain_and_dynamic(gen, fault, cores, build):
    """DPD with each fault injected on f_in: B2's build, its plain version on
    the card and the host dynamic executor agree on every state bit, fire
    count, sweep, fault word, high-water mark and trace event (a ring of 64
    events, so a run wraps it)."""
    guards, trace = build in ("guards", "both"), build in ("trace", "both")
    net, _ = make_dpd(16, block_l=4096, seed=0, device="cuda",
                      active_schedule=default_active_schedule(16, seed=0))
    state = net.init_state()
    if FAULTS[fault] is not None:
        state = FAULTS[fault](net, state, "f_in")
    cap = 64 if trace else None
    layout = lower_network(net)
    runner = compile_megakernel(net, layout=layout,
                                partition=partition_layout(net, layout, cores,
                                                           forward_transients=False),
                                guards=guards, trace_capacity=cap)
    before = megakernel_cuda.launches
    k = _health_and_trace(net, state, runner, guards, trace)
    assert megakernel_cuda.launches == before + 1
    p = _health_and_trace(net, state, runner.plain, guards, trace)
    d = _health_and_trace(net, state, lambda st: run_dynamic(
        net, st, guards=guards, trace_capacity=cap), guards, trace)
    assert k == p == d
    if guards and fault != "clean":
        assert k[4][0][net.fifo_index["f_in"]] != 0


def _with_domain(net, domains):
    """``net`` with each channel of ``domains`` declaring its domain."""
    import dataclasses
    from repro_torch.core import Network
    fifos = [dataclasses.replace(s, domain=domains[n]) if n in domains else s
             for n, s in net.fifos.items()]
    return Network(list(net.actors.values()), fifos, list(net.edges),
                   initial_tokens=net.initial_tokens, device=net.device)


@pytest.mark.parametrize("build", ["guards", "both"])
@pytest.mark.parametrize("cores", [1, 2])
@pytest.mark.parametrize("case", ["dpd_clean", "dpd_poisoned", "md_u8"])
def test_megakernel_guarded_data_domain_matches_plain_and_dynamic(gen, case, cores, build):
    """DOMAIN on data channels (C11): DPD's f_in declaring a domain every
    clean sample lies in, clean and with one finite window of 1e3 appended
    (float bounds); motion detection's u8 frame channels declaring a domain
    the frames leave (u8 bounds, byte scans and byte stores).  B2's guarded
    build, its plain version on the card and the host dynamic executor agree
    on every state bit, count, sweep, fault word, high-water mark and trace
    event."""
    trace = build == "both"
    if case.startswith("dpd"):
        net, _ = make_dpd(16, block_l=4096, seed=0, device="cuda",
                          active_schedule=default_active_schedule(16, seed=0))
        net = _with_domain(net, {"f_in": (-16.0, 16.0)})
        state = net.init_state()
        if case == "dpd_poisoned":
            state = poison_tokens(net, state, "f_in", value=1e3)
    else:
        net, _ = make_motion_detection(12, rate=4, frame_hw=(240, 320), seed=0,
                                       device="cuda")
        net = _with_domain(net, {"f_src_gauss": (0.0, 250.0), "f_thres_med": (0.0, 254.5)})
        state = net.init_state()
    cap = 64 if trace else None
    layout = lower_network(net)
    runner = compile_megakernel(net, layout=layout,
                                partition=partition_layout(net, layout, cores,
                                                           forward_transients=False),
                                guards=True, trace_capacity=cap)
    before = megakernel_cuda.launches
    k = _health_and_trace(net, state, runner, True, trace)
    assert megakernel_cuda.launches == before + 1
    p = _health_and_trace(net, state, runner.plain, True, trace)
    d = _health_and_trace(net, state, lambda st: run_dynamic(
        net, st, guards=True, trace_capacity=cap), True, trace)
    assert k == p == d
    words = k[4][0]
    if case == "dpd_clean":
        assert not any(words)
    elif case == "dpd_poisoned":
        assert words[net.fifo_index["f_in"]] == 32     # DOMAIN alone
    else:
        assert words[net.fifo_index["f_src_gauss"]] == 32
        assert words[net.fifo_index["f_thres_med"]] == 32


@pytest.mark.parametrize("cores", [1, 2])
def test_megakernel_guarded_traced_motion_detection(gen, cores):
    net, _ = make_motion_detection(48, rate=4, frame_hw=(240, 320), seed=0, device="cuda")
    layout = lower_network(net)
    runner = compile_megakernel(net, layout=layout, guards=True, trace_capacity=4096,
                                partition=partition_layout(net, layout, cores,
                                                           forward_transients=False))
    k = _health_and_trace(net, net.init_state(), runner, True, True)
    p = _health_and_trace(net, net.init_state(), runner.plain, True, True)
    d = _health_and_trace(net, net.init_state(), lambda st: run_dynamic(
        net, st, guards=True, trace_capacity=4096), True, True)
    assert k == p == d and not any(k[4][0])


# ---- B2's guarded build on bf16 and f16 channels ------------------------ #
#: Per type: a token ``t`` one step above 1, and a domain bound ``hi`` below
#: it that rounds up to it in that type (float32 bits of ``hi`` would put
#: ``t`` outside).
HALF_ROUNDING = {torch.bfloat16: (1.0078125, 1.006), torch.float16: (1.0009765625, 1.0006)}
#: Token widths of 3, 6 and 8 halves: windows moved in 2-, 4- and 16-byte
#: words (a window of an odd count of halves ends mid-word).
HALF_CASES = [(dt, width, case) for dt in HALF_ROUNDING for width in (3, 6, 8)
              for case in ("clean", "inf", "domain_rounds_up", "domain_above")]
HALF_IDS = [f"{str(d).split('.')[-1]}-w{w}-{c}" for d, w, c in HALF_CASES]
#: The fault each case reads on every channel (none: healthy).
HALF_WANT = {"clean": None, "domain_rounds_up": None, "inf": "NONFINITE",
             "domain_above": "DOMAIN"}


def half_values(dt, width, case) -> torch.Tensor:
    """Six tokens of ``width`` values of type ``dt`` in [-1, 1], one of them
    Inf (``inf``), ``t`` (``domain_rounds_up``) or the next token up from it
    (``domain_above``)."""
    rng = np.random.default_rng(width)
    v = torch.from_numpy(rng.uniform(-1, 1, (6, width)).astype(np.float32)).to(dt)
    t, _ = HALF_ROUNDING[dt]
    if case == "inf":
        v[2, width - 1] = float("inf")
    elif case == "domain_rounds_up":
        v[4, width // 2] = t
    elif case == "domain_above":
        v[4, width // 2] = 2 * t - 1
    return v


def half_copy_chain(values: torch.Tensor, domain=None, device="cpu"):
    """source -> fork -> two sinks, one token of ``values`` a firing, on
    channels ``f_in``, ``f_a`` and ``f_b`` of ``values``' type, each
    declaring ``domain``."""
    from repro_torch.core import NetworkBuilder, static_actor
    from repro_torch.core.actor import DeviceOp
    n, width = values.shape
    data = values.to(device)

    def src_fire(st, inputs, rates):
        d, idx = st
        return (d, idx + 1), {"out": d[idx:idx + 1]}

    def sink_fire(st, inputs, rates):
        d, idx = st
        d[idx:idx + 1] = inputs["in"]
        return (d, idx + 1), {}

    source = static_actor("source", (), ("out",), src_fire, init=lambda: (data.clone(), 0),
                          ready=lambda st: st[1] < n,
                          device_op=DeviceOp("source", {"n_firings": n, "planes": 1}))
    fork = static_actor("fork", ("in",), ("a", "b"),
                        lambda st, inputs, rates: (st, {"a": inputs["in"], "b": inputs["in"]}),
                        device_op=DeviceOp("fork"))
    sinks = [static_actor(s, ("in",), (), sink_fire,
                          init=lambda: (torch.zeros_like(data), 0), finish=lambda st: st[0],
                          device_op=DeviceOp("sink", {"planes": 1}))
             for s in ("sink_a", "sink_b")]
    b = NetworkBuilder()
    b.actors(source, fork, *sinks)
    kw = dict(token_shape=(width,), dtype=values.dtype, domain=domain)
    b.connect("source.out", "fork.in", name="f_in", **kw)
    b.connect("fork.a", "sink_a.in", name="f_a", **kw)
    b.connect("fork.b", "sink_b.in", name="f_b", **kw)
    return b.build(device=device)


@pytest.mark.parametrize("cores", [1, 2])
@pytest.mark.parametrize("dt,width,case", HALF_CASES, ids=HALF_IDS)
def test_megakernel_half_guards_copy_bodies(gen, dt, width, case, cores):
    """B2's MK_GUARDS build on bf16 and f16 copy bodies: every state bit,
    count, sweep, fault word and high-water mark equal to its plain
    version's and the host dynamic run's; the state equal to the unguarded
    build's; Inf reads NONFINITE and a token past the rounded bound DOMAIN
    on every channel, the token the bound rounds up to nothing."""
    from repro_torch.core.health import DOMAIN, NONFINITE
    _, hi = HALF_ROUNDING[dt]
    values = half_values(dt, width, case)
    net = half_copy_chain(values, (-1.0, hi) if case.startswith("domain") else None, "cuda")
    layout = lower_network(net)
    part = partition_layout(net, layout, cores)
    runner = compile_megakernel(net, layout=layout, partition=part, guards=True)
    state = net.init_state()
    before = megakernel_cuda.launches
    k = _health_and_trace(net, state, runner, True, False)
    assert megakernel_cuda.launches == before + 1
    p = _health_and_trace(net, state, runner.plain, True, False)
    d = _health_and_trace(net, state, lambda st: run_dynamic(net, st, guards=True), True, False)
    assert k == p == d
    main = compile_megakernel(net, layout=layout, partition=part)(state.clone())
    assert k[0] == _bits(main[0])
    want = {None: 0, "NONFINITE": NONFINITE, "DOMAIN": DOMAIN}[HALF_WANT[case]]
    assert k[4][0] == [want] * 3
    for sink in ("sink_a", "sink_b"):
        assert torch.equal(main[0].actor(sink)[0].cpu().view(torch.int16),
                           values.view(torch.int16))


@pytest.mark.parametrize("planted", [False, True], ids=["clean", "nan_embedding"])
@pytest.mark.parametrize("cores", [1, 2])
def test_megakernel_half_guards_lm_stage_network(gen, cores, planted):
    """mamba2-780m's smoke config as 2 stages on bf16 channels, B2's
    MK_GUARDS build with a yield at each stage firing: fault words and
    high-water marks equal to the plain version's and the host dynamic
    run's, every state bit equal to the unguarded build's; a NaN planted in
    one microbatch's embedded row reads NONFINITE on every channel."""
    from repro_torch.configs import smoke_config
    from repro_torch.core.health import NONFINITE
    from repro_torch.graphs.lm_pipeline import build_lm_stage_network
    from repro_torch.models import LM
    cfg = smoke_config("mamba2-780m")
    model = LM(cfg, device="cuda", seed=0)
    tokens = torch.randint(0, cfg.vocab, (4, 64), generator=torch.Generator().manual_seed(0))
    net = build_lm_stage_network(model, cfg, tokens, 2)
    state = net.init_state().clone()
    if planted:
        state.actor("source")[0][1, 3, 5] = float("nan")
    runner = compile_megakernel(net, cores=cores, guards=True)
    before = megakernel_cuda.launches
    k = _health_and_trace(net, state, runner, True, False)
    assert megakernel_cuda.launches == before + 9
    p = _health_and_trace(net, state, runner.plain, True, False)
    d = _health_and_trace(net, state, lambda st: run_dynamic(net, st, guards=True), True, False)
    assert k == p == d
    assert k[0] == _bits(compile_megakernel(net, cores=cores)(state.clone())[0])
    assert k[4] == ([NONFINITE if planted else 0] * 3, [2, 2, 2])


# ---------------------------------------------------------------------- #
# The families' plain-PyTorch attention on the card against the CPU port:
# cross attention at whisper-small's widths, and the one-token decode on a
# bf16 and an int8 cache at internvl2-1b's.  Bar: one bf16 step of |want|
# plus 2^-4 of the RMS of want's row (chip_smoke.py's per-layer bar); int8
# values written by the card within 1 of the CPU's (their bf16 inputs may
# differ by a rounding step), scales within 2^-7 of the CPU's.
# ---------------------------------------------------------------------- #
def _row_bar_holds(got, want):
    got, want = got.float().cpu(), want.float()
    rms = want.pow(2).mean(-1, keepdim=True).sqrt()
    excess = float((((got - want).abs() - 2.0 ** -7 * want.abs()) / rms).max())
    assert bool(torch.isfinite(got).all()) and excess <= 2.0 ** -4, excess


def test_cross_attention_on_the_card_matches_the_cpu(gen):
    from repro_torch.models import attention as att
    cpu_gen = torch.Generator().manual_seed(0)
    mod = att.XAttention(768, 12, 64, gen=cpu_gen, device="cpu")
    x = torch.randn((2, 33, 768), generator=cpu_gen).bfloat16()
    enc = torch.randn((2, 1500, 768), generator=cpu_gen).bfloat16()
    want = att.cross_attention(mod, x, att.cross_kv(mod, enc, n_heads=12, head_dim=64),
                               n_heads=12, head_dim=64)
    mod_c = mod.to("cuda")
    got = att.cross_attention(mod_c, x.cuda(), att.cross_kv(mod_c, enc.cuda(), n_heads=12,
                                                            head_dim=64),
                              n_heads=12, head_dim=64)
    _row_bar_holds(got, want)


@pytest.mark.parametrize("quant", [False, True])
def test_attention_decode_on_the_card_matches_the_cpu(gen, quant):
    from repro_torch.models import attention as att
    kw = dict(n_heads=14, n_kv_heads=2, head_dim=64, rope_theta=1_000_000.0)
    cpu_gen = torch.Generator().manual_seed(1)
    mod = att.Attention(896, 14, 2, 64, gen=cpu_gen, device="cpu")
    k = torch.randn((2, 300, 2, 64), generator=cpu_gen).bfloat16()
    v = torch.randn((2, 300, 2, 64), generator=cpu_gen).bfloat16()
    cache = att.cache_from_kv(k, v, 332, quant=quant)
    cache_c = {n: t.cuda() for n, t in cache.items()}
    x = torch.randn((2, 1, 896), generator=cpu_gen).bfloat16()
    pos = torch.tensor([300, 300])
    want, cache = att.attention_decode(mod, x, cache, pos, **kw)
    got, cache_c = att.attention_decode(mod.to("cuda"), x.cuda(), cache_c, pos.cuda(), **kw)
    _row_bar_holds(got, want)
    assert torch.equal(cache_c["pos"].cpu(), cache["pos"])
    for n in ("k", "v"):
        g, w = cache_c[n].cpu(), cache[n]
        # Every slot but the one decode wrote (300) is untouched.
        assert torch.equal(torch.cat([g[:, :300], g[:, 301:]], 1),
                           torch.cat([w[:, :300], w[:, 301:]], 1))
        if quant:
            assert g.dtype == torch.int8
            assert int((g[:, 300].int() - w[:, 300].int()).abs().max()) <= 1
            s_g, s_w = cache_c[f"{n}_scale"].cpu(), cache[f"{n}_scale"]
            assert float(((s_g - s_w).abs() / s_w.clamp(min=1e-30)).max()) <= 2.0 ** -7
        else:
            _row_bar_holds(g[:, 300], w[:, 300])


# ---- B2 re-entered mid-stream, its feed and fetch bodies, B6 at batch 1 --- #
def _stream_states(sub, feed, fetch, windows, chunk):
    """The state entering each chunk of a stream of ``windows`` through the
    split network ``sub`` (feed staged, fetch zeroed), each from the host
    dynamic run of the chunks before it."""
    state, out = sub.init_state(), []
    for c in range(windows.shape[0] // chunk):
        base = state.clone()
        base.actors[base.actor_names.index(feed)] = (
            windows[c * chunk:(c + 1) * chunk].contiguous(), 0)
        base.actors[base.actor_names.index(fetch)] = (
            torch.zeros_like(base.actor(fetch)[0]), 0)
        out.append(base)
        state = run_dynamic(sub, base.clone())[0]
    return out


@pytest.mark.parametrize("cores", [1, 2])
def test_megakernel_reentered_at_every_chunk_boundary(gen, cores):
    """DPD's accelerated subnetwork (phase 23's stream at block 4096): B2
    entered from the state at each chunk boundary (non-zero cursors, the
    feed's index back at 0, the config mid-schedule) equals its plain
    version bit for bit, and its run equals the host dynamic run's."""
    from repro_torch.core.mapping import heterogeneous_split
    from repro_torch.graphs.factories import states_equal
    n, L, chunk = 64, 4096, 16
    net, _ = make_dpd(n, block_l=L, seed=0, device="cuda",
                      active_schedule=default_active_schedule(n, seed=0))
    accel = [a for a in net.actors if a not in ("source", "sink")]
    sub, (feed,), (fetch,) = heterogeneous_split(net, accel, chunk)
    wins = net.init_state().actor("source")[0].reshape(2, n, L).permute(1, 0, 2)[:, None]
    prog = sub.compile(mode="megakernel", specialize=False, cores=cores)
    for c, base in enumerate(_stream_states(sub, feed, fetch, wins.contiguous(), chunk)):
        dp, sides = _b2_and_plain(sub, cores, specialize=False, state=base)
        assert sides[0][0][dp.io_meta] >= 1, c
        _assert_b2_bit_identical(dp, sides)
        before = megakernel_cuda.launches
        got = prog.run(base)
        assert megakernel_cuda.launches == before + 1
        want = run_dynamic(sub, base.clone())
        assert got.fire_counts == want[1] and got.sweeps == want[2], c
        assert states_equal(got.state, want[0]), c


@pytest.mark.parametrize("graph", ["dpd_129", "md_rate4"])
def test_megakernel_feed_and_fetch_bodies_at_one_plane(gen, graph):
    """The feed (B2's source) and fetch (its sink) at planes=1 on
    window-major slabs: DPD's (2, 129) float32 windows (rows off 16 bytes)
    and motion detection's rate-4 u8 frames, bit for bit against the plain
    version and the host dynamic run."""
    from repro_torch.core.mapping import heterogeneous_split
    if graph == "dpd_129":
        net, _ = make_dpd(8, block_l=129, seed=0, device="cuda")
        accel = [a for a in net.actors if a not in ("source", "sink")]
        sub, (feed,), (fetch,) = heterogeneous_split(net, accel, 8)
        wins = torch.randn((8, 1, 2, 129), generator=gen, device="cuda")
    else:
        net, _ = make_motion_detection(48, rate=4, frame_hw=(20, 322), seed=4,
                                       device="cuda")
        sub, (feed,), (fetch,) = heterogeneous_split(net, ["gauss", "thres", "med"], 12)
        wins = torch.randint(0, 256, (12, 4, 20, 322), generator=gen, device="cuda",
                             dtype=torch.int32).to(torch.uint8)
    assert sub.actors[feed].device_op.params["planes"] == 1
    (base,) = _stream_states(sub, feed, fetch, wins, wins.shape[0])
    dp, sides = _b2_and_plain(sub, 1, specialize=False, state=base)
    _assert_b2_bit_identical(dp, sides)
    got = sub.compile(mode="megakernel", specialize=False).run(base)
    want = run_dynamic(sub, base.clone())[0]
    assert torch.equal(got.state.actor(fetch)[0], want.actor(fetch)[0])
    assert got.state.actor(feed)[1] == wins.shape[0] == got.state.actor(fetch)[1]


def test_ssd_at_batch_one_matches_plain(gen):
    """B6 at the LM stage network's shape: one microbatch of mamba2-780m,
    x (1, 4096, 48, 64) bf16, B/C (1, 4096, 128), chunk 256."""
    B, L, H = 1, 4096, 48
    x = torch.randn((B, L, H, 64), generator=gen, device="cuda").to(torch.bfloat16)
    dt = F.softplus(torch.randn((B, L, H), generator=gen, device="cuda"))
    A = -torch.linspace(1.0, 16.0, H, device="cuda")
    Bm = torch.randn((B, L, 128), generator=gen, device="cuda").to(torch.bfloat16)
    Cm = torch.randn((B, L, 128), generator=gen, device="cuda").to(torch.bfloat16)
    _ssd_holds_the_bar(x, dt, A, Bm, Cm)


# ---------------------------------------------------------------------- #
# The kernel entries on the card (ROADMAP C13, C14) and a train step.
# ---------------------------------------------------------------------- #
@pytest.mark.parametrize("dtype,shape,order", [
    (torch.float32, (1033,), 3), (torch.float64, (4, 1033), 10),
    (torch.float32, (3, 40), 1), (torch.bfloat16, (2, 3, 137), 5),
    (torch.float16, (3, 300), 7), (torch.float32, (4, 1033), 0),
    (torch.float64, (3, 40), 11)])
def test_dpd_branch_entry_takes_batches_types_and_orders(gen, dtype, shape, order):
    """B1's entry: streams of every float type are cast to float32; at
    orders 1..10 they launch the kernel once a row, bit for bit the plain
    version on the float32 cast; other orders run the plain version."""
    from repro_torch.kernels.dyn_fir import branch_ref, dpd_branch
    xr, xi = (torch.randn(shape, generator=gen, device="cuda").to(dtype) for _ in range(2))
    hr, hi = (torch.randn(10, generator=gen, device="cuda").to(dtype) for _ in range(2))
    for impl in (None, "pallas"):
        before = dpd_branch_cuda.launches
        got = dpd_branch(xr, xi, hr, hi, order=order, impl=impl, block=shape[-1] - 9)
        rows = int(np.prod(shape[:-1])) if 1 <= order <= 10 else 0
        assert dpd_branch_cuda.launches == before + rows
        want = branch_ref(*(t.to(torch.float32) for t in (xr, xi, hr, hi)), order)
        for g, w in zip(got, want):
            assert g.dtype == torch.float32 and g.shape == shape[:-1] + (shape[-1] - 9,)
            assert torch.equal(g, w)


def test_impl_xla_runs_the_plain_versions_on_the_card(gen):
    from repro_torch.kernels.dyn_fir import branch_ref, dpd_branch
    from repro_torch.kernels.gauss5x5 import gauss5x5, gauss5x5_ref
    from repro_torch.kernels.rglru import rglru_scan
    r = lambda *s: torch.randn(s, generator=gen, device="cuda")  # noqa: E731
    q, k = r(1, 64, 2, 32).bfloat16(), r(1, 64, 1, 32).bfloat16()
    la, gx = -r(2, 40, 16).abs(), r(2, 40, 16)
    x, dt, A, Bm = r(1, 64, 2, 16), r(1, 64, 2).abs() * 0.1, -r(2).abs(), r(1, 64, 8)
    f = r(2, 24, 32) * 100
    xs, h = r(1033), r(10)
    wrappers = (flash_attention_cuda, rglru_cuda, ssd_cuda, gauss5x5_cuda,
                motion_post_cuda, dpd_branch_cuda)
    before = [w.launches for w in wrappers]
    assert torch.equal(flash_attention(q, k, k, impl="xla"), flash_attention_ref(q, k, k))
    assert all(torch.equal(a, b) for a, b in zip(rglru(la, gx, impl="xla"),
                                                  rglru_scan(la, gx)))
    assert all(torch.equal(a, b) for a, b in zip(ssd(x, dt, A, Bm, Bm, impl="xla"),
                                                  ssd_ref(x, dt, A, Bm, Bm, 256)))
    assert torch.equal(gauss5x5(f, impl="xla"), gauss5x5_ref(f))
    assert torch.equal(motion_post(f, f * 0.5, impl="xla"), motion_post_ref(f, f * 0.5))
    assert all(torch.equal(a, b) for a, b in zip(dpd_branch(xs, xs, h, h, order=3, impl="xla"),
                                                  branch_ref(xs, xs, h, h, 3)))
    assert [w.launches for w in wrappers] == before


def test_kernel_entries_refuse_autograd_on_the_card(gen):
    q = torch.randn((1, 64, 2, 32), generator=gen, device="cuda").bfloat16().requires_grad_()
    la = torch.randn((1, 8, 4), generator=gen, device="cuda").requires_grad_()
    before = flash_attention_cuda.launches, rglru_cuda.launches
    for impl in (None, "pallas"):
        with pytest.raises(ValueError, match="kernel_impl='xla'"):
            flash_attention(q, q, q, impl=impl)
        with pytest.raises(ValueError, match="kernel_impl='xla'"):
            rglru(la, la, impl=impl)
    assert (flash_attention_cuda.launches, rglru_cuda.launches) == before
    flash_attention(q, q, q, impl="xla").float().sum().backward()
    assert q.grad is not None and bool(torch.isfinite(q.grad.float()).all())


def _bf16_step(x):
    """``x`` (bf16) one representable step up or down at every element,
    signs from a fixed seed (a zero steps up): one rounding step."""
    gen = torch.Generator(device=x.device).manual_seed(5)
    step = (torch.randint(0, 2, x.shape, generator=gen, device=x.device) * 2 - 1).short()
    bits = x.view(torch.int16)
    step = torch.where((bits & 0x7FFF) == 0, torch.ones_like(step), step)
    return (bits + step).view(torch.bfloat16)


def _lm_grads(cfg, params, batch, stepped=False):
    """``train_loss`` (``kernel_impl="xla"``) on the CPU and the gradient
    of every parameter; ``stepped``: the embedded input one bf16 step off."""
    from repro_torch.models import LM
    model = LM(cfg, device="cpu", seed=None)
    model.load_state_dict(params)
    for p in model.parameters():
        p.requires_grad_(True)
    if stepped:
        embed = model._embed
        model._embed = lambda *a, **kw: (lambda x: x + (_bf16_step(x.detach()) - x).detach())(
            embed(*a, **kw))
    total = model.train_loss(batch["tokens"], batch["labels"])[0]
    total.backward()
    return float(total.detach()), {n: p.grad.float() for n, p in model.named_parameters()}


def _row_readings(want, got, base, stepped):
    """Per leaf, the largest ratio over its rows (slices along the first
    axis) of ``got``'s error from ``want`` to ``stepped - base``."""
    out = {}
    for name, w in want.items():
        rows = w.shape[0] if w.dim() > 1 else 1
        row = lambda t: t.float().reshape(rows, -1)  # noqa: E731
        err = (row(got[name]) - row(w)).norm(dim=1)
        sens = (row(stepped[name]) - row(base[name])).norm(dim=1)
        out[name] = float(torch.where(err == 0, 0.0, err / sens).max())
    return out


@pytest.mark.parametrize("arch", ["mamba2-780m", "recurrentgemma-2b"])
def test_smoke_train_step_on_the_card_matches_the_cpu(gen, arch):
    """One train step of the smoke config on the card, whole and in 2
    microbatches (float32 grads, no warmup), from the CPU's weights and
    batch: no kernel launch (the plain versions); the loss within 2^-11
    relative of the CPU's ``train_loss`` (the CPU tests' ce bar); the
    step's gradient, read from its first AdamW moment (``m = (1 - b1) g
    s``, s the clip scale), row by row within 8x the CPU gradient's change
    under a bf16 step at the embedded input (tests/test_torch_train_grads.py's
    rule), the microbatched one likewise against the whole batch's;
    ``grad_norm`` within 8x the norm of that change, and within 2^-16 of
    the norm of the step's own gradient; and the step's params
    within one bf16 step of the CPU's ``adamw_update`` on the step's own
    gradient (tests/test_torch_train.py's bar), float32 params within 1e-6
    of the leaf's largest magnitude."""
    from repro_torch.configs import smoke_config
    from repro_torch.data import DataConfig, SyntheticLM
    from repro_torch.optim import AdamWConfig, adamw_update, global_norm, init_opt_state
    from repro_torch.train import TrainOptions, init_params, make_train_step
    cfg = smoke_config(arch)
    opt = AdamWConfig(lr=1e-3, warmup_steps=0)
    params = init_params(cfg, device="cpu", seed=0)
    raw = SyntheticLM(DataConfig(vocab=cfg.vocab, seq_len=64, global_batch=4)).batch(0)
    batch = {k: torch.from_numpy(v.astype(np.int64)) for k, v in raw.items()}
    (loss_c, g_c), (_, g_s) = (_lm_grads(cfg, params, batch, stepped=st)
                               for st in (False, True))
    p_dev = {k: v.cuda() for k, v in params.items()}
    b_dev = {k: v.cuda() for k, v in batch.items()}
    wrappers = (flash_attention_cuda, rglru_cuda, ssd_cuda)
    before = [w.launches for w in wrappers]
    outs = [make_train_step(cfg, opt, TrainOptions(microbatches=n, grad_dtype="f32"))(
        p_dev, init_opt_state(p_dev), b_dev) for n in (1, 2)]
    assert [w.launches for w in wrappers] == before
    grads = []
    for _, state, metrics in outs:
        s = min(1.0, opt.clip_norm / float(metrics["grad_norm"]))
        grads.append({k: m.cpu() / ((1 - opt.betas[0]) * s) for k, m in state["m"].items()})
    assert abs(float(outs[0][2]["loss"]) - loss_c) <= 2.0 ** -11 * abs(loss_c)
    assert max(_row_readings(g_c, grads[0], g_c, g_s).values()) <= 8.0
    assert max(_row_readings(grads[0], grads[1], g_c, g_s).values()) <= 8.0
    gn_bar = 8.0 * float(global_norm(g_s[k] - g_c[k] for k in g_c))
    for (_, _, metrics), g in zip(outs, grads):
        gn, own = float(metrics["grad_norm"]), float(global_norm(g.values()))
        assert abs(gn - float(global_norm(g_c.values()))) <= gn_bar
        assert abs(gn - own) <= 2.0 ** -16 * own
    want = adamw_update(opt, params, grads[0], init_opt_state(params))[0]
    for k, w in want.items():
        got, w = outs[0][0][k].cpu().float(), w.float()
        unit = torch.full_like(w, 1e-6 * float(w.abs().max().clamp(min=1e-30)))
        if params[k].dtype == torch.bfloat16:
            unit = torch.maximum(unit, torch.ldexp(torch.ones_like(w),
                                                   torch.frexp(w)[1] - 8) * (w != 0))
        assert float(((got - w).abs() / unit).max()) <= 1.0, k



# ---- B2's serving bodies and the yield: the LM actors in megakernel mode ---- #
@pytest.fixture(scope="module")
def serving_lm():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels run only there")
    from repro_torch.configs import smoke_config
    from repro_torch.models import LM
    cfg = smoke_config("granite-8b")
    return cfg, LM(cfg, device="cuda", seed=0)


#: Serving workloads: bench_serving.py's fast one (R 6, B 2, budgets 6 and
#: 1, Poisson arrivals), every request at step 0 with queue_depth 0 (sheds),
#: a deadline expired before the first firing and one mid-flight, and R 9
#: requests on B 3 slots with an EOS id inside the argmax range.
SERVING_CASES = ("bench", "shed", "expire", "burst")


def _serving_net(serving_lm, case, poison=None):
    from repro_torch.graphs import serving
    cfg, model = serving_lm
    rng = np.random.default_rng(9)
    R = 9 if case == "burst" else 6
    prompts = [rng.integers(1, cfg.vocab, size=7 - (i % 3)).astype(np.int32)
               for i in range(R)]
    slab, lens = serving.left_pad_prompts(prompts, 8)
    if poison is not None:
        slab[poison] = -7
    deadlines = None
    if case == "expire":
        deadlines = np.full(R, serving.NO_DEADLINE, np.int32)
        deadlines[2], deadlines[4] = -1, 4
    wl = serving.ServingWorkload(
        prompts=slab, prompt_lens=lens,
        budgets=np.array([6 if i % 2 == 0 else 1 for i in range(R)], np.int32),
        arrivals=(np.zeros(R, np.int32) if case == "shed"
                  else serving.poisson_trace(R, 2.0, seed=7)),
        deadlines=deadlines)
    return serving.build_serving_network(
        cfg, model, wl, batch_size=3 if case == "burst" else 2, max_prompt=8, max_new=6,
        eos_id=5 if case == "burst" else None, queue_depth=0 if case == "shed" else None)


def _serving_sides(net, model, cores, guards=False, trace=False, specialize=True):
    """The serving network run by B2 (with its yields), by its plain version
    on the card and by the host dynamic executor, from one fresh state:
    each side's result (:func:`_health_and_trace`), B2 launches and decode
    steps run."""
    layout = lower_network(net)
    part = partition_layout(net, layout, cores, forward_transients=specialize)
    cap = 4096 if trace else None
    runner = compile_megakernel(net, layout=layout, partition=part, guards=guards,
                                trace_capacity=cap)
    steps = [0]
    step = model.decode_step

    def counted(*a, **kw):
        steps[0] += 1
        return step(*a, **kw)
    model.decode_step = counted
    out = {}
    try:
        for label, run in (("b2", runner), ("plain", runner.plain),
                           ("dynamic", lambda st: run_dynamic(
                               net, st, 1_000_000, True, guards=guards,
                               trace_capacity=cap))):
            steps[0], before = 0, megakernel_cuda.launches
            out[label] = (_health_and_trace(net, net.init_state(), run, guards, trace),
                          megakernel_cuda.launches - before, steps[0])
    finally:
        del model.decode_step
    return out


@pytest.mark.parametrize("cores", [1, 2])
@pytest.mark.parametrize("case", SERVING_CASES)
def test_megakernel_serving_bit_identical_to_plain_and_dynamic(serving_lm, case, cores):
    """B2's admission, gate, merge and retire bodies and its yield at every
    decode firing that runs the model: every ring, cursor, control token,
    actor state (the decode caches included), fire count and sweep equal to
    its plain version's and the host dynamic run's bit for bit; one launch
    a decode step, plus one."""
    net = _serving_net(serving_lm, case)
    sides = _serving_sides(net, serving_lm[1], cores)
    (b2, launches, steps), (plain, p_launches, p_steps) = sides["b2"], sides["plain"]
    assert b2 == plain == sides["dynamic"][0]
    assert steps == p_steps == sides["dynamic"][2] > 0
    assert launches == steps + 1 and p_launches == 0


@pytest.mark.parametrize("build", ["guards", "trace", "both"])
@pytest.mark.parametrize("cores", [1, 2])
def test_megakernel_serving_guarded_traced_builds_match_plain_and_dynamic(
        serving_lm, cores, build):
    """The MK_GUARDS and MK_TRACE builds carry their words across the
    yields: fault words, high-water marks and every trace event (the
    decode step's attempt once) equal to the plain version's and the host
    dynamic run's, unspecialized as the reference's resilience tests run."""
    net = _serving_net(serving_lm, "bench")
    kw = dict(guards=build in ("guards", "both"), trace=build in ("trace", "both"))
    sides = _serving_sides(net, serving_lm[1], cores, specialize=False, **kw)
    assert sides["b2"][0] == sides["plain"][0] == sides["dynamic"][0]
    assert sides["b2"][1] == sides["b2"][2] + 1


@pytest.mark.parametrize("cores", [1, 2])
def test_megakernel_serving_poisoned_request_faults_as_dynamic(serving_lm, cores):
    """A request whose prompt leaves SLOT_DOMAIN: the guarded build flags
    DOMAIN on the channels the dynamic run flags (admission's outputs by
    their stores, gate's and decode's windows, the decode step's checked
    at the resume after it), with the same high-water marks, and every
    leaf, NaN caches included, bit for bit."""
    net = _serving_net(serving_lm, "bench", poison=3)
    sides = _serving_sides(net, serving_lm[1], cores, guards=True, specialize=False)
    assert sides["b2"][0] == sides["plain"][0] == sides["dynamic"][0]
    faults, _ = sides["b2"][0][4]
    assert any(faults)


@pytest.mark.parametrize("specialize", [True, False])
@pytest.mark.parametrize("cores", [1, 2])
def test_megakernel_lm_stage_network_matches_static(gen, cores, specialize):
    """mamba2-780m's smoke config as 2 stages over 4 microbatches: the
    source and sink bodies on bf16 windows, a yield at each of the 8 stage
    firings (9 launches), activations bit for bit the static run's and the
    plain version's."""
    from repro_torch.configs import smoke_config
    from repro_torch.graphs.lm_pipeline import build_lm_stage_network
    from repro_torch.models import LM
    cfg = smoke_config("mamba2-780m")
    model = LM(cfg, device="cuda", seed=0)
    tokens = torch.randint(0, cfg.vocab, (4, 64), generator=torch.Generator().manual_seed(0))
    net = build_lm_stage_network(model, cfg, tokens, 2)
    static = net.compile(mode="static", n_iterations=4)
    want = static.collect("sink", static.run().state)
    prog = net.compile(mode="megakernel", cores=cores, specialize=specialize)
    before = megakernel_cuda.launches
    res = prog.run()
    assert megakernel_cuda.launches == before + 9
    assert res.fire_counts == {"source": 4, "stage0": 4, "stage1": 4, "sink": 4}
    got = prog.collect("sink", res.state)
    assert got.dtype == torch.bfloat16 and torch.equal(got, want)
    plain = compile_megakernel(net, cores=cores).plain(net.init_state())
    assert torch.equal(plain[0].actor("sink")[0], want)

"""The Motion Detection application — paper §4.1, Fig. 4.

Five actors: Source -> Gauss -> Thres -> Med -> Sink.  Gauss feeds Thres
through *two* channels, one of which carries an initial (delay) token: the
one-frame delay that enables consecutive-frame subtraction (the dotted
channel in Fig. 4, an Eq. 1 triple buffer with the Fig. 2 copy-back).

Frames are 320x240 8-bit grayscale: tokens are uint8 frames of 76 800
bytes, so Eq. 1 reproduces Table 1's buffer memory.  Arithmetic inside the
actors runs in float32 and is rounded back to u8 at every port (half to
even, as the reference's ``jnp.round``).  Token rate 1 is the GPP-style
configuration, 4 the accelerated one (paper §4.3).

On the card every Gauss firing is one launch of the Hopper kernel B3
(u8 window in, u8 window out); Thres and Med are plain PyTorch in the host
modes, as the reference's are plain ``jnp``.  The reference's
``gauss_impl`` switch has no counterpart: the window's device picks the
kernel (CUDA) or its plain version (CPU).  Every actor also declares its
:class:`~repro_torch.core.actor.DeviceOp`, which is what the megakernel
mode runs inside one launch of B2.
"""
from __future__ import annotations

from typing import Any, Optional, Tuple

import numpy as np
import torch

from repro_torch.core import NetworkBuilder, static_actor
from repro_torch.core.actor import DeviceOp
from repro_torch.core.network import Network
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.kernels.gauss5x5 import gauss5x5_u8, to_u8
from repro_torch.kernels.motion_post import DEFAULT_THRESHOLD, med_ref, thres_ref

FRAME_H, FRAME_W = 240, 320


def build_motion_detection(n_frames: int, rate: int = 1,
                           frame_hw: Tuple[int, int] = (FRAME_H, FRAME_W),
                           threshold: float = DEFAULT_THRESHOLD,
                           video: Optional[Any] = None,
                           device: DeviceLike = None) -> Network:
    """Build the 5-actor MD network for ``n_frames`` frames on ``device``
    (the CUDA card when None).

    ``n_frames`` must be divisible by ``rate`` (windows of ``rate`` frames
    per firing).  ``video``: optional (n_frames, H, W) array staged into
    the source, rounded to u8; zeros when None.
    """
    dev = resolve_device(device)
    H, W = frame_hw
    if n_frames % rate:
        raise ValueError(f"n_frames={n_frames} not divisible by rate={rate}")
    n_iter = n_frames // rate
    tok = (H, W)

    # Staged once; the source only reads it, so every init_state shares it.
    staged = (torch.zeros((n_frames, H, W), dtype=torch.uint8, device=dev)
              if video is None
              else to_u8(torch.as_tensor(np.asarray(video, np.float32)).to(dev)))
    if tuple(staged.shape) != (n_frames, H, W):
        raise ValueError(f"video shape {tuple(staged.shape)} != "
                         f"{(n_frames, H, W)}")

    def src_fire(state, inputs, rates):
        data, idx = state
        return (data, idx + 1), {"out": data[idx * rate:(idx + 1) * rate]}

    source = static_actor(
        "source", (), ("out",), src_fire, init=lambda: (staged, 0),
        ready=lambda st: st[1] < n_iter,
        device_op=DeviceOp("source", {"n_firings": n_iter, "planes": 1}))

    def gauss_fire(state, inputs, rates):
        out = gauss5x5_u8(inputs["in"])
        # One filtered stream feeds two channels (direct + delayed).
        return state, {"out": out, "out_d": out}

    gauss = static_actor("gauss", ("in",), ("out", "out_d"), gauss_fire,
                         cost_flops=rate * H * W * 10 * 2,  # separable 5+5 MACs
                         device_op=DeviceOp("gauss"))

    def thres_fire(state, inputs, rates):
        out = thres_ref(inputs["cur"].to(torch.float32),
                        inputs["prev"].to(torch.float32), threshold)
        return state, {"out": to_u8(out)}

    thres = static_actor("thres", ("cur", "prev"), ("out",), thres_fire,
                         cost_flops=rate * H * W * 3,
                         device_op=DeviceOp("thres", {"threshold": threshold}))

    def med_fire(state, inputs, rates):
        return state, {"out": to_u8(med_ref(inputs["in"].to(torch.float32)))}

    med = static_actor("med", ("in",), ("out",), med_fire,
                       cost_flops=rate * H * W * 12, device_op=DeviceOp("med"))

    def sink_fire(state, inputs, rates):
        data, idx = state
        data[idx * rate:(idx + 1) * rate] = inputs["in"]
        return (data, idx + 1), {}

    sink = static_actor(
        "sink", ("in",), (), sink_fire,
        init=lambda: (torch.zeros((n_frames, H, W), dtype=torch.uint8,
                                  device=dev), 0),
        finish=lambda st: st[0], device_op=DeviceOp("sink", {"planes": 1}))

    u8 = torch.uint8
    b = NetworkBuilder()
    b.actors(source, gauss, thres, med, sink)
    b.connect("source.out", "gauss.in", rate=rate, token_shape=tok, dtype=u8,
              name="f_src_gauss")
    b.connect("gauss.out", "thres.cur", rate=rate, token_shape=tok, dtype=u8,
              name="f_gauss_thres")
    # The dotted Fig. 4 channel: one initial (delay) token -> Eq. 1 triple
    # buffer, enabling consecutive-frame subtraction.
    b.connect("gauss.out_d", "thres.prev", rate=rate, token_shape=tok,
              dtype=u8, delay=1, name="f_gauss_thres_d")
    b.connect("thres.out", "med.in", rate=rate, token_shape=tok, dtype=u8,
              name="f_thres_med")
    b.connect("med.out", "sink.in", rate=rate, token_shape=tok, dtype=u8,
              name="f_med_sink")
    return b.build(device=dev)


def bench_workload(n_frames: int, rate: int = 4,
                   frame_hw: Tuple[int, int] = (FRAME_H, FRAME_W),
                   seed: int = 0, device: DeviceLike = None,
                   **build_kw) -> Network:
    """MD staged with reproducible uniform random frames (the reference's
    ``bench_workload``: ``numpy`` seed ``seed``, values in [0, 255))."""
    rng = np.random.default_rng(seed)
    video = rng.uniform(0, 255, (n_frames,) + tuple(frame_hw)).astype(np.float32)
    return build_motion_detection(n_frames, rate=rate, frame_hw=frame_hw,
                                  video=video, device=device, **build_kw)

"""Hand-written Hopper kernels, each beside its plain PyTorch version.

Sources live in ``repro_torch/csrc`` and are built by :mod:`._build` at
first launch."""

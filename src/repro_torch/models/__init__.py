"""The model stack: layers, attention (B5), RG-LRU (B7), Mamba2 (B6) and
the LM that assembles them."""
from repro_torch.models.lm import LM, layer_kinds, layer_plan

__all__ = ["LM", "layer_kinds", "layer_plan"]

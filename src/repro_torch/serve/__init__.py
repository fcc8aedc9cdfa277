"""Serving: the batched prefill + greedy decode engine."""
from repro_torch.serve.engine import Engine, Request, Result, ServeConfig

__all__ = ["Engine", "Request", "Result", "ServeConfig"]

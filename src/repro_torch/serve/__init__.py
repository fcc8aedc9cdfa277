"""Serving: the batched prefill + greedy decode engine, and the engine on
the dynamic-rate actor network."""
from repro_torch.serve.actor_engine import ActorEngine
from repro_torch.serve.engine import Engine, Request, Result, ServeConfig

__all__ = ["ActorEngine", "Engine", "Request", "Result", "ServeConfig"]

"""The paper's applications built on the port's model of computation, and
the MoE layer as an actor network."""


def __getattr__(name):
    # moe_as_actors pulls in the model stack; import it on first use.
    if name == "build_moe_network":
        from repro_torch.graphs.moe_as_actors import build_moe_network
        return build_moe_network
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")

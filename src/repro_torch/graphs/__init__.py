"""The paper's applications built on the port's model of computation, the
MoE layer as an actor network, and LM blocks as pipeline stages."""


def __getattr__(name):
    # moe_as_actors and lm_pipeline pull in the model stack; import them on
    # first use.
    if name == "build_moe_network":
        from repro_torch.graphs.moe_as_actors import build_moe_network
        return build_moe_network
    if name in ("build_lm_stage_network", "lm_stage_network_forward"):
        from repro_torch.graphs import lm_pipeline
        return getattr(lm_pipeline, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")

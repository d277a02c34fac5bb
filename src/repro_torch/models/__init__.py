"""Decoder substrate of the port (config schema, attention, Mamba, dense and
MoE FFNs, assembly, serving API, weight conversion from the JAX package)."""

"""Dense decoder substrate of the port (configs schema, attention, FFN,
assembly, serving API, weight conversion from the JAX package)."""

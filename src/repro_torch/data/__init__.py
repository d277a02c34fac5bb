"""Training data of the port: the reference's synthetic token source and
sample -> pack -> batch circuit on the ported Workspace."""

from .pipeline import TokenSource, build_data_pipeline, next_batch, synthetic_batch

__all__ = ["TokenSource", "build_data_pipeline", "next_batch", "synthetic_batch"]

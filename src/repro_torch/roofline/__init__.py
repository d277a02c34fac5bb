"""Roofline of the port's steps on H100s (port of ``repro.roofline``): ops
counted on one rank (``op_costs``), priced by ``model`` with kernel regions
credited at their kernels' IO (``kernel_credit``)."""

from .model import (
    H100_SXM,
    HardwareSpec,
    RooflineReport,
    analyze,
    collective_bytes,
    model_flops,
    ring_weight,
)
from .op_costs import OpCounter

__all__ = [
    "H100_SXM",
    "HardwareSpec",
    "OpCounter",
    "RooflineReport",
    "analyze",
    "collective_bytes",
    "model_flops",
    "ring_weight",
]

"""Optimizer, schedules and cross-pod gradient compression of the port
(``repro.optim``), written by hand on trees of torch tensors."""

from .adamw import adamw_init, adamw_update, global_norm
from .compress import (
    compress_state_init,
    dequantize_int8,
    ef_compress,
    quantize_int8,
)
from .schedules import constant_lr, cosine_warmup, linear_warmup

__all__ = [
    "adamw_init", "adamw_update", "global_norm",
    "quantize_int8", "dequantize_int8", "ef_compress", "compress_state_init",
    "cosine_warmup", "linear_warmup", "constant_lr",
]

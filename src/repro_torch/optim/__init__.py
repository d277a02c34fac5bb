"""Optimizer and schedules of the port (``repro.optim``), written by hand on
trees of torch tensors. Int8 error-feedback compression across pods
(``repro.optim.compress``) waits for sharding (ROADMAP queue 1, item 6)."""

from .adamw import adamw_init, adamw_update, global_norm
from .schedules import constant_lr, cosine_warmup, linear_warmup

__all__ = [
    "adamw_init", "adamw_update", "global_norm",
    "cosine_warmup", "linear_warmup", "constant_lr",
]

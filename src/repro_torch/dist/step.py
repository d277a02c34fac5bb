"""Serve step functions on one device.

Port of ``repro.dist.step.make_serve_fns`` without sharding (that comes with
the distribution slice). The returned functions run under
``torch.inference_mode()``; instead of donating the state, as the jitted JAX
steps do, they update the caches' K/V in place.
"""

from __future__ import annotations

import torch

from repro_torch.models.common import resolve_device
from repro_torch.models.registry import decode_step, prefill


def make_serve_fns(model, device="cuda", *, max_len: int, global_batch: int):
    """Returns (prefill_fn, decode_fn):
      prefill_fn(params, tokens, state) -> (logits (B, V), state)
      decode_fn(params, tokens, state) -> (logits (B, V), state)
    for states made by ``init_serve_state(model, global_batch, max_len, device)``.
    Raises if ``device`` is CUDA and no card is present."""
    dev = resolve_device(device)

    def _check(tokens: torch.Tensor, state: dict) -> None:
        if tokens.device.type != dev.type or tokens.shape[0] != global_batch:
            raise ValueError(
                f"tokens {tuple(tokens.shape)} on {tokens.device}: want batch {global_batch} on {dev}"
            )
        caches = state["caches"]
        if len(caches) != model.cfg.n_layers:
            raise ValueError(f"{len(caches)} caches for {model.cfg.n_layers} layers")
        for i, c in enumerate(caches):
            # attention: K/V (B, max_len, KVH, Dh); Mamba: h (B, Di, N), conv (B, K-1, Di)
            arrays = (c["k"], c["v"]) if "k" in c else (c["h"], c["conv"])
            lead = (global_batch, max_len) if "k" in c else (global_batch,)
            for a in arrays:
                if a.shape[: len(lead)] != lead or a.device.type != dev.type:
                    raise ValueError(f"layer {i} cache {tuple(a.shape)} on {a.device}: "
                                     f"want {lead + ('...',)} on {dev}")

    @torch.inference_mode()
    def prefill_fn(params, tokens, state):
        _check(tokens, state)
        return prefill(model, params, tokens, state)

    @torch.inference_mode()
    def decode_fn(params, tokens, state):
        _check(tokens, state)
        return decode_step(model, params, tokens, state)

    return prefill_fn, decode_fn

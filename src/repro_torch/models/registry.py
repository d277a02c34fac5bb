"""Public model API for serving: build a Model and step it.

Port of the serving half of ``repro.models.registry``: ``prefill`` and
``decode_step`` are functions of (params, tokens, state). The state holds
one cache per layer, of that layer's mixer: an attention layer's K/V are
updated in place, a Mamba layer's (h, conv window) state is replaced. The
state's ``t`` and each attention cache's ``index`` are host ``int``s.
"""

from __future__ import annotations

from typing import Optional

import torch

from .common import ArchConfig
from .transformer import Model


def build_model(cfg: ArchConfig) -> Model:
    return Model(cfg)


def init_serve_state(model: Model, batch: int, max_len: int, device="cuda") -> dict:
    return {"caches": model.init_cache(batch, max_len, device), "t": 0}


def prefill(
    model: Model,
    params: dict,
    tokens: torch.Tensor,  # (B, Lp)
    state: dict,
    kernels: Optional[dict] = None,
):
    """Run the prompt through the trunk filling the caches; returns
    (last_logits (B, V), state)."""
    x = model.embed(params, tokens)
    B, L, _ = x.shape
    positions = state["t"] + torch.arange(L, device=tokens.device).expand(B, L)
    x, _, caches = model.trunk(params, x, positions, caches=state["caches"], kernels=kernels)
    logits = model.logits(params, x[:, -1:])[:, 0]
    return logits, {"caches": caches, "t": state["t"] + L}


def decode_step(
    model: Model,
    params: dict,
    tokens: torch.Tensor,  # (B, 1) the latest sampled token
    state: dict,
    kernels: Optional[dict] = None,
):
    """One autoregressive step against the KV / SSM caches."""
    x = model.embed(params, tokens)
    B = tokens.shape[0]
    positions = torch.full((B, 1), state["t"], dtype=torch.int64, device=tokens.device)
    x, _, caches = model.trunk(params, x, positions, caches=state["caches"], kernels=kernels)
    logits = model.logits(params, x)[:, 0]  # (B, V)
    return logits, {**state, "caches": caches, "t": state["t"] + 1}


@torch.inference_mode()
def greedy_generate(
    model: Model,
    params: dict,
    prompt: torch.Tensor,  # (B, Lp)
    n_steps: int,
    max_len: int,
) -> torch.Tensor:
    """Reference greedy sampler used by tests; returns (B, n_steps) tokens."""
    state = init_serve_state(model, prompt.shape[0], max_len, prompt.device)
    logits, state = prefill(model, params, prompt, state)
    tok = logits.argmax(dim=-1).to(prompt.dtype)[:, None]
    toks = [tok]
    for _ in range(n_steps - 1):
        logits, state = decode_step(model, params, tok, state)
        tok = logits.argmax(dim=-1).to(prompt.dtype)[:, None]
        toks.append(tok)
    return torch.cat(toks, dim=1)

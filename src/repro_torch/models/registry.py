"""Public model API: build a Model, its training loss, and its serve steps.

Port of ``repro.models.registry``: ``train_loss``, ``prefill`` and
``decode_step`` are functions of (params, batch or tokens, state).
``train_loss`` trains the dense layouts: a layout with an MoE FFN or a Mamba
mixer raises, since their kernels have no backward yet (ROADMAP K7), and so
do frames and prefix inputs (ROADMAP queue 1, item 5). The state holds
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


def check_trainable(cfg: ArchConfig) -> None:
    """Raise for a layout whose gradient the port cannot take on the card."""
    kinds = {s.mixer for s in cfg.layout} | {s.ffn for s in cfg.layout}
    if kinds & {"moe", "mamba"}:
        raise NotImplementedError(
            f"{cfg.name}: training an {'/'.join(sorted(kinds & {'moe', 'mamba'}))} layout needs the "
            "moe_gmm and mamba_scan backward kernels (ROADMAP K7), not written yet"
        )


def train_loss(
    model: Model,
    params: dict,
    batch: dict,
    kernels: Optional[dict] = None,
    aux_weight: float = 0.01,
):
    """batch: tokens (B, L) int32, labels (B, L) int32 (-1 ignore). Returns
    (loss, metrics): loss = ce + aux_weight * aux, both f32 scalars."""
    cfg = model.cfg
    check_trainable(cfg)
    if cfg.encoder_layers or cfg.frontend != "none" or "frames" in batch or "prefix" in batch:
        raise NotImplementedError(
            f"{cfg.name}: frames and prefix inputs are not ported yet (ROADMAP.md queue 1, item 5)"
        )
    tokens, labels = batch["tokens"], batch["labels"]
    x = model.embed(params, tokens)
    B, L = tokens.shape
    positions = torch.arange(L, device=tokens.device).expand(B, L)
    x, aux, _ = model.trunk(params, x, positions, kernels=kernels)
    ce = model.chunked_loss(params, x, labels)
    loss = ce + aux_weight * aux
    return loss, {"ce": ce, "aux": aux}


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

"""Public model API: build a Model, its training loss, and its serve steps.

Port of ``repro.models.registry``: ``train_loss``, ``prefill`` and
``decode_step`` are functions of (params, batch or tokens, state).
``train_loss`` trains every layout: dense, MoE and hybrid Mamba (the MoE and
Mamba layers through their kernels' backward, K7a and K7b, paired with the
forwards in ``moe.MoeGmm`` and ``mamba.MambaScan``), MLA (attention at Dk 96
/ Dv 64 through K1), an encoder-decoder (the batch's ``frames`` encoded into
the memory that each decoder layer's cross-attention reads) and a vision
prefix (the batch's ``prefix`` before the tokens, its labels -1), as the
reference's does. The state holds
one cache per layer, of that layer's mixer: an attention layer's K/V (or MLA
latents) and, at decode, a Mamba layer's (h, conv window) state are updated
in place (prefill replaces the Mamba state). The state's ``t`` and each
cache's ``index`` are host ``int``s, for the checks and the refusals; a
decode step reads its position from a device tensor (``decode_step``'s
``t``), from which a plain K/V cache's written slot and count follow, so
that the step can be captured in a CUDA graph and replayed
(``dist.step.DecodeGraph``).

Serving an encoder-decoder, ``prefill`` encodes the frames into
``state["memory"]``, as the reference does, and also keeps each decoder
layer's cross-attention K and V of that memory in ``state["memory_kv"]``:
the reference computes them again at every decode step
(``repro/models/transformer.py:102-103``); they depend on the memory alone,
so the values are the same. A vision prefix goes before the prompt's
tokens, and positions run over both.
"""

from __future__ import annotations

from typing import Optional

import torch

from repro_torch.obs import span

from .common import ArchConfig
from .transformer import Model


def build_model(cfg: ArchConfig) -> Model:
    return Model(cfg)


def train_loss(
    model: Model,
    params: dict,
    batch: dict,
    kernels: Optional[dict] = None,
    aux_weight: float = 0.01,
):
    """batch: tokens (B, L) int32, labels (B, L) int32 (-1 ignore), and
    ``frames`` (B, T, D) for an encoder-decoder or ``prefix`` (B, Lf, D)
    stub embeddings for a model with a frontend (ignored without one, as in
    the reference). Returns (loss, metrics): loss = ce + aux_weight * aux,
    both f32 scalars."""
    cfg = model.cfg
    tokens, labels = batch["tokens"], batch["labels"]
    x = model.embed(params, tokens)
    B, L = tokens.shape
    positions = torch.arange(L, device=tokens.device).expand(B, L)
    memory = None
    if cfg.encoder_layers:
        if "frames" not in batch:
            raise ValueError(f"{cfg.name}: an encoder-decoder trains on a batch with frames")
        memory = model.encode(params, batch["frames"], kernels=kernels)
    if cfg.frontend != "none" and "prefix" in batch:
        prefix = batch["prefix"].to(x.dtype)  # (B, Lf, D)
        x = torch.cat([prefix, x], dim=1)
        positions = torch.arange(x.shape[1], device=tokens.device).expand(B, x.shape[1])
        labels = torch.cat([torch.full((B, prefix.shape[1]), -1, dtype=labels.dtype, device=labels.device),
                            labels], dim=1)
    x, aux, _ = model.trunk(params, x, positions, kernels=kernels, memory=memory)
    ce = model.chunked_loss(params, x, labels)
    loss = ce + aux_weight * aux
    return loss, {"ce": ce, "aux": aux}


def init_serve_state(model: Model, batch: int, max_len: int, device="cuda", rules: Optional[dict] = None) -> dict:
    """{"caches": one per layer, "t": 0} on ``device``. On a DeviceMesh, this
    rank's shards of the caches of the global ``batch``, placed by the serve
    rules (``rules``, default ``make_rules(cfg, mesh, "serve", batch)``;
    ``repro_torch.dist.step.placed_serve_state``)."""
    if getattr(device, "mesh_dim_names", None) is not None:
        from repro_torch.dist.step import placed_serve_state

        return placed_serve_state(model, batch, max_len, device, rules)
    return {"caches": model.init_cache(batch, max_len, device), "t": 0}


def prefill(
    model: Model,
    params: dict,
    tokens: torch.Tensor,  # (B, Lp)
    state: dict,
    kernels: Optional[dict] = None,
    frames: Optional[torch.Tensor] = None,  # (B, T, D): an encoder-decoder's
    prefix: Optional[torch.Tensor] = None,  # (B, Lf, D): stub embeddings before the tokens
):
    """Run the prompt (after ``prefix``) through the trunk filling the
    caches; returns (last_logits (B, V), state)."""
    cfg = model.cfg
    if cfg.encoder_layers and frames is None:
        raise ValueError(f"{cfg.name}: an encoder-decoder prefills with frames")
    with span("embed"):
        x = model.embed(params, tokens)
    if prefix is not None:
        x = torch.cat([prefix.to(x.dtype), x], dim=1)
    B, L, _ = x.shape
    positions = state["t"] + torch.arange(L, device=tokens.device).expand(B, L)
    new_state = {"t": state["t"] + L}
    cross_kvs = None
    if cfg.encoder_layers:
        new_state["memory"] = model.encode(params, frames, kernels=kernels)
        new_state["memory_kv"] = cross_kvs = model.memory_kv(params, new_state["memory"])
    x, _, caches = model.trunk(params, x, positions, caches=state["caches"], kernels=kernels,
                               cross_kvs=cross_kvs)
    with span("head"):
        logits = model.logits(params, x[:, -1:])[:, 0]
    return logits, {"caches": caches, **new_state}


def decode_step(
    model: Model,
    params: dict,
    tokens: torch.Tensor,  # (B, 1) the latest sampled token
    state: dict,
    kernels: Optional[dict] = None,
    t: Optional[torch.Tensor] = None,  # (1,) int64 on the tokens' device: the step's position
):
    """One autoregressive step against the KV / SSM caches (and the encoder
    memory's K/V that prefill kept). The position comes from ``t``, a
    device tensor (by default made from ``state["t"]``): a CUDA graph hands
    in its own buffer, which it sets before each replay."""
    with span("embed"):
        x = model.embed(params, tokens)
    B = tokens.shape[0]
    if t is None:
        t = torch.full((1,), state["t"], dtype=torch.int64, device=tokens.device)
    positions = t.view(1, 1).expand(B, 1).contiguous()
    x, _, caches = model.trunk(params, x, positions, caches=state["caches"], kernels=kernels,
                               cross_kvs=state.get("memory_kv"))
    with span("head"):
        logits = model.logits(params, x)[:, 0]  # (B, V)
    return logits, {**state, "caches": caches, "t": state["t"] + 1}


@torch.inference_mode()
def greedy_generate(
    model: Model,
    params: dict,
    prompt: torch.Tensor,  # (B, Lp)
    n_steps: int,
    max_len: int,
    frames: Optional[torch.Tensor] = None,
    prefix: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Reference greedy sampler used by tests; returns (B, n_steps) tokens."""
    state = init_serve_state(model, prompt.shape[0], max_len, prompt.device)
    logits, state = prefill(model, params, prompt, state, frames=frames, prefix=prefix)
    tok = logits.argmax(dim=-1).to(prompt.dtype)[:, None]
    toks = [tok]
    for _ in range(n_steps - 1):
        logits, state = decode_step(model, params, tok, state)
        tok = logits.argmax(dim=-1).to(prompt.dtype)[:, None]
        toks.append(tok)
    return torch.cat(toks, dim=1)

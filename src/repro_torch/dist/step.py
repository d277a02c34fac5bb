"""Train and serve step functions on one device.

Port of ``repro.dist.step`` without sharding (that comes with the
distribution slice, ROADMAP queue 1 item 6). Instead of donating the state,
as the jitted JAX steps do, the steps update it in place: the train step its
params, moments and step count under ``torch.no_grad()``; the serve
functions, under ``torch.inference_mode()``, the caches' K/V.
"""

from __future__ import annotations

from typing import Callable

import torch

from repro_torch.models import attention as attn
from repro_torch.models.common import resolve_device
from repro_torch.models.registry import decode_step, prefill, train_loss
from repro_torch.optim import adamw_update
from repro_torch.optim.adamw import tree_leaves, tree_map


def make_train_state_specs(model) -> dict:
    """The train state {params, opt {m, v, count}, step} as meta tensors of
    the right shapes and dtypes (no parameter is allocated): m and v f32
    mirror the params, count and step are int32 scalars."""
    params = model.init(0, "meta")
    f32 = lambda p: torch.empty(p.shape, dtype=torch.float32, device="meta")
    scalar = lambda: torch.empty((), dtype=torch.int32, device="meta")
    return {
        "params": params,
        "opt": {"m": tree_map(f32, params), "v": tree_map(f32, params), "count": scalar()},
        "step": scalar(),
    }


def make_train_step(
    model,
    device,
    schedule: Callable,
    *,
    global_batch: int,
    microbatches: int = 1,
    compress_pods: bool = False,
):
    """Returns ``train_step(state, batch) -> (state, metrics)`` on ``device``.

    ``state`` is {"params", "opt": adamw state, "step": int32 scalar}, all on
    ``device``; the step updates it in place and returns it. ``batch`` holds
    tokens and labels (B, L) int32, and ``frames`` or ``prefix`` (B, T, D)
    where the model takes them (``registry.train_loss``). metrics: loss, lr,
    grad_norm and clip_scale, f32 scalars on the device. ``microbatches > 1``
    sums f32 gradients over equal splits of the batch (every key's rows) and
    divides by their number, as the reference does. Raises if ``device`` is
    CUDA and no card is present."""
    dev = resolve_device(device)
    if compress_pods:
        raise NotImplementedError(
            "compress_pods: int8 gradient compression across pods needs sharding "
            "(ROADMAP.md queue 1, item 6)"
        )
    if microbatches < 1 or global_batch % microbatches:
        raise ValueError(f"global_batch {global_batch} not divisible by microbatches {microbatches}")

    def loss_and_grads(params, batch):
        leaves = [p.detach().requires_grad_() for p in tree_leaves(params)]
        it = iter(leaves)
        live = tree_map(lambda _: next(it), params)
        loss, _ = train_loss(model, live, batch)
        return loss.detach(), torch.autograd.grad(loss, leaves)

    def train_step(state, batch):
        tokens = batch["tokens"]
        if tokens.device.type != dev.type or tokens.shape[0] != global_batch:
            raise ValueError(f"tokens {tuple(tokens.shape)} on {tokens.device}: want batch "
                             f"{global_batch} on {dev}")
        params = state["params"]
        lr = schedule(state["step"]).to(torch.float32)
        if microbatches > 1:
            n = global_batch // microbatches
            gsum = [torch.zeros(p.shape, dtype=torch.float32, device=p.device) for p in tree_leaves(params)]
            lsum = torch.zeros((), dtype=torch.float32, device=tokens.device)
            for i in range(microbatches):
                loss, grads = loss_and_grads(params, {k: v[i * n : (i + 1) * n] for k, v in batch.items()})
                for a, g in zip(gsum, grads):
                    a.add_(g.float())
                lsum = lsum + loss
                del grads
            grads = [a / microbatches for a in gsum]
            loss = lsum / microbatches
        else:
            loss, grads = loss_and_grads(params, batch)
        it = iter(grads)
        grads = tree_map(lambda _: next(it), params)
        with torch.no_grad():
            om = adamw_update(params, grads, state["opt"], lr)
            state["step"].add_(1)
        return state, {"loss": loss, "lr": lr, "grad_norm": om["grad_norm"], "clip_scale": om["clip_scale"]}

    return train_step


def make_serve_fns(model, device="cuda", *, max_len: int, global_batch: int):
    """Returns (prefill_fn, decode_fn):
      prefill_fn(params, tokens, state, frames=None, prefix=None) -> (logits (B, V), state)
      decode_fn(params, tokens, state) -> (logits (B, V), state)
    for states made by ``init_serve_state(model, global_batch, max_len, device)``.
    Each checks the tokens and every layer's cache (and an encoder's memory)
    against those sizes first. Raises if ``device`` is CUDA and no card is
    present."""
    dev = resolve_device(device)
    cfg = model.cfg

    def _want(name: str, a: torch.Tensor, shape: tuple) -> None:
        if tuple(a.shape) != shape or a.device.type != dev.type:
            raise ValueError(f"{name} {tuple(a.shape)} on {a.device}: want {shape} on {dev}")

    def _check(tokens: torch.Tensor, state: dict, frames=None, prefix=None) -> None:
        B = global_batch
        if tokens.device.type != dev.type or tokens.shape[0] != B:
            raise ValueError(f"tokens {tuple(tokens.shape)} on {tokens.device}: want batch {B} on {dev}")
        caches = state["caches"]
        if len(caches) != cfg.n_layers:
            raise ValueError(f"{len(caches)} caches for {cfg.n_layers} layers")
        S = attn.cache_slots(cfg, max_len)
        for i, c in enumerate(caches):
            spec = cfg.layout[i % len(cfg.layout)]
            if spec.mixer == "mamba":
                _want(f"layer {i} cache h", c["h"], (B, cfg.d_inner, cfg.ssm_state))
                _want(f"layer {i} cache conv", c["conv"], (B, cfg.ssm_conv - 1, cfg.d_inner))
            elif cfg.attention == "mla":
                _want(f"layer {i} cache c_kv", c["c_kv"], (B, max_len, cfg.kv_lora_rank))
                _want(f"layer {i} cache k_rope", c["k_rope"], (B, max_len, cfg.qk_rope_dim))
            else:
                for n in ("k", "v"):
                    _want(f"layer {i} cache {n}", c[n], (B, S, cfg.n_kv_heads, cfg.head_dim))
                if cfg.attention == "swa" and cfg.window and S == cfg.window:  # a ring
                    _want(f"layer {i} cache pos", c["pos"], (B, S))
        T, d = cfg.frontend_len, cfg.d_model
        if frames is not None:
            _want("frames", frames, (B, T, d))
        if prefix is not None:
            _want("prefix", prefix, (B, T, d))
        if "memory" in state:
            _want("memory", state["memory"], (B, T, d))
            if len(state["memory_kv"]) != cfg.n_layers:
                raise ValueError(f"{len(state['memory_kv'])} memory K/V pairs for {cfg.n_layers} layers")
            for i, kv in enumerate(state["memory_kv"]):
                for n, a in zip("kv", kv):
                    _want(f"layer {i} memory {n}", a, (B, T, cfg.n_kv_heads, cfg.head_dim))

    @torch.inference_mode()
    def prefill_fn(params, tokens, state, frames=None, prefix=None):
        _check(tokens, state, frames, prefix)
        return prefill(model, params, tokens, state, frames=frames, prefix=prefix)

    @torch.inference_mode()
    def decode_fn(params, tokens, state):
        if cfg.encoder_layers and "memory" not in state:
            raise ValueError(f"{cfg.name}: decode needs the encoder memory that prefill keeps")
        _check(tokens, state)
        return decode_step(model, params, tokens, state)

    return prefill_fn, decode_fn

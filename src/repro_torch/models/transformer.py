"""Layout-driven decoder assembly, for serving.

Port of ``repro.models.transformer`` for the dense layout: ``embed -> layers
-> norm -> head``. Where the JAX model stacks each layout position's params
over the G groups and scans over them, the port keeps one params dict per
layer in ``params["layers"]`` (in the order the trunk visits them) and loops
over them in Python. Serving only: no remat, no ``chunked_loss`` yet.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from . import attention as attn
from . import moe as moe_mod
from .common import ArchConfig, LayerSpec, ParamBuilder, resolve_device, rms_norm


def _check_ported(cfg: ArchConfig, spec: LayerSpec) -> None:
    if spec.mixer != "attention" or cfg.attention == "mla":
        raise NotImplementedError(
            f"{cfg.name}: mixer {spec.mixer!r}/{cfg.attention!r} is not ported yet (see ROADMAP.md queue 1)"
        )
    if spec.ffn != "dense" or cfg.encoder_layers or cfg.cross_attention or cfg.frontend != "none":
        raise NotImplementedError(f"{cfg.name}: only the dense decoder layout is ported")


def init_layer(pb: ParamBuilder, cfg: ArchConfig, spec: LayerSpec) -> dict:
    _check_ported(cfg, spec)
    return {
        "ln1": pb.ones((cfg.d_model,)),
        "mixer": attn.init_attention(pb, cfg),
        "ln2": pb.ones((cfg.d_model,)),
        "ffn": moe_mod.init_dense_ffn(pb, cfg),
    }


def apply_layer(
    p: dict,
    cfg: ArchConfig,
    x: torch.Tensor,
    positions: torch.Tensor,
    cache: Optional[dict],
    kernels: Optional[dict] = None,
):
    """Returns (x, new_cache)."""
    h = rms_norm(x, p["ln1"], cfg.norm_eps)
    y, new_cache = attn.attention_block(p["mixer"], cfg, h, positions, cache, kernels=kernels)
    x = x + y
    h = rms_norm(x, p["ln2"], cfg.norm_eps)
    return x + moe_mod.dense_ffn(p["ffn"], h), new_cache


@dataclasses.dataclass
class Model:
    """Functional model container: init + forward paths for one ArchConfig."""

    cfg: ArchConfig

    def init(self, seed: int, device="cuda") -> dict:
        """Random params drawn from a ``torch.Generator`` seeded with ``seed``
        on ``device``."""
        cfg = self.cfg
        dev = resolve_device(device)
        gen = torch.Generator(device=dev)
        gen.manual_seed(seed)
        pb = ParamBuilder(gen, cfg.compute_dtype(), dev)
        params: dict = {
            "embed": pb.dense((cfg.vocab, cfg.d_model), scale=1.0),
            "final_norm": pb.ones((cfg.d_model,)),
        }
        if not cfg.tie_embeddings:
            params["lm_head"] = pb.dense((cfg.d_model, cfg.vocab))
        params["layers"] = [
            init_layer(pb, cfg, cfg.layout[i % len(cfg.layout)]) for i in range(cfg.n_layers)
        ]
        return params

    def trunk(
        self,
        params: dict,
        x: torch.Tensor,  # (B, L, D) embedded inputs
        positions: torch.Tensor,  # (B, L)
        caches: Optional[list] = None,  # one per layer
        kernels: Optional[dict] = None,
    ):
        """Returns (x, new_caches); new_caches is None without caches."""
        new_caches = []
        for i, p in enumerate(params["layers"]):
            x, nc = apply_layer(
                p, self.cfg, x, positions, None if caches is None else caches[i], kernels
            )
            new_caches.append(nc)
        return x, (new_caches if caches is not None else None)

    def embed(self, params: dict, tokens: torch.Tensor) -> torch.Tensor:
        return params["embed"][tokens]  # (B, L, D)

    def logits(self, params: dict, x: torch.Tensor) -> torch.Tensor:
        cfg = self.cfg
        x = rms_norm(x, params["final_norm"], cfg.norm_eps)
        w = params["embed"].T if cfg.tie_embeddings else params["lm_head"]
        return x @ w

    def init_cache(self, batch: int, max_len: int, device="cuda") -> list:
        """One KV cache per layer."""
        cfg = self.cfg
        dev = resolve_device(device)
        for spec in cfg.layout:
            _check_ported(cfg, spec)
        return [
            attn.init_attention_cache(cfg, batch, max_len, cfg.compute_dtype(), dev)
            for _ in range(cfg.n_layers)
        ]

"""Layout-driven decoder assembly, for serving.

Port of ``repro.models.transformer``: ``embed -> layers -> norm -> head``,
each layer a mixer (attention or Mamba) and an FFN (dense, MoE or none)
chosen by its ``LayerSpec``, so dense GQA, MoE, hybrid Mamba+attention and
attention-free SSM layouts are one assembly. Where the JAX model stacks each
layout position's params over the G groups and scans over them, the port
keeps one params dict per layer in ``params["layers"]`` (in the order the
trunk visits them) and loops over them in Python. The ``kernels`` dict
(default ``repro_torch.kernels.ops.kernel_set()``) reaches the attention,
Mamba and MoE blocks. Serving only: no remat, no ``chunked_loss`` yet.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from . import attention as attn
from . import mamba as mb
from . import moe as moe_mod
from .common import ArchConfig, LayerSpec, ParamBuilder, resolve_device, rms_norm


def _check_ported(cfg: ArchConfig, spec: LayerSpec) -> None:
    if spec.mixer not in ("attention", "mamba") or spec.ffn not in ("dense", "moe", "none"):
        raise ValueError(f"{cfg.name}: unknown layer spec {spec}")
    if spec.mixer == "attention" and cfg.attention == "mla":
        raise NotImplementedError(f"{cfg.name}: MLA is not ported yet (see ROADMAP.md queue 1)")
    if cfg.encoder_layers or cfg.cross_attention or cfg.frontend != "none":
        raise NotImplementedError(
            f"{cfg.name}: encoder-decoder, cross-attention and modality frontends are not "
            "ported yet (see ROADMAP.md queue 1)"
        )


def init_layer(pb: ParamBuilder, cfg: ArchConfig, spec: LayerSpec) -> dict:
    _check_ported(cfg, spec)
    p: dict = {"ln1": pb.ones((cfg.d_model,))}
    p["mixer"] = attn.init_attention(pb, cfg) if spec.mixer == "attention" else mb.init_mamba(pb, cfg)
    if spec.ffn != "none":
        p["ln2"] = pb.ones((cfg.d_model,))
        p["ffn"] = moe_mod.init_moe(pb, cfg) if spec.ffn == "moe" else moe_mod.init_dense_ffn(pb, cfg)
    return p


def apply_layer(
    p: dict,
    cfg: ArchConfig,
    spec: LayerSpec,
    x: torch.Tensor,
    positions: torch.Tensor,
    cache: Optional[dict],
    kernels: Optional[dict] = None,
):
    """Returns (x, new_cache, aux_loss); aux_loss is 0.0 without an MoE FFN."""
    aux = 0.0
    h = rms_norm(x, p["ln1"], cfg.norm_eps)
    if spec.mixer == "attention":
        y, new_cache = attn.attention_block(p["mixer"], cfg, h, positions, cache, kernels=kernels)
    else:
        y, new_cache = mb.mamba_block(p["mixer"], cfg, h, positions, cache, kernels=kernels)
    x = x + y
    if "ffn" in p:
        h = rms_norm(x, p["ln2"], cfg.norm_eps)
        if spec.ffn == "moe":
            y, mo = moe_mod.moe_ffn(p["ffn"], cfg, h, kernels=kernels)
            aux = mo["aux_loss"]
        else:
            y = moe_mod.dense_ffn(p["ffn"], h)
        x = x + y
    return x, new_cache, aux


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
        """Returns (x, aux_loss, new_caches): aux_loss is the f32 sum of the
        MoE layers' load-balancing losses; new_caches is None without caches."""
        cfg = self.cfg
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
        new_caches = []
        for i, p in enumerate(params["layers"]):
            spec = cfg.layout[i % len(cfg.layout)]
            x, nc, a = apply_layer(
                p, cfg, spec, x, positions, None if caches is None else caches[i], kernels
            )
            aux = aux + a
            new_caches.append(nc)
        return x, aux, (new_caches if caches is not None else None)

    def embed(self, params: dict, tokens: torch.Tensor) -> torch.Tensor:
        return params["embed"][tokens]  # (B, L, D)

    def logits(self, params: dict, x: torch.Tensor) -> torch.Tensor:
        cfg = self.cfg
        x = rms_norm(x, params["final_norm"], cfg.norm_eps)
        w = params["embed"].T if cfg.tie_embeddings else params["lm_head"]
        return x @ w

    def init_cache(self, batch: int, max_len: int, device="cuda") -> list:
        """One cache per layer, of its own mixer: K/V for attention, the
        (h, conv window) state for Mamba."""
        cfg = self.cfg
        dev = resolve_device(device)
        dt = cfg.compute_dtype()
        caches = []
        for i in range(cfg.n_layers):
            spec = cfg.layout[i % len(cfg.layout)]
            _check_ported(cfg, spec)
            if spec.mixer == "mamba":
                caches.append(mb.init_mamba_cache(cfg, batch, dt, dev))
            else:
                caches.append(attn.init_attention_cache(cfg, batch, max_len, dt, dev))
        return caches

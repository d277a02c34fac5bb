"""Layout-driven decoder assembly, for serving and training.

Port of ``repro.models.transformer``: ``embed -> layers -> norm -> head``,
each layer a mixer (attention, MLA or Mamba), cross-attention over an
encoder memory where the config has one, and an FFN (dense, MoE or none)
chosen by its ``LayerSpec``, so dense GQA, MoE, hybrid Mamba+attention,
attention-free SSM, MLA and encoder-decoder layouts are one assembly.
``Model.encode`` runs the encoder (non-causal, RoPE on q and k) over stub
frontend frames. Where the JAX model stacks each
layout position's params over the G groups and scans over them, the port
keeps one params dict per layer in ``params["layers"]`` (in the order the
trunk visits them; the encoder's in ``params["encoder"]["layers"]``) and
loops over them in Python. The ``kernels`` dict
(default ``repro_torch.kernels.ops.kernel_set()``) reaches the attention,
Mamba and MoE blocks.

For training, ``trunk`` without caches applies the config's remat to each
layout period (one layer for a dense layout), as the reference does to its
scan body: ``full`` keeps only the period's input
(``torch.utils.checkpoint``), ``block`` also keeps the outputs of the plain
matrix products (``aten.mm``, the reference's
``dots_with_no_batch_dims_saveable``), ``none`` keeps everything. Under
either remat the attention forward runs again in the backward pass. Under a
sharded step's FSDP (``dist.step``) the trunk's weights arrive as shards and
each period (each encoder layer) gathers its own inside the checkpointed
function (``common.gather_params``): under ``block`` and ``full`` the
gathered weights live only in that period's forward and in its recompute,
which gathers them again, as the reference's scan body does.
``encode`` applies it to each encoder layer, and a training trunk takes the
encoder's ``memory`` itself, so that each decoder layer projects its
cross-attention K and V inside its checkpointed period, as the reference's
scan body does (``repro/models/transformer.py:100-105``); serving passes
the K/V that prefill computed once instead (``cross_kvs``).
``chunked_loss`` is the reference's token-mean cross-entropy over L-chunks
of 512, which never forms the (B, L, V) logits.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Optional

import torch
from torch.utils.checkpoint import CheckpointPolicy, checkpoint, create_selective_checkpoint_contexts

from repro_torch.kernels.ops import kernel_set
from repro_torch.obs import span

from . import attention as attn
from . import mamba as mb
from . import moe as moe_mod
from .common import (
    ArchConfig,
    LayerSpec,
    ParamBuilder,
    apply_rope,
    axis_rules,
    gather_params,
    get_axis_rules,
    grad_cast,
    resolve_device,
    rms_norm,
    tensor_parallel,
)


def _rms(x: torch.Tensor, w: torch.Tensor, eps: float) -> torch.Tensor:
    # as the reference: the norm's cotangent is cast to the activation dtype
    with span("norm"):
        return grad_cast(rms_norm(x, w, eps))


def init_layer(pb: ParamBuilder, cfg: ArchConfig, spec: LayerSpec, cross: bool = False) -> dict:
    if spec.mixer not in ("attention", "mamba") or spec.ffn not in ("dense", "moe", "none"):
        raise ValueError(f"{cfg.name}: unknown layer spec {spec}")
    p: dict = {"ln1": pb.ones((cfg.d_model,), ("embed",))}
    if spec.mixer == "mamba":
        p["mixer"] = mb.init_mamba(pb, cfg)
    else:
        p["mixer"] = attn.init_mla(pb, cfg) if cfg.attention == "mla" else attn.init_attention(pb, cfg)
    if cross:
        p["ln_cross"] = pb.ones((cfg.d_model,), ("embed",))
        p["cross"] = attn.init_attention(pb, cfg)
    if spec.ffn != "none":
        p["ln2"] = pb.ones((cfg.d_model,), ("embed",))
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
    cross_kv: Optional[tuple] = None,
    memory: Optional[torch.Tensor] = None,
):
    """Returns (x, new_cache, aux_loss); aux_loss is 0.0 without an MoE FFN.
    A layer with cross-attention attends to ``cross_kv``, its (k, v) of the
    encoder memory (``attention.memory_kv``), or projects them here from
    ``memory``."""
    aux = 0.0
    if "cross" in p and cross_kv is None and memory is not None:
        cross_kv = attn.memory_kv(p["cross"], memory)
    h = _rms(x, p["ln1"], cfg.norm_eps)
    if spec.mixer == "mamba":
        with span("mamba"):
            y, new_cache = mb.mamba_block(p["mixer"], cfg, h, positions, cache, kernels=kernels)
    elif cfg.attention == "mla":
        with span("mla"):
            y, new_cache = attn.mla_block(p["mixer"], cfg, h, positions, cache, kernels=kernels)
    else:
        with span("attention"):
            y, new_cache = attn.attention_block(p["mixer"], cfg, h, positions, cache, kernels=kernels)
    x = x + y
    if "cross" in p and cross_kv is not None:
        h = _rms(x, p["ln_cross"], cfg.norm_eps)
        with span("cross"):
            y, _ = attn.attention_block(p["cross"], cfg, h, positions, cross_kv=cross_kv, kernels=kernels)
        x = x + y
    if "ffn" in p:
        h = _rms(x, p["ln2"], cfg.norm_eps)
        if spec.ffn == "moe":
            with span("moe"):
                y, mo = moe_mod.moe_ffn(p["ffn"], cfg, h, kernels=kernels)
            aux = mo["aux_loss"]
        else:
            with span("ffn"):
                y = moe_mod.dense_ffn(p["ffn"], h)
        x = x + y
    return x, new_cache, aux


@dataclasses.dataclass
class Model:
    """Functional model container: init + forward paths for one ArchConfig."""

    cfg: ArchConfig

    def init(self, seed: int, device="cuda", with_axes: bool = False):
        """Random params drawn from a ``torch.Generator`` seeded with ``seed``
        on ``device``; on the ``meta`` device, their shapes and dtypes alone.
        With ``with_axes``, returns (params, axes): the logical-axes tree of
        the same layout, each leaf one name or None per dimension (the
        reference's ``init`` tree, unstacked as ``convert.axes_from_jax``
        does)."""
        cfg = self.cfg
        dev = resolve_device(device)
        gen = None
        if dev.type != "meta":
            gen = torch.Generator(device=dev)
            gen.manual_seed(seed)
        pb = ParamBuilder(gen, cfg.compute_dtype(), dev)
        params: dict = {
            "embed": pb.dense((cfg.vocab, cfg.d_model), ("vocab", "embed"), scale=1.0),
            "final_norm": pb.ones((cfg.d_model,), ("embed",)),
        }
        if not cfg.tie_embeddings:
            params["lm_head"] = pb.dense((cfg.d_model, cfg.vocab), ("embed", "vocab"))
        params["layers"] = [
            init_layer(pb, cfg, cfg.layout[i % len(cfg.layout)], cfg.cross_attention)
            for i in range(cfg.n_layers)
        ]
        if cfg.encoder_layers:
            # the reference's encoder layers: full attention, dense FFN
            enc_spec = LayerSpec(mixer="attention", ffn="dense")
            enc_cfg = dataclasses.replace(cfg, attention="full", cross_attention=False)
            params["encoder"] = {
                "layers": [init_layer(pb, enc_cfg, enc_spec) for _ in range(cfg.encoder_layers)],
                "norm": pb.ones((cfg.d_model,), ("embed",)),
            }
        return (params, pb.axes_of(params)) if with_axes else params

    def encode(self, params: dict, frames: torch.Tensor, kernels: Optional[dict] = None) -> torch.Tensor:
        """frames (B, T, D) stub frontend embeddings -> (B, T, D) memory:
        each encoder layer is non-causal self-attention with RoPE on q and k
        and no bias, then the dense FFN; ``encoder.norm`` at the end
        (reference ``:164-188``). With a gradient enabled each layer runs
        under the config's remat, as the reference's scan body."""
        cfg = self.cfg
        kernels = kernels or kernel_set()
        x = frames.to(cfg.compute_dtype())
        B, T, _ = x.shape
        positions = torch.arange(T, device=x.device).expand(B, T)
        for p in params["encoder"]["layers"]:
            x = _remat(cfg, self._encoder_layer, p, x, positions, kernels)
        return _rms(x, params["encoder"]["norm"], cfg.norm_eps)

    def _encoder_layer(self, p: dict, x, positions, kernels):
        """One encoder layer; its weights gathered here under FSDP."""
        cfg = self.cfg
        p = gather_params(p)
        h = _rms(x, p["ln1"], cfg.norm_eps)
        m = p["mixer"]
        par = attn.heads_parallel()
        kv = attn._kv_weights(m, par, ("wk", "wv"))
        if par is not None:
            h = par.to_model(h)
        q = apply_rope(attn._proj(h, m["wq"]), positions[:, :, None], cfg.rope_theta)
        k = apply_rope(attn._proj(h, kv["wk"]), positions[:, :, None], cfg.rope_theta)
        k, v = attn._local_kv(par, k, attn._proj(h, kv["wv"]), q.shape[2])
        o = attn.attention(q, k, v, causal=False, window=0, kernels=kernels)
        x = x + attn._out_proj(m, o, par)
        return x + moe_mod.dense_ffn(p["ffn"], _rms(x, p["ln2"], cfg.norm_eps))

    def memory_kv(self, params: dict, memory: torch.Tensor) -> list:
        """Each decoder layer's cross-attention (k, v) of the encoder memory."""
        return [attn.memory_kv(p["cross"], memory) for p in params["layers"]]

    def trunk(
        self,
        params: dict,
        x: torch.Tensor,  # (B, L, D) embedded inputs
        positions: torch.Tensor,  # (B, L)
        caches: Optional[list] = None,  # one per layer
        kernels: Optional[dict] = None,
        cross_kvs: Optional[list] = None,  # one (k, v) per layer: Model.memory_kv
        memory: Optional[torch.Tensor] = None,  # (B, T, D) the encoder's, when training
    ):
        """Returns (x, aux_loss, new_caches): aux_loss is the f32 sum of the
        MoE layers' load-balancing losses; new_caches is None without caches.
        Cross-attention attends to ``cross_kvs`` (serving) or to K/V each
        layer projects from ``memory`` (training). Without caches and with a
        gradient enabled, each layout period runs under the config's remat
        (see the module docstring)."""
        cfg = self.cfg
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
        period = len(cfg.layout)
        layers = params["layers"]
        if caches is None and cross_kvs is None:
            for g in range(0, len(layers), period):
                x, aux = _remat(cfg, self._period, layers[g : g + period], x, aux, positions, kernels, memory)
            return x, aux, None
        new_caches = []
        for i, p in enumerate(layers):
            spec = cfg.layout[i % period]
            x, nc, a = apply_layer(
                p, cfg, spec, x, positions, None if caches is None else caches[i], kernels,
                None if cross_kvs is None else cross_kvs[i],
            )
            aux = aux + a
            new_caches.append(nc)
        return x, aux, (new_caches if caches is not None else None)

    def _period(self, layers: list, x, aux, positions, kernels, memory=None):
        """One layout period without caches: the reference's scan body. Under
        FSDP its weights are gathered here, as the reference's scan gathers
        each group's slice in its body."""
        layers = gather_params(layers)
        for spec, p in zip(self.cfg.layout, layers):
            x, _, a = apply_layer(p, self.cfg, spec, x, positions, None, kernels, memory=memory)
            aux = aux + a
        return x, aux

    def embed(self, params: dict, tokens: torch.Tensor) -> torch.Tensor:
        """(B, L, D) rows of the embedding; vocab-parallel where the rules
        shard ``vocab``: ids outside this rank's rows give zeros, and one
        all-reduce over ``model`` sums the ranks' rows."""
        par = _vocab_parallel()
        if par is None:
            return params["embed"][tokens]  # (B, L, D)
        w = params["embed"]
        ids = tokens - par.tp_rank * w.shape[0]
        mine = (ids >= 0) & (ids < w.shape[0])
        x = torch.where(mine[..., None], w[ids.clamp(0, w.shape[0] - 1)], torch.zeros((), dtype=w.dtype, device=w.device))
        return par.from_model(x)

    def logits(self, params: dict, x: torch.Tensor) -> torch.Tensor:
        cfg = self.cfg
        x = _rms(x, params["final_norm"], cfg.norm_eps)
        w = params["embed"].T if cfg.tie_embeddings else params["lm_head"]
        return x @ w

    def chunked_loss(
        self,
        params: dict,
        x: torch.Tensor,  # (B, L, D) trunk output
        labels: torch.Tensor,  # (B, L) next-token ids, -1 = ignore
        chunk: int = 512,
    ) -> torch.Tensor:
        """Token-mean cross-entropy in f32 over L-chunks of ``chunk``, labels
        of -1 ignored; one chunk's (B, chunk, V) logits at a time. Where the
        rules shard ``vocab``, each rank holds V/tp columns of the head (of
        the tied embedding's rows) and the loss is vocab-parallel: the max,
        the sum of exponentials and the target's logit are each all-reduced
        over ``model``."""
        cfg = self.cfg
        x = _rms(x, params["final_norm"], cfg.norm_eps)
        w = params["embed"].T if cfg.tie_embeddings else params["lm_head"]
        par = _vocab_parallel()
        if par is not None:
            x = par.to_model(x)
        L = x.shape[1]
        chunk = min(chunk, L)
        tot = torch.zeros((), dtype=torch.float32, device=x.device)
        cnt = torch.zeros((), dtype=torch.float32, device=x.device)
        for s in range(0, L, chunk):
            lc = labels[:, s : s + chunk]
            logits = (x[:, s : s + chunk] @ w).float()
            if par is None:
                lse = torch.logsumexp(logits, dim=-1)
                gold = logits.gather(-1, lc.clamp(min=0)[..., None].long())[..., 0]
            else:
                lse, gold = _vocab_parallel_lse_gold(par, logits, lc)
            mask = (lc != -1).float()
            tot = tot + ((lse - gold) * mask).sum()
            cnt = cnt + mask.sum()
        return tot / cnt.clamp(min=1.0)

    def init_cache(self, batch: int, max_len: int, device="cuda") -> list:
        """One cache per layer, of its own mixer: K/V for attention (a ring
        of ``window`` slots for SWA), the latents for MLA, the (h, conv
        window) state for Mamba."""
        cfg = self.cfg
        dev = resolve_device(device)
        dt = cfg.compute_dtype()
        caches = []
        for i in range(cfg.n_layers):
            spec = cfg.layout[i % len(cfg.layout)]
            if spec.mixer == "mamba":
                caches.append(mb.init_mamba_cache(cfg, batch, dt, dev))
            elif cfg.attention == "mla":
                caches.append(attn.init_mla_cache(cfg, batch, max_len, dt, dev))
            else:
                caches.append(attn.init_attention_cache(cfg, batch, max_len, dt, dev))
        return caches


def _vocab_parallel():
    """The tensor-parallel view when the vocabulary is sharded over ``model``."""
    par = tensor_parallel()
    return par if par is not None and par.sharded("vocab") else None


def _vocab_parallel_lse_gold(par, logits: torch.Tensor, labels: torch.Tensor):
    """log-sum-exp and target logit of (B, l, V/tp) local f32 logits: the
    max (no gradient: the lse does not depend on it), the sum of
    exponentials and the target's logit (0 on the ranks not holding it) each
    all-reduced over ``model``."""
    v_loc = logits.shape[-1]
    m = par.comm.all_reduce(logits.detach().amax(dim=-1), ("model",), op="max")
    se = par.from_model(torch.exp(logits - m[..., None]).sum(dim=-1))
    ids = labels.clamp(min=0).long() - par.tp_rank * v_loc
    mine = (ids >= 0) & (ids < v_loc)
    gold = logits.gather(-1, ids.clamp(0, v_loc - 1)[..., None])[..., 0]
    gold = par.from_model(torch.where(mine, gold, torch.zeros((), device=logits.device)))
    return m + torch.log(se), gold


def _remat(cfg: ArchConfig, fn, *args):
    """fn(*args), under the config's remat where a gradient is being taken.
    The recompute runs in the backward pass, on autograd's thread for CUDA
    tensors, so the axis rules installed now (and FSDP's gather with them)
    are installed around it too: it gathers its weights again."""
    if not torch.is_grad_enabled() or cfg.remat == "none":
        return fn(*args)
    ctx = {"full": None, "block": _save_matmuls}[cfg.remat]
    rules = get_axis_rules()
    if rules is not None:
        inner = fn

        def fn(*a):
            with axis_rules(*rules):
                return inner(*a)

    return checkpoint(fn, *args, use_reentrant=False, **({} if ctx is None else {"context_fn": ctx}))


def _save_policy(ctx, op, *args, **kwargs):
    """remat "block": keep the plain matrix products' outputs (no batch
    dimensions; attention's batched products and everything else recompute)."""
    return CheckpointPolicy.MUST_SAVE if op is torch.ops.aten.mm.default else CheckpointPolicy.PREFER_RECOMPUTE


_save_matmuls = functools.partial(create_selective_checkpoint_contexts, _save_policy)

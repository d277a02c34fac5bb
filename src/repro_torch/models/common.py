"""Shared model substrate: config schema, device choice, logical axes and
the axis-rules context, RMSNorm, RoPE.

Port of ``repro.models.common``. The config schema is a copy (the reference
module imports jax); ``compute_dtype()`` returns a torch dtype.
``ParamBuilder`` records each parameter's logical axis names ("embed",
"heads", ...), as the reference's does, so ``Model.init(..., with_axes=True)``
returns the logical-axes tree beside the params. ``axis_rules(rules, mesh)``
installs the logical-name -> mesh-axis rules of ``repro_torch.dist.sharding``
around a call; the model code reads from them (``repro_torch.dist.comm
.current``) which of its dimensions are local shards and over which process
group. Without rules nothing changes. ``cost_scope(name)`` marks a
region that runs as one hand-written kernel (the reference's
``jax.named_scope("pallas_*")``), and ``cost_repeat(n)`` a region that
stands for n runs of itself; both are context variables that
``repro_torch.roofline.op_costs`` reads, and neither launches anything.
"""

from __future__ import annotations

import contextlib
import contextvars
import dataclasses
import threading
from typing import Optional

import numpy as np
import torch

NEG_INF = -2.0e38  # finite mask value, as in the reference kernels


# ---------------------------------------------------------------------------
# Config schema
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class LayerSpec:
    """One layer position inside a repeating group."""

    mixer: str = "attention"  # "attention" | "mamba"
    ffn: str = "dense"  # "dense" | "moe" | "none"


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str  # dense | moe | hybrid | ssm | vlm | audio
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    d_head: int = 0  # 0 -> d_model // n_heads
    # repeating layout (len(layout) must divide n_layers)
    layout: tuple = (LayerSpec(),)
    # attention
    attention: str = "full"  # full | swa | mla
    window: int = 0  # SWA window (0 = unlimited)
    qkv_bias: bool = False
    rope_theta: float = 1e4
    # MoE
    n_experts: int = 0
    top_k: int = 0
    capacity_factor: float = 1.25
    # MLA (minicpm3-style)
    q_lora_rank: int = 0
    kv_lora_rank: int = 0
    qk_nope_dim: int = 0
    qk_rope_dim: int = 0
    v_head_dim: int = 0
    # Mamba
    ssm_state: int = 16
    ssm_conv: int = 4
    ssm_expand: int = 2
    # encoder-decoder
    encoder_layers: int = 0  # 0 -> decoder-only
    cross_attention: bool = False
    # modality frontend: "none" | "vision" | "audio"
    frontend: str = "none"
    frontend_len: int = 0
    # numerics & structure
    dtype: str = "bfloat16"
    tie_embeddings: bool = False
    norm_eps: float = 1e-5
    # runtime knobs of the reference (kept so that reduced() is identical)
    remat: str = "block"  # none | block | full
    block_q: int = 512
    block_kv: int = 512
    causal_skip: bool = False
    moe_groups: int = 0
    pad_heads: int = 0
    moe_block_tokens: int = 0
    moe_exact_tokens: int = 512
    use_pallas: bool = False

    # -- derived -----------------------------------------------------------
    @property
    def head_dim(self) -> int:
        return self.d_head or (self.d_model // self.n_heads)

    @property
    def n_heads_eff(self) -> int:
        """Padded head count (pad wo rows are zero at init)."""
        return self.n_heads + self.pad_heads

    @property
    def d_inner(self) -> int:
        return self.ssm_expand * self.d_model

    @property
    def dt_rank(self) -> int:
        return max(1, self.d_model // 16)

    @property
    def n_groups(self) -> int:
        if self.n_layers % len(self.layout):
            raise ValueError(f"{self.name}: layout len {len(self.layout)} !| n_layers {self.n_layers}")
        return self.n_layers // len(self.layout)

    def layer_specs(self) -> list:
        """The LayerSpec of each of the n_layers layers (layer i has the
        layout's i % len(layout)); a config cut in depth holds a prefix of its
        layout's periods."""
        return [self.layout[i % len(self.layout)] for i in range(self.n_layers)]

    @property
    def sub_quadratic(self) -> bool:
        """Eligible for long_500k: SSM-dominated (pure or hybrid) or bounded
        attention window. Pure full-attention archs are skipped per the
        assignment."""
        if any(s.mixer == "mamba" for s in self.layout):
            return True  # ssm / hybrid
        return self.attention == "swa" and self.window > 0

    def compute_dtype(self) -> torch.dtype:
        return torch.bfloat16 if self.dtype == "bfloat16" else torch.float32

    def n_params(self) -> int:
        """Analytic parameter count (for 6ND MODEL_FLOPS): the reference's,
        summed over ``layer_specs()`` (the layout times its groups for a whole
        config), so that a config cut in depth counts the layers it holds."""
        d, dh = self.d_model, self.head_dim
        total = self.vocab * d  # embed
        if not self.tie_embeddings:
            total += self.vocab * d
        for spec in self.layer_specs():
            p = 0
            if spec.mixer == "attention":
                if self.attention == "mla":
                    qr = self.q_lora_rank or d
                    p += d * qr + qr * self.n_heads * (self.qk_nope_dim + self.qk_rope_dim)
                    p += d * (self.kv_lora_rank + self.qk_rope_dim)
                    p += self.kv_lora_rank * self.n_heads * (self.qk_nope_dim + self.v_head_dim)
                    p += self.n_heads * self.v_head_dim * d
                else:
                    p += d * self.n_heads * dh + 2 * d * self.n_kv_heads * dh
                    p += self.n_heads * dh * d
            elif spec.mixer == "mamba":
                di, N = self.d_inner, self.ssm_state
                p += d * 2 * di + di * self.ssm_conv
                p += di * (self.dt_rank + 2 * N) + self.dt_rank * di
                p += di * N + di + di * d
            if spec.ffn == "dense":
                p += 3 * d * self.d_ff  # SwiGLU
            elif spec.ffn == "moe":
                p += d * self.n_experts  # router
                p += self.n_experts * 3 * d * self.d_ff
            p += 2 * d  # two norms
            total += p
        if self.encoder_layers:
            enc = self.encoder_layers * (
                d * self.n_heads * dh + 2 * d * self.n_kv_heads * dh
                + self.n_heads * dh * d + 3 * d * self.d_ff + 2 * d
            )
            # decoder cross-attention adds one attention block per layer
            cross = self.n_layers * (
                d * self.n_heads * dh + 2 * d * self.n_kv_heads * dh
                + self.n_heads * dh * d + d
            )
            total += enc + cross
        return int(total)

    def n_active_params(self) -> int:
        """Active params per token (MoE: top_k of n_experts)."""
        if self.n_experts == 0:
            return self.n_params()
        d = self.d_model
        moe_layers = sum(1 for s in self.layer_specs() if s.ffn == "moe")
        inactive = moe_layers * (self.n_experts - self.top_k) * 3 * d * self.d_ff
        return int(self.n_params() - inactive)

    def reduced(self) -> "ArchConfig":
        """Tiny same-family config for CPU smoke tests."""
        return dataclasses.replace(
            self,
            name=self.name + "-smoke",
            n_layers=len(self.layout) * 2,
            d_model=64,
            n_heads=4,
            n_kv_heads=max(1, min(self.n_kv_heads, 2)) if self.n_kv_heads < self.n_heads else 4,
            d_head=16,
            d_ff=128 if self.d_ff else 0,
            vocab=256,
            n_experts=min(self.n_experts, 4),
            top_k=min(self.top_k, 2),
            q_lora_rank=32 if self.q_lora_rank else 0,
            kv_lora_rank=16 if self.kv_lora_rank else 0,
            qk_nope_dim=8 if self.qk_nope_dim else 0,
            qk_rope_dim=8 if self.qk_rope_dim else 0,
            v_head_dim=16 if self.v_head_dim else 0,
            ssm_state=8,
            encoder_layers=2 if self.encoder_layers else 0,
            frontend_len=8 if self.frontend_len else 0,
            window=min(self.window, 64) if self.window else 0,
            block_q=16,
            block_kv=16,
            dtype="float32",
            remat="none",
        )


def resolve_device(device) -> torch.device:
    """The device an entry point runs on. Raises for an absent CUDA device:
    nothing falls back to the CPU."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {device!r} requested but CUDA is not available")
    return dev


# ---------------------------------------------------------------------------
# Logical-axis rules context
# ---------------------------------------------------------------------------

_AXIS_RULES = threading.local()


def set_axis_rules(rules: Optional[dict], mesh=None) -> None:
    """rules: logical axis name -> mesh axis (str / tuple / None)."""
    _AXIS_RULES.ctx = None if rules is None else (rules, mesh)


def get_axis_rules():
    """(rules, mesh) installed on this thread, or None."""
    return getattr(_AXIS_RULES, "ctx", None)


class axis_rules:
    """Context manager for logical -> mesh axis rules (and the mesh itself)."""

    def __init__(self, rules: Optional[dict], mesh=None):
        self.rules, self.mesh = rules, mesh

    def __enter__(self):
        self.prev = get_axis_rules()
        set_axis_rules(self.rules, self.mesh)
        return self

    def __exit__(self, *exc):
        _AXIS_RULES.ctx = self.prev


def parallel():
    """The installed rules' view on a DeviceMesh
    (``repro_torch.dist.comm.Parallel``: which dimensions are local shards,
    over which groups), or None: no rules, or rules without a DeviceMesh."""
    if get_axis_rules() is None:
        return None
    from repro_torch.dist.comm import current

    return current()


def tensor_parallel():
    """``parallel()`` where the model axis has more than one rank, else None."""
    par = parallel()
    return par if par is not None and par.tp > 1 else None


# ---------------------------------------------------------------------------
# Cost scopes (read by repro_torch.roofline.op_costs)
# ---------------------------------------------------------------------------

_COST_SCOPE = contextvars.ContextVar("cost_scope", default=None)
_COST_REPEAT = contextvars.ContextVar("cost_repeat", default=1)


@contextlib.contextmanager
def cost_scope(name: str):
    """Mark the ops inside as one kernel's region ("pallas_flash_attention",
    "pallas_moe_gmm", "pallas_mamba_scan"), whose traffic the roofline
    prices as that kernel's IO. The innermost scope names the region."""
    token = _COST_SCOPE.set(name)
    try:
        yield
    finally:
        _COST_SCOPE.reset(token)


def current_cost_scope() -> Optional[str]:
    return _COST_SCOPE.get()


@contextlib.contextmanager
def cost_repeat(n: int):
    """The ops inside stand for ``n`` runs of themselves (one step of a loop
    over n steps that a ghost run does not walk); nested repeats multiply."""
    token = _COST_REPEAT.set(_COST_REPEAT.get() * n)
    try:
        yield
    finally:
        _COST_REPEAT.reset(token)


def current_cost_repeat() -> int:
    return _COST_REPEAT.get()


# ---------------------------------------------------------------------------
# Param init
# ---------------------------------------------------------------------------


class ParamBuilder:
    """Draws parameters from one seeded ``torch.Generator`` on ``device`` and
    records each one's logical axes (one name or None per dimension), as the
    reference's ``ParamBuilder`` pairs them; ``axes_of`` reads them back for
    a tree of the tensors it made.

    The stream differs from ``jax.random``'s: parity tests carry JAX weights
    over with ``repro_torch.models.convert.params_from_jax`` instead."""

    def __init__(self, generator: torch.Generator, dtype: torch.dtype, device: torch.device):
        self.gen, self.dtype, self.device = generator, dtype, device
        self._axes: dict = {}  # id(tensor) -> (tensor, axes): the tensor keeps its id taken

    def _record(self, t: torch.Tensor, axes: tuple) -> torch.Tensor:
        if len(axes) != t.dim():
            raise ValueError(f"axes {axes} for a tensor of shape {tuple(t.shape)}")
        self._axes[id(t)] = (t, tuple(axes))
        return t

    def axes_of(self, tree):
        """The logical-axes tree of a tree of dicts and lists of this
        builder's tensors."""
        if isinstance(tree, dict):
            return {k: self.axes_of(v) for k, v in tree.items()}
        if isinstance(tree, list):
            return [self.axes_of(v) for v in tree]
        return self._axes[id(tree)][1]

    def dense(self, shape: tuple, axes: tuple, scale: float | None = None) -> torch.Tensor:
        fan_in = shape[-2] if len(shape) >= 2 else shape[-1]
        s = scale if scale is not None else fan_in**-0.5
        w = torch.randn(shape, generator=self.gen, dtype=torch.float32, device=self.device)
        return self._record((w * s).to(self.dtype), axes)

    def zeros(self, shape: tuple, axes: tuple) -> torch.Tensor:
        return self._record(torch.zeros(shape, dtype=self.dtype, device=self.device), axes)

    def ones(self, shape: tuple, axes: tuple) -> torch.Tensor:
        return self._record(torch.ones(shape, dtype=self.dtype, device=self.device), axes)

    def const(self, value: np.ndarray, axes: tuple, dtype: torch.dtype | None = None) -> torch.Tensor:
        """``value`` placed as it is (e.g. Mamba's f32 ``a_log``, ``dt_bias``)."""
        return self._record(torch.as_tensor(value, dtype=dtype or self.dtype, device=self.device), axes)


# ---------------------------------------------------------------------------
# Norms & RoPE
# ---------------------------------------------------------------------------


def _rms_norm_fwd(x: torch.Tensor, weight: torch.Tensor, eps: float):
    acc = torch.promote_types(x.dtype, torch.float32)
    xf = x.to(acc)
    rstd = torch.rsqrt((xf * xf).mean(dim=-1, keepdim=True) + eps)
    return (xf * rstd * weight.to(acc)).to(x.dtype), rstd


class RMSNorm(torch.autograd.Function):
    """The reference's ``rms_norm`` custom_vjp (``repro.models.common``): the
    forward in f32, cast back to x's dtype; residuals (x in its own dtype, w,
    rstd), and a hand-written backward whose dx leaves in x's dtype and dw in
    w's. In bf16 this rounds the gradients where the reference does, unlike
    autograd through the f32 chain. Computes in f64 for f64 inputs."""

    @staticmethod
    def forward(ctx, x, weight, eps: float):
        y, rstd = _rms_norm_fwd(x, weight, eps)
        ctx.save_for_backward(x, weight, rstd)
        return y

    @staticmethod
    def backward(ctx, g):
        x, weight, rstd = ctx.saved_tensors
        acc = rstd.dtype
        xhat = x.to(acc) * rstd
        gf = g.to(acc)
        dw = (gf * xhat).sum(dim=tuple(range(x.dim() - 1)))
        dxhat = gf * weight.to(acc)
        dx = rstd * (dxhat - xhat * (dxhat * xhat).mean(dim=-1, keepdim=True))
        return dx.to(x.dtype), dw.to(weight.dtype), None


class GradCast(torch.autograd.Function):
    """Identity whose cotangent is cast to the primal's dtype: the reference's
    ``grad_cast``, placed at every norm's output (``transformer._rms``)."""

    @staticmethod
    def forward(ctx, x):
        ctx.dtype = x.dtype
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return g.to(ctx.dtype)


def _needs_grad(*ts: torch.Tensor) -> bool:
    return torch.is_grad_enabled() and any(t.requires_grad for t in ts)


def rms_norm(x: torch.Tensor, weight: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """RMSNorm computed in f32 and cast back to x's dtype; through
    ``RMSNorm`` where a gradient is needed, directly otherwise (serving)."""
    if _needs_grad(x, weight):
        return RMSNorm.apply(x, weight, eps)
    return _rms_norm_fwd(x, weight, eps)[0]


def grad_cast(x: torch.Tensor) -> torch.Tensor:
    return GradCast.apply(x) if _needs_grad(x) else x


def rope_frequencies(dim: int, theta: float, device=None) -> torch.Tensor:
    return 1.0 / (theta ** (torch.arange(0, dim, 2, dtype=torch.float32, device=device) / dim))


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """x: (..., L, Dh), positions: (..., L). Split-half rotation (not
    interleaved): the first and second halves of Dh form the pairs, in f32."""
    dh = x.shape[-1]
    freqs = rope_frequencies(dh, theta, x.device)  # (dh/2,)
    angles = positions[..., None].float() * freqs  # (..., L, dh/2)
    cos, sin = torch.cos(angles), torch.sin(angles)
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)

"""The plain reference of the benchmark's models: PyTorch in f32, TF32 off.

It imports nothing of the port. It follows the port's model
(``repro_torch/models``), taken from the configuration file's sizes alone:
the embedding, pre-norm residual layers, RMSNorm and the output head here,
and each layer's blocks through their files (``portbench/blocks/``: their
forwards use the ``Precision``, ``rms`` and ``rope`` below).

Every matrix product goes through a ``Precision``: ``"f32"`` is the
reference; ``"fp8"`` rounds both operands of every product to float8 e4m3
with one scale per tensor first: the control, the reference computed in the
precision below the configuration's bf16; ``"bf16"`` rounds both operands
to bf16, a witness of what the configuration's own precision alone does.

Weights arrive in their stored dtype and are widened to f32 a layer at a
time (an expert at a time), so a model's f32 weights are never all held.
"""

from __future__ import annotations

import torch

from portbench import blocks

FP8 = torch.float8_e4m3fn
FP8_MAX = 448.0


def strict_f32() -> None:
    """Matrix products in full f32: TF32 off."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")


def fp8_round(x: torch.Tensor) -> torch.Tensor:
    """x rounded to e4m3 under one scale (its amax at 448), back in f32."""
    s = x.abs().amax().float().clamp(min=1e-30) / FP8_MAX
    return (x / s).to(FP8).to(torch.float32) * s


class Precision:
    def __init__(self, mode: str = "f32"):
        if mode not in ("f32", "bf16", "fp8"):
            raise ValueError(f"unknown precision {mode!r}")
        self.mode = mode

    def mm(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        """a (..., K) @ b (K, N) in f32, or on e4m3-rounded operands."""
        a, b = a.float(), b.float()
        if self.mode == "f32":
            return a @ b
        if self.mode == "bf16":
            return (a.bfloat16() @ b.bfloat16()).float()
        return fp8_round(a) @ fp8_round(b)

    def q(self, x: torch.Tensor) -> torch.Tensor:
        """An operand of attention's batched products, as ``mm`` takes it."""
        if self.mode == "bf16":
            return x.bfloat16().float()
        return x if self.mode == "f32" else fp8_round(x)


# ---------------------------------------------------------------------------
# What the blocks share (``portbench/blocks/``)
# ---------------------------------------------------------------------------


def rms(x: torch.Tensor, w: torch.Tensor, eps: float) -> torch.Tensor:
    return x * torch.rsqrt((x * x).mean(dim=-1, keepdim=True) + eps) * w.float()


def rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """x (B, S, H, Dh), positions (S,): the halves of Dh form the pairs."""
    dh = x.shape[-1]
    freqs = 1.0 / (theta ** (torch.arange(0, dh, 2, dtype=torch.float32, device=x.device) / dh))
    ang = positions.float()[:, None] * freqs  # (S, dh/2)
    cos, sin = torch.cos(ang)[None, :, None], torch.sin(ang)[None, :, None]
    x1, x2 = x.chunk(2, dim=-1)
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


# ---------------------------------------------------------------------------
# Serving: the logits of every served token, teacher-forced
# ---------------------------------------------------------------------------


@torch.no_grad()
def served_logits(cfg: dict, params: dict, prompts: torch.Tensor, served: torch.Tensor,
                  prec: Precision) -> tuple:
    """The logits (B, G, V) that pick each of the G served tokens of a round:
    the prompts (B, Lp) prefilled in one dispatch group, then each generated
    token but the last fed one decode step at a time (a dispatch group of B
    tokens each). Returns (logits, slots dropped by a capacity rule)."""
    Lp = prompts.shape[1]
    tokens = torch.cat([prompts, served[:, :-1]], dim=1).long()
    eps = cfg["rms_norm_eps"]
    x = params["embed"][tokens].float()  # (B, S, d)
    dropped = 0
    for p, layer in zip(params["layers"], blocks.layers(cfg)):
        for slot, norm, block in layer:
            y, d = block.forward(p[slot], cfg, rms(x, p[norm], eps), prec, Lp)
            x = x + y
            dropped += d
    xs = rms(x[:, Lp - 1 :], params["final_norm"], eps)
    head = params["embed"].T if cfg.get("tie_word_embeddings") else params["lm_head"]
    return prec.mm(xs, head), dropped


def logit_gaps(ref_logits: torch.Tensor, tokens: torch.Tensor) -> torch.Tensor:
    """How far each token's logit lies below the reference's best, (B, G)."""
    ref_logits = ref_logits.float()
    return ref_logits.amax(-1) - ref_logits.gather(-1, tokens.long()[..., None])[..., 0]

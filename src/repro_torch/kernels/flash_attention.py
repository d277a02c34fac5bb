"""Flash attention (causal / sliding-window / GQA) for Hopper.

Port of ``repro.kernels.flash_attention`` (Pallas), which takes one head dim;
the port's kernel also takes MLA's q/k head dim 96 with v's 64 (``HEAD_DIM_PAIRS``),
the function ``repro.models.attention.blocked_attention`` computes for
minicpm3 in the JAX package. The kernel is hand-written
CUDA C++ in ``csrc/flash_attention.cu``: one thread block per (batch x KV
head, q-tile), whose rows are the ``gq`` query heads of that KV head, so each
K/V tile is read once per KV head; a loop inside the block over KV tiles
carries the online-softmax state (m, l, acc in f32). Tiles that are dead
(causal, window, past Lk) are skipped, boundary tiles are masked per element
with the finite ``NEG_INF``.

``_route`` picks the design from the dtype alone: ``"mma"`` for bf16, a
FlashAttention-2 kernel on ``mma.sync`` m16n8k16 with K/V tiles of 64 keys
staged in bf16 by double-buffered ``cp.async`` (bound by bytes at the serving
shapes, ~128 FLOP per byte); ``"fma"`` for f32, the first port's FMA kernel,
since the tensor cores would round f32 products to TF32 and break the
reference's f32 parity. The C entry refuses any other pairing.

With ``return_lse=True`` either route also writes each row's log-sum-exp
(B, H, Lq) f32, which ``flash_attention_bwd`` takes: the backward (K1, no
Pallas counterpart; ``csrc/flash_attention_bwd.cu``) recomputes P from it and
returns dQ, dK and dV, with dK and dV summed over each KV head's ``gq`` query
heads. ``_bwd_route`` picks its design from the dtype and the head dim:
``"wgmma"`` for bf16 at Dh 64 and 128 (``wgmma`` fed by a TMA ring, D folded
into dQ's launch, its longest causal q-tiles first), ``"mma"`` (``mma.sync``)
for bf16 at Dh 16 and 32, ``"fma"`` for f32.

For tensors on the CPU or the meta device (``ref.PLAIN_DEVICES``) each
wrapper computes the plain version
(``ref.reference_attention``, ``ref.reference_attention_bwd``); for CUDA
tensors it launches its kernel or raises. ``flash_attention.launches`` counts
forward launches, ``flash_attention.route_launches`` the same launches by
route; ``flash_attention_bwd.launches`` counts backward calls (each one call
of the C entry, which launches two kernels on ``"wgmma"`` and three on the
others), ``route_launches`` by route.
"""

from __future__ import annotations

import ctypes

import torch

from . import build
from .ref import PLAIN_DEVICES, reference_attention, reference_attention_bwd

# the (Dk, Dv) pairs the forward kernel is built for (as the .cu's FA_DISPATCH):
# Dk = Dv, and MLA's (96, 64); the backward takes Dk = Dv of the first four only
HEAD_DIM_PAIRS = ((16, 16), (32, 32), (64, 64), (128, 128), (96, 64))
ROWS = 64  # query rows (gq heads x q positions) per thread block; as in the .cu
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
ROUTES = {"fma": 0, "mma": 1}  # as the .cu's route argument
BWD_ROUTES = {"fma": 0, "mma": 1, "wgmma": 2}  # as flash_attention_bwd.cu's route argument


def _fn():
    lib = build.load("flash_attention")
    fn = lib.flash_attention_fwd
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 11 + [ctypes.c_float, ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return fn


def _bwd_fn():
    lib = build.load("flash_attention_bwd")
    fn = lib.flash_attention_bwd
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 10 + [ctypes.c_int] * 10 + [ctypes.c_float, ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return fn


def _route(dtype: torch.dtype) -> str:
    """The kernel design a CUDA call in this dtype takes (every pair of
    HEAD_DIM_PAIRS and every gq up to ROWS has both)."""
    return "mma" if dtype == torch.bfloat16 else "fma"


def _bwd_route(dtype: torch.dtype, Dh: int) -> str:
    """The backward's design for a CUDA call in this dtype at head dim Dh."""
    if dtype != torch.bfloat16:
        return "fma"
    return "wgmma" if Dh in (64, 128) else "mma"


def _check_inputs(q, k, v, window: int, return_lse: bool = False):
    """Raise on anything the kernel does not take."""
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4 or k.shape[:3] != v.shape[:3]:
        raise ValueError(f"want q (B,Lq,H,Dk), k (B,Lk,KVH,Dk), v (B,Lk,KVH,Dv); got {q.shape} {k.shape} {v.shape}")
    B, Lq, H, Dk = q.shape
    if k.shape[0] != B or k.shape[3] != Dk or H % k.shape[2] or k.shape[1] == 0 or Lq == 0:
        raise ValueError(f"shape mismatch: q {tuple(q.shape)} k {tuple(k.shape)}")
    if H // k.shape[2] > ROWS:
        raise ValueError(f"gq = {H // k.shape[2]} query heads per KV head > {ROWS}")
    if not (q.device == k.device == v.device):
        raise ValueError("q, k, v on different devices")
    if not (q.dtype == k.dtype == v.dtype) or q.dtype not in _DTYPES:
        raise TypeError(f"dtypes {q.dtype} {k.dtype} {v.dtype}: want one of float32, bfloat16")
    pair = (Dk, v.shape[3])
    if pair not in HEAD_DIM_PAIRS:
        raise ValueError(f"head dims (Dk, Dv) = {pair} not in {HEAD_DIM_PAIRS}")
    if return_lse and pair[0] != pair[1]:
        raise ValueError(f"return_lse at (Dk, Dv) = {pair}: the backward takes Dk = Dv only "
                         "(ROADMAP.md queue 1, item 5b)")
    if window < 0:
        raise ValueError(f"window {window} < 0")


def flash_attention(
    q: torch.Tensor,  # (B, Lq, H, Dk)
    k: torch.Tensor,  # (B, Lk, KVH, Dk)
    v: torch.Tensor,  # (B, Lk, KVH, Dv)
    *,
    causal: bool = True,
    window: int = 0,
    return_lse: bool = False,
):
    """Returns (B, Lq, H, Dv) in q's dtype, scaled by Dk**-0.5, and with
    ``return_lse`` (Dk = Dv only) also each row's log-sum-exp (B, H, Lq) f32.
    Positions are 0..Lq-1 and 0..Lk-1
    (causal means k_pos <= q_pos, aligned at the top left). Refuses inputs
    that require a gradient (outside ``torch.no_grad``/``inference_mode``):
    the kernel's output carries no graph, so a gradient goes through
    ``repro_torch.models.attention.FlashAttention``, which pairs this call
    with ``flash_attention_bwd``."""
    _check_inputs(q, k, v, window, return_lse)
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        raise RuntimeError("flash_attention drops the gradient: differentiate through "
                           "repro_torch.models.attention.FlashAttention")
    if q.device.type in PLAIN_DEVICES:
        return reference_attention(q, k, v, causal=causal, window=window, return_lse=return_lse)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention: unsupported device {q.device}")
    if not (q.is_contiguous() and k.is_contiguous() and v.is_contiguous()):
        raise ValueError("flash_attention: q, k, v must be contiguous")
    B, Lq, H, Dk = q.shape
    Lk, KVH, Dv = k.shape[1], k.shape[2], v.shape[3]
    route = _route(q.dtype)
    out = torch.empty((B, Lq, H, Dv), dtype=q.dtype, device=q.device)
    lse = torch.empty((B, H, Lq), dtype=torch.float32, device=q.device) if return_lse else None
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = _fn()(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), 0 if lse is None else lse.data_ptr(),
            _DTYPES[q.dtype], ROUTES[route], B, Lq, Lk, H, KVH, Dk, Dv, int(causal), int(window),
            Dk**-0.5, stream,
        )
    if rc != 0:
        raise RuntimeError(f"flash_attention kernel launch failed on route {route!r}: cudaError_t {rc}")
    flash_attention.launches += 1
    flash_attention.route_launches[route] += 1
    return (out, lse) if return_lse else out


flash_attention.launches = 0
flash_attention.route_launches = dict.fromkeys(ROUTES, 0)


def flash_attention_bwd(
    q: torch.Tensor,  # (B, Lq, H, Dh)
    k: torch.Tensor,  # (B, Lk, KVH, Dh)
    v: torch.Tensor,  # (B, Lk, KVH, Dh)
    o: torch.Tensor,  # (B, Lq, H, Dh) the forward's output
    do: torch.Tensor,  # (B, Lq, H, Dh) its cotangent
    lse: torch.Tensor,  # (B, H, Lq) f32 from flash_attention(..., return_lse=True)
    *,
    causal: bool = True,
    window: int = 0,
):
    """Returns (dq, dk, dv) in the inputs' dtype: the gradient of
    ``flash_attention(q, k, v, causal=causal, window=window)`` against ``do``.
    Shapes with a row that sees no key (``window > 0`` and Lq >= Lk + window)
    are refused: the forward leaves such a row's output undefined."""
    _check_inputs(q, k, v, window)
    B, Lq, H, _ = q.shape
    if v.shape != k.shape:
        raise ValueError(f"flash_attention_bwd takes Dk = Dv only, not {q.shape[3]}, {v.shape[3]} "
                         "(ROADMAP.md queue 1, item 5b)")
    if o.shape != q.shape or do.shape != q.shape or o.dtype != q.dtype or do.dtype != q.dtype:
        raise ValueError(f"o {tuple(o.shape)} {o.dtype}, do {tuple(do.shape)} {do.dtype}: want q's "
                         f"{tuple(q.shape)} {q.dtype}")
    if lse.shape != (B, H, Lq) or lse.dtype != torch.float32:
        raise ValueError(f"lse {tuple(lse.shape)} {lse.dtype}: want ({B}, {H}, {Lq}) float32")
    if any(t.device != q.device for t in (o, do, lse)):
        raise ValueError("flash_attention_bwd: inputs on different devices")
    if window > 0 and Lq >= k.shape[1] + window:
        raise ValueError(f"window {window} leaves rows of Lq {Lq} with none of Lk {k.shape[1]} keys")
    if q.device.type in PLAIN_DEVICES:
        return reference_attention_bwd(q, k, v, o, do, lse, causal=causal, window=window)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention_bwd: unsupported device {q.device}")
    # contiguous, and 16-byte aligned for the tensor-core routes' copies (cp.async, TMA)
    ins = [t if t.is_contiguous() and t.data_ptr() % 16 == 0 else t.clone(memory_format=torch.contiguous_format)
           for t in (q, k, v, o, do, lse)]
    Lk, KVH, Dh = k.shape[1], k.shape[2], k.shape[3]
    route = _bwd_route(q.dtype, Dh)
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    dvec = torch.empty((B, H, Lq), dtype=torch.float32, device=q.device)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = _bwd_fn()(
            *(t.data_ptr() for t in ins), dvec.data_ptr(), dq.data_ptr(), dk.data_ptr(), dv.data_ptr(),
            _DTYPES[q.dtype], BWD_ROUTES[route], B, Lq, Lk, H, KVH, Dh, int(causal), int(window), Dh**-0.5,
            stream,
        )
    if rc != 0:
        raise RuntimeError(f"flash_attention_bwd kernel launch failed on route {route!r}: cudaError_t {rc}")
    flash_attention_bwd.launches += 1
    flash_attention_bwd.route_launches[route] += 1
    return dq, dk, dv


flash_attention_bwd.launches = 0
flash_attention_bwd.route_launches = dict.fromkeys(BWD_ROUTES, 0)

"""Flash attention (causal / sliding-window / GQA) for Hopper.

Port of ``repro.kernels.flash_attention`` (Pallas). The kernel is hand-written
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

For tensors on the CPU the wrapper computes the plain version
(``ref.reference_attention``); for CUDA tensors it launches the chosen route
or raises. ``flash_attention.launches`` counts kernel launches,
``flash_attention.route_launches`` the same launches by route.
"""

from __future__ import annotations

import ctypes

import torch

from . import build
from .ref import reference_attention

HEAD_DIMS = (16, 32, 64, 128)
ROWS = 64  # query rows (gq heads x q positions) per thread block; as in the .cu
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
ROUTES = {"fma": 0, "mma": 1}  # as the .cu's route argument


def _fn():
    lib = build.load("flash_attention")
    fn = lib.flash_attention_fwd
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 10 + [ctypes.c_float, ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return fn


def _route(dtype: torch.dtype) -> str:
    """The kernel design a CUDA call in this dtype takes (every head dim of
    HEAD_DIMS and every gq up to ROWS has both)."""
    return "mma" if dtype == torch.bfloat16 else "fma"


def _check_inputs(q, k, v, window: int):
    """Raise on anything the kernel does not take."""
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape:
        raise ValueError(f"want q (B,Lq,H,Dh), k=v (B,Lk,KVH,Dh); got {q.shape} {k.shape} {v.shape}")
    B, Lq, H, Dh = q.shape
    if k.shape[0] != B or k.shape[3] != Dh or H % k.shape[2] or k.shape[1] == 0 or Lq == 0:
        raise ValueError(f"shape mismatch: q {tuple(q.shape)} k {tuple(k.shape)}")
    if H // k.shape[2] > ROWS:
        raise ValueError(f"gq = {H // k.shape[2]} query heads per KV head > {ROWS}")
    if not (q.device == k.device == v.device):
        raise ValueError("q, k, v on different devices")
    if not (q.dtype == k.dtype == v.dtype) or q.dtype not in _DTYPES:
        raise TypeError(f"dtypes {q.dtype} {k.dtype} {v.dtype}: want one of float32, bfloat16")
    if Dh not in HEAD_DIMS:
        raise ValueError(f"head dim {Dh} not in {HEAD_DIMS}")
    if window < 0:
        raise ValueError(f"window {window} < 0")


def flash_attention(
    q: torch.Tensor,  # (B, Lq, H, Dh)
    k: torch.Tensor,  # (B, Lk, KVH, Dh)
    v: torch.Tensor,  # (B, Lk, KVH, Dh)
    *,
    causal: bool = True,
    window: int = 0,
) -> torch.Tensor:
    """Returns (B, Lq, H, Dh) in q's dtype. Positions are 0..Lq-1 and 0..Lk-1
    (causal means k_pos <= q_pos, aligned at the top left)."""
    _check_inputs(q, k, v, window)
    if q.device.type == "cpu":
        return reference_attention(q, k, v, causal=causal, window=window)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention: unsupported device {q.device}")
    if not (q.is_contiguous() and k.is_contiguous() and v.is_contiguous()):
        raise ValueError("flash_attention: q, k, v must be contiguous")
    B, Lq, H, Dh = q.shape
    Lk, KVH = k.shape[1], k.shape[2]
    route = _route(q.dtype)
    out = torch.empty_like(q)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = _fn()(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            _DTYPES[q.dtype], ROUTES[route], B, Lq, Lk, H, KVH, Dh, int(causal), int(window),
            Dh**-0.5, stream,
        )
    if rc != 0:
        raise RuntimeError(f"flash_attention kernel launch failed on route {route!r}: cudaError_t {rc}")
    flash_attention.launches += 1
    flash_attention.route_launches[route] += 1
    return out


flash_attention.launches = 0
flash_attention.route_launches = dict.fromkeys(ROUTES, 0)

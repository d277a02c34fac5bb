"""Grouped SwiGLU over MoE capacity bins, for Hopper.

Port of ``repro.kernels.moe_gmm`` (Pallas). The kernel is hand-written CUDA
C++ in ``csrc/moe_gmm.cu``. One call is two CUDA launches: a fused
gate/up/SiLU/product pass that writes ``h`` (E, C, F) in x's dtype (where the
Pallas kernel casts it), then an ``h @ Wd`` pass with f32 sums over the
whole of F in one block (no split-F atomics, so the result does not depend on
launch order). ``h`` is scratch allocated here.

``_route`` picks one of three designs from the dtype and shapes:

- ``"wgmma"`` (bf16, bins of more than 8 rows: prefill): a warp-specialised,
  persistent GEMM: TMA loads into a 4-stage ring and two consumer
  warpgroups on ``wgmma`` m64n256k16 (gate and up in one product); bound by
  the tensor cores' rate (~315 FLOP per byte at jamba's prefill bins).
- ``"swap_ab"`` (bf16, bins of at most 8 rows: decode): the weights on the
  tensor core's M side (``mma.sync`` m16n8k16, the bin padded to N = 8),
  streamed in 128-byte rows through per-warp ``cp.async`` rings; bound by
  the bytes of the expert weights, every one of which is read.
- ``"fma"``: the first port's FMA tiles, for every f32 call (tensor cores
  would round f32 products to TF32 and break the reference's f32 parity) and
  for bf16 shapes whose D or F is not a multiple of 8 (TMA and the 16-byte
  copies need 16-byte rows).

For tensors on the CPU or the meta device the wrapper computes the plain version
(``ref.reference_gmm``); for CUDA tensors it launches the chosen route or
raises, never another route. ``moe_gmm.launches`` counts calls that launched
the kernel (one per call), ``moe_gmm.route_launches`` the same calls by route.
"""

from __future__ import annotations

import ctypes

import torch

from . import build
from .ref import PLAIN_DEVICES, reference_gmm

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
ROUTES = {"fma": 0, "wgmma": 1, "swap_ab": 2}  # as the .cu's Route enum


def _fn():
    lib = build.load("moe_gmm")
    fn = lib.moe_gmm_fwd
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 6 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return fn


def _route(dtype: torch.dtype, E: int, C: int, D: int, F: int) -> str:
    """The kernel design a CUDA call with these inputs takes (see the module note)."""
    if dtype != torch.bfloat16 or D % 8 or F % 8:
        return "fma"
    return "swap_ab" if C <= 8 else "wgmma"


def _check_inputs(x, w_gate, w_up, w_down):
    """Raise on anything the kernel does not take."""
    if x.dim() != 3 or w_gate.dim() != 3 or w_gate.shape != w_up.shape or w_down.dim() != 3:
        raise ValueError(f"want x (E,C,D), w_gate=w_up (E,D,F), w_down (E,F,D); got "
                         f"{tuple(x.shape)} {tuple(w_gate.shape)} {tuple(w_up.shape)} {tuple(w_down.shape)}")
    E, C, D = x.shape
    F = w_gate.shape[2]
    if w_gate.shape[:2] != (E, D) or w_down.shape != (E, F, D) or min(E, C, D, F) == 0:
        raise ValueError(f"shape mismatch: x {tuple(x.shape)} w_gate {tuple(w_gate.shape)} "
                         f"w_down {tuple(w_down.shape)}")
    if any(t.device != x.device for t in (w_gate, w_up, w_down)):
        raise ValueError("moe_gmm: inputs on different devices")
    if not (x.dtype == w_gate.dtype == w_up.dtype == w_down.dtype) or x.dtype not in _DTYPES:
        raise TypeError(f"dtypes {x.dtype} {w_gate.dtype} {w_up.dtype} {w_down.dtype}: "
                        "want one of float32, bfloat16, all alike")


def moe_gmm(
    x: torch.Tensor,  # (E, C, D) per-expert token bins
    w_gate: torch.Tensor,  # (E, D, F)
    w_up: torch.Tensor,  # (E, D, F)
    w_down: torch.Tensor,  # (E, F, D)
) -> torch.Tensor:
    """Returns (E, C, D) in x's dtype. Refuses inputs that require a gradient
    (outside ``torch.no_grad``/``inference_mode``): no backward kernel exists
    yet (ROADMAP K7), and the kernel's output would carry no graph."""
    _check_inputs(x, w_gate, w_up, w_down)
    if torch.is_grad_enabled() and any(t.requires_grad for t in (x, w_gate, w_up, w_down)):
        raise NotImplementedError("moe_gmm has no backward kernel yet (ROADMAP K7): "
                                  "call it under torch.no_grad() or torch.inference_mode()")
    if x.device.type in PLAIN_DEVICES:
        return reference_gmm(x, w_gate, w_up, w_down)
    if x.device.type != "cuda":
        raise ValueError(f"moe_gmm: unsupported device {x.device}")
    if not all(t.is_contiguous() for t in (x, w_gate, w_up, w_down)):
        raise ValueError("moe_gmm: inputs must be contiguous")
    E, C, D = x.shape
    F = w_gate.shape[2]
    route = _route(x.dtype, E, C, D, F)
    h = torch.empty((E, C, F), dtype=x.dtype, device=x.device)
    out = torch.empty_like(x)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        rc = _fn()(
            x.data_ptr(), w_gate.data_ptr(), w_up.data_ptr(), w_down.data_ptr(), h.data_ptr(),
            out.data_ptr(), _DTYPES[x.dtype], ROUTES[route], E, C, D, F, stream,
        )
    if rc != 0:
        raise RuntimeError(f"moe_gmm kernel launch failed on route {route!r}: cudaError_t {rc}")
    moe_gmm.launches += 1
    moe_gmm.route_launches[route] += 1
    return out


moe_gmm.launches = 0
moe_gmm.route_launches = dict.fromkeys(ROUTES, 0)

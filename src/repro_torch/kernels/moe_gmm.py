"""Grouped SwiGLU over MoE capacity bins, for Hopper.

Port of ``repro.kernels.moe_gmm`` (Pallas). The kernel is hand-written CUDA
C++ in ``csrc/moe_gmm.cu``. One call is two CUDA launches: a fused
gate/up/SiLU/product pass that writes ``h`` (E, C, F) in x's dtype (where the
Pallas kernel casts it), then a tiled ``h @ Wd`` pass with f32 sums over the
whole of F in one block (no split-F atomics, so the result does not depend on
launch order). ``h`` is scratch allocated here.

For tensors on the CPU the wrapper computes the plain version
(``ref.reference_gmm``); for CUDA tensors it launches the kernel or raises.
``moe_gmm.launches`` counts calls that launched the kernel (one per call).
"""

from __future__ import annotations

import ctypes

import torch

from . import build
from .ref import reference_gmm

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def _fn():
    lib = build.load("moe_gmm")
    fn = lib.moe_gmm_fwd
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return fn


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
    """Returns (E, C, D) in x's dtype."""
    _check_inputs(x, w_gate, w_up, w_down)
    if x.device.type == "cpu":
        return reference_gmm(x, w_gate, w_up, w_down)
    if x.device.type != "cuda":
        raise ValueError(f"moe_gmm: unsupported device {x.device}")
    if not all(t.is_contiguous() for t in (x, w_gate, w_up, w_down)):
        raise ValueError("moe_gmm: inputs must be contiguous")
    E, C, D = x.shape
    F = w_gate.shape[2]
    h = torch.empty((E, C, F), dtype=x.dtype, device=x.device)
    out = torch.empty_like(x)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        rc = _fn()(
            x.data_ptr(), w_gate.data_ptr(), w_up.data_ptr(), w_down.data_ptr(), h.data_ptr(),
            out.data_ptr(), _DTYPES[x.dtype], E, C, D, F, stream,
        )
    if rc != 0:
        raise RuntimeError(f"moe_gmm kernel launch failed: cudaError_t {rc}")
    moe_gmm.launches += 1
    return out


moe_gmm.launches = 0

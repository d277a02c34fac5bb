"""Mamba-1 selective scan, for Hopper.

Port of ``repro.kernels.mamba_scan`` (Pallas). The kernel is hand-written
CUDA C++ in ``csrc/mamba_scan.cu``: one thread owns one (batch, channel)
pair and holds all N state elements ``h[n]`` in registers through one loop
over all L steps, consecutive threads on consecutive channels (whole lines of
``dt``, ``xc`` and ``y`` a warp and step); ``B_t`` and ``C_t``, shared by a
batch row's threads, are staged in shared memory with ``cp.async``. The Pallas
kernel's chunk grid exists only because TPU grid axes run in order, so
``chunk_len`` is accepted, for the reference's signature, and ignored: ragged
L and ragged Di are bounds checks in the kernel, not padding.

For tensors on the CPU the wrapper computes the plain version
(``ref.reference_selective_scan``); for CUDA tensors it launches the kernel
or raises. ``mamba_scan.launches`` counts kernel launches.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from . import build
from .ref import reference_selective_scan

STATE_SIZES = (4, 8, 16, 32)  # N states per thread, in registers
MAX_AHEAD = 16  # the kernel computes step offsets t * Di up to t = L + 16
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def _fn():
    lib = build.load("mamba_scan")
    fn = lib.mamba_scan_fwd
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return fn


def _check_inputs(xc, dt, Bm, Cm, a, h0):
    """Raise on anything the kernel does not take."""
    if xc.dim() != 3 or dt.shape != xc.shape or Bm.dim() != 3 or Cm.shape != Bm.shape or a.dim() != 2:
        raise ValueError(f"want xc=dt (B,L,Di), Bm=Cm (B,L,N), a (Di,N); got {tuple(xc.shape)} "
                         f"{tuple(dt.shape)} {tuple(Bm.shape)} {tuple(Cm.shape)} {tuple(a.shape)}")
    B, L, Di = xc.shape
    N = a.shape[1]
    if Bm.shape[:2] != (B, L) or a.shape[0] != Di or Bm.shape[2] != N or B * L * Di == 0:
        raise ValueError(f"shape mismatch: xc {tuple(xc.shape)} Bm {tuple(Bm.shape)} a {tuple(a.shape)}")
    if h0 is not None and h0.shape != (B, Di, N):
        raise ValueError(f"h0 {tuple(h0.shape)}: want {(B, Di, N)}")
    rest = [t for t in (dt, Bm, Cm, a, h0) if t is not None]
    if any(t.device != xc.device for t in rest):
        raise ValueError("mamba_scan: inputs on different devices")
    if xc.dtype not in _DTYPES or any(t.dtype != torch.float32 for t in rest):
        raise TypeError(f"want xc float32 or bfloat16 and dt, Bm, Cm, a, h0 float32; got xc {xc.dtype}, "
                        f"others {[t.dtype for t in rest]}")
    if N not in STATE_SIZES:
        raise ValueError(f"state size {N} not in {STATE_SIZES}")
    if (L + MAX_AHEAD) * Di >= 2**31:
        raise ValueError(f"L * Di = {L * Di}: too large for the kernel's 32-bit step offsets")


def mamba_scan(
    xc: torch.Tensor,  # (B, L, Di) post-conv activations
    dt: torch.Tensor,  # (B, L, Di) f32, post-softplus
    Bm: torch.Tensor,  # (B, L, N) f32
    Cm: torch.Tensor,  # (B, L, N) f32
    a: torch.Tensor,  # (Di, N) f32, negative
    h0: Optional[torch.Tensor] = None,  # (B, Di, N) f32 carry-in state
    chunk_len: int = 256,  # the reference's time blocking; the kernel does not chunk
):
    """Returns (y (B, L, Di) f32, h_final (B, Di, N) f32)."""
    _check_inputs(xc, dt, Bm, Cm, a, h0)
    if xc.device.type == "cpu":
        return reference_selective_scan(xc, dt, Bm, Cm, a, h0)
    if xc.device.type != "cuda":
        raise ValueError(f"mamba_scan: unsupported device {xc.device}")
    if not all(t.is_contiguous() for t in (xc, dt, Bm, Cm, a, h0) if t is not None):
        raise ValueError("mamba_scan: inputs must be contiguous")
    if Bm.data_ptr() % 16 or Cm.data_ptr() % 16:
        raise ValueError("mamba_scan: Bm and Cm must be 16-byte aligned (cp.async)")
    B, L, Di = xc.shape
    N = a.shape[1]
    y = torch.empty((B, L, Di), dtype=torch.float32, device=xc.device)
    h = torch.empty((B, Di, N), dtype=torch.float32, device=xc.device)
    with torch.cuda.device(xc.device):
        stream = torch.cuda.current_stream(xc.device).cuda_stream
        rc = _fn()(
            xc.data_ptr(), dt.data_ptr(), Bm.data_ptr(), Cm.data_ptr(), a.data_ptr(),
            0 if h0 is None else h0.data_ptr(), y.data_ptr(), h.data_ptr(),
            _DTYPES[xc.dtype], B, L, Di, N, stream,
        )
    if rc != 0:
        raise RuntimeError(f"mamba_scan kernel launch failed: cudaError_t {rc}")
    mamba_scan.launches += 1
    return y, h


mamba_scan.launches = 0

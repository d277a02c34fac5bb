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

The kernel's step offsets are 32-bit: one launch takes ``(L + MAX_AHEAD) *
Di < OFFSET_LIMIT`` (L < 262,128 at Di 8192). A longer scan is cut into
segments of ``segment_len(Di)`` steps, scanned in turn, each seeded with the
previous segment's final state; the scan is sequential, so the result is the
same. The kernel reads and writes a segment in place inside the whole
tensors through batch strides (no copy). Segmenting applies on every device:
on the CPU each segment goes through the plain version. A scan under the
limit is one launch, as before.

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
OFFSET_LIMIT = 2**31  # a launch's step offsets (L + MAX_AHEAD) * Di stay below this (int32)
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def _fn():
    lib = build.load("mamba_scan")
    fn = lib.mamba_scan_fwd
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 5 + [ctypes.c_longlong] * 2 + [ctypes.c_void_p]
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
    segment_len(Di)


def segment_len(Di: int) -> int:
    """The most steps one launch scans at ``Di`` channels: ``(steps +
    MAX_AHEAD) * Di < OFFSET_LIMIT``. Raises where not even one step fits."""
    steps = (OFFSET_LIMIT - 1) // Di - MAX_AHEAD
    if steps < 1:
        raise ValueError(f"Di = {Di}: one step is too large for the kernel's 32-bit step offsets")
    return steps


def mamba_scan(
    xc: torch.Tensor,  # (B, L, Di) post-conv activations
    dt: torch.Tensor,  # (B, L, Di) f32, post-softplus
    Bm: torch.Tensor,  # (B, L, N) f32
    Cm: torch.Tensor,  # (B, L, N) f32
    a: torch.Tensor,  # (Di, N) f32, negative
    h0: Optional[torch.Tensor] = None,  # (B, Di, N) f32 carry-in state
    chunk_len: int = 256,  # the reference's time blocking; the kernel does not chunk
):
    """Returns (y (B, L, Di) f32, h_final (B, Di, N) f32). Refuses inputs that
    require a gradient (outside ``torch.no_grad``/``inference_mode``): no
    backward kernel exists yet (ROADMAP K7), and the kernel's output would
    carry no graph."""
    _check_inputs(xc, dt, Bm, Cm, a, h0)
    if torch.is_grad_enabled() and any(t is not None and t.requires_grad for t in (xc, dt, Bm, Cm, a, h0)):
        raise NotImplementedError("mamba_scan has no backward kernel yet (ROADMAP K7): "
                                  "call it under torch.no_grad() or torch.inference_mode()")
    B, L, Di = xc.shape
    seg = segment_len(Di)
    if xc.device.type == "cpu":
        if L <= seg:
            return reference_selective_scan(xc, dt, Bm, Cm, a, h0)
        ys, h = [], h0
        for s in range(0, L, seg):
            y, h = reference_selective_scan(xc[:, s : s + seg], dt[:, s : s + seg], Bm[:, s : s + seg],
                                            Cm[:, s : s + seg], a, h)
            ys.append(y)
        return torch.cat(ys, dim=1), h
    if xc.device.type != "cuda":
        raise ValueError(f"mamba_scan: unsupported device {xc.device}")
    if not all(t.is_contiguous() for t in (xc, dt, Bm, Cm, a, h0) if t is not None):
        raise ValueError("mamba_scan: inputs must be contiguous")
    if Bm.data_ptr() % 16 or Cm.data_ptr() % 16:
        raise ValueError("mamba_scan: Bm and Cm must be 16-byte aligned (cp.async)")
    N = a.shape[1]
    y = torch.empty((B, L, Di), dtype=torch.float32, device=xc.device)
    # the final state of each segment seeds the next: two buffers in turn
    hs = [torch.empty((B, Di, N), dtype=torch.float32, device=xc.device) for _ in range(1 + (L > seg))]
    h_in = 0 if h0 is None else h0.data_ptr()
    with torch.cuda.device(xc.device):
        stream = torch.cuda.current_stream(xc.device).cuda_stream
        for i, s in enumerate(range(0, L, seg)):
            h = hs[i % len(hs)]
            # segment [s, s + n): the same tensors, s steps on; batch rows L steps apart
            rc = _fn()(
                xc.data_ptr() + s * Di * xc.element_size(), dt.data_ptr() + s * Di * 4,
                Bm.data_ptr() + s * N * 4, Cm.data_ptr() + s * N * 4, a.data_ptr(), h_in,
                y.data_ptr() + s * Di * 4, h.data_ptr(),
                _DTYPES[xc.dtype], B, min(seg, L - s), Di, N, L * Di, L * N, stream,
            )
            if rc != 0:
                raise RuntimeError(f"mamba_scan kernel launch failed: cudaError_t {rc}")
            mamba_scan.launches += 1
            h_in = h.data_ptr()
    return y, h


mamba_scan.launches = 0

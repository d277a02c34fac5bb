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

``mamba_scan_bwd`` (K7b, no Pallas counterpart: the JAX train step
differentiates the chunked scan of ``repro/models/mamba.py``) returns dxc,
ddt, dB, dC, dA and dh0 from the forward's inputs and the cotangents of y and
h_final, by ``csrc/mamba_scan.cu``'s ``mamba_scan_bwd``. A forward pass
stores the state at every ``BWD_CHUNK`` steps in f32 scratch, loading the
next chunk's inputs while it runs a chunk; a reverse pass walks the chunks
backwards with no global load on a step's critical path: a block of
``BWD_BLOCK`` channels stages a chunk's dt, xc, dy, B and C in shared memory
(the next chunk's copies in flight meanwhile), each channel's states split
over lanes, recomputed from the checkpoint into registers, and the state's
cotangent run back through them; dB and dC, sums over the channels of a (b,
t), are summed over each block in a fixed order into one partial a block,
and those, and dA's per-batch sums, by a last launch (no float atomics: a
repeated call is bit-equal). A scan past the offset limit is walked in the
forward's segments, in reverse for the cotangents, inside that one call.
The first design (one thread a channel, per-step loads, per-warp partials;
``mamba_scan_bwd_per_step`` in the .cu) is no longer chosen: it stays
reachable only as the baseline ``chip_smoke.py`` times beside the chunked one
(``_bwd_design``). ``bwd_scratch_shapes`` gives each design's scratch.

For tensors on the CPU or the meta device each wrapper computes its plain
version (``ref.reference_selective_scan``, ``ref.reference_selective_scan_bwd``,
segment by segment where the scan is cut; on the meta device their loops
walk one step that stands for all L, ``ref._walk``; inside
``models.common.cost_scope(SCOPE)``, the roofline's region); for CUDA tensors it
launches its kernel or raises. ``mamba_scan.launches`` counts forward kernel
launches, ``mamba_scan_bwd.launches`` backward calls (each one call of the C entry), and
``mamba_scan_bwd.route_launches`` the same calls by design. The
bare ``mamba_scan`` refuses inputs that require a gradient: a gradient goes
through ``repro_torch.models.mamba.MambaScan``, which pairs it with
``mamba_scan_bwd``.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from repro_torch.models.common import cost_scope
from repro_torch.obs import spanned

from . import build
from .ref import PLAIN_DEVICES, reference_selective_scan, reference_selective_scan_bwd

SCOPE = "pallas_mamba_scan"  # the roofline's region of the kernel

STATE_SIZES = (4, 8, 16, 32)  # N states per thread, in registers
MAX_AHEAD = 16  # the kernel computes step offsets t * Di up to t = L + 16
OFFSET_LIMIT = 2**31  # a launch's step offsets (L + MAX_AHEAD) * Di stay below this (int32)
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
BWD_CHUNK = 16  # steps between the backward's checkpoints (as the .cu's K)
# the backward's designs, by the C entry each calls: "chunked" (the one
# chosen) and "per_step" (the first, a baseline), and the channels each sums
# into one dB, dC partial (the .cu's CHB, a block; a warp's 32)
BWD_DESIGNS = {"chunked": "mamba_scan_bwd", "per_step": "mamba_scan_bwd_per_step"}
BWD_BLOCK = 64
_PARTIAL_CHANNELS = {"chunked": BWD_BLOCK, "per_step": 32}


def _fn():
    lib = build.load("mamba_scan")
    fn = lib.mamba_scan_fwd
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 5 + [ctypes.c_longlong] * 2 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return fn


def _bwd_fn(design: str):
    lib = build.load("mamba_scan")
    fn = getattr(lib, BWD_DESIGNS[design])
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 17 + [ctypes.c_int] * 6 + [ctypes.c_void_p]
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


def _bwd_design() -> str:
    """The backward's design a CUDA call takes (``"per_step"`` is never
    chosen; see the module note)."""
    return "chunked"


def bwd_scratch_shapes(B: int, L: int, Di: int, N: int, seg: int, design: str = "chunked") -> dict:
    """The f32 scratch ``mamba_scan_bwd``'s C entry of ``design`` takes for
    a scan of (B, L, Di, N) cut into segments of ``seg`` steps: ``ckpt`` (a
    checkpoint at the start of every ``BWD_CHUNK`` steps of each segment, and
    one more slot), ``part_bc`` (dB and dC partial sums, one for each
    ``_PARTIAL_CHANNELS[design]`` channels) and ``part_a`` (dA summed over L,
    per batch row)."""
    slots = sum(-(-min(seg, L - s) // BWD_CHUNK) for s in range(0, L, seg)) + 1
    parts = -(-Di // _PARTIAL_CHANNELS[design])
    return {"ckpt": (B, slots, N, Di), "part_bc": (B, L, parts, 2 * N), "part_a": (B, Di, N)}


def segment_len(Di: int) -> int:
    """The most steps one launch scans at ``Di`` channels: ``(steps +
    MAX_AHEAD) * Di < OFFSET_LIMIT``. Raises where not even one step fits."""
    steps = (OFFSET_LIMIT - 1) // Di - MAX_AHEAD
    if steps < 1:
        raise ValueError(f"Di = {Di}: one step is too large for the kernel's 32-bit step offsets")
    return steps


@spanned("kernel.mamba_scan")
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
    require a gradient (outside ``torch.no_grad``/``inference_mode``): the
    kernel's outputs carry no graph, so a gradient goes through
    ``repro_torch.models.mamba.MambaScan``, which pairs this call with
    ``mamba_scan_bwd``."""
    _check_inputs(xc, dt, Bm, Cm, a, h0)
    if torch.is_grad_enabled() and any(t is not None and t.requires_grad for t in (xc, dt, Bm, Cm, a, h0)):
        raise RuntimeError("mamba_scan drops the gradient: differentiate through "
                           "repro_torch.models.mamba.MambaScan")
    B, L, Di = xc.shape
    seg = segment_len(Di)
    if xc.device.type in PLAIN_DEVICES:
        with cost_scope(SCOPE):
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


def _plain_bwd_segments(xc, dt, Bm, Cm, a, h0, dy, dh_final, seg):
    """The plain backward of a scan cut into segments of ``seg`` steps: the
    forward seeds each segment's state, then the segments run in reverse,
    each seeded with the later one's state cotangent."""
    L = xc.shape[1]
    starts = list(range(0, L, seg))
    cut = lambda t, s: t[:, s : s + seg]
    seeds = [h0]
    for s in starts[:-1]:
        seeds.append(reference_selective_scan(cut(xc, s), cut(dt, s), cut(Bm, s), cut(Cm, s), a, seeds[-1])[1])
    parts, da, carry = [], None, dh_final
    for s, h in zip(reversed(starts), reversed(seeds)):
        dxc, ddt, dB, dC, da_s, carry = reference_selective_scan_bwd(
            cut(xc, s), cut(dt, s), cut(Bm, s), cut(Cm, s), a, h, cut(dy, s), carry)
        parts.append((dxc, ddt, dB, dC))
        da = da_s if da is None else da + da_s
    dxc, ddt, dB, dC = (torch.cat([p[i] for p in reversed(parts)], dim=1) for i in range(4))
    return dxc, ddt, dB, dC, da, carry


@spanned("kernel.mamba_scan_bwd")
def mamba_scan_bwd(
    xc: torch.Tensor,  # (B, L, Di)
    dt: torch.Tensor,  # (B, L, Di) f32
    Bm: torch.Tensor,  # (B, L, N) f32
    Cm: torch.Tensor,  # (B, L, N) f32
    a: torch.Tensor,  # (Di, N) f32
    h0: Optional[torch.Tensor],  # (B, Di, N) f32, or None (a zero state)
    dy: torch.Tensor,  # (B, L, Di) f32, the cotangent of y
    dh_final: Optional[torch.Tensor] = None,  # (B, Di, N) f32, the cotangent of h_final (None: zero)
):
    """Returns (dxc in xc's dtype, ddt, dB, dC, da, dh0), the rest f32: the
    gradient of ``mamba_scan(xc, dt, Bm, Cm, a, h0)`` against (dy, dh_final).
    dh0 is returned for h0 None too (the gradient of a zero state)."""
    _check_inputs(xc, dt, Bm, Cm, a, h0)
    B, L, Di = xc.shape
    N = a.shape[1]
    if dy.shape != (B, L, Di) or dy.dtype != torch.float32 or dy.device != xc.device:
        raise ValueError(f"dy {tuple(dy.shape)} {dy.dtype}: want {(B, L, Di)} float32 on {xc.device}")
    if dh_final is not None and (dh_final.shape != (B, Di, N) or dh_final.dtype != torch.float32
                                 or dh_final.device != xc.device):
        raise ValueError(f"dh_final {tuple(dh_final.shape)} {dh_final.dtype}: want {(B, Di, N)} float32")
    seg = segment_len(Di)
    if xc.device.type in PLAIN_DEVICES:
        with cost_scope(SCOPE):
            if L <= seg:
                return reference_selective_scan_bwd(xc, dt, Bm, Cm, a, h0, dy, dh_final)
            return _plain_bwd_segments(xc, dt, Bm, Cm, a, h0, dy, dh_final, seg)
    if xc.device.type != "cuda":
        raise ValueError(f"mamba_scan_bwd: unsupported device {xc.device}")
    ins = [None if t is None else t.contiguous() for t in (xc, dt, Bm, Cm, a, h0, dy, dh_final)]
    dev = xc.device
    f32 = dict(dtype=torch.float32, device=dev)
    design = _bwd_design()
    ckpt, part_bc, part_a = (torch.empty(shape, **f32)
                             for shape in bwd_scratch_shapes(B, L, Di, N, seg, design).values())
    dxc = torch.empty((B, L, Di), dtype=xc.dtype, device=dev)
    ddt = torch.empty((B, L, Di), **f32)
    dB, dC = torch.empty((B, L, N), **f32), torch.empty((B, L, N), **f32)
    da, dh0 = torch.empty((Di, N), **f32), torch.empty((B, Di, N), **f32)
    ptr = lambda t: 0 if t is None else t.data_ptr()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = _bwd_fn(design)(
            *(ptr(t) for t in ins), ckpt.data_ptr(), part_bc.data_ptr(), part_a.data_ptr(),
            dxc.data_ptr(), ddt.data_ptr(), dB.data_ptr(), dC.data_ptr(), da.data_ptr(), dh0.data_ptr(),
            _DTYPES[xc.dtype], B, L, Di, N, seg, stream,
        )
    if rc != 0:
        raise RuntimeError(f"mamba_scan_bwd kernel launch failed on design {design!r}: cudaError_t {rc}")
    mamba_scan_bwd.launches += 1
    mamba_scan_bwd.route_launches[design] += 1
    return dxc, ddt, dB, dC, da, dh0


mamba_scan_bwd.launches = 0
mamba_scan_bwd.route_launches = dict.fromkeys(BWD_DESIGNS, 0)

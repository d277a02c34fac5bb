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

``moe_gmm_bwd`` (K7a, no Pallas counterpart: the JAX train step
differentiates the einsums of ``repro/models/moe.py``) returns dX, dWg, dWu
and dWd from x, the weights and dY, by ``csrc/moe_gmm.cu``'s ``moe_gmm_bwd``.
``_bwd_route`` picks ``"wgmma"`` for bf16 with D and F multiples of 8: five
passes on the forward's warp-specialised, persistent GEMM (``wgmma``
m64n256k16 fed by TMA, each operand read in its stored layout, the
transposed ones through the instruction's transpose bits): dH = dY Wd^T into
f32 scratch; g and u recomputed, with dH, into h, dG and dU in x's dtype
(scratch allocated here); then dWd = h^T dY, dX = [dG dU] [Wg Wu]^T over 2F,
and dWg, dWu = x^T [dG dU]. Else ``"fma"`` (every f32 call, to keep the
reference's f32 parity). Weight gradients sum over C inside one block in a
fixed order (no float atomics), so a repeated call is bit-equal. ``"mma"``
(``mma.sync`` m16n8k16 on 64 x 64 tiles, four passes, the first design) is
no longer chosen: it stays reachable only as the baseline ``chip_smoke.py``
times beside ``"wgmma"``.

For tensors on the CPU or the meta device each wrapper computes its plain
version (``ref.reference_gmm``, ``ref.reference_gmm_bwd``, inside
``models.common.cost_scope(SCOPE)``, the roofline's region); for CUDA tensors
it launches the chosen route or raises, never another route.
``moe_gmm.launches`` counts calls that launched the kernel (one per call),
``moe_gmm.route_launches`` the same calls by route; ``moe_gmm_bwd.launches``
and ``route_launches`` likewise count its calls (one call of the C entry, four
or five kernels). The bare ``moe_gmm`` refuses inputs that require a gradient: a
gradient goes through ``repro_torch.models.moe.MoeGmm``, which pairs it with
``moe_gmm_bwd``.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.models.common import cost_scope
from repro_torch.obs import spanned

from . import build
from .ref import PLAIN_DEVICES, reference_gmm, reference_gmm_bwd

SCOPE = "pallas_moe_gmm"  # the roofline's region of the kernel

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
ROUTES = {"fma": 0, "wgmma": 1, "swap_ab": 2}  # as the .cu's Route enum
BWD_ROUTES = {"fma": 0, "mma": 1, "wgmma": 2}  # as moe_gmm_bwd's route argument (the .cu's BwdRoute)


def _fn():
    lib = build.load("moe_gmm")
    fn = lib.moe_gmm_fwd
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 6 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return fn


def _bwd_fn():
    lib = build.load("moe_gmm")
    fn = lib.moe_gmm_bwd
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 13 + [ctypes.c_int] * 6 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return fn


def _route(dtype: torch.dtype, E: int, C: int, D: int, F: int) -> str:
    """The kernel design a CUDA call with these inputs takes (see the module note)."""
    if dtype != torch.bfloat16 or D % 8 or F % 8:
        return "fma"
    return "swap_ab" if C <= 8 else "wgmma"


def _bwd_route(dtype: torch.dtype, D: int, F: int) -> str:
    """The backward's design for a CUDA call with these inputs (``"mma"`` is
    never chosen; see the module note)."""
    return "wgmma" if dtype == torch.bfloat16 and D % 8 == 0 and F % 8 == 0 else "fma"


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


@spanned("kernel.moe_gmm")
def moe_gmm(
    x: torch.Tensor,  # (E, C, D) per-expert token bins
    w_gate: torch.Tensor,  # (E, D, F)
    w_up: torch.Tensor,  # (E, D, F)
    w_down: torch.Tensor,  # (E, F, D)
) -> torch.Tensor:
    """Returns (E, C, D) in x's dtype. Refuses inputs that require a gradient
    (outside ``torch.no_grad``/``inference_mode``): the kernel's output
    carries no graph, so a gradient goes through
    ``repro_torch.models.moe.MoeGmm``, which pairs this call with
    ``moe_gmm_bwd``."""
    _check_inputs(x, w_gate, w_up, w_down)
    if torch.is_grad_enabled() and any(t.requires_grad for t in (x, w_gate, w_up, w_down)):
        raise RuntimeError("moe_gmm drops the gradient: differentiate through repro_torch.models.moe.MoeGmm")
    if x.device.type in PLAIN_DEVICES:
        with cost_scope(SCOPE):
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


@spanned("kernel.moe_gmm_bwd")
def moe_gmm_bwd(
    x: torch.Tensor,  # (E, C, D)
    w_gate: torch.Tensor,  # (E, D, F)
    w_up: torch.Tensor,  # (E, D, F)
    w_down: torch.Tensor,  # (E, F, D)
    dy: torch.Tensor,  # (E, C, D) the cotangent of moe_gmm's output
):
    """Returns (dx, dwg, dwu, dwd) in the inputs' dtype: the gradient of
    ``moe_gmm(x, w_gate, w_up, w_down)`` against ``dy``."""
    _check_inputs(x, w_gate, w_up, w_down)
    if dy.shape != x.shape or dy.dtype != x.dtype or dy.device != x.device:
        raise ValueError(f"dy {tuple(dy.shape)} {dy.dtype} on {dy.device}: want x's {tuple(x.shape)} {x.dtype}")
    if x.device.type in PLAIN_DEVICES:
        with cost_scope(SCOPE):
            return reference_gmm_bwd(x, w_gate, w_up, w_down, dy)
    if x.device.type != "cuda":
        raise ValueError(f"moe_gmm_bwd: unsupported device {x.device}")
    # contiguous, and 16-byte aligned for the tensor-core routes' copies (TMA, cp.async)
    ins = [t if t.is_contiguous() and t.data_ptr() % 16 == 0 else t.clone(memory_format=torch.contiguous_format)
           for t in (x, w_gate, w_up, w_down, dy)]
    E, C, D = x.shape
    F = w_gate.shape[2]
    route = _bwd_route(x.dtype, D, F)
    h, dg, du = (torch.empty((E, C, F), dtype=x.dtype, device=x.device) for _ in range(3))
    # dH in f32 between the wgmma route's first two passes
    dh = torch.empty((E, C, F), dtype=torch.float32, device=x.device) if route == "wgmma" else None
    dx, dwg, dwu, dwd = (torch.empty_like(t) for t in (x, w_gate, w_up, w_down))
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        rc = _bwd_fn()(
            *(t.data_ptr() for t in ins), h.data_ptr(), dg.data_ptr(), du.data_ptr(),
            0 if dh is None else dh.data_ptr(), dx.data_ptr(), dwg.data_ptr(), dwu.data_ptr(), dwd.data_ptr(),
            _DTYPES[x.dtype], BWD_ROUTES[route], E, C, D, F, stream,
        )
    if rc != 0:
        raise RuntimeError(f"moe_gmm_bwd kernel launch failed on route {route!r}: cudaError_t {rc}")
    moe_gmm_bwd.launches += 1
    moe_gmm_bwd.route_launches[route] += 1
    return dx, dwg, dwu, dwd


moe_gmm_bwd.launches = 0
moe_gmm_bwd.route_launches = dict.fromkeys(BWD_ROUTES, 0)

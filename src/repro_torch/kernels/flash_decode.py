"""Flash decoding: single-token GQA attention against a KV cache, for Hopper.

Port of ``repro.kernels.flash_decode`` (Pallas). The kernel is hand-written
CUDA C++ in ``csrc/flash_decode.cu``: the written slots of each (batch x KV
head) are split into ``n_split`` contiguous chunks, one per block of a
thread-block cluster; each block keeps the ``gq`` query rows of that KV head
resident while its warps stream their slots' K/V once, each warp carrying its
own online-softmax state; the warps' states merge in the block, and the
cluster's blocks merge through distributed shared memory, each writing a
slice of the output, all in one launch. Masking is by position,
as in ``repro.models.attention._cached_attention``: slot ``s`` of batch row
``b`` is attended iff ``s < n_valid[b]``, ``k_pos[b, s] <= q_pos[b]`` and,
with a window, ``k_pos[b, s] > q_pos[b] - window``. The kernel reads no
slot at or past ``n_valid``.

For tensors on the CPU or the meta device the wrapper computes the plain version
(``ref.reference_decode``); for CUDA tensors it launches the kernel or raises.
``flash_decode.launches`` counts kernel launches.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from . import build
from .ref import PLAIN_DEVICES, reference_decode

HEAD_DIMS = (16, 32, 64, 128)
MAX_GQ = 8  # query heads per KV head held in registers
MAX_SPLIT = 8  # blocks per cluster: the portable cluster size of sm_90
MIN_SPLIT_SLOTS = 64  # no chunk of fewer cache slots than this: 8 a warp
WAVE_SHARE = 0.75  # of the card's resident blocks one launch may take
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def _fn():
    lib = build.load("flash_decode")
    fn = lib.flash_decode_fwd
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 7 + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return fn


@functools.lru_cache(maxsize=None)
def _resident(index: int, dtype: int, Dh: int, gq: int) -> int:
    """SMs of card ``index`` times the blocks of the kernel for (dtype, Dh,
    gq) that one SM holds."""
    fn = build.load("flash_decode").flash_decode_blocks_per_sm
    fn.argtypes = [ctypes.c_int] * 3 + [ctypes.POINTER(ctypes.c_int)]
    fn.restype = ctypes.c_int
    blocks = ctypes.c_int(0)
    with torch.cuda.device(index):
        rc = fn(dtype, Dh, gq, ctypes.byref(blocks))
    if rc != 0 or blocks.value < 1:
        raise RuntimeError(f"flash_decode occupancy query failed: cudaError_t {rc}, {blocks.value} blocks")
    return blocks.value * torch.cuda.get_device_properties(index).multi_processor_count


def pick_split(pairs: int, S: int, resident: int) -> int:
    """Blocks per (batch, KV head), for ``pairs`` (batch, KV head) pairs, an
    S-slot cache and a card that holds ``resident`` blocks at once: as many
    as keep the grid within ``WAVE_SHARE`` of one wave (on an H100 at
    jamba's decode shape 6 a pair, 192 blocks, ran faster than 8, 256, and
    each wave past the first cost more than it saved), with at least
    ``MIN_SPLIT_SLOTS`` slots a chunk, up to ``MAX_SPLIT``."""
    n = max(1, min(MAX_SPLIT, int(WAVE_SHARE * resident) // pairs))
    while n > 1 and S // n < MIN_SPLIT_SLOTS:
        n -= 1
    return n


def _check_inputs(q, k, v, k_pos, q_pos, n_valid, window: int):
    """Raise on anything the kernel does not take."""
    if q.dim() != 4 or q.shape[1] != 1 or k.dim() != 4 or k.shape != v.shape:
        raise ValueError(f"want q (B,1,H,Dh), k=v (B,S,KVH,Dh); got {q.shape} {k.shape} {v.shape}")
    B, _, H, Dh = q.shape
    S, KVH = k.shape[1], k.shape[2]
    if k.shape[0] != B or k.shape[3] != Dh or H % KVH or S == 0:
        raise ValueError(f"shape mismatch: q {tuple(q.shape)} k {tuple(k.shape)}")
    if H // KVH > MAX_GQ:
        raise ValueError(f"gq = {H // KVH} query heads per KV head > {MAX_GQ}")
    if k_pos.shape != (B, S) or q_pos.shape != (B,) or n_valid.shape != (B,):
        raise ValueError(f"want k_pos (B,S), q_pos (B,), n_valid (B,); got "
                         f"{tuple(k_pos.shape)} {tuple(q_pos.shape)} {tuple(n_valid.shape)}")
    if any(t.device != q.device for t in (k, v, k_pos, q_pos, n_valid)):
        raise ValueError("flash_decode: inputs on different devices")
    if not (q.dtype == k.dtype == v.dtype) or q.dtype not in _DTYPES:
        raise TypeError(f"dtypes {q.dtype} {k.dtype} {v.dtype}: want one of float32, bfloat16")
    if any(t.dtype != torch.int32 for t in (k_pos, q_pos, n_valid)):
        raise TypeError("k_pos, q_pos, n_valid must be int32")
    if Dh not in HEAD_DIMS:
        raise ValueError(f"head dim {Dh} not in {HEAD_DIMS}")
    if window < 0:
        raise ValueError(f"window {window} < 0")


def flash_decode(
    q: torch.Tensor,  # (B, 1, H, Dh) the new token's queries
    k: torch.Tensor,  # (B, S, KVH, Dh) cache keys
    v: torch.Tensor,  # (B, S, KVH, Dh) cache values
    k_pos: torch.Tensor,  # (B, S) int32 absolute position per slot
    q_pos: torch.Tensor,  # (B,) int32 current position
    n_valid: torch.Tensor,  # (B,) int32 number of written slots
    *,
    window: int = 0,
) -> torch.Tensor:
    """Returns (B, 1, H, Dh) in q's dtype. The blocks per batch row and KV
    head are ``split_for``'s choice for the card."""
    _check_inputs(q, k, v, k_pos, q_pos, n_valid, window)
    if q.device.type in PLAIN_DEVICES:
        return reference_decode(q, k, v, k_pos, q_pos, n_valid, window=window)
    if q.device.type != "cuda":
        raise ValueError(f"flash_decode: unsupported device {q.device}")
    if not all(t.is_contiguous() for t in (q, k, v, k_pos, q_pos, n_valid)):
        raise ValueError("flash_decode: inputs must be contiguous")
    if k.data_ptr() % 16 or v.data_ptr() % 16:
        raise ValueError("flash_decode: k and v must be 16-byte aligned (16-byte loads)")
    B, _, H, Dh = q.shape
    S, KVH = k.shape[1], k.shape[2]
    n_split = split_for(q, k)
    out = torch.empty_like(q)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = _fn()(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), k_pos.data_ptr(), q_pos.data_ptr(),
            n_valid.data_ptr(), out.data_ptr(),
            _DTYPES[q.dtype], B, S, H, KVH, Dh, int(window), Dh**-0.5, n_split, stream,
        )
    if rc != 0:
        raise RuntimeError(f"flash_decode kernel launch failed: cudaError_t {rc}")
    flash_decode.launches += 1
    return out


_splits: dict = {}  # (device, dtype, q's shape, k's shape) -> n_split


def split_for(q: torch.Tensor, k: torch.Tensor) -> int:
    """The ``n_split`` that ``flash_decode`` picks for these CUDA tensors:
    ``pick_split``'s choice, worked out once for each device, dtype and shape
    and then found by one dict lookup."""
    key = (q.device, q.dtype, q.shape, k.shape)
    n_split = _splits.get(key)
    if n_split is None:
        B, _, H, Dh = q.shape
        S, KVH = k.shape[1], k.shape[2]
        n_split = _splits[key] = pick_split(B * KVH, S, _resident(q.device.index, _DTYPES[q.dtype], Dh, H // KVH))
    return n_split


flash_decode.launches = 0

"""Blockwise tree-hash states of large payloads, for Hopper.

Port of ``repro.kernels.hash_tree`` (Pallas), the data plane's content-hash
kernel (see ``repro_torch.core.hashing`` for the digest contract). The kernel
is hand-written CUDA C++ in ``csrc/hash_tree.cu``: one launch folds up to
``max_payloads()`` whole payloads of any length, each viewed as
little-endian uint32 words in 128-word blocks with its partial last block
and 0..3-byte tail, into a (k, 3) state. A warp folds one block per 16-byte
load of each lane; each payload gets CTAs in proportion to its blocks, and
the last of its CTAs to finish (counted by a ticket that wraps back to 0)
reduces their partials and writes its 3 words. Nothing is zeroed or filled
before a launch. The Pallas kernel's sequential chunk grid has no
counterpart; ``blocks_per_chunk`` survives only in ``hash_tree_state``'s
length contract.

:func:`hash_tree_states` takes a list of 1-D uint8 tensors on one device and
returns their states as a (k, 3) int32 tensor of uint32 bits (torch's
``uint32`` has few operations): one launch for every ``max_payloads()``
payloads. A payload that is not contiguous or whose ``data_ptr()`` is not
16-byte aligned (an odd slice) is cloned to an aligned buffer first. Each
(device, stream) keeps one scratch and ticket buffer, made at its first
launch, so launches on two streams never share a ticket.
:func:`hash_tree_state` is the one-payload call over int32 words that the
Pallas kernel's signature gives.

For tensors on the CPU the wrappers compute the plain version
(``ref.reference_hash_tree_bytes``); for CUDA tensors they launch the kernel
or raise. ``hash_tree_states.launches`` counts kernel launches.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.core.hashing import TREE_BLOCK_WORDS
from repro_torch.obs import spanned

from . import build
from .ref import reference_hash_tree_bytes

CHUNK_BLOCKS = 64  # 128-word blocks per chunk of hash_tree_state's length contract (32 KiB)

_WORK: dict = {}  # (device index, stream) -> (scratch, tickets)
_SMS: dict = {}  # device index -> SM count
_LIB: list = []  # the loaded library and its payloads a launch, once built


def _lib():
    if not _LIB:
        lib = build.load("hash_tree")
        lib.hash_tree_batch.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p,
                                        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p]
        lib.hash_tree_batch.restype = ctypes.c_int
        lib.hash_tree_scratch_words.argtypes = [ctypes.c_int]
        lib.hash_tree_scratch_words.restype = ctypes.c_longlong
        lib.hash_tree_max_payloads.restype = ctypes.c_int
        _LIB[:] = [lib, lib.hash_tree_max_payloads()]
    return _LIB


def max_payloads() -> int:
    """Payloads one launch takes (the kernel's descriptor table)."""
    return _lib()[1]


def _workspace(lib, device: torch.device, stream: int):
    """(SM count, scratch, tickets) of this device and stream; the tickets are
    zeroed once here and left at zero by every launch."""
    sms = _SMS.get(device.index)
    if sms is None:
        sms = _SMS[device.index] = torch.cuda.get_device_properties(device).multi_processor_count
    work = _WORK.get((device.index, stream))
    if work is None:
        work = _WORK[(device.index, stream)] = (
            torch.empty(lib.hash_tree_scratch_words(sms), dtype=torch.int32, device=device),
            torch.zeros(lib.hash_tree_max_payloads(), dtype=torch.int32, device=device),
        )
    return sms, work


def _check(u8s) -> torch.device:
    if not u8s:
        raise ValueError("hash_tree_states wants at least one payload")
    for u8 in u8s:
        if not isinstance(u8, torch.Tensor) or u8.dim() != 1 or u8.dtype != torch.uint8:
            raise TypeError(f"hash_tree_states wants 1-D uint8 tensors, got "
                            f"{getattr(u8, 'dtype', type(u8))} {tuple(getattr(u8, 'shape', ()))}")
    device = u8s[0].device
    if any(u8.device != device for u8 in u8s):
        raise ValueError(f"hash_tree_states: payloads on different devices {sorted({str(u.device) for u in u8s})}")
    return device


@spanned("kernel.hash_tree")
def hash_tree_states(u8s: list) -> torch.Tensor:
    """Tree states ``(h1, h2, h3)`` of each 1-D uint8 tensor of ``u8s`` (all on
    one device), as a (k, 3) int32 tensor of uint32 bits on that device."""
    device = _check(u8s)
    if device.type == "cpu":
        return torch.stack([reference_hash_tree_bytes(u8) for u8 in u8s])
    if device.type != "cuda":
        raise ValueError(f"hash_tree_states: unsupported device {device}")
    lib, cap = _lib()
    # a view that is not contiguous, or an odd slice, is cloned: fresh blocks are aligned
    u8s = [u8 if u8.is_contiguous() and u8.data_ptr() % 16 == 0 else u8.clone(memory_format=torch.contiguous_format)
           for u8 in u8s]
    ptrs, sizes = [u8.data_ptr() for u8 in u8s], [u8.numel() for u8 in u8s]
    out = torch.empty((len(u8s), 3), dtype=torch.int32, device=device)
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        sms, (scratch, tickets) = _workspace(lib, device, stream)
        for i in range(0, len(u8s), cap):
            n = min(cap, len(u8s) - i)
            rc = lib.hash_tree_batch((ctypes.c_void_p * n)(*ptrs[i : i + n]),
                                     (ctypes.c_longlong * n)(*sizes[i : i + n]), n, out.data_ptr() + 12 * i,
                                     scratch.data_ptr(), tickets.data_ptr(), sms, stream)
            if rc != 0:
                raise RuntimeError(f"hash_tree kernel launch failed: cudaError_t {rc}")
            hash_tree_states.launches += 1
    return out


hash_tree_states.launches = 0


def hash_tree_state(words: torch.Tensor, blocks_per_chunk: int = CHUNK_BLOCKS) -> torch.Tensor:
    """Tree state ``(h1, h2, h3)`` of ``words`` (n,) int32 as a (3,) int32 tensor
    of uint32 bits, on the words' device: one payload of :func:`hash_tree_states`.
    ``n`` must be a non-zero multiple of ``TREE_BLOCK_WORDS * blocks_per_chunk``,
    the length contract of the Pallas kernel's chunk grid."""
    if words.dim() != 1 or words.dtype != torch.int32:
        raise TypeError(f"hash_tree_state wants 1-D int32 words, got {words.dtype} {tuple(words.shape)}")
    n = words.numel()
    chunk_words = TREE_BLOCK_WORDS * blocks_per_chunk
    if n == 0 or n % chunk_words:
        raise ValueError(
            f"hash_tree_state needs len(words) a non-zero multiple of {chunk_words}, got {n}"
        )
    return hash_tree_states([words.contiguous().view(torch.uint8)])[0]

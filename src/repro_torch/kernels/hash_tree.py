"""Blockwise tree-hash state of a large payload, for Hopper.

Port of ``repro.kernels.hash_tree`` (Pallas), the data plane's content-hash
kernel (see ``repro_torch.core.hashing`` for the digest contract). The kernel
is hand-written CUDA C++ in ``csrc/hash_tree.cu``: one warp folds one
128-word block per 16-byte load of each lane, keeps the state
``(sum m, xor m, sum s)`` in registers through a grid-stride loop, and each
CTA adds its partial to the 3-word output with atomics. The Pallas kernel's
sequential chunk grid has no counterpart; ``blocks_per_chunk`` survives only
in the length contract, which callers rely on to cut the chunk-aligned bulk
(``repro_torch.core.hashing`` finishes the ragged rest on the host).

Words are a 1-D ``torch.int32`` tensor holding uint32 bits (torch's
``uint32`` has few operations); the state comes back the same way, as a (3,)
int32 tensor. A view that is not contiguous or whose ``data_ptr()`` is not
16-byte aligned (an odd slice) is copied to an aligned buffer first.

For tensors on the CPU the wrapper computes the plain version
(``ref.reference_hash_tree``); for CUDA tensors it launches the kernel or
raises. ``hash_tree_state.launches`` counts kernel launches.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.core.hashing import TREE_BLOCK_WORDS

from . import build
from .ref import reference_hash_tree

CHUNK_BLOCKS = 64  # 128-word blocks per chunk of the length contract (32 KiB)


def _fn():
    fn = build.load("hash_tree").hash_tree_fwd
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p, ctypes.c_longlong, ctypes.c_void_p, ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return fn


def hash_tree_state(words: torch.Tensor, blocks_per_chunk: int = CHUNK_BLOCKS) -> torch.Tensor:
    """Tree state ``(h1, h2, h3)`` of ``words`` (n,) as a (3,) int32 tensor of
    uint32 bits, on the words' device. ``n`` must be a non-zero multiple of
    ``TREE_BLOCK_WORDS * blocks_per_chunk``."""
    if words.dim() != 1 or words.dtype != torch.int32:
        raise TypeError(f"hash_tree_state wants 1-D int32 words, got {words.dtype} {tuple(words.shape)}")
    n = words.numel()
    chunk_words = TREE_BLOCK_WORDS * blocks_per_chunk
    if n == 0 or n % chunk_words:
        raise ValueError(
            f"hash_tree_state needs len(words) a non-zero multiple of {chunk_words}, got {n}"
        )
    if words.device.type == "cpu":
        return reference_hash_tree(words)
    if words.device.type != "cuda":
        raise ValueError(f"hash_tree_state: unsupported device {words.device}")
    if not words.is_contiguous() or words.data_ptr() % 16:
        words = words.clone(memory_format=torch.contiguous_format)  # fresh blocks are aligned
    with torch.cuda.device(words.device):
        out = torch.zeros(3, dtype=torch.int32, device=words.device)  # on the launch's stream
        stream = torch.cuda.current_stream(words.device).cuda_stream
        rc = _fn()(words.data_ptr(), n, out.data_ptr(), stream)
    if rc != 0:
        raise RuntimeError(f"hash_tree kernel launch failed: cudaError_t {rc}")
    hash_tree_state.launches += 1
    return out


hash_tree_state.launches = 0

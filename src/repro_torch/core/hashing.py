"""Batched content hashing — the data plane's digests, for numpy arrays and
torch tensors.

Port of ``repro.core.hashing``. Every cache key, travel document and store
ingest starts from a content hash, and the digests agree bit for bit with the
JAX package's, so AV hashes, memo keys and visitor logs match across the two.

- :func:`content_hash_batch` hashes a whole wave's payloads in one fused
  call: small arrays are copied into **one** shared host buffer and hashed as
  slices of a single memoryview; large (> 4 MiB) arrays get the
  **full-coverage** blockwise tree digest.
- :func:`content_hash` is a thin single-payload wrapper.

Digest contract (identical to the JAX package's):

=====================  ==========================================
tier                   digest
=====================  ==========================================
ghost (aval only)      ``sha256("ghost:{shape}:{dtype}")``
array  <= 4 MiB        ``sha256(bytes + shape + dtype)``
array  >  4 MiB        blockwise tree digest, full coverage
pure-JSON container    ``sha256(json.dumps(sort_keys=True))``
scalar (str/int/...)   ``sha256(repr(payload))``
arbitrary object       ``sha256("pickle:" + pickle.dumps)``
=====================  ==========================================

Torch tensors are arrays here: a tensor hashes exactly like the numpy (or
JAX) array of the same bytes, shape and dtype. Its bytes are those of
``t.contiguous().reshape(-1).view(torch.uint8)`` (a non-contiguous view hashes
like its contiguous copy, as ``np.ascontiguousarray`` makes it), its shape is
written ``str(tuple(t.shape))`` and its dtype by the numpy-style name
(``"float32"``, ``"bfloat16"`` as ml_dtypes prints JAX's bf16, ``"bool"``),
never ``torch.Size([..])`` or ``"torch.float32"``. Where the bytes live decides
where they are hashed:

- host arrays and CPU tensors go through numpy (:func:`tree_state_np` for the
  tree tier), zero-copy;
- small CUDA tensors are copied to the host once per wave — one ``torch.cat``
  and one copy per device — and hashed with sha256 there;
- large CUDA tensors stay on their card: one launch of the hand-written
  ``hash_tree`` kernel (``repro_torch.kernels.hash_tree``) folds every large
  tensor of the wave on a device, whole, its partial last block and 0..3-byte
  tail included, and only the 12-byte states cross to the host, in one copy
  per wave and device, to be finished through sha256 there.

``KOALJA_HASH_BACKEND`` stays validated (a typo raises) but chooses nothing:
the payload's device does. There is no fallback: a kernel that fails to build
or launch raises out of :func:`content_hash_batch`. ``backend_fallbacks`` and
:func:`bind_fallback_anomalies` are kept for API parity and stay idle.

Tree digest definition (the > 4 MiB tier)
-----------------------------------------
The payload bytes are viewed as little-endian uint32 words (a 0..3-byte
tail is packed LE into one extra word). Words are grouped into blocks of
``TREE_BLOCK_WORDS`` = 128; per block ``j``::

    s_j = sum(words in block j)            (uint32, wraparound)
    c_j = (j * 0x9E3779B1 + 0x85EBCA77) | 1
    m_j = (s_j ^ c_j) * c_j                (uint32, wraparound)

and the state is ``(h1, h2, h3) = (sum m_j, xor m_j, sum s_j)``; the final
digest is ``sha256(state || nbytes || shape || dtype || "tree")[:16]``.
"""

from __future__ import annotations

import hashlib
import json
import os
import pickle
import struct
from typing import Any, Callable, List, Optional, Sequence

import numpy as np
import torch

__all__ = [
    "content_hash",
    "content_hash_batch",
    "tree_state_np",
    "tree_digest",
    "hashing_stats",
    "bind_fallback_anomalies",
    "is_ghost",
    "LARGE_ARRAY_BYTES",
    "TREE_BLOCK_WORDS",
]

# Arrays at or below this many bytes keep the sha256(bytes) digest; above it
# the full-coverage tree digest.
LARGE_ARRAY_BYTES = 1 << 22  # 4 MiB

TREE_BLOCK_WORDS = 128  # words per level-0 block (512 bytes)
_TREE_GOLD = 0x9E3779B1  # golden-ratio odd constant (Fibonacci hashing)
_TREE_SALT = 0x85EBCA77  # murmur3 fmix constant

# Scalar types whose repr is canonical and address-free: these keep the
# repr digest. Everything else non-JSON goes through pickle.
_STABLE_REPR_TYPES = (str, bytes, bytearray, int, float, complex, bool, type(None))

_STATS = {
    "calls": 0,  # content_hash_batch invocations
    "payloads": 0,  # payloads hashed
    "fused_bytes": 0,  # bytes that went through the shared small-array buffer
    "tree_hashes": 0,  # large arrays hashed via the tree digest
    "pickle_hashes": 0,  # payloads hashed via the pickle tier
    "unstable_hashes": 0,  # repr fallbacks (pickle failed) — process-local!
    "backend_fallbacks": 0,  # API parity with the JAX package: the port never falls back
}

_HASH_BACKENDS = ("numpy", "jnp", "pallas")

# API parity: the JAX package routes backend-fallback notices here; the port
# has no fallback, so the sink is kept but never called.
_FALLBACK_SINK: Optional[Callable[[str], None]] = None


def bind_fallback_anomalies(sink: Optional[Callable[[str], None]]) -> None:
    """Kept for parity with ``repro.core.hashing``: binds the anomaly sink for
    hash-backend fallbacks. The port has no fallback (a failing kernel
    raises), so nothing is ever sent to it. Pass None to unbind."""
    global _FALLBACK_SINK
    _FALLBACK_SINK = sink


def _hash_backend() -> str:
    """The validated ``KOALJA_HASH_BACKEND`` selection. Unknown values fail
    loudly; known ones choose nothing in the port (the payload's device
    does)."""
    backend = os.environ.get("KOALJA_HASH_BACKEND", "numpy")
    if backend not in _HASH_BACKENDS:
        raise ValueError(
            f"KOALJA_HASH_BACKEND={backend!r} is not a hash backend "
            f"(choose from: {', '.join(_HASH_BACKENDS)})"
        )
    return backend


def hashing_stats() -> dict:
    """Counters for the hashing hot path (observability, not determinism)."""
    return dict(_STATS)


def _stable_hash_bytes(data: bytes) -> str:
    return hashlib.sha256(data).hexdigest()[:16]


def is_ghost(payload: Any) -> bool:
    """True for abstract payloads (shape+dtype but no materialized bytes):
    ``ShapeDtypeStruct``-named types and anything else that *declares*
    ``nbytes = None``. Ghosts are pure metadata — the circuit routes them
    without ever touching the store.

    The check is deliberately narrow: a payload must opt in. A meta tensor
    reports a real ``nbytes``, so it is not a ghost here (the port's ghost
    type comes with ``wireframe``)."""
    if type(payload).__name__ == "ShapeDtypeStruct":
        return True
    return (
        hasattr(payload, "shape")
        and hasattr(payload, "dtype")
        and hasattr(payload, "nbytes")
        and payload.nbytes is None
    )


# ---------------------------------------------------------------------------
# tree digest (> 4 MiB arrays)
# ---------------------------------------------------------------------------


def tree_state_np(u8) -> tuple:
    """Reference tree state over a 1-D uint8 array (pure numpy, zero-copy:
    the bulk is viewed as uint32 in place, only the <4-byte tail is packed
    separately). The canonical definition the kernel must match bit for
    bit. Returns ``(h1, h2, h3)`` as Python ints."""
    u8 = np.ascontiguousarray(u8, dtype=np.uint8).reshape(-1)
    n4 = (u8.size // 4) * 4
    w = u8[:n4].view(np.uint32)
    tail_bytes = u8[n4:].tobytes()
    B = TREE_BLOCK_WORDS
    nb = w.size // B
    if nb:
        s = np.add.reduceat(w[: nb * B], np.arange(0, nb * B, B), dtype=np.uint32)
    else:
        s = np.empty(0, dtype=np.uint32)
    rem = w[nb * B :]
    if rem.size or tail_bytes:  # the partial last block, the tail packed LE
        s_tail = (int(rem.sum(dtype=np.uint32)) + int.from_bytes(tail_bytes, "little")) & 0xFFFFFFFF
        s = np.concatenate([s, np.asarray([s_tail], dtype=np.uint32)])
    j = np.arange(s.size, dtype=np.uint64).astype(np.uint32)
    c = (j * np.uint32(_TREE_GOLD) + np.uint32(_TREE_SALT)) | np.uint32(1)
    m = (s ^ c) * c
    h1 = int(m.sum(dtype=np.uint32))
    h2 = int(np.bitwise_xor.reduce(m)) if m.size else 0
    h3 = int(s.sum(dtype=np.uint32))
    return h1, h2, h3


def _tree_states_card(u8s: list) -> list:
    """Tree states of card-resident 1-D uint8 tensors (one device), in order:
    one ``hash_tree_states`` call folds every payload whole on the card, and
    one device-to-host copy brings back their 12-byte states."""
    from repro_torch.kernels.hash_tree import hash_tree_states

    host = hash_tree_states(u8s).cpu().numpy().view(np.uint32)
    return [tuple(int(x) for x in row) for row in host]


def _tree_finish(state, nbytes: int, shape: str, dtype: str) -> str:
    trailer = f":{nbytes}:{shape}:{dtype}:tree".encode()
    return _stable_hash_bytes(struct.pack("<3I", *state) + trailer)


def _dtype_name(dtype: torch.dtype) -> str:
    """numpy-style name of a torch dtype: ``torch.bfloat16`` -> ``"bfloat16"``."""
    return str(dtype).removeprefix("torch.")


def _tensor_bytes(t: torch.Tensor):
    """(flat uint8 bytes on the tensor's device, shape string, dtype string)."""
    flat = t.detach().resolve_conj().resolve_neg().contiguous().reshape(-1)
    u8 = flat.view(torch.uint8) if flat.numel() else flat.new_empty(0, dtype=torch.uint8)
    return u8, str(tuple(t.shape)), _dtype_name(t.dtype)


def tree_digest(arr) -> str:
    """Full-coverage digest of an array or tensor: tree state + (nbytes,
    shape, dtype) finalized through sha256. A CUDA tensor is hashed on its
    card by the ``hash_tree`` kernel."""
    if isinstance(arr, torch.Tensor):
        u8, shape, dtype = _tensor_bytes(arr)
        if u8.is_cuda:
            state = _tree_states_card([u8])[0]
        else:
            state = tree_state_np(u8.cpu().numpy())
        return _tree_finish(state, u8.numel(), shape, dtype)
    a = np.asarray(arr)
    if not a.flags["C_CONTIGUOUS"]:
        a = np.ascontiguousarray(a)
    u8 = a.reshape(-1).view(np.uint8) if a.size else np.empty(0, np.uint8)
    return _tree_finish(tree_state_np(u8), u8.size, str(a.shape), str(a.dtype))


# ---------------------------------------------------------------------------
# tiered per-payload hashing
# ---------------------------------------------------------------------------


def _json_canonical(payload) -> Optional[bytes]:
    """Strict canonical JSON bytes for pure-JSON containers (no ``default``
    hook — anything non-JSON falls through to the pickle tier rather than
    being repr-embedded with a memory address)."""
    try:
        return json.dumps(payload, sort_keys=True).encode()
    except (TypeError, ValueError):
        return None


def _pickle_digest(payload, on_unstable: Optional[Callable[[str], None]]) -> str:
    try:
        if isinstance(payload, (set, frozenset)):
            # Set iteration order is hash-salted per process; canonicalize
            # by sorting when the elements allow it.
            try:
                blob = pickle.dumps(("sorted-set", sorted(payload)), protocol=4)
            except TypeError:
                blob = pickle.dumps(payload, protocol=4)
        else:
            blob = pickle.dumps(payload, protocol=4)
        _STATS["pickle_hashes"] += 1
        return _stable_hash_bytes(b"pickle:" + blob)
    except Exception:
        _STATS["unstable_hashes"] += 1
        if on_unstable is not None:
            try:
                on_unstable(
                    f"unstable_hash: payload of type "
                    f"{type(payload).__name__} is not picklable; repr digest "
                    f"is process-local"
                )
            except Exception:
                pass
        return _stable_hash_bytes(repr(payload).encode())


class _Deferred:
    """A payload whose digest waits for the batch's fused pass: its flat
    uint8 bytes (a numpy array, or a uint8 tensor on a card), shape and dtype
    strings, and its slot in the output list."""

    __slots__ = ("u8", "shape", "dtype", "index")

    def __init__(self, u8, shape: str, dtype: str, index: int):
        self.u8 = u8
        self.shape = shape
        self.dtype = dtype
        self.index = index


def _classify_tensor(t: torch.Tensor, out: list, small: list, large: list, on_unstable) -> None:
    if t.layout is not torch.strided:  # sparse/quantized: no flat bytes to view
        out.append(_pickle_digest(t, on_unstable))
        return
    if t.is_meta:
        raise TypeError(
            "a meta tensor has no bytes to hash; the port's ghost type comes "
            "with wireframe (ROADMAP queue 1 item 2c)"
        )
    u8, shape, dtype = _tensor_bytes(t)
    if not u8.is_cuda:
        u8 = u8.cpu().numpy()
    out.append(None)
    entry = _Deferred(u8, shape, dtype, len(out) - 1)
    if t.nbytes <= LARGE_ARRAY_BYTES:
        small.append(entry)
        return
    _STATS["tree_hashes"] += 1
    if isinstance(u8, np.ndarray):
        out[-1] = _tree_finish(tree_state_np(u8), u8.size, shape, dtype)
    else:
        large.append(entry)


def _classify(payload: Any, out: list, small: list, large: list, on_unstable) -> None:
    """Hash one payload, or defer it into ``small`` / ``large`` for the fused
    passes. Appends the digest (or a placeholder) to ``out``."""
    if isinstance(payload, torch.Tensor):
        _classify_tensor(payload, out, small, large, on_unstable)
        return
    try:  # numpy-like arrays
        if hasattr(payload, "shape") and hasattr(payload, "dtype"):
            if not hasattr(payload, "nbytes") or payload.nbytes is None:
                # ShapeDtypeStruct / abstract value: hash the aval.
                out.append(
                    _stable_hash_bytes(
                        f"ghost:{payload.shape}:{payload.dtype}".encode()
                    )
                )
                return
            arr = np.asarray(payload)
            if arr.dtype.hasobject:
                # Object arrays serialize as pointers under tobytes():
                # pickle instead.
                out.append(_pickle_digest(payload, on_unstable))
                return
            if payload.nbytes <= LARGE_ARRAY_BYTES:  # <= 4 MiB: real bytes
                if not arr.flags["C_CONTIGUOUS"]:
                    arr = np.ascontiguousarray(arr)
                u8 = (
                    arr.reshape(-1).view(np.uint8)
                    if arr.size
                    else np.empty(0, np.uint8)
                )
                out.append(None)
                small.append(_Deferred(u8, str(arr.shape), str(arr.dtype), len(out) - 1))
                return
            # Large arrays: full-coverage tree digest.
            _STATS["tree_hashes"] += 1
            out.append(tree_digest(arr))
            return
    except Exception:
        pass
    if isinstance(payload, (dict, list, tuple)):
        blob = _json_canonical(payload)
        if blob is not None:
            out.append(_stable_hash_bytes(blob))
            return
        out.append(_pickle_digest(payload, on_unstable))
        return
    if isinstance(payload, _STABLE_REPR_TYPES):
        out.append(_stable_hash_bytes(repr(payload).encode()))
        return
    out.append(_pickle_digest(payload, on_unstable))


def _by_device(entries: List[_Deferred]) -> dict:
    groups: dict = {}
    for e in entries:
        groups.setdefault(e.u8.device, []).append(e)
    return groups


def _fuse_small(small: List[_Deferred], out: list) -> None:
    """One shared host buffer for all small arrays of the batch, digests
    ``sha256(bytes + shape + dtype)``. Host bytes are copied in; the card
    tensors of each device are concatenated there and land in the buffer
    with one device-to-host copy."""
    host = [s for s in small if isinstance(s.u8, np.ndarray)]
    card = _by_device([s for s in small if not isinstance(s.u8, np.ndarray)])
    order = host + [s for group in card.values() for s in group]
    total = sum(s.u8.nbytes for s in order)  # uint8: bytes = elements, numpy or torch
    buf = np.empty(total, dtype=np.uint8)
    off = 0
    for s in host:
        buf[off : off + s.u8.size] = s.u8
        off += s.u8.size
    for group in card.values():
        n = sum(s.u8.numel() for s in group)
        if n:
            torch.from_numpy(buf[off : off + n]).copy_(torch.cat([s.u8 for s in group]))
        off += n
    mv = memoryview(buf)
    _STATS["fused_bytes"] += total
    off = 0
    for s in order:
        n = s.u8.nbytes
        h = hashlib.sha256(mv[off : off + n])
        h.update(s.shape.encode())
        h.update(s.dtype.encode())
        out[s.index] = h.hexdigest()[:16]
        off += n


def _fuse_large_card(large: List[_Deferred], out: list) -> None:
    """Tree digests of the batch's large card tensors: per device, one
    ``hash_tree`` launch (for up to 128 of them) and one device-to-host
    copy of their states."""
    for group in _by_device(large).values():
        for s, state in zip(group, _tree_states_card([s.u8 for s in group])):
            out[s.index] = _tree_finish(state, s.u8.numel(), s.shape, s.dtype)


def content_hash_batch(
    payloads: Sequence[Any],
    *,
    on_unstable: Optional[Callable[[str], None]] = None,
) -> List[str]:
    """Content hashes for a whole wave of payloads in one fused call.

    Semantics are identical to mapping :func:`content_hash` over the
    payloads; the batch form pays the per-payload dispatch, buffer
    allocations and device-to-host copies once per wave instead of once per
    AV. ``on_unstable`` is invoked with a note for every payload that fell
    back to a process-local repr digest (see
    :meth:`repro_torch.core.store.ArtifactStore.bind_provenance`).
    """
    payloads = list(payloads)
    _hash_backend()  # fail loudly on a typo'd KOALJA_HASH_BACKEND up front
    _STATS["calls"] += 1
    _STATS["payloads"] += len(payloads)
    out: list = []
    small: List[_Deferred] = []
    large: List[_Deferred] = []
    for payload in payloads:
        _classify(payload, out, small, large, on_unstable)
    if small:
        _fuse_small(small, out)
    if large:
        _fuse_large_card(large, out)
    return out


def content_hash(payload: Any, *, on_unstable=None) -> str:
    """Content hash of a payload for cache keys and travel documents.

    Thin single-payload wrapper over :func:`content_hash_batch` — see the
    module docstring for the tier table and the tensor contract.
    """
    return content_hash_batch((payload,), on_unstable=on_unstable)[0]

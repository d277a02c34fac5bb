"""Content-hash parity of the port (``repro_torch.core.hashing``) with the JAX
package (``repro.core.hashing``), on the CPU.

Tolerance is bit-equality everywhere: the tree state is integer arithmetic
mod 2**32, and a digest either matches or does not.

- The plain version of the ``hash_tree`` kernel (``ref.reference_hash_tree``)
  against the Pallas kernel in interpret mode, the JAX package's jnp oracle
  and numpy ``tree_state_np``, on the sizes of ``tests/test_hashing.py``.
- The plain version of the redesigned kernel's whole-payload entry
  (``ref.reference_hash_tree_bytes``: ragged bytes, tail included) against
  numpy ``tree_state_np`` over ragged lengths, and on the chunk-aligned bulk
  against the Pallas kernel; ``hash_tree_states`` and the card tier's
  ``_tree_states_card`` on CPU tensors against the JAX package's digests.
- ``content_hash_batch`` over the payload zoo of ``tests/test_hashing.py``
  plus bf16, bool, 0-d, empty, non-contiguous and > 4 MiB ragged arrays, each
  array given to the port both as numpy and as a CPU tensor of the same
  bytes: every digest equals the JAX package's.
"""

import dataclasses

import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.core import hashing as jax_hashing
from repro.kernels import ref as jax_ref
from repro.kernels.hash_tree import hash_tree_state as pallas_hash_tree
from repro_torch.core import hashing
from repro_torch.kernels import ops, ref
from repro_torch.kernels.hash_tree import CHUNK_BLOCKS, hash_tree_state, hash_tree_states

LARGE = hashing.LARGE_ARRAY_BYTES
CHUNK_WORDS = hashing.TREE_BLOCK_WORDS * CHUNK_BLOCKS


@dataclasses.dataclass
class Reading:
    sensor: str
    values: tuple
    ok: bool = True


def _u32(state) -> tuple:
    return tuple(int(x) & 0xFFFFFFFF for x in state)


def _words(n_words: int, seed: int) -> np.ndarray:
    return np.random.RandomState(seed).randint(0, 2**32, size=n_words, dtype=np.uint64).astype(np.uint32)


def _as_tensor(a) -> torch.Tensor:
    """A CPU tensor viewing the same bytes with the same shape, strides and
    dtype (bf16 through its bits)."""
    a = np.asarray(a)
    if a.dtype == ml_dtypes.bfloat16:
        return torch.from_numpy(a.view(np.uint16)).view(torch.bfloat16)
    return torch.from_numpy(a)


# ---------------------------------------------------------------------------
# the kernel's plain version
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("n_words", [hashing.TREE_BLOCK_WORDS, 8192, 3 * 8192])
def test_plain_hash_tree_matches_references(n_words):
    w = _words(n_words, seed=2)
    got = _u32(ref.reference_hash_tree(torch.from_numpy(w.view(np.int32))))
    assert got == _u32(np.asarray(jax_ref.reference_hash_tree(w)))
    assert got == jax_hashing.tree_state_np(w.view(np.uint8))
    assert got == hashing.tree_state_np(w.view(np.uint8))
    if n_words % CHUNK_WORDS == 0:
        assert got == _u32(np.asarray(pallas_hash_tree(w, interpret=True)))
        assert got == _u32(hash_tree_state(torch.from_numpy(w.view(np.int32))))


@pytest.mark.parametrize("case", ["randn_1300001_f64", "u8_4MiB_plus_13"])
def test_plain_hash_tree_on_ragged_bulk_matches_pallas(case):
    """The chunk-aligned bulk of the ragged payloads of ``test_hashing.py``
    (the part the kernel takes) through the plain version and through the
    Pallas kernel in interpret mode."""
    rng = np.random.RandomState(3)
    if case == "randn_1300001_f64":
        a = rng.randn(1_300_001)
    else:
        a = rng.randint(0, 255, size=LARGE + 13, dtype=np.uint8)
    u8 = a.reshape(-1).view(np.uint8)
    n_words = (u8.size // 4 // CHUNK_WORDS) * CHUNK_WORDS
    w = u8[: n_words * 4].view(np.uint32)
    got = _u32(hash_tree_state(torch.from_numpy(w.view(np.int32).copy())))
    assert got == _u32(np.asarray(pallas_hash_tree(w, interpret=True)))
    assert got == jax_hashing.tree_state_np(w.view(np.uint8))


def test_plain_hash_tree_wraps_block_index_like_numpy():
    """Blocks past 2**32 / 0x9E3779B1 make j*c overflow 32 bits: the plain
    version's split product must wrap exactly as numpy's uint32 does."""
    w = _words(64 * 8192, seed=5)  # 4096 blocks
    got = _u32(ref.reference_hash_tree(torch.from_numpy(w.view(np.int32))))
    assert got == jax_hashing.tree_state_np(w.view(np.uint8))


def test_wrapper_rejects_bad_length_and_dtype():
    with pytest.raises(ValueError, match="multiple of 8192"):
        hash_tree_state(torch.zeros(8192 + 128, dtype=torch.int32))
    with pytest.raises(ValueError, match="multiple of 8192"):
        hash_tree_state(torch.zeros(0, dtype=torch.int32))
    with pytest.raises(TypeError, match="int32"):
        hash_tree_state(torch.zeros(8192, dtype=torch.int64))
    with pytest.raises(TypeError, match="1-D"):
        hash_tree_state(torch.zeros(2, 8192, dtype=torch.int32))
    with pytest.raises(ValueError, match="multiple of 4096"):
        hash_tree_state(torch.zeros(8192 + 128, dtype=torch.int32), blocks_per_chunk=32)


@pytest.mark.parametrize("nbytes", [0, 1, 3, 4, 511, 512, 513, 8192 * 4 + 13, LARGE + 13])
def test_plain_hash_tree_bytes_matches_references(nbytes):
    """A whole payload of any length, its partial last block and tail included,
    through the plain version of ``hash_tree_states``: equal to the JAX
    package's numpy ``tree_state_np``; its chunk-aligned bulk (the Pallas
    kernel's contract) equal to the Pallas kernel in interpret mode."""
    u8 = np.random.RandomState(nbytes % 1000).randint(0, 256, size=nbytes, dtype=np.uint64).astype(np.uint8)
    got = _u32(ref.reference_hash_tree_bytes(torch.from_numpy(u8)))
    assert got == jax_hashing.tree_state_np(u8) == hashing.tree_state_np(u8)
    bulk = (nbytes // 4 // CHUNK_WORDS) * CHUNK_WORDS
    if bulk:
        w = u8[: 4 * bulk].view(np.uint32)
        assert _u32(ref.reference_hash_tree_bytes(torch.from_numpy(u8[: 4 * bulk]))) == _u32(
            np.asarray(pallas_hash_tree(w, interpret=True)))


def _ragged_payloads():
    """CPU uint8 tensors of mixed lengths: tails of 1-3 bytes, a partial last
    block, one shorter than a block, an empty one, and an odd-offset slice."""
    rng = np.random.RandomState(9)
    lengths = [LARGE + 13, 8192 * 4 + 2, 512 * 3 + 100, 300, 0, LARGE // 2 + 511]
    out = [torch.from_numpy(rng.randint(0, 256, size=n, dtype=np.uint64).astype(np.uint8)) for n in lengths]
    odd = torch.from_numpy(rng.randint(0, 256, size=LARGE + 64, dtype=np.uint64).astype(np.uint8))[3:]
    return out + [odd]


def test_hash_tree_states_of_cpu_tensors_equal_the_plain_states():
    u8s = _ragged_payloads()
    got = hash_tree_states(u8s)
    assert got.shape == (len(u8s), 3) and got.dtype == torch.int32
    for row, u8 in zip(got, u8s):
        assert _u32(row) == _u32(ref.reference_hash_tree_bytes(u8)) == jax_hashing.tree_state_np(u8.numpy())


def test_tree_states_card_gives_the_jax_package_digests():
    """The card tier's path (``_tree_states_card``, then the sha256 finish) on
    CPU tensors, for a mixed wave of large payloads of several dtypes and
    ragged lengths: each digest equals the JAX package's for the numpy copy."""
    rng = np.random.RandomState(10)
    wave = [
        rng.randn(LARGE // 4 + 1).astype(np.float32),
        rng.randint(0, 255, size=LARGE + 13, dtype=np.uint8),
        rng.randn(LARGE // 2 + 9).astype(ml_dtypes.bfloat16),  # 2-byte tail
        rng.randint(-5, 5, size=(LARGE // 16 + 1, 4)).astype(np.int32),
        rng.randn(LARGE + 3) > 0,  # bool: 1 byte an element, 3-byte tail
        rng.randint(0, 255, size=LARGE + 64, dtype=np.uint8)[3:],  # odd offset
    ]
    want = jax_hashing.content_hash_batch([_jax_view(a) for a in wave])
    parts = [hashing._tensor_bytes(_as_tensor(a)) for a in wave]
    states = hashing._tree_states_card([u8 for u8, _, _ in parts])
    got = [hashing._tree_finish(st, u8.numel(), shape, dtype) for st, (u8, shape, dtype) in zip(states, parts)]
    assert got == want


def test_hash_tree_states_rejects_mixed_devices_and_non_uint8():
    u8 = torch.zeros(600, dtype=torch.uint8)
    with pytest.raises(ValueError, match="different devices"):
        hash_tree_states([u8, torch.zeros(600, dtype=torch.uint8, device="meta")])
    with pytest.raises(TypeError, match="uint8"):
        hash_tree_states([u8, torch.zeros(150, dtype=torch.int32)])
    with pytest.raises(TypeError, match="1-D"):
        hash_tree_states([u8.view(2, 300)])
    with pytest.raises(ValueError, match="at least one"):
        hash_tree_states([])


def test_cpu_tensors_launch_no_kernel():
    ops.reset_launch_counts()
    before = hashing.hashing_stats()["tree_hashes"]
    big = torch.arange(LARGE // 4 + 3, dtype=torch.int32)
    hashing.content_hash_batch([big, big[1:], torch.ones(5)])
    hash_tree_state(torch.zeros(8192, dtype=torch.int32))
    assert hashing.hashing_stats()["tree_hashes"] == before + 2
    assert ops.launch_counts()["hash_tree"] == 0


# ---------------------------------------------------------------------------
# content_hash_batch: the payload zoo through both packages
# ---------------------------------------------------------------------------


def _zoo():
    """The payload zoo of ``tests/test_hashing.py``, then the arrays the
    torch contract singles out."""
    rng = np.random.RandomState(0)
    return [
        rng.randn(64).astype(np.float32),
        np.asfortranarray(rng.randn(8, 8)),
        np.arange(100)[::3],  # non-contiguous
        np.float64(3.25),  # 0-d
        np.array([], dtype=np.int32),
        {"a": 1, "b": [1.5, "x", None, True]},
        [1, 2, {"k": "v"}],
        (4, 5),
        "plain string",
        b"raw bytes",
        12345,
        2.5,
        None,
        True,
        Reading("s0", (1.0, 2.0)),  # dataclass -> pickle tier
        {3, 1, 2},  # set -> canonicalized pickle tier
        # the torch contract's cases
        rng.randn(5, 7).astype(ml_dtypes.bfloat16),
        rng.randn(3, 3) > 0,  # bool
        np.array(7, dtype=np.int32),  # 0-d int
        np.zeros((0, 4), dtype=np.float32),  # empty, 2-D
        rng.randint(-5, 5, size=(6, 4)).astype(np.int32).T,  # non-contiguous (transposed)
        rng.randn(1_300_001),  # > 4 MiB, ragged
        rng.randint(0, 255, size=LARGE + 13, dtype=np.uint8),  # > 4 MiB, 1-byte tail
        rng.randn(LARGE // 2 + 9).astype(ml_dtypes.bfloat16),  # > 4 MiB bf16, 2-byte tail
    ]


def _jax_view(p):
    """What a JAX user hands the reference: bf16 arrays as JAX arrays."""
    if isinstance(p, np.ndarray) and p.dtype == ml_dtypes.bfloat16:
        return jnp.asarray(p)
    return p


def test_zoo_digests_equal_as_numpy_and_as_tensors():
    zoo = _zoo()
    want = jax_hashing.content_hash_batch([_jax_view(p) for p in zoo])
    assert hashing.content_hash_batch(zoo) == want
    as_tensors = [_as_tensor(p) if isinstance(p, (np.ndarray, np.generic)) else p for p in zoo]
    assert sum(isinstance(p, torch.Tensor) for p in as_tensors) == 13
    assert hashing.content_hash_batch(as_tensors) == want
    # one payload at a time: the batch boundary changes nothing
    assert [hashing.content_hash(p) for p in as_tensors] == want


def test_tensor_views_hash_like_their_contiguous_copies():
    rng = np.random.RandomState(4)
    base = torch.from_numpy(rng.randn(6, 10).astype(np.float32))
    views = [base.T, base[:, ::3], base[1:, 2:], base.reshape(-1)[1:]]  # the last: misaligned start
    for v in views:
        assert not v.is_contiguous() or v.data_ptr() % 16
        assert hashing.content_hash(v) == jax_hashing.content_hash(np.ascontiguousarray(v.numpy()))
    big = torch.from_numpy(rng.randint(0, 255, size=LARGE + 64, dtype=np.uint8))[3:]
    assert hashing.content_hash(big) == jax_hashing.content_hash(big.numpy().copy())


def test_tree_digest_of_tensor_matches_reference():
    rng = np.random.RandomState(6)
    a = rng.randn(1000, 7)  # tree digest of a small array, as tree_digest allows
    assert hashing.tree_digest(torch.from_numpy(a)) == jax_hashing.tree_digest(a)
    assert hashing.tree_digest(a) == jax_hashing.tree_digest(a)


def test_tensor_trailer_uses_numpy_dtype_names():
    for t, name in ((torch.zeros(2), "float32"), (torch.zeros(2, dtype=torch.bfloat16), "bfloat16"),
                    (torch.zeros(2, dtype=torch.bool), "bool"), (torch.zeros(2, dtype=torch.int32), "int32")):
        assert hashing._tensor_bytes(t)[1:] == ("(2,)", name)


def test_meta_tensor_is_not_a_ghost_and_raises():
    meta = torch.empty(4, 4, device="meta")
    assert not hashing.is_ghost(meta)
    with pytest.raises(TypeError, match="wireframe"):
        hashing.content_hash(meta)


def test_typo_hash_backend_raises(monkeypatch):
    monkeypatch.setenv("KOALJA_HASH_BACKEND", "palas")
    with pytest.raises(ValueError, match="KOALJA_HASH_BACKEND"):
        hashing.content_hash_batch([torch.arange(8)])


@pytest.mark.parametrize("backend", ["numpy", "jnp", "pallas"])
def test_hash_backend_chooses_nothing(backend, monkeypatch):
    """A valid backend name changes no digest and falls back on nothing."""
    a = np.random.RandomState(7).randn(LARGE // 8 + 5)
    want = jax_hashing.tree_digest(a)
    monkeypatch.setenv("KOALJA_HASH_BACKEND", backend)
    before = hashing.hashing_stats()["backend_fallbacks"]
    assert hashing.content_hash(torch.from_numpy(a)) == want
    assert hashing.hashing_stats()["backend_fallbacks"] == before

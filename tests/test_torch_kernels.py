"""The port's attention kernels against the JAX package's Pallas kernels.

On the CPU each port wrapper computes its kernel's plain version
(``repro_torch.kernels.ref``); the JAX side runs the Pallas kernels in
interpret mode, as ``tests/test_kernels.py`` and ``tests/test_flash_decode.py``
do, and their jnp oracles. The same numpy inputs, made from a seed, go to
both. The CUDA kernels themselves are held against the same plain versions
on the card by ``chip_smoke.py``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jax_ref
from repro.kernels.flash_attention import flash_attention as pallas_attention
from repro.kernels.flash_decode import flash_decode as pallas_decode
from repro_torch.kernels import ops
from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.kernels.flash_decode import flash_decode

# f32: both sides accumulate in f32, in different orders (online vs full
# softmax, XLA vs ATen sums) -- the reference kernel tests' 2e-5.
# bf16: inputs are identical bf16 values, outputs are rounded to bf16 (8 bits
# of mantissa) -- the reference tests' 2e-2.
TOL = {torch.float32: dict(rtol=2e-5, atol=2e-5), torch.bfloat16: dict(rtol=2e-2, atol=2e-2)}
JNP = {torch.float32: jnp.float32, torch.bfloat16: jnp.bfloat16}

# the cases of tests/test_kernels.py::test_flash_attention_sweep
ATTN_CASES = [
    (2, 128, 128, 4, 2, 64, True, 0, 64, 64),
    (1, 256, 256, 8, 8, 32, True, 0, 128, 64),
    (2, 200, 200, 4, 1, 64, True, 0, 64, 64),  # ragged lengths
    (1, 256, 256, 4, 2, 64, True, 96, 64, 64),  # sliding window
    (1, 64, 256, 4, 2, 64, False, 0, 64, 64),  # cross attention
    (1, 128, 128, 6, 2, 16, True, 0, 32, 32),  # small head dim
]

# the cases of tests/test_flash_decode.py::test_flash_decode_sweep
DECODE_CASES = [
    (2, 256, 8, 2, 64, 0, 64, 200, 199),
    (1, 300, 4, 4, 32, 0, 128, 300, 299),  # ragged S, MHA
    (2, 128, 4, 1, 64, 48, 32, 100, 99),  # SWA window
    (1, 64, 8, 2, 64, 0, 32, 10, 9),  # mostly-empty cache
]


def _both(x: np.ndarray, dtype: torch.dtype):
    """The same values as a torch tensor and a jax array of ``dtype``."""
    return torch.from_numpy(x).to(dtype), jnp.asarray(x).astype(JNP[dtype])


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x.astype(jnp.float32))


@pytest.mark.parametrize("B,Lq,Lk,H,KVH,Dh,causal,window,bq,bkv", ATTN_CASES)
def test_flash_attention_matches_pallas(B, Lq, Lk, H, KVH, Dh, causal, window, bq, bkv):
    rng = np.random.RandomState(0)
    (qt, qj), (kt, kj), (vt, vj) = (
        _both(rng.randn(B, L, n, Dh).astype(np.float32), torch.float32)
        for L, n in ((Lq, H), (Lk, KVH), (Lk, KVH))
    )
    out = flash_attention(qt, kt, vt, causal=causal, window=window)
    assert out.shape == qt.shape and out.dtype == qt.dtype
    pallas = pallas_attention(qj, kj, vj, causal=causal, window=window, block_q=bq, block_kv=bkv)
    oracle = jax_ref.reference_attention(qj, kj, vj, causal=causal, window=window)
    np.testing.assert_allclose(_np(out), _np(pallas), **TOL[torch.float32])
    np.testing.assert_allclose(_np(out), _np(oracle), **TOL[torch.float32])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_attention_dtypes(dtype):
    rng = np.random.RandomState(1)
    B, L, H, KVH, Dh = 1, 128, 4, 2, 64
    (qt, qj), (kt, kj), (vt, vj) = (
        _both(rng.randn(B, L, n, Dh).astype(np.float32), dtype) for n in (H, KVH, KVH)
    )
    out = flash_attention(qt, kt, vt, causal=True)
    assert out.dtype == dtype
    pallas = pallas_attention(qj, kj, vj, causal=True)
    np.testing.assert_allclose(_np(out), _np(pallas), **TOL[dtype])


@pytest.mark.parametrize("B,S,H,KVH,Dh,window,bkv,nv,qp", DECODE_CASES)
def test_flash_decode_matches_pallas(B, S, H, KVH, Dh, window, bkv, nv, qp):
    rng = np.random.RandomState(2)
    (qt, qj), (kt, kj), (vt, vj) = (
        _both(rng.randn(B, L, n, Dh).astype(np.float32), torch.float32)
        for L, n in ((1, H), (S, KVH), (S, KVH))
    )
    kpos = np.broadcast_to(np.arange(S, dtype=np.int32)[None], (B, S)).copy()
    qpos = np.full((B,), qp, np.int32)
    nval = np.full((B,), nv, np.int32)
    out = flash_decode(qt, kt, vt, *map(torch.from_numpy, (kpos, qpos, nval)), window=window)
    args = (qj, kj, vj, jnp.asarray(kpos), jnp.asarray(qpos), jnp.asarray(nval))
    pallas = pallas_decode(*args, window=window, block_kv=bkv)
    oracle = jax_ref.reference_decode(*args, window=window)
    np.testing.assert_allclose(_np(out), _np(pallas), **TOL[torch.float32])
    np.testing.assert_allclose(_np(out), _np(oracle), **TOL[torch.float32])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_decode_ring_positions(dtype):
    """SWA ring buffer: slot order is rotated, positions are explicit."""
    rng = np.random.RandomState(3)
    B, S, H, KVH, Dh, W = 1, 64, 4, 2, 32, 64
    (qt, qj), (kt, kj), (vt, vj) = (
        _both(rng.randn(B, L, n, Dh).astype(np.float32), dtype)
        for L, n in ((1, H), (S, KVH), (S, KVH))
    )
    # a ring at absolute time 100: slot i holds position (100 - W + 1 + i), rotated by 13
    kpos = np.roll(np.arange(S, dtype=np.int32) + (100 - W + 1), 13)[None]
    qpos = np.asarray([100], np.int32)
    nval = np.asarray([S], np.int32)
    out = flash_decode(qt, kt, vt, *map(torch.from_numpy, (kpos, qpos, nval)), window=W)
    args = (qj, kj, vj, jnp.asarray(kpos), jnp.asarray(qpos), jnp.asarray(nval))
    pallas = pallas_decode(*args, window=W, block_kv=16)
    np.testing.assert_allclose(_np(out), _np(pallas), **TOL[dtype])
    np.testing.assert_allclose(_np(out), _np(jax_ref.reference_decode(*args, window=W)), **TOL[dtype])


def test_cpu_path_launches_no_kernel():
    ops.reset_launch_counts()
    q = torch.randn(1, 16, 2, 16)
    flash_attention(q, q, q)
    flash_decode(q[:, :1], q, q, torch.zeros(1, 16, dtype=torch.int32),
                 torch.zeros(1, dtype=torch.int32), torch.ones(1, dtype=torch.int32))
    assert ops.launch_counts() == {"flash_attention": 0, "flash_decode": 0}


@pytest.mark.parametrize(
    "q_shape,kv_shape,dtype",
    [
        ((1, 8, 4, 48), (1, 8, 2, 48), torch.float32),  # head dim the kernel lacks
        ((1, 8, 4, 16), (1, 8, 2, 16), torch.float16),  # dtype the kernel lacks
        ((1, 8, 3, 16), (1, 8, 2, 16), torch.float32),  # H not a multiple of KVH
        ((1, 8, 4, 16), (2, 8, 2, 16), torch.float32),  # batch mismatch
    ],
)
def test_wrappers_reject_what_the_kernels_do_not_take(q_shape, kv_shape, dtype):
    q, kv = torch.zeros(q_shape, dtype=dtype), torch.zeros(kv_shape, dtype=dtype)
    with pytest.raises((ValueError, TypeError)):
        flash_attention(q, kv, kv)
    i32 = dict(dtype=torch.int32)
    with pytest.raises((ValueError, TypeError)):
        flash_decode(q[:, :1], kv, kv, torch.zeros(kv_shape[:2], **i32),
                     torch.zeros(q_shape[:1], **i32), torch.zeros(q_shape[:1], **i32))

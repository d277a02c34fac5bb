"""The port's kernels against the JAX package's Pallas kernels.

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
from repro.kernels.mamba_scan import mamba_scan as pallas_scan
from repro.kernels.moe_gmm import moe_gmm as pallas_gmm
from repro.models.mamba import selective_scan as jax_chunked_scan
from repro_torch.kernels import ops
from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.kernels.flash_decode import flash_decode
from repro_torch.kernels.hash_tree import hash_tree_state
from repro_torch.kernels.mamba_scan import mamba_scan
from repro_torch.kernels.moe_gmm import moe_gmm

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

# the cases of tests/test_kernels.py::test_moe_gmm_sweep: (E, C, D, F, block_c, block_f)
GMM_CASES = [
    (4, 32, 64, 96, 16, 32),
    (2, 100, 48, 80, 32, 32),  # ragged capacity
    (8, 16, 32, 32, 16, 16),
    (1, 64, 128, 64, 64, 64),
]
# the reference tests' tolerances for these kernels: f32 sums of up to F
# products in other orders (gmm), and exp/FMA rounding compounded over L steps (scan)
GMM_TOL = dict(rtol=2e-4, atol=2e-4)
SCAN_TOL = dict(rtol=1e-4, atol=1e-4)

# the cases of tests/test_kernels.py::test_mamba_scan_sweep: (B, L, Di, N, chunk, d_block, h0)
SCAN_CASES = [
    (2, 64, 32, 8, 16, 16, False),
    (1, 100, 48, 16, 32, 32, True),  # ragged L + seeded state
    (2, 256, 64, 16, 64, 64, False),
    (1, 32, 24, 4, 32, 8, True),  # d-blocked
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


def _gmm_inputs(rng, E, C, D, F):
    return (rng.randn(E, C, D).astype(np.float32) * 0.5, rng.randn(E, D, F).astype(np.float32) * 0.1,
            rng.randn(E, D, F).astype(np.float32) * 0.1, rng.randn(E, F, D).astype(np.float32) * 0.1)


@pytest.mark.parametrize("E,C,D,F,bc,bf", GMM_CASES)
def test_moe_gmm_matches_pallas(E, C, D, F, bc, bf):
    rng = np.random.RandomState(4)
    arrays = _gmm_inputs(rng, E, C, D, F)
    arrays[0][:, C // 2 :] = 0  # empty capacity rows give zeros
    out = moe_gmm(*(torch.from_numpy(a) for a in arrays))
    assert out.shape == (E, C, D) and out.dtype == torch.float32
    assert not out[:, C // 2 :].any()
    js = [jnp.asarray(a) for a in arrays]
    np.testing.assert_allclose(_np(out), _np(pallas_gmm(*js, block_c=bc, block_f=bf)), **GMM_TOL)
    np.testing.assert_allclose(_np(out), _np(jax_ref.reference_gmm(*js)), **GMM_TOL)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_moe_gmm_dtypes(dtype):
    rng = np.random.RandomState(5)
    both = [_both(a, dtype) for a in _gmm_inputs(rng, 2, 32, 32, 48)]
    out = moe_gmm(*(t for t, _ in both))
    assert out.dtype == dtype
    pallas = pallas_gmm(*(j for _, j in both), block_c=16, block_f=16)
    np.testing.assert_allclose(_np(out), _np(pallas), **(GMM_TOL if dtype == torch.float32 else TOL[dtype]))


def _scan_inputs(rng, B, L, Di, N, with_h0):
    return dict(
        xc=rng.randn(B, L, Di).astype(np.float32),
        dt=(np.abs(rng.randn(B, L, Di)) * 0.1).astype(np.float32),
        Bm=rng.randn(B, L, N).astype(np.float32),
        Cm=rng.randn(B, L, N).astype(np.float32),
        a=(-np.abs(rng.randn(Di, N)) - 0.1).astype(np.float32),
        h0=rng.randn(B, Di, N).astype(np.float32) if with_h0 else None,
    )


@pytest.mark.parametrize("B,L,Di,N,Lc,db,with_h0", SCAN_CASES)
def test_mamba_scan_matches_pallas(B, L, Di, N, Lc, db, with_h0):
    ins = _scan_inputs(np.random.RandomState(6), B, L, Di, N, with_h0)
    y, h = mamba_scan(**{k: None if v is None else torch.from_numpy(v) for k, v in ins.items()},
                      chunk_len=Lc)
    assert y.shape == (B, L, Di) and h.shape == (B, Di, N) and y.dtype == h.dtype == torch.float32
    js = {k: None if v is None else jnp.asarray(v) for k, v in ins.items()}
    yp, hp = pallas_scan(js["xc"], js["dt"], js["Bm"], js["Cm"], js["a"], js["h0"], chunk_len=Lc, d_block=db)
    yr, hr = jax_ref.reference_selective_scan(js["xc"], js["dt"], js["Bm"], js["Cm"], js["a"], js["h0"])
    for got, want in ((y, yp), (h, hp), (y, yr), (h, hr)):
        np.testing.assert_allclose(_np(got), _np(want), **SCAN_TOL)


def test_mamba_scan_matches_model_chunked_scan():
    """The plain scan against the JAX model's chunked associative scan."""
    ins = _scan_inputs(np.random.RandomState(7), 2, 128, 32, 8, True)
    y, h = mamba_scan(**{k: torch.from_numpy(v) for k, v in ins.items()}, chunk_len=32)
    js = {k: jnp.asarray(v) for k, v in ins.items()}
    yj, hj = jax_chunked_scan(js["xc"], js["dt"], js["Bm"], js["Cm"], js["a"], js["h0"], chunk_len=32)
    np.testing.assert_allclose(_np(y), _np(yj), **SCAN_TOL)
    np.testing.assert_allclose(_np(h), _np(hj), **SCAN_TOL)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_mamba_scan_bf16_activations(dtype):
    """xc may be bf16 (the serving dtype); everything else stays f32."""
    ins = _scan_inputs(np.random.RandomState(8), 1, 40, 16, 16, True)
    tin = {k: torch.from_numpy(v) for k, v in ins.items()}
    tin["xc"] = tin["xc"].to(dtype)
    y, h = mamba_scan(**tin)
    js = {k: jnp.asarray(v) for k, v in ins.items()}
    js["xc"] = js["xc"].astype(JNP[dtype])
    yp, hp = pallas_scan(js["xc"], js["dt"], js["Bm"], js["Cm"], js["a"], js["h0"], chunk_len=16, d_block=16)
    np.testing.assert_allclose(_np(y), _np(yp), **SCAN_TOL)
    np.testing.assert_allclose(_np(h), _np(hp), **SCAN_TOL)


def test_cpu_path_launches_no_kernel():
    ops.reset_launch_counts()
    q = torch.randn(1, 16, 2, 16)
    flash_attention(q, q, q)
    flash_decode(q[:, :1], q, q, torch.zeros(1, 16, dtype=torch.int32),
                 torch.zeros(1, dtype=torch.int32), torch.ones(1, dtype=torch.int32))
    w = torch.randn(2, 8, 8)
    moe_gmm(torch.randn(2, 3, 8), w, w, w)
    x = torch.randn(1, 5, 8)
    mamba_scan(x, x.abs(), torch.randn(1, 5, 4), torch.randn(1, 5, 4), -torch.rand(8, 4))
    hash_tree_state(torch.zeros(8192, dtype=torch.int32))
    assert ops.launch_counts() == {"flash_attention": 0, "flash_decode": 0, "moe_gmm": 0, "mamba_scan": 0,
                                   "hash_tree": 0}


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


@pytest.mark.parametrize(
    "shapes,dtype",
    [
        (((2, 3, 8), (2, 8, 6), (2, 8, 6), (2, 6, 8)), torch.float16),  # dtype the kernel lacks
        (((2, 3, 8), (2, 8, 6), (2, 8, 5), (2, 6, 8)), torch.float32),  # w_up unlike w_gate
        (((2, 3, 8), (3, 8, 6), (3, 8, 6), (3, 6, 8)), torch.float32),  # expert count mismatch
        (((2, 3, 8), (2, 8, 6), (2, 8, 6), (2, 8, 6)), torch.float32),  # w_down not (E, F, D)
        (((2, 0, 8), (2, 8, 6), (2, 8, 6), (2, 6, 8)), torch.float32),  # empty bins axis
    ],
)
def test_moe_gmm_rejects_what_the_kernel_does_not_take(shapes, dtype):
    with pytest.raises((ValueError, TypeError)):
        moe_gmm(*(torch.zeros(s, dtype=dtype) for s in shapes))


@pytest.mark.parametrize(
    "N,xc_dtype,dt_dtype,h0_shape",
    [
        (6, torch.float32, torch.float32, None),  # state size not a divisor of the warp
        (64, torch.float32, torch.float32, None),  # state size wider than the warp
        (8, torch.float16, torch.float32, None),  # activation dtype the kernel lacks
        (8, torch.float32, torch.bfloat16, None),  # dt must stay f32
        (8, torch.float32, torch.float32, (1, 8, 8)),  # h0 of another channel count
    ],
)
def test_mamba_scan_rejects_what_the_kernel_does_not_take(N, xc_dtype, dt_dtype, h0_shape):
    B, L, Di = 1, 5, 16
    xc = torch.zeros(B, L, Di, dtype=xc_dtype)
    dt = torch.zeros(B, L, Di, dtype=dt_dtype)
    bc = torch.zeros(B, L, N)
    h0 = None if h0_shape is None else torch.zeros(h0_shape)
    with pytest.raises((ValueError, TypeError)):
        mamba_scan(xc, dt, bc, bc, torch.zeros(Di, N), h0)

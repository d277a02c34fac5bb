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
from repro_torch.configs import get_config
from repro_torch.kernels import ops, ref
from repro_torch.kernels.flash_attention import BWD_ROUTES, _bwd_route, flash_attention, flash_attention_bwd
import repro_torch.kernels.flash_decode as fd_module
from repro_torch.kernels.flash_decode import flash_decode, pick_split
from repro_torch.kernels.hash_tree import hash_tree_state
import repro_torch.kernels.mamba_scan as scan_module
from repro_torch.kernels.mamba_scan import _check_inputs as _check_scan_inputs
from repro_torch.kernels.mamba_scan import mamba_scan, mamba_scan_bwd
from repro_torch.kernels.moe_gmm import _bwd_route as gmm_bwd_route
from repro_torch.kernels.moe_gmm import _route as gmm_route
from repro_torch.kernels.moe_gmm import moe_gmm, moe_gmm_bwd
from repro_torch.models.moe import expert_capacity

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


def _decode_inputs(rng, B, S, H, KVH, Dh, dtype=torch.float32):
    return [_both(rng.randn(B, L, n, Dh).astype(np.float32), dtype) for L, n in ((1, H), (S, KVH), (S, KVH))]


@pytest.mark.parametrize("n_split", [1, 2, 3, 8])
@pytest.mark.parametrize("B,S,H,KVH,Dh,window,bkv,nv,qp", DECODE_CASES)
def test_split_decode_model_matches_pallas(B, S, H, KVH, Dh, window, bkv, nv, qp, n_split):
    """flash_decode's split and merge (ref.split_decode_reference) against the
    port's plain version and the Pallas kernel over the reference sweep."""
    (qt, qj), (kt, kj), (vt, vj) = _decode_inputs(np.random.RandomState(2), B, S, H, KVH, Dh)
    kpos = np.broadcast_to(np.arange(S, dtype=np.int32)[None], (B, S)).copy()
    qpos, nval = np.full((B,), qp, np.int32), np.full((B,), nv, np.int32)
    pos = [torch.from_numpy(a) for a in (kpos, qpos, nval)]
    out = ref.split_decode_reference(qt, kt, vt, *pos, window=window, n_split=n_split)
    args = (qj, kj, vj, jnp.asarray(kpos), jnp.asarray(qpos), jnp.asarray(nval))
    np.testing.assert_allclose(_np(out), _np(ref.reference_decode(qt, kt, vt, *pos, window=window)),
                               **TOL[torch.float32])
    np.testing.assert_allclose(_np(out), _np(pallas_decode(*args, window=window, block_kv=bkv)),
                               **TOL[torch.float32])


# (S, window, n_valid, q_pos, n_split): the hazards of the split. Where every
# slot is masked, the kernel and the reference both weigh the masked slots
# alike, the reference over all S slots and the kernel over the written ones,
# so those cases write every slot (n_valid = S).
SPLIT_EDGE_CASES = [
    (64, 0, 1, 0, 8),  # one written slot: seven chunks wholly past n_valid
    (64, 0, 5, 4, 8),  # n_valid < n_split: empty chunks beside one-slot chunks
    (64, 0, 6, 5, 3),  # n_valid < one chunk of the cache
    (100, 16, 100, 99, 8),  # the window masks the first six chunks whole
    (96, 0, 96, -1, 3),  # every slot masked by position: exp(0) weights everywhere
    (96, 40, 96, 200, 8),  # every slot masked by the window
    (77, 0, 77, 76, 8),  # S not a multiple of n_split
]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("S,window,nv,qp,n_split", SPLIT_EDGE_CASES)
def test_split_decode_model_edges(S, window, nv, qp, n_split, dtype):
    B, H, KVH, Dh = 2, 8, 2, 32
    (qt, qj), (kt, kj), (vt, vj) = _decode_inputs(np.random.RandomState(9), B, S, H, KVH, Dh, dtype)
    kpos = np.broadcast_to(np.arange(S, dtype=np.int32)[None], (B, S)).copy()
    qpos, nval = np.full((B,), qp, np.int32), np.full((B,), nv, np.int32)
    pos = [torch.from_numpy(a) for a in (kpos, qpos, nval)]
    out = ref.split_decode_reference(qt, kt, vt, *pos, window=window, n_split=n_split)
    assert out.dtype == dtype and bool(torch.isfinite(out.float()).all())
    args = (qj, kj, vj, jnp.asarray(kpos), jnp.asarray(qpos), jnp.asarray(nval))
    np.testing.assert_allclose(_np(out), _np(ref.reference_decode(qt, kt, vt, *pos, window=window)), **TOL[dtype])
    np.testing.assert_allclose(_np(out), _np(jax_ref.reference_decode(*args, window=window)), **TOL[dtype])
    np.testing.assert_allclose(_np(out), _np(pallas_decode(*args, window=window, block_kv=32)), **TOL[dtype])


@pytest.mark.parametrize("pairs,S,resident,want", [
    (4 * 32, 552, 2 * 132, 1),  # stablelm-1.6b decode, 2 blocks an SM: 128 blocks already
    (4 * 8, 552, 2 * 132, 6),  # jamba-v0.1-52b decode: 192 blocks within 3/4 of one wave
    (4 * 8, 552, 132, 3),  # the same where an SM holds one block (gq > 4)
    (8 * 40, 552, 2 * 132, 1),  # B * KVH >= 2 x 132 SMs
    (2, 100, 2 * 132, 1),  # too short to split
    (2, 300, 2 * 132, 4),  # chunks of at least 64 slots
    (1, 1 << 16, 2 * 132, 8),  # never past the portable cluster size
])
def test_flash_decode_split_choice(pairs, S, resident, want):
    """Blocks per (batch, KV head): as many as keep the grid within 3/4 of a
    wave of resident blocks, with chunks of 64 slots or more, up to 8."""
    assert pick_split(pairs, S, resident) == want


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_decode_split_is_worked_out_once_a_shape(monkeypatch, dtype):
    """``split_for`` asks for the card's resident blocks once for each device,
    dtype and shape, and then answers from its table."""
    asked = []

    def resident(index, dtype_code, Dh, gq):
        asked.append((dtype_code, Dh, gq))
        return 2 * 132

    monkeypatch.setattr(fd_module, "_resident", resident)
    monkeypatch.setattr(fd_module, "_splits", {})
    q, k = torch.zeros(4, 1, 32, 128, dtype=dtype), torch.zeros(4, 552, 8, 128, dtype=dtype)
    assert [fd_module.split_for(q, k) for _ in range(3)] == [pick_split(4 * 8, 552, 2 * 132)] * 3
    assert asked == [(fd_module._DTYPES[dtype], 128, 4)]
    q, k = torch.zeros(4, 1, 32, 64, dtype=dtype), torch.zeros(4, 552, 32, 64, dtype=dtype)
    assert fd_module.split_for(q, k) == pick_split(4 * 32, 552, 2 * 132)
    assert len(asked) == 2


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


def test_mamba_scan_rejects_what_its_offsets_cannot_reach():
    """The kernel indexes steps with 32-bit offsets t * Di, up to t = L + 16:
    one launch scans at most ``segment_len(Di)`` steps, a longer L is taken in
    segments (no longer refused), and a Di at which not one step fits raises."""
    meta = dict(device="meta")
    N = 16
    assert scan_module.segment_len(2048) == 2**20 - 17  # (2**20 - 17 + 16) * 2048 < 2**31
    for L, Di in ((2**20 - 17, 2048), (2**20 - 16, 2048), (2**20, 8192)):
        _check_scan_inputs(torch.empty(1, L, Di, **meta), torch.empty(1, L, Di, **meta),
                           torch.empty(1, L, N, **meta), torch.empty(1, L, N, **meta),
                           torch.empty(Di, N, **meta), None)
    Di = 2**27  # (1 + 16) * Di > 2**31
    with pytest.raises(ValueError, match="32-bit"):
        _check_scan_inputs(torch.empty(1, 1, Di, **meta), torch.empty(1, 1, Di, **meta),
                           torch.empty(1, 1, N, **meta), torch.empty(1, 1, N, **meta),
                           torch.empty(Di, N, **meta), None)


@pytest.mark.parametrize("with_h0", [False, True])
@pytest.mark.parametrize("xc_dtype", [torch.float32, torch.bfloat16])
def test_mamba_scan_segments_a_scan_past_the_offset_limit(monkeypatch, with_h0, xc_dtype):
    """With the limit patched small, an L that needs 3 launches is scanned in
    3 segments, each seeded with the last one's state: y and h bit-equal to
    the unsegmented plain scan."""
    B, L, Di, N = 2, 45, 24, 8
    monkeypatch.setattr(scan_module, "OFFSET_LIMIT", (20 + scan_module.MAX_AHEAD) * Di + 1)
    assert scan_module.segment_len(Di) == 20  # segments of 20, 20 and 5 steps
    ins = {k: None if v is None else torch.from_numpy(v)
           for k, v in _scan_inputs(np.random.RandomState(11), B, L, Di, N, with_h0).items()}
    ins["xc"] = ins["xc"].to(xc_dtype)
    y, h = mamba_scan(**ins)
    yr, hr = ref.reference_selective_scan(**ins)
    assert torch.equal(y, yr) and torch.equal(h, hr)
    y1, h1 = mamba_scan(**{k: v[:, :20] if k in ("xc", "dt", "Bm", "Cm") else v for k, v in ins.items()})
    assert torch.equal(y1, yr[:, :20]) and not torch.equal(h1, hr)  # the first segment alone stops short


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
    o, lse = flash_attention(q, q, q, return_lse=True)
    flash_attention_bwd(q, q, q, o, q, lse)
    moe_gmm_bwd(torch.randn(2, 3, 8), w, w, w, torch.randn(2, 3, 8))
    mamba_scan_bwd(x, x.abs(), torch.randn(1, 5, 4), torch.randn(1, 5, 4), -torch.rand(8, 4), None, x)
    assert ops.launch_counts() == {"flash_attention": 0, "flash_attention_bwd": 0, "flash_decode": 0,
                                   "moe_gmm": 0, "moe_gmm_bwd": 0, "mamba_scan": 0, "mamba_scan_bwd": 0,
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


# Route choice of moe_gmm at jamba-v0.1-52b's serving bins (batch 4, prompt
# 512), on both sides of the 8-row boundary between swap_ab and wgmma, and
# where D is not a multiple of 8 (no 16-byte rows): bf16 takes a tensor-core
# route where its strides allow one, f32 always takes "fma".
_JAMBA = get_config("jamba-v0.1-52b")
ROUTE_GMM_CASES = [  # (E, C, D, F, bf16 route)
    (_JAMBA.n_experts, expert_capacity(4 * 512, _JAMBA), _JAMBA.d_model, _JAMBA.d_ff, "wgmma"),  # prefill
    (_JAMBA.n_experts, expert_capacity(4, _JAMBA), _JAMBA.d_model, _JAMBA.d_ff, "swap_ab"),  # decode
    (3, 8, 200, 328, "swap_ab"),
    (3, 9, 200, 328, "wgmma"),
    (2, 9, 44, 36, "fma"),
]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("E,C,D,F,bf16_route", ROUTE_GMM_CASES)
def test_moe_gmm_route(E, C, D, F, bf16_route, dtype):
    assert gmm_route(dtype, E, C, D, F) == (bf16_route if dtype == torch.bfloat16 else "fma")


def test_route_counts_reset_with_the_launch_counts():
    moe_gmm.route_launches["wgmma"] = 3
    flash_attention.route_launches["mma"] = 2
    flash_attention_bwd.route_launches.update(fma=1, mma=2, wgmma=4)
    ops.reset_launch_counts()
    assert set(moe_gmm.route_launches) == {"fma", "wgmma", "swap_ab"}
    assert set(flash_attention.route_launches) == {"fma", "mma"}
    assert set(flash_attention_bwd.route_launches) == {"fma", "mma", "wgmma"}
    for fn in (moe_gmm, flash_attention, flash_attention_bwd):
        assert not any(fn.route_launches.values()), fn.__name__


# K1's route by dtype and head dims: wgmma for bf16 at Dh 64 and 128 (and
# MLA's (96, 64), below), mma for bf16 at Dh 16 and 32, fma for f32. The
# (Dh, gq) pairs include every dense config that trains: stablelm-1.6b (64,
# 1), qwen2.5-32b (128, 5) and internlm2-20b (128, 6).
_DENSE_TRAINING = ("stablelm-1.6b", "qwen2.5-32b", "internlm2-20b")
BWD_ROUTE_CASES = [  # (Dh, gq, bf16 route)
    (16, 8, "mma"),
    (32, 4, "mma"),
    (64, 1, "wgmma"),
    (64, 4, "wgmma"),
    (128, 5, "wgmma"),
    (128, 6, "wgmma"),
]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("Dh,gq,bf16_route", BWD_ROUTE_CASES)
def test_flash_attention_bwd_route(Dh, gq, bf16_route, dtype):
    route = _bwd_route(dtype, Dh, Dh)
    assert route == (bf16_route if dtype == torch.bfloat16 else "fma")
    assert route in BWD_ROUTES and route in flash_attention_bwd.route_launches


def test_dense_training_configs_are_in_the_route_cases():
    cases = {(Dh, gq) for Dh, gq, _ in BWD_ROUTE_CASES}
    for arch in _DENSE_TRAINING:
        cfg = get_config(arch)
        assert (cfg.head_dim, cfg.n_heads_eff // cfg.n_kv_heads) in cases, arch
        assert _bwd_route(torch.bfloat16, cfg.head_dim, cfg.head_dim) == "wgmma", arch


@pytest.mark.parametrize("arch", ["minicpm3-4b", "internvl2-1b", "seamless-m4t-medium", "mixtral-8x7b",
                                  "jamba-v0.1-52b"])
def test_attention_training_layouts_take_the_wgmma_backward(arch):
    """Every attention a training config runs has its bf16 backward on wgmma:
    MLA at (Dk 96, Dv 64), internvl2 at gq 7, seamless's encoder, decoder and
    cross-attention at Dh 64, the MoE and hybrid layouts; f32 on fma. The
    unequal pairs but MLA's are refused by the pair check, before a route."""
    cfg = get_config(arch)
    if cfg.attention == "mla":
        pair = (cfg.qk_nope_dim + cfg.qk_rope_dim, cfg.v_head_dim)
        assert pair == (96, 64)
    else:
        pair = (cfg.head_dim, cfg.head_dim)
    assert cfg.n_heads_eff // cfg.n_kv_heads <= 64
    assert _bwd_route(torch.bfloat16, *pair) == "wgmma"
    assert _bwd_route(torch.float32, *pair) == "fma"


# The ragged edges of the new tiles, as chip_smoke.py phase 2 holds the CUDA
# kernels there: the plain versions against the Pallas kernels (interpret mode).
EDGE_ATTN_CASES = [  # (B, Lq, Lk, H, KVH, Dh, causal, window, block_q, block_kv)
    (1, 200, 231, 40, 8, 128, True, 64, 64, 64),  # Lq, Lk not multiples of 64, gq 5, window
    (2, 96, 112, 16, 2, 16, True, 0, 32, 64),  # head dim 16, gq 8
    (1, 256, 256, 4, 2, 64, True, 16, 64, 64),  # window < tile: rows fully masked inside a live tile
]
EDGE_GMM_CASES = [  # (E, C, D, F, block_c, block_f)
    (3, 9, 200, 328, 16, 128),  # D, F not multiples of 64, a 9-row bin
    (2, 65, 200, 328, 64, 128),  # one row past a 64-row block
    (2, 9, 44, 36, 16, 32),  # D not a multiple of 8
]


@pytest.mark.parametrize("B,Lq,Lk,H,KVH,Dh,causal,window,bq,bkv", EDGE_ATTN_CASES)
def test_flash_attention_tile_edges_match_pallas(B, Lq, Lk, H, KVH, Dh, causal, window, bq, bkv):
    test_flash_attention_matches_pallas(B, Lq, Lk, H, KVH, Dh, causal, window, bq, bkv)


@pytest.mark.parametrize("E,C,D,F,bc,bf", EDGE_GMM_CASES)
def test_moe_gmm_tile_edges_match_pallas(E, C, D, F, bc, bf):
    test_moe_gmm_matches_pallas(E, C, D, F, bc, bf)


# ---------------------------------------------------------------------------
# K1: the flash_attention backward's plain version (the CUDA kernel is held
# against it on the card by chip_smoke.py phase 2)
# ---------------------------------------------------------------------------

import jax  # noqa: E402

from repro.models import common as jax_common  # noqa: E402
from repro.models.attention import blocked_attention  # noqa: E402
from repro_torch.models import common as torch_common  # noqa: E402
from repro_torch.models.attention import FlashAttention  # noqa: E402

BWD_CASES = [  # (B, Lq, Lk, H, KVH, Dk, Dv, causal, window): lengths not multiples of 16
    pytest.param(2, 37, 37, 4, 4, 16, 16, True, 0, id="2-37-4-4-16-0"),  # MHA
    pytest.param(1, 45, 45, 4, 2, 64, 64, True, 0, id="1-45-4-2-64-0"),  # gq 2
    pytest.param(2, 29, 29, 8, 2, 16, 16, True, 9, id="2-29-8-2-16-9"),  # gq 4, a window
    pytest.param(1, 50, 50, 4, 1, 64, 64, True, 20, id="1-50-4-1-64-20"),  # gq 4, a window
    # MLA's (Dk 96, Dv 64), a small unequal pair, and non-causal Lq != Lk (an
    # encoder's self-attention, cross-attention over a longer memory)
    pytest.param(2, 37, 37, 4, 2, 96, 64, True, 0, id="mla-96-64"),
    pytest.param(1, 23, 23, 4, 4, 24, 8, True, 5, id="dk24-dv8-window"),
    pytest.param(2, 21, 45, 4, 2, 16, 16, False, 0, id="noncausal-lq21-lk45"),
    pytest.param(1, 45, 19, 4, 4, 96, 64, False, 0, id="noncausal-lq45-lk19-mla"),
]
# dq, dk, dv against jax.grad of the jnp blocked_attention. f32: full vs
# blocked online softmax and XLA vs ATen sum orders. bf16: the reference
# rounds q.k, p and each product's output to bf16 where the plain version
# keeps f32 (one bf16 ulp, 2^-8, of the largest gradient, and a little more
# for sums of a few dozen such terms).
BWD_TOL = {torch.float32: 2e-5, torch.bfloat16: 3e-2}  # max |diff| over the largest |grad|


def _bwd_inputs(B, L, H, KVH, Dh, dtype, seed=0, Lk=None, Dv=None):
    """q (B, L, H, Dh), k (B, Lk, KVH, Dh), v (B, Lk, KVH, Dv) and do (B, L,
    H, Dv); Lk = L and Dv = Dh unless given."""
    Lk, Dv = Lk or L, Dv or Dh
    rng = np.random.RandomState(seed)
    q, do = rng.randn(B, L, H, Dh).astype(np.float32), rng.randn(B, L, H, Dv).astype(np.float32)
    k, v = rng.randn(B, Lk, KVH, Dh).astype(np.float32), rng.randn(B, Lk, KVH, Dv).astype(np.float32)
    return [torch.from_numpy(a).to(dtype) for a in (q, k, v, do)]


def _rel_err(got, want):
    want = want.float()
    return ((got.float() - want).abs().max() / want.abs().max()).item()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,Lq,Lk,H,KVH,Dk,Dv,causal,window", BWD_CASES)
def test_reference_attention_bwd_matches_jax_grad(B, Lq, Lk, H, KVH, Dk, Dv, causal, window, dtype):
    q, k, v, do = _bwd_inputs(B, Lq, H, KVH, Dk, dtype, Lk=Lk, Dv=Dv)
    mask = dict(causal=causal, window=window)
    o, lse = ref.reference_attention(q, k, v, **mask, return_lse=True)
    got = ref.reference_attention_bwd(q, k, v, o, do, lse, **mask)
    assert [g.dtype for g in got] == [dtype] * 3 and lse.dtype == torch.float32
    assert [g.shape for g in got] == [q.shape, k.shape, v.shape]

    def j(t):
        return jnp.asarray(t.float().numpy()).astype(JNP[dtype])

    def f(q_, k_, v_):
        return blocked_attention(q_, k_, v_, **mask, block_q=16, block_kv=16)

    _, vjp = jax.vjp(f, j(q), j(k), j(v))
    want = vjp(j(do))
    for name, g, w in zip("qkv", got, want):
        assert _rel_err(g, torch.from_numpy(np.array(w, dtype=np.float32))) <= BWD_TOL[dtype], f"d{name}"

    # autograd through the plain forward: the same function, differentiated by torch
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    ref.reference_attention(*leaves, **mask).backward(do)
    for name, g, leaf in zip("qkv", got, leaves):
        assert _rel_err(g, leaf.grad) <= BWD_TOL[dtype], f"d{name} vs autograd"


@pytest.mark.parametrize("window", [0, 7])
def test_reference_lse_is_the_rows_logsumexp(window):
    q, k, v, _ = _bwd_inputs(2, 33, 4, 2, 16, torch.float32, seed=1)
    o, lse = flash_attention(q, k, v, window=window, return_lse=True)  # the CPU path: the plain version
    torch.testing.assert_close(o, ref.reference_attention(q, k, v, window=window), rtol=0, atol=0)
    qg = q.reshape(2, 33, 2, 2, 16)
    s = torch.einsum("bqhgd,bkhd->bhgqk", qg, k) * 16**-0.5
    ok = ref._attention_mask(33, 33, True, window, "cpu")
    want = torch.logsumexp(s.masked_fill(~ok, float("-inf")), dim=-1).reshape(2, 4, 33)
    torch.testing.assert_close(lse, want, rtol=1e-6, atol=1e-6)


GRADCHECK_CASES = [  # (Lq, Lk, Dk, Dv, causal, window)
    pytest.param((9, 9, 16, 16, True, 0), id="0"),
    pytest.param((9, 9, 16, 16, True, 5), id="5"),
    pytest.param((7, 11, 24, 8, False, 0), id="noncausal-lq7-lk11-dk24-dv8"),
]


@pytest.mark.parametrize("case", GRADCHECK_CASES)
def test_flash_attention_function_passes_gradcheck_in_f64(case):
    Lq, Lk, Dk, Dv, causal, window = case
    g = torch.Generator().manual_seed(0)
    q = torch.randn(1, Lq, 2, Dk, dtype=torch.float64, generator=g, requires_grad=True)  # gq 2
    k = torch.randn(1, Lk, 1, Dk, dtype=torch.float64, generator=g, requires_grad=True)
    v = torch.randn(1, Lk, 1, Dv, dtype=torch.float64, generator=g, requires_grad=True)

    def fn(q_, k_, v_):
        return FlashAttention.apply(q_, k_, v_, causal, window, ref.reference_attention, ref.reference_attention_bwd)

    assert torch.autograd.gradcheck(fn, (q, k, v), eps=1e-6, atol=1e-7, rtol=1e-5)


@pytest.mark.parametrize("dk,dv", [(64, 32), (96, 96), (128, 64)])
def test_flash_attention_bwd_refuses_other_head_dim_pairs(dk, dv):
    """K1 takes Dk = Dv and MLA's (96, 64) only: any other pair raises, on
    the CPU as on a card, before a plain version or a kernel runs."""
    q, k, v = torch.zeros(1, 8, 2, dk), torch.zeros(1, 8, 2, dk), torch.zeros(1, 8, 2, dv)
    o, do, lse = torch.zeros(1, 8, 2, dv), torch.zeros(1, 8, 2, dv), torch.zeros(1, 2, 8)
    with pytest.raises(ValueError, match="head dims"):
        flash_attention_bwd(q, k, v, o, do, lse)


def test_flash_attention_bwd_refuses_rows_without_keys():
    q, k, v, do = _bwd_inputs(1, 20, 2, 2, 16, torch.float32)
    o, lse = flash_attention(q, k[:, :8], v[:, :8], causal=False, window=12, return_lse=True)
    with pytest.raises(ValueError, match="window 12"):
        flash_attention_bwd(q, k[:, :8], v[:, :8], o, do, lse, causal=False, window=12)


def _jax_rms_grads(x, w, g):
    def f(x_, w_):
        return jax_common.grad_cast(jax_common.rms_norm(x_, w_, 1e-5))

    y, vjp = jax.vjp(f, x, w)
    return y, *vjp(g)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_rms_norm_and_grad_cast_backward_match_the_custom_vjps(dtype):
    """The same formula with the same casts in both packages: bit for bit in
    bf16 (the f32 sums' last-place differences vanish in the rounding to bf16
    on these inputs), within 2e-6 in f32."""
    rng = np.random.RandomState(3)
    x, g = (rng.randn(3, 7, 64).astype(np.float32) for _ in range(2))
    w = (1 + 0.1 * rng.randn(64)).astype(np.float32)
    xt, wt, gt = (torch.from_numpy(a).to(dtype) for a in (x, w, g))
    xt.requires_grad_()
    wt.requires_grad_()
    y = torch_common.grad_cast(torch_common.rms_norm(xt, wt, 1e-5))
    y.backward(gt)
    j = lambda t: jnp.asarray(t.detach().float().numpy()).astype(JNP[dtype])
    yj, dxj, dwj = _jax_rms_grads(j(xt), j(wt), j(gt))
    assert xt.grad.dtype == wt.grad.dtype == y.dtype == dtype
    for got, want in ((y, yj), (xt.grad, dxj), (wt.grad, dwj)):
        want = torch.from_numpy(np.array(want.astype(jnp.float32))).to(dtype)
        if dtype == torch.bfloat16:
            assert torch.equal(got.detach(), want)
        else:
            torch.testing.assert_close(got.detach(), want, rtol=2e-6, atol=2e-6)


def test_wrappers_refuse_a_gradient_they_would_drop():
    """The forward moe_gmm, mamba_scan and flash_attention take no gradient
    outside their autograd Functions (MoeGmm, MambaScan, FlashAttention, which
    pair them with their backward kernels): given inputs that require a
    gradient, with grad mode on, they raise on every device rather than
    return an output without a graph on a card."""
    w = torch.randn(2, 8, 8, requires_grad=True)
    with pytest.raises(RuntimeError, match="MoeGmm"):
        moe_gmm(torch.randn(2, 3, 8), w, w, w)
    x = torch.randn(1, 5, 8, requires_grad=True)
    with pytest.raises(RuntimeError, match="MambaScan"):
        mamba_scan(x, x.detach().abs(), torch.randn(1, 5, 4), torch.randn(1, 5, 4), -torch.rand(8, 4))
    q = torch.randn(1, 16, 2, 16, requires_grad=True)
    with pytest.raises(RuntimeError, match="FlashAttention"):
        flash_attention(q, q, q)
    # serving is unaffected: no grad mode, or no input that requires one
    with torch.inference_mode():
        moe_gmm(torch.randn(2, 3, 8), w, w, w)
        flash_attention(q, q, q)
    with torch.no_grad():
        mamba_scan(x, x.abs(), torch.randn(1, 5, 4), torch.randn(1, 5, 4), -torch.rand(8, 4))
    moe_gmm(torch.randn(2, 3, 8), w.detach(), w.detach(), w.detach())


# -- K7: the backward of moe_gmm (K7a) and of mamba_scan (K7b) ------------------------

from repro.models import mamba as jax_mamba  # noqa: E402
from repro_torch.models.mamba import MambaScan, selective_scan as model_scan  # noqa: E402
from repro_torch.models.moe import MoeGmm, grouped_swiglu  # noqa: E402

# (E, C, D, F, rows filled per bin or None): ragged C, D and F not multiples
# of 8 (the bf16 FMA route), and bins partly filled and empty, as a capacity
# dispatch leaves them
GMM_BWD_CASES = [
    (4, 32, 64, 96, None),
    (2, 100, 48, 80, None),
    (3, 9, 44, 36, None),
    (6, 20, 32, 48, (0, 1, 7, 20, 0, 13)),
]
# f32 sums of up to max(C, D, F) products in other orders (XLA vs ATen): the
# gmm reference tests' 2e-4 as a share of each gradient's largest |value|
GMM_BWD_REL = 2e-4


def _gmm_bwd_inputs(rng, E, C, D, F, fill):
    x, wg, wu, wd = _gmm_inputs(rng, E, C, D, F)
    dy = rng.randn(E, C, D).astype(np.float32)
    if fill is not None:  # rows past a bin's fill are zeros in x and in dY
        live = (np.arange(C)[None] < np.asarray(fill)[:, None])[..., None]
        x, dy = x * live, dy * live
    return x, wg, wu, wd, dy


@pytest.mark.parametrize("E,C,D,F,fill", GMM_BWD_CASES)
def test_reference_gmm_bwd_matches_jax_grad(E, C, D, F, fill):
    """The plain backward against jax.vjp of the reference's jnp oracle
    (``repro.kernels.ref.reference_gmm``) and torch autograd of the plain
    forward; empty rows give zero dX."""
    arrays = _gmm_bwd_inputs(np.random.RandomState(21), E, C, D, F, fill)
    t = [torch.from_numpy(a) for a in arrays]
    got = ref.reference_gmm_bwd(*t)
    assert [g.dtype for g in got] == [torch.float32] * 4
    assert [g.shape for g in got] == [a.shape for a in t[:4]]
    _, vjp = jax.vjp(jax_ref.reference_gmm, *(jnp.asarray(a) for a in arrays[:4]))
    leaves = [a.clone().requires_grad_() for a in t[:4]]
    ref.reference_gmm(*leaves).backward(t[4])
    for name, g, w, leaf in zip(("dx", "dwg", "dwu", "dwd"), got, vjp(jnp.asarray(arrays[4])), leaves):
        assert _rel_err(g, torch.from_numpy(np.array(w))) <= GMM_BWD_REL, name
        assert _rel_err(g, leaf.grad) <= GMM_BWD_REL, f"{name} vs autograd"
    if fill is not None:
        live = torch.arange(C)[None] < torch.tensor(fill)[:, None]
        assert not got[0][~live].any()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_moe_gmm_function_matches_autograd_of_the_plain_forward(dtype):
    """MoeGmm through the wrappers (the plain versions on the CPU) gives
    autograd's gradient of reference_gmm: bit for bit in f32; in bf16 the
    plain backward rounds dG and dU to bf16 before their products, as the
    forward rounds h, where autograd keeps them f32 (2e-2 of the largest)."""
    arrays = _gmm_bwd_inputs(np.random.RandomState(22), 3, 17, 32, 48, None)
    t = [torch.from_numpy(a).to(dtype) for a in arrays]
    a = [x.clone().requires_grad_() for x in t[:4]]
    out = grouped_swiglu(*a, ops.kernel_set())
    assert out.grad_fn is not None and out.dtype == dtype
    torch.testing.assert_close(out.detach(), moe_gmm(*t[:4]), rtol=0, atol=0)
    out.backward(t[4])
    b = [x.clone().requires_grad_() for x in t[:4]]
    ref.reference_gmm(*b).backward(t[4])
    for name, x, y in zip(("dx", "dwg", "dwu", "dwd"), a, b):
        assert x.grad.dtype == dtype
        if dtype == torch.float32:
            assert _rel_err(x.grad, y.grad) <= 1e-6, name
        else:
            assert _rel_err(x.grad, y.grad) <= 2e-2, name


def test_moe_gmm_function_passes_gradcheck_in_f64():
    g = torch.Generator().manual_seed(1)
    ins = [torch.randn(s, dtype=torch.float64, generator=g, requires_grad=True)
           for s in ((2, 5, 6), (2, 6, 7), (2, 6, 7), (2, 7, 6))]

    def fn(*args):
        return MoeGmm.apply(*args, ref.reference_gmm, ref.reference_gmm_bwd)

    assert torch.autograd.gradcheck(fn, ins, eps=1e-6, atol=1e-7, rtol=1e-5)


# (B, L, Di, N, chunk_len): L not a multiple of the chunk, every N the kernel takes
SCAN_BWD_CASES = [
    (2, 37, 16, 8, 16),
    (1, 64, 24, 4, 32),
    (2, 20, 8, 16, 8),
    (1, 33, 12, 32, 16),
]


def _scan_bwd_inputs(rng, B, L, Di, N, with_h0):
    ins = _scan_inputs(rng, B, L, Di, N, with_h0)
    ins["dy"] = rng.randn(B, L, Di).astype(np.float32)
    ins["dh_final"] = rng.randn(B, Di, N).astype(np.float32)
    return ins


@pytest.mark.parametrize("with_h0", [False, True])
@pytest.mark.parametrize("B,L,Di,N,Lc", SCAN_BWD_CASES)
def test_reference_selective_scan_bwd_matches_jax_grad(B, L, Di, N, Lc, with_h0):
    """The plain backward against jax.vjp of the JAX model's chunked scan
    (``repro.models.mamba.selective_scan``, the function the reference's
    train step differentiates), with a cotangent for h_final, and against
    torch autograd of the plain forward. The chunked associative scan sums in
    another order than the sequential one: SCAN_TOL as a share of each
    gradient's largest |value|."""
    ins = _scan_bwd_inputs(np.random.RandomState(23), B, L, Di, N, with_h0)
    t = {k: None if v is None else torch.from_numpy(v) for k, v in ins.items()}
    got = ref.reference_selective_scan_bwd(**t)
    names = ("dxc", "ddt", "dB", "dC", "da", "dh0")
    assert [g.shape for g in got] == [(B, L, Di), (B, L, Di), (B, L, N), (B, L, N), (Di, N), (B, Di, N)]
    js = [jnp.asarray(ins[k]) for k in ("xc", "dt", "Bm", "Cm", "a")] + ([jnp.asarray(ins["h0"])] if with_h0 else [])
    f = lambda *a: jax_mamba.selective_scan(*a, chunk_len=Lc)
    _, vjp = jax.vjp(f, *js)
    want = vjp((jnp.asarray(ins["dy"]), jnp.asarray(ins["dh_final"])))
    leaves = [t[k].clone().requires_grad_() for k in ("xc", "dt", "Bm", "Cm", "a")] + (
        [t["h0"].clone().requires_grad_()] if with_h0 else [])
    y, h = ref.reference_selective_scan(*leaves)
    ((y * t["dy"]).sum() + (h * t["dh_final"]).sum()).backward()
    for name, g, w, leaf in zip(names, got, want, leaves):
        assert _rel_err(g, torch.from_numpy(np.array(w))) <= SCAN_TOL["rtol"], name
        assert _rel_err(g, leaf.grad) <= 1e-6, f"{name} vs autograd"


@pytest.mark.parametrize("with_dh", [False, True])
@pytest.mark.parametrize("with_h0", [False, True])
@pytest.mark.parametrize("xc_dtype", [torch.float32, torch.bfloat16])
def test_mamba_scan_function_matches_autograd_of_the_plain_forward(xc_dtype, with_h0, with_dh):
    """MambaScan through the wrappers (the plain versions on the CPU): the
    gradients autograd takes through reference_selective_scan, h0's only
    where it was given, and a cotangent of h_final only where h_final is
    used (else the backward is called with None)."""
    ins = _scan_bwd_inputs(np.random.RandomState(24), 2, 21, 8, 8, with_h0)
    t = {k: None if v is None else torch.from_numpy(v) for k, v in ins.items()}
    t["xc"] = t["xc"].to(xc_dtype)
    keys = ("xc", "dt", "Bm", "Cm", "a") + (("h0",) if with_h0 else ())
    a = {k: t[k].clone().requires_grad_() for k in keys}
    b = {k: t[k].clone().requires_grad_() for k in keys}
    y, h = model_scan(ops.kernel_set(), a["xc"], a["dt"], a["Bm"], a["Cm"], a["a"], a.get("h0"), chunk_len=8)
    assert y.grad_fn is not None
    yr, hr = ref.reference_selective_scan(*(b[k] for k in keys))
    torch.testing.assert_close(y.detach(), yr.detach(), rtol=0, atol=0)
    loss = (y * t["dy"]).sum() + ((h * t["dh_final"]).sum() if with_dh else 0)
    loss_r = (yr * t["dy"]).sum() + ((hr * t["dh_final"]).sum() if with_dh else 0)
    loss.backward()
    loss_r.backward()
    for k in keys:
        assert a[k].grad.dtype == t[k].dtype
        tol = 1e-6 if k != "xc" or xc_dtype == torch.float32 else 2e-2  # dxc rounds to bf16
        assert _rel_err(a[k].grad, b[k].grad) <= tol, k


@pytest.mark.parametrize("with_h0", [False, True])
def test_mamba_scan_function_passes_gradcheck_in_f64(with_h0):
    g = torch.Generator().manual_seed(2)
    B, L, Di, N = 1, 6, 3, 4
    ins = [torch.randn(B, L, Di, dtype=torch.float64, generator=g),
           torch.rand(B, L, Di, dtype=torch.float64, generator=g) * 0.5,
           torch.randn(B, L, N, dtype=torch.float64, generator=g),
           torch.randn(B, L, N, dtype=torch.float64, generator=g),
           -torch.rand(Di, N, dtype=torch.float64, generator=g) - 0.1]
    if with_h0:
        ins.append(torch.randn(B, Di, N, dtype=torch.float64, generator=g))
    for x in ins:
        x.requires_grad_()

    def fn(*args):
        h0 = args[5] if with_h0 else None
        return MambaScan.apply(*args[:5], h0, 0,
                               lambda *a, h0=None, chunk_len=0: ref.reference_selective_scan(*a, h0),
                               ref.reference_selective_scan_bwd)

    assert torch.autograd.gradcheck(fn, ins, eps=1e-6, atol=1e-7, rtol=1e-5)


@pytest.mark.parametrize("with_h0", [False, True])
@pytest.mark.parametrize("xc_dtype", [torch.float32, torch.bfloat16])
def test_mamba_scan_bwd_segments_a_scan_past_the_offset_limit(monkeypatch, with_h0, xc_dtype):
    """With the limit patched small the backward walks 3 segments (seeded by
    the forward's segment states, the cotangents carried back): every output
    but dA bit-equal to the unsegmented plain backward; dA, summed a segment
    at a time, within 1e-6 of it."""
    B, L, Di, N = 2, 45, 24, 8
    ins = {k: None if v is None else torch.from_numpy(v)
           for k, v in _scan_bwd_inputs(np.random.RandomState(25), B, L, Di, N, with_h0).items()}
    ins["xc"] = ins["xc"].to(xc_dtype)
    whole = ref.reference_selective_scan_bwd(**ins)
    monkeypatch.setattr(scan_module, "OFFSET_LIMIT", (20 + scan_module.MAX_AHEAD) * Di + 1)
    assert scan_module.segment_len(Di) == 20  # segments of 20, 20 and 5 steps
    segs = mamba_scan_bwd(**ins)
    for name, g, w in zip(("dxc", "ddt", "dB", "dC", "da", "dh0"), segs, whole):
        if name == "da":
            torch.testing.assert_close(g, w, rtol=1e-6, atol=1e-6)
        else:
            assert torch.equal(g, w), name


def test_backward_kernels_are_registered_and_counted():
    """K7a and K7b sit in the kernel registry beside their forwards, with
    launch counters that reset_launch_counts zeroes (moe_gmm_bwd by route
    too); a call on CPU tensors computes the plain version and counts none."""
    assert ops.KERNELS["moe_gmm_bwd"] is moe_gmm_bwd and ops.KERNELS["mamba_scan_bwd"] is mamba_scan_bwd
    ks = ops.kernel_set()
    assert {"moe_gmm_bwd", "mamba_scan_bwd"} <= set(ks)
    moe_gmm_bwd.launches, mamba_scan_bwd.launches = 2, 3
    moe_gmm_bwd.route_launches.update(fma=1, mma=1, wgmma=1)
    mamba_scan_bwd.route_launches.update(chunked=2, per_step=1)
    assert ops.launch_counts()["moe_gmm_bwd"] == 2 and ops.launch_counts()["mamba_scan_bwd"] == 3
    ops.reset_launch_counts()
    assert moe_gmm_bwd.launches == mamba_scan_bwd.launches == 0
    assert moe_gmm_bwd.route_launches == {"fma": 0, "mma": 0, "wgmma": 0}
    assert mamba_scan_bwd.route_launches == {"chunked": 0, "per_step": 0}
    w = torch.randn(2, 8, 8)
    moe_gmm_bwd(torch.randn(2, 3, 8), w, w, w, torch.randn(2, 3, 8))
    assert ops.launch_counts()["moe_gmm_bwd"] == 0


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("D,F,bf16_route", [(4096, 14336, "wgmma"), (64, 128, "wgmma"), (44, 36, "fma"),
                                            (64, 36, "fma")])
def test_moe_gmm_bwd_route(D, F, bf16_route, dtype):
    """bf16 with 16-byte rows (D and F multiples of 8) on wgmma fed by TMA;
    f32, and bf16 rows TMA cannot take, on FMA; mma.sync (the first design)
    is never chosen."""
    assert gmm_bwd_route(dtype, D, F) == (bf16_route if dtype == torch.bfloat16 else "fma")


@pytest.mark.parametrize("arch", ["jamba-v0.1-52b", "mixtral-8x7b", "phi3.5-moe-42b"])
def test_moe_training_layouts_take_the_wgmma_backward(arch):
    """The MoE layouts that train (jamba and mixtral at (4096, 14336),
    phi3.5-moe at (4096, 6400)) send their bf16 backward to wgmma, f32 to FMA."""
    cfg = get_config(arch)
    assert cfg.n_experts > 0 and cfg.dtype == "bfloat16"
    assert gmm_bwd_route(torch.bfloat16, cfg.d_model, cfg.d_ff) == "wgmma"
    assert gmm_bwd_route(torch.float32, cfg.d_model, cfg.d_ff) == "fma"


def test_mamba_scan_bwd_takes_the_chunked_design():
    """The wrapper calls the chunked design's C entry; the first design's
    entry stays only as a baseline, and both count under route_launches."""
    assert scan_module._bwd_design() == "chunked"
    assert scan_module.BWD_DESIGNS == {"chunked": "mamba_scan_bwd", "per_step": "mamba_scan_bwd_per_step"}
    assert set(mamba_scan_bwd.route_launches) == set(scan_module.BWD_DESIGNS)


@pytest.mark.parametrize(
    "B,L,Di,N,seg,design,slots,parts",
    [
        # jamba's training scan, one segment: 1024 / 16 = 64 checkpoints and the
        # final slot; 8192 / 64 = 128 block partials (8192 / 32 = 256 warp partials)
        (4, 1024, 8192, 16, 262128, "chunked", 65, 128),
        (4, 1024, 8192, 16, 262128, "per_step", 65, 256),
        # ragged Di: 130 channels are 3 blocks of 64 (5 warps of 32); L 45 is 3 chunks
        (2, 45, 130, 16, 1000, "chunked", 4, 3),
        (2, 45, 130, 16, 1000, "per_step", 4, 5),
        # segments of 20, 20 and 5 steps: 2 + 2 + 1 chunks, and the final slot
        (2, 45, 130, 8, 20, "chunked", 6, 3),
    ],
)
def test_mamba_scan_bwd_scratch_shapes(B, L, Di, N, seg, design, slots, parts):
    assert scan_module.bwd_scratch_shapes(B, L, Di, N, seg, design) == {
        "ckpt": (B, slots, N, Di), "part_bc": (B, L, parts, 2 * N), "part_a": (B, Di, N)}


def test_mamba_scan_bwd_scratch_at_jambas_training_shape_in_bytes():
    """The chunked design halves part_bc against the first (one partial a
    block of 64 channels, not a warp of 32): 67,108,864 bytes for 134,217,728
    at jamba's (4, 1024, 8192, 16); ckpt stays 136,314,880."""
    nbytes = {d: {k: 4 * int(np.prod(v)) for k, v in scan_module.bwd_scratch_shapes(
        4, 1024, 8192, 16, scan_module.segment_len(8192), d).items()} for d in ("chunked", "per_step")}
    assert nbytes["chunked"]["part_bc"] == 67_108_864 and nbytes["per_step"]["part_bc"] == 134_217_728
    assert nbytes["chunked"]["ckpt"] == nbytes["per_step"]["ckpt"] == 136_314_880


def test_backward_wrappers_reject_what_the_kernels_do_not_take():
    w = torch.randn(2, 8, 8)
    with pytest.raises(ValueError, match="dy"):
        moe_gmm_bwd(torch.randn(2, 3, 8), w, w, w, torch.randn(2, 4, 8))
    with pytest.raises(ValueError, match="dy"):
        moe_gmm_bwd(torch.randn(2, 3, 8), w, w, w, torch.randn(2, 3, 8, dtype=torch.bfloat16))
    x = torch.randn(1, 5, 8)
    args = (x, x.abs(), torch.randn(1, 5, 4), torch.randn(1, 5, 4), -torch.rand(8, 4), None)
    with pytest.raises(ValueError, match="dy"):
        mamba_scan_bwd(*args, torch.randn(1, 5, 7))
    with pytest.raises(ValueError, match="dh_final"):
        mamba_scan_bwd(*args, x, torch.randn(1, 8, 5))
    with pytest.raises(ValueError, match="state size"):
        mamba_scan_bwd(x, x.abs(), torch.randn(1, 5, 3), torch.randn(1, 5, 3), -torch.rand(8, 3), None, x)


def _chip_smoke():
    """chip_smoke.py as a module (it imports no CUDA at import time)."""
    import importlib.util
    from pathlib import Path

    spec = importlib.util.spec_from_file_location("chip_smoke", Path(__file__).resolve().parents[1] / "chip_smoke.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


class _Event:  # the fields of a torch.profiler CUDA event that kernel_shares reads
    def __init__(self, name, us):
        self.name = name
        self.time_range = type("TR", (), {"elapsed_us": lambda _self: us})()


# CUDA kernel names as the profiler gives them (demangled), by family
K7_KERNEL_NAMES = [
    ("void (anonymous namespace)::wg::bwd_kernel<0>((anonymous namespace)::wg::Maps, __nv_bfloat16*, "
     "__nv_bfloat16*, __nv_bfloat16*, float*, int, int, int, int)", "moe_gmm_bwd", "pass0"),
    ("void (anonymous namespace)::wg::bwd_kernel<4>((anonymous namespace)::wg::Maps, __nv_bfloat16*, "
     "__nv_bfloat16*, __nv_bfloat16*, float*, int, int, int, int)", "moe_gmm_bwd", "pass4"),
    ("void (anonymous namespace)::bwd::tc::gemm_kernel<2, 3, true, 4, 4, 0>((anonymous namespace)::bwd::"
     "Args<__nv_bfloat16>)", "moe_gmm_bwd", "pass1"),
    ("void (anonymous namespace)::bwd::tc::gemm_kernel<1, 2, false, 0, 0, 3>((anonymous namespace)::bwd::"
     "Args<__nv_bfloat16>)", "moe_gmm_bwd", "pass4"),
    ("void (anonymous namespace)::bwd::ffma::gemm_kernel<float, 1, 1, false, 0, 0, 1>((anonymous namespace)::"
     "bwd::Args<float>)", "moe_gmm_bwd", None),
    ("void (anonymous namespace)::chunked::ckpt_ahead_kernel<__nv_bfloat16, 16>(__nv_bfloat16 const*, float "
     "const*, float const*, float const*, float const*, float*, int, int, int, int, int, int, long, long)",
     "mamba_scan_bwd", "ckpt"),
    ("void (anonymous namespace)::chunked::rev_chunk_kernel<__nv_bfloat16, 16>(__nv_bfloat16 const*, ...)",
     "mamba_scan_bwd", "rev"),
    ("void (anonymous namespace)::bwd::ckpt_kernel<float, 16>(float const*, ...)", "mamba_scan_bwd", "ckpt"),
    ("void (anonymous namespace)::bwd::rev_kernel<float, 16>(float const*, ...)", "mamba_scan_bwd", "rev"),
    ("(anonymous namespace)::bwd::reduce_bc_kernel(float const*, float*, float*, long, int, int)",
     "mamba_scan_bwd", "reduce_bc"),
    ("(anonymous namespace)::bwd::reduce_a_kernel(float const*, float*, int, long)", "mamba_scan_bwd", "reduce_a"),
    ("void (anonymous namespace)::wg::gemm_kernel<true>(CUtensorMap, CUtensorMap, CUtensorMap, "
     "__nv_bfloat16*, int, int, int, int)", "moe_gmm", None),
    ("void (anonymous namespace)::mamba_scan_kernel<__nv_bfloat16, 16>(__nv_bfloat16 const*, ...)",
     "mamba_scan", None),
    ("nvjet_tst_128x256_64x4_1x2_h_bz_coopA_NNT", "cuBLAS matmuls", None),
    ("void at::native::vectorized_elementwise_kernel<4, ...>", "other", None),
]


@pytest.mark.parametrize("name,family,part", K7_KERNEL_NAMES)
def test_chip_smoke_sorts_the_backward_kernels(name, family, part):
    """Phase 5g's step breakdown (kernel_shares) puts K7a's five wgmma passes
    and K7b's chunked launches, beside both first designs, in their kernels'
    families, and its per-launch split (k7_part) names each pass and launch."""
    smoke = _chip_smoke()
    assert smoke.kernel_shares([_Event(name, 1500.0)]) == {family: 1.5}
    assert smoke.k7_part(name) == part

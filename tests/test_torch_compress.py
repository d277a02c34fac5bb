"""Int8 error-feedback compression of the pod reduction against the JAX
package's ``repro.optim.compress``.

``quantize_int8`` / ``dequantize_int8`` equal the reference's on the same
inputs; the reference's error bound holds for the port's quantiser; the
int32 lanes that carry two int8 values each sum exactly for up to 258 pods;
and ``ef_compress`` on two spawned gloo ranks (one per pod, different
gradients) gives integer pod sums exactly equal to the reference's quantiser
run per pod in JAX and summed in numpy, with ``g_hat`` and the new residual
close to the reference's formulas. The rank function imports no JAX.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from repro_torch.optim.compress import (
    MAX_PODS,
    compress_state_init,
    dequantize_int8,
    ef_compress,
    pack_int8_pairs,
    quantize_int8,
    sum_int8,
    unpack_int32_sums,
)

try:  # the reference's property-test harness, as tests/test_properties.py
    from hypothesis import given, settings
    from hypothesis import strategies as st
except ImportError:  # pragma: no cover - the container may lack hypothesis
    from repro.testing.hypothesis_fallback import given, settings
    from repro.testing.hypothesis_fallback import strategies as st

SHAPES = {"w": (33, 17), "b": (17,), "e": (3, 5, 7)}


def _grads(seed: int) -> dict:
    rng = np.random.RandomState(seed)
    return {k: (rng.randn(*s) * 10.0 ** rng.uniform(-4, 1)).astype(np.float32) for k, s in SHAPES.items()}


@pytest.mark.parametrize("seed", range(4))
def test_quantize_matches_reference(seed):
    from repro.optim.compress import dequantize_int8 as jax_deq
    from repro.optim.compress import quantize_int8 as jax_quant

    for k, x in _grads(seed).items():
        x[0] = 0.0  # exact zeros and a half-way value round as the reference rounds them
        q, scale = quantize_int8(torch.from_numpy(x))
        jq, jscale = jax_quant(x)
        np.testing.assert_array_equal(q.numpy(), np.asarray(jq), err_msg=k)
        assert scale.item() == float(jscale)
        np.testing.assert_array_equal(dequantize_int8(q, scale).numpy(), np.asarray(jax_deq(jq, jscale)))
    q, scale = quantize_int8(torch.zeros(5))
    jq, jscale = jax_quant(np.zeros(5, np.float32))
    assert scale.item() == float(jscale) and not q.any() and not np.asarray(jq).any()


@settings(max_examples=40, deadline=None)
@given(
    arr=st.lists(
        st.floats(-1e6, 1e6, allow_nan=False, allow_infinity=False, width=32),
        min_size=1,
        max_size=256,
    )
)
def test_int8_quantization_error_bound(arr):
    """The reference's bound (tests/test_properties.py): |x - deq(q(x))| <=
    scale / 2 elementwise."""
    x = torch.tensor(np.asarray(arr, np.float32))
    q, scale = quantize_int8(x)
    err = (x - dequantize_int8(q, scale)).abs()
    assert float(err.max()) <= float(scale) / 2 + 1e-6


@pytest.mark.parametrize("n_pods", [1, 2, 3, 129, MAX_PODS])
def test_packed_lanes_sum_exactly(n_pods):
    """Each pod's int8 payload packed two to an int32 lane; the lanes summed
    as int32 (wrapping, as the all-reduce does) unpack to the exact sums."""
    rng = np.random.RandomState(n_pods)
    qs = rng.randint(-127, 128, size=(n_pods, 101)).astype(np.int8)
    qs[0, :4] = [127, -127, 127, -127]
    lanes = np.zeros(51, np.int64)
    for q in qs:
        lanes += pack_int8_pairs(torch.from_numpy(q)).numpy().astype(np.int64)
    wrapped = torch.from_numpy(((lanes + 2**31) % 2**32 - 2**31).astype(np.int32))
    got = unpack_int32_sums(wrapped, 101, n_pods).numpy()
    np.testing.assert_array_equal(got, qs.astype(np.int64).sum(0))
    with pytest.raises(ValueError, match="pods"):
        sum_int8(torch.zeros(3, dtype=torch.int8), None, MAX_PODS + 1)


def _pod_ranks(rank, world):
    """One pod of ``world``: its own gradients and residual; ef_compress and
    the bare integer sums over the pod group (the whole world here)."""
    import torch.distributed as dist

    grads = {k: torch.from_numpy(v) for k, v in _grads(10 + rank).items()}
    state = compress_state_init(grads)
    state["residual"] = {k: torch.from_numpy(v) * 1e-3 for k, v in _grads(20 + rank).items()}
    group = dist.new_group(list(range(world)))
    out, new_state, stats = ef_compress(grads, state, group, world)
    qs = [quantize_int8(grads[k].float() + state["residual"][k])[0].reshape(-1) for k in sorted(grads)]
    sums = sum_int8(torch.cat(qs), group, world)
    return {"g": {k: v.numpy() for k, v in out.items()}, "r": {k: v.numpy() for k, v in new_state["residual"].items()},
            "sums": sums.numpy(), "stats": stats}


def test_ef_compress_on_two_pods_matches_reference(tmp_path):
    from repro.optim.compress import dequantize_int8 as jax_deq
    from repro.optim.compress import quantize_int8 as jax_quant
    from repro_torch.dist.spawn import run_ranks

    world = 2
    ranks = run_ranks(_pod_ranks, world, str(tmp_path / "pods"), timeout=120)
    gf = [{k: _grads(10 + r)[k] + _grads(20 + r)[k].astype(np.float32) * np.float32(1e-3) for k in SHAPES}
          for r in range(world)]
    ref = [{k: jax_quant(gf[r][k]) for k in SHAPES} for r in range(world)]
    want_sums = np.concatenate([sum(np.asarray(ref[r][k][0], np.int64) for r in range(world)).reshape(-1)
                                for k in sorted(SHAPES)])
    for r, out in enumerate(ranks):
        np.testing.assert_array_equal(out["sums"], want_sums)
        assert out["stats"]["compress_ratio"] == 4.0
        n = sum(int(np.prod(s)) for s in SHAPES.values())
        assert out["stats"]["wire_bytes_per_param"] == 4 * -(-n // 2) / n
        for k in SHAPES:
            qsum = sum(np.asarray(ref[p][k][0], np.float32) for p in range(world))
            mean_scale = sum(float(ref[p][k][1]) for p in range(world)) / world
            np.testing.assert_allclose(out["g"][k], qsum * mean_scale / world, rtol=1e-6, atol=1e-12, err_msg=k)
            want_r = gf[r][k] - np.asarray(jax_deq(*ref[r][k]))
            np.testing.assert_allclose(out["r"][k], want_r, rtol=1e-6, atol=1e-9, err_msg=k)

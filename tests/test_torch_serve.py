"""The port's dense serving slice against the JAX package, on the CPU.

Module parity first (``rms_norm``, ``apply_rope``, ``dense_ffn``,
``attention_block`` in prefill and decode), then the whole slice on reduced
stablelm-1.6b, internlm2-20b and qwen2.5-32b with the JAX weights carried over
by ``params_from_jax``. Inputs are made with numpy from a seed and handed to
both packages; everything runs in f32.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCH_IDS as JAX_ARCH_IDS
from repro.configs import get_config as jax_get_config
from repro.models import attention as jax_attn
from repro.models import common as jax_common
from repro.models import moe as jax_moe
from repro.models import registry as jax_registry
from repro_torch.configs import ARCH_IDS, get_config
from repro_torch.launch import serve
from repro_torch.models import attention, common, moe, registry
from repro_torch.models.convert import params_from_jax

ARCHS = ["stablelm-1.6b", "internlm2-20b", "qwen2.5-32b"]
# one module on f32 inputs: only the order of f32 sums and the last ulp of
# exp/rsqrt/cos/sin differ between XLA and ATen
MODULE_TOL = dict(rtol=1e-5, atol=1e-5)
# logits after the whole trunk: the module differences above, compounded
# over the layers and the vocab projection, on logits of magnitude ~1-10
LOGIT_TOL = dict(rtol=1e-4, atol=1e-4)


def _t(x: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(x))


def _close(port: torch.Tensor, ref, tol=MODULE_TOL):
    np.testing.assert_allclose(port.detach().numpy(), np.asarray(ref), **tol)


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_config_matches_reference(arch):
    """All ten of the reference's architectures, field for field."""
    assert ARCH_IDS == JAX_ARCH_IDS
    for full in (False, True):
        port = get_config(arch) if full else get_config(arch).reduced()
        ref = jax_get_config(arch) if full else jax_get_config(arch).reduced()
        assert dataclasses.asdict(port) == dataclasses.asdict(ref)
        assert (port.head_dim, port.d_inner, port.dt_rank, port.n_groups) == (
            ref.head_dim, ref.d_inner, ref.dt_rank, ref.n_groups)
    assert port.compute_dtype() == torch.bfloat16


def test_rms_norm_parity():
    rng = np.random.RandomState(0)
    x, w = rng.randn(2, 5, 64).astype(np.float32), rng.randn(64).astype(np.float32)
    _close(common.rms_norm(_t(x), _t(w), 1e-5), jax_common.rms_norm(jnp.asarray(x), jnp.asarray(w), 1e-5))


@pytest.mark.parametrize("theta", [1e4, 1e6])
def test_apply_rope_parity(theta):
    rng = np.random.RandomState(1)
    x = rng.randn(2, 3, 40, 16).astype(np.float32)  # (B, H, L, Dh)
    pos = rng.randint(0, 600, size=(2, 1, 40)).astype(np.int32)
    ref = jax_common.apply_rope(jnp.asarray(x), jnp.asarray(pos), theta)
    _close(common.apply_rope(_t(x), _t(pos), theta), ref)


def test_dense_ffn_parity():
    rng = np.random.RandomState(2)
    p = {n: rng.randn(*s).astype(np.float32) * 0.1
         for n, s in (("w_gate", (64, 128)), ("w_up", (64, 128)), ("w_down", (128, 64)))}
    x = rng.randn(2, 7, 64).astype(np.float32)
    ref = jax_moe.dense_ffn({n: jnp.asarray(a) for n, a in p.items()}, jnp.asarray(x))
    _close(moe.dense_ffn({n: _t(a) for n, a in p.items()}, _t(x)), ref)


def _attn_params(cfg, rng) -> dict:
    d, H, KVH, Dh = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    shapes = {"wq": (d, H, Dh), "wk": (d, KVH, Dh), "wv": (d, KVH, Dh), "wo": (H, Dh, d)}
    if cfg.qkv_bias:
        shapes.update(bq=(H, Dh), bk=(KVH, Dh), bv=(KVH, Dh))
    return {n: (rng.randn(*s) * d**-0.5).astype(np.float32) for n, s in shapes.items()}


@pytest.mark.parametrize("arch", ARCHS)
def test_attention_block_parity(arch):
    """No cache, then prefill into an empty cache, then three decode steps."""
    cfg, jcfg = get_config(arch).reduced(), jax_get_config(arch).reduced()
    rng = np.random.RandomState(3)
    p = _attn_params(cfg, rng)
    pt, pj = {n: _t(a) for n, a in p.items()}, {n: jnp.asarray(a) for n, a in p.items()}
    B, L, S = 2, 12, 20
    x = rng.randn(B, L + 3, cfg.d_model).astype(np.float32)
    pos = np.broadcast_to(np.arange(L + 3)[None], (B, L + 3)).astype(np.int32)

    y, _ = attention.attention_block(pt, cfg, _t(x[:, :L]), _t(pos[:, :L]))
    yj, _ = jax_attn.attention_block(pj, jcfg, jnp.asarray(x[:, :L]), jnp.asarray(pos[:, :L]))
    _close(y, yj)

    cache = attention.init_attention_cache(cfg, B, S, torch.float32, "cpu")
    cj = jax_attn.init_attention_cache(jcfg, B, S, jnp.float32)
    for lo, hi in ((0, L), (L, L + 1), (L + 1, L + 2), (L + 2, L + 3)):
        y, cache = attention.attention_block(pt, cfg, _t(x[:, lo:hi]), _t(pos[:, lo:hi]), cache)
        yj, cj = jax_attn.attention_block(pj, jcfg, jnp.asarray(x[:, lo:hi]), jnp.asarray(pos[:, lo:hi]), cj)
        _close(y, yj)
        assert cache["index"] == int(cj["index"]) == hi
        _close(cache["k"], cj["k"])


def _models(arch):
    """(port model, port params, jax model, jax params) from one JAX init."""
    cfg, jcfg = get_config(arch).reduced(), jax_get_config(arch).reduced()
    jm = jax_registry.build_model(jcfg)
    jparams, _ = jm.init(jax.random.key(0))
    if cfg.qkv_bias:  # init zeros them: make the bias path count
        rng = np.random.RandomState(4)
        mixer = jparams["blocks"][0]["mixer"]
        for n in ("bq", "bk", "bv"):
            mixer[n] = jnp.asarray(rng.randn(*mixer[n].shape).astype(np.float32) * 0.1)
    params = params_from_jax(cfg, jax.tree.map(np.asarray, jparams), device="cpu")
    return registry.build_model(cfg), params, jm, jparams


def test_params_from_jax_layout_and_bf16_bits():
    jcfg = dataclasses.replace(jax_get_config("internlm2-20b").reduced(), dtype="bfloat16")
    cfg = dataclasses.replace(get_config("internlm2-20b").reduced(), dtype="bfloat16")
    jparams, _ = jax_registry.build_model(jcfg).init(jax.random.key(1))
    params = params_from_jax(cfg, jax.tree.map(np.asarray, jparams), device="cpu")
    assert len(params["layers"]) == cfg.n_layers
    for g, layer in enumerate(params["layers"]):
        for name in ("wq", "wo"):
            got, want = layer["mixer"][name], np.asarray(jparams["blocks"][0]["mixer"][name][g])
            assert got.dtype == torch.bfloat16 and tuple(got.shape) == want.shape
            np.testing.assert_array_equal(got.view(torch.int16).numpy(), want.view(np.int16))


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_and_decode_logits_match_jax(arch):
    m, params, jm, jparams = _models(arch)
    rng = np.random.RandomState(5)
    B, Lp, steps, max_len = 2, 12, 8, 24
    toks = rng.randint(0, m.cfg.vocab, size=(B, Lp + steps)).astype(np.int32)

    state = registry.init_serve_state(m, B, max_len, "cpu")
    jstate = jax_registry.init_serve_state(jm, B, max_len)
    jdecode = jax.jit(lambda p, tok, st: jax_registry.decode_step(jm, p, tok, st))
    with torch.inference_mode():
        lg, state = registry.prefill(m, params, _t(toks[:, :Lp]).long(), state)
    jlg, jstate = jax_registry.prefill(jm, jparams, jnp.asarray(toks[:, :Lp]), jstate)
    _close(lg, jlg, LOGIT_TOL)
    for t in range(Lp, Lp + steps):
        with torch.inference_mode():
            lg, state = registry.decode_step(m, params, _t(toks[:, t : t + 1]).long(), state)
        jlg, jstate = jdecode(jparams, jnp.asarray(toks[:, t : t + 1]), jstate)
        _close(lg, jlg, LOGIT_TOL)
    assert state["t"] == int(jstate["t"]) == Lp + steps


@pytest.mark.parametrize("arch", ARCHS)
def test_greedy_generate_tokens_identical(arch):
    m, params, jm, jparams = _models(arch)
    prompt = np.random.RandomState(6).randint(0, m.cfg.vocab, size=(2, 10)).astype(np.int32)
    got = registry.greedy_generate(m, params, _t(prompt), n_steps=8, max_len=24)
    want = jax_registry.greedy_generate(jm, jparams, jnp.asarray(prompt), n_steps=8, max_len=24)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("arch", ARCHS)
def test_serve_driver_runs_on_cpu(arch, capsys):
    gen = serve.main(["--arch", arch, "--reduced", "--batch", "2", "--prompt-len", "8",
                      "--gen", "4", "--device", "cpu"])
    assert gen.shape == (2, 4)
    assert "tok/s" in capsys.readouterr().out

"""The port's last four architectures against the JAX package, on the CPU.

Mixtral's SWA ring cache, minicpm3's MLA (at its reduced head dims, where
Dk = Dv = 16, and at its own, Dk 96 / Dv 64), internvl2's vision prefix and
seamless's encoder-decoder: module parity first (the ring through a wrap,
``mla_block`` in each of its three branches, cross-attention in prefill and
decode, ``Model.encode``, the plain ``flash_attention`` at (96, 64)), then
prefill + decode logits and greedy tokens of each whole reduced model with
the JAX weights carried over by ``params_from_jax``; each takes a training
step. Inputs are made with numpy from a seed and handed to both packages;
everything runs in f32, with ``tests/test_torch_serve.py``'s tolerances.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.models import attention as jax_attn
from repro.models import registry as jax_registry
from repro.models import transformer as jax_transformer
from repro_torch.configs import get_config
from repro_torch.dist.step import make_serve_fns
from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.launch import serve
from repro_torch.models import attention, registry, transformer
from repro_torch.models.convert import params_from_jax
from repro_torch.optim import adamw_init, cosine_warmup
from repro_torch.dist.step import make_train_step

ARCHS = ["mixtral-8x7b", "minicpm3-4b", "internvl2-1b", "seamless-m4t-medium"]
# one module on f32 inputs: only the order of f32 sums and the last ulp of
# exp/rsqrt/cos/sin differ between XLA and ATen (test_torch_serve.py's)
MODULE_TOL = dict(rtol=1e-5, atol=1e-5)
# logits after the whole trunk (test_torch_serve.py's)
LOGIT_TOL = dict(rtol=1e-4, atol=1e-4)


def _t(x: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(x))


def _close(port: torch.Tensor, ref, tol=MODULE_TOL):
    np.testing.assert_allclose(port.detach().float().numpy(), np.asarray(ref, np.float32), **tol)


def _pair(p: dict):
    return {n: _t(a) for n, a in p.items()}, {n: jnp.asarray(a) for n, a in p.items()}


def _positions(B: int, lo: int, hi: int) -> np.ndarray:
    return np.broadcast_to(np.arange(lo, hi)[None], (B, hi - lo)).astype(np.int32)


# -- the plain flash_attention at MLA's head dims ------------------------------


@pytest.mark.parametrize("Lq,Lk,causal", [(40, 72, True), (72, 72, True), (40, 72, False), (72, 40, False)])
def test_flash_attention_takes_mla_head_dims(Lq, Lk, causal):
    """(Dk 96, Dv 64), MHA and GQA, against the reference's blocked_attention
    (which computes MLA's attention in the JAX package), scaled by Dk**-0.5."""
    rng = np.random.RandomState(0)
    for H, KVH in ((4, 4), (4, 2)):
        q = rng.randn(2, Lq, H, 96).astype(np.float32)
        k = rng.randn(2, Lk, KVH, 96).astype(np.float32)
        v = rng.randn(2, Lk, KVH, 64).astype(np.float32)
        got = flash_attention(_t(q), _t(k), _t(v), causal=causal)
        want = jax_attn.blocked_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=causal,
                                          block_q=16, block_kv=16)
        assert tuple(got.shape) == (2, Lq, H, 64)
        _close(got, want)


@pytest.mark.parametrize("dk,dv", [(64, 32), (96, 96), (128, 64), (64, 96), (80, 80), (48, 48)])
def test_flash_attention_refuses_other_head_dim_pairs(dk, dv):
    q, k, v = torch.zeros(1, 8, 2, dk), torch.zeros(1, 8, 2, dk), torch.zeros(1, 8, 2, dv)
    with pytest.raises(ValueError, match="head dims"):
        flash_attention(q, k, v)


def test_flash_attention_lse_at_mla_head_dims_is_the_rows_logsumexp():
    """The log-sum-exp that K1 reads, at (Dk 96, Dv 64): each row's
    logsumexp of its scores scaled by Dk**-0.5, masked causally; the output
    the one without it."""
    rng = np.random.RandomState(2)
    q, k = _t(rng.randn(2, 40, 4, 96).astype(np.float32)), _t(rng.randn(2, 40, 2, 96).astype(np.float32))
    v = _t(rng.randn(2, 40, 2, 64).astype(np.float32))
    o, lse = flash_attention(q, k, v, return_lse=True)
    assert tuple(lse.shape) == (2, 4, 40) and lse.dtype == torch.float32
    torch.testing.assert_close(o, flash_attention(q, k, v), rtol=0, atol=0)
    s = torch.einsum("bqhgd,bkhd->bhgqk", q.reshape(2, 40, 2, 2, 96), k) * 96**-0.5
    causal = torch.ones(40, 40, dtype=torch.bool).tril()
    want = torch.logsumexp(s.masked_fill(~causal, float("-inf")), dim=-1).reshape(2, 4, 40)
    torch.testing.assert_close(lse, want, rtol=1e-6, atol=1e-6)


# -- mixtral's ring cache ----------------------------------------------------------


def _attn_params(cfg, rng) -> dict:
    d, H, KVH, Dh = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    shapes = {"wq": (d, H, Dh), "wk": (d, KVH, Dh), "wv": (d, KVH, Dh), "wo": (H, Dh, d)}
    if cfg.qkv_bias:
        shapes.update(bq=(H, Dh), bk=(KVH, Dh), bv=(KVH, Dh))
    return {n: (rng.randn(*s) * d**-0.5).astype(np.float32) for n, s in shapes.items()}


def test_ring_cache_matches_jax_through_a_wrap():
    """Reduced mixtral (window 64): a 48-token prefill into a ring of 64
    slots, then decode from position 48 to 79, past the wrap at 64; the
    block's output and the ring's K, V and positions at every step."""
    cfg, jcfg = get_config("mixtral-8x7b").reduced(), jax_get_config("mixtral-8x7b").reduced()
    assert cfg.window == 64
    rng = np.random.RandomState(1)
    pt, pj = _pair(_attn_params(cfg, rng))
    B, Lp, end, max_len = 2, 48, 80, 96
    x = rng.randn(B, end, cfg.d_model).astype(np.float32)
    pos = _positions(B, 0, end)
    cache = attention.init_attention_cache(cfg, B, max_len, torch.float32, "cpu")
    cj = jax_attn.init_attention_cache(jcfg, B, max_len, jnp.float32)
    assert tuple(cache["pos"].shape) == cj["pos"].shape == (B, 64) and int(cache["pos"].min()) == -1
    step = jax.jit(lambda p, x, pos, c: jax_attn.attention_block(p, jcfg, x, pos, c))
    for lo, hi in [(0, Lp)] + [(t, t + 1) for t in range(Lp, end)]:
        with torch.inference_mode():
            y, cache = attention.attention_block(pt, cfg, _t(x[:, lo:hi]), _t(pos[:, lo:hi]), cache)
        yj, cj = step(pj, jnp.asarray(x[:, lo:hi]), jnp.asarray(pos[:, lo:hi]), cj)
        _close(y, yj)
        assert cache["index"] == int(cj["index"]) == hi
        for n in ("k", "v"):
            _close(cache[n], cj[n])
        np.testing.assert_array_equal(cache["pos"].numpy(), np.asarray(cj["pos"]))
    assert int(cache["pos"].min()) == end - 64  # every slot rewritten since the wrap


def test_ring_prefill_longer_than_the_ring_raises():
    """The reference scatters such a prompt to repeated slots in one update,
    in no defined order: there is no answer to match (ROADMAP section 3)."""
    cfg = get_config("mixtral-8x7b").reduced()
    pt, _ = _pair(_attn_params(cfg, np.random.RandomState(2)))
    cache = attention.init_attention_cache(cfg, 1, 128, torch.float32, "cpu")
    x, pos = torch.zeros(1, 65, cfg.d_model), _t(_positions(1, 0, 65))
    with pytest.raises(ValueError, match="ring of 64 slots"):
        attention.attention_block(pt, cfg, x, pos, cache)


# -- minicpm3's MLA ---------------------------------------------------------------


def _mla_cfgs(dims: str):
    cfg, jcfg = get_config("minicpm3-4b").reduced(), jax_get_config("minicpm3-4b").reduced()
    if dims == "mla":  # minicpm3's own head dims (Dk 96, Dv 64) on a small model
        own = dict(qk_nope_dim=64, qk_rope_dim=32, v_head_dim=64)
        cfg, jcfg = dataclasses.replace(cfg, **own), dataclasses.replace(jcfg, **own)
    return cfg, jcfg


def _mla_params(cfg, rng) -> dict:
    d, H, qr, kvr = cfg.d_model, cfg.n_heads, cfg.q_lora_rank, cfg.kv_lora_rank
    dn, dr, dv = cfg.qk_nope_dim, cfg.qk_rope_dim, cfg.v_head_dim
    shapes = {"wq_a": ((d, qr), d), "wq_b": ((qr, H, dn + dr), qr), "wkv_a": ((d, kvr + dr), d),
              "wk_b": ((kvr, H, dn), kvr), "wv_b": ((kvr, H, dv), kvr), "wo": ((H, dv, d), H * dv)}
    p = {n: (rng.randn(*s) * f**-0.5).astype(np.float32) for n, (s, f) in shapes.items()}
    p["q_norm"] = (1 + 0.1 * rng.randn(qr)).astype(np.float32)
    p["kv_norm"] = (1 + 0.1 * rng.randn(kvr)).astype(np.float32)
    return p


@pytest.mark.parametrize("dims", ["reduced", "mla"])
def test_mla_block_matches_jax_in_every_branch(dims):
    """No cache; prefill into the latent cache (per-head K/V rebuilt from
    every slot, flash_attention at (Dk, Dv)); then absorbed decode steps."""
    cfg, jcfg = _mla_cfgs(dims)
    Dk, Dv = cfg.qk_nope_dim + cfg.qk_rope_dim, cfg.v_head_dim
    assert (Dk, Dv) == ((16, 16) if dims == "reduced" else (96, 64))
    rng = np.random.RandomState(3)
    pt, pj = _pair(_mla_params(cfg, rng))
    B, Lp, end, max_len = 2, 12, 16, 20
    x = rng.randn(B, end, cfg.d_model).astype(np.float32)
    pos = _positions(B, 0, end)
    with torch.inference_mode():
        y, c = attention.mla_block(pt, cfg, _t(x[:, :Lp]), _t(pos[:, :Lp]))
    yj, cj = jax_attn.mla_block(pj, jcfg, jnp.asarray(x[:, :Lp]), jnp.asarray(pos[:, :Lp]))
    assert c is None and cj is None
    _close(y, yj)

    cache = attention.init_mla_cache(cfg, B, max_len, torch.float32, "cpu")
    cj = jax_attn.init_mla_cache(jcfg, B, max_len, jnp.float32)
    for lo, hi in [(0, Lp)] + [(t, t + 1) for t in range(Lp, end)]:
        with torch.inference_mode():
            y, cache = attention.mla_block(pt, cfg, _t(x[:, lo:hi]), _t(pos[:, lo:hi]), cache)
        yj, cj = jax_attn.mla_block(pj, jcfg, jnp.asarray(x[:, lo:hi]), jnp.asarray(pos[:, lo:hi]), cj)
        _close(y, yj)
        assert cache["index"] == int(cj["index"]) == hi
        _close(cache["c_kv"], cj["c_kv"])
        _close(cache["k_rope"], cj["k_rope"])


def test_init_mla_scales_by_true_fan_in():
    """The port's departure from the reference's fan_in = shape[-2] (ROADMAP
    section 3): each 3-D weight's std is its true fan-in**-0.5."""
    cfg = dataclasses.replace(get_config("minicpm3-4b"), n_layers=1, dtype="float32")
    gen = torch.Generator().manual_seed(0)
    from repro_torch.models.common import ParamBuilder

    p = attention.init_mla(ParamBuilder(gen, torch.float32, torch.device("cpu")), cfg)
    for name, fan_in in (("wq_b", cfg.q_lora_rank), ("wk_b", cfg.kv_lora_rank), ("wv_b", cfg.kv_lora_rank),
                         ("wo", cfg.n_heads * cfg.v_head_dim), ("wq_a", cfg.d_model)):
        np.testing.assert_allclose(p[name].std().item(), fan_in**-0.5, rtol=0.02)


# -- seamless's encoder and cross-attention ------------------------------------------


# the 3-D attention weights of a (G, ...) stack, and the axes of their true
# fan-in (after the group axis)
_FAN_IN_AXES = {"wq": 1, "wk": 1, "wv": 1, "wq_b": 1, "wk_b": 1, "wv_b": 1, "wo": 2}


def _true_fan_in(tree):
    """The stacked 3-D attention weights rescaled from the reference's init
    (std shape[-2]**-0.5: H, KVH or Dh) to their true fan-in's, as the port
    draws them (ROADMAP section 3). With the reference's scale the attention
    logits have std ~8 at these widths, and a stack of layers multiplies f32
    rounding differences ~3-4x a layer (Model.encode: 5e-6 after one layer,
    3e-5 after two, 8e-5 after four), which the four-layer-deep seamless
    (encoder and decoder) exceeds at LOGIT_TOL."""
    if not isinstance(tree, dict):
        return tree
    out = {}
    for n, a in tree.items():
        if n in _FAN_IN_AXES and not isinstance(a, dict) and a.ndim == 4:
            fan_in = int(np.prod(a.shape[1 : 1 + _FAN_IN_AXES[n]]))
            a = a * jnp.asarray((a.shape[-2] / fan_in) ** 0.5, a.dtype)
        out[n] = _true_fan_in(a) if isinstance(a, dict) else ([_true_fan_in(b) for b in a] if isinstance(a, list) else a)
    return out


def _models(arch, seed=0):
    """(port model, port params, jax model, jax params) from one JAX init with
    the attention weights at the port's scale (``_true_fan_in``); a qkv bias
    made non-zero so that its path counts."""
    cfg, jcfg = get_config(arch).reduced(), jax_get_config(arch).reduced()
    jm = jax_registry.build_model(jcfg)
    jparams, _ = jm.init(jax.random.key(seed))
    jparams = _true_fan_in(jparams)
    if cfg.qkv_bias:
        rng = np.random.RandomState(4)
        mixer = jparams["blocks"][0]["mixer"]
        for n in ("bq", "bk", "bv"):
            mixer[n] = jnp.asarray(rng.randn(*mixer[n].shape).astype(np.float32) * 0.1)
    params = params_from_jax(cfg, jax.tree.map(np.asarray, jparams), device="cpu")
    return registry.build_model(cfg), params, jm, jparams


def test_encode_matches_jax():
    """The encoder is a stack of layers, as the trunk is: the stack's
    tolerance."""
    m, params, jm, jparams = _models("seamless-m4t-medium")
    frames = np.random.RandomState(5).randn(2, m.cfg.frontend_len, m.cfg.d_model).astype(np.float32)
    with torch.inference_mode():
        mem = m.encode(params, _t(frames))
    _close(mem, jm.encode(jparams, jnp.asarray(frames)), LOGIT_TOL)


@pytest.mark.parametrize("L", [7, 1])
def test_cross_attention_layer_matches_jax(L):
    """A decoder layer of reduced seamless with its memory: self-attention
    without a cache, cross-attention (flash_attention for L > 1, flash_decode
    over every memory slot for L = 1), the FFN."""
    m, params, jm, jparams = _models("seamless-m4t-medium")
    cfg, spec = m.cfg, m.cfg.layout[0]
    rng = np.random.RandomState(6)
    x = rng.randn(2, L, cfg.d_model).astype(np.float32)
    memory = rng.randn(2, 11, cfg.d_model).astype(np.float32)
    pos = _positions(2, 5, 5 + L)
    p = params["layers"][0]
    with torch.inference_mode():
        y, c, _ = transformer.apply_layer(p, cfg, spec, _t(x), _t(pos), None,
                                          cross_kv=attention.memory_kv(p["cross"], _t(memory)))
    pj = jax.tree.map(lambda a: a[0], jparams["blocks"][0])
    yj, _, _ = jax_transformer.apply_layer(pj, jm.cfg, spec, jnp.asarray(x), jnp.asarray(pos), None,
                                           jnp.asarray(memory))
    assert c is None
    _close(y, yj)


# -- the weights -----------------------------------------------------------------------


def test_params_from_jax_carries_encoder_cross_and_mla_leaves():
    m, params, _, jparams = _models("seamless-m4t-medium")
    enc = jparams["encoder"]
    assert len(params["encoder"]["layers"]) == m.cfg.encoder_layers == 2
    for i, layer in enumerate(params["encoder"]["layers"]):
        for path in (("mixer", "wq"), ("mixer", "wo"), ("ffn", "w_down"), ("ln1",), ("ln2",)):
            got, want = layer, enc["blocks"]
            for k in path:
                got, want = got[k], want[k]
            np.testing.assert_array_equal(got.numpy(), np.asarray(want)[i])
    np.testing.assert_array_equal(params["encoder"]["norm"].numpy(), np.asarray(enc["norm"]))
    for g, layer in enumerate(params["layers"]):
        block = jparams["blocks"][0]
        np.testing.assert_array_equal(layer["ln_cross"].numpy(), np.asarray(block["ln_cross"])[g])
        for n in ("wq", "wk", "wv", "wo"):
            np.testing.assert_array_equal(layer["cross"][n].numpy(), np.asarray(block["cross"][n])[g])

    _, params, _, jparams = _models("minicpm3-4b")
    names = {"wq_a", "q_norm", "wq_b", "wkv_a", "kv_norm", "wk_b", "wv_b", "wo"}
    for g, layer in enumerate(params["layers"]):
        assert set(layer["mixer"]) == names
        for n in names:
            np.testing.assert_array_equal(layer["mixer"][n].numpy(),
                                          np.asarray(jparams["blocks"][0]["mixer"][n])[g])


# -- the whole reduced models --------------------------------------------------------


def _frontend(cfg, rng, B):
    """(frames, prefix) numpy inputs as the config takes them, or None."""
    shape = (B, cfg.frontend_len, cfg.d_model)
    frames = rng.randn(*shape).astype(np.float32) if cfg.encoder_layers else None
    prefix = rng.randn(*shape).astype(np.float32) if cfg.frontend == "vision" else None
    return frames, prefix


def _opt(a, fn):
    return None if a is None else fn(a)


# mixtral's 40 + 30 tokens fill its reduced ring of 64 slots and wrap it
SHAPES = {"mixtral-8x7b": (40, 30, 80)}  # (prompt, decode steps, max_len)


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_and_decode_logits_match_jax(arch):
    m, params, jm, jparams = _models(arch)
    rng = np.random.RandomState(7)
    B = 2
    Lp, steps, max_len = SHAPES.get(arch, (12, 8, 40))
    toks = rng.randint(0, m.cfg.vocab, size=(B, Lp + steps)).astype(np.int32)
    frames, prefix = _frontend(m.cfg, rng, B)
    Lf = 0 if prefix is None else prefix.shape[1]

    state = registry.init_serve_state(m, B, max_len, "cpu")
    jstate = jax_registry.init_serve_state(jm, B, max_len)
    jdecode = jax.jit(lambda p, tok, st: jax_registry.decode_step(jm, p, tok, st))
    with torch.inference_mode():
        lg, state = registry.prefill(m, params, _t(toks[:, :Lp]).long(), state,
                                     frames=_opt(frames, _t), prefix=_opt(prefix, _t))
    jlg, jstate = jax_registry.prefill(jm, jparams, jnp.asarray(toks[:, :Lp]), jstate,
                                       frames=_opt(frames, jnp.asarray), prefix=_opt(prefix, jnp.asarray))
    _close(lg, jlg, LOGIT_TOL)
    for t in range(Lp, Lp + steps):
        with torch.inference_mode():
            lg, state = registry.decode_step(m, params, _t(toks[:, t : t + 1]).long(), state)
        jlg, jstate = jdecode(jparams, jnp.asarray(toks[:, t : t + 1]), jstate)
        _close(lg, jlg, LOGIT_TOL)
    assert state["t"] == int(jstate["t"]) == Lf + Lp + steps
    if m.cfg.encoder_layers:
        _close(state["memory"], jstate["memory"])
    if arch == "mixtral-8x7b":
        assert all(tuple(c["pos"].shape) == (B, 64) for c in state["caches"]) and state["t"] > 64


@pytest.mark.parametrize("arch", ARCHS)
def test_greedy_generate_tokens_identical(arch):
    m, params, jm, jparams = _models(arch)
    rng = np.random.RandomState(8)
    Lp, steps, max_len = SHAPES.get(arch, (10, 8, 40))
    prompt = rng.randint(0, m.cfg.vocab, size=(2, Lp)).astype(np.int32)
    frames, prefix = _frontend(m.cfg, rng, 2)
    got = registry.greedy_generate(m, params, _t(prompt), n_steps=steps, max_len=max_len,
                                   frames=_opt(frames, _t), prefix=_opt(prefix, _t))
    want = jax_registry.greedy_generate(jm, jparams, jnp.asarray(prompt), n_steps=steps, max_len=max_len,
                                        frames=_opt(frames, jnp.asarray), prefix=_opt(prefix, jnp.asarray))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("arch", ARCHS)
def test_serve_driver_runs_on_cpu(arch, capsys):
    gen = serve.main(["--arch", arch, "--reduced", "--batch", "2", "--prompt-len", "8",
                      "--gen", "4", "--device", "cpu"])
    assert gen.shape == (2, 4)
    assert "tok/s" in capsys.readouterr().out


def test_serve_driver_sizes_the_cache_for_the_prefix():
    cfg = get_config("internvl2-1b")
    assert serve.serve_max_len(cfg, 512, 32) == 1024 + 512 + 32 + 8
    assert serve.serve_max_len(get_config("seamless-m4t-medium"), 512, 32) == 512 + 32 + 8
    frames, prefix = serve.make_frontend(cfg.reduced(), 2, 0, "cpu")
    assert frames is None and tuple(prefix.shape) == (2, 8, 64)
    frames, prefix = serve.make_frontend(get_config("seamless-m4t-medium").reduced(), 2, 0, "cpu")
    assert prefix is None and tuple(frames.shape) == (2, 8, 64)


# -- training takes a step, serving checks its state ---------------------------------


@pytest.mark.parametrize("arch", [a for a in ARCHS if a != "mixtral-8x7b"])
def test_make_train_step_takes_a_step(arch):
    """MLA, the vision prefix and the encoder-decoder train: one step of
    ``make_train_step`` on the reduced config, with the stub frames or
    prefix in the batch, moves the params and gives finite metrics (their
    parity with the JAX package: tests/test_torch_train.py)."""
    cfg = get_config(arch).reduced()
    m = registry.build_model(cfg)
    params = m.init(0, "cpu")
    before = {n: t.clone() for n, t in (("embed", params["embed"]), ("wo", params["layers"][0]["mixer"]["wo"]))}
    rng = np.random.RandomState(0)
    tokens = _t(rng.randint(0, cfg.vocab, size=(2, 8)).astype(np.int32))
    batch = {"tokens": tokens, "labels": tokens}
    stub = _t(rng.randn(2, cfg.frontend_len, cfg.d_model).astype(np.float32))
    if cfg.encoder_layers:
        batch["frames"] = stub
    if cfg.frontend == "vision":
        batch["prefix"] = stub
    state = {"params": params, "opt": adamw_init(params), "step": torch.zeros((), dtype=torch.int32)}
    step = make_train_step(m, "cpu", cosine_warmup(1e-3, 1, 4), global_batch=2)
    state, met = step(state, batch)
    state, met = step(state, batch)  # the warmup's first lr is 0
    assert int(state["step"]) == 2 and all(np.isfinite(v.item()) for v in met.values())
    for name, t in before.items():
        now = params["embed"] if name == "embed" else params["layers"][0]["mixer"]["wo"]
        assert not torch.equal(now, t), name


@pytest.mark.parametrize("arch,max_len", [("mixtral-8x7b", 70), ("minicpm3-4b", 16), ("seamless-m4t-medium", 16)])
def test_serve_fns_check_ring_mla_and_memory_states(arch, max_len):
    """A ring's positions, MLA's latents and an encoder's memory are checked
    as the K/V of a plain cache are: a wrong shape of each raises."""
    m = registry.build_model(get_config(arch).reduced())
    cfg = m.cfg
    params = m.init(0, "cpu")
    prefill_fn, decode_fn = make_serve_fns(m, "cpu", max_len=max_len, global_batch=2)
    tokens = torch.zeros(2, 4, dtype=torch.long)
    frames = torch.zeros(2, cfg.frontend_len, cfg.d_model) if cfg.encoder_layers else None
    logits, state = prefill_fn(params, tokens, registry.init_serve_state(m, 2, max_len, "cpu"), frames)
    assert logits.shape == (2, cfg.vocab)
    decode_fn(params, tokens[:, :1], state)

    bad = registry.init_serve_state(m, 2, max_len, "cpu")
    if arch == "mixtral-8x7b":
        assert "pos" in bad["caches"][1]
        bad["caches"][1]["pos"] = torch.full((2, 63), -1, dtype=torch.int32)
        match = "layer 1 cache pos"
    elif arch == "minicpm3-4b":
        bad["caches"][1]["c_kv"] = torch.zeros(2, max_len + 1, cfg.kv_lora_rank)
        match = "layer 1 cache c_kv"
    else:
        with pytest.raises(ValueError, match="frames"):
            prefill_fn(params, tokens, bad, torch.zeros(2, cfg.frontend_len + 1, cfg.d_model))
        with pytest.raises(ValueError, match="memory"):
            decode_fn(params, tokens[:, :1], {k: v for k, v in state.items() if k not in ("memory", "memory_kv")})
        bad = {**state, "memory": state["memory"][:1]}
        with pytest.raises(ValueError, match="memory"):
            decode_fn(params, tokens[:, :1], bad)
        bad = {**state, "memory_kv": [(k[:, :-1], v) for k, v in state["memory_kv"]]}
        with pytest.raises(ValueError, match="layer 0 memory k"):
            decode_fn(params, tokens[:, :1], bad)
        return
    with pytest.raises(ValueError, match=match):
        prefill_fn(params, tokens, bad)


@pytest.mark.parametrize("arch", ARCHS)
def test_kernel_inputs_are_contiguous(arch):
    """The CUDA wrappers refuse non-contiguous inputs, which the plain
    versions on the CPU would take: every tensor the four hand their kernels
    in prefill and decode (the ring, the latent cache's rebuilt K/V, the
    encoder and the memory's K/V) is contiguous."""
    from repro_torch.kernels import ref

    plain = {"flash_attention": ref.reference_attention, "flash_decode": ref.reference_decode,
             "moe_gmm": ref.reference_gmm}
    seen = []

    def strict(name):
        def call(*args, **kwargs):
            for a in args:
                assert not isinstance(a, torch.Tensor) or a.is_contiguous(), (name, tuple(a.shape))
            seen.append(name)
            return plain[name](*args, **kwargs)
        return call

    kernels = {n: strict(n) for n in plain}
    m = registry.build_model(get_config(arch).reduced())
    Lp, steps, max_len = SHAPES.get(arch, (12, 3, 24))
    frames, prefix = serve.make_frontend(m.cfg, 2, 0, "cpu")
    params = m.init(0, "cpu")
    toks = torch.zeros((2, Lp + steps), dtype=torch.long)
    with torch.inference_mode():
        state = registry.init_serve_state(m, 2, max_len + m.cfg.frontend_len, "cpu")
        _, state = registry.prefill(m, params, toks[:, :Lp], state, kernels=kernels, frames=frames, prefix=prefix)
        for t in range(Lp, Lp + steps):
            _, state = registry.decode_step(m, params, toks[:, t : t + 1], state, kernels=kernels)
    assert "flash_attention" in seen and ("flash_decode" in seen) == (m.cfg.attention != "mla")

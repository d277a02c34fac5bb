"""The port's hybrid serving slice (Mamba + MoE) against the JAX package, on the CPU.

Module parity first (``expert_capacity``, routing with ties, ``moe_ffn`` with
overflowing capacity bins, ``mamba_block`` in each of its three branches),
then the whole slice on reduced jamba-v0.1-52b, falcon-mamba-7b and
phi3.5-moe-42b with the JAX weights carried over by ``params_from_jax``.
Inputs are made with numpy from a seed and handed to both packages;
everything runs in f32. The JAX side runs jnp, or its Pallas kernels in
interpret mode, as its own tests do.
"""

import dataclasses
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.kernels.mamba_scan import mamba_scan as pallas_scan
from repro.kernels.moe_gmm import moe_gmm as pallas_gmm
from repro.models import mamba as jax_mamba
from repro.models import moe as jax_moe
from repro.models import registry as jax_registry
from repro_torch.configs import get_config
from repro_torch.dist.step import make_serve_fns
from repro_torch.models import mamba, moe, registry
from repro_torch.models.convert import params_from_jax

ARCHS = ["jamba-v0.1-52b", "falcon-mamba-7b", "phi3.5-moe-42b"]
# one module on f32 inputs: only the order of f32 sums and the last ulp of
# exp/softplus/silu differ between XLA and ATen
MODULE_TOL = dict(rtol=1e-5, atol=1e-5)
# a Mamba block: the JAX chunked associative scan and the port's direct
# scan multiply the same decays in other orders (the kernel tests' 1e-4)
MAMBA_TOL = dict(rtol=1e-4, atol=1e-4)
GMM_TOL = dict(rtol=2e-4, atol=2e-4)  # as the gmm kernel tests: f32 sums over F in other orders
# logits after the whole trunk: the module differences above compounded over
# the layers and the vocab projection; the JAX jnp and Pallas-interpret paths
# already differ by ~1e-4 on reduced jamba
LOGIT_TOL = dict(rtol=2e-4, atol=2e-4)
PALLAS = {
    "mamba_scan": lambda *a, h0=None, chunk_len=256: pallas_scan(*a, h0=h0, chunk_len=chunk_len),
    "moe_gmm": pallas_gmm,
}
SRC = Path(__file__).resolve().parents[1] / "src"


def _t(x: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(x))


def _close(port: torch.Tensor, ref, tol=MODULE_TOL):
    np.testing.assert_allclose(port.detach().float().numpy(), np.asarray(ref, np.float32), **tol)


# -- modules -----------------------------------------------------------------


@pytest.mark.parametrize("n_tokens", [1, 8, 511, 512, 513, 2048, 4100])
def test_expert_capacity_matches_reference(n_tokens):
    for arch in ("jamba-v0.1-52b", "phi3.5-moe-42b"):
        for reduce in (False, True):
            cfg, jcfg = get_config(arch), jax_get_config(arch)
            if reduce:
                cfg, jcfg = cfg.reduced(), jcfg.reduced()
            assert moe.expert_capacity(n_tokens, cfg) == jax_moe.expert_capacity(n_tokens, jcfg)
    # the serve shapes of the jamba slice: prefill 4 x 512 tokens drops, decode 4 does not
    jamba = get_config("jamba-v0.1-52b")
    assert moe.expert_capacity(2048, jamba) == 320 and moe.expert_capacity(4, jamba) == 4


def _moe_params(cfg, rng) -> dict:
    d, f, e = cfg.d_model, cfg.d_ff, cfg.n_experts
    return {
        "router": (rng.randn(d, e) * d**-0.5).astype(np.float32),
        "w_gate": (rng.randn(e, d, f) * d**-0.5).astype(np.float32),
        "w_up": (rng.randn(e, d, f) * d**-0.5).astype(np.float32),
        "w_down": (rng.randn(e, f, d) * f**-0.5).astype(np.float32),
    }


def test_routing_keeps_top_k_order_on_ties():
    """Tied router probabilities pick the lowest expert index first, as
    ``jax.lax.top_k`` does."""
    cfg = get_config("jamba-v0.1-52b").reduced()
    rng = np.random.RandomState(0)
    p = _moe_params(cfg, rng)
    p["router"][:, 3] = p["router"][:, 1]  # experts 1 and 3 tie for every token
    p["router"][:, 2] = p["router"][:, 0]  # so do 0 and 2
    xf = rng.randn(64, cfg.d_model).astype(np.float32)
    probs, gate_w, gate_e = moe.route({n: _t(a) for n, a in p.items()}, cfg, _t(xf))
    jprobs = jax.nn.softmax(jnp.asarray(xf) @ jnp.asarray(p["router"]), axis=-1)
    jw, je = jax.lax.top_k(jprobs, cfg.top_k)
    np.testing.assert_array_equal(gate_e.numpy(), np.asarray(je))
    assert set(np.unique(gate_e.numpy()[:, 0])) <= {0, 1}  # the lower index of each tied pair
    _close(probs, jprobs)
    _close(gate_w, jw / jw.sum(-1, keepdims=True))


@pytest.mark.parametrize("jax_gmm", ["jnp", "pallas"])
def test_moe_ffn_parity_with_overflowing_bins(jax_gmm):
    # 24 tokens over 4 experts, top-2, capacity factor 0.5: bins of 8 slots for
    # ~12 slots per expert, so overflow is dropped
    cfg = dataclasses.replace(get_config("jamba-v0.1-52b").reduced(), moe_exact_tokens=4, capacity_factor=0.5)
    jcfg = dataclasses.replace(jax_get_config("jamba-v0.1-52b").reduced(), moe_exact_tokens=4, capacity_factor=0.5)
    rng = np.random.RandomState(1)
    p = _moe_params(cfg, rng)
    x = rng.randn(2, 12, cfg.d_model).astype(np.float32)
    pt, pj = {n: _t(a) for n, a in p.items()}, {n: jnp.asarray(a) for n, a in p.items()}

    # the routing first, so that a tie shows up by name
    _, _, gate_e = moe.route(pt, cfg, _t(x.reshape(-1, cfg.d_model)))
    jprobs = jax.nn.softmax(jnp.asarray(x.reshape(-1, cfg.d_model)) @ pj["router"], axis=-1)
    np.testing.assert_array_equal(gate_e.numpy(), np.asarray(jax.lax.top_k(jprobs, cfg.top_k)[1]))

    y, aux = moe.moe_ffn(pt, cfg, _t(x))
    yj, auxj = jax_moe.moe_ffn(pj, jcfg, jnp.asarray(x), gmm=pallas_gmm if jax_gmm == "pallas" else None)
    assert moe.expert_capacity(24, cfg) == 8 and float(aux["dropped_frac"]) > 0.1
    _close(y, yj, GMM_TOL)
    _close(aux["aux_loss"], auxj["aux_loss"])
    assert float(aux["dropped_frac"]) == float(auxj["dropped_frac"])


@pytest.mark.parametrize("groups", [2, 3, 4])
def test_moe_groups_match_reference(groups):
    """Group-local dispatch (``moe_groups``; test_levers.py's cases) against
    the reference's ``moe_ffn``: G groups of T / G tokens, each sorted and
    binned with ``expert_capacity(T / G)``, ``moe_gmm`` once a group where
    the reference runs einsums; 64 tokens do not split in 3 groups, which
    falls back to one. Generous capacity keeps every token; moe_exact_tokens
    8 and capacity factor 0.5 make the group bins overflow."""
    from repro_torch.kernels.ops import kernel_set

    calls = []
    kernels = dict(kernel_set())
    gmm = kernels["moe_gmm"]
    kernels["moe_gmm"] = lambda *a: calls.append(a[0].shape) or gmm(*a)
    for over in ({"capacity_factor": 8.0}, {"moe_exact_tokens": 8, "capacity_factor": 0.5}):
        cfg = dataclasses.replace(get_config("mixtral-8x7b").reduced(), moe_groups=groups, **over)
        jcfg = dataclasses.replace(jax_get_config("mixtral-8x7b").reduced(), moe_groups=groups, **over)
        rng = np.random.RandomState(2)
        p = _moe_params(cfg, rng)
        x = rng.randn(4, 16, cfg.d_model).astype(np.float32)
        calls.clear()
        y, aux = moe.moe_ffn({n: _t(a) for n, a in p.items()}, cfg, _t(x), kernels=kernels)
        yj, auxj = jax_moe.moe_ffn({n: jnp.asarray(a) for n, a in p.items()}, jcfg, jnp.asarray(x))
        g = groups if 64 % groups == 0 else 1
        assert calls == [(cfg.n_experts, moe.expert_capacity(64 // g, cfg), cfg.d_model)] * g
        _close(y, yj, GMM_TOL)
        _close(aux["aux_loss"], auxj["aux_loss"])
        assert float(aux["dropped_frac"]) == float(auxj["dropped_frac"])
        assert (float(aux["dropped_frac"]) > 0) == ("moe_exact_tokens" in over)


def _mamba_params(cfg, rng) -> dict:
    d, di, n, r, k = cfg.d_model, cfg.d_inner, cfg.ssm_state, cfg.dt_rank, cfg.ssm_conv
    p = {
        "in_proj": rng.randn(d, 2 * di) * d**-0.5,
        "conv_w": rng.randn(k, di) * k**-0.5,
        "conv_b": rng.randn(di) * 0.1,
        "x_proj": rng.randn(di, r + 2 * n) * di**-0.5,
        "dt_proj": rng.randn(r, di) * r**-0.5,
        "dt_bias": rng.uniform(-5, -2, size=di),
        "a_log": np.log(np.tile(np.arange(1, n + 1)[None], (di, 1))),
        "d_skip": rng.randn(di),
        "out_proj": rng.randn(di, d) * di**-0.5,
    }
    return {n_: a.astype(np.float32) for n_, a in p.items()}


@pytest.mark.parametrize("jax_scan", ["jnp", "pallas"])
def test_mamba_block_parity_in_every_branch(jax_scan):
    """No cache; prefill into a fresh cache; three decode steps; then a
    second prefill into the state those left (the conv window and h carry in)."""
    cfg, jcfg = get_config("jamba-v0.1-52b").reduced(), jax_get_config("jamba-v0.1-52b").reduced()
    rng = np.random.RandomState(3)
    p = _mamba_params(cfg, rng)
    pt, pj = {n: _t(a) for n, a in p.items()}, {n: jnp.asarray(a) for n, a in p.items()}
    scan_impl = PALLAS["mamba_scan"] if jax_scan == "pallas" else None
    B, L = 2, 10
    x = rng.randn(B, L + 3 + 6, cfg.d_model).astype(np.float32)
    pos = np.zeros(x.shape[:2], np.int32)  # unused by the mixer

    y, c = mamba.mamba_block(pt, cfg, _t(x[:, :L]), _t(pos[:, :L]))
    yj, cj = jax_mamba.mamba_block(pj, jcfg, jnp.asarray(x[:, :L]), jnp.asarray(pos[:, :L]), scan_impl=scan_impl)
    assert c is None and cj is None
    _close(y, yj, MAMBA_TOL)

    cache = mamba.init_mamba_cache(cfg, B, torch.float32, "cpu")
    cj = jax_mamba.init_mamba_cache(jcfg, B, jnp.float32)
    for lo, hi in ((0, L), (L, L + 1), (L + 1, L + 2), (L + 2, L + 3), (L + 3, L + 9)):
        y, cache = mamba.mamba_block(pt, cfg, _t(x[:, lo:hi]), _t(pos[:, lo:hi]), cache)
        yj, cj = jax_mamba.mamba_block(pj, jcfg, jnp.asarray(x[:, lo:hi]), jnp.asarray(pos[:, lo:hi]), cj,
                                       scan_impl=scan_impl)
        _close(y, yj, MAMBA_TOL)
        _close(cache["h"], cj["h"], MAMBA_TOL)
        _close(cache["conv"], cj["conv"], MODULE_TOL)
        assert cache["h"].dtype == torch.float32 and tuple(cache["conv"].shape) == cj["conv"].shape


def test_init_mamba_matches_reference_constants():
    """a_log and dt_bias are f32 constants (dt from RandomState(0)) in a bf16 model."""
    from repro.models.common import ParamBuilder as JaxParamBuilder
    from repro_torch.models.common import ParamBuilder

    cfg = dataclasses.replace(get_config("falcon-mamba-7b").reduced(), dtype="bfloat16")
    jcfg = dataclasses.replace(jax_get_config("falcon-mamba-7b").reduced(), dtype="bfloat16")
    p = mamba.init_mamba(ParamBuilder(torch.Generator().manual_seed(0), torch.bfloat16, torch.device("cpu")), cfg)
    pj = jax_mamba.init_mamba(JaxParamBuilder(jax.random.key(0), jnp.bfloat16), jcfg)
    for name in ("a_log", "dt_bias"):
        assert p[name].dtype == torch.float32
        np.testing.assert_array_equal(p[name].numpy(), np.asarray(pj[name][0]))
    for name, (arr, _) in pj.items():
        want = {"bfloat16": torch.bfloat16, "float32": torch.float32}[str(arr.dtype)]
        assert tuple(p[name].shape) == arr.shape and p[name].dtype == want


# -- the slice ---------------------------------------------------------------


@pytest.fixture(scope="module", params=ARCHS)
def models(request):
    """(port model, port params, jax model, jax params) from one JAX init."""
    arch = request.param
    cfg, jcfg = get_config(arch).reduced(), jax_get_config(arch).reduced()
    jm = jax_registry.build_model(jcfg)
    jparams, _ = jm.init(jax.random.key(0))
    params = params_from_jax(cfg, jax.tree.map(np.asarray, jparams), device="cpu")
    return registry.build_model(cfg), params, jm, jparams


def test_params_from_jax_carries_mamba_and_moe_leaves():
    cfg = dataclasses.replace(get_config("jamba-v0.1-52b").reduced(), dtype="bfloat16")
    jcfg = dataclasses.replace(jax_get_config("jamba-v0.1-52b").reduced(), dtype="bfloat16")
    jparams, _ = jax_registry.build_model(jcfg).init(jax.random.key(1))
    params = params_from_jax(cfg, jax.tree.map(np.asarray, jparams), device="cpu")
    assert len(params["layers"]) == cfg.n_layers
    for i, layer in enumerate(params["layers"]):
        pos, g = i % len(cfg.layout), i // len(cfg.layout)
        spec, block = cfg.layout[pos], jparams["blocks"][pos]
        assert set(layer["mixer"]) == set(block["mixer"])
        assert set(layer.get("ffn", {})) == set(block.get("ffn", {}))
        if spec.mixer == "mamba":
            for name in ("a_log", "dt_bias"):  # f32 leaves of a bf16 model, carried bit for bit
                got, want = layer["mixer"][name], np.asarray(block["mixer"][name][g])
                assert got.dtype == torch.float32
                np.testing.assert_array_equal(got.numpy(), want)
        if spec.ffn == "moe":
            for name in ("router", "w_gate", "w_down"):
                got, want = layer["ffn"][name], np.asarray(block["ffn"][name][g])
                assert got.dtype == torch.bfloat16 and tuple(got.shape) == want.shape
                np.testing.assert_array_equal(got.view(torch.int16).numpy(), want.view(np.int16))


def test_trunk_without_caches_and_aux_match_jax(models):
    m, params, jm, jparams = models
    rng = np.random.RandomState(4)
    B, L = 2, 12
    x = rng.randn(B, L, m.cfg.d_model).astype(np.float32)
    pos = np.broadcast_to(np.arange(L)[None], (B, L)).astype(np.int32)
    with torch.inference_mode():
        y, aux, caches = m.trunk(params, _t(x), _t(pos))
    yj, auxj, cj = jm.trunk(jparams, jnp.asarray(x), jnp.asarray(pos))
    assert caches is None and cj is None
    _close(y, yj, LOGIT_TOL)
    _close(aux, auxj, MODULE_TOL)
    has_moe = any(s.ffn == "moe" for s in m.cfg.layout)
    assert (float(aux) > 0) == has_moe


def test_prefill_and_decode_logits_match_jax(models):
    m, params, jm, jparams = models
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
    for c, spec in zip(state["caches"], m.cfg.layout * m.cfg.n_groups):
        assert set(c) == ({"h", "conv"} if spec.mixer == "mamba" else {"k", "v", "index"})


def test_prefill_logits_match_jax_pallas_kernels(models):
    """The JAX trunk handed its Pallas kernels (interpret mode), as a TPU
    serve would run them, against the port's prefill."""
    m, params, jm, jparams = models
    toks = np.random.RandomState(6).randint(0, m.cfg.vocab, size=(2, 12)).astype(np.int32)
    with torch.inference_mode():
        lg, _ = registry.prefill(m, params, _t(toks).long(), registry.init_serve_state(m, 2, 20, "cpu"))
    jlg, _ = jax_registry.prefill(jm, jparams, jnp.asarray(toks), jax_registry.init_serve_state(jm, 2, 20),
                                  kernels=PALLAS)
    _close(lg, jlg, LOGIT_TOL)


def test_greedy_generate_tokens_identical(models):
    m, params, jm, jparams = models
    prompt = np.random.RandomState(7).randint(0, m.cfg.vocab, size=(2, 10)).astype(np.int32)
    got = registry.greedy_generate(m, params, _t(prompt), n_steps=8, max_len=24)
    want = jax_registry.greedy_generate(jm, jparams, jnp.asarray(prompt), n_steps=8, max_len=24)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_serve_fns_check_every_layer_cache():
    """Layer 0 of jamba is a Mamba layer: its cache is (h, conv), not K/V."""
    m = registry.build_model(get_config("jamba-v0.1-52b").reduced())
    params = m.init(0, "cpu")
    prefill_fn, _ = make_serve_fns(m, "cpu", max_len=16, global_batch=2)
    tokens = torch.zeros(2, 4, dtype=torch.long)
    logits, _ = prefill_fn(params, tokens, registry.init_serve_state(m, 2, 16, "cpu"))
    assert logits.shape == (2, m.cfg.vocab)
    bad = registry.init_serve_state(m, 2, 16, "cpu")
    bad["caches"][0] = mamba.init_mamba_cache(m.cfg, 3, torch.float32, "cpu")  # batch 3
    with pytest.raises(ValueError, match="layer 0 cache"):
        prefill_fn(params, tokens, bad)
    bad = registry.init_serve_state(m, 2, 16, "cpu")
    bad["caches"][4] = registry.init_serve_state(m, 2, 17, "cpu")["caches"][4]  # attention, max_len 17
    with pytest.raises(ValueError, match="layer 4 cache"):
        prefill_fn(params, tokens, bad)


def test_serve_module_runs_hybrid_on_cpu():
    r = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--device", "cpu", "--reduced",
         "--arch", "jamba-v0.1-52b", "--batch", "2", "--prompt-len", "8", "--gen", "4"],
        capture_output=True, text=True, timeout=300, env=dict(os.environ, PYTHONPATH=str(SRC)),
    )
    assert r.returncode == 0, r.stdout + r.stderr
    assert "jamba-v0.1-52b-smoke: prefill 2x8" in r.stdout and "tok/s" in r.stdout

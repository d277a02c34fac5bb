"""The port's training step against the JAX package, on the CPU.

Reduced dense, MoE, hybrid Mamba, MLA, vision-prefix and encoder-decoder
configs in f32, the JAX weights carried over with ``params_from_jax`` (the
G-stacked ``blocks`` leaves become one dict per layer), and the same numpy
batches (with the stub frames or prefix) handed to both packages:
``train_loss`` (ce and the MoE aux loss) and every gradient leaf against
``jax.value_and_grad``, also with capacity bins that drop tokens, three steps
of ``make_train_step`` (with and without microbatches) against the JAX step
on ``make_host_mesh()``, AdamW and the cosine schedule alone, and the inputs
that must refuse to train. On the CPU the MoE and Mamba layers' gradients
come from the plain backward versions that the Functions ``MoeGmm`` and
``MambaScan`` call (``ref.reference_gmm_bwd``,
``ref.reference_selective_scan_bwd``), where the card runs K7a and K7b.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.dist.step import make_train_step as jax_make_train_step
from repro.launch.mesh import make_host_mesh
from repro.models import registry as jax_registry
from repro.optim import adamw_init as jax_adamw_init
from repro.optim import adamw_update as jax_adamw_update
from repro.optim import cosine_warmup as jax_cosine_warmup
from repro_torch.configs import get_config
from repro_torch.dist.step import make_train_state_specs, make_train_step
from repro_torch.models import moe as moe_mod
from repro_torch.models import registry
from repro_torch.models.convert import params_from_jax
from repro_torch.optim import adamw_init, adamw_update, constant_lr, cosine_warmup
from repro_torch.optim.adamw import tree_leaves, tree_map

ARCHS = ["stablelm-1.6b", "internlm2-20b", "qwen2.5-32b"]
# the MoE and hybrid layouts: Mamba + attention + MoE, attention + MoE (a
# sliding window), attention + MoE, attention-free Mamba
MOE_HYBRID = ["jamba-v0.1-52b", "mixtral-8x7b", "phi3.5-moe-42b", "falcon-mamba-7b"]
MOE_ARCHS = ["jamba-v0.1-52b", "mixtral-8x7b", "phi3.5-moe-42b"]
# MLA, a vision prefix before the tokens, and an encoder-decoder over stub
# frames (cross-attention in every decoder layer)
FRONTEND_MLA = ["minicpm3-4b", "internvl2-1b", "seamless-m4t-medium"]
# minicpm3's reduced config has Dk = Dv = 16 (qk_nope 8 + rope 8, v 16): it
# trains here at its own head dims (qk_nope 64 + rope 32 = Dk 96, Dv 64) at
# the reduced width, so that its attention is the Dk != Dv function
HEAD_DIMS = {"minicpm3-4b": dict(qk_nope_dim=64, qk_rope_dim=32, v_head_dim=64)}
B, L = 4, 40
# loss and gradients of one f32 forward/backward: XLA and ATen sum in other
# orders (matmuls, the norm's means, logsumexp), ~1e-6 relative per op,
# compounded through two layers and the head; measured <= 5e-5 of the leaf's
# largest gradient
LOSS_TOL = dict(rtol=1e-6, atol=1e-5)
GRAD_REL = 2e-4  # max |diff| over the leaf's max |grad|
# The encoder-decoder's gradients are worse conditioned in f32: its cross-
# attention and non-causal encoder softmaxes are near one-hot at the
# reference's init (attention logits of std ~16), where dS = P (dP - D)
# cancels. Held against the same model in f64 (the port's plain versions,
# test_encoder_decoder_f32_gradients_against_f64), the JAX package's own f32
# gradients differ by up to 2.6e-4, 6.4e-4, 3.5e-4 and 5.1e-4 of a leaf's
# largest at seeds 0-3, and the port's by up to 3.7e-4, 5.0e-4, 2.6e-4 and
# 3.5e-4 (seamless-m4t-medium reduced), so the two f32 runs may differ by
# up to their sum (seeds 0-3: 4.4e-4, 6.2e-4, 5.0e-4, 3.3e-4).
GRAD_REL_BY_ARCH = {"seamless-m4t-medium": 1e-3}
# three AdamW steps: each step divides an element's moment by the root of its
# own second moment, so an element's update carries its gradient's *relative*
# error. An element whose gradient sits at the f32 noise floor of its leaf
# (e.g. qwen's key bias, whose gradient nearly cancels over positions) may
# step the other way in either package: it may differ by up to Adam's largest
# move, 2 lr a step, where its first moment is below NOISE_REL of the leaf's
# largest. Every other element agrees within PARAM_TOL. Metrics of steps 2-3
# see parameters moved that way.
METRIC_TOL = dict(rtol=2e-3, atol=1e-6)
PARAM_TOL = dict(rtol=1e-4, atol=2e-5)
NOISE_REL = 1e-4
MOMENT_REL = 1e-3  # max |diff| over the leaf's max |moment|


def _models(arch, seed=0, **overrides):
    """The reduced config of ``arch`` (at ``HEAD_DIMS``, with ``overrides``
    replaced in both packages') and its JAX weights carried over."""
    overrides = {**HEAD_DIMS.get(arch, {}), **overrides}
    cfg = dataclasses.replace(get_config(arch).reduced(), **overrides)
    jcfg = dataclasses.replace(jax_get_config(arch).reduced(), **overrides)
    jm = jax_registry.build_model(jcfg)
    jparams, _ = jm.init(jax.random.key(seed))
    params = params_from_jax(cfg, jax.tree.map(np.asarray, jparams), device="cpu")
    return registry.build_model(cfg), params, jm, jparams


def _batch(cfg, seed=0, batch=B):
    """One step's numpy inputs: tokens and labels (B, L) int32, and the stub
    frames or prefix (B, frontend_len, d_model) f32 where ``cfg`` takes them."""
    rng = np.random.RandomState(seed)
    tokens = rng.randint(0, cfg.vocab, size=(batch, L)).astype(np.int32)
    labels = rng.randint(0, cfg.vocab, size=(batch, L)).astype(np.int32)
    labels[0, :5] = -1  # ignored positions
    out = {"tokens": tokens, "labels": labels}
    if cfg.encoder_layers:
        out["frames"] = rng.randn(batch, cfg.frontend_len, cfg.d_model).astype(np.float32)
    if cfg.frontend == "vision":
        out["prefix"] = rng.randn(batch, cfg.frontend_len, cfg.d_model).astype(np.float32)
    return out


def _port_tree(cfg, jtree):
    """A JAX param-shaped tree (grads, moments) in the port's layout."""
    return params_from_jax(cfg, jax.tree.map(np.asarray, jtree), device="cpu")


def _leaf_names(tree, prefix=""):
    if isinstance(tree, dict):
        return [n for k in sorted(tree) for n in _leaf_names(tree[k], f"{prefix}/{k}")]
    if isinstance(tree, list):
        return [n for i, t in enumerate(tree) for n in _leaf_names(t, f"{prefix}/{i}")]
    return [prefix]


def _rel_close(name, got, want, rel):
    scale = max(float(want.abs().max()), 1e-12)
    diff = float((got - want).abs().max())
    assert diff <= rel * scale, f"{name}: max |diff| {diff} > {rel} x {scale}"


def _jax_loss_and_grads(jm, jparams, batch):
    """(loss, metrics, gradients) of ``jax.value_and_grad`` of the reference's
    train_loss on the numpy ``batch``, the gradients as a numpy tree."""
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    (jloss, jaux), jgrads = jax.value_and_grad(
        lambda p: jax_registry.train_loss(jm, p, jb), has_aux=True)(jparams)
    return float(jloss), {k: float(v) for k, v in jaux.items()}, jax.tree.map(np.asarray, jgrads)


@functools.lru_cache(maxsize=None)
def _jax_reference(arch):
    """The JAX package's loss and gradients of ``arch`` at remat none on
    ``_batch``: its remat variants compute the same values, and tracing
    jamba's eight layer kinds takes ~15 s a variant on the CPU (MLA, an
    encoder-decoder 5-12 s), so the port variants of every layout but the
    dense family are held against this one."""
    m, _, jm, jparams = _models(arch)
    return _jax_loss_and_grads(jm, jparams, _batch(m.cfg))


def _loss_and_grads(m, params, batch, jref):
    """(loss, metrics, grads) of the port on the numpy ``batch``, and ``jref``
    with its gradients in the port's layout."""
    leaves = [p.clone().requires_grad_() for p in tree_leaves(params)]
    it = iter(leaves)
    live = tree_map(lambda _: next(it), params)
    loss, aux = registry.train_loss(m, live, {k: torch.from_numpy(v) for k, v in batch.items()})
    grads = torch.autograd.grad(loss, leaves)
    jloss, jaux, jgrads = jref
    return (loss, aux, grads), (jloss, jaux, _port_tree(m.cfg, jgrads))


def _check_loss_and_grads(port, ref, rel=GRAD_REL):
    (loss, aux, grads), (jloss, jaux, want) = port, ref
    np.testing.assert_allclose(loss.item(), jloss, **LOSS_TOL)
    np.testing.assert_allclose(aux["ce"].item(), jaux["ce"], **LOSS_TOL)
    np.testing.assert_allclose(aux["aux"].item(), jaux["aux"], **LOSS_TOL)
    names = _leaf_names(want)
    assert len(names) == len(grads)
    for name, g, w in zip(names, grads, tree_leaves(want)):
        assert g.shape == w.shape and g.dtype == w.dtype, name
        _rel_close(name, g, w, rel)
    return names


@pytest.mark.parametrize("remat", ["none", "block", "full"])
@pytest.mark.parametrize("arch", ARCHS + MOE_HYBRID + FRONTEND_MLA)
def test_train_loss_and_grads_match_jax(arch, remat):
    """The port at each remat against the JAX package at the same remat
    (dense) or at remat none (``_jax_reference``: MoE, hybrid, MLA, prefix
    and encoder-decoder)."""
    m, params, jm, jparams = _models(arch, remat=remat)
    batch = _batch(m.cfg)
    jref = _jax_loss_and_grads(jm, jparams, batch) if arch in ARCHS else _jax_reference(arch)
    port, ref = _loss_and_grads(m, params, batch, jref)
    names = _check_loss_and_grads(port, ref, GRAD_REL_BY_ARCH.get(arch, GRAD_REL))
    cfg = m.cfg
    if arch in ARCHS:  # dense: no aux loss; embed, head, final norm and 9 leaves a layer
        assert port[1]["aux"].item() == ref[1]["aux"] == 0.0
        assert len(names) == 3 + 9 * cfg.n_layers + 3 * cfg.qkv_bias * cfg.n_layers
    elif arch in FRONTEND_MLA:  # no MoE; every leaf, the encoder's and cross-attention's too
        assert port[1]["aux"].item() == ref[1]["aux"] == 0.0
        assert len(names) == len(tree_leaves(params))
        if cfg.encoder_layers:
            assert any("/encoder/" in n for n in names) and any("/cross/" in n for n in names)
        if cfg.attention == "mla":
            assert cfg.qk_nope_dim + cfg.qk_rope_dim == 96 and cfg.v_head_dim == 64
    else:  # every MoE layer adds its load-balancing loss
        assert (port[1]["aux"].item() > 0) == any(s.ffn == "moe" for s in cfg.layout)


@pytest.mark.parametrize("seed", [0, 1])
def test_encoder_decoder_f32_gradients_against_f64(seed, monkeypatch):
    """What ``GRAD_REL_BY_ARCH`` rests on: seamless-m4t-medium's f32
    gradients, the port's and the JAX package's, each against the port's f64
    gradient of the same weights and batch (its plain attention versions;
    every ``.float()`` of the model code, the rotary embedding's and the
    loss's, keeps an f64 tensor in f64). The port's f32 error stays within
    half the limit, the reference's own within the limit: the limit is f32's
    error on this model, not a gap between the packages."""
    from repro_torch.kernels import ref
    from repro_torch.models import common

    arch = "seamless-m4t-medium"
    rel = GRAD_REL_BY_ARCH[arch]
    m, params, jm, jparams = _models(arch, seed=seed)
    batch = _batch(m.cfg, seed=seed)
    (_, _, grads), (_, _, jgrads) = _loss_and_grads(m, params, batch, _jax_loss_and_grads(jm, jparams, batch))
    monkeypatch.setattr(common.ArchConfig, "compute_dtype", lambda self: torch.float64)
    to_f32 = torch.Tensor.float
    monkeypatch.setattr(torch.Tensor, "float", lambda t, *a, **k: t if t.dtype == torch.float64 else to_f32(t, *a, **k))
    leaves = [p.double().requires_grad_() for p in tree_leaves(params)]
    it = iter(leaves)
    live = tree_map(lambda _: next(it), params)
    b64 = {k: torch.from_numpy(v.astype(np.float64) if v.dtype == np.float32 else v) for k, v in batch.items()}
    plain = {"flash_attention": ref.reference_attention, "flash_attention_bwd": ref.reference_attention_bwd}
    loss, _ = registry.train_loss(m, live, b64, kernels=plain)
    assert loss.dtype == torch.float64
    g64 = torch.autograd.grad(loss, leaves)

    def err(gs):
        return max(float((g.double() - w).abs().max()) / max(float(w.abs().max()), 1e-30) for g, w in zip(gs, g64))

    port_err, jax_err = err(grads), err(tree_leaves(jgrads))
    assert port_err <= rel / 2, f"the port's f32 gradient is {port_err} of a leaf's largest from f64"
    assert jax_err <= rel, f"the JAX package's f32 gradient is {jax_err} of a leaf's largest from f64"


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_train_loss_and_grads_with_capacity_drops_match_jax(arch, monkeypatch):
    """moe_exact_tokens 16 and capacity_factor 0.5 in both packages' configs:
    the 160 tokens of a batch go to capacity bins that overflow, and the
    dropped token-slots carry no gradient in either package."""
    m, params, jm, jparams = _models(arch, moe_exact_tokens=16, capacity_factor=0.5)
    dropped = []
    moe_ffn = moe_mod.moe_ffn

    def recording_moe_ffn(*args, **kwargs):
        y, aux = moe_ffn(*args, **kwargs)
        dropped.append(aux["dropped_frac"].item())
        return y, aux

    monkeypatch.setattr(moe_mod, "moe_ffn", recording_moe_ffn)
    batch = _batch(m.cfg)
    _check_loss_and_grads(*_loss_and_grads(m, params, batch, _jax_loss_and_grads(jm, jparams, batch)))
    n_moe = sum(m.cfg.layout[i % len(m.cfg.layout)].ffn == "moe" for i in range(m.cfg.n_layers))
    assert len(dropped) == n_moe and all(d > 0 for d in dropped), dropped


LR = 3e-4


def _run_steps(arch, microbatches, n_steps=3, lr=LR):
    m, params, jm, jparams = _models(arch)
    batches = [_batch(m.cfg, seed=s) for s in range(n_steps)]
    jstep, _, state_shard, _ = jax_make_train_step(jm, make_host_mesh(), jax_cosine_warmup(lr, 1, 4),
                                                   global_batch=B, microbatches=microbatches)
    step = make_train_step(m, "cpu", cosine_warmup(lr, 1, 4), global_batch=B, microbatches=microbatches)
    # placed as the step places its output state, so the second step does not
    # compile the step again (~18 s for reduced jamba on the CPU)
    jstate = jax.device_put({"params": jparams, "opt": jax_adamw_init(jparams), "step": jnp.zeros((), jnp.int32)},
                            state_shard)
    state = {"params": params, "opt": adamw_init(params), "step": torch.zeros((), dtype=torch.int32)}
    for batch in batches:
        jstate, jmet = jstep(jstate, {k: jnp.asarray(v) for k, v in batch.items()})
        state, met = step(state, {k: torch.from_numpy(v) for k, v in batch.items()})
        for k in ("loss", "lr", "grad_norm", "clip_scale"):
            np.testing.assert_allclose(met[k].item(), float(jmet[k]), err_msg=k, **METRIC_TOL)
    assert int(state["step"]) == int(jstate["step"]) == n_steps
    assert int(state["opt"]["count"]) == int(jstate["opt"]["count"]) == n_steps
    return m.cfg, state, jstate


def _check_state(cfg, state, jstate, n_steps=3):
    want_p, want_m = _port_tree(cfg, jstate["params"]), _port_tree(cfg, jstate["opt"]["m"])
    for name, got, want, m in zip(_leaf_names(want_p), tree_leaves(state["params"]), tree_leaves(want_p),
                                  tree_leaves(want_m)):
        diff = (got - want).abs()
        far = diff > PARAM_TOL["atol"] + PARAM_TOL["rtol"] * want.abs()
        noise = m.abs() <= NOISE_REL * m.abs().max()
        assert not (far & ~noise).any(), f"{name}: {int((far & ~noise).sum())} of {far.numel()} elements"
        assert diff.max().item() <= 2 * n_steps * LR, name
    for moment in ("m", "v"):
        want_m = _port_tree(cfg, jstate["opt"][moment])
        for name, got, want in zip(_leaf_names(want_m), tree_leaves(state["opt"][moment]), tree_leaves(want_m)):
            assert got.dtype == torch.float32
            _rel_close(f"{moment}{name}", got, want, MOMENT_REL)


@pytest.mark.parametrize("arch", ARCHS + MOE_HYBRID + FRONTEND_MLA)
def test_three_train_steps_match_jax(arch):
    _check_state(*_run_steps(arch, microbatches=1))


def test_microbatched_train_steps_match_jax():
    _check_state(*_run_steps("stablelm-1.6b", microbatches=2))


def _tree_np(tree):
    return jax.tree.map(lambda a: np.asarray(a, dtype=np.float32), tree)


@pytest.mark.parametrize("clip_norm", [1.0, 1e3])  # clipped, and not
def test_adamw_update_matches_jax(clip_norm):
    """One 1-D param (never decayed), one 2-D param, and one per-layer 1-D
    param in a list, which the reference stacks to (G, D) and so decays."""
    rng = np.random.RandomState(7)
    p = {"norm": rng.randn(8), "w": rng.randn(8, 6), "layers": [{"ln": rng.randn(8)}, {"ln": rng.randn(8)}]}
    g = {"norm": rng.randn(8) * 3, "w": rng.randn(8, 6) * 3,
         "layers": [{"ln": rng.randn(8) * 3}, {"ln": rng.randn(8) * 3}]}
    p, g = _tree_np(p), _tree_np(g)
    stack = lambda t: {"norm": t["norm"], "w": t["w"], "ln": np.stack([t["layers"][0]["ln"], t["layers"][1]["ln"]])}
    jp, jg = jax.tree.map(jnp.asarray, stack(p)), jax.tree.map(jnp.asarray, stack(g))
    tp, tg = tree_map(torch.from_numpy, p), tree_map(torch.from_numpy, g)
    jstate, state = jax_adamw_init(jp), adamw_init(tp)
    for lr in (1e-2, 5e-3):
        jp, jstate, jm = jax_adamw_update(jp, jg, jstate, jnp.float32(lr), clip_norm=clip_norm)
        with torch.no_grad():
            met = adamw_update(tp, tg, state, torch.tensor(lr, dtype=torch.float32), clip_norm=clip_norm)
        np.testing.assert_allclose(met["grad_norm"].item(), float(jm["grad_norm"]), rtol=1e-6)
        np.testing.assert_allclose(met["clip_scale"].item(), float(jm["clip_scale"]), rtol=1e-6)
        got = stack(tree_map(lambda t: t.numpy(), tp))
        for k in got:
            np.testing.assert_allclose(got[k], np.asarray(jp[k]), rtol=1e-6, atol=1e-7, err_msg=k)
    assert (met["clip_scale"].item() < 1.0) == (clip_norm == 1.0)
    # the 1-D param took no decay: with weight_decay 0 it lands on the same value
    p0 = _tree_np({"norm": np.ones(8)})
    a, b = tree_map(torch.from_numpy, p0), tree_map(torch.from_numpy, _tree_np({"norm": np.ones(8)}))
    gg = tree_map(torch.from_numpy, _tree_np({"norm": np.full(8, 0.5)}))
    with torch.no_grad():
        adamw_update(a, gg, adamw_init(a), torch.tensor(0.1))
        adamw_update(b, gg, adamw_init(b), torch.tensor(0.1), weight_decay=0.0)
    assert torch.equal(a["norm"], b["norm"])


def test_cosine_warmup_matches_jax():
    port, ref = cosine_warmup(3e-4, 2, 20), jax_cosine_warmup(3e-4, 2, 20)
    for step in range(25):
        want = float(ref(jnp.asarray(step, jnp.int32)))
        np.testing.assert_allclose(port(torch.tensor(step, dtype=torch.int32)).item(), want, rtol=1e-6, atol=0)
        np.testing.assert_allclose(port(step).item(), want, rtol=1e-6, atol=0)


def test_prefix_inputs_and_pod_compression_raise():
    """A prefix given to a config without a frontend is ignored, as the
    reference ignores it (``repro/models/registry.py:46``). Pod compression
    no longer raises: on one device, which has no pod axis, it changes
    nothing, as the reference's on a mesh without pods (the compressed pod
    reduction itself: tests/test_torch_dist.py, test_torch_compress.py)."""
    m, params, jm, jparams = _models("stablelm-1.6b")
    batch = _batch(m.cfg, batch=2)
    with_prefix = dict(batch, prefix=np.random.RandomState(1).randn(2, 4, m.cfg.d_model).astype(np.float32))
    t = lambda b: {k: torch.from_numpy(v) for k, v in b.items()}
    loss, _ = registry.train_loss(m, params, t(with_prefix))
    assert loss.item() == registry.train_loss(m, params, t(batch))[0].item()
    jloss, _, _ = _jax_loss_and_grads(jm, jparams, with_prefix)
    np.testing.assert_allclose(loss.item(), jloss, **LOSS_TOL)
    states = []
    for compress in (False, True):
        p = tree_map(lambda x: x.clone(), params)
        state = {"params": p, "opt": adamw_init(p), "step": torch.zeros((), dtype=torch.int32)}
        step = make_train_step(m, "cpu", constant_lr(1e-3), global_batch=2, compress_pods=compress)
        states.append(step(state, t(batch))[0])
    assert "compress" not in states[1]
    assert all(torch.equal(a, b) for a, b in zip(tree_leaves(states[0]), tree_leaves(states[1])))


def test_train_state_specs_mirror_the_params():
    m, params, _, _ = _models("internlm2-20b")
    spec = make_train_state_specs(m)
    for name, s, p in zip(_leaf_names(params), tree_leaves(spec["params"]), tree_leaves(params)):
        assert s.device.type == "meta" and s.shape == p.shape and s.dtype == p.dtype, name
    for s, p in zip(tree_leaves(spec["opt"]["m"]), tree_leaves(params)):
        assert s.shape == p.shape and s.dtype == torch.float32
    assert spec["step"].dtype == spec["opt"]["count"].dtype == torch.int32 and spec["step"].dim() == 0

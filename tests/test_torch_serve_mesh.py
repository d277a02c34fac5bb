"""Serving on a DeviceMesh (item 6b) against the port's one-device serve and
against the JAX package, on the CPU.

``flash_decode``'s log-sum-exp first: the plain version's output against the
JAX package's ``flash_decode`` (interpret mode), its lse against the
log-sum-exp of the reference's masked, scaled scores computed with jnp, and
the merge of two and four slices of a cache (``dist.comm.combine_partials``)
against one call over the whole cache, with an empty slice, a slice masked by
position and a wrapped ring among them.

Then the sharded serve on gloo CPU ranks spawned from here (``run_ranks``: a
file-initialised process group under ``tmp_path``, a 120 s timeout, one
thread a rank), one spawn per mesh shape looping over every architecture's
reduced config: prefill and decode steps (teacher-forced with the one-device
run's greedy tokens) on (data 1, model 2), (data 2, model 1) at global
batch 2 and at batch 1 (the slots over ``data``), (data 1, model 4) (the
slots over ``model`` for the six GQA families, whose 2 KV heads do not divide
4), (pod 2, data 1, model 2) and (data 2, model 2) at global batch 1 with
one KV head (the slots over ``data`` and ``model`` together, cut in the
mesh's order). The gathered logits must equal the port's
one-device serve within ``tests/test_torch_serve.py``'s f32 tolerance, the
greedy tokens must be the same, and every rank's cache shard must have the
local shape ``pspec_for_axes`` gives. The reduced mixtral (window 64) takes a
prompt of 48 and decodes past its ring's wrap on the batch-1 and model-4
meshes. stablelm and jamba also serve on (data 1, model 2) with the JAX
package's weights (``params_from_jax``), against its one-device ``prefill``
and ``decode_step``. The spawned module imports neither JAX nor the
reference: the tests that need them import them.
"""

from __future__ import annotations

import dataclasses
import functools
import time

import numpy as np
import pytest
import torch

from repro_torch.configs import ARCH_IDS, get_config
from repro_torch.kernels.ref import reference_decode, split_decode_reference

ARCHS = list(ARCH_IDS)
# tests/test_torch_serve.py's f32 tolerance for logits after the whole trunk
LOGIT_TOL = dict(rtol=1e-4, atol=1e-4)
# tests/test_torch_kernels.py's f32 kernel tolerance; a merge of f32 partials
MERGE_TOL = dict(rtol=1e-5, atol=1e-5)
PROMPT, STEPS, MAX_LEN = 12, 6, 32  # 32 slots: 8 a rank over 4, so the last slices start empty
RING = dict(prompt=48, steps=20, max_len=76)  # mixtral's ring of 64 slots wraps at the 17th step
# (mesh shape, global batch): one spawn each
MESHES = {"1x2": ((1, 2), 4), "2x1": ((2, 1), 2), "2x1-b1": ((2, 1), 1), "1x4": ((1, 4), 4),
          "2x1x2": ((2, 1, 2), 4), "2x2-b1": ((2, 2), 1)}
# meshes served with another KV head count: one KV head meets 2 model ranks
# at batch 1, so the serve rules put the slots over model and data together
KV_HEADS = {"2x2-b1": 1}
JAX_ARCHS = ("stablelm-1.6b", "jamba-v0.1-52b")


# ---------------------------------------------------------------------------
# flash_decode's log-sum-exp and the merge of partials
# ---------------------------------------------------------------------------

# (B, S, H, KVH, Dh, window, n_valid, q_pos, slots): phase 2's decode cases
# at CPU sizes: dense, a window, a wrapped ring's positions, gq 8
LSE_CASES = [
    (2, 256, 8, 2, 64, 0, 200, 199, "cache"),
    (1, 300, 4, 4, 32, 0, 300, 299, "cache"),
    (2, 128, 4, 1, 64, 48, 100, 99, "cache"),
    (1, 64, 8, 2, 64, 0, 10, 9, "cache"),
    (2, 64, 4, 2, 32, 64, 64, 100, "ring:13"),
    (2, 96, 16, 2, 16, 0, 80, 79, "cache"),
]


def _decode_inputs(seed, B, S, H, KVH, Dh, nv, qp, slots):
    rng = np.random.RandomState(seed)
    q, k, v = (rng.randn(B, L, n, Dh).astype(np.float32) for L, n in ((1, H), (S, KVH), (S, KVH)))
    kpos = np.arange(S, dtype=np.int32)
    if slots.startswith("ring:"):
        kpos = np.roll(kpos + (qp - S + 1), int(slots[5:]))
    kpos = np.broadcast_to(kpos[None], (B, S)).copy()
    return q, k, v, kpos, np.full((B,), qp, np.int32), np.full((B,), nv, np.int32)


@pytest.mark.parametrize("B,S,H,KVH,Dh,window,nv,qp,slots", LSE_CASES)
def test_reference_decode_lse_matches_jax(B, S, H, KVH, Dh, window, nv, qp, slots):
    import jax.numpy as jnp

    from repro.kernels.flash_decode import flash_decode as pallas_decode

    arrays = _decode_inputs(2, B, S, H, KVH, Dh, nv, qp, slots)
    out, lse = reference_decode(*map(torch.from_numpy, arrays), window=window, return_lse=True)
    assert out.dtype == torch.float32 and lse.shape == (B, H) and lse.dtype == torch.float32
    pallas = pallas_decode(*map(jnp.asarray, arrays), window=window, block_kv=32)
    np.testing.assert_allclose(out.numpy(), np.asarray(pallas), **MERGE_TOL)
    # the reference's mask (repro/models/attention.py:291-306), its scores with jnp
    q, k, _, kpos, qpos, nval = map(jnp.asarray, arrays)
    s = jnp.einsum("bqhgd,bkhd->bhgqk", q.reshape(B, 1, KVH, H // KVH, Dh), k) * Dh**-0.5
    ok = (kpos[:, None, :] <= qpos[:, None, None]) & (jnp.arange(S)[None, None, :] < nval[:, None, None])
    if window > 0:
        ok &= kpos[:, None, :] > (qpos[:, None, None] - window)
    s = s + jnp.where(ok, 0.0, -2.0e38)[:, None, None]
    want = jnp.log(jnp.sum(jnp.exp(s - s.max(-1, keepdims=True)), -1)) + s.max(-1)
    np.testing.assert_allclose(lse.numpy(), np.asarray(want).reshape(B, H), **MERGE_TOL)
    # the kernel's own split and merge, modelled, gives the same lse
    _, split_lse = split_decode_reference(*map(torch.from_numpy, arrays), window=window, n_split=3, return_lse=True)
    np.testing.assert_allclose(split_lse.numpy(), lse.numpy(), **MERGE_TOL)


def test_reference_decode_empty_row_gives_zero_and_neg_inf():
    from repro_torch.models.common import NEG_INF

    q, k, v, kpos, qpos, nval = map(torch.from_numpy, _decode_inputs(4, 2, 32, 4, 2, 16, 5, 4, "cache"))
    nval[1] = 0
    out, lse = reference_decode(q, k, v, kpos, qpos, nval, return_lse=True)
    assert torch.equal(out[1], torch.zeros_like(out[1])) and bool((lse[1] == NEG_INF).all())
    assert bool((out[0] != 0).any()) and bool((lse[0] > -1e30).all())
    _, split_lse = split_decode_reference(q, k, v, kpos, qpos, nval, n_split=2, return_lse=True)
    assert bool((split_lse[1] == NEG_INF).all())


# (S, window, n_valid, q_pos, slots): the hazards of a split cache
MERGE_CASES = {
    "dense": (64, 0, 64, 63, "cache"),
    "empty_slice": (64, 0, 20, 19, "cache"),  # the last slices hold no written slot
    "masked_slice": (64, 16, 64, 63, "cache"),  # the window masks the first slices whole
    "wrapped_ring": (64, 64, 64, 100, "ring:13"),  # the newest slot sits mid-cache
}


@pytest.mark.parametrize("n", [2, 4])
@pytest.mark.parametrize("case", list(MERGE_CASES))
def test_merged_slices_equal_one_call(case, n):
    from repro_torch.dist.comm import combine_partials
    from repro_torch.kernels.flash_decode import flash_decode

    S, window, nv, qp, slots = MERGE_CASES[case]
    B, H, KVH, Dh = 2, 8, 2, 32
    q, k, v, kpos, qpos, nval = map(torch.from_numpy, _decode_inputs(6, B, S, H, KVH, Dh, nv, qp, slots))
    whole = flash_decode(q, k, v, kpos, qpos, nval, window=window)
    part = S // n
    outs, lses = [], []
    for r in range(n):
        cut = slice(r * part, (r + 1) * part)
        o, lse = flash_decode(q, k[:, cut].contiguous(), v[:, cut].contiguous(), kpos[:, cut].contiguous(), qpos,
                              (nval - r * part).clamp(0, part), window=window, return_lse=True,
                              out_dtype=torch.float32)
        outs.append(o)
        lses.append(lse)
    merged = combine_partials(torch.stack(outs), torch.stack(lses))
    assert torch.isfinite(merged).all()
    np.testing.assert_allclose(merged.numpy(), whole.numpy(), **MERGE_TOL)
    if case == "empty_slice":
        assert bool((lses[-1] < -1e38).all())  # NEG_INF: weighed 0


# ---------------------------------------------------------------------------
# the sharded serve on spawned gloo ranks
# ---------------------------------------------------------------------------


def _mesh(world: int, shape: tuple):
    from torch.distributed.device_mesh import DeviceMesh

    names = ("data", "model") if len(shape) == 2 else ("pod", "data", "model")
    return DeviceMesh("cpu", torch.arange(world).reshape(shape), mesh_dim_names=names)


def _plan(arch: str, ring: bool, kv_heads=None):
    cfg = get_config(arch).reduced()
    if kv_heads:
        cfg = dataclasses.replace(cfg, n_kv_heads=kv_heads)
    prompt, steps, max_len = (RING["prompt"], RING["steps"], RING["max_len"]) if ring else (PROMPT, STEPS, MAX_LEN)
    if cfg.frontend == "vision":
        max_len += cfg.frontend_len
    return cfg, prompt, steps, max_len


def _inputs(cfg, batch: int, prompt: int, seed: int = 7):
    g = torch.Generator().manual_seed(seed)
    tokens = torch.randint(0, cfg.vocab, (batch, prompt), generator=g)
    frames = torch.randn(batch, cfg.frontend_len, cfg.d_model, generator=g) if cfg.encoder_layers else None
    prefix = torch.randn(batch, cfg.frontend_len, cfg.d_model, generator=g) if cfg.frontend == "vision" else None
    return tokens, frames, prefix


def _serve(prefill_fn, decode_fn, params, state, tokens, frames, prefix, steps, forced=None, gather=None):
    """Logits (B, 1 + steps, V) of a prefill and ``steps`` decode steps, fed
    the greedy tokens, or ``forced`` (B, steps) tokens where given."""
    gather = gather or (lambda t: t)
    lg, state = prefill_fn(params, tokens, state, frames, prefix)
    out = [gather(lg)]
    for t in range(steps):
        tok = out[-1].argmax(-1)[:, None] if forced is None else forced[:, t : t + 1]
        lg, state = decode_fn(params, tok, state)
        out.append(gather(lg))
    return torch.stack(out, dim=1), state


def _local_shapes_ok(cfg, mesh, batch: int, max_len: int, state) -> list:
    """The cache leaves whose shard's shape is not the one ``pspec_for_axes``
    of the serve rules gives."""
    from repro_torch.dist.sharding import cache_logical_axes, make_rules, mesh_shape, pspec_for_axes
    from repro_torch.models.registry import build_model

    rules, sizes = make_rules(cfg, mesh, "serve", batch), mesh_shape(mesh)
    bad = []
    meta = build_model(cfg).init_cache(batch, max_len, "meta")
    for i, (axes, c, got) in enumerate(zip(cache_logical_axes(cfg, max_len), meta, state["caches"])):
        for key, ax in axes.items():
            if key == "index":
                continue
            spec = pspec_for_axes(ax, tuple(c[key].shape), rules, mesh)
            want = tuple(d // int(np.prod([sizes[a] for a in ((e,) if isinstance(e, str) else (e or ()))]))
                         for d, e in zip(c[key].shape, spec))
            if tuple(got[key].shape) != want:
                bad.append((i, key, tuple(got[key].shape), want))
    return bad


def _serve_ranks(rank, world, shape, batch, kv_heads, archs, jax_params):
    """One rank of a spawned mesh: each architecture served on one device and
    on the mesh, the mesh teacher-forced with the one-device greedy tokens."""
    from repro_torch.dist.step import gather_full, make_serve_fns, place_serve_params
    from repro_torch.models.registry import build_model, init_serve_state

    mesh = _mesh(world, shape)
    out = {}
    for arch in archs:
        t0 = time.time()
        ring = arch == "mixtral-8x7b" and (batch == 1 or shape[-1] == 4)
        cfg, prompt, steps, max_len = _plan(arch, ring, kv_heads)
        model = build_model(cfg)
        params = model.init(0, "cpu")
        tokens, frames, prefix = _inputs(cfg, batch, prompt)
        fns = make_serve_fns(model, "cpu", max_len=max_len, global_batch=batch)
        one, one_state = _serve(*fns, params, init_serve_state(model, batch, max_len, "cpu"), tokens, frames, prefix,
                                steps)
        forced = one.argmax(-1)[:, :steps]
        prefill_fn, decode_fn, shapes, shards = make_serve_fns(model, mesh, max_len=max_len, global_batch=batch)
        placed = place_serve_params(params, shards, mesh)
        state = init_serve_state(model, batch, max_len, mesh)
        bad_shapes = _local_shapes_ok(cfg, mesh, batch, max_len, state)
        got, state = _serve(prefill_fn, decode_fn, placed, state, tokens, frames, prefix, steps, forced, gather_full)
        cache_gap = _cache_gap(state, one_state, shards, mesh)
        res = {"diff": float((got - one).abs().max()), "scale": float(one.abs().max()),
               "close": bool(torch.allclose(got, one, **LOGIT_TOL)), "tokens": bool(torch.equal(got.argmax(-1),
                                                                                               one.argmax(-1))),
               "bad_shapes": bad_shapes, "cache_gap": cache_gap, "t": state["t"], "want_t": prompt + steps + (cfg.frontend_len if prefix
                                                                                     is not None else 0),
               "split": [c.get("split") for c in state["caches"]], "seconds": time.time() - t0}
        if ring:
            res["index"] = state["caches"][0]["index"]
        out[arch] = res
    if shape == (1, 2):
        out["entry"] = _entry_points(mesh)
    for arch, (params, tokens, steps) in (jax_params or {}).items():
        cfg = get_config(arch).reduced()
        model = build_model(cfg)
        prefill_fn, decode_fn, _, shards = make_serve_fns(model, mesh, max_len=MAX_LEN, global_batch=tokens.shape[0])
        state = init_serve_state(model, tokens.shape[0], MAX_LEN, mesh)
        got, _ = _serve(prefill_fn, decode_fn, place_serve_params(params, shards, mesh), state,
                        tokens[:, :PROMPT], None, None, steps, tokens[:, PROMPT:], gather_full)
        out["jax", arch] = got
    return out


def _cache_gap(state, one_state, shards, mesh) -> float:
    """The largest gap between the mesh's caches, each put together from the
    ranks' shards by its placements (slots split over several axes cut in
    the mesh's order), and the one-device run's caches."""
    from torch.distributed.tensor import DTensor

    gap = 0.0
    for local, whole, placements in zip(state["caches"], one_state["caches"], shards["state"]["caches"]):
        for key, pl in placements.items():
            full = DTensor.from_local(local[key], mesh, pl, run_check=False).full_tensor()
            if full.shape != whole[key].shape:
                return float("inf")
            gap = max(gap, float((full.double() - whole[key].double()).abs().max()))
    return gap


def _entry_points(mesh) -> dict:
    """The entry points a user calls, on the (data 1, model 2) process group:
    ``launch.serve.main(["--model", "2", ...])`` and ``MeshExecutor(...,
    mode="serve").serve_fns``, against the one-device greedy tokens."""
    import contextlib
    import io

    from repro_torch.dist.step import gather_full, place_serve_params
    from repro_torch.launch import serve
    from repro_torch.models.registry import build_model, greedy_generate, init_serve_state
    from repro_torch.optim.adamw import tree_leaves
    from repro_torch.workspace import MeshExecutor

    cfg = get_config("jamba-v0.1-52b").reduced()
    model = build_model(cfg)
    with contextlib.redirect_stdout(io.StringIO()) as printed:
        got = serve.main(["--arch", cfg.name[: -len("-smoke")], "--reduced", "--batch", "2", "--prompt-len", "8",
                          "--gen", "4", "--device", "cpu", "--model", "2"])
    prompts = serve.make_prompts(cfg.vocab, 2, 8, 1, "cpu")
    want = greedy_generate(model, model.init(0, "cpu"), prompts, 4, serve.serve_max_len(cfg, 8, 4))
    ex = MeshExecutor(mesh, cfg=cfg, mode="serve", global_batch=2)
    prefill_fn, _, _, shards = ex.serve_fns(model, max_len=16)
    placed = place_serve_params(model.init(0, "cpu"), shards, mesh)
    lg, _ = prefill_fn(placed, prompts, init_serve_state(model, 2, 16, mesh))
    locals_ = [t.to_local() for t in tree_leaves(placed)]
    held = sum(t.untyped_storage().nbytes() for t in locals_)  # no shard keeps its whole leaf alive
    from repro_torch.launch.mesh import make_host_mesh

    try:  # a mesh of cards asked for where there is none raises: nothing falls back to the CPU
        make_host_mesh(model=2, device="cuda")
        cuda_raises = torch.cuda.is_available()
    except RuntimeError as e:
        cuda_raises = "CUDA is not available" in str(e)
    return {"serve_main": bool(torch.equal(got, want)), "printed": printed.getvalue(),
            "executor": bool(torch.equal(gather_full(lg).argmax(-1), want[:, 0])), "rules": ex.rules,
            "cuda_raises": cuda_raises, "held": held, "shards": sum(t.numel() * t.element_size() for t in locals_),
            "whole": sum(t.numel() * t.element_size() for t in tree_leaves(model.init(0, "meta")))}


@functools.lru_cache(maxsize=None)
def _spawned(mesh_id: str, workdir: str):
    from repro_torch.dist.spawn import run_ranks

    shape, batch = MESHES[mesh_id]
    world = int(np.prod(shape))
    jax_params = _jax_case()[0] if mesh_id == "1x2" else None
    return run_ranks(_serve_ranks, world, workdir, shape, batch, KV_HEADS.get(mesh_id), ARCHS, jax_params, timeout=120)


@functools.lru_cache(maxsize=None)
def _jax_case():
    """({arch: (the JAX weights in the port's layout, tokens (B, PROMPT +
    STEPS), STEPS)}, {arch: the JAX package's one-device logits (B, 1 +
    STEPS, V)}) for stablelm and jamba, f32."""
    import jax
    import jax.numpy as jnp

    from repro.configs import get_config as jax_get_config
    from repro.models import registry as jax_registry
    from repro_torch.models.convert import params_from_jax

    cases, logits = {}, {}
    for arch in JAX_ARCHS:
        jcfg = jax_get_config(arch).reduced()
        jm = jax_registry.build_model(jcfg)
        jparams, _ = jm.init(jax.random.key(3))
        toks = np.random.RandomState(5).randint(0, jcfg.vocab, size=(4, PROMPT + STEPS)).astype(np.int32)
        jstate = jax_registry.init_serve_state(jm, 4, MAX_LEN)
        jlg, jstate = jax_registry.prefill(jm, jparams, jnp.asarray(toks[:, :PROMPT]), jstate)
        jdecode = jax.jit(lambda p, tok, st: jax_registry.decode_step(jm, p, tok, st))
        out = [np.asarray(jlg)]
        for t in range(PROMPT, PROMPT + STEPS - 1):
            jlg, jstate = jdecode(jparams, jnp.asarray(toks[:, t : t + 1]), jstate)
            out.append(np.asarray(jlg))
        logits[arch] = np.stack(out, axis=1)
        params = params_from_jax(get_config(arch).reduced(), jax.tree.map(np.asarray, jparams), device="cpu")
        cases[arch] = (params, torch.from_numpy(toks).long(), STEPS - 1)
    return cases, logits


@pytest.fixture(scope="module")
def spawned(tmp_path_factory):
    base = tmp_path_factory.mktemp("serve_ranks")
    return lambda mesh_id: _spawned(mesh_id, str(base / mesh_id))


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("mesh_id", list(MESHES))
def test_sharded_serve_matches_one_device(spawned, mesh_id, arch):
    for rank, out in enumerate(spawned(mesh_id)):
        res = out[arch]
        assert res["close"], f"rank {rank}: max |logit diff| {res['diff']} (logits up to {res['scale']})"
        assert res["tokens"], f"rank {rank}: greedy tokens differ"
        assert res["bad_shapes"] == [], f"rank {rank}: cache shards of another shape {res['bad_shapes']}"
        # the shards, put together by their placements, are the one-device caches
        assert res["cache_gap"] <= LOGIT_TOL["atol"], f"rank {rank}: caches differ by {res['cache_gap']}"
        assert res["t"] == res["want_t"]


def test_flash_decoding_fallback_splits_the_slots(spawned):
    """Which caches split their slots, over which axes: the slots go over
    ``data`` at batch 1, over ``model`` where 2 KV heads meet 4 ranks, and
    over both (in the mesh's order) where 1 KV head meets 2 ranks at batch
    1; a ring wraps on all three."""
    gqa = {"internlm2-20b", "internvl2-1b", "jamba-v0.1-52b", "mixtral-8x7b", "phi3.5-moe-42b", "qwen2.5-32b"}
    attending = set(ARCHS) - {"falcon-mamba-7b"}
    for mesh_id, axes, archs in (("2x1-b1", ("data",), attending), ("1x4", ("model",), gqa),
                                 ("2x2-b1", ("data", "model"), attending), ("1x2", None, set()),
                                 ("2x1x2", None, set())):
        shape = MESHES[mesh_id][0]
        sizes = dict(zip(("data", "model") if len(shape) == 2 else ("pod", "data", "model"), shape))
        for rank, out in enumerate(spawned(mesh_id)):
            for arch in ARCHS:
                splits = {s for s in out[arch]["split"] if s is not None}
                if arch in archs:
                    n = int(np.prod([sizes[a] for a in axes]))
                    assert splits == {(rank % n, axes)}, (mesh_id, arch, splits)
                else:
                    assert splits == set(), (mesh_id, arch, splits)
            if mesh_id in ("2x1-b1", "1x4", "2x2-b1"):
                assert out["mixtral-8x7b"]["index"] == RING["prompt"] + RING["steps"] > 64  # past the wrap


def test_entry_points_serve_on_a_mesh(spawned):
    from repro_torch.dist.sharding import make_rules

    for rank, out in enumerate(spawned("1x2")):
        res = out["entry"]
        assert res["serve_main"] and res["executor"] and res["cuda_raises"], res
        assert res["rules"] == make_rules(get_config("jamba-v0.1-52b").reduced(), _Shape((1, 2)), "serve", 2)
        assert ("tok/s" in res["printed"]) == (rank == 0)  # rank 0 prints
        # the placed params hold their shards alone: experts, Mamba channels
        # and vocab rows split, the rest whole
        assert res["held"] == res["shards"] < 0.7 * res["whole"], res


class _Shape:
    def __init__(self, shape):
        self.shape = dict(zip(("data", "model"), shape))


def test_sharded_serve_matches_jax(spawned):
    _, want = _jax_case()
    for rank, out in enumerate(spawned("1x2")):
        for arch in JAX_ARCHS:
            np.testing.assert_allclose(out["jax", arch].numpy(), want[arch], err_msg=f"rank {rank} {arch}",
                                       **LOGIT_TOL)

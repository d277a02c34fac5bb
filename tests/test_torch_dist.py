"""The port's distribution layer against the JAX package and against its own
one-device step.

Rules and specs: ``make_rules``, ``pspec_for_axes`` (over every leaf of the
params, the train state and the caches), the param axes tree and
``cache_logical_axes`` equal the reference's, for all ten architectures at
full size, in train and serve, on six meshes and four global batches. The
reference reads only ``mesh.shape``, so a stand-in with a ``.shape`` dict
drives both packages with no devices.

Numerics: the reference never runs a step across devices; the port's
sharded step runs on gloo CPU ranks spawned from here (``run_ranks``: a
file-initialised process group under ``tmp_path``, a 120 s timeout, one
thread a rank, a rank's exception re-raised here), one spawn per mesh shape
looping over the cases. Every architecture's reduced config takes two steps
on (data 2, model 2) and on (pod 2, data 1, model 2), and its loss and
gathered params must equal the one-device port step's (which
``test_torch_train.py`` holds against JAX) within that file's f32
tolerances. The spawned module imports neither JAX nor the reference: they
are imported inside the tests that need them.
"""

from __future__ import annotations

import dataclasses
import functools
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

from repro_torch.configs import ARCH_IDS, get_config

ARCHS = list(ARCH_IDS)
MESH_SHAPES = [(1, 1), (2, 2), (4, 1), (1, 4), (16, 16), (2, 16, 16)]
BATCHES = [None, 1, 8, 256]
MODES = ["train", "serve"]
MAX_LEN = 4096

# test_torch_train.py's f32 tolerances: the step's loss, and the params after
# AdamW steps (an element whose first moment sits below NOISE_REL of its
# leaf's largest may step the other way, up to 2 lr a step)
LOSS_TOL = dict(rtol=1e-6, atol=1e-5)
METRIC_TOL = dict(rtol=2e-3, atol=1e-6)
PARAM_TOL = dict(rtol=1e-4, atol=2e-5)
NOISE_REL = 1e-4
LR = 1e-3
B, L = 4, 16


class _Mesh:
    """A mesh that does not exist: its name -> size mapping alone."""

    def __init__(self, shape: tuple):
        names = ("data", "model") if len(shape) == 2 else ("pod", "data", "model")
        self.shape = dict(zip(names, shape))


def _mesh_id(shape) -> str:
    return "x".join(map(str, shape))


# ---------------------------------------------------------------------------
# rules, specs and axes trees against the reference
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def _trees(arch: str):
    """(port, reference) of: param axes, train-state (axes, shapes), cache
    (axes, shapes) per layer; the reference's mapped to the port's layout
    with each stacked leaf's leading "layers" entry checked and dropped."""
    import jax

    from repro.configs import get_config as jax_get_config
    from repro.dist.sharding import cache_logical_axes as jax_cache_axes
    from repro.dist.step import make_train_state_specs as jax_state_specs
    from repro.models.transformer import Model as JaxModel
    from repro_torch.dist.sharding import cache_logical_axes
    from repro_torch.dist.step import make_train_state_specs
    from repro_torch.models.transformer import Model

    cfg, jcfg = get_config(arch), jax_get_config(arch)
    port_state, port_axes = make_train_state_specs(Model(cfg), with_axes=True)
    jstate, jaxes = jax_state_specs(JaxModel(jcfg))
    caches = Model(cfg).init_cache(8, MAX_LEN, "meta")
    jcaches = jax.eval_shape(lambda: JaxModel(jcfg).init_cache(8, MAX_LEN))
    return {
        "cfg": cfg, "port_state": port_state, "port_axes": port_axes, "ref_state": jstate, "ref_axes": jaxes,
        "port_cache_axes": cache_logical_axes(cfg, MAX_LEN), "ref_cache_axes": jax_cache_axes(jcfg, MAX_LEN),
        "port_caches": caches, "ref_caches": jcaches,
    }


def _walk(fn, axes, shapes):
    if isinstance(axes, tuple):
        return fn(axes, getattr(shapes, "shape", ()))
    if isinstance(axes, dict):
        return {k: _walk(fn, axes[k], shapes[k]) for k in axes}
    return [_walk(fn, a, s) for a, s in zip(axes, shapes)]


def _stacked_to_port(cfg, tree):
    """A reference params-layout tree (leaves: per-leaf values of stacked
    leaves, tuples) in the port's layout, the leading entry dropped."""
    from repro_torch.models.convert import _unstack

    def layer(x, _):
        assert x[0] is None or x[0] == "layers", x
        return tuple(x[1:])

    return _unstack(cfg, tree, tuple, layer)


def _ref_cache_to_port(cfg, ref):
    return [{k: tuple(v[1:]) for k, v in ref[i % len(cfg.layout)].items()} for i in range(cfg.n_layers)]


@pytest.mark.parametrize("arch", ARCHS)
def test_param_axes_tree_matches_reference(arch):
    t = _trees(arch)
    from repro_torch.models.convert import axes_from_jax

    assert t["port_axes"]["params"] == axes_from_jax(t["cfg"], t["ref_axes"]["params"])
    assert t["port_axes"]["opt"]["m"] == t["port_axes"]["params"] and t["port_axes"]["step"] == ()


@pytest.mark.parametrize("arch", ARCHS)
def test_cache_logical_axes_match_reference(arch):
    t = _trees(arch)
    assert t["port_cache_axes"] == _ref_cache_to_port(t["cfg"], t["ref_cache_axes"])
    # and they mirror the port's caches leaf for leaf
    for axes, cache in zip(t["port_cache_axes"], t["port_caches"]):
        assert set(axes) == set(cache)
        for k, a in axes.items():
            assert len(a) == len(getattr(cache[k], "shape", ())), k


@pytest.mark.parametrize("batch", BATCHES, ids=lambda b: f"b{b}")
@pytest.mark.parametrize("mesh", MESH_SHAPES, ids=_mesh_id)
@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("arch", ARCHS)
def test_rules_and_specs_match_reference(arch, mode, mesh, batch):
    from repro.configs import get_config as jax_get_config
    from repro.dist.sharding import make_rules as jax_make_rules
    from repro.dist.sharding import pspec_for_axes as jax_pspec
    from repro_torch.dist.sharding import make_rules, pspec_for_axes

    t = _trees(arch)
    cfg, m = t["cfg"], _Mesh(mesh)
    rules = make_rules(cfg, m, mode, batch)
    assert rules == jax_make_rules(jax_get_config(arch), m, mode, batch)

    port = lambda ax, shape: pspec_for_axes(ax, tuple(shape), rules, m)
    ref = lambda ax, shape: tuple(jax_pspec(ax, tuple(shape), rules, m))
    for part in ("params", "m", "v"):
        pa = t["port_axes"]["params"]
        ps = t["port_state"]["params"] if part == "params" else t["port_state"]["opt"][part]
        ra = t["ref_axes"]["params"]
        rs = t["ref_state"]["params"] if part == "params" else t["ref_state"]["opt"][part]
        assert _walk(port, pa, ps) == _stacked_to_port(cfg, _walk(ref, ra, rs)), part
    for part in (("opt", "count"), ("step",)):
        pa, ra = t["port_axes"], t["ref_axes"]
        for k in part:
            pa, ra = pa[k], ra[k]
        assert port(pa, ()) == ref(ra, ()) == ()
    port_caches = _walk(port, t["port_cache_axes"], t["port_caches"])
    ref_caches = _walk(ref, t["ref_cache_axes"], t["ref_caches"])
    assert port_caches == _ref_cache_to_port(cfg, ref_caches)


def test_placements_follow_the_spec():
    from torch.distributed.tensor import Replicate, Shard

    from repro_torch.dist.sharding import placements_for

    m = _Mesh((2, 16, 16))
    assert placements_for((("pod", "data"), None), m) == (Shard(0), Shard(0), Replicate())
    assert placements_for(("model", "data"), m) == (Replicate(), Shard(1), Shard(0))
    with pytest.raises(ValueError, match="order"):
        placements_for((("data", "pod"),), m)


def test_production_mesh_on_the_fake_backend():
    """make_production_mesh builds (16, 16) and (2, 16, 16) on torch's fake
    backend in one process (run apart: it starts a process group), and the
    rules and placements of a full-size config derive on it."""
    code = (
        "from repro_torch.launch.mesh import make_production_mesh\n"
        "from repro_torch.dist import make_rules\n"
        "from repro_torch.configs import get_config\n"
        "m = make_production_mesh(multi_pod=True, fake=True)\n"
        "r = make_rules(get_config('mixtral-8x7b'), m, 'train', 256)\n"
        "print(tuple(m.shape), m.mesh_dim_names, r['batch'], r['experts'], r['embed'])\n"
    )
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, timeout=120,
                         env=_env())
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().splitlines()[-1] == "(2, 16, 16) ('pod', 'data', 'model') ('pod', 'data') None data"


def _env():
    import os

    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(p for p in sys.path if p)
    return env


# ---------------------------------------------------------------------------
# the sharded train step on spawned gloo ranks
# ---------------------------------------------------------------------------

# (case id, arch, config overrides, step options); every case runs on both
# meshes. "drops": capacity bins that overflow (moe_exact_tokens 16 and
# capacity_factor 0.5, as test_torch_train.py's capacity-drop case);
# "mlp_tp": 3 experts on a model axis of 2, so the ffn dim splits instead;
# "kv_repl": 1 KV head on a model axis of 2, replicated; "pad_heads": 3
# heads padded to 4 (zero wo rows) for the model axis. jamba's variants
# run one layout period (8 layers: Mamba, attention, MoE).
CASES = [(a, a, {}, {}) for a in ARCHS] + [
    ("mixtral-drops", "mixtral-8x7b", dict(moe_exact_tokens=16, capacity_factor=0.5), {}),
    ("jamba-drops", "jamba-v0.1-52b", dict(n_layers=8, moe_exact_tokens=16, capacity_factor=0.5), {}),
    ("phi-groups2-drops", "phi3.5-moe-42b", dict(moe_groups=2, moe_exact_tokens=8, capacity_factor=0.5), {}),
    ("mixtral-groups4", "mixtral-8x7b", dict(moe_groups=4), {}),
    ("mixtral-mlp_tp", "mixtral-8x7b", dict(n_experts=3, moe_exact_tokens=16, capacity_factor=0.5), {}),
    ("qwen-kv_repl", "qwen2.5-32b", dict(n_kv_heads=1), {}),
    ("qwen-pad_heads", "qwen2.5-32b", dict(n_heads=3, pad_heads=1, n_kv_heads=1), {}),
    ("stablelm-micro2", "stablelm-1.6b", {}, dict(microbatches=2)),
    ("jamba-remat_block", "jamba-v0.1-52b", dict(n_layers=8, remat="block"), {}),
    ("seamless-remat_full", "seamless-m4t-medium", dict(remat="full"), {}),
    ("jamba-micro2", "jamba-v0.1-52b", dict(n_layers=8), dict(microbatches=2)),
    ("stablelm-remat_block4", "stablelm-1.6b", dict(n_layers=4, remat="block"), {}),
]
SPAWN_MESHES = {"2x2": (2, 2), "2x1x2": (2, 1, 2)}


def _config(arch, over):
    return dataclasses.replace(get_config(arch).reduced(), **over)


def _batches(cfg, n=2, seed=1):
    g = torch.Generator().manual_seed(seed)
    out = []
    for _ in range(n):
        b = {"tokens": torch.randint(0, cfg.vocab, (B, L), generator=g, dtype=torch.int32),
             "labels": torch.randint(0, cfg.vocab, (B, L), generator=g, dtype=torch.int32)}
        if cfg.encoder_layers:
            b["frames"] = torch.randn(B, cfg.frontend_len, cfg.d_model, generator=g)
        if cfg.frontend == "vision":
            b["prefix"] = torch.randn(B, cfg.frontend_len, cfg.d_model, generator=g)
        out.append(b)
    return out


def _fresh(model):
    from repro_torch.optim import adamw_init

    p = model.init(0, "cpu")
    return {"params": p, "opt": adamw_init(p), "step": torch.zeros((), dtype=torch.int32)}


def _far_elements(got, want, m) -> int:
    """Elements of one leaf outside PARAM_TOL and above the noise floor."""
    diff = (got.float() - want.float()).abs()
    far = diff > PARAM_TOL["atol"] + PARAM_TOL["rtol"] * want.float().abs()
    noise = m.abs() <= NOISE_REL * m.abs().max()
    return int((far & ~noise).sum()) + int(diff.max() > 2 * 2 * LR)


def _moe_dispatch_check(cfg, mesh, rules, seed=3):
    """moe_ffn of one layer's weights under the mesh's rules (this rank's
    rows and expert or ffn shards) against the one-device call: y of this
    rank's rows, the aux loss and dropped_frac."""
    from repro_torch.dist.comm import parallel_of
    from repro_torch.models import moe
    from repro_torch.models.common import axis_rules

    g = torch.Generator().manual_seed(seed)
    d, f, E = cfg.d_model, cfg.d_ff, cfg.n_experts
    p = {"router": torch.randn(d, E, generator=g) * d**-0.5, "w_gate": torch.randn(E, d, f, generator=g) * d**-0.5,
         "w_up": torch.randn(E, d, f, generator=g) * d**-0.5, "w_down": torch.randn(E, f, d, generator=g) * f**-0.5}
    x = torch.randn(B, L, d, generator=g)
    y1, m1 = moe.moe_ffn(p, cfg, x)
    par = parallel_of(rules, mesh)
    rows = B // par.dp
    xs = x[par.dp_rank * rows : (par.dp_rank + 1) * rows]
    ps = dict(p)
    if par.sharded("experts"):
        e = E // par.tp
        ps.update({k: p[k][par.tp_rank * e : (par.tp_rank + 1) * e] for k in ("w_gate", "w_up", "w_down")})
        ps["router"] = p["router"][:, par.tp_rank * e : (par.tp_rank + 1) * e]
    elif par.sharded("mlp"):
        n = f // par.tp
        ps.update({"w_gate": p["w_gate"][:, :, par.tp_rank * n : (par.tp_rank + 1) * n],
                   "w_up": p["w_up"][:, :, par.tp_rank * n : (par.tp_rank + 1) * n],
                   "w_down": p["w_down"][:, par.tp_rank * n : (par.tp_rank + 1) * n]})
    with axis_rules(rules, mesh):
        y2, m2 = moe.moe_ffn(ps, cfg, xs)
    return {"y": float((y2 - y1[par.dp_rank * rows : (par.dp_rank + 1) * rows]).abs().max()),
            "aux": (float(m1["aux_loss"]), float(m2["aux_loss"])),
            "dropped": (float(m1["dropped_frac"]), float(m2["dropped_frac"]))}


def _train_ranks(rank, world, shape, cases):
    """One rank of a spawned mesh: each case's two sharded steps beside the
    one-device steps, with what the tests compare."""
    from repro_torch.dist.comm import track_gathers
    from repro_torch.dist.sharding import make_rules
    from repro_torch.dist.step import gather_state, make_train_step, place_state
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models.registry import build_model
    from repro_torch.optim import cosine_warmup
    from repro_torch.optim.adamw import tree_leaves

    if len(shape) == 2:
        mesh = make_host_mesh(model=shape[1], device="cpu")
        assert tuple(mesh.shape) == shape
    else:
        from torch.distributed.device_mesh import DeviceMesh

        mesh = DeviceMesh("cpu", torch.arange(world).reshape(shape), mesh_dim_names=("pod", "data", "model"))
    out = {}
    for name, arch, over, opts in cases:
        t0 = time.time()
        cfg = _config(arch, over)
        model = build_model(cfg)
        batches = _batches(cfg)
        one = make_train_step(model, "cpu", cosine_warmup(LR, 1, 4), global_batch=B, **opts)
        step, _, shard, _ = make_train_step(model, mesh, cosine_warmup(LR, 1, 4), global_batch=B, **opts)
        s1, s2 = _fresh(model), place_state(_fresh(model), shard, mesh)
        mets, tracks = [], []
        for b in batches:
            s1, m1 = one(s1, b)
            with track_gathers(("pod", "data")) as track:
                s2, m2 = step(s2, b)
            mets.append({k: (float(m1[k]), float(m2[k])) for k in ("loss", "lr", "grad_norm", "clip_scale")})
            tracks.append({"count": track.count, "peak": track.peak, "live": track.live})
        full = gather_state(s2)
        far = {}
        for i, (got, want, m) in enumerate(zip(tree_leaves(full["params"]), tree_leaves(s1["params"]),
                                               tree_leaves(s1["opt"]["m"]))):
            n = _far_elements(got, want, m)
            if n:
                far[i] = n
        res = {"metrics": mets, "far": far, "step": int(full["step"]), "seconds": time.time() - t0,
               "gathers": tracks, "fsdp": _fsdp_budget(cfg, s2["params"])}
        if cfg.n_experts:
            res["moe"] = _moe_dispatch_check(cfg, mesh, make_rules(cfg, mesh, "train", B))
        out[name] = res
    if len(shape) == 3:
        out["compress"] = _compress_case(mesh)
    return out


def _fsdp_budget(cfg, params) -> dict:
    """What FSDP gathers of a placed params tree (``dist.step.fsdp_units``):
    the gathered bytes and number of the leaves outside the trunk, of the
    trunk, and of its largest unit (a layout period or an encoder layer). A
    leaf is gathered over the data axes its placements split it on."""
    from torch.distributed.tensor import Shard

    from repro_torch.dist.step import fsdp_units
    from repro_torch.optim.adamw import tree_leaves

    def gathered(tree):
        n_bytes = n = 0
        for t in tree_leaves(tree):
            k = 1
            for name, pl in zip(t.device_mesh.mesh_dim_names, t.placements):
                if isinstance(pl, Shard) and name in ("pod", "data"):
                    k *= t.device_mesh.size(t.device_mesh.mesh_dim_names.index(name))
            if k > 1:
                n_bytes, n = n_bytes + t.to_local().nbytes * k, n + 1
        return n_bytes, n

    outside, units = fsdp_units(cfg, params)
    trunk = [gathered(u) for u in units]
    return {"outside": gathered(outside), "trunk": tuple(map(sum, zip(*trunk))), "period": max(trunk)}


def _compress_case(mesh):
    """compress_pods on the pod axis: the state gains its residual, the step
    runs, its loss is the uncompressed step's, and the wire carries 2 bytes a
    parameter."""
    from repro_torch.dist.step import gather_state, make_train_step, place_state
    from repro_torch.models.registry import build_model
    from repro_torch.optim import constant_lr
    from repro_torch.optim.adamw import tree_leaves

    cfg = get_config("stablelm-1.6b").reduced()
    model = build_model(cfg)
    step, shapes, shard, _ = make_train_step(model, mesh, constant_lr(LR), global_batch=B, compress_pods=True)
    plain, _, pshard, _ = make_train_step(model, mesh, constant_lr(LR), global_batch=B)
    fresh = _fresh(model)
    fresh["compress"] = {"residual": _zeros_like(fresh["params"])}
    s = place_state(fresh, shard, mesh)
    s0 = place_state(_fresh(model), pshard, mesh)
    b = _batches(cfg, 1)[0]
    s, met = step(s, b)
    s0, met0 = plain(s0, b)
    full, full0 = gather_state(s), gather_state(s0)
    return {"loss": (float(met0["loss"]), float(met["loss"])), "ratio": met["compress_ratio"],
            "wire": met["wire_bytes_per_param"], "keys": sorted(shapes),
            "moved": max(float((a - b).abs().max()) for a, b in zip(tree_leaves(full["params"]),
                                                                      tree_leaves(full0["params"]))),
            "residual": max(float(r.abs().max()) for r in tree_leaves(full["compress"]["residual"]))}


def _zeros_like(tree):
    from repro_torch.optim.adamw import tree_map

    return tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32), tree)


@functools.lru_cache(maxsize=None)
def _spawned(mesh_id: str, workdir: str):
    from repro_torch.dist.spawn import run_ranks

    shape = SPAWN_MESHES[mesh_id]
    return run_ranks(_train_ranks, 4, workdir, shape, CASES, timeout=240)


@pytest.fixture(scope="module")
def spawned(tmp_path_factory):
    base = tmp_path_factory.mktemp("ranks")
    return lambda mesh_id: _spawned(mesh_id, str(base / mesh_id))


@pytest.mark.parametrize("case", [c[0] for c in CASES])
@pytest.mark.parametrize("mesh_id", list(SPAWN_MESHES))
def test_sharded_train_step_matches_one_device(spawned, mesh_id, case):
    ranks = spawned(mesh_id)
    for rank, out in enumerate(ranks):
        res = out[case]
        first, second = res["metrics"]
        np.testing.assert_allclose(first["loss"][1], first["loss"][0], err_msg=f"rank {rank}", **LOSS_TOL)
        for k in ("loss", "lr", "grad_norm", "clip_scale"):
            np.testing.assert_allclose(first[k][1], first[k][0], err_msg=f"rank {rank} {k}", **METRIC_TOL)
            np.testing.assert_allclose(second[k][1], second[k][0], err_msg=f"rank {rank} {k}", **METRIC_TOL)
        assert res["far"] == {}, f"rank {rank}: leaves (index: elements) outside PARAM_TOL {res['far']}"
        assert res["step"] == 2
        if "moe" in res:
            moe = res["moe"]
            assert moe["y"] <= 1e-5, moe
            np.testing.assert_allclose(moe["aux"][1], moe["aux"][0], rtol=1e-6)
            assert moe["dropped"][1] == moe["dropped"][0], moe
            if "drops" in case:
                assert moe["dropped"][0] > 0.1, moe


@pytest.mark.parametrize("case", ["stablelm-remat_block4", "seamless-remat_full", "jamba-remat_block"])
def test_fsdp_gathers_one_layout_period_at_a_time(spawned, case):
    """FSDP on (data 2, model 2) under remat block or full: the gathered
    weights alive at once never exceed one layout period's (or encoder
    layer's) plus the leaves outside the trunk, and every trunk leaf is
    gathered twice a step, in the forward and again in the recompute (so no
    product kept its gathered weight)."""
    for rank, out in enumerate(spawned("2x2")):
        res = out[case]
        (outside, n_outside), (trunk, n_trunk), (period, _) = (res["fsdp"][k] for k in ("outside", "trunk", "period"))
        assert n_trunk > 0 and n_outside > 0, res["fsdp"]
        for track in res["gathers"]:
            assert track["peak"] <= outside + period, (rank, track, res["fsdp"])
            assert track["count"] == n_outside + 2 * n_trunk, (rank, track, res["fsdp"])
            assert track["live"] == 0, (rank, track)  # nothing gathered outlives the step
        if case == "stablelm-remat_block4":  # four periods: the whole trunk was never gathered at once
            assert outside + period < outside + trunk and max(t["peak"] for t in res["gathers"]) == outside + period


def test_pod_compression_in_the_sharded_step(spawned):
    for out in spawned("2x1x2"):
        c = out["compress"]
        assert "compress" in c["keys"]
        np.testing.assert_allclose(c["loss"][1], c["loss"][0], **LOSS_TOL)
        assert c["ratio"] == 4.0 and abs(c["wire"] - 2.0) < 1e-3
        assert 0 < c["moved"] <= 2 * LR and c["residual"] > 0


# ---------------------------------------------------------------------------
# elastic resharding and kv heads over a model axis of 4
# ---------------------------------------------------------------------------


def _launch_train_case(workdir):
    """launch.train.run in the process group: on (data 2, model 2) and on
    (data 4, model 1), each through the make-mode recovery drill (a failure
    at step 1, restored from every rank's own checkpoint): gathered params
    equal within PARAM_TOL, and each rank's checkpoint directory."""
    import contextlib
    import io
    import os

    from repro_torch.dist.step import gather_state
    from repro_torch.launch import train
    from repro_torch.optim.adamw import tree_leaves

    cfg = get_config("stablelm-1.6b").reduced()
    out = []
    for model_axis in (2, 1):
        ckpt = os.path.join(workdir, f"ckpt_model{model_axis}")
        with contextlib.redirect_stdout(io.StringIO()):
            state = train.run(cfg, steps=2, batch=B, seq=L, ckpt_every=1, ckpt_dir=ckpt, fail_at_step=1,
                              device="cpu", model_axis=model_axis)
        out.append((gather_state(state), sorted(os.listdir(ckpt))))
    (a, dirs_a), (b, dirs_b) = out
    diff = max(float((x - y).abs().max()) for x, y in zip(tree_leaves(a["params"]), tree_leaves(b["params"])))
    return {"diff": diff, "step": int(a["step"]), "dirs": dirs_a}


def _remat_thread_case(mesh):
    """The backward of a rematerialised trunk on a thread with no axis rules
    (as autograd's device thread runs it for CUDA tensors): the recompute
    must see the rules of the forward."""
    import threading

    from repro_torch.dist.sharding import make_rules
    from repro_torch.dist.step import make_train_step, placed_train_state
    from repro_torch.models.common import axis_rules
    from repro_torch.models.registry import build_model, train_loss
    from repro_torch.optim.adamw import tree_leaves, tree_map

    cfg = dataclasses.replace(get_config("mixtral-8x7b").reduced(), remat="block")
    model = build_model(cfg)
    _, _, shard, _ = make_train_step(model, mesh, lambda s: torch.tensor(0.0), global_batch=B)
    state = placed_train_state(model.init(0, "cpu"), shard, mesh)
    params = tree_map(lambda t: t.to_local().detach().requires_grad_(), state["params"])
    b = {k: v[: B // 2] for k, v in _batches(cfg, 1)[0].items()}
    with axis_rules(make_rules(cfg, mesh, "train", B), mesh):
        loss, _ = train_loss(model, params, b)
    out = {}

    def backward():
        try:
            out["grads"] = torch.autograd.grad(loss, tree_leaves(params))
        except Exception as e:  # re-raised below, on the rank's own thread
            out["error"] = e

    t = threading.Thread(target=backward)
    t.start()
    t.join()
    if "error" in out:
        raise out["error"]
    return len(out["grads"])


def _serve_on_mesh(mesh):
    """Serving on the resharded (data 2, model 2) mesh against one device: the
    serve fns (prefill and two decode steps fed the one-device greedy tokens,
    the logits gathered), and one cached attention call under the serve rules
    (a decode step into this rank's shard of a cache: its rows and KV heads)."""
    from repro_torch.dist.comm import comm_for
    from repro_torch.dist.sharding import make_rules
    from repro_torch.dist.step import gather_full, make_serve_fns, place_serve_params
    from repro_torch.models import attention
    from repro_torch.models.common import axis_rules
    from repro_torch.models.registry import build_model, init_serve_state
    from repro_torch.optim.adamw import tree_map

    cfg = get_config("stablelm-1.6b").reduced()
    model = build_model(cfg)
    params = model.init(0, "cpu")
    tokens = torch.randint(0, cfg.vocab, (B, 8), generator=torch.Generator().manual_seed(2))
    prefill_fn, decode_fn = make_serve_fns(model, "cpu", max_len=16, global_batch=B)
    lg, state = prefill_fn(params, tokens, init_serve_state(model, B, 16, "cpu"))
    one = [lg]
    for _ in range(2):
        lg, state = decode_fn(params, one[-1].argmax(-1)[:, None], state)
        one.append(lg)
    prefill_fn, decode_fn, _, shards = make_serve_fns(model, mesh, max_len=16, global_batch=B)
    placed = place_serve_params(params, shards, mesh)
    lg, state = prefill_fn(placed, tokens, init_serve_state(model, B, 16, mesh))
    got = [gather_full(lg)]
    for t in range(2):
        lg, state = decode_fn(placed, one[t].argmax(-1)[:, None], state)
        got.append(gather_full(lg))
    fns = max(float((a - b).abs().max()) for a, b in zip(got, one))
    same = all(torch.equal(a.argmax(-1), b.argmax(-1)) for a, b in zip(got, one))

    p = params["layers"][0]["mixer"]
    x = torch.randn(B, 1, cfg.d_model, generator=torch.Generator().manual_seed(3))
    positions = torch.zeros(B, 1, dtype=torch.long)
    want, _ = attention.attention_block(p, cfg, x, positions,
                                        attention.init_attention_cache(cfg, B, 16, torch.float32,
                                                                       torch.device("cpu")))
    local = tree_map(lambda t: t.to_local(), placed["layers"][0]["mixer"])
    cache = init_serve_state(model, B, 16, mesh)["caches"][0]
    rows = B // 2
    r0 = comm_for(mesh).index("data") * rows
    with axis_rules(make_rules(cfg, mesh, "serve", B), mesh):
        y, new = attention.attention_block(local, cfg, x[r0 : r0 + rows], positions[r0 : r0 + rows], cache)
    return {"fns": fns, "tokens": same, "attention": float((y - want[r0 : r0 + rows]).abs().max()),
            "cache": tuple(new["k"].shape), "index": new["index"]}


def _reshard_ranks(rank, world, workdir):
    from torch.distributed.device_mesh import DeviceMesh

    from repro_torch.dist import reshard_state
    from repro_torch.dist.step import gather_state, make_train_step, place_state
    from repro_torch.models.registry import build_model
    from repro_torch.optim import cosine_warmup
    from repro_torch.optim.adamw import tree_leaves

    meshes = [DeviceMesh("cpu", torch.arange(4).reshape(s), mesh_dim_names=("data", "model"))
              for s in ((1, 4), (2, 2), (4, 1))]
    out = {}
    for arch in ("jamba-v0.1-52b", "minicpm3-4b"):
        cfg = get_config(arch).reduced()
        cfg = dataclasses.replace(cfg, n_layers=len(cfg.layout))  # one layout period
        model = build_model(cfg)
        _, axes = model.init(0, "meta", with_axes=True)
        step, _, shard, _ = make_train_step(model, meshes[0], cosine_warmup(LR, 1, 4), global_batch=B)
        state = place_state(_fresh(model), shard, meshes[0])
        state, _ = step(state, _batches(cfg, 1)[0])  # moments and step count no longer zero
        want = [t.clone() for t in tree_leaves(gather_state(state))]
        same = []
        for src, dst in zip(meshes, meshes[1:]):
            state, shardings = reshard_state(state, axes, src, dst, cfg, "train", B)
            leaves = tree_leaves(state)
            assert all(t.device_mesh is dst for t in leaves)
            assert [tuple(t.placements) for t in leaves] == list(_placement_leaves(shardings))
            same.append(all(torch.equal(a, b) for a, b in zip(want, tree_leaves(gather_state(state)))))
        out[arch] = same
    out["pieces"] = _pieces_case(meshes[1])
    out["launch_train"] = _launch_train_case(workdir)
    out["remat_thread"] = _remat_thread_case(meshes[1])
    out["serve_6b"] = _serve_on_mesh(meshes[1])
    # (1, 4): 2 KV heads on a model axis of 4 stay replicated, each rank's
    # one query head reading its own; heads, vocab and experts split
    for name, arch in (("kv_repl_tp4", "internlm2-20b"), ("moe_tp4", "mixtral-8x7b")):
        cfg = get_config(arch).reduced()
        model = build_model(cfg)
        one = make_train_step(model, "cpu", cosine_warmup(LR, 1, 4), global_batch=B)
        step, _, shard, _ = make_train_step(model, meshes[0], cosine_warmup(LR, 1, 4), global_batch=B)
        s1, s2 = _fresh(model), place_state(_fresh(model), shard, meshes[0])
        losses = []
        for b in _batches(cfg):
            s1, m1 = one(s1, b)
            s2, m2 = step(s2, b)
            losses.append((float(m1["loss"]), float(m2["loss"])))
        full = gather_state(s2)
        far = sum(_far_elements(a, b, m) for a, b, m in zip(tree_leaves(full["params"]), tree_leaves(s1["params"]),
                                                            tree_leaves(s1["opt"]["m"])))
        out[name] = {"losses": losses, "far": far}
    return out


def _pieces_case(mesh):
    """The collectives' gloo-on-CUDA forms (list all_gather, reduce-scatter
    by all_reduce, in pieces), forced on CPU tensors with 40-byte pieces,
    against the native ones: (shape, max |difference|) of each."""
    from repro_torch.dist import comm as comm_mod

    c = comm_mod.comm_for(mesh)
    g = torch.Generator().manual_seed(c.index(("data", "model")))
    t = torch.randn(3, 10, 7, generator=g)
    out = []
    for native in (True, False):
        piece, comm_mod.GLOO_CUDA_PIECE = comm_mod.GLOO_CUDA_PIECE, 40
        c.native = lambda _t, _n=native: _n
        try:
            out.append([c.all_gather(t, 1, "data"), c.all_gather(t, 2, ("data", "model")),
                        c.reduce_scatter(t.clone(), 1, "model"), c.all_reduce(t.clone(), ("data", "model")),
                        c.all_reduce(t.clone(), "data", op="max")])
        finally:
            comm_mod.GLOO_CUDA_PIECE = piece
            del c.native
    assert all(t.is_contiguous() for t in out[0] + out[1])  # the kernels take contiguous inputs
    return [(tuple(b.shape), float((a - b).abs().max())) for a, b in zip(*out)]


def _placement_leaves(tree):
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _placement_leaves(tree[k])]
    if isinstance(tree, list):
        return [x for t in tree for x in _placement_leaves(t)]
    return [tuple(tree)]


@pytest.fixture(scope="module")
def resharded(tmp_path_factory):
    from repro_torch.dist.spawn import run_ranks

    workdir = tmp_path_factory.mktemp("reshard")
    return run_ranks(_reshard_ranks, 4, str(workdir / "pg"), str(workdir), timeout=180)


@pytest.mark.parametrize("arch", ["jamba-v0.1-52b", "minicpm3-4b"])
def test_reshard_state_keeps_every_leaf_bit_equal(resharded, arch):
    for out in resharded:
        assert out[arch] == [True, True]  # (1, 4) -> (2, 2) -> (4, 1)


def test_launch_train_runs_on_a_mesh_and_recovers(resharded):
    for out in resharded:
        res = out["launch_train"]
        assert res["step"] == 2 and res["dirs"] == [f"rank_{r}" for r in range(4)]
        assert res["diff"] <= 2 * 2 * LR * 1e-2, res  # two meshes of one run: f32 sums in other orders


def test_serving_on_a_resharded_mesh_matches_one_device(resharded):
    for out in resharded:
        res = out["serve_6b"]
        assert res["fns"] <= 1e-4 and res["tokens"], res  # tests/test_torch_serve.py's f32 logit tolerance
        assert res["attention"] <= 1e-5, res
        assert res["cache"] == (B // 2, 16, 2, 16) and res["index"] == 1, res  # its rows and 2 of 4 KV heads


def test_gloo_cuda_collectives_match_native(resharded):
    for out in resharded:
        shapes, diffs = zip(*out["pieces"])
        assert shapes == ((3, 20, 7), (3, 10, 28), (3, 5, 7), (3, 10, 7), (3, 10, 7))
        # gathers and the max are exact; a sum of 4 may be added in another order
        assert diffs[0] == diffs[1] == diffs[4] == 0 and max(diffs) <= 1e-6, diffs


@pytest.mark.parametrize("name", ["kv_repl_tp4", "moe_tp4"])
def test_model_axis_of_four_matches_one_device(resharded, name):
    for out in resharded:
        res = out[name]
        for one, sharded in res["losses"]:
            np.testing.assert_allclose(sharded, one, **METRIC_TOL)
        assert res["far"] == 0


def test_remat_recompute_keeps_the_axis_rules(resharded):
    for out in resharded:
        assert out["remat_thread"] > 0


def test_adamw_update_in_pieces_is_bit_equal(monkeypatch):
    """A leaf larger than ``PIECE`` is updated in flat pieces (bounding the
    f32 temporaries on a rank's card): the same values, bit for bit."""
    import repro_torch.optim.adamw as adamw

    def run():
        g = torch.Generator().manual_seed(0)
        params = {"w": torch.randn(100, 37, generator=g).bfloat16(), "b": torch.randn(5, generator=g),
                  "t": torch.randn(37, 100, generator=g).T}  # not contiguous: whole
        state = adamw.adamw_init(params)
        for _ in range(3):
            grads = {k: torch.randn(v.shape, generator=g).to(v.dtype) for k, v in params.items()}
            with torch.no_grad():
                adamw.adamw_update(params, grads, state, torch.tensor(1e-2))
        return adamw.tree_leaves(params) + adamw.tree_leaves(state)

    whole = run()
    monkeypatch.setattr(adamw, "PIECE", 64)
    assert all(torch.equal(a, b) for a, b in zip(whole, run()))


def test_make_host_mesh_without_a_process_group_is_the_device():
    from repro_torch.launch.mesh import make_host_mesh

    assert make_host_mesh(device="cpu") == torch.device("cpu")
    with pytest.raises(ValueError, match="process group"):
        make_host_mesh(model=2, device="cpu")

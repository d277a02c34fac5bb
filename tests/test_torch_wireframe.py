"""Wireframe and evaluation-loop parity, on the CPU.

Ghost runs: the same circuits through ``repro.workspace.Workspace.ghost``
(``jax.ShapeDtypeStruct`` ghosts, ``jax.eval_shape``) and the port's
(``repro_torch.core.wireframe.ShapeDtypeStruct`` ghosts run on meta tensors)
must give equal reports — routes with ``carried`` and ``last_hash``, task
executions, design map — opaque ghosts included, with zero store traffic and
zero kernel launches.

The evaluation loop: ``EvalLoop`` over a reduced stablelm whose weights the
port takes from the JAX model (``models.convert.params_from_jax``); after
each step the report's loss agrees within 1e-4 relative in f32, and
``evals_run`` and ``cache_hits`` are equal.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core.evalloop as jax_eval
import repro.workspace as jax_ws
import repro_torch.core.evalloop as torch_eval
import repro_torch.workspace as torch_ws
from repro.configs import get_config as jax_get_config
from repro.core.hashing import content_hash as jax_content_hash
from repro.models import registry as jax_registry
from repro_torch.configs import get_config
from repro_torch.core import GhostValue, ShapeDtypeStruct, content_hash
from repro_torch.core.wireframe import eval_shape
from repro_torch.kernels import ops
from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.models import registry
from repro_torch.models.convert import params_from_jax
from repro_torch.optim.adamw import tree_map
from test_torch_engine import fresh_uids  # noqa: F401

LOSS_REL = 1e-4


def _jax_spec(shape, dtype):
    return jax.ShapeDtypeStruct(shape, jnp.dtype(dtype))


def _torch_spec(shape, dtype):
    return ShapeDtypeStruct(shape, dtype)


# ---------------------------------------------------------------------------
# circuits: the same user code runs on tracers and on meta tensors
# ---------------------------------------------------------------------------


def chain(W, spec):
    ws = W.Workspace("g")
    f = ws.task(lambda x: {"y": x * 2.0}, name="f", inputs=["x"], outputs=["y"])
    g = ws.task(lambda y: {"z": y + 1}, name="g", inputs=["y"], outputs=["z"])
    h = ws.task(lambda z: {"s": z.sum(0), "m": z > 0}, name="h", inputs=["z"], outputs=["s", "m"])
    f["y"] >> g["y"]
    g["z"] >> h["z"]
    return ws, {f["x"]: spec((4, 4), "float32")}


def matmul_fan(W, spec):
    ws = W.Workspace("fan")
    src = ws.task(lambda x: {"a": x.T, "b": x.reshape(-1)}, name="src", inputs=["x"],
                  outputs=["a", "b"])
    mm = ws.task(lambda a: {"p": a @ a}, name="mm", inputs=["a"], outputs=["p"])
    flat = ws.task(lambda b: {"q": b * b}, name="flat", inputs=["b"], outputs=["q"])
    join = ws.task(lambda p, q: {"r": p.mean(-1)}, name="join", inputs=["p", "q"], outputs=["r"])
    src["a"] >> mm["a"]
    src["b"] >> flat["b"]
    mm["p"] >> join["p"]
    flat["q"] >> join["q"]
    return ws, {"src.x": spec((8, 8), "bfloat16")}


def opaque(W, spec):
    """User code that cannot be traced (a host conversion) and a task with a
    service: both give opaque ghosts."""
    ws = W.Workspace("opaque")
    f = ws.task(lambda x: {"y": float(x.sum())}, name="host", inputs=["x"], outputs=["y"])
    g = ws.task(lambda y, dns: {"z": dns("h")}, name="svc", inputs=["y"], outputs=["z"],
                services={"dns": lambda host: {"ip": "10.0.0.7"}})
    f["y"] >> g["y"]
    return ws, {("host", "x"): spec((3,), "float32")}


def window_list(W, spec):
    ws = W.Workspace("win")
    s = ws.task(lambda x: {"y": x - 1.0}, name="s", inputs=["x"], outputs=["y"])
    agg = ws.task(lambda y: {"n": y[0] + y[1]}, name="agg", inputs=["y"], outputs=["n"])
    agg["y"].buffer(2)
    s["y"] >> agg["y"]
    return ws, {"s.x": [spec((2, 3), "float32"), spec((2, 3), "float32")]}


def regions(W, spec):
    ws = W.Workspace("regions")
    eu = ws.task(lambda x: {"s": x * 0.5}, name="eu_sensor", inputs=["x"], outputs=["s"], region="eu")
    hq = ws.task(lambda t: {"report": t + 0.0}, name="hq", inputs=["t"], outputs=["report"],
                 region="us")
    (eu["s"] >> hq["t"]).region("us")
    return ws, {eu["x"]: spec((16, 16), "float32")}


def scalar_out(W, spec):
    """Python scalars out of traced code become weak-typed scalar specs."""
    ws = W.Workspace("scalar")
    f = ws.task(lambda x: {"y": x, "c": 3, "f": 1.5}, name="f", inputs=["x"], outputs=["y", "c", "f"])
    g = ws.task(lambda y: {"d": y + 1}, name="g", inputs=["y"], outputs=["d"])
    f["y"] >> g["y"]
    return ws, {"f.x": spec((5,), "int32")}


SCRIPTS = {"chain": chain, "matmul_fan": matmul_fan, "opaque": opaque,
           "window_list": window_list, "regions": regions, "scalar_out": scalar_out}


def _ghost(W, spec, name):
    ws, inj = SCRIPTS[name](W, spec)
    report = ws.ghost(inj)
    store = ws.store.stats()
    ghosts = {n: {o: repr(av.meta.get("ghost_spec")) for o, av in t.last_outputs.items()}
              for n, t in ws.pipeline.tasks.items()}
    return report, (store["puts"], store["gets"]), ghosts


@pytest.mark.parametrize("name", sorted(SCRIPTS))
def test_ghost_reports_equal(name, fresh_uids):
    fresh_uids()
    want, want_io, want_ghosts = _ghost(jax_ws, _jax_spec, name)
    ops.reset_launch_counts()
    fresh_uids()
    got, got_io, got_ghosts = _ghost(torch_ws, _torch_spec, name)
    assert got == want
    assert got_ghosts == want_ghosts  # the specs journal with the same repr
    assert got_io == want_io == (0, 0)
    assert sum(ops.launch_counts().values()) == 0
    assert all(r["carried"] >= 1 for r in got["routes"].values())


def test_opaque_and_abstract_ghosts():
    ws, inj = opaque(torch_ws, _torch_spec)
    ws.ghost(inj)
    outs = {n: t.last_outputs for n, t in ws.pipeline.tasks.items()}
    assert isinstance(outs["host"]["y"].meta["ghost_spec"], GhostValue)
    ws, inj = chain(torch_ws, _torch_spec)
    ws.ghost(inj)
    h = ws.pipeline.tasks["h"].last_outputs
    assert h["s"].meta["ghost_spec"] == ShapeDtypeStruct((4,), "float32")
    assert h["m"].meta["ghost_spec"] == ShapeDtypeStruct((4, 4), torch.bool)


def test_ghost_run_through_the_kernel_wrappers_launches_nothing(fresh_uids):
    """A task that calls ``flash_attention`` runs it on meta tensors: the
    wrapper hands them to its plain version, the outputs are specs of the
    right shape, and no kernel is launched."""
    ops.reset_launch_counts()
    ws = torch_ws.Workspace("attn")
    t = ws.task(lambda q: {"o": flash_attention(q, q, q)}, name="attn", inputs=["q"], outputs=["o"])
    report = ws.ghost({t["q"]: ShapeDtypeStruct((2, 32, 4, 64), "bfloat16")})
    assert report["tasks"]["attn"]["executions"] == 1
    spec = ws.pipeline.tasks["attn"].last_outputs["o"].meta["ghost_spec"]
    assert spec == ShapeDtypeStruct((2, 32, 4, 64), "bfloat16")
    assert ws.store.stats()["puts"] == 0
    assert ops.launch_counts() == dict.fromkeys(ops.KERNELS, 0)
    out = eval_shape(lambda q: flash_attention(q, q, q, causal=False),
                     q=ShapeDtypeStruct((1, 8, 2, 32), torch.float32))
    assert out == ShapeDtypeStruct((1, 8, 2, 32), "float32")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "int32", "bool"])
def test_ghost_spec_digest_and_repr_match_the_reference(dtype):
    for shape in ((4, 4), (2, 3, 5), ()):
        ref = jax.ShapeDtypeStruct(shape, jnp.dtype(dtype))
        port = ShapeDtypeStruct(shape, dtype)
        assert content_hash(port) == jax_content_hash(ref)
        assert repr(port) == repr(ref)
        assert port.nbytes is None and port.shape == shape


# ---------------------------------------------------------------------------
# the evaluation loop
# ---------------------------------------------------------------------------


def _eval_models():
    cfg, jcfg = get_config("stablelm-1.6b").reduced(), jax_get_config("stablelm-1.6b").reduced()
    jm = jax_registry.build_model(jcfg)
    jparams, _ = jm.init(jax.random.key(0))
    params = params_from_jax(cfg, jax.tree.map(np.asarray, jparams), device="cpu")
    return registry.build_model(cfg), params, jm, jparams


def test_eval_loop_matches_jax():
    m, params, jm, jparams = _eval_models()
    assert m.cfg.dtype == "float32"
    rng = np.random.RandomState(1)
    toks = rng.randint(0, m.cfg.vocab, size=(2, 32)).astype(np.int32)
    jbatch = {"tokens": jnp.asarray(toks), "labels": jnp.asarray(toks)}
    tbatch = {"tokens": torch.from_numpy(toks), "labels": torch.from_numpy(toks)}
    calls = {"jax": 0, "torch": 0}

    def jax_fn(p, batch):
        calls["jax"] += 1
        loss, _ = jax_registry.train_loss(jm, p, batch)
        return {"loss": float(loss)}

    def torch_fn(p, batch):
        calls["torch"] += 1
        with torch.no_grad():
            loss, _ = registry.train_loss(m, p, batch)
        return {"loss": float(loss)}

    jl = jax_eval.EvalLoop(jax_eval.build_eval_circuit(jax_fn, jbatch))
    tl = torch_eval.EvalLoop(torch_eval.build_eval_circuit(torch_fn, tbatch))
    jp2 = jax.tree.map(lambda x: x * 1.01, jparams)
    tp2 = tree_map(lambda x: x * 1.01, params)
    steps = [(jparams, params, 1), (jparams, params, 1), (jp2, tp2, 2), (None, None, None)]
    reports = []
    for jp, tp, step in steps:
        if jp is not None:
            jl.publish(jp, step=step)
            tl.publish(tp, step=step)
        jr, tr = jl.report(), tl.report()
        assert tr["step"] == jr["step"]
        assert abs(tr["loss"] - jr["loss"]) <= LOSS_REL * abs(jr["loss"])
        assert (tl.evals_run, tl.cache_hits) == (jl.evals_run, jl.cache_hits)
        assert calls["torch"] == calls["jax"]
        reports.append(tr)
    assert calls["torch"] == 2 and tl.cache_hits >= 1
    assert reports[1] == reports[0] and reports[3] == reports[2]
    assert reports[2]["loss"] != reports[0]["loss"]


def test_checkpoint_digest_is_stable_for_the_same_tensors():
    """The checkpoint dict of tensors digests in the pickle tier: the same
    tensors twice give one digest; an in-place update gives another."""
    w = torch.arange(12.0).reshape(3, 4)
    ck = {"params": {"w": w, "layers": [{"b": torch.ones(4)}]}, "step": 3}
    first = content_hash(ck)
    assert content_hash(ck) == first
    w.add_(1.0)
    assert content_hash(ck) != first

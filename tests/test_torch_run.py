"""The port's training run around the step, against the JAX package, on the CPU.

The data circuit (the same numpy payloads, content hashes, software versions
and visitor logs as the reference's), checkpoints of torch trees (bf16 bit for
bit, the manifest's hash over canonical dtype names), the one-device
``MeshExecutor`` and ``make_host_mesh``, and ``launch.train.main`` with its
make-mode recovery drill, whose per-step losses equal the reference's
from the same carried-over weights.
"""

import itertools
import os
import re
import subprocess
import sys
import threading

import jax
import ml_dtypes
import numpy as np
import pytest
import torch

import repro.core.av as jax_av
from repro.checkpoint import save_checkpoint as jax_save_checkpoint
from repro.configs import get_config as jax_get_config
from repro.core import content_hash as jax_content_hash
from repro.data.pipeline import build_data_pipeline as jax_build_data_pipeline
from repro.data.pipeline import next_batch as jax_next_batch
from repro.launch import train as jax_train
from repro.models import registry as jax_registry
import repro_torch.core.av as torch_av
from repro_torch.checkpoint import CheckpointManager, restore_checkpoint, save_checkpoint
from repro_torch.configs import get_config
from repro_torch.data.pipeline import build_data_pipeline, next_batch
from repro_torch.dist.ft import FaultToleranceManager, SimulatedFailure
from repro_torch.launch import train
from repro_torch.launch.mesh import make_host_mesh, make_production_mesh
from repro_torch.models import transformer
from repro_torch.models.convert import params_from_jax
from repro_torch.models.registry import build_model
from repro_torch.optim import cosine_warmup
from repro_torch.workspace import ConcurrentExecutor, MeshExecutor

# losses printed to 4 decimals by both entry points over 6 f32 steps of a reduced
# model: the step's parity (tests/test_torch_train.py) is ~1e-6 relative, so
# a printed value may differ by one unit in its last place
LOSS_PRINT_TOL = 1.5e-4


@pytest.fixture
def fresh_uids(monkeypatch):
    monkeypatch.setattr(jax_av, "_AV_COUNTER", itertools.count())
    monkeypatch.setattr(torch_av, "_AV_COUNTER", itertools.count())


def _circuit_view(ws):
    """Content hashes of every AV by task, and each task's visitor log with
    AV uids replaced by (source task, content hash) and times dropped."""
    reg = ws.registry
    avs = [reg.get_av(u) for u in reg.all_avs()]
    uid_to = {av.uid: (av.source_task, av.chash) for av in avs}
    chashes = {}
    for av in avs:
        chashes.setdefault(av.source_task, set()).add(av.chash)
    visits = {t: [(e["task"], e["event"], uid_to.get(e["av_uid"], e["av_uid"]), e["software_version"],
                   e["note"].split("=")[0]) for e in ws.visitor_log(t)] for t in ws.tasks()}
    return chashes, visits


def test_data_circuit_matches_jax(fresh_uids):
    arch, batch, seq = "stablelm-1.6b", 16, 24
    cfg, jcfg = get_config(arch).reduced(), jax_get_config(arch).reduced()
    ws, jws = build_data_pipeline(cfg, batch, seq, seed=3), jax_build_data_pipeline(jcfg, batch, seq, seed=3)
    for _ in range(4):
        got, want = next_batch(ws, cfg), jax_next_batch(jws, jcfg)
        assert sorted(got) == sorted(want) == ["labels", "tokens"]
        for k in got:
            assert got[k].dtype == np.int32 and got[k].shape == (batch, seq)
            np.testing.assert_array_equal(got[k], want[k])
    chashes, visits = _circuit_view(ws)
    jchashes, jvisits = _circuit_view(jws)
    assert set(chashes) == {"sample", "pack", "batch"}
    assert chashes == jchashes
    assert len(chashes["batch"]) == 4
    assert visits == jvisits and all(visits.values())


def _state():
    g = torch.Generator().manual_seed(0)
    return {
        "params": {"w": torch.randn(5, 3, generator=g).bfloat16(), "b": torch.randn(3, generator=g),
                   "layers": [{"ln": torch.randn(4, generator=g).bfloat16()}, {"ln": torch.randn(4, generator=g)}]},
        "opt": {"count": torch.tensor(7, dtype=torch.int32)},
        "step": torch.tensor(7, dtype=torch.int32),
    }


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        return {k2: v2 for k in sorted(tree) for k2, v2 in _flat(tree[k], f"{prefix}{k}/").items()}
    if isinstance(tree, list):
        return {k2: v2 for i, t in enumerate(tree) for k2, v2 in _flat(t, f"{prefix}{i}/").items()}
    return {prefix[:-1]: tree}


def _bits(t):
    return t.view(torch.int16) if t.dtype == torch.bfloat16 else t


def test_checkpoint_round_trip_is_bit_equal(tmp_path):
    state = _state()
    av = save_checkpoint(str(tmp_path), state, 7, meta={"loss": 1.5}, software_version="v-x")
    like = {"params": {"w": torch.zeros(5, 3, dtype=torch.bfloat16), "b": torch.zeros(3),
                       "layers": [{"ln": torch.zeros(4, dtype=torch.bfloat16)}, {"ln": torch.zeros(4)}]},
            "opt": {"count": torch.zeros((), dtype=torch.int32)}, "step": torch.zeros((), dtype=torch.int32)}
    back, manifest = restore_checkpoint(str(tmp_path), like)
    flat, flat_back = _flat(state), _flat(back)
    assert sorted(flat) == sorted(flat_back) == manifest["keys"]
    assert "params/layers/0/ln" in flat
    for k in flat:
        assert flat_back[k].dtype == flat[k].dtype and torch.equal(_bits(flat_back[k]), _bits(flat[k])), k
    # the bf16 leaves are stored as their uint16 bits
    with np.load(tmp_path / "step_00000007" / "host_0.npz") as data:
        assert data["params/w"].dtype == np.uint16 and data["params/b"].dtype == np.float32
    # the hash is over the canonical dtype names, as the reference writes them
    shapes = {k: (tuple(v.shape), {torch.bfloat16: "bfloat16", torch.float32: "float32",
                                   torch.int32: "int32"}[v.dtype]) for k, v in flat.items()}
    assert manifest["payload_hash"] == av.chash == jax_content_hash(shapes)
    assert {d for _, d in shapes.values()} == {"bfloat16", "float32", "int32"}
    # ... and equals the JAX package's checkpoint of the same leaves (bf16 via ml_dtypes)
    as_np = {k: (v.view(torch.int16).numpy().view(ml_dtypes.bfloat16) if v.dtype == torch.bfloat16 else v.numpy())
             for k, v in flat.items()}
    jav = jax_save_checkpoint(str(tmp_path / "jax"), as_np, 7)
    assert jav.chash == manifest["payload_hash"]
    assert manifest["meta"] == {"loss": 1.5} and manifest["software_version"] == "v-x"
    with pytest.raises(TypeError, match="dtype mismatch"):
        restore_checkpoint(str(tmp_path), {**like, "step": torch.zeros((), dtype=torch.int64)})
    with pytest.raises(ValueError, match="shape mismatch"):
        restore_checkpoint(str(tmp_path), {**like, "step": torch.zeros(2, dtype=torch.int32)})


def test_checkpoint_manager_copies_before_the_thread_and_keeps_three(tmp_path):
    state = _state()
    mgr = CheckpointManager(str(tmp_path), keep=3)
    want = state["params"]["b"].clone()
    for step in range(1, 6):
        mgr.save_async(state, step)
        state["params"]["b"].add_(1.0)  # the train step updates in place right after
        mgr.wait()
    assert mgr.latest_step() == 5
    assert sorted(os.listdir(tmp_path)) == [f"step_{s:08d}" for s in (3, 4, 5)]
    back, _ = mgr.restore(_state(), step=3)
    assert torch.equal(back["params"]["b"], want + 2.0)
    assert [av.meta["step"] for av in mgr.saved] == [1, 2, 3, 4, 5]


def test_checkpoint_manager_reraises_a_failed_write(tmp_path):
    blocker = tmp_path / "file"
    blocker.write_text("not a directory")
    mgr = CheckpointManager(str(blocker))
    mgr.save_async(_state(), 1)
    with pytest.raises(OSError):
        mgr.wait()
    mgr.wait()  # reported once


def test_mesh_executor_binds_one_device_and_builds_steps():
    ex = MeshExecutor(make_host_mesh(device="cpu"), cfg=None, mode="train", global_batch=2,
                      inner=ConcurrentExecutor(max_workers=2))
    assert ex.mesh == torch.device("cpu")
    assert ex.stats()["mesh"] == {"device": "cpu"} and ex.stats()["inner"]["backend"] == "ConcurrentExecutor"
    model = build_model(get_config("stablelm-1.6b").reduced())
    step = ex.train_step(model, cosine_warmup(1e-3, 1, 4))
    params = model.init(0, "cpu")
    from repro_torch.optim import adamw_init

    state = {"params": params, "opt": adamw_init(params), "step": torch.zeros((), dtype=torch.int32)}
    tokens = torch.randint(0, 256, (2, 16), generator=torch.Generator().manual_seed(1), dtype=torch.int32)
    state, met = step(state, {"tokens": tokens, "labels": tokens})
    assert int(state["step"]) == 1 and torch.isfinite(met["loss"])
    prefill_fn, _ = ex.serve_fns(model, max_len=16)
    assert callable(prefill_fn)
    # the meshes of several devices are ported: a model axis needs a process
    # group of its ranks, and the production mesh builds on the fake backend
    with pytest.raises(ValueError, match="process group"):
        make_host_mesh(model=2, device="cpu")
    with pytest.raises(RuntimeError, match="fake=True"):
        make_production_mesh()
    code = ("from repro_torch.launch.mesh import make_production_mesh\n"
            "m = make_production_mesh(fake=True)\n"
            "print(tuple(m.shape), m.mesh_dim_names)\n")
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(p for p in sys.path if p))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, timeout=120, env=env)
    assert out.returncode == 0 and out.stdout.split("\n")[-2] == "(16, 16) ('data', 'model')", out.stderr[-2000:]


def test_fault_tolerance_manager_is_the_reference_s():
    ft = FaultToleranceManager(n_hosts=4)
    for h, d in enumerate((1.0, 1.01, 0.99, 3.0)):
        ft.heartbeat(h, d)
    assert [h for h, _ in ft.stragglers()] == [3]
    calls = []

    def run(start):
        calls.append(start)
        if len(calls) < 3:
            raise SimulatedFailure(host=1)
        return start

    assert ft.run_with_recovery(run, lambda: len(calls)) == 2 and ft.restarts == 2


def _losses(out: str) -> list:
    return [(int(s), float(l)) for s, l in re.findall(r"^step\s+(\d+) loss ([0-9.]+)", out, re.M)]


def test_train_main_matches_jax_main_through_a_failure(tmp_path, monkeypatch, capsys):
    arch = "stablelm-1.6b"
    jcfg = jax_get_config(arch).reduced()

    def carried_init(self, seed, device="cuda"):
        jparams, _ = jax_registry.build_model(jcfg).init(jax.random.key(seed))
        return params_from_jax(self.cfg, jax.tree.map(np.asarray, jparams), device)

    monkeypatch.setattr(transformer.Model, "init", carried_init)
    flags = ["--arch", arch, "--reduced", "--steps", "6", "--batch", "4", "--seq", "32", "--ckpt-every", "2",
             "--fail-at-step", "3", "--seed", "1"]
    state = train.main(flags + ["--device", "cpu", "--ckpt-dir", str(tmp_path / "port")])
    out = capsys.readouterr().out
    jax_train.main(flags + ["--ckpt-dir", str(tmp_path / "jax")])
    jout = capsys.readouterr().out

    got, want = _losses(out), _losses(jout)
    assert [s for s, _ in got] == [s for s, _ in want] == [0, 1, 2, 2, 3, 4, 5]
    np.testing.assert_allclose([l for _, l in got], [l for _, l in want], rtol=0, atol=LOSS_PRINT_TOL)
    # the resumed step 2 takes the circuit's next batch, not the one it replaces (no rewind)
    assert got[2][1] != got[3][1]
    for line in ("[restore] step 2", "[done] 6 steps; checkpoints: [2, 4, 6]",
                 "[provenance] visitor log entries: 8"):
        assert line in out and line in jout, line
    assert "[ft] injected at step 3 -> restart from latest checkpoint (attempt 1)" in out
    assert int(state["step"]) == 6 and state["params"]["embed"].device.type == "cpu"
    assert sorted(os.listdir(tmp_path / "port")) == [f"step_{s:08d}" for s in (2, 4, 6)]

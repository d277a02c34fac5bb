"""The port's multi-pod dry-run (``python -m repro_torch.launch.dryrun``) as
the reference's integration test drives its own (tests/test_dryrun_integration.py):
a train and a decode cell on each production mesh, the skip rows, a lever
override; each run in a subprocess of its own, since it starts torch's fake
process-group backend. And the pieces it needs on meta tensors: the MoE
layouts' static-shape dispatch (``models.moe.bin_counts``)."""

import dataclasses
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from repro_torch.configs import SHAPES, all_cells, get_config
from repro_torch.dist.step import make_batch_specs, make_train_step
from repro_torch.launch.dryrun import port_skip_reason
from repro_torch.models.moe import bin_counts
from repro_torch.models.registry import build_model, decode_step, init_serve_state, prefill, train_loss
from repro_torch.optim import adamw_init, constant_lr

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _env():
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(p for p in sys.path if p)
    return env


def _run_dryrun(args, out_dir):
    return subprocess.run(
        [sys.executable, "-W", "ignore", "-m", "repro_torch.launch.dryrun", *args, "--out", str(out_dir)],
        capture_output=True, text=True, timeout=150, env=_env(), cwd=REPO)


@pytest.mark.parametrize("multipod", [False, True])
@pytest.mark.parametrize("shape", ["train_4k", "decode_32k"])
def test_dryrun_cell_counts_and_records(shape, multipod, tmp_path):
    r = _run_dryrun(["--arch", "stablelm-1.6b", "--shape", shape, "--tag", "citest"]
                    + (["--multipod"] if multipod else []), tmp_path)
    assert r.returncode == 0, r.stderr[-2000:]
    assert f"[OK] stablelm-1.6b x {shape}" in r.stdout
    mesh = "pod2x16x16" if multipod else "pod16x16"
    rec = json.load(open(tmp_path / mesh / f"stablelm-1.6b__{shape}__citest.json"))
    assert rec["n_devices"] == (512 if multipod else 256)
    assert rec["t_memory"] > 0 and rec["bottleneck"] in ("compute", "memory", "collective")
    assert rec["memory_analysis"] is not None and rec["memory_analysis"]["peak_live_bytes"] > 0
    assert rec["state_gb_per_device"] < 80.0
    assert rec["collectives"]["total_weighted"] >= 0
    assert rec["xla_cost_analysis"] is None and rec["compile_seconds"] > 0
    assert rec["hardware"]["name"] == "nvidia-h100-sxm" and rec["t_compute"] > 0
    # every kernel region of the cell was counted and credited
    assert set(rec["kernel_credit"]["detail"]) == {"pallas_flash_attention"}
    assert rec["buckets"]["pallas_flash_attention"]["flops"] > 0
    # the collectives: a train step's FSDP gather and reduce-scatter and tensor-parallel all-reduces
    kinds = {k for k, v in rec["collectives"].items() if isinstance(v, dict) and v["count"]}
    if shape == "train_4k":
        assert {"all-gather", "reduce-scatter", "all-reduce", "all-gather@n16", "all-reduce@n16"} <= kinds
        assert ("all-reduce@n2" in kinds) == multipod  # the gradients' sum over the pods
    else:
        assert "all-reduce" in kinds


# one rank of a (data 4, model 2) mesh on the fake backend: a reduced
# stablelm of 4 layers takes a train step on meta tensors under each remat,
# counted; prints the all-gather and reduce-scatter bytes over data and what
# FSDP gathers (each leaf's shard bytes times the data axis it is split over)
_FSDP_COUNT = """
import dataclasses, json, torch, torch.distributed as dist
from torch.testing._internal.distributed.fake_pg import FakeStore
from torch.distributed.device_mesh import DeviceMesh
from torch.distributed.tensor import Shard
dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=8)
mesh = DeviceMesh("cpu", torch.arange(8).reshape(4, 2), mesh_dim_names=("data", "model"))
from repro_torch.configs import get_config
from repro_torch.dist.step import fsdp_units, make_batch_specs, make_train_step, param_specs, placed_train_state
from repro_torch.models.registry import build_model
from repro_torch.optim import constant_lr
from repro_torch.optim.adamw import tree_leaves
from repro_torch.roofline import OpCounter

def gathered(tree):
    return sum(t.to_local().nbytes * 4 for t in tree_leaves(tree)
               if any(isinstance(pl, Shard) and n == "data" for n, pl in zip(mesh.mesh_dim_names, t.placements)))

out = {}
for remat in ("block", "full", "none"):
    cfg = dataclasses.replace(get_config("stablelm-1.6b").reduced(), n_layers=4, remat=remat)
    model = build_model(cfg)
    step, _, shard, _ = make_train_step(model, mesh, constant_lr(1e-3), global_batch=8)
    state = placed_train_state(param_specs(model)[0], shard, mesh)
    batch = make_batch_specs(cfg, "train", 8, 16)
    with OpCounter(args=(state, batch)) as counter:
        step(state, batch)
    outside, units = fsdp_units(cfg, state["params"])
    out[remat] = {
        "all_gather": sum(b for k, b, n in counter.collective_ops if k == "all-gather" and n == 4),
        "reduce_scatter": sum(b for k, b, n in counter.collective_ops if k == "reduce-scatter" and n == 4),
        "trunk": gathered(units), "outside": gathered(outside),
        "peak": counter.costs()["peak_bytes"]}
print(json.dumps(out))
"""


def test_dryrun_counts_the_recompute_gathers():
    """FSDP on a fake mesh with data 4: under remat block and full the
    counted all-gather bytes over data are the leaves outside the trunk once
    and the trunk twice (the forward's gathers and the recompute's, which
    the counter sees on the backward's thread); under remat none, the trunk
    once. Each gradient is reduce-scattered once, whatever the remat."""
    r = subprocess.run([sys.executable, "-W", "ignore", "-c", _FSDP_COUNT], capture_output=True, text=True,
                       timeout=150, env=_env(), cwd=REPO)
    assert r.returncode == 0, r.stderr[-2000:]
    out = json.loads(r.stdout.strip().splitlines()[-1])
    for remat, times in (("block", 2), ("full", 2), ("none", 1)):
        c = out[remat]
        assert c["trunk"] > 0 and c["outside"] > 0, c
        assert c["all_gather"] == c["outside"] + times * c["trunk"], (remat, c)
        assert c["reduce_scatter"] * 4 == c["outside"] + c["trunk"], (remat, c)
    assert out["block"]["peak"] < out["none"]["peak"], out


def test_dryrun_skip_rows_recorded(tmp_path):
    """The reference's skip row, and the port's own: a prefill longer than
    mixtral's ring of 4096 slots, on either mesh."""
    r = _run_dryrun(["--arch", "internlm2-20b", "--shape", "long_500k", "--tag", "citest"], tmp_path)
    assert r.returncode == 0 and "[SKIP]" in r.stdout, r.stderr[-2000:]
    assert "skip" in json.load(open(tmp_path / "pod16x16" / "internlm2-20b__long_500k__citest.json"))
    for multipod in (False, True):
        r = _run_dryrun(["--arch", "mixtral-8x7b", "--shape", "prefill_32k"] + (["--multipod"] if multipod else []),
                        tmp_path)
        assert r.returncode == 0 and "[SKIP] mixtral-8x7b x prefill_32k" in r.stdout, r.stderr[-2000:]
        rec = json.load(open(tmp_path / ("pod2x16x16" if multipod else "pod16x16") / "mixtral-8x7b__prefill_32k.json"))
        assert "ring" in rec["skip"] and "4096" in rec["skip"]


def test_dryrun_lever_overrides(tmp_path):
    r = _run_dryrun(["--arch", "stablelm-1.6b", "--shape", "decode_32k", "--set", "block_kv=1024",
                     "--tag", "citest2"], tmp_path)
    assert r.returncode == 0, r.stderr[-2000:]
    assert "[OK]" in r.stdout
    assert json.load(open(tmp_path / "pod16x16" / "stablelm-1.6b__decode_32k__citest2.json"))["n_devices"] == 256


def test_the_port_skips_only_the_ring_prefill():
    """Of the reference's 40 cells the port refuses one more: mixtral-8x7b x
    prefill_32k (a prompt of 32,768 tokens into a ring of 4096 slots)."""
    extra = [(a, s) for a, s, skip in all_cells() if skip is None and port_skip_reason(get_config(a), s)]
    assert extra == [("mixtral-8x7b", "prefill_32k")]
    assert len(list(all_cells())) == 40


# ---------------------------------------------------------------------------
# The MoE dispatch on meta tensors
# ---------------------------------------------------------------------------


def test_bin_counts_equal_bincount():
    rng = np.random.RandomState(0)
    for n, size in ((1, 5), (16, 1000), (64, 37), (300, 4096), (8, 0)):
        key = torch.from_numpy(rng.randint(0, n, size=size)).long()
        got = bin_counts(key, n)
        assert got.dtype == torch.int64 and torch.equal(got, torch.bincount(key, minlength=n))


MOE_CASES = [("mixtral-8x7b", {}), ("phi3.5-moe-42b", {}), ("jamba-v0.1-52b", {}),
             ("mixtral-8x7b", dict(moe_groups=2)), ("jamba-v0.1-52b", dict(moe_exact_tokens=8, capacity_factor=0.5))]


@pytest.mark.parametrize("arch,overrides", MOE_CASES)
def test_moe_layouts_run_on_meta(arch, overrides):
    """A train step, a prefill and a decode step of every MoE layout on meta
    tensors: shapes only, no op whose output size depends on the data."""
    cfg = dataclasses.replace(get_config(arch).reduced(), **overrides)
    model = build_model(cfg)
    params = model.init(0, "meta")
    state = {"params": params, "opt": adamw_init(params), "step": torch.zeros((), dtype=torch.int32, device="meta")}
    batch = make_batch_specs(cfg, "train", 4, 16)
    _, met = make_train_step(model, "meta", constant_lr(1e-3), global_batch=4)(state, batch)
    assert met["loss"].device.type == "meta" and met["loss"].shape == ()
    loss, aux = train_loss(model, params, batch)
    assert loss.shape == () and aux["aux"].device.type == "meta"
    with torch.inference_mode():
        st = init_serve_state(model, 2, 24, "meta")
        logits, st = prefill(model, params, torch.empty((2, 12), dtype=torch.int32, device="meta"), st)
        logits, st = decode_step(model, params, torch.empty((2, 1), dtype=torch.int32, device="meta"), st)
    assert logits.shape == (2, cfg.vocab) and logits.device.type == "meta" and st["t"] == 13

"""Multi-pod dry-run: one rank's step of every (arch x shape x mesh) cell,
counted on a fake DeviceMesh over meta tensors and priced for H100s.

Port of ``repro.launch.dryrun``, which lowers and compiles each cell for 256
or 512 TPU v5e chips. Here torch's fake process-group backend stands for the
(16, 16) or (2, 16, 16) production mesh in this one process
(``launch.mesh.make_production_mesh(fake=True)``): every rank's shards are
meta tensors (``dist.step.mesh_device``), so the real sharded train step or
serve function (``dist.step``) runs as a user calls it, with rules,
placements, collectives and the model's tensor-, expert- and
channel-parallel code, and moves no byte. ``roofline.op_costs`` counts what
rank 0 dispatches and ``roofline.model.analyze`` prices it with
``H100_SXM``: the compute, memory and collective terms of what a (16, 16)
or (2, 16, 16) H100 deployment of each cell would spend.

  python -m repro_torch.launch.dryrun --arch mixtral-8x7b --shape train_4k
  python -m repro_torch.launch.dryrun --all                # 40-cell table
  python -m repro_torch.launch.dryrun --all --multipod     # 2-pod (512 ranks)

Records go to ``<out>/<mesh>/<arch>__<shape>[__tag].json`` (``--out``,
default ``dryrun_out``), with the reference's keys: ``compile_seconds`` is
the counted run's seconds, ``xla_cost_analysis`` None, ``memory_analysis``
the run's argument and peak live bytes. Cells follow the reference's: a
prefill's cache holds the vision prefix too, a decode is one new token
against a cache of ``seq_len - 1`` tokens (an encoder-decoder's memory made
by a one-token prefill first, not counted). The port adds one skip row:
a prefill longer than a sliding-window ring (mixtral-8x7b x prefill_32k),
which the port refuses (``models.attention._cached_attention``).

The fake backend must not share a process with another process group: run
this in a process of its own (``python -m``), as the tests and
``chip_smoke.py`` do.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import math
import os
import sys
import time
import traceback
from typing import Optional

import torch

from repro_torch.configs import SHAPES, all_cells, cell_skip_reason, get_config
from repro_torch.dist.sharding import cache_logical_axes, local_shape, make_rules, mesh_shape, pspec_for_axes
from repro_torch.dist.step import (
    make_batch_specs,
    make_serve_fns,
    make_train_state_specs,
    make_train_step,
    param_specs,
    place_serve_params,
    place_state,
    placed_serve_state,
    placed_train_state,
    serve_params,
)
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.models import attention as attn
from repro_torch.models.registry import build_model
from repro_torch.optim import cosine_warmup
from repro_torch.optim.adamw import tree_map
from repro_torch.roofline import H100_SXM, OpCounter, analyze

OUT_DIR = "dryrun_out"


def _mesh_name(multi_pod: bool) -> str:
    return "pod2x16x16" if multi_pod else "pod16x16"


def _max_len(cfg, spec) -> int:
    """A cell's cache length: a prefill's holds the vision prefix too."""
    return spec.seq_len + (cfg.frontend_len if spec.kind == "prefill" and cfg.frontend == "vision" else 0)


def port_skip_reason(cfg, shape: str) -> Optional[str]:
    """A cell the reference compiles and the port refuses, or None: a
    prefill its attention caches refuse (``models.attention.prefill_refusal``)."""
    spec = SHAPES[shape]
    if spec.kind != "prefill":
        return None
    n = _max_len(cfg, spec)
    refused = attn.prefill_refusal(n, attn.cache_slots(cfg, n), attn.is_ring(cfg, n))
    if refused is None:
        return None
    return (f"{refused}: the port refuses a prefill longer than its cache (into a ring the reference writes "
            "repeated slots in no defined order; ROADMAP section 3, 'Ring prefill longer than the ring')")


def _spec_bytes(shapes, axes, rules: dict, mesh) -> int:
    """Bytes of one rank's shards of a tree of tensors (meta or not) whose
    logical axes are ``axes``, placed by ``rules`` on ``mesh``."""
    if isinstance(shapes, dict):
        return sum(_spec_bytes(shapes[k], axes[k], rules, mesh) for k in shapes)
    if isinstance(shapes, (list, tuple)):
        return sum(_spec_bytes(t, a, rules, mesh) for t, a in zip(shapes, axes))
    spec = pspec_for_axes(axes, tuple(shapes.shape), rules, mesh)
    return math.prod(local_shape(tuple(shapes.shape), spec, mesh)) * shapes.element_size()


def state_bytes(model, kind: str, global_batch: int, max_len: int, rules: dict, mesh,
                compress_pods: bool = False) -> int:
    """Bytes of one rank's state of a cell, from its shapes and the specs the
    rules give them, as the reference's ``_sharded_gb`` counts them: in
    train the params, AdamW's moments, count and step (and the pod
    compression's residual), in serve the params (``serve_params``' view)
    and every layer's cache (its ``index`` is a host int). Anything with a
    ``.shape`` mapping stands in for the mesh."""
    if kind == "train":
        shapes, axes = make_train_state_specs(model, with_axes=True)
        if compress_pods and mesh_shape(mesh).get("pod", 1) > 1:
            shapes["compress"] = {"residual": shapes["opt"]["m"]}
            axes["compress"] = {"residual": axes["params"]}
        return _spec_bytes(shapes, axes, rules, mesh)
    pmeta, paxes = param_specs(model)
    caches = [{k: v for k, v in c.items() if k != "index"} for c in model.init_cache(global_batch, max_len, "meta")]
    cache_axes = [{k: v for k, v in a.items() if k != "index"} for a in cache_logical_axes(model.cfg, max_len)]
    return (_spec_bytes(serve_params(pmeta), serve_params(paxes), rules, mesh)
            + _spec_bytes(caches, cache_axes, rules, mesh))


def _train_run(model, mesh, rules, spec, microbatches: int, compress_pods: bool):
    """(the counted run, its arguments, the sequence length)."""
    step, _, state_shard, _ = make_train_step(
        model, mesh, cosine_warmup(3e-4, 2000, 100_000), rules=rules, global_batch=spec.global_batch,
        microbatches=microbatches, compress_pods=compress_pods)
    params, _ = param_specs(model)
    state = placed_train_state(params, state_shard, mesh)
    if "compress" in state_shard:
        residual = tree_map(lambda p: torch.empty(p.shape, dtype=torch.float32, device="meta"), params)
        state["compress"] = place_state({"residual": residual}, state_shard["compress"], mesh)
    batch = make_batch_specs(model.cfg, "train", spec.global_batch, spec.seq_len)
    return (lambda: step(state, batch)), (state, batch), spec.seq_len


def _serve_run(model, mesh, rules, spec):
    """(the counted run, its arguments, the caches' max_len)."""
    cfg = model.cfg
    B, L = spec.global_batch, spec.seq_len
    max_len = _max_len(cfg, spec)
    prefill_fn, decode_fn, _, shards = make_serve_fns(model, mesh, max_len=max_len, global_batch=B, rules=rules)
    params = place_serve_params(param_specs(model)[0], shards, mesh)
    state = placed_serve_state(model, B, max_len, mesh, rules)
    if spec.kind == "prefill":
        batch = make_batch_specs(cfg, "prefill", B, L)
        run = lambda: prefill_fn(params, batch["tokens"], state, batch.get("frames"), batch.get("prefix"))
        return run, (params, state, batch), max_len
    meta = lambda shape, dtype: torch.empty(shape, dtype=dtype, device="meta")
    if cfg.encoder_layers:  # the memory (and its K/V) that a prefill keeps
        frames = meta((B, cfg.frontend_len, cfg.d_model), cfg.compute_dtype())
        _, state = prefill_fn(params, meta((B, 1), torch.int32), state, frames)
    for c in state["caches"]:  # one new token against seq_len - 1 cached ones
        if "index" in c:
            c["index"] = L - 1
    state["t"] = L - 1
    tokens = meta((B, 1), torch.int32)
    return (lambda: decode_fn(params, tokens, state)), (params, state, tokens), max_len


def dryrun_cell(
    arch: str,
    shape: str,
    *,
    multi_pod: bool = False,
    overrides: Optional[dict] = None,
    compress_pods: bool = False,
    microbatches: int = 1,
    tag: str = "",
    out_dir: str = OUT_DIR,
    mesh=None,
) -> dict:
    """Count and price one cell, print its [OK] or [SKIP] line and save its
    roofline record (a dict, returned) under ``out_dir``. ``mesh``: the
    production mesh to plan on (made on the fake backend when None)."""
    cfg = get_config(arch)
    if overrides:
        cfg = dataclasses.replace(cfg, **overrides)
    spec = SHAPES[shape]
    skip = cell_skip_reason(cfg, shape) or port_skip_reason(cfg, shape)
    if skip:
        rec = {"arch": arch, "shape": shape, "mesh": _mesh_name(multi_pod), "skip": skip}
        _save(rec, out_dir, multi_pod, arch, shape, tag)
        print(f"[SKIP] {arch} x {shape}: {skip}")
        return rec

    mesh = mesh if mesh is not None else make_production_mesh(multi_pod=multi_pod, fake=True)
    n_dev = mesh.size()
    model = build_model(cfg)
    rules = make_rules(cfg, mesh, "train" if spec.kind == "train" else "serve", spec.global_batch)
    if spec.kind == "train":
        run, args, max_len = _train_run(model, mesh, rules, spec, microbatches, compress_pods)
    else:
        run, args, max_len = _serve_run(model, mesh, rules, spec)
    n_bytes = state_bytes(model, spec.kind, spec.global_batch, max_len, rules, mesh, compress_pods)
    t0 = time.perf_counter()
    with OpCounter(args=args) as counter:
        run()
    count_s = time.perf_counter() - t0
    costs = counter.costs()

    report = analyze(
        costs, arch=arch, shape=shape, mesh_name=_mesh_name(multi_pod), n_devices=n_dev, kind=spec.kind,
        cfg=cfg, seq_len=spec.seq_len, global_batch=spec.global_batch, hw=H100_SXM,
        mesh_shape=mesh_shape(mesh), rules=rules)
    rec = report.to_record()
    rec["roofline_frac"] = report.roofline_frac
    rec["compile_seconds"] = count_s
    rec["state_gb_per_device"] = n_bytes / 1e9
    rec["memory_analysis"] = {
        "argument_size_in_bytes": int(costs["argument_bytes"]),
        "temp_size_in_bytes": int(costs["peak_bytes"] - costs["argument_bytes"]),
        "peak_live_bytes": int(costs["peak_bytes"]),
    }
    rec["n_ops"] = costs["n_ops"]
    if n_bytes > H100_SXM.hbm_bytes:
        print(f"[WARN] {arch} x {shape}: state {n_bytes / 1e9:.1f} GB/device exceeds the H100's "
              f"{H100_SXM.hbm_bytes / 1e9:.0f} GB of HBM")
    raw = (f" memory_raw={report.t_memory_raw * 1e3:.2f}ms"
           if report.t_memory_raw and abs(report.t_memory_raw - report.t_memory) > 1e-9 else "")
    print(f"[OK] {arch} x {shape} ({_mesh_name(multi_pod)}): "
          f"compute={report.t_compute * 1e3:.2f}ms memory={report.t_memory * 1e3:.2f}ms{raw} "
          f"collective={report.t_collective * 1e3:.2f}ms -> {report.bottleneck}-bound; "
          f"useful/counted={report.useful_flops_frac:.3f} roofline_frac={report.roofline_frac:.3f} "
          f"state={n_bytes / 1e9:.2f}GB peak={costs['peak_bytes'] / 1e9:.2f}GB "
          f"(counted {count_s:.1f}s, {costs['n_ops']} ops)")
    _save(rec, out_dir, multi_pod, arch, shape, tag)
    return rec


def _save(rec: dict, out_dir: str, multi_pod: bool, arch: str, shape: str, tag: str = "") -> None:
    d = os.path.join(out_dir, _mesh_name(multi_pod))
    os.makedirs(d, exist_ok=True)
    suffix = f"__{tag}" if tag else ""
    with open(os.path.join(d, f"{arch}__{shape}{suffix}.json"), "w") as f:
        json.dump(rec, f, indent=2, default=str)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--multipod", action="store_true")
    ap.add_argument("--compress-pods", action="store_true")
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--tag", default="")
    ap.add_argument("--out", default=OUT_DIR, help="directory of the records (default %(default)s)")
    ap.add_argument(
        "--set", action="append", default=[],
        help="ArchConfig override, e.g. --set causal_skip=True --set block_kv=1024",
    )
    args = ap.parse_args(argv)

    overrides = {}
    for kv in args.set:
        k, v = kv.split("=", 1)
        overrides[k] = json.loads(v.lower()) if v.lower() in ("true", "false") else (
            int(v) if v.lstrip("-").isdigit() else v
        )
    opts = dict(multi_pod=args.multipod, overrides=overrides or None, compress_pods=args.compress_pods,
                microbatches=args.microbatches, tag=args.tag, out_dir=args.out)

    if not args.all:
        if not args.arch or not args.shape:
            ap.error("--arch and --shape required (or --all)")
        dryrun_cell(args.arch, args.shape, **opts)
        return
    mesh = make_production_mesh(multi_pod=args.multipod, fake=True)
    failures, cells = [], list(all_cells())
    t_all = time.perf_counter()
    for arch, shape, _ in cells:
        t0 = time.perf_counter()
        try:
            dryrun_cell(arch, shape, mesh=mesh, **opts)
        except Exception as e:  # a cell's failure is reported and the table goes on
            traceback.print_exc()
            failures.append((arch, shape, repr(e)))
            print(f"[FAIL] {arch} x {shape}: {e}")
        print(f"  {arch} x {shape}: {time.perf_counter() - t0:.1f} s")
    print(f"\n{len(cells)} cells in {time.perf_counter() - t_all:.1f} s")
    if failures:
        print(f"\n{len(failures)} cell(s) FAILED:")
        for a, s, e in failures:
            print(f"  {a} x {s}: {e}")
        sys.exit(1)
    print("\nAll cells passed.")


if __name__ == "__main__":
    main()

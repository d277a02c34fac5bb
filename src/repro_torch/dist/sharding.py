"""Logical-axis sharding rules and placement derivation.

Port of ``repro.dist.sharding``; ``make_rules``, ``pspec_for_axes`` and
``cache_logical_axes`` are copies of the reference's logic on plain Python
types. Models name every parameter dimension with a *logical* axis
("embed", "heads", "kv_seq", ...); this module maps logical names to mesh
axes per (arch config, mesh, mode) and derives a spec per tensor with two
safety properties:

  - **divisibility fallback**: a dimension that does not divide evenly over
    its assigned mesh axes is replicated (that dimension only);
  - **no mesh-axis reuse**: a mesh axis consumed by an earlier dimension of
    the same tensor is dropped from later dimensions.

The rules encode the placement policy: in train, Megatron tensor
parallelism over ``model`` (heads / mlp / vocab, or experts when the expert
count divides), FSDP over ``data`` (the ``embed`` dimension of every weight,
the AdamW moments with it), batch over ``(pod, data)``; in serve, no FSDP and
the KV cache placed by the flash-decoding fallback over ``kv_seq``.

A spec is a tuple with one entry per dimension: None, a mesh-axis name, or a
tuple of names. ``shardings_for`` turns specs into DTensor placements (one
``Shard(dim)`` or ``Replicate()`` per mesh dimension) of a
``torch.distributed.device_mesh.DeviceMesh`` named ``("data", "model")`` or
``("pod", "data", "model")``. Rules and specs read only the mesh's
name -> size mapping (``mesh_shape``), so they can be derived for meshes that
do not exist (anything with a ``.shape`` dict stands in for one).
"""

from __future__ import annotations

import math
from typing import Optional

from repro_torch.models.common import ArchConfig


def mesh_shape(mesh) -> dict:
    """name -> size of a DeviceMesh (``mesh_dim_names`` with ``mesh.shape``)
    or of any object whose ``.shape`` is such a mapping."""
    names = getattr(mesh, "mesh_dim_names", None)
    if names is not None:
        return dict(zip(names, mesh.shape))
    return dict(mesh.shape)


def _axis_size(shape: dict, entry) -> int:
    axes = entry if isinstance(entry, (tuple, list)) else (entry,)
    return math.prod(shape.get(a, 1) for a in axes)


def pspec_for_axes(axes: tuple, shape: tuple, rules: dict, mesh) -> tuple:
    """The spec of one tensor: per dimension None, a mesh axis, or a tuple of
    mesh axes. ``axes``: a logical name (or None) per dimension; ``shape``:
    the dimension sizes (for the divisibility checks); ``rules``: logical
    name -> mesh axis, mesh axes or None. A tuple assignment is cut greedily
    from the right until the dimension divides (batch 8 over ("pod", "data")
    = (2, 16) falls back to "pod")."""
    sizes = mesh_shape(mesh)
    used: set = set()
    entries = []
    for ax, dim in zip(axes, shape):
        assign = rules.get(ax) if ax is not None else None
        if assign is None:
            entries.append(None)
            continue
        cand = tuple(assign) if isinstance(assign, (tuple, list)) else (assign,)
        cand = tuple(a for a in cand if a not in used and sizes.get(a, 1) > 1)
        while cand and dim % _axis_size(sizes, cand) != 0:
            cand = cand[:-1]  # greedy fallback: drop trailing axes
        if not cand:
            entries.append(None)
            continue
        used.update(cand)
        entries.append(cand if len(cand) > 1 else cand[0])
    return tuple(entries)


def spec_axes(entry) -> tuple:
    """The mesh axes of one spec entry, as a tuple."""
    if entry is None:
        return ()
    return tuple(entry) if isinstance(entry, (tuple, list)) else (entry,)


def in_mesh_order(spec: tuple, mesh) -> tuple:
    """``spec`` with each dimension's mesh axes in the mesh's order (major
    first), the order in which ``placements_for`` cuts a dimension split over
    several axes. The serve rules' ``kv_seq`` lists ``model`` before the data
    axes; a cache's slots are cut in the mesh's order."""
    names = list(getattr(mesh, "mesh_dim_names", None) or mesh_shape(mesh))
    out = []
    for entry in spec:
        axes = sorted(spec_axes(entry), key=names.index)
        out.append(None if not axes else (axes[0] if len(axes) == 1 else tuple(axes)))
    return tuple(out)


def local_shape(shape: tuple, spec: tuple, mesh) -> tuple:
    """The shape of one rank's shard of a tensor of ``shape`` placed by
    ``spec`` (each dimension divided by the ranks of its mesh axes)."""
    sizes = mesh_shape(mesh)
    return tuple(d // _axis_size(sizes, spec_axes(e)) for d, e in zip(shape, spec))


LOGITS_AXES = ("batch", "vocab")  # the serve fns' logits (B, V), as the reference places them


def placements_for(spec: tuple, mesh) -> tuple:
    """DTensor placements of a spec: per mesh dimension, ``Shard(d)`` for the
    tensor dimension d that names it, else ``Replicate()``. A dimension over
    several mesh axes is split by them in the spec's order (major first), as
    DTensor orders shards of one dimension by mesh dimension."""
    from torch.distributed.tensor import Replicate, Shard

    names = list(getattr(mesh, "mesh_dim_names", None) or mesh_shape(mesh))
    where = {a: d for d, entry in enumerate(spec) for a in spec_axes(entry)}
    for entry in spec:
        order = list(spec_axes(entry))
        if order != sorted(order, key=names.index):
            raise ValueError(f"spec {spec}: a dimension's mesh axes out of the mesh's order {names}")
    return tuple(Shard(where[n]) if n in where else Replicate() for n in names)


def _is_axes_leaf(x) -> bool:
    return isinstance(x, tuple) and all(e is None or isinstance(e, str) for e in x)


def _tree_map2(fn, axes, shapes):
    if _is_axes_leaf(axes):
        return fn(axes, shapes)
    if isinstance(axes, dict):
        return {k: _tree_map2(fn, axes[k], shapes[k]) for k in axes}
    if isinstance(axes, list):
        if len(axes) != len(shapes):
            raise ValueError(f"axes list of {len(axes)} for {len(shapes)} leaves")
        return [_tree_map2(fn, a, s) for a, s in zip(axes, shapes)]
    raise TypeError(f"not an axes tree node: {axes!r}")


def _shape(t) -> tuple:
    """A leaf's shape; () for a host scalar (a cache's ``index``)."""
    return tuple(getattr(t, "shape", ()))


def specs_for(axes_tree, shapes_tree, rules: dict, mesh):
    """Spec tree from parallel (logical axes, tensors) trees."""
    return _tree_map2(lambda ax, t: pspec_for_axes(ax, _shape(t), rules, mesh), axes_tree, shapes_tree)


def shardings_for(axes_tree, shapes_tree, rules: dict, mesh):
    """Placements tree (a tuple of ``Shard`` / ``Replicate`` per leaf) from
    parallel (logical axes, tensors) trees."""
    return _tree_map2(
        lambda ax, t: placements_for(pspec_for_axes(ax, _shape(t), rules, mesh), mesh),
        axes_tree, shapes_tree,
    )


def make_rules(
    cfg: ArchConfig,
    mesh,
    mode: str,
    global_batch: Optional[int] = None,
) -> dict:
    """Logical axis name -> mesh axis assignment for one (arch, mesh, mode).

    mode: "train" | "serve". global_batch=None assumes a batch large enough
    to occupy the data axes (capacity-planning default).
    """
    if mode not in ("train", "serve"):
        raise ValueError(f"unknown mode {mode!r} (want 'train' or 'serve')")
    sizes = mesh_shape(mesh)
    model = "model" if sizes.get("model", 1) > 1 else None
    tp = sizes.get("model", 1)
    data_axes = tuple(a for a in ("pod", "data") if sizes.get(a, 1) > 1)
    dp = _axis_size(sizes, data_axes)
    batch_ok = bool(data_axes) and (
        global_batch is None or (global_batch >= dp and global_batch % dp == 0)
    )

    rules: dict = {
        "layers": None,
        "seq": None,
        "head_dim": None,
        "q_lora": None,
        "kv_lora": None,
        "vocab": model if cfg.vocab % tp == 0 else None,
        "heads": model if cfg.n_heads_eff % tp == 0 else None,
        "kv_heads": model if cfg.n_kv_heads % tp == 0 else None,
        "inner": model if cfg.d_inner % tp == 0 else None,
        "batch": (
            (data_axes if len(data_axes) > 1 else data_axes[0]) if batch_ok else None
        ),
        "moe_group": None,
    }

    # MoE FFN: expert parallelism when the expert count divides the model
    # axis; otherwise replicate experts and tensor-shard the ffn dim.
    if cfg.n_experts and cfg.n_experts % tp == 0:
        rules["experts"], rules["mlp"] = model, None
    else:
        rules["experts"] = None
        rules["mlp"] = model if (cfg.d_ff and cfg.d_ff % tp == 0) else None
    if cfg.moe_groups and "data" in sizes:
        rules["moe_group"] = "data"

    # FSDP (ZeRO-3 posture) is a throughput lever: train only.
    rules["embed"] = "data" if (mode == "train" and "data" in sizes) else None

    # serve: KV-cache placement (flash-decoding fallback on the seq axis)
    kv_seq: list = []
    if mode == "serve":
        if model and cfg.n_kv_heads % tp != 0:
            kv_seq.append("model")
        if data_axes and not batch_ok:
            kv_seq.extend(data_axes)
    rules["kv_seq"] = tuple(kv_seq) if kv_seq else None
    return rules


def cache_logical_axes(cfg: ArchConfig, max_len: int) -> list:
    """Logical-axes tree mirroring ``Model.init_cache(batch, max_len)``: one
    dict per layer (the port keeps a cache per layer where the reference
    stacks them per layout position over a leading "layers" axis), each
    leaf one logical name or None per dimension; ``index`` is ()."""

    def attention_axes() -> dict:
        if cfg.attention == "mla":
            return {
                "c_kv": ("batch", "kv_seq", "kv_lora"),
                "k_rope": ("batch", "kv_seq", None),
                "index": (),
            }
        c = {
            "k": ("batch", "kv_seq", "kv_heads", "head_dim"),
            "v": ("batch", "kv_seq", "kv_heads", "head_dim"),
            "index": (),
        }
        S = min(max_len, cfg.window) if (cfg.attention == "swa" and cfg.window) else max_len
        if cfg.attention == "swa" and cfg.window and S == cfg.window:
            c["pos"] = ("batch", "kv_seq")  # ring-buffer slot positions
        return c

    def mamba_axes() -> dict:
        return {"h": ("batch", "inner", None), "conv": ("batch", None, "inner")}

    return [
        mamba_axes() if cfg.layout[i % len(cfg.layout)].mixer == "mamba" else attention_axes()
        for i in range(cfg.n_layers)
    ]

"""Train and serve step builders, on one device or on a DeviceMesh.

Port of ``repro.dist.step``. Instead of donating the state, as the jitted
JAX steps do, the steps update it in place: the train step its params,
moments and step count under ``torch.no_grad()``; the serve functions, under
``torch.inference_mode()``, the caches' K/V.

``make_train_step(model, device, ...)`` is the one-device step. Given a
``DeviceMesh`` (``repro_torch.launch.mesh``), it is the sharded step, and
returns it with the state's shapes and placements and the batch's
placements, as the reference does:

  - the state {params, opt {m, v, count}, step} (and ``compress`` with
    ``compress_pods``) is a tree of DTensors placed as ``shardings_for`` of
    the logical axes says (``place_state`` puts a whole state there; every
    rank computes the same whole state from one seed);
  - the batch's rows are split over the mesh axes of ``rules["batch"]``
    (greedy fallback): each rank takes its own rows of the global batch it is
    given, for each microbatch its part of that microbatch's rows, so that a
    microbatch holds the rows it holds on one device;
  - FSDP (``embed`` over ``data``): params, m and v are stored as shards,
    and a forward all-gathers each leaf over ``data`` (the tensor-parallel
    shards stay local) inside the graph, so that the backward
    reduce-scatters each gradient into its shard as soon as it is complete
    (in the params' dtype, as FSDP reduces by default; the other data axes
    are summed in f32). The leaves outside the trunk (``embed``,
    ``lm_head``, ``final_norm``, the encoder's ``norm``) are gathered before
    the model runs; the trunk's reach the model as shards, and each layout
    period (each encoder layer) gathers its own inside its checkpointed
    function (``models.common.gather_params``, through the rules context),
    as the reference's scan gathers each group's slice in its body. Under
    remat ``block`` and ``full`` a rank so holds one period's weights
    gathered at a time, and the recompute gathers them again;
  - each rank's loss is the mean over its rows, and the gradients are
    averaged over the data axes (pod and data), which is the global mean when
    the splits are equal, as in the reference; with ``compress_pods`` the pod
    reduction runs on the int8 payload (``optim.compress.ef_compress``);
  - the compute runs under ``axis_rules(rules, mesh)``: the model code holds
    heads, kv heads, mlp, vocab, experts and Mamba channels as the local
    shards over ``model`` and reduces across ranks itself (see
    ``models.attention``, ``models.moe``, ``models.mamba``, ``models
    .transformer``);
  - the global norm sums every element once (``optim.adamw.global_norm`` of
    a placed tree), and AdamW updates each rank's shards in place.

``make_serve_fns(model, device, ...)`` are the one-device serve functions.
Given a DeviceMesh, they serve on it and come back with the state's shapes
and placements, as the reference's do: the serve rules (no FSDP; where the
KV heads do not divide ``model`` or the global batch does not fill the data
axes, the caches' slots go over ``kv_seq``, the flash-decoding fallback);
params placed as DTensors (``place_serve_params``: Mamba's ``in_proj`` as
its (d, 2, Di) view, so a rank keeps its own x and z columns and no call
gathers the weight); a state of this rank's cache shards alone
(``placed_serve_state``, also ``registry.init_serve_state`` given the mesh);
the global tokens on every rank, each taking its rows; the model code's
tensor-, expert- and channel-parallel branches and its placed-cache
attention (``models.attention``) under ``axis_rules(rules, mesh)``; logits
back as a DTensor placed by ("batch", "vocab").
"""

from __future__ import annotations

from typing import Callable, Optional

import torch
import torch.distributed as dist

from repro_torch.models import attention as attn
from repro_torch.models.common import axis_rules, get_axis_rules, resolve_device
from repro_torch.models.registry import decode_step, prefill, train_loss
from repro_torch.optim import adamw_update, ef_compress, global_norm
from repro_torch.optim.adamw import _spec_leaves, tree_leaves, tree_map

from .comm import TP_AXES, comm_for, gather
from .sharding import (
    LOGITS_AXES,
    cache_logical_axes,
    in_mesh_order,
    local_shape,
    make_rules,
    mesh_shape,
    placements_for,
    pspec_for_axes,
    shardings_for,
    spec_axes,
    specs_for,
)

DATA_AXES = ("pod", "data")
# the params the model gathers itself under FSDP, a layout period (an
# encoder layer) at a time (``models.transformer``)
TRUNK = (("layers",), ("encoder", "layers"))


def is_mesh(x) -> bool:
    """Whether ``x`` is a DeviceMesh (as opposed to a device)."""
    return getattr(x, "mesh_dim_names", None) is not None and hasattr(x, "get_coordinate")


def mesh_device(mesh) -> torch.device:
    """The device this rank's shards live on: ``meta`` on torch's fake
    backend (a planned mesh of ranks that do not exist: shapes, no bytes),
    else the mesh's own."""
    if dist.is_initialized() and str(dist.get_backend()) == "fake":
        return torch.device("meta")
    if mesh.device_type == "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(mesh.device_type)


def param_specs(model):
    """(meta params, logical-axes tree) of the model: shapes and dtypes, no
    parameter allocated."""
    return model.init(0, "meta", with_axes=True)


def make_batch_specs(cfg, kind: str, global_batch: int, seq_len: int) -> dict:
    """A ghost batch (meta tensors) of one input shape: tokens, labels in
    train, and the stub ``frames`` / ``prefix`` where the model takes them."""
    meta = lambda shape, dtype: torch.empty(shape, dtype=dtype, device="meta")
    batch = {"tokens": meta((global_batch, seq_len), torch.int32)}
    if kind == "train":
        batch["labels"] = meta((global_batch, seq_len), torch.int32)
    if cfg.encoder_layers:
        batch["frames"] = meta((global_batch, cfg.frontend_len, cfg.d_model), cfg.compute_dtype())
    if cfg.frontend == "vision":
        batch["prefix"] = meta((global_batch, cfg.frontend_len, cfg.d_model), cfg.compute_dtype())
    return batch


def make_train_state_specs(model, with_axes: bool = False):
    """The train state {params, opt {m, v, count}, step} as meta tensors of
    the right shapes and dtypes (no parameter is allocated): m and v f32
    mirror the params, count and step are int32 scalars. With ``with_axes``,
    returns (state, state logical axes): the moments inherit the params'
    axes, so FSDP shards them as it shards the weights."""
    params, paxes = param_specs(model)
    f32 = lambda p: torch.empty(p.shape, dtype=torch.float32, device="meta")
    scalar = lambda: torch.empty((), dtype=torch.int32, device="meta")
    state = {
        "params": params,
        "opt": {"m": tree_map(f32, params), "v": tree_map(f32, params), "count": scalar()},
        "step": scalar(),
    }
    if not with_axes:
        return state
    return state, {"params": paxes, "opt": {"m": paxes, "v": paxes, "count": ()}, "step": ()}


# ---------------------------------------------------------------------------
# Placed trees
# ---------------------------------------------------------------------------


def _outside_trunk(fn, tree: dict, path: tuple = ()) -> dict:
    """``tree`` with ``fn(subtree)`` in place of each subtree outside
    ``TRUNK``: a leaf, or a list that is not a trunk."""
    if path in TRUNK:
        return tree
    if isinstance(tree, dict):
        return {k: _outside_trunk(fn, v, path + (k,)) for k, v in tree.items()}
    return fn(tree)


def fsdp_units(cfg, params: dict) -> tuple:
    """What FSDP gathers of ``params`` (a params tree of a model of ``cfg``)
    and when: (the tree of the leaves outside ``TRUNK``, gathered before the
    model runs; the list of the trunk's units, each gathered inside the
    model, one at a time: each layout period of ``layers``, each encoder
    layer)."""
    def outside(tree, path=()):
        if not isinstance(tree, dict):
            return tree
        return {k: outside(v, path + (k,)) for k, v in tree.items() if path + (k,) not in TRUNK}

    period = len(cfg.layout)
    units = [params["layers"][g : g + period] for g in range(0, len(params["layers"]), period)]
    units += [[p] for p in params.get("encoder", {}).get("layers", [])]
    return outside(params), units


def _tree_zip(fn, tree, other):
    if isinstance(tree, dict):
        return {k: _tree_zip(fn, tree[k], other[k]) for k in tree}
    if isinstance(tree, list):
        return [_tree_zip(fn, t, o) for t, o in zip(tree, other)]
    return fn(tree, other)


def place(t: torch.Tensor, mesh, placements: tuple, device=None):
    """The DTensor of a whole tensor ``t`` that every rank holds alike: this
    rank's shard sliced off locally (no communication), in storage of its
    own, so that the whole tensor is freed once its holder drops it (a slice
    of the leading dimension is a contiguous view of the whole)."""
    from torch.distributed.tensor import DTensor, Shard

    comm = comm_for(mesh)
    local = t
    for d in range(t.dim()):
        axes = tuple(n for n, pl in zip(comm.names, placements) if isinstance(pl, Shard) and pl.dim == d)
        if axes:
            local = comm.shard(local, d, axes)
    local = local.to(device if device is not None else mesh_device(mesh))
    local = local.clone(memory_format=torch.contiguous_format) if local.numel() < t.numel() else local.contiguous()
    return DTensor.from_local(local, mesh, placements, run_check=False)


def place_state(state, shardings, mesh, device=None):
    """``place`` of every leaf of a whole state tree."""
    return _tree_zip(lambda t, pl: place(t, mesh, pl, device), state, shardings)


def placed_train_state(params, state_shard, mesh) -> dict:
    """A fresh train state on the mesh from whole ``params`` that every rank
    holds alike: the params sliced into their shards, the AdamW moments made
    as zero shards and the counters as zeros (never whole: a state's f32
    moments are 4x its bf16 params)."""
    from torch.distributed.tensor import DTensor

    placed = place_state(params, state_shard["params"], mesh)
    zeros = lambda t: DTensor.from_local(torch.zeros(t.to_local().shape, dtype=torch.float32,
                                                     device=t.to_local().device), mesh, t.placements, run_check=False)
    dev = mesh_device(mesh)
    scalar = lambda pl: place(torch.zeros((), dtype=torch.int32, device=dev), mesh, pl)
    return {"params": placed, "opt": {"m": tree_map(zeros, placed), "v": tree_map(zeros, placed),
                                      "count": scalar(state_shard["opt"]["count"])},
            "step": scalar(state_shard["step"])}


def gather_full(t) -> torch.Tensor:
    """The whole tensor of a DTensor (all-gathers over its sharded mesh
    dimensions; a dimension split over several is gathered over them at
    once, major first)."""
    from torch.distributed.tensor import Shard

    comm = comm_for(t.device_mesh)
    out = t.to_local()
    for d in range(t.dim()):
        axes = tuple(n for n, pl in zip(comm.names, t.placements) if isinstance(pl, Shard) and pl.dim == d)
        if axes:
            out = comm.all_gather(out, d, axes)
    return out


def gather_state(state):
    """Every leaf of a placed tree gathered whole (plain tensors)."""
    return tree_map(gather_full, state)


# ---------------------------------------------------------------------------
# Train step
# ---------------------------------------------------------------------------


def _check_rules(rules: dict) -> None:
    """The placements the sharded compute implements."""
    for name, want in (("embed", (None, "data")), ("kv_seq", (None,))):
        if rules.get(name) not in want:
            raise NotImplementedError(f"rules[{name!r}] = {rules.get(name)!r}: the train step takes {want}")
    for name in TP_AXES:
        if rules.get(name) not in (None, "model"):
            raise NotImplementedError(f"rules[{name!r}] = {rules.get(name)!r}: tensor parallelism is over 'model'")
    if not set(spec_axes(rules.get("batch"))) <= set(DATA_AXES):
        raise NotImplementedError(f"rules['batch'] = {rules.get('batch')!r}: the batch splits over pod and data")


def _batch_rows(n_rows: int, micro: int, index: int, dp: int) -> torch.Tensor:
    """This batch rank's rows: its 1/dp part of each of ``micro`` equal
    microbatches, microbatch-major."""
    n = n_rows // micro
    part = n // dp
    return torch.cat([torch.arange(i * n + index * part, i * n + (index + 1) * part) for i in range(micro)])


def make_train_step(
    model,
    mesh_or_device,
    schedule: Callable,
    *,
    rules: Optional[dict] = None,
    global_batch: int,
    microbatches: int = 1,
    compress_pods: bool = False,
):
    """The train step ``train_step(state, batch) -> (state, metrics)``.

    On a device: the one-device step, returned alone. ``state`` is
    {"params", "opt": adamw state, "step": int32 scalar}, all on the device;
    the step updates it in place and returns it. ``batch`` holds tokens and
    labels (B, L) int32, and ``frames`` or ``prefix`` (B, T, D) where the
    model takes them (``registry.train_loss``). metrics: loss, lr, grad_norm
    and clip_scale, f32 scalars on the device. ``microbatches > 1`` sums f32
    gradients over equal splits of the batch (every key's rows) and divides by
    their number, as the reference does. ``compress_pods`` needs a pod axis,
    so on one device it changes nothing, as in the reference on a mesh
    without pods. Raises if ``device`` is CUDA and no card is present.

    On a DeviceMesh: the sharded step (module docstring), returned as
    ``(train_step, state_shapes, state_shard, batch_shard)``: the state's
    meta tensors, its placements tree and the batch's (``tokens``,
    ``labels``, and ``frames`` / ``prefix`` where the model takes them).
    ``placed_train_state`` makes a fresh state from whole params.
    ``rules`` default to ``make_rules(cfg, mesh, "train", global_batch)``.
    The state is placed (``place_state``); the batch is the global batch,
    the same on every rank. The loss is averaged over the data axes, equal on
    every rank; with pod compression, metrics also hold ``compress_ratio``
    and ``wire_bytes_per_param``."""
    if not is_mesh(mesh_or_device):
        return _device_train_step(model, mesh_or_device, schedule, global_batch=global_batch,
                                  microbatches=microbatches)
    return _mesh_train_step(model, mesh_or_device, schedule, rules=rules, global_batch=global_batch,
                            microbatches=microbatches, compress_pods=compress_pods)


def _loss_and_grads(model, params, batch, fsdp=None):
    """(loss, the gradient of each leaf of ``params``); ``fsdp`` maps the
    leaves to FSDP's gather of a tree of them, inside the graph, whose
    backward reduce-scatters: the step applies it to the leaves outside the
    trunk, and installs it beside the axis rules for the model's periods
    (``models.common.gather_params``)."""
    leaves = [p.detach().requires_grad_() for p in tree_leaves(params)]
    it = iter(leaves)
    live = tree_map(lambda _: next(it), params)
    if fsdp is None:
        loss, _ = train_loss(model, live, batch)
    else:
        gather_tree = fsdp(leaves)
        with axis_rules(*get_axis_rules()[:2], gather_tree):
            loss, _ = train_loss(model, _outside_trunk(gather_tree, live), batch)
    return loss.detach(), torch.autograd.grad(loss, leaves)


def _accumulate(model, params, batch: dict, microbatches: int, n_rows: int, fsdp=None):
    """(loss, grads) of ``batch``, f32 gradients summed over equal splits of
    its ``n_rows`` rows and divided by their number where ``microbatches`` >
    1, as the reference does."""
    if microbatches == 1:
        return _loss_and_grads(model, params, batch, fsdp)
    n = n_rows // microbatches
    gsum = [torch.zeros(p.shape, dtype=torch.float32, device=p.device) for p in tree_leaves(params)]
    lsum = torch.zeros((), dtype=torch.float32, device=batch["tokens"].device)
    for i in range(microbatches):
        loss, grads = _loss_and_grads(model, params, {k: v[i * n : (i + 1) * n] for k, v in batch.items()},
                                      fsdp)
        for a, g in zip(gsum, grads):
            a.add_(g.float())
        lsum = lsum + loss
        del grads
    return lsum / microbatches, [a / microbatches for a in gsum]


def _device_train_step(model, device, schedule: Callable, *, global_batch: int, microbatches: int):
    dev = resolve_device(device)
    if microbatches < 1 or global_batch % microbatches:
        raise ValueError(f"global_batch {global_batch} not divisible by microbatches {microbatches}")

    def train_step(state, batch):
        tokens = batch["tokens"]
        if tokens.device.type != dev.type or tokens.shape[0] != global_batch:
            raise ValueError(f"tokens {tuple(tokens.shape)} on {tokens.device}: want batch "
                             f"{global_batch} on {dev}")
        params = state["params"]
        lr = schedule(state["step"]).to(torch.float32)
        loss, grads = _accumulate(model, params, batch, microbatches, global_batch)
        it = iter(grads)
        grads = tree_map(lambda _: next(it), params)
        with torch.no_grad():
            om = adamw_update(params, grads, state["opt"], lr)
            state["step"].add_(1)
        return state, {"loss": loss, "lr": lr, "grad_norm": om["grad_norm"], "clip_scale": om["clip_scale"]}

    return train_step


def _mesh_train_step(model, mesh, schedule: Callable, *, rules, global_batch: int, microbatches: int,
                     compress_pods: bool):
    cfg = model.cfg
    rules = dict(rules) if rules is not None else make_rules(cfg, mesh, "train", global_batch)
    _check_rules(rules)
    sizes = mesh_shape(mesh)
    comm = comm_for(mesh)
    dev = mesh_device(mesh)
    if microbatches < 1 or global_batch % microbatches:
        raise ValueError(f"global_batch {global_batch} not divisible by microbatches {microbatches}")

    state_shapes, state_axes = make_train_state_specs(model, with_axes=True)
    n_pods = sizes.get("pod", 1)
    compress = bool(compress_pods) and n_pods > 1
    if compress:
        state_shapes["compress"] = {"residual": tree_map(
            lambda p: torch.empty(p.shape, dtype=torch.float32, device="meta"), state_shapes["params"])}
        state_axes["compress"] = {"residual": state_axes["params"]}
    specs = specs_for(state_axes, state_shapes, rules, mesh)
    state_shard = shardings_for(state_axes, state_shapes, rules, mesh)
    pspecs = specs["params"]

    # the batch: split over the axes its spec keeps; the model sees those
    batch_entry = pspec_for_axes(("batch", None), (global_batch, 1), rules, mesh)[0]
    batch_axes = spec_axes(batch_entry)
    dp = comm.size(batch_axes)
    if (global_batch // microbatches) % dp:
        raise ValueError(f"a microbatch of {global_batch // microbatches} rows does not split over "
                         f"{batch_axes} = {dp} ranks")
    run_rules = dict(rules, batch=batch_entry)
    tok = placements_for((batch_entry, None), mesh)
    three = placements_for((batch_entry, None, None), mesh)
    batch_shard = {"tokens": tok, "labels": tok}
    if cfg.encoder_layers:
        batch_shard["frames"] = three
    if cfg.frontend == "vision":
        batch_shard["prefix"] = three
    rows = _batch_rows(global_batch, microbatches, comm.index(batch_axes), dp)

    reduce_axes = tuple(a for a in DATA_AXES if sizes.get(a, 1) > 1 and not (compress and a == "pod"))
    n_avg = comm.size(tuple(a for a in DATA_AXES if a in sizes))
    # each leaf's FSDP gathers: (dim, data axes) of the dims split over them
    gathers = [tuple((d, spec_axes(e)) for d, e in enumerate(sp) if set(spec_axes(e)) & set(DATA_AXES))
               for sp in _spec_leaves(pspecs)]

    def gather_leaf(leaf: torch.Tensor, gs) -> torch.Tensor:
        for d, axes in gs:
            leaf = gather(leaf, comm, d, axes)
        return leaf

    def fsdp(leaves: list):
        """FSDP's gather of a tree of this forward's ``leaves``: each leaf
        gathered whole over its data axes, in the graph, so that the backward
        reduce-scatters its gradient as soon as it is complete (in the leaf's
        dtype) and no whole gradient outlives its leaf's. A leaf is found by
        identity: the model's periods hand it their own leaves, and their
        recompute (a checkpoint's) the same objects."""
        by_id = {id(leaf): gs for leaf, gs in zip(leaves, gathers)}
        return lambda tree: tree_map(lambda t: gather_leaf(t, by_id[id(t)]), tree)

    def to_storage(g: torch.Tensor, gs) -> torch.Tensor:
        """A shard's gradient, summed over its gathered axes already: summed
        in f32 over the other data axes, and averaged."""
        g = g.float()
        done = {a for _, axes in gs for a in axes}
        rest = tuple(a for a in reduce_axes if a not in done)
        if rest:
            g = comm.all_reduce(g.contiguous(), rest)
        return g / (n_avg if not compress else n_avg // n_pods) if n_avg > 1 else g

    def train_step(state, batch):
        tokens = batch["tokens"]
        if tokens.shape[0] != global_batch or tokens.device != dev:
            raise ValueError(f"tokens {tuple(tokens.shape)} on {tokens.device}: want the global batch "
                             f"{global_batch} on {dev}")
        local_batch = {k: v.index_select(0, rows.to(v.device)) for k, v in batch.items()} if dp > 1 else batch
        shards = tree_map(lambda t: t.to_local(), state["params"])
        lr = schedule(state["step"].to_local()).to(torch.float32)
        with axis_rules(run_rules, mesh):
            loss, grads = _accumulate(model, shards, local_batch, microbatches, global_batch // dp, fsdp)
        with torch.no_grad():
            grads = list(grads)
            for i, gs in enumerate(gathers):  # leaf by leaf, each one's own-dtype gradient freed as it goes
                grads[i] = to_storage(grads[i], gs)
            it = iter(grads)
            grads = tree_map(lambda _: next(it), shards)
            metrics = {}
            if compress:
                grads, cstate, stats = ef_compress(
                    grads, {"residual": tree_map(lambda t: t.to_local(), state["compress"]["residual"])},
                    comm.group("pod"), n_pods)
                for dst, src in zip(tree_leaves(state["compress"]["residual"]), tree_leaves(cstate["residual"])):
                    dst.to_local().copy_(src)
                metrics.update(stats)
            opt = {"m": tree_map(lambda t: t.to_local(), state["opt"]["m"]),
                   "v": tree_map(lambda t: t.to_local(), state["opt"]["v"]),
                   "count": state["opt"]["count"].to_local()}
            gnorm = global_norm(grads, pspecs, comm)
            om = adamw_update(shards, grads, opt, lr, grad_norm=gnorm)
            state["step"].to_local().add_(1)
            loss = comm.all_reduce(loss.clone(), tuple(a for a in DATA_AXES if a in sizes))
            if n_avg > 1:
                loss = loss / n_avg
        metrics.update({"loss": loss, "lr": lr, "grad_norm": om["grad_norm"], "clip_scale": om["clip_scale"]})
        return state, metrics

    return train_step, state_shapes, state_shard, batch_shard


def serve_params(tree):
    """The serve view of a params tree (or of its logical axes): Mamba's
    ``in_proj`` (d, 2 Di) as (d, 2, Di), axes ("embed", None, "inner"), so
    that its shard over ``inner`` is a rank's own x and z columns
    ``[x_r | z_r]`` (``models.mamba``); every other leaf as it is. A view: no
    copy."""
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            if k == "in_proj" and isinstance(v, tuple) and len(v) == 2:
                out[k] = (v[0], None, v[1])
            elif k == "in_proj" and hasattr(v, "dim") and v.dim() == 2:
                out[k] = v.view(v.shape[0], 2, v.shape[1] // 2)
            else:
                out[k] = serve_params(v)
        return out
    if isinstance(tree, list):
        return [serve_params(v) for v in tree]
    return tree


def place_serve_params(params, shards, mesh):
    """Whole ``params`` that every rank holds alike, placed for serving: a tree
    of DTensors of ``serve_params``' view by ``shards["params"]`` of
    ``make_serve_fns`` (each rank slices its shards; no communication)."""
    return place_state(serve_params(params), shards["params"], mesh)


def _check_serve_rules(rules: dict) -> None:
    """The placements the sharded serve implements."""
    if rules.get("embed") is not None:
        raise NotImplementedError(f"rules['embed'] = {rules['embed']!r}: the serve fns take no FSDP")
    for name in TP_AXES:
        if rules.get(name) not in (None, "model"):
            raise NotImplementedError(f"rules[{name!r}] = {rules.get(name)!r}: tensor parallelism is over 'model'")
    if not set(spec_axes(rules.get("batch"))) <= set(DATA_AXES):
        raise NotImplementedError(f"rules['batch'] = {rules.get('batch')!r}: the batch splits over pod and data")
    if not set(spec_axes(rules.get("kv_seq"))) <= {"model", *DATA_AXES}:
        raise NotImplementedError(f"rules['kv_seq'] = {rules.get('kv_seq')!r}: the slots split over model and data")


class _ServePlan:
    """Where a serve state lives on a mesh: the rules the model code runs
    under (the batch entry as its spec keeps it), this rank's rows of the
    global batch, and each cache leaf's spec (its slots cut in the mesh's
    order)."""

    def __init__(self, model, mesh, global_batch: int, max_len: int, rules: Optional[dict]):
        cfg = model.cfg
        rules = dict(rules) if rules is not None else make_rules(cfg, mesh, "serve", global_batch)
        _check_serve_rules(rules)
        self.mesh, self.comm = mesh, comm_for(mesh)
        entry = pspec_for_axes(("batch", None), (global_batch, 1), rules, mesh)[0]
        self.batch_axes = spec_axes(entry)
        self.rules = dict(rules, batch=entry)
        dp = self.comm.size(self.batch_axes)
        self.rows = global_batch // dp
        self.row0 = self.comm.index(self.batch_axes) * self.rows
        self.dp = dp
        self.caches = model.init_cache(global_batch, max_len, "meta")
        self.cache_specs = [
            {k: in_mesh_order(pspec_for_axes(ax, tuple(c[k].shape), self.rules, mesh), mesh)
             for k, ax in axes.items() if k != "index"}
            for axes, c in zip(cache_logical_axes(cfg, max_len), self.caches)
        ]

    def split(self, specs: dict):
        """The cache's ``split`` entry: (this rank's index, the mesh axes) of
        its slots' dimension, or None where its slots are whole."""
        axes = spec_axes(specs.get("k", specs.get("c_kv", (None, None)))[1])
        return (self.comm.index(axes), axes) if axes else None

    def local_caches(self, device) -> list:
        """Each layer's cache, this rank's shards alone (zeros; a ring's
        positions -1), index 0."""
        out = []
        for c, specs in zip(self.caches, self.cache_specs):
            local = {}
            for k, t in c.items():
                if k == "index":
                    local[k] = 0
                    continue
                shape = local_shape(tuple(t.shape), specs[k], self.mesh)
                fill = -1 if k == "pos" else 0
                local[k] = torch.full(shape, fill, dtype=t.dtype, device=device)
            split = self.split(specs)
            if split is not None:
                local["split"] = split
            out.append(local)
        return out

    def take_rows(self, t):
        return t if t is None or self.dp == 1 else t[self.row0 : self.row0 + self.rows]


def placed_serve_state(model, global_batch: int, max_len: int, mesh, rules: Optional[dict] = None) -> dict:
    """The serve state on a mesh: each rank allocates only its own shard of
    every cache (batch rows over the data axes, KV heads or Mamba channels
    over ``model``, slices of the slots over ``kv_seq``), never the whole
    cache; ``t`` and each cache's ``index`` are host ints, the same on every
    rank. ``rules`` default to the serve rules of ``global_batch``."""
    plan = _ServePlan(model, mesh, global_batch, max_len, rules)
    return {"caches": plan.local_caches(mesh_device(mesh)), "t": 0}


def make_serve_fns(model, device="cuda", *, max_len: int, global_batch: int, rules: Optional[dict] = None):
    """The serve functions
      prefill_fn(params, tokens, state, frames=None, prefix=None) -> (logits, state)
      decode_fn(params, tokens, state) -> (logits, state)
    Each checks the tokens and every layer's cache (and an encoder's memory)
    against the sizes first. Raises if the device is CUDA and no card is
    present.

    On a device (``device``): (prefill_fn, decode_fn), for states made by
    ``init_serve_state(model, global_batch, max_len, device)``; logits (B, V).

    On a DeviceMesh (``device``): ``(prefill_fn, decode_fn, state_shapes, shards)``, as the
    reference returns them. ``rules`` default to ``make_rules(cfg, mesh,
    "serve", global_batch)`` (no FSDP; the flash-decoding fallback puts the
    caches' slots over ``kv_seq``). ``state_shapes``: the global state as meta
    tensors; ``shards``: {"params": placements of ``serve_params``' view,
    "state": {"caches": placements, "t": ()}}. The params are the tree
    ``place_serve_params(params, shards, mesh)`` makes (DTensors; each call
    takes their local shards); the state is ``init_serve_state(model,
    global_batch, max_len, mesh)``'s, this rank's shards; the tokens (and
    frames, prefix) the global ones, the same on every rank, of which each
    rank takes its own rows. Logits come back as a DTensor placed by
    ("batch", "vocab") (``gather_full`` makes the global (B, V) on every
    rank). Everything runs under ``axis_rules(rules, mesh)``."""
    if not is_mesh(device):
        return _device_serve_fns(model, device, max_len=max_len, global_batch=global_batch)
    return _mesh_serve_fns(model, device, max_len=max_len, global_batch=global_batch, rules=rules)


def _local_params(params):
    from torch.distributed.tensor import DTensor

    return tree_map(lambda t: t.to_local() if isinstance(t, DTensor) else t, params)


def _mesh_serve_fns(model, mesh, *, max_len: int, global_batch: int, rules: Optional[dict]):
    from torch.distributed.tensor import DTensor

    cfg = model.cfg
    plan = _ServePlan(model, mesh, global_batch, max_len, rules)
    run_rules, dev = plan.rules, mesh_device(mesh)
    pmeta, paxes = param_specs(model)
    param_shard = shardings_for(serve_params(paxes), serve_params(pmeta), run_rules, mesh)
    cache_shard = [{k: placements_for(sp, mesh) for k, sp in specs.items()} for specs in plan.cache_specs]
    state_shapes = {"caches": plan.caches, "t": 0}
    shards = {"params": param_shard, "state": {"caches": cache_shard, "t": ()}}
    logits_pl = placements_for(pspec_for_axes(LOGITS_AXES, (global_batch, cfg.vocab), run_rules, mesh), mesh)
    kv_spec = pspec_for_axes(("batch", None, "kv_heads", "head_dim"),
                             (global_batch, cfg.frontend_len, cfg.n_kv_heads, cfg.head_dim), run_rules, mesh)
    memory_kv_shape = local_shape((global_batch, cfg.frontend_len, cfg.n_kv_heads, cfg.head_dim), kv_spec, mesh)

    def _want(name: str, a: torch.Tensor, shape: tuple) -> None:
        if tuple(a.shape) != tuple(shape) or a.device.type != dev.type:
            raise ValueError(f"{name} {tuple(a.shape)} on {a.device}: want this rank's {tuple(shape)} on {dev}")

    def _check(tokens, state, frames=None, prefix=None) -> None:
        if tokens.device.type != dev.type or tokens.shape[0] != global_batch:
            raise ValueError(f"tokens {tuple(tokens.shape)} on {tokens.device}: want the global batch "
                             f"{global_batch} on {dev}")
        caches = state["caches"]
        if len(caches) != cfg.n_layers:
            raise ValueError(f"{len(caches)} caches for {cfg.n_layers} layers")
        for i, (c, meta, specs) in enumerate(zip(caches, plan.caches, plan.cache_specs)):
            for k, t in meta.items():
                if k != "index":
                    _want(f"layer {i} cache {k}", c[k], local_shape(tuple(t.shape), specs[k], mesh))
            if c.get("split") != plan.split(specs):
                raise ValueError(f"layer {i} cache split {c.get('split')}: want {plan.split(specs)}")
        T, d = cfg.frontend_len, cfg.d_model
        for name, a in (("frames", frames), ("prefix", prefix)):
            if a is not None:
                _want(name, a, (global_batch, T, d))
        if "memory" in state:
            _want("memory", state["memory"], (plan.rows, T, d))
            if len(state["memory_kv"]) != cfg.n_layers:
                raise ValueError(f"{len(state['memory_kv'])} memory K/V pairs for {cfg.n_layers} layers")
            for i, kv in enumerate(state["memory_kv"]):
                for n, a in zip("kv", kv):
                    _want(f"layer {i} memory {n}", a, memory_kv_shape)

    def _placed(logits: torch.Tensor):
        return DTensor.from_local(logits.contiguous(), mesh, logits_pl, run_check=False)

    @torch.inference_mode()
    def prefill_fn(params, tokens, state, frames=None, prefix=None):
        if cfg.encoder_layers and frames is None:
            raise ValueError(f"{cfg.name}: an encoder-decoder prefills with frames")
        _check(tokens, state, frames, prefix)
        local = _local_params(params)
        with axis_rules(run_rules, mesh):
            logits, new_state = prefill(model, local, plan.take_rows(tokens), state, frames=plan.take_rows(frames),
                                        prefix=plan.take_rows(prefix))
        return _placed(logits), new_state

    @torch.inference_mode()
    def decode_fn(params, tokens, state):
        if cfg.encoder_layers and "memory" not in state:
            raise ValueError(f"{cfg.name}: decode needs the encoder memory that prefill keeps")
        _check(tokens, state)
        local = _local_params(params)
        with axis_rules(run_rules, mesh):
            logits, new_state = decode_step(model, local, plan.take_rows(tokens), state)
        return _placed(logits), new_state

    return prefill_fn, decode_fn, state_shapes, shards


def _device_serve_fns(model, device, *, max_len: int, global_batch: int):
    dev = resolve_device(device)
    cfg = model.cfg

    def _want(name: str, a: torch.Tensor, shape: tuple) -> None:
        if tuple(a.shape) != shape or a.device.type != dev.type:
            raise ValueError(f"{name} {tuple(a.shape)} on {a.device}: want {shape} on {dev}")

    def _check(tokens: torch.Tensor, state: dict, frames=None, prefix=None) -> None:
        B = global_batch
        if tokens.device.type != dev.type or tokens.shape[0] != B:
            raise ValueError(f"tokens {tuple(tokens.shape)} on {tokens.device}: want batch {B} on {dev}")
        caches = state["caches"]
        if len(caches) != cfg.n_layers:
            raise ValueError(f"{len(caches)} caches for {cfg.n_layers} layers")
        S = attn.cache_slots(cfg, max_len)
        for i, c in enumerate(caches):
            spec = cfg.layout[i % len(cfg.layout)]
            if spec.mixer == "mamba":
                _want(f"layer {i} cache h", c["h"], (B, cfg.d_inner, cfg.ssm_state))
                _want(f"layer {i} cache conv", c["conv"], (B, cfg.ssm_conv - 1, cfg.d_inner))
            elif cfg.attention == "mla":
                _want(f"layer {i} cache c_kv", c["c_kv"], (B, max_len, cfg.kv_lora_rank))
                _want(f"layer {i} cache k_rope", c["k_rope"], (B, max_len, cfg.qk_rope_dim))
            else:
                for n in ("k", "v"):
                    _want(f"layer {i} cache {n}", c[n], (B, S, cfg.n_kv_heads, cfg.head_dim))
                if cfg.attention == "swa" and cfg.window and S == cfg.window:  # a ring
                    _want(f"layer {i} cache pos", c["pos"], (B, S))
        T, d = cfg.frontend_len, cfg.d_model
        if frames is not None:
            _want("frames", frames, (B, T, d))
        if prefix is not None:
            _want("prefix", prefix, (B, T, d))
        if "memory" in state:
            _want("memory", state["memory"], (B, T, d))
            if len(state["memory_kv"]) != cfg.n_layers:
                raise ValueError(f"{len(state['memory_kv'])} memory K/V pairs for {cfg.n_layers} layers")
            for i, kv in enumerate(state["memory_kv"]):
                for n, a in zip("kv", kv):
                    _want(f"layer {i} memory {n}", a, (B, T, cfg.n_kv_heads, cfg.head_dim))

    @torch.inference_mode()
    def prefill_fn(params, tokens, state, frames=None, prefix=None):
        _check(tokens, state, frames, prefix)
        return prefill(model, params, tokens, state, frames=frames, prefix=prefix)

    @torch.inference_mode()
    def decode_fn(params, tokens, state):
        if cfg.encoder_layers and "memory" not in state:
            raise ValueError(f"{cfg.name}: decode needs the encoder memory that prefill keeps")
        _check(tokens, state)
        return decode_step(model, params, tokens, state)

    return prefill_fn, decode_fn

"""AdamW with decoupled weight decay and global-norm clipping.

Port of ``repro.optim.adamw``, written by hand rather than taken from
``torch.optim.AdamW``, whose rules differ: the moments m and v are f32; the
global norm is taken over the f32 gradients and the clip folds into the
update; weight decay applies only to params with ``ndim >= 2``; the step
count and the bias corrections are f32; each new param is cast back to its
dtype. The state mirrors the param tree (dicts and lists of tensors).

A list in the tree stands for the axis the reference stacks: the port keeps
one dict per layer where the JAX model stacks each leaf over its G groups
(``repro_torch.models.convert``), so a leaf counts one dimension more for
each list above it. The per-layer RMSNorm weights, (G, D) in the reference,
are therefore decayed, as the reference decays them; ``final_norm`` is not.
``adamw_update`` writes params and moments in place (the JAX step donates
them instead) and must run under ``torch.no_grad()``.
"""

from __future__ import annotations

import torch


def tree_leaves(tree) -> list:
    """The tensors of a tree of dicts and lists, dict keys in sorted order."""
    if isinstance(tree, dict):
        return [leaf for k in sorted(tree) for leaf in tree_leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [leaf for t in tree for leaf in tree_leaves(t)]
    return [tree]


def _leaves_with_depth(tree, depth: int = 0) -> list:
    """(leaf, number of lists above it), in ``tree_leaves``' order."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaves_with_depth(tree[k], depth)]
    if isinstance(tree, (list, tuple)):
        return [x for t in tree for x in _leaves_with_depth(t, depth + 1)]
    return [(tree, depth)]


def tree_map(fn, tree):
    """``fn`` of every leaf, visited in ``tree_leaves``' order."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, tree[k]) for k in sorted(tree)}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, t) for t in tree)
    return fn(tree)


def global_norm(tree, specs=None, comm=None) -> torch.Tensor:
    """sqrt of the sum of squares of every leaf, in f32. Over a placed tree
    (``specs``: each leaf's spec, ``repro_torch.dist.sharding``; ``comm``:
    the mesh's ``MeshComm``), each leaf is this rank's shard: the squares are
    summed over the local shards of the leaves sharded over the same mesh
    axes, each such sum all-reduced over exactly those axes (never over an
    axis the leaf is replicated on), so every element counts once and the
    norm is equal on every rank."""
    if specs is None:
        return torch.sqrt(sum(torch.sum(torch.square(x.float())) for x in tree_leaves(tree)))
    from repro_torch.dist.sharding import spec_axes

    parts: dict = {}
    for x, spec in zip(tree_leaves(tree), _spec_leaves(specs)):
        axes = tuple(sorted({a for e in spec for a in spec_axes(e)}))
        parts.setdefault(axes, []).append(x)
    total = 0
    for axes, xs in parts.items():
        s = sum(torch.sum(torch.square(x.float())) for x in xs)
        total = total + (comm.all_reduce(s, axes) if axes else s)
    return torch.sqrt(total)


def _spec_leaves(specs) -> list:
    """The spec tuples of a spec tree, in ``tree_leaves``' order."""
    if isinstance(specs, dict):
        return [leaf for k in sorted(specs) for leaf in _spec_leaves(specs[k])]
    if isinstance(specs, list):
        return [leaf for t in specs for leaf in _spec_leaves(t)]
    return [specs]


PIECE = 1 << 26  # elements of a leaf updated at a time: bounds the f32 temporaries of the update


def _pieces(*ts: torch.Tensor):
    """(p, g, m, v) of one leaf, whole, or as flat pieces of PIECE elements
    where the leaf is larger and all four are contiguous. The update is
    elementwise, so its values do not depend on the pieces."""
    n = ts[0].numel()
    if n <= PIECE or not all(t.is_contiguous() for t in ts):
        yield ts
        return
    flat = [t.view(-1) for t in ts]
    for i in range(0, n, PIECE):
        yield tuple(f[i : i + PIECE] for f in flat)


def adamw_init(params) -> dict:
    return {
        "m": tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32, device=p.device), params),
        "v": tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32, device=p.device), params),
        "count": torch.zeros((), dtype=torch.int32, device=tree_leaves(params)[0].device),
    }


def adamw_update(
    params,
    grads,
    state: dict,
    lr: torch.Tensor,
    *,
    b1: float = 0.9,
    b2: float = 0.95,
    eps: float = 1e-8,
    weight_decay: float = 0.1,
    clip_norm: float = 1.0,
    grad_norm: torch.Tensor | None = None,
) -> dict:
    """Updates params, ``state["m"]``, ``state["v"]`` and ``state["count"]``
    in place; returns the metrics ``grad_norm`` and ``clip_scale`` (f32
    scalars on the params' device). ``grad_norm``, where given, is the
    gradients' global norm (of a placed tree, whose leaves are shards)."""
    gnorm = global_norm(grads) if grad_norm is None else grad_norm
    scale = torch.clamp(clip_norm / torch.clamp(gnorm, min=1e-9), max=1.0)
    count = state["count"] + 1
    c1 = 1.0 - b1 ** count.float()
    c2 = 1.0 - b2 ** count.float()
    for (leaf, stacked), grad, mom1, mom2 in zip(_leaves_with_depth(params), tree_leaves(grads),
                                                 tree_leaves(state["m"]), tree_leaves(state["v"])):
        decay = leaf.dim() + stacked >= 2
        for p, g, m, v in _pieces(leaf, grad, mom1, mom2):
            g = g.float() * scale
            m.copy_(b1 * m + (1 - b1) * g)
            v.copy_(b2 * v + (1 - b2) * g * g)
            step = (m / c1) / (torch.sqrt(v / c2) + eps)
            if decay:
                step = step + weight_decay * p.float()
            p.copy_((p.float() - lr * step).to(p.dtype))
    state["count"].copy_(count)
    return {"grad_norm": gnorm, "clip_scale": scale}

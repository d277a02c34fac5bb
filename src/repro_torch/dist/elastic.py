"""Elastic resharding: move a train state onto a different mesh.

Port of ``repro.dist.elastic``. The state is a tree of DTensors plus a
logical-axes tree; a new mesh means new rules and the placements derived
from them. Growing, shrinking after a restore, or trading data for model
parallelism are the same call. Both meshes span the ranks of one process
group; each leaf is gathered whole on the old mesh and each rank keeps its
shard of the new placement (the reference states only the target shardings
and lets XLA choose the collectives).
"""

from __future__ import annotations

from typing import Optional

from .sharding import make_rules, shardings_for
from .step import gather_full, place


def _state_shardings(state: dict, axes, rules: dict, mesh) -> dict:
    """Placements tree matching a {params, opt, step, ...} train state:
    params, opt.m, opt.v (and a compression residual) follow the logical
    param axes; every other leaf (step, opt.count) is replicated."""
    from torch.distributed.tensor import Replicate

    repl = tuple(Replicate() for _ in mesh.mesh_dim_names)
    by_params = lambda sub: shardings_for(axes, sub, rules, mesh)
    out: dict = {}
    for key, sub in state.items():
        if key == "params":
            out[key] = by_params(sub)
        elif key == "opt":
            out[key] = {k: by_params(v) if k in ("m", "v") else repl for k, v in sub.items()}
        elif key == "compress":
            out[key] = {"residual": by_params(sub["residual"])}
        else:
            out[key] = repl
    return out


def _move(tree, shard, mesh_to):
    if isinstance(tree, dict):
        return {k: _move(tree[k], shard[k], mesh_to) for k in tree}
    if isinstance(tree, list):
        return [_move(t, s, mesh_to) for t, s in zip(tree, shard)]
    return place(gather_full(tree), mesh_to, shard)


def reshard_state(
    state: dict,
    axes,
    mesh_from,
    mesh_to,
    cfg,
    mode: str,
    global_batch: Optional[int] = None,
):
    """Reshard {params, opt, step} (DTensors on ``mesh_from``) onto
    ``mesh_to``. ``axes``: the params' logical-axes tree
    (``Model.init(..., with_axes=True)``). ``mesh_from`` is taken for the
    reference's signature; each leaf carries its own mesh. Returns
    (new_state, shardings)."""
    rules = make_rules(cfg, mesh_to, mode, global_batch)
    shardings = _state_shardings(state, axes, rules, mesh_to)
    return _move(state, shardings, mesh_to), shardings

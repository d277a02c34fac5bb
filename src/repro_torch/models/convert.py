"""Carry weights of the JAX model over to the port.

``params_from_jax`` takes the JAX param pytree of ``repro.models.transformer
.Model.init`` with its leaves as numpy arrays (bfloat16 arrays included) and
returns the port's params: the leading G group axis of every ``blocks``
leaf is unstacked into one dict per layer, in the order the trunk visits
them (with the cross-attention's ``cross`` and ``ln_cross`` and MLA's
leaves, whatever a layer holds), and so is the encoder's layer axis
(``encoder.blocks`` -> ``encoder.layers``); every other layout (``wq (d, H, Dh)``, ``wo (H, Dh, d)``, the experts'
``(E, d, f)``, ...) is kept, and so is every leaf's dtype (a bf16 model's
Mamba ``a_log`` and ``dt_bias`` stay f32).
With it, both packages compute the same function from the same weights.
``axes_from_jax`` maps the reference's logical-axes tree the same way.
"""

from __future__ import annotations

import numpy as np
import torch

from .common import ArchConfig, resolve_device


def _tensor(a, device: torch.device) -> torch.Tensor:
    a = np.array(a, order="C")  # a writable copy: the port updates some tensors in place
    if a.dtype.name == "bfloat16":  # numpy has no bfloat16: move the bits
        return torch.from_numpy(a.view(np.int16)).view(torch.bfloat16).to(device)
    return torch.from_numpy(a).to(device)


def _map(tree, fn):
    if isinstance(tree, dict):
        return {k: _map(v, fn) for k, v in tree.items()}
    return fn(tree)


def _unstack(cfg: ArchConfig, tree: dict, leaf, layer) -> dict:
    """The port's layout of a reference tree: ``leaf(x)`` of the top-level
    leaves, ``layer(x, i)`` of each stacked leaf at group (or encoder layer) i."""
    extra = set(tree) - {"embed", "final_norm", "lm_head", "blocks"} - ({"encoder"} if cfg.encoder_layers else set())
    if extra:
        raise NotImplementedError(f"{cfg.name}: params {sorted(extra)} are not ported yet")
    out = {"embed": leaf(tree["embed"]), "final_norm": leaf(tree["final_norm"])}
    if not cfg.tie_embeddings:
        out["lm_head"] = leaf(tree["lm_head"])
    if len(tree["blocks"]) != len(cfg.layout):
        raise ValueError(f"{len(tree['blocks'])} block stacks for a layout of {len(cfg.layout)}")
    out["layers"] = [
        _map(tree["blocks"][pos], lambda a: layer(a, g))
        for g in range(cfg.n_groups)
        for pos in range(len(cfg.layout))
    ]
    if cfg.encoder_layers:
        enc = tree["encoder"]
        out["encoder"] = {
            "layers": [_map(enc["blocks"], lambda a: layer(a, i)) for i in range(cfg.encoder_layers)],
            "norm": leaf(enc["norm"]),
        }
    return out


def params_from_jax(cfg: ArchConfig, params: dict, device="cuda") -> dict:
    dev = resolve_device(device)
    return _unstack(cfg, params, lambda a: _tensor(a, dev), lambda a, g: _tensor(np.asarray(a)[g], dev))


def axes_from_jax(cfg: ArchConfig, axes: dict) -> dict:
    """The reference's logical-axes tree (``Model.init(key)[1]``) in the
    port's layout: each stacked leaf loses its leading "layers" axis."""

    def layer(ax, _):
        if not ax or ax[0] != "layers":
            raise ValueError(f"stacked axes {ax} do not start with 'layers'")
        return tuple(ax[1:])

    return _unstack(cfg, axes, tuple, layer)

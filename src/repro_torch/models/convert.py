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


def params_from_jax(cfg: ArchConfig, params: dict, device="cuda") -> dict:
    dev = resolve_device(device)
    extra = set(params) - {"embed", "final_norm", "lm_head", "blocks"} - ({"encoder"} if cfg.encoder_layers else set())
    if extra:
        raise NotImplementedError(f"{cfg.name}: params {sorted(extra)} are not ported yet")
    out = {
        "embed": _tensor(params["embed"], dev),
        "final_norm": _tensor(params["final_norm"], dev),
    }
    if not cfg.tie_embeddings:
        out["lm_head"] = _tensor(params["lm_head"], dev)
    if len(params["blocks"]) != len(cfg.layout):
        raise ValueError(f"{len(params['blocks'])} block stacks for a layout of {len(cfg.layout)}")
    out["layers"] = [
        _map(params["blocks"][pos], lambda a: _tensor(np.asarray(a)[g], dev))
        for g in range(cfg.n_groups)
        for pos in range(len(cfg.layout))
    ]
    if cfg.encoder_layers:
        enc = params["encoder"]
        out["encoder"] = {
            "layers": [_map(enc["blocks"], lambda a: _tensor(np.asarray(a)[i], dev))
                       for i in range(cfg.encoder_layers)],
            "norm": _tensor(enc["norm"], dev),
        }
    return out

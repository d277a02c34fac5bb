"""A model's layer blocks, one file each (``blocks/<block>.py``), found by
the name that a configuration file gives them.

A configuration file's layers are its optional ``first_layers`` followed by
its ``layout`` repeated to ``num_hidden_layers``; each layer names a block
for each of its slots. A slot is a sub-tree of the port's layer with its
pre-norm (``SLOTS``): the block reads the normed residual stream and adds
its output to it.

A block file holds, for its block:

- ``SLOT``, the slot it fills, and ``runs(spec, cfg)``: whether the port runs
  this block in a layer of ``LayerSpec`` ``spec`` under ``ArchConfig`` ``cfg``;
- ``KEYS``: the configuration-file keys it owns, each with the port's
  ``ArchConfig`` field it must equal, or a function of the ``ArchConfig``
  that gives the port's value; optionally ``OPTIONS`` (keys that set an
  option of the port's) and ``refuse(config, cfg)`` (further differences
  from the port, as lines);
- ``plan(config)``: its weight leaves, in the forms ``weights.plan`` gives;
- ``forward(p, config, h, prec, prompt_len)``: its plain f32 forward through
  a ``reference.model.Precision``, over h (B, S, d): the prompt's
  ``prompt_len`` positions, then one decode step a position. Returns (y,
  token-slots dropped);
- its costs: ``products(config, active)``, the parameters that multiply a
  token (the top-k experts where ``active``); optionally ``attention_shape(config)``,
  (H, KVH, Dk, Dv) of its causal attention at prefill, ``decode_extra(config,
  B, context, elt)``, the (operations, bytes) of a decode step beyond its
  weights (attention's products, the bytes it reads of its cache or state),
  and ``routed(config)``, the expert slots a token takes.

Nothing here imports the port: ``runs`` and ``KEYS`` read the ``ArchConfig``
they are handed.
"""

from __future__ import annotations

import importlib
from pathlib import Path

DIR = Path(__file__).resolve().parent
SLOTS = {"mixer": "ln1", "ffn": "ln2"}  # slot -> the port's norm before it, in layer order


def load(name: str):
    """The block file ``name``; exits where there is none."""
    if not (DIR / f"{name}.py").is_file():
        raise SystemExit(f"no block file portbench/blocks/{name}.py")
    return importlib.import_module(f"{__name__}.{name}")


def layer_list(config: dict) -> list:
    """{slot: block name} of each of the file's layers."""
    first, layout = config.get("first_layers", []), config["layout"]
    return list(first) + [layout[i % len(layout)] for i in range(config["num_hidden_layers"] - len(first))]


def layers(config: dict) -> list:
    """(slot, norm, block module) of each slot of each of the file's layers,
    in the order the port applies them."""
    return [[(slot, norm, load(layer[slot])) for slot, norm in SLOTS.items() if slot in layer]
            for layer in layer_list(config)]


def named(config: dict) -> dict:
    """{name: block module} of every block the file's layers name."""
    return {n: load(n) for layer in layer_list(config) for n in layer.values()}


def mismatch(layer: dict, spec, cfg) -> list:
    """Where the file's layer ({slot: block name}) is not the port's layer
    ``spec``: the port must fill exactly the slots the file names, and each
    named block must say that it runs there (``runs(spec, cfg)``)."""
    port = {slot: getattr(spec, slot) for slot in SLOTS if getattr(spec, slot) != "none"}
    if port.keys() != layer.keys():
        return [f"the port fills {port}, the file names {layer}"]
    return [f"{slot}: block {name!r} does not run the port's {port[slot]!r} under attention {cfg.attention!r}"
            for slot, name in layer.items() if load(name).SLOT != slot or not load(name).runs(spec, cfg)]


def period(flags: list) -> tuple:
    """(period, offset) of the flagged layers: the least p that divides
    their number with flags[i] == flags[i % p] throughout, and the first
    flagged layer (None if none)."""
    n = len(flags)
    p = next(p for p in range(1, n + 1) if n % p == 0 and all(flags[i] == flags[i % p] for i in range(n)))
    return p, next((i for i, f in enumerate(flags) if f), None)


def port_period(runs, cfg) -> tuple:
    """(period, offset) of the port's layers for which ``runs(spec, cfg)``."""
    return period([runs(s, cfg) for s in cfg.layer_specs()])

"""The weights of a cell, drawn from its seed in the port's parameter layout.

The benchmark makes the weights and hands the same tree to the port and,
drawn again from the same seed after the window, to the plain reference.
Every random matrix comes out of one ``torch.randn`` call on the device, in
the configuration's dtype, from one ``torch.Generator`` seeded with the
run's seed; each matrix is a view of that buffer scaled in place by its
fan-in (attention's q, k and v biases by ``blocks.attention.BIAS_SCALE``).
Norm weights are ones, the conv bias zeros; Mamba's ``dt_bias`` and
``a_log`` are f32, the first drawn from the same generator (softplus of it
spans [1e-3, 1e-1]), the second the S4D-real ``log(1..N)``.

The layout (key names, shapes, scales) is the port's (``repro_torch.models``:
each block file's ``plan`` follows the port's ``init_*``); ``run.py`` checks
it against the port's own shapes on the meta device before a run, so a
change of the layout fails loudly.
"""

from __future__ import annotations

import math

import torch

from portbench import blocks

DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def plan(cfg: dict) -> dict:
    """The parameter tree as leaves ("randn", shape, scale), ("ones", shape),
    ("zeros", shape), ("dt_bias", shape) or ("a_log", shape): the embedding,
    the final norm and the output head here, each layer's slots from its
    block files (``portbench/blocks/``), each after its norm."""
    d, V = cfg["hidden_size"], cfg["vocab_size"]
    tree: dict = {
        "embed": ("randn", (V, d), 1.0),
        "final_norm": ("ones", (d,)),
    }
    if not cfg.get("tie_word_embeddings", False):
        tree["lm_head"] = ("randn", (d, V), d ** -0.5)
    layers = []
    for layer in blocks.layers(cfg):
        p: dict = {}
        for slot, norm, block in layer:
            p[norm] = ("ones", (d,))
            p[slot] = block.plan(cfg)
        layers.append(p)
    tree["layers"] = layers
    return tree


def _walk(tree, fn):
    """``fn`` of every leaf, dict keys in sorted order (the port's tree order)."""
    if isinstance(tree, dict):
        return {k: _walk(tree[k], fn) for k in sorted(tree)}
    if isinstance(tree, list):
        return [_walk(t, fn) for t in tree]
    return fn(tree)


def leaves(tree) -> list:
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in leaves(tree[k])]
    if isinstance(tree, list):
        return [x for t in tree for x in leaves(t)]
    return [tree]


def shapes(tree) -> list:
    """(shape, dtype) of each tensor leaf, in tree order."""
    return [(tuple(t.shape), t.dtype) for t in leaves(tree)]


def make_params(cfg: dict, seed: int, device) -> dict:
    """The cell's weights (see the module docstring), on ``device``."""
    dtype = DTYPES[cfg["torch_dtype"]]
    spec = plan(cfg)
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    total = sum(math.prod(leaf[1]) for leaf in leaves(spec) if leaf[0] == "randn")
    flat = torch.randn((total,), generator=gen, dtype=dtype, device=device)
    offset = 0

    def build(leaf):
        nonlocal offset
        kind, shape = leaf[0], leaf[1]
        if kind == "randn":
            n = math.prod(shape)
            t = flat[offset : offset + n].view(shape)
            offset += n
            return t.mul_(leaf[2])
        if kind == "ones":
            return torch.ones(shape, dtype=dtype, device=device)
        if kind == "zeros":
            return torch.zeros(shape, dtype=dtype, device=device)
        if kind == "dt_bias":
            u = torch.rand(shape, generator=gen, dtype=torch.float32, device=device)
            dt = torch.exp(math.log(1e-3) + u * (math.log(1e-1) - math.log(1e-3)))
            return dt + torch.log(-torch.expm1(-dt))  # inverse softplus
        if kind == "a_log":
            n = shape[1]
            return torch.log(torch.arange(1, n + 1, dtype=torch.float32, device=device)).expand(shape).contiguous()
        raise ValueError(f"unknown leaf kind {kind!r}")

    return _walk(spec, build)

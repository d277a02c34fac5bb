"""The weights of a cell, drawn from its seed in the port's parameter layout.

The benchmark makes the weights and hands the same tree to the port and,
drawn again from the same seed after the window, to the plain reference.
Every random matrix comes out of one ``torch.randn`` call on the device, in
the configuration's dtype, from one ``torch.Generator`` seeded with the
run's seed; each matrix is a view of that buffer scaled in place by its
fan-in (attention's q, k and v biases by ``BIAS_SCALE``). Norm weights are
ones, the conv bias zeros; Mamba's ``dt_bias`` and
``a_log`` are f32, the first drawn from the same generator (softplus of it
spans [1e-3, 1e-1]), the second the S4D-real ``log(1..N)``.

The layout (key names, shapes, scales) is the port's
(``repro_torch.models``: ``init_attention``, ``init_mamba``, ``init_moe``,
``init_dense_ffn``); ``run.py`` checks it against the port's own shapes on
the meta device before a run, so a change of the layout fails loudly.
"""

from __future__ import annotations

import math

import torch

DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}
BIAS_SCALE = 0.1  # q, k and v biases: drawn, not zero, so that the comparison sees them


def layer_specs(cfg: dict) -> list:
    """(mixer, ffn) of each of the config's layers: its layout repeated."""
    layout = cfg["layout"]
    return [(layout[i % len(layout)]["mixer"], layout[i % len(layout)]["ffn"]) for i in range(cfg["num_hidden_layers"])]


def head_dim(cfg: dict) -> int:
    return cfg["hidden_size"] // cfg["num_attention_heads"]


def d_inner(cfg: dict) -> int:
    return cfg["mamba_expand"] * cfg["hidden_size"]


def plan(cfg: dict) -> dict:
    """The parameter tree as leaves ("randn", shape, scale), ("ones", shape),
    ("zeros", shape), ("dt_bias", shape) or ("a_log", shape)."""
    d, f, V = cfg["hidden_size"], cfg["intermediate_size"], cfg["vocab_size"]
    H, KVH, Dh = cfg["num_attention_heads"], cfg["num_key_value_heads"], head_dim(cfg)
    tree: dict = {
        "embed": ("randn", (V, d), 1.0),
        "final_norm": ("ones", (d,)),
    }
    if not cfg.get("tie_word_embeddings", False):
        tree["lm_head"] = ("randn", (d, V), d ** -0.5)
    layers = []
    for mixer, ffn in layer_specs(cfg):
        p: dict = {"ln1": ("ones", (d,))}
        if mixer == "attention":
            p["mixer"] = {
                "wq": ("randn", (d, H, Dh), d ** -0.5),
                "wk": ("randn", (d, KVH, Dh), d ** -0.5),
                "wv": ("randn", (d, KVH, Dh), d ** -0.5),
                "wo": ("randn", (H, Dh, d), (H * Dh) ** -0.5),
            }
            if cfg.get("use_qkv_bias"):
                p["mixer"] |= {"bq": ("randn", (H, Dh), BIAS_SCALE), "bk": ("randn", (KVH, Dh), BIAS_SCALE),
                               "bv": ("randn", (KVH, Dh), BIAS_SCALE)}
        else:
            di, n, k, r = d_inner(cfg), cfg["mamba_d_state"], cfg["mamba_d_conv"], cfg["mamba_dt_rank"]
            p["mixer"] = {
                "in_proj": ("randn", (d, 2 * di), d ** -0.5),
                "conv_w": ("randn", (k, di), k ** -0.5),
                "conv_b": ("zeros", (di,)),
                "x_proj": ("randn", (di, r + 2 * n), di ** -0.5),
                "dt_proj": ("randn", (r, di), r ** -0.5),
                "dt_bias": ("dt_bias", (di,)),
                "a_log": ("a_log", (di, n)),
                "d_skip": ("ones", (di,)),
                "out_proj": ("randn", (di, d), di ** -0.5),
            }
        p["ln2"] = ("ones", (d,))
        if ffn == "moe":
            e = cfg["num_experts"]
            p["ffn"] = {
                "router": ("randn", (d, e), d ** -0.5),
                "w_gate": ("randn", (e, d, f), d ** -0.5),
                "w_up": ("randn", (e, d, f), d ** -0.5),
                "w_down": ("randn", (e, f, d), f ** -0.5),
            }
        else:
            p["ffn"] = {
                "w_gate": ("randn", (d, f), d ** -0.5),
                "w_up": ("randn", (d, f), d ** -0.5),
                "w_down": ("randn", (f, d), f ** -0.5),
            }
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

"""The layer blocks as files of their own (``portbench/blocks/``): the MLA
block's plain forward against the port's ``mla_block`` (no cache, prefill
into the latent cache, absorbed decode steps through it); the costs and the
weight plans of the configurations that were there before the blocks moved
into files, pinned to what the harness gave then; ``first_layers``; and the
refusals of a file that is not the port's."""

import copy
import hashlib
import json

import pytest
import torch

from portbench import blocks, costs, harness, weights
from portbench.blocks import mla
from portbench.reference import model as ref_model
from portbench.tests.smoke import SMOKE_SIZES


def _config(name: str) -> dict:
    return json.loads((harness.PKG / "configs" / f"{name}.json").read_text())


def _smoke_mla() -> dict:
    config = _config("minicpm3-4b")
    config.update(smoke=True, torch_dtype="float32", **SMOKE_SIZES["minicpm3-4b"])
    return config


def test_mla_follows_the_ports_block_without_and_through_its_latent_cache():
    from repro_torch.models.attention import init_mla_cache, mla_block

    config = _smoke_mla()
    cfg = harness.arch_config(config)
    p = weights.make_params(config, 3, torch.device("cpu"))["layers"][0]["mixer"]
    B, L, steps, d = 2, 12, 3, config["hidden_size"]
    x = torch.randn((B, L + steps, d), generator=torch.Generator().manual_seed(4))
    prec = ref_model.Precision("f32")
    want = mla.mla(p, config, x, prec, head_block=3, row_block=5)  # blocks that do not divide H or S
    pos = torch.arange(L + steps).expand(B, L + steps)

    y, cache = mla_block(p, cfg, x[:, :L], pos[:, :L])
    assert cache is None
    torch.testing.assert_close(y, want[:, :L], rtol=1e-5, atol=1e-5)

    cache = init_mla_cache(cfg, B, L + steps + 4, torch.float32, torch.device("cpu"))
    y, cache = mla_block(p, cfg, x[:, :L], pos[:, :L], cache)
    torch.testing.assert_close(y, want[:, :L], rtol=1e-5, atol=1e-5)
    for t in range(L, L + steps):  # the absorbed form over the latent cache
        y, cache = mla_block(p, cfg, x[:, t : t + 1], pos[:, t : t + 1], cache)
        torch.testing.assert_close(y, want[:, t : t + 1], rtol=1e-5, atol=1e-5)
    assert cache["index"] == L + steps


# What the harness computed for these files before the blocks moved into files of their own.
PINNED = {
    "stablelm-1.6b": {
        "matmul_params": (1438646272, 1438646272, 1233125376),
        "prefill_flops": (94014753734656.0, 82492899983360.0),
        "decode_step": ((29467082752.0, 9326067712), (192199786496.0, 10930618368), (8636006400.0, 5762867200)),
        "leaves": (291, "55455c873ec3896806eade18485990309dd52b0bb1775c32ed4592daff706145"),
    },
    "jamba-v0.1-52b-p8": {
        "matmul_params": (3160637440, 13025640448, 2892201984),
        "prefill_flops": (190647424253952.0, 189715416350720.0),
        "decode_step": ((51107594240.0, 26249920512), (405232680960.0, 26733379584), (18964168704.0, 52128931840)),
        "leaves": (114, "646ab98e5808a33850d09e4e467f014e1061df728f651d31586c2a2a81fa95ea"),
    },
}


@pytest.mark.parametrize("name", sorted(PINNED))
def test_costs_equal_what_they_were(name):
    c, pin = _config(name), PINNED[name]
    assert (costs.matmul_params(c), costs.matmul_params(c, active=False),
            costs.matmul_params(c, head=False)) == pin["matmul_params"]
    assert (costs.prefill_flops(c, 8, 4096), costs.prefill_flops(c, 64, 512)) == pin["prefill_flops"]
    assert (costs.decode_step(c, 8, 4100), costs.decode_step(c, 64, 640),
            costs.decode_step(c, 3, 7, elt=4)) == pin["decode_step"]


@pytest.mark.parametrize("name", sorted(PINNED))
def test_weight_plans_equal_what_they_were(name):
    """The leaves in draw order, their kinds, shapes and scales: the weights
    drawn from a seed are bit-equal to those drawn before."""
    leaves = weights.leaves(weights.plan(_config(name)))
    assert (len(leaves), hashlib.sha256(repr(leaves).encode()).hexdigest()) == PINNED[name]["leaves"]


def test_first_layers_come_before_the_repeated_layout():
    base = _config("jamba-v0.1-52b-p8")
    base.update(num_hidden_layers=3, layout=[{"mixer": "mamba", "ffn": "moe"}])
    pre = copy.deepcopy(base)
    pre["first_layers"] = [{"mixer": "attention", "ffn": "dense"}]
    assert blocks.layer_list(pre) == [{"mixer": "attention", "ffn": "dense"}] + 2 * [{"mixer": "mamba", "ffn": "moe"}]
    tree = weights.plan(pre)["layers"]
    assert [sorted(layer["mixer"]) for layer in tree] == [["wk", "wo", "wq", "wv"]] + 2 * [sorted(tree[1]["mixer"])]
    assert "router" not in tree[0]["ffn"] and all("router" in layer["ffn"] for layer in tree[1:])
    # one Mamba and MoE layer fewer, one attention and dense layer more
    d, f = base["hidden_size"], base["intermediate_size"]
    att = 2 * d * d + 2 * d * (d // 4)  # q and o d x d, k and v d x d / 4 (8 of 32 heads)
    mamba, moe = blocks.load("mamba").products(base, True), blocks.load("moe").products(base, True)
    assert costs.matmul_params(pre) - costs.matmul_params(base) == att + 3 * d * f - mamba - moe
    assert costs.attention_shapes(pre) == [(32, 8, 128, 128)] and costs.attention_shapes(base) == []
    assert costs.routed_slots(pre) == 2 * 2 and costs.routed_slots(base) == 3 * 2


def _refusal(config: dict) -> str:
    with pytest.raises(SystemExit) as e:
        harness.arch_config(config)
    return str(e.value)


def test_refuses_a_block_with_no_file():
    config = _config("minicpm3-4b")
    config["layout"] = [{"mixer": "mla_yarn", "ffn": "dense"}]
    assert "no block file portbench/blocks/mla_yarn.py" in _refusal(config)


def test_refuses_a_port_layer_the_file_does_not_state():
    config = _config("minicpm3-4b")
    config["layout"] = [{"mixer": "attention", "ffn": "dense"}]  # the port runs MLA there
    msg = _refusal(config)
    assert "first difference at layer 0" in msg and "'mla'" in msg
    config = _config("stablelm-1.6b")
    config["first_layers"] = [{"mixer": "attention", "ffn": "moe"}]  # the port has no leading MoE layer
    assert "first difference at layer 0" in _refusal(config)


def test_refuses_a_key_no_named_block_owns():
    config = _config("stablelm-1.6b")
    config["mamba_d_state"] = 16  # Mamba's key, and stablelm names no Mamba layer
    assert "mamba_d_state: no block that the file names owns it" in _refusal(config)
    config = _config("minicpm3-4b")
    config["q_lora_rank"] = 512
    assert "q_lora_rank: file 512, port 768 (mla)" in _refusal(config)

"""The frozen counts against hand counts, one shape each."""

from portbench import costs


def test_attention_forward():
    # B 1, H 2, KVH 1, L 4, Dh 8: 10 causal pairs
    f, b = costs.attention_fwd(1, 2, 1, 4, 8, 8)
    assert f == 2 * 1 * 2 * 10 * 16
    assert b == 2 * 4 * (2 * 8 + 1 * 16 + 2 * 8)


def test_moe_gmm_and_mamba_scan():
    f, b = costs.moe_gmm(10, 3, 4, 5)
    assert f == 6 * 10 * 4 * 5 and b == 2 * (3 * 3 * 4 * 5 + 2 * 10 * 4)
    f, b = costs.mamba_scan(2, 3, 4, 5, h0=True)
    assert f == 6 * 2 * 3 * 4 * 5
    assert b == 2 * 3 * 4 * 10 + 2 * 3 * 2 * 5 * 4 + 4 * 5 * 4 + 2 * 2 * 4 * 5 * 4


def test_whole_steps():
    cfg = {"num_hidden_layers": 2, "hidden_size": 8, "num_attention_heads": 2, "num_key_value_heads": 2,
           "intermediate_size": 16, "vocab_size": 32, "layout": [{"mixer": "attention", "ffn": "dense"}]}
    per_layer = 4 * 8 * 8 + 3 * 8 * 16
    assert costs.matmul_params(cfg) == 2 * per_layer + 8 * 32
    assert costs.prefill_flops(cfg, 1, 4) == 2 * 2 * per_layer * 4 + 4 * 2 * 10 * 2 * 4 + 2 * 8 * 32
    f, b = costs.decode_step(cfg, 1, 5)
    assert f == 2 * (2 * per_layer + 256) + 4 * 2 * 5 * 2 * 4
    assert b == 2 * (2 * per_layer + 256) + 2 * 8 + 2 * 2 * 5 * 2 * 4 * 2
    assert costs.bound_s(989e12, 0) == 1.0 and costs.bound_s(0, 3.35e12) == 1.0

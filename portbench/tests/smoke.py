"""Cells cut to CPU size for the tests: every file of a real cell, with the
configuration swapped for the architecture's tiny preset
(``ArchConfig.reduced``, f32) and the traffic shrunk."""

import copy

from portbench import harness

SMOKE_SIZES = {
    "stablelm-1.6b": dict(num_hidden_layers=2, hidden_size=64, num_attention_heads=4, num_key_value_heads=4,
                          intermediate_size=128, vocab_size=256),
    "jamba-v0.1-52b": dict(hidden_size=64, num_attention_heads=4, num_key_value_heads=2, intermediate_size=128,
                           vocab_size=256, num_experts=4, mamba_d_state=8, mamba_dt_rank=4, moe_exact_tokens=16),
    "minicpm3-4b": dict(num_hidden_layers=2, hidden_size=64, num_attention_heads=4, num_key_value_heads=4,
                        q_lora_rank=32, kv_lora_rank=16, qk_nope_head_dim=8, qk_rope_head_dim=8, v_head_dim=16,
                        intermediate_size=128, vocab_size=256),
}
SMOKE_TRAFFIC = dict(batch=2, prompt=24, gen=4, trace_rounds=1, trace_decode_steps=2, check_rounds=1)


def smoke_cell(name: str):
    cell = copy.deepcopy(harness.load_cell(name))
    cell.config.update(smoke=True, torch_dtype="float32", **SMOKE_SIZES[cell.config["arch"]])
    cell.traffic.update(SMOKE_TRAFFIC)
    return cell


def control_cell(name: str):
    """A cell cut to a size at which the control study's numbers part on the
    CPU: serving at hidden 256 and 32 served tokens, so one altered token
    moves the mean gap past the cell's limit."""
    cell = smoke_cell(name)
    wider = dict(hidden_size=256, num_attention_heads=16, vocab_size=8192, intermediate_size=512, mamba_dt_rank=16)
    if cell.config["num_key_value_heads"] == cell.config["num_attention_heads"]:
        wider["num_key_value_heads"] = 16
    cell.config.update({k: v for k, v in wider.items() if k in cell.config})
    cell.traffic.update(batch=2, prompt=32, gen=16)
    return cell

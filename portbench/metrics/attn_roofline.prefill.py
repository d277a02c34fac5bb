"""attn_roofline.prefill: ``flash_attention`` in the traced prefills: its
launches times one causal call's least time at the peaks (``costs``, B x
prompt, the config's heads), over the profiler's device time of its CUDA
kernels, in percent. Moves ttft_p95_ms."""

from portbench import costs, harness

KERNELS = ("mma::attn_kernel", "flash_attention_kernel")


def read(ctx):
    prof = ctx["profile"].get("prefill")
    if not prof:
        return None
    seconds, _ = harness.kernel_time_s(prof, KERNELS)
    c, t = ctx["config"], ctx["traffic"]
    H, KVH = c["num_attention_heads"], c["num_key_value_heads"]
    dh = c["hidden_size"] // H
    one = costs.bound_s(*costs.attention_fwd(t["batch"], H, KVH, t["prompt"], dh, dh))
    bound = prof["launches"].get("flash_attention", 0) * one
    return 100.0 * bound / seconds if seconds > 0 and bound > 0 else None

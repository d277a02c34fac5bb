"""attn_roofline.prefill: ``flash_attention`` in the traced prefills: its
launches times the least time at the peaks of one causal call (``costs``,
B x prompt, each attention layer's heads and (Dk, Dv) from its block file,
averaged over those layers), over the profiler's device time of its CUDA
kernels, in percent. Moves ttft_p95_ms."""

from portbench import costs, harness

KERNELS = ("mma::attn_kernel", "flash_attention_kernel")


def read(ctx):
    prof = ctx["profile"].get("prefill")
    shapes = costs.attention_shapes(ctx["config"])
    if not prof or not shapes:
        return None
    seconds, _ = harness.kernel_time_s(prof, KERNELS)
    t = ctx["traffic"]
    ones = [costs.bound_s(*costs.attention_fwd(t["batch"], H, KVH, t["prompt"], dk, dv)) for H, KVH, dk, dv in shapes]
    bound = prof["launches"].get("flash_attention", 0) * sum(ones) / len(ones)
    return 100.0 * bound / seconds if seconds > 0 and bound > 0 else None

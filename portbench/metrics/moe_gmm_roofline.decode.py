"""moe_gmm_roofline.decode: ``moe_gmm`` in the traced decode steps: its
launches times the least time at the peaks of the work B tokens' top-k
slots need (``costs.moe_gmm``; decode is drop-free; every expert's weights
read once, each touched at this batch), over the profiler's device time of
its forward CUDA kernels, in percent. Moves itl_p95_ms."""

from portbench import costs, harness

KERNELS = ("wg::gemm_kernel", "swab::swap_ab_kernel", "::gmm_kernel")


def read(ctx):
    prof = ctx["profile"].get("decode")
    if not prof:
        return None
    seconds, _ = harness.kernel_time_s(prof, KERNELS)
    c, t = ctx["config"], ctx["traffic"]
    kept = t["batch"] * c["num_experts_per_tok"]
    one = costs.bound_s(*costs.moe_gmm(kept, c["num_experts"], c["hidden_size"], c["intermediate_size"]))
    bound = prof["launches"].get("moe_gmm", 0) * one
    return 100.0 * bound / seconds if seconds > 0 and bound > 0 else None

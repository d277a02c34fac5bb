"""moe_gmm_roofline.prefill: ``moe_gmm`` in the traced prefills: its
launches times the least time at the peaks of the work the routed tokens
need (``costs.moe_gmm``: the kept token-slots, B x prompt x top-k less the
share that the reference's routing of the run's checked rounds drops at the
capacity bins; every expert's weights read once, each touched at these
batches), over the profiler's device time of its forward CUDA kernels, in
percent. Moves ttft_p95_ms."""

from portbench import costs, harness

KERNELS = ("wg::gemm_kernel", "swab::swap_ab_kernel", "::gmm_kernel")


def read(ctx):
    prof = ctx["profile"].get("prefill")
    if not prof:
        return None
    seconds, _ = harness.kernel_time_s(prof, KERNELS)
    c, t = ctx["config"], ctx["traffic"]
    kept = t["batch"] * t["prompt"] * c["num_experts_per_tok"] * (1.0 - ctx.get("ref_prefill_drop_share", 0.0))
    one = costs.bound_s(*costs.moe_gmm(kept, c["num_experts"], c["hidden_size"], c["intermediate_size"]))
    bound = prof["launches"].get("moe_gmm", 0) * one
    return 100.0 * bound / seconds if seconds > 0 and bound > 0 else None

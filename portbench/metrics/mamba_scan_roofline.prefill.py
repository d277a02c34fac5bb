"""mamba_scan_roofline.prefill: ``mamba_scan`` in the traced prefills: its
launches times one scan's least time (``costs.mamba_scan`` at B x prompt,
the inner width and state, with the carried-in state that prefill into a
cache passes; against the f32 rate outside the tensor cores and the HBM
rate), over the profiler's device time of its CUDA kernel, in percent.
Moves ttft_p95_ms."""

from portbench import costs, harness

KERNELS = ("mamba_scan_kernel",)


def read(ctx):
    prof = ctx["profile"].get("prefill")
    if not prof:
        return None
    seconds, _ = harness.kernel_time_s(prof, KERNELS)
    c, t = ctx["config"], ctx["traffic"]
    di = c["mamba_expand"] * c["hidden_size"]
    flops, nbytes = costs.mamba_scan(t["batch"], t["prompt"], di, c["mamba_d_state"], h0=True)
    bound = prof["launches"].get("mamba_scan", 0) * costs.bound_s(flops, nbytes, costs.PEAK_F32_FLOPS)
    return 100.0 * bound / seconds if seconds > 0 and bound > 0 else None

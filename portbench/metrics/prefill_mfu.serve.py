"""prefill_mfu.serve: the model step at prefill, as a share of the card's
bf16 peak, in percent: (2 N_active B L over the layers, attention's causal
products, the head at the last position; ``costs.prefill_flops``, no
capacity padding counted) a round, times the rounds finished in the window,
over the sum of their times from the round's start to its first token (CUDA
events), over 989e12 FLOP/s. Moves ttft_p95_ms."""

from portbench import costs


def read(ctx):
    spans = ctx.get("prefill_s")
    if not spans:
        return None
    t = ctx["traffic"]
    flops = costs.prefill_flops(ctx["config"], t["batch"], t["prompt"])
    return 100.0 * len(spans) * flops / sum(spans) / costs.PEAK_BF16_FLOPS

"""decode_mfu.serve: the whole decode step's share of its roofline bound, in
percent: for each decode step finished in the window, the larger of its
operations over 989e12 FLOP/s and the bytes of weights and caches it reads
over 3.35e12 B/s (``costs.decode_step`` at its context), summed, over the
sum of the steps' times (CUDA events after each step's argmax). Named with
mfu so that it bounds any claim on the decode path. Moves itl_p95_ms."""

from portbench import costs


def read(ctx):
    steps = ctx.get("decode")
    if not steps:
        return None
    B = ctx["traffic"]["batch"]
    bound = sum(costs.bound_s(*costs.decode_step(ctx["config"], B, context)) for context, _ in steps)
    return 100.0 * bound / sum(dt for _, dt in steps)

"""decode_tokens_per_s: the decode cell's served tokens a second, taken as
``serve_tokens_per_s`` is in the prefill cells: the tokens of every round
finished in the window and the share of the round under way at its close
(CUDA events), over the window's seconds. A per-layer metric: the host paces
every decode step, so a stall of the host lengthens the window's rounds by
its whole length, and runs spread too widely for an end-to-end bound, where
``itl_p95_ms``, a tail that the few stalls of a window hardly reach, holds.
Moves itl_p95_ms."""


def read(ctx):
    return ctx.get("tokens_per_s") or None

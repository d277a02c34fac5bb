"""idle_share.prefill: the share of the traced prefills' windows (each from
a synchronise to the synchronise after the first token's argmax) in which
no operation ran on the card, in percent. Moves ttft_p95_ms."""


def read(ctx):
    prof = ctx["profile"].get("prefill")
    if not prof or prof["trace_window_s"] <= 0:
        return None
    return 100.0 * (1.0 - prof["busy_s"] / prof["trace_window_s"])

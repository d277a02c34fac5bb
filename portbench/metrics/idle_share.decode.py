"""idle_share.decode: the share of the traced decode steps' window in which
no operation ran on the card, in percent. Moves itl_p95_ms."""


def read(ctx):
    prof = ctx["profile"].get("decode")
    if not prof or prof["trace_window_s"] <= 0:
        return None
    return 100.0 * (1.0 - prof["busy_s"] / prof["trace_window_s"])

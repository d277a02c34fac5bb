"""The port's own counters (``repro_torch.obs.count``), as the per-layer
metric ``graph_share.decode`` reads them: how the traced decode steps were
served, by path. The registry fills only while ``torch.profiler`` records,
so it holds the traced sessions alone. A program without the counters (no
``count_totals`` in ``repro_torch.obs``, or no decode step counted) gives
None, never an error."""

REPLAY = "repro_torch.graph.replay"
EAGER = "repro_torch.graph.eager"


def decode_counts():
    """{counter name: count} of the traced decode steps, or None."""
    try:
        from repro_torch.obs import count_totals
    except ImportError:
        return None
    counts = count_totals().get("decode", {})
    return counts if counts.get(REPLAY, 0) + counts.get(EAGER, 0) else None


def graph_share() -> float | None:
    """The share of the traced decode steps served by replaying the decode
    step's CUDA graph, in percent, or None."""
    counts = decode_counts()
    if counts is None:
        return None
    replay = counts.get(REPLAY, 0)
    return 100.0 * replay / (replay + counts.get(EAGER, 0))

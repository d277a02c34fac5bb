"""The port's own host spans (``repro_torch.obs``), as the per-layer
metrics ``*_host_ms.decode`` read them: host milliseconds a traced decode
step, a step being one ``repro_torch.serve.decode`` span. The registry fills
only while ``torch.profiler`` records, so it holds the traced sessions
alone. A program without the spans (no ``repro_torch.obs``, or no decode
step recorded) gives None, never an error."""

STEP = "repro_torch.serve.decode"
BLOCKS = ("repro_torch.moe", "repro_torch.mamba", "repro_torch.attention", "repro_torch.mla")


def decode_spans():
    """{span name: (count, host seconds)} of the traced decode steps, or None."""
    try:
        from repro_torch.obs import span_totals
    except ImportError:
        return None
    spans = span_totals().get("decode", {})
    return spans if spans.get(STEP, (0, 0.0))[0] else None


def ms_per_step(names) -> float | None:
    """Host ms a step inside the spans ``names`` (a span name, or a prefix
    ending in "."), or None where none of them was recorded."""
    spans = decode_spans()
    if spans is None:
        return None
    found = [s for n, (_, s) in spans.items() if any(n == m or (m.endswith(".") and n.startswith(m)) for m in names)]
    return 1e3 * sum(found) / spans[STEP][0] if found else None


def rest_ms_per_step() -> float | None:
    """Host ms a step inside ``serve.decode`` and outside its MoE, Mamba,
    attention and MLA spans."""
    spans = decode_spans()
    if spans is None:
        return None
    n, total = spans[STEP]
    return 1e3 * (total - sum(spans[b][1] for b in BLOCKS if b in spans)) / n

"""dispatch_ms.decode: the median host milliseconds to enqueue one decode
step and its argmax (``decode_fn`` and ``argmax``, no synchronise; host
clock, every decode step of the window). A median: a step whose launches
wait for room in the launch queue reads long. Moves itl_p95_ms."""

import statistics


def read(ctx):
    d = ctx.get("dispatch_s")
    return statistics.median(d) * 1e3 if d else None

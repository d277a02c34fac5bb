"""graph_share.decode: the share of the traced decode steps that a replay of
the decode step's CUDA graph served (``dist/step.py::DecodeGraph``), in
percent, from the port's counters ``graph.replay`` and ``graph.eager``
(``port_counts``); None without them. Moves itl_p95_ms."""

from portbench import port_counts


def read(ctx):
    return port_counts.graph_share()

"""mamba_host_ms.decode: host ms a traced decode step inside the port's
``repro_torch.mamba`` spans (``models/mamba.py::mamba_block``), over
``serve.decode`` spans (``port_spans``); None without the port's spans.
Moves itl_p95_ms."""

from portbench import port_spans


def read(ctx):
    return port_spans.ms_per_step(["repro_torch.mamba"])

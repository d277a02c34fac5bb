"""kernel_host_ms.decode: host ms a traced decode step inside the port's
``repro_torch.kernel.*`` spans (the ``kernels/*.py`` wrappers: checks, route
or split choice, the ctypes launch), over ``serve.decode`` spans
(``port_spans``). It overlaps the MoE, Mamba and attention metrics on
purpose: it says how much of them is the wrappers. None without the port's
spans. Moves itl_p95_ms."""

from portbench import port_spans


def read(ctx):
    return port_spans.ms_per_step(["repro_torch.kernel."])

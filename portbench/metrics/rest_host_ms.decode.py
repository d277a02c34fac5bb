"""rest_host_ms.decode: host ms a traced decode step inside the port's
``repro_torch.serve.decode`` span and outside its ``moe``, ``mamba``,
``attention`` and ``mla`` spans (``dist/step.py``'s serve functions and
their check, ``models/registry.py``'s embedding and head,
``models/transformer.py::apply_layer``'s norms, dense FFNs and residual
adds), over ``serve.decode`` spans (``port_spans``); None without the
port's spans. Moves itl_p95_ms."""

from portbench import port_spans


def read(ctx):
    return port_spans.rest_ms_per_step()

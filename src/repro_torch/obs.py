"""Host spans of the serve path, on the profiler's clock.

``span(name)`` marks a region of the port as ``repro_torch.<name>``. While a
``torch.profiler`` session records (``torch.autograd._profiler_enabled()``)
it opens a host-only record function (``_RecordFunctionFast``: unlike
``record_function`` it is no user annotation, so the profiler copies nothing
of it onto the device's timeline, whose rows keep only device work) and adds
the region's count and host seconds (``time.perf_counter_ns``) to a registry
keyed by the enclosing serve phase (``"prefill"``, ``"decode"``, or ``""``
outside both: ``dist.step``'s ``serve.prefill`` and ``serve.decode`` spans
set it) and the span's name. Otherwise it costs that one check and returns a
shared ``nullcontext``. There is no other switch. Nothing of a span reaches
the device, so a CUDA graph captured around a serve step records none; a
step served by replaying one runs only the spans outside the graph
(``serve.decode``, ``serve.check``), not those of the layers inside it.

``count(name)`` adds one to the counter ``repro_torch.<name>`` in a second
registry, in the same way: only while a profiler records, under the serve
phase open at the time (``count_totals()``). ``dist.step``'s decode counts
its steps by path: ``graph.replay`` (a step served by replaying the decode
step's CUDA graph), ``graph.eager`` (a step run eagerly), and, of the
replayed steps, ``graph.capture`` (captured first) and ``graph.copy_in``
(the state copied into the graph's buffers first).

Spans (all ``repro_torch.``): ``serve.prefill``, ``serve.decode`` and
``serve.check`` (``dist/step.py``); ``embed`` and ``head``
(``models/registry.py``); ``norm``, one span per mixer kind (``attention``,
``mla``, ``mamba``, ``cross``) and per FFN kind (``moe``, ``ffn``)
(``models/transformer.py``); ``moe.route``, ``moe.dispatch``,
``moe.experts`` and ``moe.combine`` (``models/moe.py``); ``kernel.<name>``
around each kernel wrapper of ``kernels.ops.KERNELS``.

An operator profiles a serve loop and reads the registry or the trace::

    from torch.profiler import ProfilerActivity, profile
    from repro_torch import obs

    obs.reset_spans()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(steps):
            logits, state = decode_fn(params, tok, state)
            tok = logits.argmax(dim=-1)[:, None]
    decode = obs.span_totals()["decode"]
    n_steps = decode["repro_torch.serve.decode"][0]
    moe_ms = 1e3 * decode["repro_torch.moe"][1] / n_steps  # host ms a step in the MoE FFNs
    prof.export_chrome_trace("serve.json")  # the same spans on the host's rows

The registries belong to the process and assume one serving thread.
"""

from __future__ import annotations

import contextlib
import functools
import time

from torch._C._profiler import _RecordFunctionFast
from torch.autograd import _profiler_enabled

PREFIX = "repro_torch."

_OFF = contextlib.nullcontext()
_totals: dict = {}  # phase -> {span name: [count, host ns]}
_counts: dict = {}  # phase -> {counter name: count}
_phase = ""


class _Span:
    __slots__ = ("name", "phase", "outer", "rf", "t0")

    def __init__(self, name: str, phase):
        self.name, self.phase = PREFIX + name, phase

    def __enter__(self):
        global _phase
        self.outer = _phase
        if self.phase is not None:
            _phase = self.phase
        self.rf = _RecordFunctionFast(self.name)
        self.rf.__enter__()
        self.t0 = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        global _phase
        ns = time.perf_counter_ns() - self.t0
        self.rf.__exit__(*exc)
        entry = _totals.setdefault(_phase, {}).setdefault(self.name, [0, 0])
        entry[0] += 1
        entry[1] += ns
        _phase = self.outer
        return False


def span(name: str, phase=None):
    """``repro_torch.<name>`` while the profiler records (see the module
    note); ``phase`` names the serve phase that the region and every span
    inside it count under."""
    if not _profiler_enabled():
        return _OFF
    return _Span(name, phase)


def spanned(name: str):
    """Decorate a function to run inside ``span(name)``."""

    def wrap(fn):
        @functools.wraps(fn)
        def inner(*args, **kwargs):
            with span(name):
                return fn(*args, **kwargs)

        return inner

    return wrap


def count(name: str) -> None:
    """Add one to ``repro_torch.<name>`` under the open serve phase while the
    profiler records (see the module note)."""
    if _profiler_enabled():
        by_name = _counts.setdefault(_phase, {})
        by_name[PREFIX + name] = by_name.get(PREFIX + name, 0) + 1


def count_totals() -> dict:
    """{phase: {counter name: count}} since the last ``reset_spans()``."""
    return {ph: dict(by_name) for ph, by_name in _counts.items()}


def span_totals() -> dict:
    """{phase: {span name: (count, host seconds)}} since the last
    ``reset_spans()``."""
    return {ph: {n: (c, ns / 1e9) for n, (c, ns) in by_name.items()} for ph, by_name in _totals.items()}


def reset_spans() -> None:
    """Empty both registries, the spans' and the counters'."""
    _totals.clear()
    _counts.clear()

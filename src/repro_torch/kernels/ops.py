"""The kernel registry handed to the models, and the launch counters.

Port of ``repro.kernels.ops``. ``kernel_set()`` returns the dict the model
trunk threads through the layers (``repro_torch.models.transformer``): the
hand-written CUDA kernels, whose wrappers compute the plain version for CPU
tensors. A caller may hand the trunk another dict, e.g. the plain versions
of ``ref`` on the card, to hold the kernels against them. ``KERNELS`` also
holds ``hash_tree``, which the engine's content hashing launches
(``repro_torch.core.hashing``), not the models; the launch counters cover
all eight. Under ``torch.profiler`` each wrapper's call runs inside the
host span ``kernel.<name>`` (``repro_torch.obs``), its checks, route choice
and launch included. The three backward kernels that training runs have no Pallas
counterpart (the JAX train step differentiates jnp code):
``flash_attention_bwd`` (K1), ``moe_gmm_bwd`` (K7a) and ``mamba_scan_bwd``
(K7b), each paired with its forward in a ``torch.autograd.Function`` of
``repro_torch.models``.
"""

from __future__ import annotations

import contextlib
import re

from .flash_attention import flash_attention, flash_attention_bwd
from .flash_decode import flash_decode
from .hash_tree import hash_tree_states
from .mamba_scan import mamba_scan, mamba_scan_bwd
from .moe_gmm import moe_gmm, moe_gmm_bwd

KERNELS = {
    "flash_attention": flash_attention,
    "flash_attention_bwd": flash_attention_bwd,
    "flash_decode": flash_decode,
    "moe_gmm": moe_gmm,
    "moe_gmm_bwd": moe_gmm_bwd,
    "mamba_scan": mamba_scan,
    "mamba_scan_bwd": mamba_scan_bwd,
    "hash_tree": hash_tree_states,
}
# The wrappers themselves, which hold the launch counts: the counters below
# read these, whatever a caller stands in ``KERNELS`` for a while (a spy that
# calls the wrapper).
_WRAPPERS = dict(KERNELS)
_counting: list = []  # the registries of the open count_calls() blocks, innermost last

# The CUDA kernels that the serving wrappers' calls launch, by their names in
# a profiler trace (qualified, "(anonymous namespace)::" left out), and how
# many one call launches, for ``calls_in_trace``.
DEVICE_KERNELS = {
    "flash_attention": (("flash_attention_kernel", "mma::attn_kernel"), 1),
    "flash_decode": (("flash_decode_kernel",), 1),
    "moe_gmm": (("gmm_kernel", "wg::gemm_kernel", "swab::swap_ab_kernel"), 2),
    "mamba_scan": (("mamba_scan_kernel",), 1),
}


def kernel_set() -> dict:
    """The dict the model trunk consumes (it reads flash_attention,
    flash_decode, moe_gmm and mamba_scan, and for a gradient their backward
    kernels flash_attention_bwd, moe_gmm_bwd and mamba_scan_bwd)."""
    return dict(KERNELS)


def launch_counts() -> dict:
    """Kernel launches so far, by name."""
    return {name: fn.launches for name, fn in _WRAPPERS.items()}


def launch_state() -> dict:
    """Every kernel's launch count and per-route counts: {name: (launches,
    {route: launches})}, for ``launches_since``."""
    return {name: (fn.launches, dict(getattr(fn, "route_launches", {}))) for name, fn in _WRAPPERS.items()}


def launches_since(before: dict) -> dict:
    """The launches counted since ``launch_state()`` gave ``before``, in its
    form; kernels with none are left out."""
    out = {}
    for name, (n, routes) in launch_state().items():
        n0, routes0 = before.get(name, (0, {}))
        if n != n0:
            out[name] = (n - n0, {r: c - routes0.get(r, 0) for r, c in routes.items() if c != routes0.get(r, 0)})
    return out


def add_launches(counts: dict, times: int = 1) -> None:
    """Add ``times`` x ``counts`` (``launches_since``'s form) to the
    counters: the launches of a replayed CUDA graph, which no wrapper's
    Python runs to count (``dist.step.DecodeGraph``)."""
    for name, (n, routes) in counts.items():
        fn = _WRAPPERS[name]
        fn.launches += times * n
        for r, c in routes.items():
            fn.route_launches[r] += times * c


@contextlib.contextmanager
def count_calls(names):
    """Count the calls of the kernels ``names`` by the shapes of their first
    three inputs while open; yields {name: {shapes: calls}}. A counting
    function stands in ``KERNELS`` for each, around what stood there, so
    blocks nest; a replayed CUDA graph adds the calls it captured
    (``add_calls``), as it adds their launches."""
    calls = {name: {} for name in names}
    saved = {name: KERNELS[name] for name in names}
    for name, fn in saved.items():
        def counted(*args, _fn=fn, _per=calls[name], **kwargs):
            key = tuple(tuple(a.shape) for a in args[:3])
            _per[key] = _per.get(key, 0) + 1
            return _fn(*args, **kwargs)

        KERNELS[name] = counted
    _counting.append(calls)
    try:
        yield calls
    finally:
        KERNELS.update(saved)
        _counting.pop()


def add_calls(calls: dict, times: int = 1) -> None:
    """Add ``times`` x ``calls`` ({name: {shapes: calls}}) to every
    ``count_calls`` block open for those kernels."""
    for open_calls in _counting:
        for name, per in calls.items():
            if name in open_calls:
                into = open_calls[name]
                for key, c in per.items():
                    into[key] = into.get(key, 0) + times * c


def calls_in_trace(kernel_names) -> dict:
    """{wrapper: calls} that the CUDA kernels named ``kernel_names`` (a
    profiler trace's kernel events) make up, for each wrapper of
    ``DEVICE_KERNELS``: what the device ran, to hold the launch counters
    against (a replayed CUDA graph's launches are added, not counted)."""
    wrapper_of = {k: name for name, (kernels, _) in DEVICE_KERNELS.items() for k in kernels}
    n = dict.fromkeys(DEVICE_KERNELS, 0)
    for full in kernel_names:
        qualified = re.split(r"[<(]", full.replace("(anonymous namespace)::", ""), maxsplit=1)[0].split()[-1]
        if qualified in wrapper_of:
            n[wrapper_of[qualified]] += 1
    return {name: c / DEVICE_KERNELS[name][1] for name, c in n.items()}


def reset_launch_counts() -> None:
    """Zero every launch count, and the per-route counts of the kernels that
    have routes (``route_launches``)."""
    for fn in _WRAPPERS.values():
        fn.launches = 0
        routes = getattr(fn, "route_launches", None)
        if routes is not None:
            for r in routes:
                routes[r] = 0

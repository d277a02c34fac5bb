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


def kernel_set() -> dict:
    """The dict the model trunk consumes (it reads flash_attention,
    flash_decode, moe_gmm and mamba_scan, and for a gradient their backward
    kernels flash_attention_bwd, moe_gmm_bwd and mamba_scan_bwd)."""
    return dict(KERNELS)


def launch_counts() -> dict:
    """Kernel launches so far, by name."""
    return {name: fn.launches for name, fn in KERNELS.items()}


def reset_launch_counts() -> None:
    """Zero every launch count, and the per-route counts of the kernels that
    have routes (``route_launches``)."""
    for fn in KERNELS.values():
        fn.launches = 0
        routes = getattr(fn, "route_launches", None)
        if routes is not None:
            for r in routes:
                routes[r] = 0

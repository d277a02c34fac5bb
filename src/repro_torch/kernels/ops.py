"""The kernel registry handed to the models, and the launch counters.

Port of ``repro.kernels.ops``. ``kernel_set()`` returns the dict the model
trunk threads through the layers (``repro_torch.models.transformer``): the
hand-written CUDA kernels, whose wrappers compute the plain version for CPU
tensors. A caller may hand the trunk another dict, e.g. the plain versions
of ``ref`` on the card, to hold the kernels against them.
"""

from __future__ import annotations

from .flash_attention import flash_attention
from .flash_decode import flash_decode
from .mamba_scan import mamba_scan
from .moe_gmm import moe_gmm

KERNELS = {
    "flash_attention": flash_attention,
    "flash_decode": flash_decode,
    "moe_gmm": moe_gmm,
    "mamba_scan": mamba_scan,
}


def kernel_set() -> dict:
    """The dict the model trunk consumes (keys: flash_attention, flash_decode,
    moe_gmm, mamba_scan)."""
    return dict(KERNELS)


def launch_counts() -> dict:
    """Kernel launches so far, by name."""
    return {name: fn.launches for name, fn in KERNELS.items()}


def reset_launch_counts() -> None:
    for fn in KERNELS.values():
        fn.launches = 0

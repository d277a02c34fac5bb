"""Device bindings of the port (``repro.launch.mesh``).

The reference builds JAX meshes: a production pod (16, 16) or two pods, and
a small host mesh over whatever devices exist. The port runs on one device
until sharding is ported (ROADMAP.md queue 1, item 6): ``make_host_mesh``
binds that device, and asking for more than one raises.
"""

from __future__ import annotations

import torch

from repro_torch.models.common import resolve_device

_ITEM_6 = "ROADMAP queue 1 item 6: distribution"


def make_production_mesh(*, multi_pod: bool = False):
    raise NotImplementedError(f"a production mesh of many devices is not ported yet ({_ITEM_6})")


def make_host_mesh(model: int = 1, device="cuda") -> torch.device:
    """The one device a step runs on (``device``, default the current card;
    raises without one). ``model > 1`` asks for a mesh of several devices."""
    if model != 1:
        raise NotImplementedError(f"a mesh with a model axis of {model} devices is not ported yet ({_ITEM_6})")
    return resolve_device(device)

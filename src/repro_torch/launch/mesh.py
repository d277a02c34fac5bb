"""Device meshes of the port (``repro.launch.mesh``).

``make_host_mesh(model)`` is a ``DeviceMesh`` (world / model, model) named
("data", "model") over the initialised process group: one rank a card under
``torchrun`` (NCCL), or ranks of gloo on the CPU or sharing one card. With
no process group it is the one device a step runs on (a ``torch.device``),
as the one-device steps take it.

``make_production_mesh(multi_pod)`` is the reference's production shape,
(16, 16) ("data", "model") or (2, 16, 16) ("pod", "data", "model"), over a
process group of that many ranks. With ``fake=True`` and no process group,
it first starts torch's fake backend in this one process (a world of 256 or
512 ranks, no devices), so that rules, placements and per-rank shapes can be
planned for a mesh that does not exist. A process group the caller already
set up is never replaced.

``join_process_group(device)`` joins the process group of a launcher that
starts several processes (``torchrun``), as the train and serve drivers do.

Functions, not module constants: importing this module starts nothing.
"""

from __future__ import annotations

import os

import torch
import torch.distributed as dist

from repro_torch.models.common import resolve_device


def _device_type(device) -> str:
    dev = resolve_device(device)
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"a mesh of {dev.type} devices")
    return dev.type


def join_process_group(device) -> None:
    """Under a launcher that sets ``WORLD_SIZE`` > 1 (``torchrun``), join its
    process group: NCCL with this rank on card ``LOCAL_RANK``, or gloo on the
    CPU. Nothing without one, or when a group is already initialised."""
    if int(os.environ.get("WORLD_SIZE", "1")) <= 1 or dist.is_initialized():
        return
    if torch.device(device).type == "cuda":
        torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", "0")))
        dist.init_process_group("nccl")
    else:
        dist.init_process_group("gloo")


def make_host_mesh(model: int = 1, device="cuda"):
    """A DeviceMesh (world // model, model) over the initialised process
    group, on ``device``'s type; without a process group, ``device`` itself
    (raises for ``model > 1``, or for CUDA without a card)."""
    if not dist.is_initialized():
        if model != 1:
            raise ValueError(f"a model axis of {model} ranks needs an initialised process group of them")
        return resolve_device(device)
    from torch.distributed.device_mesh import DeviceMesh

    world = dist.get_world_size()
    if model < 1 or world % model:
        raise ValueError(f"a model axis of {model} does not divide the world of {world} ranks")
    return DeviceMesh(_device_type(device), torch.arange(world).reshape(world // model, model),
                      mesh_dim_names=("data", "model"))


def make_production_mesh(*, multi_pod: bool = False, fake: bool = False, device="cuda"):
    """The (16, 16) pod or the (2, 16, 16) pair of pods as a DeviceMesh.
    Over the initialised process group (its world must match); or, with
    ``fake`` and no process group, over torch's fake backend in this process
    (rank 0 of the shape's world; the mesh's device type is then "cpu")."""
    from torch.distributed.device_mesh import DeviceMesh

    shape = (2, 16, 16) if multi_pod else (16, 16)
    names = ("pod", "data", "model") if multi_pod else ("data", "model")
    world = 1
    for n in shape:
        world *= n
    if not dist.is_initialized():
        if not fake:
            raise RuntimeError(f"a mesh {shape} needs a process group of {world} ranks (or fake=True to plan)")
        from torch.testing._internal.distributed.fake_pg import FakeStore

        dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=world)
        device = "cpu"
    if dist.get_world_size() != world:
        raise ValueError(f"a mesh {shape} over a process group of {dist.get_world_size()} ranks")
    dtype = "cpu" if str(dist.get_backend()) == "fake" else _device_type(device)
    return DeviceMesh(dtype, torch.arange(world).reshape(shape), mesh_dim_names=names)

"""Wireframing: ghost batches through the circuit (paper §III.K / §III.L).

"The most basic execution of a data pipeline is to send no real data at all.
By sending ghost batches through a pipeline, we can expose where data actually
end up being routed, in test runs prior to exposing to real data."

Port of ``repro.core.wireframe``. Ghost payloads are :class:`ShapeDtypeStruct`
specs: a shape (a tuple of ints), a dtype written as numpy writes it
(``"float32"``, ``"bfloat16"``, ``"bool"``) and ``nbytes`` None, so they
digest as ``sha256("ghost:{shape}:{dtype}")`` exactly as the JAX package's
``jax.ShapeDtypeStruct`` ghosts do, and journal with the same repr. Each
task's user code runs on ``device="meta"`` tensors of those shapes under
``torch.no_grad()`` — no bytes allocated, no kernel launched (the kernel
wrappers send non-CUDA tensors to their plain versions) — and its tensor
outputs turn back into specs. The AV machinery (links, stamps, visitor logs,
region transits) runs for real. Code that cannot run on meta tensors
(``.item()``, numpy calls, services) yields an opaque :class:`GhostValue`.
A weak-typed scalar spec fed to a downstream task becomes a 0-d tensor of its
dtype there, so weak typing does not carry on through torch ops as it does
through JAX's.

Ghost values never touch the :class:`~repro_torch.core.store.ArtifactStore`:
the shape spec rides on the AV itself (``meta["ghost_spec"]``, ``ghost://``
URIs), so a wireframe run leaves the store's put/get counters at exactly
zero — the strongest form of the paper's transport-avoidance claim.
"""

from __future__ import annotations

from typing import Any, Optional

import torch

from .pipeline import PipelineManager


def _dtype_name(dtype) -> str:
    """numpy's name for a dtype given as a string, a numpy dtype or a torch
    dtype (``torch.float32`` -> ``"float32"``)."""
    if isinstance(dtype, torch.dtype):
        return str(dtype).removeprefix("torch.")
    if isinstance(dtype, str):
        return dtype
    return str(getattr(dtype, "name", dtype))


class ShapeDtypeStruct:
    """A ghost payload: shape and dtype, no bytes (``nbytes`` is None).

    ``weak_type`` marks a Python scalar's ghost, as the JAX package's abstract
    evaluation marks it; it shows in the repr only."""

    __slots__ = ("shape", "dtype", "weak_type")
    nbytes = None

    def __init__(self, shape, dtype, weak_type: bool = False) -> None:
        self.shape = tuple(int(d) for d in shape)
        self.dtype = _dtype_name(dtype)
        self.weak_type = bool(weak_type)

    def to_meta(self) -> torch.Tensor:
        """An empty tensor of this shape and dtype on the meta device."""
        return torch.empty(self.shape, dtype=getattr(torch, self.dtype), device="meta")

    def __eq__(self, other) -> bool:
        return (
            isinstance(other, ShapeDtypeStruct)
            and (self.shape, self.dtype, self.weak_type)
            == (other.shape, other.dtype, other.weak_type)
        )

    def __hash__(self) -> int:
        return hash((self.shape, self.dtype, self.weak_type))

    def __repr__(self) -> str:
        weak = ", weak_type=True" if self.weak_type else ""
        return f"ShapeDtypeStruct(shape={self.shape}, dtype={self.dtype}{weak})"


class GhostValue:
    """Opaque ghost for tasks whose code cannot run on meta tensors."""

    def __init__(self, label: str = "ghost") -> None:
        self.label = label
        self.shape = ()
        self.dtype = "ghost"
        self.nbytes = None

    def __repr__(self) -> str:
        return f"GhostValue({self.label})"


def _abstract(out):
    """Turn a function's outputs on meta tensors back into specs; Python
    scalars become weak-typed scalar specs, as under ``jax.eval_shape``."""
    if isinstance(out, torch.Tensor):
        return ShapeDtypeStruct(tuple(out.shape), out.dtype)
    if isinstance(out, dict):
        return {k: _abstract(v) for k, v in out.items()}
    if isinstance(out, (list, tuple)):
        return type(out)(_abstract(v) for v in out)
    if isinstance(out, bool):
        return ShapeDtypeStruct((), "bool", weak_type=True)
    if isinstance(out, int):
        return ShapeDtypeStruct((), "int32", weak_type=True)
    if isinstance(out, float):
        return ShapeDtypeStruct((), "float32", weak_type=True)
    raise TypeError(f"{type(out).__name__} output has no abstract value")


def eval_shape(fn, **kwargs):
    """Run ``fn`` on meta tensors built from the ghost specs in ``kwargs``
    (lists of specs become lists of tensors) and return its outputs as
    specs."""
    meta = {
        k: [s.to_meta() for s in v] if isinstance(v, list) else v.to_meta()
        for k, v in kwargs.items()
    }
    with torch.no_grad():
        return _abstract(fn(**meta))


def _ghostify_fn(task_name: str, fn, outputs: list):
    def ghost_fn(**kwargs: Any):
        # Service handles pass through untouched; array ghosts stay abstract.
        try:
            specs = {
                k: v
                for k, v in kwargs.items()
                if isinstance(v, ShapeDtypeStruct)
                or (isinstance(v, list) and all(isinstance(x, ShapeDtypeStruct) for x in v))
            }
            if specs and len(specs) == len(kwargs):
                out = eval_shape(fn, **kwargs)
                if not isinstance(out, dict):
                    out = {outputs[0]: out}
                return out
        except Exception:
            pass  # code that cannot run on meta tensors: fall through to opaque ghosts
        return {o: GhostValue(f"{task_name}.{o}") for o in outputs}

    return ghost_fn


def ghost_run(
    manager: PipelineManager,
    injections: dict,
    pulls: Optional[list] = None,
) -> dict:
    """Run the pipeline with ghosts.

    injections: {(task, input_name): ShapeDtypeStruct or list thereof}
    pulls: optional make-mode targets to resolve after injection.

    Returns a routing report: per-link traffic, per-task visits, and the shape
    contract discovered on every wire.
    """
    pipe = manager.pipeline
    originals = {}
    for t in pipe.tasks.values():
        originals[t.name] = t.fn
        t.fn = _ghostify_fn(t.name, t.fn, t.outputs)
    try:
        for (task, iname), spec in injections.items():
            specs = spec if isinstance(spec, list) else [spec]
            for s in specs:
                manager._inject(task, iname, s)
        manager.propagate()
        for target in pulls or []:
            manager._pull(target)
    finally:
        for t in pipe.tasks.values():
            t.fn = originals[t.name]

    contract = {}
    for link in pipe.links:
        av = None
        # last AV seen on this wire, if any, via registry lineage
        for uid in reversed(manager.registry.all_avs()):
            a = manager.registry.get_av(uid)
            if a.source_task == link.src_task:
                av = a
                break
        contract[link.name] = {
            "carried": link.avs_carried,
            "last_hash": av.chash if av else None,
        }
    return {
        "routes": contract,
        "tasks": {
            n: {"executions": t.executions}
            for n, t in pipe.tasks.items()
        },
        "design_map": manager.registry.design_map(),
    }

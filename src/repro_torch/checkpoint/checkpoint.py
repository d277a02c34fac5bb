"""Provenance-stamped checkpoints of a tree of torch tensors.

Port of ``repro.checkpoint.checkpoint``. Every checkpoint is a Koalja
artifact: the payload (one npz per host) plus an AnnotatedValue travel
document naming the step, code version and meta that produced it. Restart is
'make'-mode: restore the latest checkpoint and resume.

The state is a tree of dicts and lists of tensors; its leaves are stored
under their paths joined with ``/`` (``params/layers/0/mixer/wq``), dict
keys in sorted order, as the reference flattens its pytree. numpy has no
bfloat16 of its own, so a bf16 tensor is stored as its ``uint16`` bit view
and restored bit for bit into the dtype of the tree it is restored into.
The manifest's ``payload_hash`` is taken over each leaf's shape and its
canonical dtype name (``"bfloat16"``, ``"float32"``, ``"int32"``), as the
reference's over numpy's names.

Async save: the device-to-host copy of the whole state happens in
``save_async`` before the writer thread starts, so the train loop may update
the state in place right after; the thread serialises the host copy.
"""

from __future__ import annotations

import json
import os
import shutil
import threading
import time
from typing import Any, Optional

import numpy as np
import torch

from repro_torch.core import AnnotatedValue, ArtifactStore, content_hash


def _flatten_with_paths(tree, prefix: str = "") -> dict:
    if isinstance(tree, dict):
        out = {}
        for k in sorted(tree):
            out.update(_flatten_with_paths(tree[k], f"{prefix}{k}/"))
        return out
    if isinstance(tree, (list, tuple)):
        out = {}
        for i, t in enumerate(tree):
            out.update(_flatten_with_paths(t, f"{prefix}{i}/"))
        return out
    return {prefix[:-1]: tree}


def _unflatten_like(like, flat: dict, prefix: str = ""):
    if isinstance(like, dict):
        return {k: _unflatten_like(like[k], flat, f"{prefix}{k}/") for k in like}
    if isinstance(like, (list, tuple)):
        return type(like)(_unflatten_like(t, flat, f"{prefix}{i}/") for i, t in enumerate(like))
    return flat[prefix[:-1]]


def dtype_name(dtype: torch.dtype) -> str:
    """numpy's name for a torch dtype; ``"bfloat16"`` for bf16."""
    return str(dtype).removeprefix("torch.")


def _to_numpy(t: torch.Tensor) -> np.ndarray:
    t = t.detach().cpu().contiguous()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.uint16)
    return t.numpy()


def _from_numpy(a: np.ndarray, like: torch.Tensor, key: str) -> torch.Tensor:
    if tuple(a.shape) != tuple(like.shape):
        raise ValueError(f"shape mismatch for {key}: {a.shape} vs {tuple(like.shape)}")
    if like.dtype == torch.bfloat16 and a.dtype == np.uint16:
        t = torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
    elif a.dtype.name == dtype_name(like.dtype):
        t = torch.from_numpy(a)
    else:
        raise TypeError(f"dtype mismatch for {key}: stored {a.dtype} vs {like.dtype}")
    device = like.device if like.device.type != "meta" else torch.device("cpu")
    return t.to(device)


def save_checkpoint(
    directory: str,
    state: Any,
    step: int,
    *,
    meta: Optional[dict] = None,
    software_version: str = "?",
    store: Optional[ArtifactStore] = None,
    host_id: int = 0,
) -> AnnotatedValue:
    """Write <dir>/step_<N>/host_<id>.npz + manifest; returns the AV."""
    os.makedirs(directory, exist_ok=True)
    step_dir = os.path.join(directory, f"step_{step:08d}")
    os.makedirs(step_dir, exist_ok=True)
    flat = _flatten_with_paths(state)
    arrays = {k: _to_numpy(v) for k, v in flat.items()}
    path = os.path.join(step_dir, f"host_{host_id}.npz")
    np.savez(path, **arrays)

    manifest = {
        "step": step,
        "host": host_id,
        "keys": sorted(arrays.keys()),
        "software_version": software_version,
        "meta": meta or {},
        "written_at": time.time(),
        "payload_hash": content_hash(
            {k: (tuple(v.shape), dtype_name(flat[k].dtype)) for k, v in arrays.items()}
        ),
    }
    with open(os.path.join(step_dir, f"manifest_{host_id}.json"), "w") as f:
        json.dump(manifest, f, indent=2)

    av = AnnotatedValue.produce(
        manifest["payload_hash"],
        f"file://{path}",
        source_task="checkpoint.save",
        software_version=software_version,
        meta={"step": step, "dir": step_dir},
    )
    if store is not None:
        store.put(manifest)
    return av


def _steps(directory: str) -> list:
    return sorted(int(d.split("_")[1]) for d in os.listdir(directory) if d.startswith("step_"))


def restore_checkpoint(directory: str, like: Any, step: Optional[int] = None, host_id: int = 0):
    """Restore into the structure, dtypes and devices of ``like`` (shapes and
    dtypes validated; a ``meta`` leaf restores to the CPU). Returns
    (state, manifest)."""
    steps = _steps(directory)
    if not steps:
        raise FileNotFoundError(f"no checkpoints under {directory}")
    step = steps[-1] if step is None else step
    step_dir = os.path.join(directory, f"step_{step:08d}")
    with open(os.path.join(step_dir, f"manifest_{host_id}.json")) as f:
        manifest = json.load(f)
    flat_like = _flatten_with_paths(like)
    with np.load(os.path.join(step_dir, f"host_{host_id}.npz")) as data:
        missing = set(flat_like) - set(data.files)
        if missing:
            raise KeyError(f"checkpoint missing keys: {sorted(missing)[:5]} ...")
        flat = {k: _from_numpy(data[k], leaf, k) for k, leaf in flat_like.items()}
    return _unflatten_like(like, flat), manifest


class CheckpointManager:
    """Async save + retention + provenance wiring."""

    def __init__(
        self,
        directory: str,
        *,
        keep: int = 3,
        software_version: str = "?",
        store: Optional[ArtifactStore] = None,
    ) -> None:
        self.directory = directory
        self.keep = keep
        self.software_version = software_version
        self.store = store
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None
        self.saved: list = []  # AVs

    def save_async(self, state: Any, step: int, meta: Optional[dict] = None):
        # device->host copy happens here (blocking); a copy even for CPU
        # tensors, which the train step goes on updating in place
        flat = {k: v.detach().to("cpu", copy=True) for k, v in _flatten_with_paths(state).items()}
        host_state = _unflatten_like(state, flat)
        self.wait()

        def _write():
            try:
                av = save_checkpoint(
                    self.directory,
                    host_state,
                    step,
                    meta=meta,
                    software_version=self.software_version,
                    store=self.store,
                )
                self.saved.append(av)
                self._gc()
            except BaseException as e:  # re-raised by wait() on the caller's thread
                self._error = e

        self._thread = threading.Thread(target=_write, daemon=True)
        self._thread.start()

    def wait(self):
        """Join the writer thread; raise what it raised, if anything."""
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            err, self._error = self._error, None
            raise err

    def latest_step(self) -> Optional[int]:
        if not os.path.isdir(self.directory):
            return None
        steps = _steps(self.directory)
        return steps[-1] if steps else None

    def restore(self, like: Any, step: Optional[int] = None):
        return restore_checkpoint(self.directory, like, step)

    def _gc(self):
        for s in _steps(self.directory)[: -self.keep]:
            shutil.rmtree(os.path.join(self.directory, f"step_{s:08d}"), ignore_errors=True)

"""repro_torch.workspace — the typed public API over the Koalja circuit layer.

    from repro_torch.workspace import Workspace

    ws = Workspace("demo")
    cam = ws.source(read_fn, name="camera", outputs=["image"])
    det = ws.task(detect_fn, name="detect", inputs=["frame"], outputs=["boxes"])
    cam["image"] >> det["frame"]
    ws.push(cam, image=img)
    boxes = ws.pull(det)["boxes"]

See :class:`Workspace` for the full surface (push / pull / sample / watch /
ghost / provenance queries) and :mod:`repro_torch.workspace.executors` for the
backend protocol (InlineExecutor, ConcurrentExecutor).
"""

from .executors import (
    AdaptiveExecutor,
    ConcurrentExecutor,
    Executor,
    InlineExecutor,
    MeshExecutor,
    ZonedExecutor,
    default_executor,
)
from .handles import Port, TaskHandle, Wire, WiringError
from .workspace import (
    RunResult,
    TaskResult,
    Watcher,
    Workspace,
    WorkspaceFrozenError,
    service,
)

__all__ = [
    "AdaptiveExecutor", "ConcurrentExecutor", "Executor", "InlineExecutor",
    "MeshExecutor", "ZonedExecutor", "default_executor",
    "Port", "TaskHandle", "Wire", "WiringError",
    "RunResult", "TaskResult", "Watcher", "Workspace",
    "WorkspaceFrozenError", "service",
]

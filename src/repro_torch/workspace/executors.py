"""Executor backends: where a Workspace's circuit actually runs.

Port of ``repro.workspace.executors``. The executor protocol is the
underlay-transparency seam from the paper: the breadboard (Workspace) and
the trigger semantics (push/pull/sample) are fixed; *where* task code
executes is a backend choice. ``InlineExecutor`` runs everything in-process
(the paper's single-node breadboard); ``ConcurrentExecutor`` fans a wave of
simultaneously-ready tasks across a thread pool. ``MeshExecutor`` binds the
circuit to one torch device and builds the model steps on it.
``ZonedExecutor`` partitions each wave by extended-cloud zone (placement
decided by the scheduler's ``PlacementPolicy``) and runs each partition
through its ``inner=`` backend; ``AdaptiveExecutor`` resizes a pool-bearing
backend between waves. The process backends live in
:mod:`repro_torch.runtime`.

The scheduling seam is ``run_wave(manager, tasks)``: the event scheduler
(:mod:`repro_torch.core.scheduler`) computes *waves* of ready tasks and hands each
wave here. Backends run the user code however they like, but emission is
always serialized by the scheduler in wave order, so provenance and
merge-FCFS snapshots are identical across backends.
"""

from __future__ import annotations

import os
from concurrent.futures import ThreadPoolExecutor
from typing import Any, Optional, Protocol, runtime_checkable


@runtime_checkable
class Executor(Protocol):
    """Minimal backend contract: drive one PipelineManager engine call and
    execute scheduler waves."""

    def push(self, manager, task: str, payloads: dict, region: str) -> dict: ...

    def pull(self, manager, target: str) -> dict: ...

    def sample(self, manager, source: str) -> dict: ...

    def inject(self, manager, task: str, input_name: str, payload: Any, region: str): ...

    def run_wave(self, manager, tasks: list) -> list: ...

    def stats(self) -> dict: ...


class InlineExecutor:
    """Run tasks in-process on the shared trigger engine.

    Counts every engine call it drives, so ``Workspace.stats()`` can report
    how much *triggering* happened alongside how much work and transport the
    memo/store layers avoided (§III.F)."""

    def __init__(self) -> None:
        self.pushes = 0
        self.pulls = 0
        self.samples = 0
        self.injects = 0
        self.waves_run = 0

    def push(self, manager, task: str, payloads: dict, region: str) -> dict:
        self.pushes += 1
        return manager._push(task, region=region, **payloads)

    def pull(self, manager, target: str) -> dict:
        self.pulls += 1
        return manager._pull(target)

    def sample(self, manager, source: str) -> dict:
        self.samples += 1
        return manager._sample(source)

    def inject(self, manager, task: str, input_name: str, payload: Any, region: str):
        self.injects += 1
        return manager._inject(task, input_name, payload, region=region)

    def run_wave(self, manager, tasks: list) -> list:
        """Execute one scheduler wave serially (today's semantics, minus the
        full-graph scans). Emission is deferred to the scheduler."""
        self.waves_run += 1
        return [
            (t.name, t.execute(manager.store, manager.registry, manager.cache, emit=False))
            for t in tasks
        ]

    def stats(self) -> dict:
        return {
            "backend": type(self).__name__,
            "pushes": self.pushes,
            "pulls": self.pulls,
            "samples": self.samples,
            "injects": self.injects,
            "waves_run": self.waves_run,
        }

    def __repr__(self) -> str:
        return "InlineExecutor()"


class ConcurrentExecutor(InlineExecutor):
    """Execute independent tasks of a wave in parallel on a thread pool.

    The tasks of one wave are, by construction, independent (each consumes
    its own already-formed snapshot), so user code runs concurrently; the
    scheduler then emits outputs serially in wave order, which keeps
    downstream arrival seqs — and with them merge-FCFS determinism and the
    provenance stories — bit-identical to :class:`InlineExecutor`.

    Thread-compatibility contract for plugin code: tasks in one wave may run
    on different threads, so user fns should not share unguarded mutable
    state across *tasks* (state inside one task is safe — a task is never in
    two waves at once). Registry, memo cache, store, and policies are all
    lock-protected.
    """

    def __init__(self, max_workers: int = 8) -> None:
        super().__init__()
        if max_workers < 1:
            raise ValueError(f"max_workers must be >= 1, got {max_workers}")
        self.max_workers = max_workers
        self._pool: Optional[ThreadPoolExecutor] = None
        self.parallel_waves = 0
        self.tasks_parallel = 0

    def _ensure_pool(self) -> ThreadPoolExecutor:
        if self._pool is None:
            self._pool = ThreadPoolExecutor(
                max_workers=self.max_workers, thread_name_prefix="koalja-wave"
            )
        return self._pool

    def run_wave(self, manager, tasks: list) -> list:
        if len(tasks) <= 1:
            # single-task waves (and pull-mode nodes) stay on the calling
            # thread: no pool hop, and context managers installed by outer
            # backends (e.g. MeshExecutor's axis rules) remain visible.
            return super().run_wave(manager, tasks)
        self.waves_run += 1
        self.parallel_waves += 1
        self.tasks_parallel += len(tasks)
        pool = self._ensure_pool()
        futures = [
            pool.submit(
                t.execute, manager.store, manager.registry, manager.cache, emit=False
            )
            for t in tasks
        ]
        # zip back in wave order — not completion order — so the caller's
        # serialized emission is deterministic.
        return [(t.name, f.result()) for t, f in zip(tasks, futures)]

    def resize(self, max_workers: int) -> None:
        """Adopt a new pool size between waves (the
        :class:`AdaptiveExecutor` seam). The old pool is drained and a new
        one is built lazily at the next multi-task wave; results are always
        zipped back in wave order, so pool size never affects merge order
        or provenance."""
        if max_workers < 1:
            raise ValueError(f"max_workers must be >= 1, got {max_workers}")
        if max_workers == self.max_workers:
            return
        self.max_workers = max_workers
        if self._pool is not None:
            self._pool.shutdown(wait=True)
            self._pool = None

    def shutdown(self) -> None:
        if self._pool is not None:
            self._pool.shutdown(wait=True)
            self._pool = None

    def __del__(self) -> None:
        # workspaces are created freely (tests, short-lived circuits); drop
        # the worker threads with the executor instead of leaking them
        try:
            if self._pool is not None:
                self._pool.shutdown(wait=False)
                self._pool = None
        except Exception:
            pass

    def stats(self) -> dict:
        out = super().stats()
        out["max_workers"] = self.max_workers
        out["parallel_waves"] = self.parallel_waves
        out["tasks_parallel"] = self.tasks_parallel
        return out

    def __repr__(self) -> str:
        return f"ConcurrentExecutor(max_workers={self.max_workers})"


class ZonedExecutor(InlineExecutor):
    """Partition each wave by extended-cloud zone (paper §IV).

    The scheduler's placement policy has already assigned every task of the
    wave a zone (on the scheduler thread, before ``run_wave``); this backend
    groups the wave by zone and runs one zone's partition at a time, in
    topology declaration order — the in-process stand-in for dispatching
    each partition to that zone's physical site. Within a partition the
    ``inner=`` backend decides serial vs thread-pool execution
    (``ZonedExecutor(inner=ConcurrentExecutor(8))`` composes, exactly like
    ``MeshExecutor``'s ``inner=``).

    Results are re-ordered back to wave order before returning, and emission
    stays with the scheduler — so arrival seqs, merge-FCFS snapshots, and
    the provenance stories are bit-identical to Inline/Concurrent backends.
    Per-zone wave/task counts surface in ``Workspace.stats()["topology"]
    ["executor_zones"]``.
    """

    def __init__(self, topology=None, *, inner: Optional[InlineExecutor] = None) -> None:
        super().__init__()
        self.topology = topology
        self.inner = inner
        self.zone_waves: dict = {}  # zone -> {"waves": n, "tasks": n}

    def _inner_run(self, manager, tasks: list) -> list:
        if self.inner is not None:
            return self.inner.run_wave(manager, tasks)
        return [
            (t.name, t.execute(manager.store, manager.registry, manager.cache, emit=False))
            for t in tasks
        ]

    def run_wave(self, manager, tasks: list) -> list:
        # one scheduler wave = one waves_run tick, however many zone
        # partitions it splits into (those are counted in zone_waves)
        self.waves_run += 1
        topo = self.topology or getattr(manager, "topology", None)
        if topo is None:
            return self._inner_run(manager, tasks)
        groups: dict = {}
        for t in tasks:
            groups.setdefault(t.zone or topo.default_zone, []).append(t)
        order = {z: i for i, z in enumerate(topo.zone_names())}
        results: dict = {}
        for zone in sorted(groups, key=lambda z: (order.get(z, len(order)), z)):
            part = groups[zone]
            zw = self.zone_waves.setdefault(zone, {"waves": 0, "tasks": 0})
            zw["waves"] += 1
            zw["tasks"] += len(part)
            for name, out_avs in self._inner_run(manager, part):
                results[name] = out_avs
        # back to wave order: the scheduler zips results against the wave
        # and emits serially, so partition order must not leak downstream
        return [(t.name, results[t.name]) for t in tasks]

    def stats(self) -> dict:
        out = super().stats()
        out["zones"] = {z: dict(v) for z, v in sorted(self.zone_waves.items())}
        if self.inner is not None:
            out["inner"] = self.inner.stats()
        return out

    def __repr__(self) -> str:
        inner = f"inner={self.inner!r}" if self.inner is not None else "inner=serial"
        return f"ZonedExecutor({inner})"


class AdaptiveExecutor(InlineExecutor):
    """Feedback-driven autoscaler around a pool-bearing backend.

    Between waves — never inside one — the wrapper reads the scheduler's
    :class:`~repro_torch.core.scheduler.LoadSignals` and resizes the ``inner``
    pool (thread or process) toward the p95 wave width, clamped to
    ``[min_workers, max_workers]``:

      - **scale up** immediately when the signals want a bigger pool (a
        burst is presenting work right now);
      - **scale down** only after ``scale_down_patience`` consecutive waves
        wanted a smaller one (hysteresis: troughs must prove themselves
        before workers are released).

    Pool size never affects merge order or provenance — the scheduler
    serializes emission in wave order regardless — so the decision sequence
    is free to act on live signals. Wave widths are a pure function of the
    push schedule, hence so are the decisions: the same run produces the
    same resize sequence under every backend. Every resize is journaled as
    a typed ``scale`` record, and ``Workspace.from_journal`` replays the
    decision history (``ReplayedJournal.scales``).
    """

    def __init__(
        self,
        inner: Optional[InlineExecutor] = None,
        *,
        min_workers: int = 1,
        max_workers: int = 8,
        scale_down_patience: int = 3,
    ) -> None:
        super().__init__()
        if min_workers < 1:
            raise ValueError(f"min_workers must be >= 1, got {min_workers}")
        if max_workers < min_workers:
            raise ValueError(
                f"max_workers ({max_workers}) must be >= min_workers ({min_workers})"
            )
        if scale_down_patience < 1:
            raise ValueError(
                f"scale_down_patience must be >= 1, got {scale_down_patience}"
            )
        if inner is None:
            inner = ConcurrentExecutor(max_workers=min_workers)
        if not callable(getattr(inner, "resize", None)):
            raise TypeError(
                f"AdaptiveExecutor needs a pool-bearing inner executor with a "
                f"resize(n) method (ConcurrentExecutor or ProcessExecutor), "
                f"got {inner!r}"
            )
        self.inner = inner
        self.min_workers = min_workers
        self.max_workers = max_workers
        self.scale_down_patience = scale_down_patience
        self._calm = 0  # consecutive waves that wanted a smaller pool
        self.resizes = 0
        self.scale_ups = 0
        self.scale_downs = 0
        self.scale_history: list = []  # journaled scale events, in order
        start = min(max(inner.max_workers, min_workers), max_workers)
        if start != inner.max_workers:
            inner.resize(start)

    @property
    def current_workers(self) -> int:
        return self.inner.max_workers

    def run_wave(self, manager, tasks: list) -> list:
        self._maybe_resize(manager, len(tasks))
        self.waves_run += 1
        return self.inner.run_wave(manager, tasks)

    def _maybe_resize(self, manager, wave_width: int) -> None:
        sched = getattr(manager, "scheduler", None)
        load = getattr(sched, "load", None)
        if load is None:
            return
        current = self.inner.max_workers
        # signals include the wave about to run (observe_wave precedes
        # run_wave); take the larger of p95 and this wave's width so a
        # burst wider than recent history is served, not queued
        target = max(int(load.recommended_workers), int(wave_width))
        target = max(self.min_workers, min(self.max_workers, target))
        if target > current:
            self._calm = 0
            self._apply(manager, load, current, target, "up")
        elif target < current:
            self._calm += 1
            if self._calm >= self.scale_down_patience:
                self._calm = 0
                self._apply(manager, load, current, target, "down")
        else:
            self._calm = 0

    def _apply(self, manager, load, current: int, target: int, direction: str) -> None:
        self.inner.resize(target)
        self.resizes += 1
        if direction == "up":
            self.scale_ups += 1
        else:
            self.scale_downs += 1
        event = {
            "executor": type(self.inner).__name__,
            "wave": self.waves_run,
            "from": current,
            "to": target,
            "direction": direction,
            "width_p95": int(load.wave_width_p95),
            "queue_high_water": int(load.queue_depth_high_water),
        }
        self.scale_history.append(event)
        journal = getattr(manager, "journal", None)
        if journal is not None and not getattr(journal, "closed", False):
            journal.append("scale", event)

    def shutdown(self) -> None:
        shut = getattr(self.inner, "shutdown", None)
        if shut is not None:
            shut()

    def stats(self) -> dict:
        out = super().stats()
        out["current_workers"] = self.inner.max_workers
        out["min_workers"] = self.min_workers
        out["max_workers"] = self.max_workers
        out["resizes"] = self.resizes
        out["scale_ups"] = self.scale_ups
        out["scale_downs"] = self.scale_downs
        out["last_scale"] = self.scale_history[-1] if self.scale_history else None
        out["inner"] = self.inner.stats()
        return out

    def __repr__(self) -> str:
        return (
            f"AdaptiveExecutor(inner={self.inner!r}, "
            f"band=[{self.min_workers},{self.max_workers}])"
        )


class MeshExecutor(InlineExecutor):
    """Execute the circuit against one torch device (``repro.workspace.executors``).

    The reference binds a JAX mesh and installs its axis rules around every
    engine call; the port binds one device (``repro_torch.launch.mesh
    .make_host_mesh``) and makes it the current CUDA device around every
    engine call, so task code that allocates on "cuda" lands on it. Model-step
    tasks get their implementations from the dist layer (``train_step`` /
    ``serve_fns``). The circuit, its provenance and the trigger modes are
    untouched. Wave execution is serial (inherited), or, with
    ``inner=ConcurrentExecutor(...)``, fanned across threads; multi-task
    waves then run on pool threads outside the device context. Logical-axis
    rules and meshes of several devices wait for sharding (ROADMAP.md queue
    1, item 6)."""

    def __init__(
        self,
        mesh=None,
        *,
        rules: Optional[dict] = None,
        cfg=None,
        mode: str = "train",
        global_batch: Optional[int] = None,
        inner: Optional[InlineExecutor] = None,
    ) -> None:
        super().__init__()
        from repro_torch.launch.mesh import make_host_mesh

        if rules is not None:
            raise NotImplementedError("logical-axis rules need sharding (ROADMAP queue 1 item 6: distribution)")
        # cfg, as in the reference, would derive the sharding rules (item 6)
        self.mesh = make_host_mesh() if mesh is None else make_host_mesh(device=mesh)
        self.mode = mode
        self.global_batch = global_batch
        self.inner = inner

    def _ctx(self):
        import contextlib

        import torch

        return torch.cuda.device(self.mesh) if self.mesh.type == "cuda" else contextlib.nullcontext()

    def push(self, manager, task: str, payloads: dict, region: str) -> dict:
        with self._ctx():
            return super().push(manager, task, payloads, region)

    def pull(self, manager, target: str) -> dict:
        with self._ctx():
            return super().pull(manager, target)

    def sample(self, manager, source: str) -> dict:
        with self._ctx():
            return super().sample(manager, source)

    def run_wave(self, manager, tasks: list) -> list:
        if self.inner is not None:
            return self.inner.run_wave(manager, tasks)
        return super().run_wave(manager, tasks)

    # -- dist-layer step builders (model tasks) -----------------------------
    def train_step(self, model, schedule, **kwargs):
        """``train_step(state, batch) -> (state, metrics)`` on this
        executor's device (``repro_torch.dist.step.make_train_step``)."""
        from repro_torch.dist.step import make_train_step

        kwargs.setdefault("global_batch", self.global_batch)
        return make_train_step(model, self.mesh, schedule, **kwargs)

    def serve_fns(self, model, **kwargs):
        """(prefill_fn, decode_fn) on this executor's device."""
        from repro_torch.dist.step import make_serve_fns

        kwargs.setdefault("global_batch", self.global_batch)
        return make_serve_fns(model, self.mesh, **kwargs)

    def stats(self) -> dict:
        out = super().stats()
        out["mesh"] = {"device": str(self.mesh)}
        out["mode"] = self.mode
        if self.inner is not None:
            out["inner"] = self.inner.stats()
        return out

    def __repr__(self) -> str:
        inner = f", inner={self.inner!r}" if self.inner is not None else ""
        return f"MeshExecutor(device={str(self.mesh)!r}, mode={self.mode!r}{inner})"


EXECUTOR_CHOICES = (
    "inline",
    "concurrent",
    "zoned",
    "zoned-concurrent",
    "process",
    "zoned-process",
    "adaptive",
    "zoned-adaptive",
)


def _env_max_workers() -> int:
    raw = os.environ.get("KOALJA_MAX_WORKERS", "8").strip()
    try:
        workers = int(raw)
    except ValueError:
        raise ValueError(
            f"KOALJA_MAX_WORKERS={raw!r} is not an integer (pool size, >= 1)"
        ) from None
    if workers < 1:
        raise ValueError(f"KOALJA_MAX_WORKERS={workers} must be >= 1")
    return workers


def default_executor() -> InlineExecutor:
    """Backend selected by the ``KOALJA_EXECUTOR`` env var (one of
    ``inline | concurrent | zoned | zoned-concurrent | process |
    zoned-process | adaptive | zoned-adaptive``); ``KOALJA_MAX_WORKERS``
    sizes thread and process pools (for adaptive backends it is the upper
    bound of the autoscaling band). Lets CI smoke every execution substrate
    across the whole suite without code changes."""
    name = os.environ.get("KOALJA_EXECUTOR", "inline").strip().lower()
    if name in ("concurrent", "threads", "threadpool"):
        return ConcurrentExecutor(max_workers=_env_max_workers())
    if name in ("zoned",):
        return ZonedExecutor()
    if name in ("zoned-concurrent", "zoned_concurrent"):
        return ZonedExecutor(inner=ConcurrentExecutor(max_workers=_env_max_workers()))
    if name in ("process", "process-pool", "process_pool"):
        from repro_torch.runtime import ProcessExecutor

        return ProcessExecutor(max_workers=_env_max_workers())
    if name in ("zoned-process", "zoned_process"):
        from repro_torch.runtime import ZonedProcessExecutor

        return ZonedProcessExecutor(max_workers=_env_max_workers())
    if name in ("adaptive",):
        return AdaptiveExecutor(max_workers=_env_max_workers())
    if name in ("zoned-adaptive", "zoned_adaptive"):
        return ZonedExecutor(inner=AdaptiveExecutor(max_workers=_env_max_workers()))
    if name in ("", "inline"):
        return InlineExecutor()
    raise ValueError(
        f"KOALJA_EXECUTOR={name!r} is not a known backend "
        f"(choose from {' | '.join(EXECUTOR_CHOICES)})"
    )

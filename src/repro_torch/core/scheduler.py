"""Event-driven ready-queue scheduler (paper §III.J, Principle 1).

The original engine was a polling loop: ``propagate()`` rescanned *every* task in
the circuit every round until quiescence — O(rounds × tasks) work even when a
single event touched two tasks. Smart Links already carry a notification side
channel precisely so consumers stop polling; this module makes that channel
drive computation:

  - ``SmartLink.offer()`` notifies the scheduler, which enqueues exactly the
    consumer whose :class:`~repro_torch.core.policy.SnapshotPolicy` may have become
    ready (a *dirty* mark, deduplicated).
  - ``drain()`` turns the dirty queue into **waves**: the set of tasks that
    are simultaneously ready. Each wave is handed to the executor through the
    ``run_wave(manager, tasks)`` seam — serially for
    :class:`~repro_torch.workspace.executors.InlineExecutor`, concurrently for
    :class:`~repro_torch.workspace.executors.ConcurrentExecutor`.
  - User code runs with emission *deferred* (``execute(emit=False)``); the
    scheduler then emits serially in wave order, so downstream arrival seqs —
    and therefore merge-FCFS snapshots — are bit-identical no matter which
    worker thread finished first.
  - Cycle control moves from global ``max_rounds`` to a **per-task fire
    budget** per drain: a cyclic circuit rate-limits only the tasks actually
    spinning, without capping unrelated work.

Suppressed notifications (``notify_threshold_s`` — arrivals faster than the
threshold coalesce, §III.J's poll-mode fast path) are caught by a *sweep*: at
quiescence the scheduler batch-polls only the links that still hold AVs, so
correctness never depends on per-event interrupts.

Make-mode ``pull()`` runs on the same machinery: an iterative postorder walk
of the target's dependency cone (back-edges skipped — the old recursion's
cycle guard) where each node executes through the same wave seam.

The scheduler's stats are the §III.F sustainability counters for *trigger*
work: ``tasks_enqueued`` (what the event engine touched) vs
``polling_scan_equivalent`` (what the original engine's full-graph scan would have
touched) quantifies the polling work avoided.
"""

from __future__ import annotations

import threading
from collections import deque
from typing import TYPE_CHECKING, Optional

from .task import FiringBatch

if TYPE_CHECKING:  # pragma: no cover
    from .pipeline import PipelineManager
    from .task import SmartTask


class LoadSignals:
    """Feedback snapshot for the adaptive runtime, recomputed at wave
    boundaries by the scheduler that owns it.

    Three signals, each chosen because a knob can act on it between waves
    without touching merge order or provenance:

      - **windowed wave-width percentiles** — how much simultaneous work the
        circuit is actually presenting (p95 is what an adaptive pool sizes
        itself to; pure function of the push schedule, so identical across
        executor backends);
      - **queue-depth high-water per drain** — burst pressure the current
        drain built up before waves caught up;
      - **per-task service-time EWMAs** — wall seconds per execution
        (observability only: wall clocks vary run to run, so no
        deterministic decision may depend on them).

    Surfaced under ``stats()["scheduler"]["load"]`` and read by
    :class:`~repro_torch.workspace.executors.AdaptiveExecutor`.
    """

    #: EWMA smoothing for per-task service seconds
    ALPHA = 0.3

    def __init__(self, window: int = 64) -> None:
        self.window = window
        self._widths: deque = deque(maxlen=window)
        self.waves_observed = 0
        self.current_wave_width = 0
        self.wave_width_p50 = 0
        self.wave_width_p95 = 0
        self.queue_depth_high_water = 0  # per-drain (current/last drain)
        self.service_ewma_s: dict = {}  # task name -> EWMA wall seconds

    @staticmethod
    def _percentile(ordered: list, q: float) -> int:
        # nearest-rank on the sorted window: deterministic, no interpolation
        idx = max(0, min(len(ordered) - 1, int(q * len(ordered) + 0.999999) - 1))
        return ordered[idx]

    def observe_wave(self, width: int) -> None:
        """Record a formed wave's width and refresh the width percentiles
        (called on the scheduler thread *before* run_wave, so an adaptive
        executor sees signals that include the wave it is about to run)."""
        self.waves_observed += 1
        self.current_wave_width = width
        self._widths.append(width)
        ordered = sorted(self._widths)
        self.wave_width_p50 = self._percentile(ordered, 0.50)
        self.wave_width_p95 = self._percentile(ordered, 0.95)

    def observe_services(self, tasks: list) -> None:
        """Fold the wave's tasks' per-execution EWMAs into the snapshot
        (tasks update their own EWMA as executions finish)."""
        for t in tasks:
            ewma = getattr(t, "service_ewma_s", None)
            if ewma is not None:
                self.service_ewma_s[t.name] = ewma

    @property
    def recommended_workers(self) -> int:
        """Pool size the signals suggest: the p95 wave width (at least 1).
        Deterministic for a given push schedule — the adaptive executor
        clamps it to its own [min, max] band."""
        return max(1, int(self.wave_width_p95))

    def snapshot(self) -> dict:
        ewmas = dict(sorted(self.service_ewma_s.items()))
        return {
            "waves_observed": self.waves_observed,
            "wave_width_window": len(self._widths),
            "current_wave_width": self.current_wave_width,
            "wave_width_p50": self.wave_width_p50,
            "wave_width_p95": self.wave_width_p95,
            "queue_depth_high_water_last_drain": self.queue_depth_high_water,
            "recommended_workers": self.recommended_workers,
            "service_ewma_s": ewmas,
            "service_ewma_max_s": max(ewmas.values()) if ewmas else None,
        }


class SerialWaveRunner:
    """Default wave backend: run a wave's tasks one after another on the
    calling thread (the engine-level analogue of ``InlineExecutor``; used
    when a ``PipelineManager`` is driven without a Workspace executor)."""

    def run_wave(self, manager: "PipelineManager", tasks: list) -> list:
        return [
            (t.name, t.execute(manager.store, manager.registry, manager.cache, emit=False))
            for t in tasks
        ]

    def __repr__(self) -> str:
        return "SerialWaveRunner()"


class Scheduler:
    """Notification-driven ready queue over one pipeline.

    Owned by :class:`~repro_torch.core.pipeline.PipelineManager`; subscribes to
    every link's notification channel and is marked dirty directly by
    ``_inject`` (edge arrivals have no link to notify on).
    """

    def __init__(self, manager: "PipelineManager", fire_budget: int = 100) -> None:
        self.manager = manager
        self.fire_budget = fire_budget
        # dict-as-ordered-set: insertion order is wave order (determinism)
        self._dirty: dict = {}
        self._lock = threading.Lock()
        self._subscribed: set = set()
        # tasks dropped by the fire budget resume on the next drain (the
        # original engine's "call propagate() again to keep a cycle going" semantics)
        self._throttled: set = set()
        # -- stats (trigger-work sustainability counters) ------------------
        self.waves = 0
        # widest wave formed: the parallelism a pooled backend (thread or
        # process, repro.runtime) could extract from this circuit — width 1
        # everywhere means a pool buys nothing
        self.max_wave_width = 0
        self.tasks_enqueued = 0
        self.tasks_executed = 0
        self.notifications_received = 0
        self.queue_depth_high_water = 0
        self.polling_scan_equivalent = 0
        self.budget_exhausted = 0
        self.sweeps = 0
        self.pulls = 0
        # adaptive-runtime feedback snapshot (wave widths, queue pressure,
        # service EWMAs), recomputed at wave boundaries in drain()
        self.load = LoadSignals()
        self._drain_depth_high = 0  # queue high-water within current drain
        self._subscribe_links()

    # ------------------------------------------------------------------
    # notification intake
    # ------------------------------------------------------------------

    def _subscribe_links(self) -> None:
        """Idempotently subscribe to every link (links wired after manager
        construction — legacy direct-engine use — are picked up on the next
        drain)."""
        for link in self.manager.pipeline.links:
            if id(link) not in self._subscribed:
                self._subscribed.add(id(link))
                link.subscribe(self._on_notify)
                # overflow drops on this link log a 'dropped' visit (and
                # journal record) instead of silently vanishing
                link.bind_provenance(self.manager.registry)

    def _on_notify(self, link, av) -> None:
        with self._lock:
            self.notifications_received += 1
        self.mark_dirty(link.dst_task)

    def mark_dirty(self, task_name: str, external: bool = True) -> None:
        """Enqueue a task whose policy may have become ready (deduplicated).

        ``external=False`` marks a *self-requeue*: the task is still ready
        from data already in its policy buffers (no new arrival). Requeues
        drain pre-buffered work and are exempt from the fire budget — only
        arrival-driven fires (the ones a cycle feeds on) are budgeted,
        matching the original engine's unbounded ``while ready()`` inner loop on
        acyclic circuits.
        """
        with self._lock:
            entry = self._dirty.get(task_name)
            if entry is None:
                self._dirty[task_name] = external
                self.tasks_enqueued += 1
                depth = len(self._dirty)
                if depth > self.queue_depth_high_water:
                    self.queue_depth_high_water = depth
                if depth > self._drain_depth_high:
                    self._drain_depth_high = depth
            elif external and not entry:
                self._dirty[task_name] = True

    # ------------------------------------------------------------------
    # reactive mode: waves until quiescence
    # ------------------------------------------------------------------

    def _runner(self):
        return self.manager.executor

    def drain(self) -> dict:
        """Process the ready queue to quiescence. Returns the fired map
        (task -> [out_avs per firing], in firing order) — the contract of
        the old polling ``propagate()``."""
        self._subscribe_links()
        mgr = self.manager
        tasks = mgr.pipeline.tasks
        n_tasks = len(tasks)
        fired: dict = {}
        budgets: dict = {}
        with self._lock:
            self._drain_depth_high = len(self._dirty)
        throttled, self._throttled = self._throttled, set()
        for name in throttled:  # fresh budget, pick up where the cap hit
            self.mark_dirty(name)
        while True:
            wave = self._form_wave(tasks, budgets)
            if not wave:
                # poll-mode fast path: arrivals whose notifications were
                # suppressed (notify_threshold_s) still sit on links; one
                # batch sweep coalesces them. ingest() empties the link
                # queues, so this converges.
                if self._sweep():
                    continue
                break
            self.waves += 1
            if len(wave) > self.max_wave_width:
                self.max_wave_width = len(wave)
            # wave boundary: refresh the load signals an AdaptiveExecutor
            # will read inside the run_wave call below
            self.load.observe_wave(len(wave))
            with self._lock:
                self.load.queue_depth_high_water = self._drain_depth_high
            # A polling engine would have scanned every task this round.
            self.polling_scan_equivalent += n_tasks
            # Extended-cloud placement happens here, on the scheduler thread,
            # with the wave's snapshots already ingested: a data-gravity
            # policy sees the exact pending input bytes per zone, and the
            # assignment is deterministic across executor backends.
            if mgr.placement is not None:
                mgr.placement.place_wave(mgr, wave)
            results = self._runner().run_wave(mgr, wave)
            self.tasks_executed += len(results)
            self.load.observe_services(wave)
            # Emission is serialized in wave order: downstream arrival seqs
            # (merge FCFS) are identical across Inline/Concurrent backends.
            # A coalescing task returns a FiringBatch; each firing emits in
            # its original order, so seqs match the uncoalesced schedule.
            for task, (name, out) in zip(wave, results):
                firings = out if isinstance(out, FiringBatch) else [out]
                for out_avs in firings:
                    self._relieve_backpressure(task, tasks)
                    task._emit(out_avs)
                    fired.setdefault(name, []).append(out_avs)
            # A task may still be ready from already-buffered data (no new
            # notification will come for it) — requeue it. external=False:
            # draining one's own buffers is not arrival-driven work, so it
            # is exempt from the cycle fire budget (original semantics).
            for task in wave:
                if task.policy.ready():
                    self.mark_dirty(task.name, external=False)
        # the polling engine needed one extra full scan to detect quiescence
        self.polling_scan_equivalent += n_tasks
        return fired

    def _form_wave(self, tasks: dict, budgets: dict) -> list:
        with self._lock:
            dirty = list(self._dirty.items())
            self._dirty.clear()
        candidates, charged = [], {}
        for name, external in dirty:
            t = tasks.get(name)
            if t is None:
                continue
            t.ingest()  # drain links into the policy (always, for sweep convergence)
            if external and budgets.get(name, 0) >= self.fire_budget:
                # arrival-driven refire over budget: a cycle spinning. Drop
                # it for this drain; it resumes (fresh budget) next drain.
                self.budget_exhausted += 1
                self._throttled.add(name)
                continue
            if t.ready():
                candidates.append(t)
                charged[name] = external
        # Glitch avoidance: a task whose direct producer is also ready in
        # this wave would fire on a stale/partial snapshot (e.g. the short
        # leg of a diamond under swap_new_for_old). Defer it one wave so it
        # sees the producer's fresh output — unless deferral would empty the
        # wave entirely (a cycle of mutually-ready tasks), where everyone
        # runs and the fire budget bounds the spin.
        names = {t.name for t in candidates}
        wave, deferred = [], []
        for t in candidates:
            upstream_firing = any(
                l.src_task in names and l.src_task != t.name
                for l in t.in_links.values()
            )
            (deferred if upstream_firing else wave).append(t)
        if not wave:
            wave, deferred = candidates, []
        for t in deferred:
            # revisit right after this wave emits, keeping the arrival flag
            self.mark_dirty(t.name, external=charged[t.name])
        for t in wave:
            if charged[t.name]:  # only arrival-driven fires count (cycles)
                budgets[t.name] = budgets.get(t.name, 0) + 1
        return wave

    def _relieve_backpressure(self, task: "SmartTask", tasks: dict) -> None:
        """In-engine relief valve for ``overflow='block'`` links: the drain
        thread is both producer and (via ingest) consumer, so blocking on a
        full link would only stall the engine until the timeout and then
        fail. Before emitting, drain any full block-policy out-link into its
        consumer's policy buffer and queue the consumer — no loss, no
        stall. True blocking applies to producers on *other* threads (e.g.
        a sensor thread offering into the circuit)."""
        for links in task.out_links.values():
            for link in links:
                if (
                    link.capacity is not None
                    and link.overflow == "block"
                    and link.peek_count() >= link.capacity
                ):
                    dst = tasks.get(link.dst_task)
                    if dst is not None:
                        dst.ingest()
                        self.mark_dirty(dst.name, external=False)

    def _sweep(self) -> bool:
        """Batch-poll links that still hold AVs (suppressed notifications);
        returns True if any consumer was enqueued."""
        found = False
        for link in self.manager.pipeline.links:
            if link.peek_count() > 0:
                self.mark_dirty(link.dst_task)
                found = True
        if found:
            self.sweeps += 1
        return found

    # ------------------------------------------------------------------
    # make mode: dependency-cone pull
    # ------------------------------------------------------------------

    def pull(self, target: str) -> dict:
        """Resolve one task's outputs, rebuilding dependencies backwards.

        Iterative postorder over the dependency cone (the old recursion,
        without re-entry); back-edges are skipped, which is exactly the
        recursive cycle guard's "reuse last outputs" behaviour. Each node
        executes through the wave seam, so pull-mode work runs under the
        same executor as reactive waves.
        """
        self.pulls += 1
        tasks = self.manager.pipeline.tasks
        if target not in tasks:
            raise KeyError(f"no task {target!r} in pipeline")
        order = self._dependency_postorder(tasks, target)
        results: dict = {}
        for name in order:
            t = tasks[name]
            t.ingest()
            if t.ready() or (t.source and not t.input_specs):
                results[name] = self._execute_one(t)
            elif t.last_outputs:
                results[name] = dict(t.last_outputs)
            else:
                raise RuntimeError(
                    f"pull({name}): dependencies produced no data and no prior "
                    f"outputs exist (pending={t.policy.stats()['pending']})"
                )
        return results[target]

    @staticmethod
    def _dependency_postorder(tasks: dict, target: str) -> list:
        order: list = []
        state: dict = {target: "visiting"}
        deps = lambda n: [l.src_task for l in tasks[n].in_links.values()]  # noqa: E731
        stack = [(target, iter(deps(target)))]
        while stack:
            name, it = stack[-1]
            child = next((d for d in it if state.get(d) is None), None)
            if child is not None:
                state[child] = "visiting"
                stack.append((child, iter(deps(child))))
            else:
                state[name] = "done"
                order.append(name)
                stack.pop()
        return order

    def _execute_one(self, task: "SmartTask") -> dict:
        if self.manager.placement is not None:
            self.manager.placement.place_wave(self.manager, [task])
        self.load.observe_wave(1)
        [(_, out)] = self._runner().run_wave(self.manager, [task])
        self.load.observe_services([task])
        firings = out if isinstance(out, FiringBatch) else [out]
        for out_avs in firings:
            self._relieve_backpressure(task, self.manager.pipeline.tasks)
            task._emit(out_avs)
        self.tasks_executed += 1
        return firings[-1] if firings else {}

    # ------------------------------------------------------------------

    def stats(self) -> dict:
        with self._lock:
            depth = len(self._dirty)
        enq = self.tasks_enqueued
        scan = self.polling_scan_equivalent
        return {
            "backend": type(self._runner()).__name__,
            "waves": self.waves,
            "max_wave_width": self.max_wave_width,
            "tasks_enqueued": enq,
            "tasks_executed": self.tasks_executed,
            "notifications_received": self.notifications_received,
            "queue_depth": depth,
            "queue_depth_high_water": self.queue_depth_high_water,
            # the §III.F-style avoided-work counter: what the original engine's
            # full-graph polling loop would have scanned for the same runs
            "polling_scan_equivalent": scan,
            "scan_reduction_x": scan / enq if enq else None,
            "budget_exhausted": self.budget_exhausted,
            "sweeps": self.sweeps,
            "pulls": self.pulls,
            "fire_budget": self.fire_budget,
            "load": self.load.snapshot(),
        }

    def __repr__(self) -> str:
        return (
            f"Scheduler(waves={self.waves}, enqueued={self.tasks_enqueued}, "
            f"backend={type(self._runner()).__name__})"
        )

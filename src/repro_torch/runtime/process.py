"""ProcessExecutor — scheduler waves on a pool of forked worker processes.

The multi-process sibling of
:class:`~repro_torch.workspace.executors.ConcurrentExecutor`: same ``run_wave``
seam, same single-task-wave inline shortcut, but the wave's user code runs
on *processes*, so CPU-bound plugin code actually parallelizes instead of
serializing on the GIL (benchmark B12 measures exactly this).

Determinism comes from a strict phase split, all in wave order on the
calling thread:

  1. ``begin_execution`` for every task (arrival visits, memo lookups —
     cache hits never leave the parent);
  2. ``publish`` each remote plan's inputs to the shared object tier
     (reference handover: a worker resolves payloads by content hash);
  3. dispatch the plans round-robin over the pool and collect replies;
  4. ``finish_remote`` per task, in wave order — every AV mint, visitor
     entry, ledger charge, and memo insert happens *here*, in the parent.

Because step 4 is the only provenance-producing step and it runs after a
worker's outcome is fully in hand, a worker crash mid-task leaves nothing
to roll back: the parent journals a ``worker_died`` anomaly, respawns the
slot, and retries the task on a fresh worker (bounded by ``retry_budget``),
finally degrading to an inline run — no lost and no duplicated AVs, and
the determinism fingerprint matches a crash-free run.

Port of ``repro.runtime.process``. A plan with a card tensor among its
inputs never leaves the parent: it runs there, on the card, and counts in
``tasks_inline``, as ghost and dedup plans do. Host plans go to workers.
"""

from __future__ import annotations

from repro_torch.workspace.executors import InlineExecutor

from .worker import WorkerProcess, fork_context

# exception set that means "the worker at the far end is gone"
_DEAD = (BrokenPipeError, ConnectionResetError, EOFError, OSError)


def _plan_all_real(plan) -> bool:
    """Remote-eligibility: plans with ghost inputs stay inline — a ghost run
    moves zero bytes by design, so a process hop buys nothing and the spec
    objects (which may not pickle) never need to cross the pipe. Plans
    carrying a dedup closure stay inline too: the replay is a store read
    plus parent-side provenance, and the closure itself never pickles."""
    if getattr(plan, "dedup", None) is not None:
        return False
    for val in plan.snap.values():
        for av in val if isinstance(val, list) else [val]:
            if av.uri.startswith("ghost://"):
                return False
    return True


def _plan_on_card(store, plan) -> bool:
    """True when an input of ``plan`` holds a tensor on a card. Such plans
    run in the parent: a forked worker cannot touch CUDA, and moving the
    payload to the host to compute it there would hide the card."""
    for val in plan.snap.values():
        for av in val if isinstance(val, list) else [val]:
            if store.on_card(av.chash):
                return True
    return False


def _remote_eligible(store, plan) -> bool:
    return _plan_all_real(plan) and not _plan_on_card(store, plan)


def _publish_inputs(store, plan) -> None:
    for val in plan.snap.values():
        for av in val if isinstance(val, list) else [val]:
            if av.uri.startswith("ghost://"):
                continue
            try:
                store.publish(av.chash)
            except KeyError:
                # resident in neither tier — the worker's own resolution
                # will raise the same KeyError the inline path would have
                pass


class ProcessExecutor(InlineExecutor):
    """Execute multi-task waves across a persistent forked worker pool.

    ``KOALJA_EXECUTOR=process`` selects this backend;
    ``KOALJA_MAX_WORKERS`` sizes the pool. Workers fork lazily at the first
    multi-task wave (single-task waves and pull-mode nodes stay on the
    calling thread, like ConcurrentExecutor), against the manager they will
    serve — the fork snapshot carries the task registry and the store
    handle; per-request state arrives as references over the pipe.
    """

    def __init__(self, max_workers: int = 8, retry_budget: int = 2) -> None:
        super().__init__()
        if max_workers < 1:
            raise ValueError(f"max_workers must be >= 1, got {max_workers}")
        self.max_workers = int(max_workers)
        self.retry_budget = max(0, int(retry_budget))
        self._workers: list = [None] * self.max_workers  # slot -> WorkerProcess
        self._manager = None
        self.parallel_waves = 0
        self.tasks_remote = 0
        self.tasks_inline = 0
        self.worker_restarts = 0
        self.retries = 0
        self.inline_fallbacks = 0
        self._retired_bytes_sent = 0
        self._retired_bytes_received = 0

    # -- pool management -----------------------------------------------------
    def _prepare(self, manager) -> None:
        if self._manager is manager:
            return
        if self._manager is not None:
            # rebinding to a new workspace: the old forks hold the old
            # manager's registry — useless and wrong for the new circuit
            self.shutdown()
        manager.store.ensure_object_dir()
        self._manager = manager

    def _worker(self, slot: int) -> WorkerProcess:
        w = self._workers[slot]
        if w is None or not w.alive():
            if w is not None:
                self._retire(slot)
            w = WorkerProcess(self._manager, worker_id=slot)
            self._workers[slot] = w
        return w

    def _retire(self, slot: int) -> None:
        w = self._workers[slot]
        if w is None:
            return
        self._retired_bytes_sent += w.bytes_sent
        self._retired_bytes_received += w.bytes_received
        w.kill()
        self._workers[slot] = None
        self.worker_restarts += 1

    def resize(self, max_workers: int) -> None:
        """Adopt a new pool size between waves (the
        :class:`~repro_torch.workspace.executors.AdaptiveExecutor` seam). Growing
        appends empty slots — workers fork lazily when a wave first needs
        them; shrinking stops the excess workers gracefully. All provenance
        is minted parent-side in wave order, so pool size never affects
        merge order, ledgers, or the journal's forensic stories."""
        if max_workers < 1:
            raise ValueError(f"max_workers must be >= 1, got {max_workers}")
        max_workers = int(max_workers)
        if max_workers == self.max_workers:
            return
        if max_workers > self.max_workers:
            self._workers.extend([None] * (max_workers - self.max_workers))
        else:
            for slot in range(max_workers, self.max_workers):
                w = self._workers[slot]
                if w is not None:
                    self._retired_bytes_sent += w.bytes_sent
                    self._retired_bytes_received += w.bytes_received
                    w.stop()
            del self._workers[max_workers:]
        self.max_workers = max_workers

    def kill_worker(self, slot: int = 0) -> bool:
        """Chaos/test helper: SIGKILL one pool worker. The next wave (or the
        in-flight one) detects the death, journals the anomaly, and
        retries on a fresh fork."""
        w = self._workers[slot] if 0 <= slot < len(self._workers) else None
        if w is not None and w.alive():
            w.proc.kill()
            w.proc.join(timeout=5)
            return True
        return False

    def shutdown(self) -> None:
        """Stop every worker gracefully and unbind the manager."""
        for slot, w in enumerate(self._workers):
            if w is not None:
                self._retired_bytes_sent += w.bytes_sent
                self._retired_bytes_received += w.bytes_received
                w.stop()
                self._workers[slot] = None
        self._manager = None

    def __del__(self) -> None:  # daemonized forks die with us, but be tidy
        try:
            for w in self._workers:
                if w is not None:
                    w.kill()
        except Exception:
            pass

    # -- wave execution ------------------------------------------------------
    def run_wave(self, manager, tasks: list) -> list:
        if len(tasks) <= 1 or fork_context() is None:
            # single-task waves (and platforms without fork) stay inline:
            # no pipe hop, and outer context managers remain visible
            return super().run_wave(manager, tasks)
        self._prepare(manager)
        self.waves_run += 1
        self.parallel_waves += 1
        results: dict = {}
        pending: list = []
        for t in tasks:
            status, payload = t.begin_execution(
                manager.store, manager.registry, manager.cache
            )
            if status == "hit":
                results[t.name] = payload
            else:
                pending.append((t, payload))
        remote = [(t, plan) for t, plan in pending if _remote_eligible(manager.store, plan)]
        outcomes, errors = self._run_remote(manager, remote)
        if errors:
            task_name, exc, tb = errors[0]
            if exc is not None:
                raise exc
            raise RuntimeError(
                f"task {task_name!r} failed in worker process:\n{tb}"
            )
        remote_names = {t.name for t, _ in remote}
        for t, plan in pending:
            outcome = outcomes.get(t.name)
            if outcome is not None:
                results[t.name] = t.finish_remote(
                    plan, outcome, manager.store, manager.registry,
                    manager.cache, emit=False,
                )
                self.tasks_remote += 1
            else:
                # ghost-flavoured or card plan, or a casualty past its retry budget
                if t.name in remote_names:
                    self.inline_fallbacks += 1
                result, dt = t.run_user_fn(plan, manager.store)
                results[t.name] = t.finish_execution(
                    plan, result, dt, manager.store, manager.registry,
                    manager.cache, emit=False,
                )
                self.tasks_inline += 1
        return [(t.name, results[t.name]) for t in tasks]

    def _run_remote(self, manager, items: list) -> tuple:
        """Dispatch ``(task, plan)`` items across the pool; returns
        ``({task_name: outcome | None}, [(task_name, exc, traceback)])``.
        ``None`` outcomes are crash casualties past their retry budget —
        the caller runs them inline."""
        outcomes: dict = {t.name: None for t, _ in items}
        errors: list = []
        if not items:
            return outcomes, errors
        for _t, plan in items:
            _publish_inputs(manager.store, plan)
        todo = list(items)
        attempts = {t.name: 0 for t, _ in items}
        while todo:
            n = min(self.max_workers, len(todo))
            slots: list = [[] for _ in range(n)]
            for i, item in enumerate(todo):
                slots[i % n].append(item)
            retry: list = []
            workers, sent = [], []
            for s in range(n):
                w = self._worker(s)
                workers.append(w)
                ssent: list = []
                for t, plan in slots[s]:
                    try:
                        w.send(
                            {
                                "op": "exec",
                                "task": t.name,
                                "zone": t.zone,
                                "snapshot": plan.snapshot_refs(),
                            }
                        )
                        ssent.append((t, plan))
                    except _DEAD:
                        break
                sent.append(ssent)
            for s in range(n):
                w = workers[s]
                answered = 0
                for t, _plan in sent[s]:
                    try:
                        reply = w.recv()
                    except _DEAD:
                        break
                    answered += 1
                    if reply.get("ok"):
                        outcomes[t.name] = reply["result"]
                    else:
                        errors.append(
                            (t.name, reply.get("exc"), reply.get("error", ""))
                        )
                # everything sent but unanswered, plus never-sent: casualties
                casualties = sent[s][answered:] + slots[s][len(sent[s]):]
                if casualties:
                    pid = w.pid
                    self._retire(s)
                    for t, plan in casualties:
                        attempts[t.name] += 1
                        manager.registry.record_anomaly(
                            t.name,
                            f"worker_died pid={pid} slot={s} "
                            f"attempt={attempts[t.name]}",
                        )
                        if attempts[t.name] <= self.retry_budget:
                            self.retries += 1
                            retry.append((t, plan))
                        # else: outcome stays None -> inline fallback
            todo = retry
        return outcomes, errors

    # -- introspection -------------------------------------------------------
    def _pipe_bytes(self) -> tuple:
        sent, received = self._retired_bytes_sent, self._retired_bytes_received
        for w in self._workers:
            if w is not None:
                sent += w.bytes_sent
                received += w.bytes_received
        return sent, received

    def stats(self) -> dict:
        out = super().stats()
        sent, received = self._pipe_bytes()
        out.update(
            {
                "max_workers": self.max_workers,
                "retry_budget": self.retry_budget,
                "parallel_waves": self.parallel_waves,
                "tasks_remote": self.tasks_remote,
                "tasks_inline": self.tasks_inline,
                "workers_alive": sum(
                    1 for w in self._workers if w is not None and w.alive()
                ),
                "worker_restarts": self.worker_restarts,
                "retries": self.retries,
                "inline_fallbacks": self.inline_fallbacks,
                "control_bytes_sent": sent,
                "control_bytes_received": received,
                # payloads cross via the shared object tier, never the pipe
                # — the refs-only contract benchmark B12 verifies
                "payload_bytes_over_pipe": 0,
            }
        )
        return out

    def __repr__(self) -> str:
        return (
            f"ProcessExecutor(max_workers={self.max_workers}, "
            f"retry_budget={self.retry_budget})"
        )

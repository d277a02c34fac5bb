"""repro_torch.runtime — multi-process worker pools and remote zone runners.

Everything below the :class:`~repro_torch.workspace.executors.Executor` seam so far
ran in one OS process; this package breaks that boundary while keeping the
engine's determinism contract intact:

  - :class:`ProcessExecutor` drives each multi-task wave on a persistent pool
    of **forked worker processes**. Workers inherit the task registry and a
    handle to the shared object-store tier at fork time; after that, only
    ``(uri, chash)`` references plus AV metadata ever cross the pipe —
    payload bytes move exclusively through the store's object directory
    (``publish`` on the parent side, ``export``/``adopt`` on the way back).
    All provenance side effects (AV minting, visitor logs, ledger charges,
    memo inserts) stay in the parent via ``SmartTask.finish_remote``, so a
    worker that dies mid-task leaves no state to undo and the wave retries
    on a fresh worker (``worker_died`` anomaly, bounded budget, inline
    fallback when the budget is spent).

  - :class:`ZonedProcessExecutor` promotes each extended-cloud
    :class:`~repro_torch.topology.Topology` zone to its own :class:`ZoneRunner`
    process: the zone's partition (tasks, pins, internal/boundary links —
    :func:`~repro_torch.topology.extract_partitions`) is journaled as a
    ``partition`` record, and every remote firing carries a **reserved
    window** of global journal seqs, visitor-log seqs, and AV uid numbers.
    The runner mints its zone's AVs and visit entries inside that window,
    appends them to its own journal *segment* file, and streams the typed
    records back; the parent restores them verbatim. A deterministic merge
    (:func:`repro_torch.provenance.replay_segments`, ordered by the global seq
    protocol) rebuilds a single registry identical to the in-process run.

Fork is the required start method (task functions are arbitrary closures —
not picklable); on platforms without it both executors degrade to inline
execution. Determinism fingerprints — merge-FCFS arrival order, lineage,
visitor logs, transfer-ledger byte/energy totals — are bit-identical across
Inline, Concurrent, Zoned, Process, and ZonedProcess backends; see
docs/runtime.md for the runnable walkthrough.
"""

from .process import ProcessExecutor
from .worker import WorkerProcess, fork_context
from .zoned import ZonedProcessExecutor, ZoneRunner

__all__ = [
    "ProcessExecutor",
    "ZonedProcessExecutor",
    "ZoneRunner",
    "WorkerProcess",
    "fork_context",
]

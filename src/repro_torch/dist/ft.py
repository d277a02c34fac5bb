"""Fault tolerance: heartbeats, straggler/dead-host detection, replay.

Port of ``repro.dist.ft``: pure Python, copied so that the port imports
nothing of the JAX package.

The Koalja make-mode posture applied to training: a failure is not an
emergency, it is a missing build artifact. ``run_with_recovery`` restores
the latest checkpoint AV and replays — the provenance registry already
names exactly which data batches the restored state had consumed.

Straggler detection uses a robust z-score (median / MAD with a relative
floor) over per-host mean step durations, so one slow host cannot inflate
the scale estimate that is supposed to expose it.
"""

from __future__ import annotations

import statistics
import time
from typing import Callable, Optional


class SimulatedFailure(RuntimeError):
    """Injected host failure (tests / chaos drills)."""

    def __init__(self, host: int, msg: str = ""):
        self.host = host
        super().__init__(msg or f"simulated failure on host {host}")


class FaultToleranceManager:
    def __init__(
        self,
        n_hosts: int,
        straggler_zscore: float = 3.0,
        heartbeat_timeout_s: float = 60.0,
    ) -> None:
        self.n_hosts = n_hosts
        self.straggler_zscore = straggler_zscore
        self.heartbeat_timeout_s = heartbeat_timeout_s
        self._durations: dict = {h: [] for h in range(n_hosts)}
        self._last_seen: dict = {}
        self.restarts = 0

    # -- heartbeats -----------------------------------------------------------
    def heartbeat(self, host: int, step_duration_s: float) -> None:
        self._durations.setdefault(host, []).append(float(step_duration_s))
        self._last_seen[host] = time.time()

    # -- detection ------------------------------------------------------------
    def stragglers(self) -> list:
        """Hosts whose mean step duration is a robust-z outlier above the
        fleet median. Returns [(host, zscore)] sorted worst-first."""
        means = {
            h: statistics.fmean(d) for h, d in self._durations.items() if d
        }
        if len(means) < 3:
            return []
        med = statistics.median(means.values())
        mad = statistics.median(abs(m - med) for m in means.values())
        scale = max(1.4826 * mad, 0.02 * abs(med), 1e-12)
        out = [
            (h, (m - med) / scale)
            for h, m in means.items()
            if (m - med) / scale > self.straggler_zscore
        ]
        return sorted(out, key=lambda hz: -hz[1])

    def dead_hosts(self, now: Optional[float] = None) -> list:
        now = time.time() if now is None else now
        return sorted(
            h
            for h, t in self._last_seen.items()
            if now - t > self.heartbeat_timeout_s
        )

    # -- recovery -------------------------------------------------------------
    def run_with_recovery(
        self,
        run: Callable,
        restore: Callable,
        max_restarts: int = 16,
    ):
        """restore() -> start token; run(start) -> result. On failure,
        restore-and-replay (make semantics), bounded by max_restarts."""
        while True:
            start = restore()
            try:
                return run(start)
            except SimulatedFailure:
                self.restarts += 1
                if self.restarts > max_restarts:
                    raise

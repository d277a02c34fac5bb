"""Snapshot / data-arrival policies (paper §III.E, §III.I).

A task's inputs arrive on links at different rates. A *snapshot* is the tuple
of input value-sets handed to one execution of the user code. The paper names
three aggregation policies plus sliding windows and rate control:

  - **All new** — no reuse; each snapshot is formed from completely fresh data
    (the usual stream semantics).
  - **Swap new for old** — fresh values where links have them, previous values
    where they don't (the Makefile semantics: recompile when any source file
    changes, reusing the unchanged ones).
  - **Merge** — data from multiple links aggregated First-Come-First-Served
    into a single scalar stream (types must match).

Buffers: ``input[N]`` needs N values per snapshot. Sliding windows:
``input[N/k]`` keeps the last N values and advances by k fresh values per
snapshot (e.g. moving averages). Rate control bounds trigger frequency
(the paper's DoS guard).
"""

from __future__ import annotations

import dataclasses
import threading
import time
from collections import deque
from typing import Any, Optional


@dataclasses.dataclass(frozen=True)
class InputSpec:
    """Parsed ``name[N/k]`` input declaration."""

    name: str
    buffer: int = 1  # N: values per snapshot
    slide: Optional[int] = None  # k: fresh values to advance per snapshot

    @property
    def is_window(self) -> bool:
        return self.slide is not None

    @property
    def fresh_needed(self) -> int:
        return self.slide if self.is_window else self.buffer

    @staticmethod
    def parse(text: str) -> "InputSpec":
        text = text.strip()
        if "[" not in text:
            return InputSpec(text)
        name, rest = text.split("[", 1)
        rest = rest.rstrip("]")
        if "/" in rest:
            n, k = rest.split("/")
            n, k = int(n), int(k)
            if not (1 <= k <= n):
                raise ValueError(f"window slide must satisfy 1<=k<=N: {text}")
            return InputSpec(name.strip(), n, k)
        return InputSpec(name.strip(), int(rest))

    def __str__(self) -> str:
        if self.is_window:
            return f"{self.name}[{self.buffer}/{self.slide}]"
        if self.buffer != 1:
            return f"{self.name}[{self.buffer}]"
        return self.name


class _LinkBuffer:
    """Per-input accumulation buffer with window/new-value accounting."""

    def __init__(self, spec: InputSpec) -> None:
        self.spec = spec
        self.window: deque = deque(maxlen=spec.buffer)
        self.fresh: deque = deque()  # values not yet consumed by a snapshot
        self.arrival_seqs: deque = deque()  # global arrival order (merge FCFS)
        self.last_value: Any = None
        self.ever: bool = False

    def push(self, value: Any, seq: int = 0) -> None:
        self.fresh.append(value)
        self.arrival_seqs.append(seq)
        self.last_value = value
        self.ever = True

    def take(self) -> Any:
        """Consume the oldest fresh value (keeps seq accounting in step)."""
        self.arrival_seqs.popleft()
        return self.fresh.popleft()

    def take_seq(self) -> tuple:
        """Consume the oldest fresh value with its global arrival seq."""
        return self.arrival_seqs.popleft(), self.fresh.popleft()

    def fresh_count(self) -> int:
        return len(self.fresh)


class SnapshotPolicy:
    """Assembles execution snapshots from per-input buffers.

    mode: "all_new" | "swap_new_for_old" | "merge"
    """

    MODES = ("all_new", "swap_new_for_old", "merge")

    def __init__(
        self,
        inputs: list,
        mode: str = "all_new",
        min_interval_s: float = 0.0,
    ) -> None:
        if mode not in self.MODES:
            raise ValueError(f"unknown snapshot mode {mode!r}")
        specs = [s if isinstance(s, InputSpec) else InputSpec.parse(s) for s in inputs]
        if mode == "merge" and any(s.is_window or s.buffer != 1 for s in specs):
            raise ValueError("merge mode uses plain FCFS inputs (no buffers/windows)")
        self.mode = mode
        self.specs = specs
        self.buffers = {s.name: _LinkBuffer(s) for s in specs}
        self.min_interval_s = min_interval_s
        self._last_fire = 0.0
        self._arrival_seq = 0  # global arrival counter (merge FCFS ordering)
        self.snapshots_formed = 0
        self.rate_suppressions = 0
        # Arrivals land from the scheduler thread while snapshot() may run
        # in an executor worker; an RLock keeps buffer/seq accounting
        # coherent (snapshot() re-enters ready()).
        self._lock = threading.RLock()

    # -- arrivals -------------------------------------------------------------
    def arrive(self, input_name: str, value: Any) -> None:
        with self._lock:
            self.buffers[input_name].push(value, seq=self._arrival_seq)
            self._arrival_seq += 1

    # -- readiness ------------------------------------------------------------
    def _rate_ok(self) -> bool:
        return (time.time() - self._last_fire) >= self.min_interval_s

    def ready(self) -> bool:
        with self._lock:
            return self._ready_locked()

    def _ready_locked(self) -> bool:
        if not self.buffers:
            # Source tasks have no inputs; they fire only when explicitly
            # sampled or pulled, never spontaneously in reactive rounds.
            return False
        if not self._rate_ok():
            if self._any_data():
                self.rate_suppressions += 1
            return False
        if self.mode == "merge":
            return self._any_data()
        if self.mode == "all_new":
            return all(
                b.fresh_count() >= b.spec.fresh_needed
                and (not b.spec.is_window or self._window_fillable(b))
                for b in self.buffers.values()
            )
        # swap_new_for_old: window inputs still advance only on >=k fresh
        # values; plain inputs reuse their last value. At least one input
        # must have fresh data ('changes to a do not lead to a new event').
        for b in self.buffers.values():
            if b.spec.is_window:
                if b.fresh_count() < b.spec.fresh_needed or not self._window_fillable(b):
                    return False
            elif not b.ever:
                return False
        return self._any_data()

    def _any_data(self) -> bool:
        return any(b.fresh_count() > 0 for b in self.buffers.values())

    def _window_fillable(self, b: _LinkBuffer) -> bool:
        # First snapshot must fill the whole window (N fresh); later ones
        # advance by k and reuse the other N-k positions.
        return len(b.window) + b.fresh_count() >= b.spec.buffer

    # -- snapshot formation -----------------------------------------------------
    def snapshot(self) -> dict:
        """Form one execution set. Caller must have checked ready()."""
        with self._lock:
            return self._snapshot_locked()

    def _snapshot_locked(self) -> dict:
        if not self.buffers:
            # Source task: explicit sample()/pull() fires it with an empty set.
            self._last_fire = time.time()
            self.snapshots_formed += 1
            return {}
        if not self._ready_locked():
            raise RuntimeError("snapshot() called when not ready")
        self._last_fire = time.time()
        self.snapshots_formed += 1
        if self.mode == "merge":
            return {"merged": self._merge_snapshot()}
        out = {}
        for name, b in self.buffers.items():
            spec = b.spec
            if spec.is_window:
                # advance window by k fresh values (or fill it on the first
                # snapshot), emit the last N
                take = max(spec.fresh_needed, spec.buffer - len(b.window))
                for _ in range(take):
                    b.window.append(b.take())
                out[name] = list(b.window)
            elif self.mode == "all_new":
                vals = [b.take() for _ in range(spec.buffer)]
                out[name] = vals if spec.buffer > 1 else vals[0]
            else:  # swap_new_for_old
                if b.fresh_count() >= spec.buffer:
                    vals = [b.take() for _ in range(spec.buffer)]
                else:
                    # reuse old values; consume whatever fresh exist
                    reuse = spec.buffer - b.fresh_count()
                    vals = [b.last_value] * reuse + [
                        b.take() for _ in range(b.fresh_count())
                    ]
                out[name] = vals if spec.buffer > 1 else vals[-1]
        return out

    def _merge_snapshot(self) -> list:
        """First-Come-First-Served merge of all links into one scalar
        stream: values are ordered by *global* arrival time across links,
        not by which link happens to drain first."""
        tagged = []
        for b in self.buffers.values():
            while b.fresh:
                tagged.append(b.take_seq())
        tagged.sort(key=lambda sv: sv[0])
        return [v for _, v in tagged]

    def stats(self) -> dict:
        with self._lock:
            return {
                "mode": self.mode,
                "snapshots_formed": self.snapshots_formed,
                "rate_suppressions": self.rate_suppressions,
                "pending": {n: b.fresh_count() for n, b in self.buffers.items()},
            }

"""Smart Links (paper §III.J) — typed wires carrying AV references.

A SmartLink connects one producer task output to one consumer task input. It
holds a queue of AnnotatedValues and a *separate* notification channel
(Principle 1: separation of channels by timescale): consumers may poll the
data queue, or subscribe for arrival notifications when arrivals are slow
relative to service time. Payloads never travel on the link — only AVs.

The notification channel drives the event scheduler
(:mod:`repro_torch.core.scheduler`): every ``offer()`` wakes exactly the consumer
whose policy may have become ready. When arrivals are *faster* than
``notify_threshold_s`` the link suppresses per-event notifications (the
paper's poll-mode fast path — "when data arrive quickly, it's cheaper to
poll than to be interrupted per event"); the scheduler then coalesces those
arrivals into a single batch poll at quiescence. Suppressions are counted in
link stats so the timescale separation is observable, not just claimed.

Flow control: a link may be bounded (``capacity``) with an ``overflow``
policy — ``"block"`` (wait for the consumer, raising on timeout),
``"drop_oldest"`` (ring-buffer semantics for sensor streams), or
``"error"`` (fail fast). The default is unbounded, preserving the original
semantics. ``block`` is cross-thread backpressure: it waits for a consumer
on *another* thread to ``poll()``. Inside a single-threaded drain the
scheduler is both producer and consumer, so it relieves a full block-link
itself (draining it into the consumer's policy buffer) rather than
stalling — see ``Scheduler._relieve_backpressure``.

Links carry region policy: an AV crossing into a link whose region differs
from the AV's gets a 'transit' stamp, and a ``region_fence`` link refuses AVs
from fenced regions (the paper's 'US data cannot leave the US' audit/enforce
case, §III.L / §IV).
"""

from __future__ import annotations

import threading
import time
from collections import deque
from typing import Callable, Optional

from .av import AnnotatedValue


class RegionFenceError(RuntimeError):
    pass


class LinkBackpressureError(RuntimeError):
    """A bounded link could not accept an AV (full + policy refused it)."""


OVERFLOW_POLICIES = ("block", "drop_oldest", "error")


class SmartLink:
    def __init__(
        self,
        name: str,
        src_task: str,
        dst_task: str,
        dst_input: str,
        region: str = "local",
        fenced_regions: tuple = (),
        notify_threshold_s: float = 0.0,
        capacity: Optional[int] = None,
        overflow: str = "block",
        block_timeout_s: float = 5.0,
    ) -> None:
        if overflow not in OVERFLOW_POLICIES:
            raise ValueError(
                f"unknown overflow policy {overflow!r} (choose from {OVERFLOW_POLICIES})"
            )
        if capacity is not None and capacity < 1:
            raise ValueError(f"link capacity must be >= 1, got {capacity}")
        self.name = name
        self.src_task = src_task
        self.dst_task = dst_task
        self.dst_input = dst_input
        self.region = region
        self.fenced_regions = tuple(fenced_regions)
        # data channel (bounded iff capacity is set)
        self._queue: deque = deque()
        self._lock = threading.Lock()
        self._not_full = threading.Condition(self._lock)
        self.capacity = capacity
        self.overflow = overflow
        self.block_timeout_s = block_timeout_s
        # notification side channel (Principle 1)
        self._subscribers: list = []
        self.notify_threshold_s = notify_threshold_s
        self._last_offer_t: Optional[float] = None
        # notifications_sent counts *events* that notified (one per offer),
        # not callback invocations — fan-out to N subscribers is one event.
        self.notifications_sent = 0
        self.notifications_suppressed = 0
        self.avs_carried = 0
        self.avs_dropped = 0
        self.blocked_waits = 0
        # Extended-cloud transport (repro.topology): AV references that
        # crossed a zone boundary on this link. Counting refs — not bytes —
        # is the point: cross-zone edges are hash-only ghost transfers, and
        # payload bytes are charged separately (TransferLedger) only when a
        # consumer materializes them.
        self.crosszone_refs = 0
        # Forensic sink for overflow drops (bound by the scheduler): a
        # drop_oldest eviction logs a 'dropped' visit so the traveller's
        # disappearance stays reconstructable, not just counted.
        self._provenance = None

    def bind_provenance(self, registry) -> None:
        self._provenance = registry

    # -- data channel ---------------------------------------------------------
    def offer(self, av: AnnotatedValue, software_version: str = "?") -> None:
        """Producer side: put an AV reference on the wire."""
        if av.region in self.fenced_regions:
            raise RegionFenceError(
                f"AV {av.uid} from region {av.region!r} fenced on link {self.name}"
            )
        if av.region != self.region:
            av.stamp(
                self.name,
                "transit",
                software_version,
                region=self.region,
                note=f"{av.region}->{self.region}",
            )
        dropped: Optional[AnnotatedValue] = None
        with self._not_full:
            if self.capacity is not None and len(self._queue) >= self.capacity:
                if self.overflow == "error":
                    raise LinkBackpressureError(
                        f"link {self.name} full (capacity={self.capacity}, "
                        f"overflow='error')"
                    )
                if self.overflow == "drop_oldest":
                    dropped = self._queue.popleft()
                    self.avs_dropped += 1
                else:  # block
                    self.blocked_waits += 1
                    deadline = time.monotonic() + self.block_timeout_s
                    while len(self._queue) >= self.capacity:
                        remaining = deadline - time.monotonic()
                        if remaining <= 0 or not self._not_full.wait(remaining):
                            if len(self._queue) < self.capacity:
                                break
                            raise LinkBackpressureError(
                                f"link {self.name} full (capacity="
                                f"{self.capacity}): consumer did not drain "
                                f"within {self.block_timeout_s}s"
                            )
            self._queue.append(av)
            self.avs_carried += 1
            # poll-mode fast path (§III.J): arrivals faster than the
            # threshold coalesce — no per-event interrupt.
            now = time.monotonic()
            suppress = (
                self.notify_threshold_s > 0.0
                and self._last_offer_t is not None
                and (now - self._last_offer_t) < self.notify_threshold_s
            )
            self._last_offer_t = now
            if suppress:
                self.notifications_suppressed += 1
                subscribers = ()
            else:
                self.notifications_sent += 1
                subscribers = tuple(self._subscribers)
        # Outside the link lock (registry has its own): the evicted AV gets
        # a 'dropped' stamp and a visitor-log entry at the consumer it never
        # reached — before this, a drop_oldest eviction was a bare counter
        # bump and the traveller silently vanished from every story.
        if dropped is not None:
            dropped.stamp(
                self.name,
                "dropped",
                software_version,
                region=self.region,
                note=f"overflow=drop_oldest capacity={self.capacity}",
            )
            if self._provenance is not None:
                self._provenance.log_visit(
                    self.dst_task,
                    dropped.uid,
                    "dropped",
                    software_version,
                    note=f"link={self.name} overflow=drop_oldest",
                )
        # callbacks run outside the lock: a subscriber may poll() or inspect
        # the link without deadlocking.
        for cb in subscribers:
            cb(self, av)

    def poll(self) -> Optional[AnnotatedValue]:
        """Consumer side: non-blocking get (the paper's 'get' on the
        pseudo-stream; 'it wants to know if there is anything new')."""
        with self._not_full:
            if self._queue:
                av = self._queue.popleft()
                self._not_full.notify()
                return av
        return None

    def peek_count(self) -> int:
        with self._lock:
            return len(self._queue)

    # -- notification channel ---------------------------------------------------
    def subscribe(self, callback: Callable) -> None:
        with self._lock:
            self._subscribers.append(callback)

    def _notify(self, av: AnnotatedValue) -> None:
        """Force one notification event to all subscribers (bypasses the
        threshold; used by tests/tools — ``offer`` notifies inline)."""
        with self._lock:
            self.notifications_sent += 1
            subscribers = tuple(self._subscribers)
        for cb in subscribers:
            cb(self, av)

    def stats(self) -> dict:
        return {
            "carried": self.avs_carried,
            "depth": self.peek_count(),
            "notified": self.notifications_sent,
            "suppressed": self.notifications_suppressed,
            "dropped": self.avs_dropped,
            "blocked_waits": self.blocked_waits,
            "capacity": self.capacity,
            "crosszone_refs": self.crosszone_refs,
        }

    def __repr__(self) -> str:
        return (
            f"SmartLink({self.src_task}->{self.dst_task}.{self.dst_input},"
            f" depth={self.peek_count()})"
        )

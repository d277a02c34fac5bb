"""Per-tenant transfer quotas — the billing half of the multi-tenant hub.

A tenant's resource story has two meters, both fed by machinery that
already exists for single-tenant workspaces:

* **bytes** — payload ingress (every ``push``/``inject`` payload, priced by
  the same :meth:`~repro_torch.core.store.ArtifactStore._nbytes` rule the store
  itself uses) plus cross-zone movement the tenant's
  :class:`~repro_torch.topology.ledger.TransferLedger` actually billed
  (``bytes_moved_crosszone`` — reference handovers are free, exactly as in
  the single-tenant sustainability story);
* **joules** — the ledger's derived ``transfer_energy_j``. Flat-topology
  tenants never spend joules, which mirrors the paper's claim that energy
  cost is a *placement* consequence, not a compute one.

Each meter has a soft and a hard limit:

* crossing a **soft** limit journals a ``quota_warning`` anomaly — exactly
  once per crossing, because usage is monotone within a run — and work
  continues;
* a **hard** limit is a deterministic *rejection*: the offending push is
  refused with :class:`QuotaExceededError` before any payload enters the
  store, a ``quota_rejected`` anomaly is journaled (so replay sees the
  refusal too), and **zero** bytes are charged for the rejected attempt.

Determinism contract: both checks run on the facade thread, before/after
the engine call, using only deterministic quantities (payload sizes,
ledger byte totals, the order-independent energy sum) — so the same
session script trips the same warnings and rejections under every
executor backend, and a journal replay reconstructs the same anomaly
trail.

Port of ``repro.tenancy.quota``. A tensor payload is billed its
``numel * element_size``, as numpy's ``nbytes``; a container of tensors its
pickle length with the tensors by value
(:func:`repro_torch.core.hashing.content_pickle`), the reference's length for
the same container of numpy arrays.
"""

from __future__ import annotations

import dataclasses
import threading
from typing import Optional


class TenancyError(RuntimeError):
    """Base class for multi-tenant control-plane failures."""


class PermissionDeniedError(TenancyError):
    """Caller's role on the tenant workspace does not cover the operation."""


class QuotaExceededError(TenancyError):
    """A hard per-tenant limit would be crossed; the operation was refused
    deterministically and nothing was charged."""


@dataclasses.dataclass(frozen=True)
class TenantQuota:
    """Limits for one tenant. ``None`` means unlimited on that axis."""

    hard_bytes: Optional[int] = None
    soft_bytes: Optional[int] = None
    hard_joules: Optional[float] = None
    soft_joules: Optional[float] = None

    def to_record(self) -> dict:
        return dataclasses.asdict(self)

    @classmethod
    def from_record(cls, data: Optional[dict]) -> Optional["TenantQuota"]:
        if not data:
            return None
        return cls(
            hard_bytes=data.get("hard_bytes"),
            soft_bytes=data.get("soft_bytes"),
            hard_joules=data.get("hard_joules"),
            soft_joules=data.get("soft_joules"),
        )


class TenantMeter:
    """Usage accounting + limit enforcement for one tenant.

    The meter owns only the ingress-byte counter; cross-zone bytes and
    joules are read off the tenant's ledger at check time, so the numbers
    always agree with ``ledger.stats()`` (part of the determinism
    fingerprint). Thread-safe: a tenant's own session calls are sequential,
    but the hub's stats/billing reads may race them.
    """

    def __init__(self, tenant: str, quota: Optional[TenantQuota] = None) -> None:
        self.tenant = tenant
        self.quota = quota
        self.ingress_bytes = 0
        self.rejections = 0
        self._warned_bytes = False
        self._warned_joules = False
        self._lock = threading.Lock()

    # -- usage readings ------------------------------------------------------
    def bytes_used(self, ledger=None) -> int:
        moved = int(ledger.stats()["bytes_moved_crosszone"]) if ledger is not None else 0
        return self.ingress_bytes + moved

    def joules_used(self, ledger=None) -> float:
        if ledger is None:
            return 0.0
        return float(ledger.stats()["transfer_energy_j"])

    # -- enforcement ---------------------------------------------------------
    def charge_ingress(self, nbytes: int, task: str, registry, ledger=None) -> None:
        """Admit (and bill) ``nbytes`` of payload ingress for ``task``, or
        refuse with :class:`QuotaExceededError` — journaling the refusal —
        if a hard limit would be crossed. Refusals charge nothing."""
        nbytes = int(nbytes)
        with self._lock:
            q = self.quota
            if q is not None:
                used_b = self.bytes_used(ledger)
                if q.hard_bytes is not None and used_b + nbytes > q.hard_bytes:
                    self.rejections += 1
                    registry.record_anomaly(
                        task,
                        f"quota_rejected axis=bytes requested={nbytes} "
                        f"used={used_b} hard={q.hard_bytes}",
                    )
                    raise QuotaExceededError(
                        f"tenant {self.tenant!r}: push of {nbytes} B refused — "
                        f"{used_b} B used of hard limit {q.hard_bytes} B"
                    )
                used_j = self.joules_used(ledger)
                if q.hard_joules is not None and used_j >= q.hard_joules:
                    self.rejections += 1
                    registry.record_anomaly(
                        task,
                        f"quota_rejected axis=joules used={used_j:.6f} "
                        f"hard={q.hard_joules}",
                    )
                    raise QuotaExceededError(
                        f"tenant {self.tenant!r}: push refused — "
                        f"{used_j:.6f} J spent of hard limit {q.hard_joules} J"
                    )
            self.ingress_bytes += nbytes

    def observe(self, task: str, registry, ledger=None) -> None:
        """Post-operation soft-limit sweep: journal one ``quota_warning``
        anomaly per axis the first time usage crosses the soft line."""
        with self._lock:
            q = self.quota
            if q is None:
                return
            if q.soft_bytes is not None and not self._warned_bytes:
                used_b = self.bytes_used(ledger)
                if used_b > q.soft_bytes:
                    self._warned_bytes = True
                    registry.record_anomaly(
                        task,
                        f"quota_warning axis=bytes used={used_b} "
                        f"soft={q.soft_bytes}",
                    )
            if q.soft_joules is not None and not self._warned_joules:
                used_j = self.joules_used(ledger)
                if used_j > q.soft_joules:
                    self._warned_joules = True
                    registry.record_anomaly(
                        task,
                        f"quota_warning axis=joules used={used_j:.6f} "
                        f"soft={q.soft_joules}",
                    )

    # -- introspection -------------------------------------------------------
    def stats(self, ledger=None) -> dict:
        with self._lock:
            return {
                "tenant": self.tenant,
                "quota": self.quota.to_record() if self.quota else None,
                "ingress_bytes": self.ingress_bytes,
                "bytes_used": self.bytes_used(ledger),
                "joules_used": self.joules_used(ledger),
                "rejections": self.rejections,
                "soft_warned_bytes": self._warned_bytes,
                "soft_warned_joules": self._warned_joules,
            }

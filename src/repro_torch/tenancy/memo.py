"""Cross-tenant memo dedup — shared results, private provenance.

Tenants of one :class:`~repro_torch.tenancy.WorkspaceHub` share the
content-addressed :class:`~repro_torch.core.store.ArtifactStore`, so identical
payloads are already stored once. This module extends the sharing to
*compute*: a :class:`HubMemoStore` indexes every tenant's memo records by
their content key (software version + input content hashes + policy mode —
no tenant identity anywhere in the key), and a tenant's
:class:`TenantMemoCache` consults it on a local miss. When tenant B pushes
bytes tenant A already computed, B's task never runs: the hub hands back a
**dedup closure** (see ``ExecutionPlan.dedup`` in :mod:`repro_torch.core.task`)
that replays A's output references out of the shared store.

The scoping rule that makes this safe for multi-tenant forensics:

* **Tenant-scoped provenance is written as if the tenant computed the
  result itself.** The replay flows through the ordinary
  ``finish_execution`` path — executed visit, freshly minted AVs, emitted
  visits, ledger charges, memo insert — so the tenant's lineage and
  visitor logs are byte-identical to a solo run and never mention the
  other tenant. Lineage/visitor-log reads stay strictly tenant-scoped.
* **The cross-tenant credit lives only at hub level.** ``credit`` journals
  a hub-scope ``cache_hit`` record naming beneficiary, origin tenant, and
  the origin run's AV uids (``memo_of``), and bumps the hub's
  ``executions_avoided``/``bytes_saved`` counters — the billing story that
  credits the original run without leaking it into anyone's workspace.

Port of ``repro.tenancy.memo``. A replay hands the origin's payload objects
out of the shared store by reference: a card tensor stays where it is, and
no byte of it is read or copied.
"""

from __future__ import annotations

import threading
from typing import Any, Optional

from repro_torch.cache.memo import MemoCache


class HubMemoStore:
    """Hub-wide, first-writer-wins index of memo records by content key.

    Thread-safe: tenants insert and peek concurrently. Optionally writes
    through to the hub journal (``hub_memo`` on first offer per key,
    hub-scope ``cache_hit`` on every cross-tenant credit) so
    :meth:`WorkspaceHub.from_journal` can rebuild the dedup story.
    """

    def __init__(self) -> None:
        self._entries: dict = {}  # key -> {"tenant": origin, "record": memo}
        self._lock = threading.Lock()
        self._journal = None
        self.offers = 0
        self.dedup_hits = 0
        self.executions_avoided = 0
        self.bytes_saved = 0
        self.by_tenant: dict = {}  # beneficiary -> {"hits", "bytes_saved"}

    def bind_journal(self, journal) -> None:
        with self._lock:
            self._journal = journal

    # -- writes --------------------------------------------------------------
    def offer(self, tenant: str, key: str, record: Any) -> bool:
        """Register one tenant's memo record under its content key. First
        writer wins — later offers for the same key (same content ⇒ same
        outputs) are dropped, keeping the origin credit stable."""
        if not isinstance(record, dict) or not record.get("outputs"):
            return False
        with self._lock:
            self.offers += 1
            if key in self._entries:
                return False
            self._entries[key] = {"tenant": tenant, "record": record}
            if self._journal is not None:
                self._journal.append(
                    "hub_memo", {"tenant": tenant, "key": key, "record": record}
                )
            return True

    def restore_offer(self, tenant: str, key: str, record: Any) -> None:
        """Replay-side ``offer`` — no counters, no re-journaling."""
        with self._lock:
            self._entries.setdefault(key, {"tenant": tenant, "record": record})

    # -- reads ---------------------------------------------------------------
    def peek(self, key: str) -> Optional[dict]:
        with self._lock:
            return self._entries.get(key)

    def credit(self, key: str, entry: dict, beneficiary: str) -> int:
        """Account one cross-tenant dedup replay; returns bytes saved. The
        hub journal gets the only record that names both tenants."""
        record = entry.get("record") or {}
        saved = sum(int(n) for n in record.get("out_nbytes", {}).values())
        with self._lock:
            self.dedup_hits += 1
            self.executions_avoided += 1
            self.bytes_saved += saved
            bt = self.by_tenant.setdefault(
                beneficiary, {"hits": 0, "bytes_saved": 0}
            )
            bt["hits"] += 1
            bt["bytes_saved"] += saved
            if self._journal is not None:
                self._journal.append(
                    "cache_hit",
                    {
                        "scope": "hub",
                        "tenant": beneficiary,
                        "origin_tenant": entry.get("tenant"),
                        "key": key,
                        "memo_of": dict(record.get("out_uids", {})),
                        "bytes_saved": saved,
                    },
                )
        return saved

    def stats(self) -> dict:
        with self._lock:
            return {
                "entries": len(self._entries),
                "offers": self.offers,
                "dedup_hits": self.dedup_hits,
                "executions_avoided": self.executions_avoided,
                "bytes_saved": self.bytes_saved,
                "by_tenant": {t: dict(v) for t, v in self.by_tenant.items()},
            }


class TenantMemoCache(MemoCache):
    """A tenant's :class:`MemoCache` that shares results through the hub.

    ``lookup`` is untouched (tenant-scoped, journals into the tenant's own
    segment). ``insert`` additionally offers the record to the hub store.
    ``plan_dedup`` is the hook ``SmartTask._begin_execution`` consults after
    a *local* miss: it peeks the hub index and, when another tenant already
    computed this key, returns the replay closure the execution plan
    carries. Same-tenant entries return ``None`` — a tenant's own TTL
    expiry must recompute exactly as it would solo, or fingerprints drift.
    """

    def __init__(
        self,
        hub_store: HubMemoStore,
        tenant: str,
        default_ttl_s: Optional[float] = None,
    ) -> None:
        super().__init__(default_ttl_s)
        self._hub = hub_store
        self.tenant = tenant

    def insert(self, key: str, value: Any, ttl_s: Optional[float] = None) -> None:
        super().insert(key, value, ttl_s=ttl_s)
        self._hub.offer(self.tenant, key, value)

    def plan_dedup(self, key: str):
        entry = self._hub.peek(key)
        if entry is None or entry.get("tenant") == self.tenant:
            return None
        record = entry.get("record") or {}
        outputs = record.get("outputs") or {}
        if not outputs:
            return None
        hub, tenant = self._hub, self.tenant

        def _replay(store):
            # Every output must still be resolvable in the shared store; a
            # store-evicted origin falls through to a real run (closure
            # returns None, run_user_fn proceeds as if no dedup existed).
            refs = {}
            for oname, ref in outputs.items():
                uri, _chash = ref[0], ref[1]
                if not store.resolvable(uri):
                    return None
                refs[oname] = uri
            out = {oname: store.get(uri) for oname, uri in refs.items()}
            hub.credit(key, entry, beneficiary=tenant)
            return out

        return _replay

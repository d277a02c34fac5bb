"""Semantic memoization — the sustainability pillar (paper §III.F / §III.J).

A memo entry keys one task execution on *content identity*:

    key = (task software version, ordered input content hashes,
           snapshot-policy mode)

Unchanged inputs + unchanged code + unchanged aggregation semantics ⇒ hit ⇒
no recompute ("it's unnecessary to recompile binaries that are unchanged").
The policy mode is part of the key because the same input hashes mean
different things under ``all_new`` vs ``merge`` aggregation. A
software-version change invalidates downstream results exactly as the paper
prescribes for "software updates trigger recomputation".

A hit is *not* lossy for forensics: each record remembers the uids of the
AVs the original run produced (``out_uids``), so the short-circuited AV can
carry a ``memo_of`` pointer and :meth:`ProvenanceRegistry.lineage` still
reconstructs the producing run, software version and all.

Sustainability accounting: ``executions_avoided`` counts short-circuited
firings and ``bytes_saved`` the output payload bytes that never had to be
recomputed or re-transported (the "bytes not moved" half that belongs to the
memo layer; the :class:`~repro_torch.core.store.ArtifactStore` counts the
reference-dedup half).

Purge policy: per-entry TTL classes so caches can "purge at different rates
depending on the risk of recomputation" (§III.F Principle 2 discussion).
"""

from __future__ import annotations

import hashlib
import threading
import time
from typing import Any, Optional


def snapshot_key(
    software_version: str,
    input_hashes: dict,
    extra: str = "",
    policy_mode: str = "",
) -> str:
    """Content key for one snapshot execution.

    ``input_hashes`` maps input name -> content hash (or ordered list of
    hashes for buffered/window inputs); ordering inside a buffer is
    significant, ordering of input names is not (they are sorted).
    """
    parts = [software_version, extra]
    if policy_mode:
        parts.append(f"mode={policy_mode}")
    for name in sorted(input_hashes):
        v = input_hashes[name]
        if isinstance(v, (list, tuple)):
            parts.append(f"{name}=[{','.join(v)}]")
        else:
            parts.append(f"{name}={v}")
    return hashlib.sha256("|".join(parts).encode()).hexdigest()[:24]


def make_record(
    software_version: str,
    outputs: dict,
    out_uids: Optional[dict] = None,
    out_nbytes: Optional[dict] = None,
    birth_zone: Optional[str] = None,
) -> dict:
    """Build a memo record: {output_name: (uri, chash)} plus the forensic
    back-pointers (original AV uids) and size accounting. ``birth_zone`` is
    the extended-cloud zone the producing run executed in — a later memo
    hit replays references to payloads still resident *there*, so the
    transfer ledger must bill from the birth zone, not the replay zone."""
    return {
        "software_version": software_version,
        "outputs": dict(outputs),
        "out_uids": dict(out_uids or {}),
        "out_nbytes": dict(out_nbytes or {}),
        "birth_zone": birth_zone,
        "produced_at": time.time(),
    }


class MemoCache:
    """Content-addressed memo table with TTL purge classes and
    sustainability counters. (Exported as ``ContentCache`` for the original
    earlier name; the two are the same class.)"""

    def __init__(self, default_ttl_s: Optional[float] = None) -> None:
        self._entries: dict = {}  # key -> (record, expiry)
        self.default_ttl_s = default_ttl_s
        self.hits = 0
        self.misses = 0
        self.evictions = 0
        self.executions_avoided = 0
        self.bytes_saved = 0
        # hits served from a replica already resident in the consumer's
        # zone (the zone-local tier): no cross-zone transfer was implied
        self.zone_local_hits = 0
        # Concurrent waves consult the memo table from worker threads.
        self._lock = threading.RLock()
        # optional durable write-through (repro.provenance.Journal)
        self._journal = None

    def bind_journal(self, journal) -> None:
        """Attach a provenance journal: every memo hit appends a typed
        ``cache_hit`` record, so short-circuited work is reconstructable
        after a restart alongside the visitor-log entries it produced."""
        with self._lock:
            self._journal = journal

    def lookup(self, key: str) -> Optional[Any]:
        with self._lock:
            rec = self._entries.get(key)
            if rec is None:
                self.misses += 1
                return None
            value, expiry = rec
            if expiry is not None and time.time() > expiry:
                del self._entries[key]
                self.evictions += 1
                self.misses += 1
                return None
            self.hits += 1
            if self._journal is not None:
                self._journal.append(
                    "cache_hit",
                    {
                        "key": key,
                        "software_version": (
                            value.get("software_version")
                            if isinstance(value, dict)
                            else None
                        ),
                    },
                )
            return value

    def insert(self, key: str, value: Any, ttl_s: Optional[float] = None) -> None:
        ttl = ttl_s if ttl_s is not None else self.default_ttl_s
        expiry = (time.time() + ttl) if ttl is not None else None
        with self._lock:
            self._entries[key] = (value, expiry)
            if self._journal is not None:
                # typed ``memo`` record: the table itself survives restarts
                # (re-inserting under the same key supersedes the old record
                # on replay — exactly the last-writer-wins the dict applies
                # here — which is what lets compaction fold overwrites away)
                self._journal.append(
                    "memo", {"key": key, "record": value, "expires_at": expiry}
                )

    # -- replay / checkpoint (journal rehydration + compaction support) ------
    def restore_entry(
        self, key: str, record: Any, expires_at: Optional[float] = None
    ) -> None:
        """Rebuild one memo entry from a journaled ``memo`` record without
        re-journaling; last record per key wins, matching live overwrite
        semantics."""
        with self._lock:
            self._entries[key] = (record, expires_at)

    def snapshot_state(self) -> dict:
        """Serialize the live (non-expired) memo table as the ``cache``
        payload of a journal checkpoint — expired entries are the memo
        layer's superseded records and are purged at the fold."""
        now = time.time()
        with self._lock:
            return {
                "entries": [
                    {"key": k, "record": v, "expires_at": e}
                    for k, (v, e) in self._entries.items()
                    if e is None or now <= e
                ]
            }

    def restore_state(self, state: dict) -> None:
        """Rehydrate from a checkpoint snapshot (inverse of
        :meth:`snapshot_state`); tail ``memo`` records replayed afterwards
        overwrite on top."""
        with self._lock:
            self._entries.clear()
            for item in state.get("entries", []):
                self._entries[item["key"]] = (
                    item.get("record"),
                    item.get("expires_at"),
                )

    def credit_hit(self, record: Any) -> int:
        """Account one short-circuited execution; returns bytes saved."""
        saved = 0
        if isinstance(record, dict):
            saved = sum(int(n) for n in record.get("out_nbytes", {}).values())
        with self._lock:
            self.executions_avoided += 1
            self.bytes_saved += saved
        return saved

    def note_zone_local_hit(self) -> None:
        """Count a hit served from a same-zone replica (see
        ``ArtifactStore.zone_resident``; the ledger credits the bytes)."""
        with self._lock:
            self.zone_local_hits += 1

    def invalidate_version(self, software_version_prefix: str) -> int:
        """Purge entries produced by a given software version (forensic
        recall: 'a change may be due to software errors, indicating that
        recomputation is needed')."""
        with self._lock:
            doomed = [
                k
                for k, (v, _) in self._entries.items()
                if isinstance(v, dict)
                and v.get("software_version", "").startswith(software_version_prefix)
            ]
            for k in doomed:
                del self._entries[k]
                self.evictions += 1
            return len(doomed)

    def purge_expired(self) -> int:
        now = time.time()
        with self._lock:
            doomed = [
                k for k, (_, e) in self._entries.items() if e is not None and now > e
            ]
            for k in doomed:
                del self._entries[k]
                self.evictions += 1
            return len(doomed)

    def stats(self) -> dict:
        with self._lock:
            return {
                "entries": len(self._entries),
                "hits": self.hits,
                "misses": self.misses,
                "evictions": self.evictions,
                "executions_avoided": self.executions_avoided,
                "bytes_saved": self.bytes_saved,
                "zone_local_hits": self.zone_local_hits,
            }


# Earlier name; kept so `from repro_torch.core import ContentCache` stays valid.
ContentCache = MemoCache

"""The three provenance stories of paper §III.C / §III.L.

1. **Traveller log** — what each data packet experienced along its journey
   (which software version processed it, in what order). Stored as travel
   documents on the AVs themselves plus a registry index here.
2. **Checkpoint visitor log** — per-task log of which AVs passed through and
   when, with interleaving timelines (paper fig. 9).
3. **Design map** — the long-term map of checkpoints (tasks), their promises,
   the kinds of data passed between them, and significant anomalies
   (paper fig. 10: ``(a) --b(precedes)--> "b"`` records).

Strict record format; queries are structured (no regex scraping, per §III.L).

Port of ``repro.core.provenance``. Durability: the registry can write
through to an append-only
:class:`~repro_torch.provenance.Journal` (``bind_journal``) — one typed JSONL
record per registration/visit/edge/anomaly — so the stories survive process
restarts and replay via ``Workspace.from_journal``. Every visitor entry also
carries a registry-assigned monotonic ``seq`` (assigned under the lock, so
it is a total order over this registry's events), which is the cross-task
ordering key: wall clocks tie on coarse granularities, sequence numbers
never do.
"""

from __future__ import annotations

import dataclasses
import json
import threading
import time
from collections import defaultdict
from typing import Any, Iterable, Optional

from .av import AnnotatedValue, Stamp


@dataclasses.dataclass
class VisitorEntry:
    """One line of a checkpoint (task) visitor log."""

    task: str
    av_uid: str
    event: str  # "arrived" | "executed" | "emitted" | "cache_hit" | "anomaly" | "dropped"
    timestamp: float
    software_version: str
    note: str = ""
    # Monotonic registry event number — the deterministic ordering key for
    # cross-task queries (and the replay order after a restart).
    seq: int = 0

    def to_record(self) -> dict:
        return dataclasses.asdict(self)


class ProvenanceRegistry:
    """Pipeline-manager-held registry: the 'secure location' for travel docs.

    All reads and writes hold ``_lock`` (an RLock — ``lineage`` recurses):
    concurrent wave workers register AVs and log visits while forensic
    queries iterate the same dicts, and an unlocked iteration would throw
    ``dictionary changed size during iteration`` or return a lineage with
    parents missing mid-recursion.
    """

    def __init__(self) -> None:
        self._avs: dict = {}  # uid -> AnnotatedValue
        self._visitor_logs: dict = defaultdict(list)  # task -> [VisitorEntry]
        self._design_edges: set = set()  # (src, relation, dst)
        self._task_promises: dict = {}  # task -> {inputs, outputs, version}
        self._lineage: dict = {}  # av uid -> list of parent av uids
        self.anomalies: list = []
        # ConcurrentExecutor workers register AVs and log visits from
        # multiple threads; an RLock keeps the stories coherent.
        self._lock = threading.RLock()
        # monotonic event counter (visitor-log seq); survives rehydration
        self._next_seq = 0
        # optional durable write-through (repro_torch.provenance.Journal)
        self._journal = None

    # -- durability ----------------------------------------------------------
    def bind_journal(self, journal) -> None:
        """Attach an append-only journal; every subsequent registration,
        visit, edge, and anomaly writes through. Replayed registries stay
        unbound — rehydration never re-journals history.

        Binding a *resumed* journal (one with records already on disk)
        advances the event counter past the highest journaled visit seq, so
        post-restart entries keep the total order ``visits_of`` sorts by."""
        with self._lock:
            self._journal = journal
            if journal is not None:
                self._next_seq = max(
                    self._next_seq,
                    getattr(journal, "resumed_visit_seq", -1) + 1,
                )

    @property
    def journal(self):
        return self._journal

    def reserve_seqs(self, n: int) -> int:
        """Claim ``n`` consecutive visitor-log seq numbers and return the
        first. The multi-process runtime reserves a window per remote
        firing, ships the start with the work order, and the runner stamps
        its visit records inside the window — so entries streamed back via
        ``restore_visit`` interleave deterministically with entries logged
        here, and ``visits_of``'s total order never collides."""
        with self._lock:
            start = self._next_seq
            self._next_seq += max(0, int(n))
            return start

    # -- registration --------------------------------------------------------
    def register_av(self, av: AnnotatedValue, parents: Iterable[str] = ()) -> None:
        parents = list(parents)
        with self._lock:
            self._avs[av.uid] = av
            self._lineage[av.uid] = parents
            if self._journal is not None:
                self._journal.append(
                    "av", {"av": av.to_record(), "parents": parents}
                )

    def log_visit(
        self,
        task: str,
        av_uid: str,
        event: str,
        software_version: str,
        note: str = "",
    ) -> None:
        with self._lock:
            entry = VisitorEntry(
                task=task,
                av_uid=av_uid,
                event=event,
                timestamp=time.time(),
                software_version=software_version,
                note=note,
                seq=self._next_seq,
            )
            self._next_seq += 1
            self._visitor_logs[task].append(entry)
            if self._journal is not None:
                self._journal.append("visit", entry.to_record())

    def register_task(
        self, task: str, inputs: list, outputs: list, version: str
    ) -> None:
        with self._lock:
            self._task_promises[task] = {
                "inputs": list(inputs),
                "outputs": list(outputs),
                "version": version,
            }
            if self._journal is not None:
                self._journal.append(
                    "task",
                    {
                        "task": task,
                        "inputs": list(inputs),
                        "outputs": list(outputs),
                        "version": version,
                    },
                )

    def add_design_edge(self, src: str, relation: str, dst: str) -> None:
        with self._lock:
            self._design_edges.add((src, relation, dst))
            if self._journal is not None:
                self._journal.append(
                    "edge", {"src": src, "relation": relation, "dst": dst}
                )

    def record_anomaly(self, task: str, note: str) -> None:
        with self._lock:
            rec = {"task": task, "note": note, "timestamp": time.time()}
            self.anomalies.append(rec)
            if self._journal is not None:
                self._journal.append("anomaly", rec)
            self.log_visit(task, "-", "anomaly", self.task_version(task), note)

    def task_version(self, task: str) -> str:
        with self._lock:
            return self._task_promises.get(task, {}).get("version", "?")

    # -- replay (journal rehydration; see repro_torch.provenance.journal) ----------
    def restore_av(self, data: dict) -> None:
        """Rebuild one AV (and its lineage) from a journaled ``av`` record.
        The travel document is restored as of registration time — stamps
        added later in the original process were link/task-side mutations
        the journal does not track."""
        rec = dict(data["av"])
        stamps = [Stamp(**s) for s in rec.get("travel_document", [])]
        av = AnnotatedValue(
            uid=rec["uid"],
            source_task=rec["source_task"],
            uri=rec["uri"],
            chash=rec["chash"],
            created_at=rec["created_at"],
            region=rec.get("region", "local"),
            meta=dict(rec.get("meta") or {}),
            travel_document=stamps,
        )
        with self._lock:
            self._avs[av.uid] = av
            self._lineage[av.uid] = list(data.get("parents", []))

    def restore_visit(self, data: dict) -> None:
        """Rebuild one visitor-log entry from a journaled ``visit`` record,
        preserving its original seq (and advancing the counter past it so
        post-rehydration events keep the total order)."""
        entry = VisitorEntry(**data)
        with self._lock:
            self._visitor_logs[entry.task].append(entry)
            self._next_seq = max(self._next_seq, entry.seq + 1)

    def restore_anomaly(self, data: dict) -> None:
        """Rebuild one anomaly record (its visitor-log line replays
        separately — ``record_anomaly`` journaled both)."""
        with self._lock:
            self.anomalies.append(dict(data))

    # -- forensic horizon (journal compaction support) -----------------------
    def _apply_retirement(self, gone: set, horizon: int) -> None:
        """The shared removal rule for live retirement and journal replay:
        drop the retired AVs, their lineage rows, every visitor entry that
        references them, and the AV-less ``executed`` markers (one per task
        firing, ``av_uid == '-'``) at or below the horizon seq — a firing
        whose artifacts are all retired has nothing left to anchor its
        marker to. Anomaly lines are never trimmed (they are design-map
        content, deliberately permanent)."""
        for uid in gone:
            self._avs.pop(uid, None)
            self._lineage.pop(uid, None)
        for task in list(self._visitor_logs):
            kept = [
                e
                for e in self._visitor_logs[task]
                if e.av_uid not in gone
                and not (
                    e.av_uid == "-" and e.event == "executed" and e.seq <= horizon
                )
            ]
            if kept:
                self._visitor_logs[task][:] = kept
            else:
                del self._visitor_logs[task]

    def retire_avs(self, uids: Iterable[str], note: str = "") -> list:
        """Drop AVs — and the visitor-log entries that reference them — from
        the registry's forensic horizon, journaling one ``retired`` record so
        every view of history agrees: the live registry, a full-history
        replay (which applies the marker), and a compacted replay (whose
        checkpoint simply no longer contains them).

        This is the deliberate forgetting that makes
        :meth:`~repro_torch.provenance.Journal.compact` *bound* state rather than
        merely re-encode it: dropped travellers, store-evicted payloads, and
        aged-out ``[N/k]`` window members stop costing memory and checkpoint
        bytes. Lineage pointers from surviving AVs to retired parents go
        dangling, which ``lineage()`` already tolerates (it skips unknown
        uids). Returns the uids actually retired."""
        with self._lock:
            doomed = [u for u in uids if u in self._avs]
            if not doomed:
                return []
            gone = set(doomed)
            # horizon for AV-less `executed` markers: the newest visit being
            # retired — markers older than that belong to folded firings
            horizon = max(
                (
                    e.seq
                    for es in self._visitor_logs.values()
                    for e in es
                    if e.av_uid in gone
                ),
                default=-1,
            )
            self._apply_retirement(gone, horizon)
            if self._journal is not None:
                self._journal.append(
                    "retired",
                    {"uids": sorted(doomed), "horizon_seq": horizon, "note": note},
                )
            return sorted(doomed)

    def restore_retired(self, data: dict) -> None:
        """Apply a journaled ``retired`` marker during replay: the same
        removals the live registry performed, without re-journaling."""
        with self._lock:
            self._apply_retirement(
                set(data.get("uids", [])), int(data.get("horizon_seq", -1))
            )

    # -- checkpoint snapshot (journal compaction support) --------------------
    def snapshot_state(self) -> dict:
        """Serialize the whole registry as one JSON-safe state blob — the
        ``registry`` payload of a journal checkpoint record. Everything a
        replay of the folded records would have produced is here: AVs with
        lineage (insertion order preserved), visitor entries (sorted by
        their total-order seq), promises, edges, anomalies, and the event
        counter."""
        with self._lock:
            visits = sorted(
                (e for es in self._visitor_logs.values() for e in es),
                key=lambda e: e.seq,
            )
            return {
                "avs": [
                    {"av": av.to_record(), "parents": list(self._lineage.get(uid, []))}
                    for uid, av in self._avs.items()
                ],
                "visits": [e.to_record() for e in visits],
                "tasks": {t: dict(p) for t, p in self._task_promises.items()},
                "edges": sorted(list(e) for e in self._design_edges),
                "anomalies": [dict(a) for a in self.anomalies],
                "next_seq": self._next_seq,
            }

    def restore_state(self, state: dict) -> None:
        """Rehydrate from a checkpoint snapshot (inverse of
        :meth:`snapshot_state`), replacing current contents. Tail records
        replayed afterwards append on top, exactly as the folded records
        would have."""
        with self._lock:
            self._avs.clear()
            self._lineage.clear()
            self._visitor_logs.clear()
            self._task_promises.clear()
            self._design_edges.clear()
            self.anomalies.clear()
            for item in state.get("avs", []):
                self.restore_av(item)
            for v in state.get("visits", []):
                self.restore_visit(v)
            for t, p in (state.get("tasks") or {}).items():
                self._task_promises[t] = dict(p)
            for e in state.get("edges", []):
                self._design_edges.add(tuple(e))
            for a in state.get("anomalies", []):
                self.anomalies.append(dict(a))
            self._next_seq = max(self._next_seq, int(state.get("next_seq", 0)))

    # -- story 1: traveller log ----------------------------------------------
    def traveller_log(self, av_uid: str) -> list:
        """Full journey of one artifact: every stamp, in order."""
        with self._lock:
            av = self._avs[av_uid]
            return [s.to_record() for s in av.travel_document]

    def lineage(self, av_uid: str, depth: int = -1) -> dict:
        """Recursive forensic reconstruction: which AVs (and software
        versions) led to this outcome — the paper's 'which changes triggered
        the recomputation / which versions were involved'.

        A memoized AV (one minted by a cache hit) carries a ``memo_of``
        pointer to the AV the *original* run produced; the node includes that
        run's lineage too, so a short-circuited result reconstructs exactly
        like a computed one."""
        with self._lock:
            av = self._avs[av_uid]
            node = {
                "uid": av_uid,
                "source_task": av.source_task,
                "software_version": next(
                    (s.software_version for s in av.travel_document if s.event == "produced"),
                    "?",
                ),
                "chash": av.chash,
                "parents": [],
            }
            if av.meta.get("cache_hit"):
                node["cache_hit"] = True
            if depth != 0:
                for p in self._lineage.get(av_uid, []):
                    if p in self._avs:
                        node["parents"].append(self.lineage(p, depth - 1))
                memo_of = av.meta.get("memo_of")
                if memo_of and memo_of in self._avs:
                    node["memo_of"] = self.lineage(memo_of, depth - 1)
            return node

    # -- story 2: checkpoint visitor log --------------------------------------
    def visitor_log(self, task: str) -> list:
        with self._lock:
            return [e.to_record() for e in self._visitor_logs[task]]

    def visits_of(self, av_uid: str) -> list:
        """All checkpoints an AV passed through (cross-task query), in event
        order. Ordered by the monotonic ``seq`` — two visits in one clock
        tick used to tie-break arbitrarily on the timestamp float."""
        out = []
        with self._lock:
            for task, entries in self._visitor_logs.items():
                for e in entries:
                    if e.av_uid == av_uid:
                        out.append(e.to_record())
        return sorted(out, key=lambda r: r["seq"])

    # -- story 3: design map ---------------------------------------------------
    def design_map(self) -> dict:
        """Topology + promises + anomalies (the invariant concept map)."""
        with self._lock:
            return {
                "tasks": {t: dict(p) for t, p in self._task_promises.items()},
                "edges": sorted(self._design_edges),
                "anomalies": [dict(a) for a in self.anomalies],
            }

    def design_map_text(self) -> str:
        """Paper fig. 10 rendering: '(a) --b(precedes)--> \"b\"'."""
        with self._lock:
            edges = sorted(self._design_edges)
        lines = ["<begin NON-LOCAL CAUSE>"]
        for src, rel, dst in edges:
            lines.append(f'({src}) --b({rel})--> "{dst}"')
        lines.append("<end NON-LOCAL CAUSE>")
        return "\n".join(lines)

    # -- misc ------------------------------------------------------------------
    def overhead_bytes(self) -> int:
        """Metadata footprint — supports the paper's 'cheap to keep' claim."""
        n = 0
        with self._lock:
            for av in self._avs.values():
                n += len(json.dumps(av.to_record(), default=repr))
            for entries in self._visitor_logs.values():
                for e in entries:
                    n += len(json.dumps(e.to_record()))
        return n

    def all_avs(self) -> list:
        with self._lock:
            return list(self._avs)

    def get_av(self, uid: str) -> AnnotatedValue:
        with self._lock:
            return self._avs[uid]

"""Durable provenance journal — crash-safe persistence for the three
forensic stories (paper §III.C / §III.L), at production scale.

The paper's enterprise claim is "full tracing of provenance and forensic
reconstruction of transactional processes", but a registry that lives only
in process memory forgets everything on restart. This module is the fix: an
**append-only on-disk JSONL event log** that the :class:`ProvenanceRegistry`,
:class:`MemoCache`, and :class:`TransferLedger` write through. One typed
record per event:

  ========== ==========================================================
  kind       emitted by
  ========== ==========================================================
  meta       Journal itself (file header: workspace name, format version)
  task       ProvenanceRegistry.register_task   (design-map promises)
  edge       ProvenanceRegistry.add_design_edge (design-map topology)
  av         ProvenanceRegistry.register_av     (travel documents + lineage)
  visit      ProvenanceRegistry.log_visit       (checkpoint visitor logs)
  anomaly    ProvenanceRegistry.record_anomaly
  retired    ProvenanceRegistry.retire_avs      (forensic-horizon trims)
  cache_hit  MemoCache.lookup                   (memo short-circuits)
  memo       MemoCache.insert                   (memo table contents)
  topology   PipelineManager                    (zone/tier/link-cost spec)
  ledger     TransferLedger                     (residency + byte charges)
  scale      AdaptiveExecutor                   (pool-resize decisions)
  checkpoint Journal.compact                    (folded-history snapshot)
  ========== ==========================================================

Every record carries a **monotonically increasing global sequence number**
(``seq``) — not a wall-clock float — so replays order events exactly as the
run emitted them, regardless of clock granularity. Writes are buffered and
fsync'd every ``flush_every_n`` records (the durability/throughput knob), so
the hot path stays cheap; ``close()``/``flush()`` force the tail out.

Production scale is the **segment chain**. A long-running sensor pipeline
appending one JSONL forever pays O(lifetime) on every restart; instead the
journal *rotates*: when the live file crosses ``rotate_bytes`` /
``rotate_records`` (``KOALJA_JOURNAL_ROTATE`` bytes; default off) it is
renamed to a numbered segment ``<path>.000N`` and a fresh live file
continues the same global seq. :func:`Journal.compact` then folds the
rotated history — superseded ledger charges, re-announced topology specs,
overwritten memo entries, retired AVs and their stale visits — into one
``checkpoint`` snapshot record (``<path>.ckpt-<seq>``), written
new-file-then-``os.replace`` so a crash at any byte offset leaves a
replayable chain, and garbage-collects the folded segments. Replay cost
becomes *last checkpoint + tail* — proportional to live state, not history.

Crash safety is the append-only contract: a process killed mid-write leaves
at most one torn final line per file, which :func:`read_records` detects and
drops. :func:`replay_journal` then rebuilds a fresh registry (and, when a
topology record is present, a transfer ledger) from the intact prefix of
the whole chain, so ``lineage()`` / ``visitor_log()`` / ``design_map()`` /
ledger stats answer identically to the pre-crash process.
``Workspace.from_journal(path)`` is the user-facing rehydrator.
"""

from __future__ import annotations

import dataclasses
import json
import os
import re
import threading
import time
from typing import Any, Iterable, Optional

FORMAT_VERSION = 1

# rotated segments: <path>.0001, <path>.0002, ... (live tail is <path>)
_SEGMENT_RE = re.compile(r"\.(\d{4,})$")
# checkpoint snapshots: <path>.ckpt-<upto_seq>; *.tmp are in-flight writes
_CHECKPOINT_RE = re.compile(r"\.ckpt-(\d+)$")


class JournalCorruptError(ValueError):
    """A journal line *before* the final one failed to parse — the file was
    edited or damaged, not merely torn by a crash."""


# One shared encoder instance: json.dumps() with non-default arguments
# constructs a fresh JSONEncoder per call, which costs more than the
# encode itself for hot-path-sized records.
_ENCODER = json.JSONEncoder(separators=(",", ":"), default=repr).encode
# record kinds are literal identifiers (visit/av/ledger/...); anything that
# would need escaping inside the template's "kind" slot takes the slow path.
# Kinds seen to match are memoized — the engine uses fewer than a dozen.
_SAFE_KIND_RE = re.compile(r"^[A-Za-z0-9_.-]+$")
_SAFE_KINDS: set = set()


def encode_record(seq: int, kind: str, data: dict) -> str:
    """One journal line (no trailing newline), byte-identical to the earlier
    ``json.dumps(..., default=repr, separators=(",", ":"))`` call. The
    wrapper object is assembled by template (int seq and identifier kinds
    never need escaping) so only ``data`` goes through the encoder — and
    through a shared instance, not a per-call ``json.dumps``. Record
    constructors already emit canonical key order (dataclass field order for
    visits/AVs, literal order everywhere else), so there is no per-record
    ``sort_keys`` re-sort on the hot path."""
    if type(seq) is int and (
        kind in _SAFE_KINDS or _SAFE_KIND_RE.match(kind)
    ):
        _SAFE_KINDS.add(kind)
        return '{"seq":%d,"kind":"%s","data":%s}' % (seq, kind, _ENCODER(data))
    return json.dumps(
        {"seq": seq, "kind": kind, "data": data},
        default=repr,
        separators=(",", ":"),
    )


class _StagingWindow:
    """Reentrant per-thread batching window for :meth:`Journal.staging`."""

    __slots__ = ("_journal", "_outermost")

    def __init__(self, journal: "Journal") -> None:
        self._journal = journal
        self._outermost = False

    def __enter__(self) -> "_StagingWindow":
        tl = self._journal._staging
        if getattr(tl, "buf", None) is None:
            tl.buf = []
            self._outermost = True
        return self

    def __exit__(self, exc_type, exc, tb) -> None:
        if not self._outermost:
            return
        tl = self._journal._staging
        buf, tl.buf = tl.buf, None
        if buf:
            self._journal.append_batch(buf)


def _rotate_bytes_env() -> Optional[int]:
    """Parse ``KOALJA_JOURNAL_ROTATE`` (a byte threshold; off by default).
    Raises at construction on a non-integer value, naming the knob."""
    v = os.environ.get("KOALJA_JOURNAL_ROTATE", "").strip().lower()
    if v in ("", "0", "false", "no", "off"):
        return None
    try:
        n = int(v)
    except ValueError:
        raise ValueError(
            f"KOALJA_JOURNAL_ROTATE={v!r} is not a rotation threshold "
            "(expected a byte count integer, or 0/off to disable)"
        ) from None
    return n if n > 0 else None


def discover_chain(path: str) -> dict:
    """Enumerate the on-disk segment chain of a journal base path:
    rotated segments (ascending), checkpoint files (newest first), and
    whether the live tail exists. ``*.tmp`` checkpoint writes that a crash
    abandoned mid-compaction are ignored (they were never renamed into the
    chain)."""
    path = str(path)
    parent = os.path.dirname(os.path.abspath(path)) or "."
    base = os.path.basename(path)
    segments: list = []
    checkpoints: list = []
    if os.path.isdir(parent):
        for name in os.listdir(parent):
            if not name.startswith(base + "."):
                continue
            suffix = name[len(base):]
            m = _SEGMENT_RE.fullmatch(suffix)
            if m:
                segments.append((int(m.group(1)), os.path.join(parent, name)))
                continue
            m = _CHECKPOINT_RE.fullmatch(suffix)
            if m:
                checkpoints.append((int(m.group(1)), os.path.join(parent, name)))
    segments.sort()
    checkpoints.sort(reverse=True)
    return {
        "live": path if os.path.exists(path) else None,
        "segments": [p for _, p in segments],
        "segment_indices": [i for i, _ in segments],
        "checkpoints": [p for _, p in checkpoints],
    }


def _load_checkpoint(path: str) -> Optional[dict]:
    """Read one checkpoint file; returns its single ``checkpoint`` record or
    None if the file is unreadable/torn (the atomic-rename protocol never
    produces one, but discovery stays defensive)."""
    try:
        records, _ = read_records(path)
    except (OSError, JournalCorruptError):
        return None
    for r in records:
        if r.get("kind") == "checkpoint" and isinstance(r.get("data"), dict):
            return r
    return None


def read_chain(path: str) -> tuple:
    """Parse a journal's whole segment chain: best checkpoint (if any) +
    every record *after* it from rotated segments and the live tail, in seq
    order. A torn final line is tolerated per file — a crash can tear the
    tail of whichever file was being written, including a segment later
    stranded by a mid-compaction kill. Returns ``(records, truncated,
    info)`` where ``info`` describes the chain (files read, checkpoint
    used, fold boundary)."""
    chain = discover_chain(path)
    ck_rec = None
    ck_path = None
    for p in chain["checkpoints"]:
        ck_rec = _load_checkpoint(p)
        if ck_rec is not None:
            ck_path = p
            break
    upto = int(ck_rec["data"].get("upto_seq", -1)) if ck_rec else -1
    records: list = [ck_rec] if ck_rec else []
    truncated = 0
    files = [ck_path] if ck_path else []
    for f in chain["segments"] + ([chain["live"]] if chain["live"] else []):
        rs, tr = read_records(f)
        truncated += tr
        # a checkpoint covers everything at or below its fold boundary;
        # segments left behind by a crash between rename and GC replay as
        # harmless no-ops because every record they hold is filtered here
        records.extend(r for r in rs if int(r.get("seq", -1)) > upto)
        files.append(f)
    records.sort(key=lambda r: int(r.get("seq", -1)))
    info = {
        "files": files,
        "checkpoint": ck_path,
        "checkpoint_data": ck_rec["data"] if ck_rec else None,
        "upto_seq": upto,
        "segments": len(chain["segments"]) + (1 if chain["live"] else 0),
        "checkpoints": len(chain["checkpoints"]),
    }
    return records, truncated, info


class Journal:
    """Append-only JSONL event log with batched fsync, segment rotation,
    and checkpoint compaction.

    Thread-safe: producers (registry, cache, ledger — possibly on concurrent
    wave workers) serialize through one lock, which is also what makes the
    global ``seq`` a total order over events.
    """

    def __init__(
        self,
        path: str,
        flush_every_n: Optional[int] = None,
        workspace: str = "",
        segment: Optional[str] = None,
        rotate_bytes: Optional[int] = None,
        rotate_records: Optional[int] = None,
        seq_source: Optional["Journal"] = None,
    ) -> None:
        self.path = str(path)
        # Non-None marks this file as a *segment* of a parent journal (one
        # per remote zone runner): its records carry seqs reserved from the
        # parent's global sequence space, and merge_segments later folds the
        # files back into one totally-ordered stream. The segment's own meta
        # header is bookkeeping, not history — merges drop it.
        self.segment = segment
        # Non-None delegates sequence-number assignment to another journal
        # (multi-tenant hubs: every per-tenant journal draws seqs from the
        # hub journal's one counter via ``reserve``, so records across all
        # tenant files form a single total order while each tenant's file
        # stays strictly its own history). Lock order is always
        # tenant-journal -> source-journal; the source never calls back.
        self._seq_source = seq_source
        self._workspace = workspace
        if flush_every_n is None:
            flush_every_n = int(os.environ.get("KOALJA_JOURNAL_FLUSH", "64"))
        self.flush_every_n = max(1, int(flush_every_n))
        # Rotation thresholds: cross either and the live file is renamed to
        # <path>.000N, a fresh tail continuing the same seq space. Explicit
        # kwargs win; otherwise KOALJA_JOURNAL_ROTATE (bytes) decides.
        if rotate_bytes is None and rotate_records is None:
            rotate_bytes = _rotate_bytes_env()
        self.rotate_bytes = int(rotate_bytes) if rotate_bytes else None
        self.rotate_records = int(rotate_records) if rotate_records else None
        self._lock = threading.Lock()
        # Per-thread staging buffer (see staging()): while active, append()
        # enqueues instead of writing, and the context exit flushes the whole
        # firing through append_batch under ONE lock acquisition.
        self._staging = threading.local()
        self.records_written = 0
        self.flushes = 0
        self.encode_wall_s = 0.0  # cumulative record-encode time (stats())
        self.rotations = 0
        self.compactions = 0
        # cumulative across the journal's lifetime (reseeded from the
        # checkpoint on resume — the checkpoint carries the totals)
        self.records_compacted = 0
        self.bytes_reclaimed = 0
        self._pending = 0
        self.closed = False
        parent = os.path.dirname(os.path.abspath(self.path))
        os.makedirs(parent, exist_ok=True)
        # Resume an existing journal after its last intact record — scanning
        # the FULL chain (checkpoint + rotated segments + live tail), not
        # just the newest file: the seq must stay monotonic across restarts
        # for replays to stay ordered, and the highest seq may live in a
        # rotated segment when the live tail is young.
        self._next_seq = 0
        # Highest visitor-entry seq already on disk (chain-wide): a resuming
        # registry seeds its event counter past this, so entry seqs stay a
        # total order across restarts too (visits_of sorts by them).
        self.resumed_visit_seq = -1
        self._live_records = 0
        self._live_start_seq = 0
        chain = discover_chain(self.path)
        self._rotation_index = (
            max(chain["segment_indices"]) + 1 if chain["segment_indices"] else 1
        )
        fresh = (
            (chain["live"] is None or os.path.getsize(self.path) == 0)
            and not chain["segments"]
            and not chain["checkpoints"]
        )
        if not fresh:
            records, _, info = read_chain(self.path)
            if records:
                self._next_seq = max(int(r.get("seq", -1)) for r in records) + 1
                self.resumed_visit_seq = max(
                    (
                        int(r["data"]["seq"])
                        for r in records
                        if r.get("kind") == "visit"
                        and isinstance(r.get("data"), dict)
                        and "seq" in r["data"]
                    ),
                    default=-1,
                )
            ck = info.get("checkpoint_data")
            if ck:
                # folded visitor entries don't appear as records anymore;
                # the checkpointed registry counter carries their high water
                reg_state = ck.get("registry") or {}
                self.resumed_visit_seq = max(
                    self.resumed_visit_seq, int(reg_state.get("next_seq", 0)) - 1
                )
                self.records_compacted = int(ck.get("records_compacted", 0))
                self.bytes_reclaimed = int(ck.get("bytes_reclaimed", 0))
                self.compactions = int(ck.get("compactions", 0))
            if chain["live"] is not None:
                live_records, live_truncated = read_records(self.path)
                self._live_records = len(live_records)
                self._live_start_seq = (
                    int(live_records[0].get("seq", 0))
                    if live_records
                    else self._next_seq
                )
                if live_truncated:
                    # Drop the torn tail *before* reopening for append: 'a'
                    # mode would glue the next record onto the partial line,
                    # losing it (or corrupting every later record) on the
                    # next replay.
                    self._truncate_to_intact_prefix()
            else:
                self._live_start_seq = self._next_seq
        self._fh = open(self.path, "a", encoding="utf-8")
        if fresh:
            meta = {
                "workspace": workspace,
                "format": FORMAT_VERSION,
                "created_at": time.time(),
            }
            if segment is not None:
                meta["segment"] = segment
            self.append("meta", meta)

    def _truncate_to_intact_prefix(self) -> None:
        """Cut the file back to the end of its last whole, parseable line
        (callers have already established the damage is only a torn tail)."""
        with open(self.path, "rb") as fh:
            blob = fh.read()
        good = 0
        for line in blob.splitlines(keepends=True):
            if not line.endswith(b"\n"):
                break
            if line.strip():
                try:
                    json.loads(line)
                except json.JSONDecodeError:
                    break
            good += len(line)
        if good < len(blob):
            with open(self.path, "r+b") as fh:
                fh.truncate(good)

    def _fsync_dir(self) -> None:
        """fsync the containing directory so renames (rotation, checkpoint
        publication) survive a power cut, not just process death."""
        try:
            fd = os.open(os.path.dirname(os.path.abspath(self.path)) or ".", os.O_RDONLY)
            try:
                os.fsync(fd)
            finally:
                os.close(fd)
        except OSError:  # pragma: no cover - platform-dependent
            pass

    # -- write path ---------------------------------------------------------
    def reserve(self, n: int) -> int:
        """Claim ``n`` consecutive sequence numbers without writing records;
        returns the first. A parent journal reserves a window per remote
        firing and ships it with the work order — the zone runner writes the
        records (with those seqs) into its own *segment* file, and the
        merge re-establishes the total order. Gaps from failed/retried
        remote work are harmless: replay orders by seq, it never requires
        density."""
        with self._lock:
            if self.closed:
                raise ValueError(f"journal {self.path} is closed")
            if self._seq_source is not None:
                start = self._seq_source.reserve(n)
                self._next_seq = max(self._next_seq, start + max(0, int(n)))
                return start
            start = self._next_seq
            self._next_seq += max(0, int(n))
            return start

    def append(self, kind: str, data: dict, seq: Optional[int] = None) -> int:
        """Append one typed record; returns its global sequence number.

        ``seq`` overrides the auto-assigned number — segment journals write
        records under sequence numbers their parent reserved, so the merged
        stream stays a total order across processes.

        Inside a :meth:`staging` window the record is enqueued on the
        calling thread's buffer instead (flushed as one batch at window
        exit) and ``-1`` is returned — every engine write-through ignores
        the return value."""
        buf = getattr(self._staging, "buf", None)
        if buf is not None:
            buf.append((kind, data, seq))
            return -1
        with self._lock:
            if self.closed:
                raise ValueError(f"journal {self.path} is closed")
            out = self._append_locked(kind, data, seq)
            self._maybe_rotate_locked()
            return out

    def append_batch(self, records: Iterable[tuple]) -> list:
        """Append many records under **one** lock acquisition: seqs are
        assigned monotonically in order, every line is encoded into one
        ``"\\n".join``-ed buffer, the file sees one ``write``, and the
        flush/fsync and rotation thresholds are consulted once per batch
        instead of once per record. Each item is ``(kind, data)`` or
        ``(kind, data, seq)``; returns the assigned seqs."""
        records = list(records)
        if not records:
            return []
        with self._lock:
            if self.closed:
                raise ValueError(f"journal {self.path} is closed")
            t0 = time.perf_counter()
            seqs: list = []
            lines: list = []
            # Delegated seq space: claim the whole batch's numbers from the
            # source in ONE reserve call, so a firing's records stay
            # contiguous in the hub's total order and the source lock is
            # taken once per batch, not once per record.
            delegated = iter(())
            if self._seq_source is not None:
                need = sum(
                    1 for rec in records if len(rec) == 2 or rec[2] is None
                )
                if need:
                    base = self._seq_source.reserve(need)
                    delegated = iter(range(base, base + need))
            for rec in records:
                if len(rec) == 3:
                    kind, data, seq = rec
                else:
                    kind, data = rec
                    seq = None
                if seq is None:
                    seq = next(delegated, None)
                    if seq is None:
                        seq = self._next_seq
                        self._next_seq += 1
                    else:
                        self._next_seq = max(self._next_seq, seq + 1)
                else:
                    self._next_seq = max(self._next_seq, seq + 1)
                lines.append(encode_record(seq, kind, data))
                seqs.append(seq)
            self.encode_wall_s += time.perf_counter() - t0
            self._fh.write("\n".join(lines) + "\n")
            n = len(lines)
            self.records_written += n
            self._live_records += n
            self._pending += n
            if self._pending >= self.flush_every_n:
                self._flush_locked()
            self._maybe_rotate_locked()
            return seqs

    def staging(self):
        """Context manager that batches this thread's appends: while active,
        :meth:`append` enqueues onto a thread-local buffer, and exit flushes
        the buffer through :meth:`append_batch` (one lock, one encode buffer,
        one write/fsync decision). The engine wraps each task firing in a
        staging window so a firing's records — visits, AVs, ledger charges,
        memo inserts — land as one fused batch. Nested windows join the
        outermost one; flush happens even if the body raises, so anomaly
        records from a failing firing still reach disk."""
        return _StagingWindow(self)

    def _append_locked(self, kind: str, data: dict, seq: Optional[int] = None) -> int:
        if seq is None:
            if self._seq_source is not None:
                seq = self._seq_source.reserve(1)
                self._next_seq = max(self._next_seq, seq + 1)
            else:
                seq = self._next_seq
                self._next_seq += 1
        else:
            self._next_seq = max(self._next_seq, seq + 1)
        t0 = time.perf_counter()
        line = encode_record(seq, kind, data)
        self.encode_wall_s += time.perf_counter() - t0
        self._fh.write(line + "\n")
        self.records_written += 1
        self._live_records += 1
        self._pending += 1
        if self._pending >= self.flush_every_n:
            self._flush_locked()
        return seq

    def _maybe_rotate_locked(self) -> None:
        if self.rotate_bytes is None and self.rotate_records is None:
            return
        # never rotate a file down to just-a-header: a pathological
        # threshold must not spin out empty segments
        if self._live_records < 2:
            return
        over = (
            self.rotate_records is not None
            and self._live_records >= self.rotate_records
        )
        if not over and self.rotate_bytes is not None:
            over = self._fh.tell() >= self.rotate_bytes
        if over:
            self._rotate_locked()

    def _rotate_locked(self) -> Optional[str]:
        """Seal the live file as the next numbered segment and start a fresh
        tail (with a continuation header) under the same seq space. Returns
        the sealed segment's path, or None if the live file had no records."""
        if self._live_records == 0:
            return None
        self._flush_locked()
        self._fh.close()
        idx = self._rotation_index
        self._rotation_index += 1
        target = f"{self.path}.{idx:04d}"
        os.replace(self.path, target)
        self._fsync_dir()
        self._fh = open(self.path, "a", encoding="utf-8")
        self.rotations += 1
        self._live_records = 0
        self._pending = 0
        self._live_start_seq = self._next_seq
        header = {
            "workspace": self._workspace,
            "format": FORMAT_VERSION,
            "rotated_from": idx,
        }
        if self.segment is not None:
            header["segment"] = self.segment
        self._append_locked("meta", header)
        return target

    def rotate(self) -> Optional[str]:
        """Force a rotation now (used by compaction to make the fold
        boundary 'everything so far'); no-op on an empty live file."""
        with self._lock:
            if self.closed:
                raise ValueError(f"journal {self.path} is closed")
            return self._rotate_locked()

    # -- compaction ---------------------------------------------------------
    def compact(
        self,
        segment_paths: Iterable[str] = (),
        archive_dir: Optional[str] = None,
        fault: Optional[Any] = None,
    ) -> dict:
        """Fold all rotated history into one checkpoint snapshot record, so
        replay = last checkpoint + live tail.

        Superseded records collapse into state: thousands of ``ledger``
        charges become per-pair byte totals, re-announced ``topology`` specs
        and resumed ``task``/``edge`` registrations dedup, overwritten
        ``memo`` entries keep only the last record (expired ones are purged),
        and AVs retired by :meth:`ProvenanceRegistry.retire_avs` — dropped
        travellers, store-evicted payloads, aged-out ``[N/k]`` window
        members — vanish along with their stale visits and the ``retired``
        markers themselves.

        ``segment_paths`` are per-zone runner segment files (multi-process
        runs): their records at or below the fold boundary are folded into
        the checkpoint too (minus revoked windows), after which
        :func:`merge_segments` drops them as already-covered. Call at
        quiescence — between drains — so no reserved seq window is still in
        flight below the boundary.

        Atomicity: the checkpoint is written to a ``.tmp`` file, fsync'd,
        then published with one ``os.replace``; folded segments and older
        checkpoints are garbage-collected only after the rename (or moved
        into ``archive_dir`` when given — the cold-tier/oracle hook). A
        crash at any byte offset leaves a replayable chain: before the
        rename the old chain is intact (the ``.tmp`` is ignored), after it
        the leftover segments replay as no-ops below the boundary.

        ``fault`` is a test hook: called with a stage name at each crash
        window (``fold``, ``pre-rename``, ``post-rename``, ``mid-gc``,
        ``post-gc``); raising from it simulates dying there.
        """
        fault = fault or (lambda stage: None)
        with self._lock:
            if self.closed:
                raise ValueError(f"journal {self.path} is closed")
            if self.segment is not None:
                raise ValueError(
                    f"journal {self.path} is a zone segment — segments are "
                    "merged by the parent, never compacted in place"
                )
            self._rotate_locked()  # fold boundary = everything before the tail
            boundary = self._live_start_seq
            chain = discover_chain(self.path)
            if not chain["segments"] and not chain["checkpoints"]:
                return {"checkpoint": None, "noop": True}
            ck_rec = None
            for p in chain["checkpoints"]:
                ck_rec = _load_checkpoint(p)
                if ck_rec is not None:
                    break
            prev = ck_rec["data"] if ck_rec else {}
            prev_upto = int(prev.get("upto_seq", -1))
            records: list = [ck_rec] if ck_rec else []
            folded_raw = 0
            for f in chain["segments"]:
                rs, _ = read_records(f)
                kept = [r for r in rs if int(r.get("seq", -1)) > prev_upto]
                records.extend(kept)
                folded_raw += len(kept)
            # revoked windows void zone-segment records a dead runner left
            # behind; the set rides the checkpoint so later merges can still
            # drop orphans below the boundary
            revoked = {int(s) for s in prev.get("revoked", [])}
            for r in records:
                if r.get("kind") == "revoked":
                    d = r.get("data") or {}
                    start = int(d.get("start", 0))
                    revoked.update(range(start, start + int(d.get("count", 0))))
            for seg in segment_paths:
                seg_chain = discover_chain(seg)
                for f in seg_chain["segments"] + (
                    [seg_chain["live"]] if seg_chain["live"] else []
                ):
                    rs, _ = read_records(f)
                    kept = [
                        r
                        for r in rs
                        if r.get("kind") not in ("meta", "checkpoint")
                        and prev_upto < int(r.get("seq", -1)) < boundary
                        and int(r.get("seq", -1)) not in revoked
                    ]
                    records.extend(kept)
                    folded_raw += len(kept)
            records.sort(key=lambda r: int(r.get("seq", -1)))
            fault("fold")
            rep = _apply_records(records, 0)
            counts = dict(rep.counts)
            counts.pop("checkpoint", None)
            doomed = list(chain["checkpoints"]) + list(chain["segments"])
            reclaim = sum(
                os.path.getsize(f) for f in doomed if os.path.exists(f)
            )
            upto = boundary - 1
            data = {
                "upto_seq": upto,
                "workspace": rep.workspace or self._workspace,
                "registry": rep.registry.snapshot_state(),
                "topology": rep.topology.describe() if rep.topology else None,
                "ledger": rep.ledger.snapshot_state() if rep.ledger else None,
                "cache": rep.cache.snapshot_state() if rep.cache else None,
                "counts": counts,
                "revoked": sorted(s for s in revoked if s <= upto),
                "records_compacted": self.records_compacted + folded_raw,
                "bytes_reclaimed": self.bytes_reclaimed + reclaim,
                "compactions": self.compactions + 1,
                "compacted_at": time.time(),
            }
            final = f"{self.path}.ckpt-{upto}"
            tmp = final + ".tmp"
            with open(tmp, "w", encoding="utf-8") as fh:
                fh.write(
                    json.dumps(
                        {"seq": upto, "kind": "checkpoint", "data": data},
                        default=repr,
                        separators=(",", ":"),
                    )
                    + "\n"
                )
                fh.flush()
                os.fsync(fh.fileno())
            fault("pre-rename")
            os.replace(tmp, final)
            self._fsync_dir()
            fault("post-rename")
            removed = 0
            for f in doomed:
                try:
                    if archive_dir is not None and _SEGMENT_RE.search(f):
                        os.makedirs(archive_dir, exist_ok=True)
                        os.replace(
                            f, os.path.join(archive_dir, os.path.basename(f))
                        )
                    else:
                        os.unlink(f)
                    removed += 1
                except OSError:  # pragma: no cover - GC is best-effort
                    pass
                fault("mid-gc")
            self._fsync_dir()
            fault("post-gc")
            self.compactions = data["compactions"]
            self.records_compacted = data["records_compacted"]
            self.bytes_reclaimed = data["bytes_reclaimed"]
            return {
                "checkpoint": final,
                "upto_seq": upto,
                "records_folded": folded_raw,
                "segments_removed": removed,
                "bytes_reclaimed": reclaim,
                "avs_live": len(data["registry"].get("avs", [])),
            }

    def _flush_locked(self) -> None:
        self._fh.flush()
        os.fsync(self._fh.fileno())
        self.flushes += 1
        self._pending = 0

    def flush(self) -> None:
        """Force buffered records to disk (flush + fsync)."""
        with self._lock:
            if not self.closed and self._pending:
                self._flush_locked()

    def close(self) -> None:
        with self._lock:
            if self.closed:
                return
            if self._pending:
                self._flush_locked()
            self._fh.close()
            self.closed = True

    def __del__(self) -> None:  # journals are per-workspace; don't leak fds
        try:
            self.close()
        except Exception:
            pass

    # -- introspection ------------------------------------------------------
    def chain_files(self) -> list:
        """Every live file of the on-disk chain: best-first checkpoints,
        rotated segments, and the live tail."""
        chain = discover_chain(self.path)
        return (
            list(chain["checkpoints"])
            + list(chain["segments"])
            + ([chain["live"]] if chain["live"] else [])
        )

    def stats(self) -> dict:
        with self._lock:
            if not self.closed:
                self._fh.flush()  # so bytes_on_disk reflects buffered writes
            chain = discover_chain(self.path)
            files = (
                list(chain["checkpoints"])
                + list(chain["segments"])
                + ([chain["live"]] if chain["live"] else [])
            )
            return {
                "path": self.path,
                "records_written": self.records_written,
                # the whole chain, not just the live tail: rotated segments
                # and checkpoints are as much "the journal" as the tail is
                "bytes_on_disk": sum(
                    os.path.getsize(f) for f in files if os.path.exists(f)
                ),
                "flushes": self.flushes,
                "flush_every_n": self.flush_every_n,
                "encode_wall_s": self.encode_wall_s,
                "next_seq": self._next_seq,
                "segments": len(chain["segments"])
                + (1 if chain["live"] else 0),
                "checkpoints": len(chain["checkpoints"]),
                "rotations": self.rotations,
                "compactions": self.compactions,
                "records_compacted": self.records_compacted,
                "bytes_reclaimed": self.bytes_reclaimed,
            }

    def __repr__(self) -> str:
        return (
            f"Journal({self.path!r}, records={self.records_written}, "
            f"flush_every_n={self.flush_every_n})"
        )


# ---------------------------------------------------------------------------
# read / replay
# ---------------------------------------------------------------------------


def read_records(path: str) -> tuple:
    """Parse a journal file, tolerating a torn final line.

    Returns ``(records, truncated)`` where ``truncated`` counts dropped
    trailing partial lines (0 or 1 — the most a crash mid-``write`` can
    leave). A malformed line *followed by intact ones* is real corruption
    and raises :class:`JournalCorruptError`.
    """
    records: list = []
    truncated = 0
    with open(path, "r", encoding="utf-8") as fh:
        lines = fh.read().split("\n")
    last = max(
        (i for i, line in enumerate(lines) if line.strip()), default=-1
    )
    for i, line in enumerate(lines):
        if not line.strip():
            continue
        try:
            records.append(json.loads(line))
        except json.JSONDecodeError:
            if i == last:
                truncated = 1  # torn tail from a crash mid-append
                break
            raise JournalCorruptError(
                f"{path}:{i + 1}: unparseable journal line before end of file"
            ) from None
    return records, truncated


@dataclasses.dataclass
class ReplayedJournal:
    """Result of :func:`replay_journal`: a fresh registry (and ledger, when
    the run had a topology) rebuilt from the intact journal prefix."""

    registry: Any
    ledger: Any = None
    topology: Any = None
    cache: Any = None
    workspace: str = ""
    records: int = 0
    truncated: int = 0
    counts: dict = dataclasses.field(default_factory=dict)
    # AdaptiveExecutor pool-resize decisions, in journal order — the
    # autoscaling story replays alongside the provenance it never affects
    scales: list = dataclasses.field(default_factory=list)
    # segment-chain provenance of the replay itself
    segments: int = 1
    checkpoints: int = 0
    records_compacted: int = 0

    def __repr__(self) -> str:
        return (
            f"ReplayedJournal(workspace={self.workspace!r}, "
            f"records={self.records}, truncated={self.truncated}, "
            f"counts={self.counts})"
        )


def _segment_files(seg: str) -> list:
    """A zone segment plus its own rotated parts (segments rotate under the
    same env knob as the main journal)."""
    chain = discover_chain(seg)
    return chain["segments"] + ([chain["live"]] if chain["live"] else [])


def _merged(path: str, segment_paths: Iterable[str]) -> tuple:
    records, truncated, info = read_chain(path)
    upto = int(info.get("upto_seq", -1))
    ck = info.get("checkpoint_data") or {}
    revoked: set = {int(s) for s in ck.get("revoked", [])}
    seg_batches = []
    for seg in segment_paths:
        for f in _segment_files(seg):
            seg_records, seg_truncated = read_records(f)
            truncated += seg_truncated
            seg_batches.append(seg_records)
    # Sweep revocation markers from *every* file before filtering any:
    # in a multi-tenant hub merge the segments are themselves per-tenant
    # journals, and it is the tenant (not the hub) that revoked its dead
    # runners' windows.
    for batch in [records] + seg_batches:
        for r in batch:
            if r.get("kind") == "revoked":
                d = r.get("data") or {}
                start = int(d.get("start", 0))
                revoked.update(range(start, start + int(d.get("count", 0))))
    for seg_records in seg_batches:
        records.extend(
            r
            for r in seg_records
            if r.get("kind") not in ("meta", "checkpoint")
            and int(r.get("seq", -1)) not in revoked
            and int(r.get("seq", -1)) > upto
        )
    records.sort(key=lambda r: int(r.get("seq", -1)))
    return records, truncated, info


def merge_segments(path: str, segment_paths: Iterable[str]) -> tuple:
    """Fold one or more runner *segment* files back into the main journal's
    record stream, ordered by the global ``seq`` protocol.

    Each zone runner wrote its records under sequence numbers the parent
    reserved from one shared counter, so sorting the union by ``seq``
    reconstructs the exact total order a single-process run would have
    journaled. Segment ``meta`` headers are per-file bookkeeping (their
    seq 0 would collide with the main header) and are dropped. A torn tail
    in any file — main or segment — is tolerated per-file, exactly like
    :func:`read_records` on a single journal.

    The *main* side is read as a full chain: rotated segments, live tail,
    and — when the main journal has been compacted — its best checkpoint.
    Zone-segment records at or below the checkpoint's fold boundary were
    folded into the checkpoint by :meth:`Journal.compact` and are dropped
    here as already-covered.

    ``revoked`` records in the main journal (or the revoked set a
    checkpoint carries forward) void a seq window: a runner that died
    mid-flight may have appended records for a firing the parent then
    retried under fresh seqs, and replaying both copies would duplicate
    AVs. Segment records whose seq falls in a revoked window are dropped
    (the revocation marker itself carries no registry state).

    Returns ``(records, truncated)`` where ``truncated`` sums the dropped
    torn lines across all files.
    """
    records, truncated, _ = _merged(path, segment_paths)
    return records, truncated


def replay_segments(path: str, segment_paths: Iterable[str]) -> ReplayedJournal:
    """Rebuild provenance state from a main journal plus its runner
    segments: :func:`merge_segments` then the same record application as
    :func:`replay_journal`. The result's ``lineage`` / ``visits_of`` /
    ledger answers match the live multi-process registry — and the
    single-process oracle."""
    records, truncated, info = _merged(path, segment_paths)
    return _apply_records(records, truncated, chain=info)


def replay_journal(path: str) -> ReplayedJournal:
    """Rebuild provenance state from a journal's segment chain.

    Replays the best checkpoint (if the journal has been compacted) and
    every intact record after it, in sequence order, into a fresh
    :class:`~repro_torch.core.provenance.ProvenanceRegistry` — and, if the run
    recorded a ``topology`` spec, into a fresh
    :class:`~repro_torch.topology.TransferLedger` — so the three forensic stories
    and the transfer scorecard answer exactly as the writing process would
    have. The replayed objects carry **no** journal binding: rehydration
    never re-journals history.
    """
    records, truncated, info = read_chain(path)
    return _apply_records(records, truncated, chain=info)


def replay_files(paths: Iterable[str]) -> ReplayedJournal:
    """Replay an explicit list of journal files — no chain discovery, no
    checkpoint required: read each (torn tails tolerated), union, order by
    seq, apply. This is the *uncompacted oracle* primitive: replaying every
    archived segment (``compact(archive_dir=...)``) plus the live tail
    reconstructs full history for byte-identical comparison against a
    checkpointed replay. Files must share one seq space (one journal's
    chain) — zone segment files belong in :func:`replay_segments` instead."""
    records: list = []
    truncated = 0
    for p in paths:
        rs, tr = read_records(p)
        records.extend(rs)
        truncated += tr
    records.sort(key=lambda r: int(r.get("seq", -1)))
    return _apply_records(records, truncated)


def _apply_records(records: list, truncated: int, chain: Optional[dict] = None) -> ReplayedJournal:
    from repro_torch.core.provenance import ProvenanceRegistry

    registry = ProvenanceRegistry()
    ledger = topology = cache = None
    workspace = ""
    counts: dict = {}
    scales: list = []
    records_compacted = 0
    for rec in records:
        kind = rec.get("kind")
        data = rec.get("data") or {}
        counts[kind] = counts.get(kind, 0) + 1
        if kind == "meta":
            workspace = data.get("workspace") or workspace
        elif kind == "checkpoint":
            # folded history: restore state wholesale instead of replaying
            # the records the fold superseded
            workspace = data.get("workspace") or workspace
            registry.restore_state(data.get("registry") or {})
            if data.get("topology"):
                from repro_torch.topology import Topology, TransferLedger

                topology = Topology.from_spec(data["topology"])
                ledger = TransferLedger(topology)
                if data.get("ledger"):
                    ledger.restore_state(data["ledger"])
            if data.get("cache"):
                from repro_torch.cache import MemoCache

                cache = MemoCache()
                cache.restore_state(data["cache"])
            for k, v in (data.get("counts") or {}).items():
                counts[k] = counts.get(k, 0) + int(v)
            records_compacted = int(data.get("records_compacted", 0))
        elif kind == "task":
            registry.register_task(
                data["task"], data["inputs"], data["outputs"], data["version"]
            )
        elif kind == "edge":
            registry.add_design_edge(data["src"], data["relation"], data["dst"])
        elif kind == "av":
            registry.restore_av(data)
        elif kind == "visit":
            registry.restore_visit(data)
        elif kind == "anomaly":
            registry.restore_anomaly(data)
        elif kind == "retired":
            registry.restore_retired(data)
        elif kind == "memo":
            if cache is None:
                from repro_torch.cache import MemoCache

                cache = MemoCache()
            cache.restore_entry(
                data["key"], data.get("record"), data.get("expires_at")
            )
        elif kind == "topology":
            from repro_torch.topology import Topology, TransferLedger

            new_topo = Topology.from_spec(data)
            if topology is None or new_topo.describe() != topology.describe():
                topology = new_topo
                ledger = TransferLedger(topology)
            # else: a resumed run re-announced the same spec — keep the
            # ledger charges accumulated from the pre-restart records
        elif kind == "ledger" and ledger is not None:
            if data.get("op") == "resident":
                ledger.register_resident(data["chash"], data["zone"])
            elif data.get("op") == "materialize":
                ledger.on_materialize(
                    data["chash"], int(data["nbytes"]), data["src"], data["dst"]
                )
            elif data.get("op") == "execute":
                ledger.on_execute(data["zone"], int(data["nbytes"]))
            elif data.get("op") == "zone_local":
                ledger.credit_zone_local(
                    data["chash"], int(data["nbytes"]), data["zone"]
                )
        elif kind == "scale":
            scales.append(dict(data))
        # cache_hit records are counted (counts) but carry no registry state:
        # the memo short-circuit already journaled its visitor-log entries.
    return ReplayedJournal(
        registry=registry,
        ledger=ledger,
        topology=topology,
        cache=cache,
        workspace=workspace,
        records=len(records),
        truncated=truncated,
        counts=counts,
        scales=scales,
        segments=(chain or {}).get("segments", 1),
        checkpoints=(chain or {}).get("checkpoints", 0),
        records_compacted=records_compacted,
    )

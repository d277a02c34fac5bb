"""Tenant determinism fingerprint — the isolation test's measuring stick.

``tenant_fingerprint(ws)`` serializes one workspace's complete forensic
story (AV graph, visitor logs, promises, design edges, anomalies, transfer
ledger) as canonical JSON, with every run-incidental quantity scrubbed:

* **uids** — AV uid numbers come from a process-global counter, so two
  tenants interleaving on one hub draw different numbers than a solo run
  would. Every uid reference (lineage parents, visit subjects, ``memo_of``
  pointers) is rewritten to the AV's *content hash*, which is identical
  wherever the bytes came from.
* **timestamps / wall clocks** — AV ``created_at``, stamp and visit
  timestamps, and ``wall=…`` notes vary per run; dropped or starred.
* **storage URIs** — artifacts identify by content hash; the URI *scheme*
  (``local://`` vs ``object://``) records which store tier a copy landed
  in, which on a shared hub depends on whether another tenant's identical
  bytes already occupied a tier at adoption time. Placement is a store
  artifact, not tenant provenance, so AV rows carry the chash only.
* **global event seqs** — visitor entries serialize as *per-task* logs in
  seq order, without the seq values. Within one task the event stream is
  totally ordered and backend-invariant; the cross-task interleaving is a
  wave-scheduling detail (thread pools race it, zoned executors partition
  waves by zone) that the engine's own determinism contract
  (``tests/test_topology._fingerprint``) likewise excludes.

What remains is exactly the paper's three provenance stories plus the
sustainability ledger — the content a tenant could subpoena. The tenancy
property test asserts this string is **byte-identical** between a tenant's
run on a shared hub and the same session script on a private solo hub,
under every executor backend.

Port of ``repro.tenancy.fingerprint``: the same string for the same session
script through either package.
"""

from __future__ import annotations

import json
import re


_UID_RE = re.compile(r"av-\d{8}-[0-9a-f]+")


def _scrub_note(note: str, uid_chash: dict) -> str:
    if note.startswith("wall="):
        return "wall=*"
    note = re.sub(r"pid=\d+", "pid=*", note)
    # uid references embedded in notes (e.g. ``memo_of=av-…``) rewrite to
    # the referenced AV's content hash, like every other uid in the doc
    return _UID_RE.sub(lambda m: uid_chash.get(m.group(0), "?"), note)


def _journey(stamps: list, uid_chash: dict) -> list:
    """Registration-time view of a travel document: stamps up to and
    including ``produced``. Later stamps (``consumed``, ``transit``) are
    link/task-side mutations that happen wherever the consumer ran — a
    worker process mutates its own copy — so they are neither
    backend-invariant nor journaled; the visitor log carries the
    consumption story instead."""
    out = []
    for s in stamps:
        out.append(
            [
                s["task"],
                s["event"],
                s["software_version"],
                s.get("region", "local"),
                _scrub_note(s.get("note", ""), uid_chash),
            ]
        )
        if s["event"] == "produced":
            break
    return out


def tenant_fingerprint(ws) -> str:
    """Canonical, uid-free, clock-free serialization of one workspace's
    forensic + ledger state. Works on live and journal-rehydrated
    workspaces alike (both expose a registry and a ledger)."""
    state = ws.registry.snapshot_state()
    uid_chash = {item["av"]["uid"]: item["av"]["chash"] for item in state["avs"]}

    def ref(uid):
        if uid == "-":
            return "-"
        return uid_chash.get(uid, "?")

    avs = []
    for item in state["avs"]:
        rec = item["av"]
        meta = dict(rec.get("meta") or {})
        if "memo_of" in meta:
            meta["memo_of"] = ref(meta["memo_of"])
        avs.append(
            {
                "task": rec["source_task"],
                "chash": rec["chash"],
                "region": rec.get("region", "local"),
                "meta": meta,
                "journey": _journey(rec.get("travel_document", []), uid_chash),
                "parents": [ref(p) for p in item.get("parents", [])],
            }
        )
    avs.sort(key=lambda row: json.dumps(row, sort_keys=True))
    # Per-task visitor logs: within a task the event stream is totally
    # ordered and backend-invariant; the global cross-task interleaving is
    # a wave-scheduling artifact and deliberately excluded (see module doc).
    visits: dict = {}
    for v in state["visits"]:
        visits.setdefault(v["task"], []).append(
            [
                ref(v["av_uid"]),
                v["event"],
                v["software_version"],
                _scrub_note(v.get("note", ""), uid_chash),
            ]
        )
    anomalies = sorted(
        (
            {"task": a.get("task"), "note": _scrub_note(a.get("note", ""), uid_chash)}
            for a in state.get("anomalies", [])
        ),
        key=lambda row: json.dumps(row, sort_keys=True),
    )
    ledger = None
    try:
        led = ws.ledger
    except Exception:
        led = None
    if led is not None:
        ledger = led.stats()
    doc = {
        "avs": avs,
        "visits": visits,
        "tasks": state.get("tasks") or {},
        "edges": state.get("edges") or [],
        "anomalies": anomalies,
        "ledger": ledger,
    }
    return json.dumps(doc, sort_keys=True, separators=(",", ":"))

"""Worker-process side of the multi-process runtime.

One forked child per :class:`WorkerProcess` handle. The protocol over the
pipe is deliberately narrow — pickled dicts via ``send_bytes``/``recv_bytes``
(framed, so control-plane bytes are exactly countable) — and **never carries
payloads**: requests ship the plan's reference view
(:meth:`~repro_torch.core.task.ExecutionPlan.snapshot_refs`), replies ship
per-output ``(uri, chash, nbytes, existed)`` specs. The payload channel is
the store's shared object directory.

Request kinds:

  ==========  ===========================================================
  op          semantics
  ==========  ===========================================================
  ping        liveness probe; replies with the worker pid
  exec        run one task's user fn; export outputs; reply specs only
              (flat pool — the parent mints all provenance afterwards)
  exec_zoned  ``exec`` plus zone-runner provenance: mint output AVs and
              visitor entries inside the parent-reserved uid/seq window,
              append them to this runner's journal *segment*, stream the
              typed records back for the parent to restore verbatim
  stop        acknowledge and exit cleanly
  ==========  ===========================================================

Fork discipline: the parent flushes its journal before every spawn (a
buffered line must not be double-written by two processes), and the child's
first act is to *neutralize* every inherited journal binding — close the fd,
mark the journal closed, unhook registry/cache/ledger write-through — so the
only file a child ever appends to is its own segment.

Port of ``repro.runtime.worker``. The child's start-up also drops torch's
intra-op pool to one thread: a child forked after the parent's OpenMP pool
has run would otherwise hang at its first parallel op, since the pool's
threads were not forked with it. A child never touches CUDA: plans with a
card tensor among their inputs run in the parent
(:func:`repro_torch.runtime.process._plan_on_card`), and CUDA raises in a
forked child.
"""

from __future__ import annotations

import os
import pickle
import time
import traceback
from typing import Optional

import torch

from repro_torch.core.av import AnnotatedValue, is_ghost
from repro_torch.core.hashing import content_hash_batch
from repro_torch.core.provenance import VisitorEntry

try:
    from multiprocessing import get_context

    _CTX = get_context("fork")
except (ImportError, ValueError):  # pragma: no cover - non-POSIX platforms
    _CTX = None


def fork_context():
    """The ``fork`` multiprocessing context, or ``None`` where the platform
    has no fork. Fork is required (not preferred): task functions are
    arbitrary closures — lambdas, locally-defined fns — which ``spawn``
    could never pickle. Callers degrade to inline execution on ``None``."""
    return _CTX


# Parent-side pipe ends currently open, module-global so a newly forked
# child can close the copies it inherited: a sibling worker holding the
# write end of another worker's pipe would keep that pipe from EOF-ing
# when its owner dies, breaking crash detection.
_OPEN_PARENT_CONNS: list = []

# seconds a stopping worker is given to answer and to exit
_STOP_GRACE_S = 2


def _send(conn, obj) -> int:
    blob = pickle.dumps(obj, protocol=4)
    conn.send_bytes(blob)
    return len(blob)


def _recv(conn) -> tuple:
    blob = conn.recv_bytes()
    return pickle.loads(blob), len(blob)


class WorkerProcess:
    """Parent-side handle on one forked worker: the pipe, the process, and
    the control-plane byte counters (which is all that ever crosses)."""

    def __init__(
        self,
        manager,
        worker_id,
        segment_path: Optional[str] = None,
        segment_zone: Optional[str] = None,
    ) -> None:
        ctx = fork_context()
        if ctx is None:
            raise RuntimeError(
                "repro_torch.runtime requires the 'fork' start method (POSIX only)"
            )
        if manager.journal is not None:
            # buffered journal lines must reach disk before the fork — the
            # child closes its inherited fd without flushing, and a line
            # held in both copies of the buffer would otherwise double-write
            manager.journal.flush()
        parent_conn, child_conn = ctx.Pipe()
        self.conn = parent_conn
        _OPEN_PARENT_CONNS.append(parent_conn)
        self.proc = ctx.Process(
            target=_child_main,
            args=(child_conn, manager, segment_path, segment_zone),
            daemon=True,
            name=f"koalja-worker-{worker_id}",
        )
        self.proc.start()
        child_conn.close()
        self.worker_id = worker_id
        self.pid = self.proc.pid
        self.segment_path = segment_path
        self.bytes_sent = 0
        self.bytes_received = 0
        self.requests = 0

    # -- control plane -------------------------------------------------------
    def send(self, msg: dict) -> None:
        self.requests += 1
        self.bytes_sent += _send(self.conn, msg)

    def recv(self) -> dict:
        msg, n = _recv(self.conn)
        self.bytes_received += n
        return msg

    def call(self, msg: dict) -> dict:
        self.send(msg)
        return self.recv()

    # -- lifecycle -----------------------------------------------------------
    def alive(self) -> bool:
        return self.proc.is_alive()

    def kill(self) -> None:
        """SIGKILL the worker (crash cleanup and chaos testing)."""
        try:
            self.proc.kill()
        except Exception:
            pass
        self.proc.join(timeout=5)
        self._close()

    def stop(self) -> None:
        """Graceful shutdown: stop request, short grace, then terminate. The
        stop reply is awaited for the grace period only, so a hung worker
        cannot hold up shutdown."""
        try:
            self.send({"op": "stop"})
            if self.conn.poll(_STOP_GRACE_S):
                self.recv()
        except Exception:
            pass
        self.proc.join(timeout=_STOP_GRACE_S)
        if self.proc.is_alive():
            self.proc.terminate()
            self.proc.join(timeout=_STOP_GRACE_S)
        self._close()

    def _close(self) -> None:
        try:
            self.conn.close()
        except Exception:
            pass
        try:
            _OPEN_PARENT_CONNS.remove(self.conn)
        except ValueError:
            pass

    def __repr__(self) -> str:
        return (
            f"WorkerProcess({self.worker_id!r}, pid={self.pid}, "
            f"alive={self.alive()})"
        )


# ---------------------------------------------------------------------------
# child side
# ---------------------------------------------------------------------------


def _neutralize_journal(manager) -> None:
    """Disarm every inherited journal binding in a freshly forked child: the
    parent's journal file has exactly one writer (the parent), and nothing
    in the child — registry, memo cache, transfer ledger — may write
    through. The fd is closed raw (no flush: the parent flushed pre-fork,
    and a racing buffer copy must not be written twice)."""
    journal = getattr(manager, "journal", None)
    if journal is not None:
        try:
            os.close(journal._fh.fileno())
        except Exception:
            pass
        journal.closed = True
    registry = getattr(manager, "registry", None)
    if registry is not None:
        registry._journal = None
    for holder in (getattr(manager, "cache", None), getattr(manager, "ledger", None)):
        if holder is not None and hasattr(holder, "_journal"):
            holder._journal = None


def _neutralize_threads() -> None:
    """Run torch's CPU ops on the calling thread in a freshly forked child:
    the inherited OpenMP pool has no threads behind it after the fork."""
    torch.set_num_threads(1)


def _child_main(conn, manager, segment_path, segment_zone) -> None:
    # Close inherited parent-side pipe ends (this worker's own and any
    # earlier siblings'): see _OPEN_PARENT_CONNS.
    for c in list(_OPEN_PARENT_CONNS):
        try:
            c.close()
        except Exception:
            pass
    _OPEN_PARENT_CONNS.clear()
    _neutralize_journal(manager)
    _neutralize_threads()
    segment = None
    if segment_path is not None:
        from repro_torch.provenance import Journal

        # flush_every_n=1: a record is durable before the reply that
        # references it leaves this process — "parent saw the outcome"
        # implies "the segment holds its records", even if this runner is
        # later killed without a clean stop.
        segment = Journal(
            segment_path,
            flush_every_n=1,
            workspace=getattr(manager.pipeline, "name", ""),
            segment=segment_zone,
        )
    pid = os.getpid()
    while True:
        try:
            msg, _ = _recv(conn)
        except (EOFError, OSError):
            break
        op = msg.get("op")
        if op == "stop":
            try:
                _send(conn, {"ok": True})
            except Exception:
                pass
            break
        try:
            if op == "ping":
                reply = {"ok": True, "pid": pid, "zone": segment_zone}
            elif op == "exec":
                reply = {"ok": True, "result": _execute_request(manager, msg)}
            elif op == "exec_zoned":
                reply = {"ok": True, "result": _execute_zoned(manager, msg, segment)}
            else:
                reply = {"ok": False, "error": f"unknown op {op!r}"}
        except BaseException as exc:
            reply = {"ok": False, "error": traceback.format_exc(), "exc": exc}
        try:
            _send(conn, reply)
        except (EOFError, OSError, BrokenPipeError):
            break
        except Exception:
            # reply not picklable (exotic exception / ghost spec): degrade
            # to the traceback string so the parent still gets an answer
            fallback = {
                "ok": False,
                "error": reply.get("error") or "worker reply was not picklable",
            }
            try:
                _send(conn, fallback)
            except Exception:
                break
    if segment is not None:
        try:
            segment.close()
        except Exception:
            pass
    try:
        conn.close()
    except Exception:
        pass
    os._exit(0)


def _resolve(store, ref: dict):
    """Materialize one shipped reference: ghosts resolve from metadata
    (zero bytes, ever); real artifacts pin into this worker's private local
    tier from the shared object directory the parent published into."""
    uri = ref["uri"]
    if uri.startswith("ghost://"):
        return (ref.get("meta") or {}).get("ghost_spec")
    return store.get(store.pin_local(uri, region=ref.get("region")))


def _normalize_result(task, result):
    # same contract checks as SmartTask.finish_execution — fail here, in the
    # worker, so the parent-side retry machinery never sees a malformed
    # outcome as a crash
    if not isinstance(result, dict):
        if len(task.outputs) != 1:
            raise TypeError(
                f"task {task.name} returned a single value but declares "
                f"outputs {task.outputs}"
            )
        result = {task.outputs[0]: result}
    missing = set(task.outputs) - set(result)
    if missing:
        raise KeyError(f"task {task.name} missing outputs {sorted(missing)}")
    return result


def _execute_request(manager, msg: dict) -> dict:
    """Run one task's user fn against a shipped reference snapshot; export
    outputs to the shared object tier; reply with specs only."""
    task = manager.pipeline.tasks[msg["task"]]
    task.zone = msg.get("zone")  # placement was decided on the parent
    kwargs = {}
    for name, val in msg["snapshot"].items():
        if isinstance(val, list):
            kwargs[name] = [_resolve(manager.store, r) for r in val]
        else:
            kwargs[name] = _resolve(manager.store, val)
    svc_base = {n: len(s.frozen_responses) for n, s in task.services.items()}
    for sname, svc in task.services.items():
        kwargs[sname] = svc
    t0 = time.perf_counter()
    result = task.fn(**kwargs)
    dt = time.perf_counter() - t0
    result = _normalize_result(task, result)
    # hash the whole firing's outputs in one fused call, then export the
    # non-ghosts as a batch with the digests precomputed (hash work is not
    # repeated inside the store)
    payloads = [result[oname] for oname in task.outputs]
    hashes = content_hash_batch(payloads)
    ghost_flags = [is_ghost(p) for p in payloads]
    exported = iter(
        manager.store.export_batch(
            [p for p, g in zip(payloads, ghost_flags) if not g],
            hashes=[h for h, g in zip(hashes, ghost_flags) if not g],
        )
    )
    outputs = {}
    for oname, payload, chash, ghost in zip(task.outputs, payloads, hashes, ghost_flags):
        if ghost:
            outputs[oname] = {
                "ghost": True,
                "chash": chash,
                "ghost_spec": payload,
            }
        else:
            uri, chash, nbytes, existed = next(exported)
            outputs[oname] = {
                "uri": uri,
                "chash": chash,
                "nbytes": int(nbytes),
                "existed": bool(existed),
            }
    services = {
        n: task.services[n].frozen_responses[base:]
        for n, base in svc_base.items()
        if len(task.services[n].frozen_responses) > base
    }
    return {"task": task.name, "outputs": outputs, "wall_s": dt, "services": services}


def _execute_zoned(manager, msg: dict, segment) -> dict:
    """``exec`` plus zone-runner provenance: mint the output AVs and visitor
    entries inside the uid/seq window the parent reserved, append each
    record (under its reserved global seq) to this runner's segment, and
    stream the records back for verbatim restoration.

    Record layout per firing — exactly the journal shape an in-process run
    writes, so the seq-ordered merge is indistinguishable from one:
    ``visit(executed)`` then, per output, ``av`` + ``visit(emitted)``;
    1 + 2·n_outputs journal seqs, 1 + n_outputs visitor seqs, n_outputs
    uid numbers."""
    base = _execute_request(manager, msg)
    task = manager.pipeline.tasks[msg["task"]]
    zone = msg.get("zone")
    uid_nos = list(msg["uid_nos"])
    vseq = int(msg["visit_seq"])
    jseq = msg.get("journal_seq")
    records: list = []

    def emit_record(kind: str, data: dict) -> None:
        nonlocal jseq
        seq = None
        if jseq is not None:
            seq = jseq
            jseq += 1
            if segment is not None:
                segment.append(kind, data, seq=seq)
        records.append({"seq": seq, "kind": kind, "data": data})

    entry = VisitorEntry(
        task=task.name,
        av_uid="-",
        event="executed",
        timestamp=time.time(),
        software_version=task.version,
        note=f"wall={base['wall_s']:.6f}s",
        seq=vseq,
    )
    emit_record("visit", entry.to_record())
    parents = list(msg.get("parent_uids", []))
    for i, oname in enumerate(task.outputs):
        spec = base["outputs"][oname]
        if spec.get("ghost"):
            meta = {"ghost": True, "ghost_spec": spec.get("ghost_spec")}
            if zone is not None:
                meta["zone"] = zone
            av = AnnotatedValue.produce(
                spec["chash"],
                f"ghost://{spec['chash']}",
                task.name,
                task.version,
                region=task.region,
                meta=meta,
                uid_no=uid_nos[i],
            )
        else:
            meta = None
            if zone is not None:
                meta = {"zone": zone, "nbytes": spec["nbytes"]}
            av = AnnotatedValue.produce(
                spec["chash"],
                spec["uri"],
                task.name,
                task.version,
                region=task.region,
                meta=meta,
                uid_no=uid_nos[i],
            )
        emit_record("av", {"av": av.to_record(), "parents": parents})
        entry = VisitorEntry(
            task=task.name,
            av_uid=av.uid,
            event="emitted",
            timestamp=time.time(),
            software_version=task.version,
            seq=vseq + 1 + i,
        )
        emit_record("visit", entry.to_record())
        spec["uid"] = av.uid
    base["records"] = records
    return base

"""ZoneRunner + ZonedProcessExecutor — remote runners per extended-cloud zone.

Where :class:`~repro_torch.runtime.process.ProcessExecutor` is a flat pool, this
backend promotes each :class:`~repro_torch.topology.Topology` zone to its own
**runner process** — the in-machine stand-in for dispatching a zone's
partition to that zone's physical site. On first use the executor extracts
every zone's partition (:func:`~repro_torch.topology.extract_partitions`) and
journals it as a typed ``partition`` record: the deployment story survives
the processes.

Provenance is minted *where the work runs*. Each remote firing carries a
parent-reserved window — ``1 + 2·n_outputs`` global journal seqs
(``Journal.reserve``), ``1 + n_outputs`` visitor-log seqs
(``ProvenanceRegistry.reserve_seqs``), and ``n_outputs`` AV uid numbers
(``reserve_uid_numbers``) — so the runner's records are born with their
final position in the global order. The runner appends them to its own
journal *segment* file (``<journal>.seg-<zone>``) and streams them back;
the parent restores them verbatim (``restore_av`` / ``restore_visit``,
which never re-journal). :func:`repro_torch.provenance.replay_segments` later
merges main + segments by seq into a registry identical to the live one —
and to the single-process oracle. The merge is chain-aware on both sides:
a rotated main journal (numbered segments + live tail + best checkpoint)
and rotated zone segments replay the same stream, and zone records already
folded into a main checkpoint by ``Journal.compact`` are dropped as
covered.

Crash story: a runner killed mid-flight may have already appended records
for firings the parent will retry under *fresh* reservations. The parent
therefore appends a ``revoked`` record (the dead window) to the main
journal; the segment merge drops revoked seqs, so the merged history holds
each firing exactly once — no lost, no duplicated AVs.

Port of ``repro.runtime.zoned``: a plan with a card tensor among its inputs
runs in the parent, as in :class:`~repro_torch.runtime.process.ProcessExecutor`.
"""

from __future__ import annotations

import os
import re
from typing import Optional

from repro_torch.core.av import reserve_uid_numbers
from repro_torch.topology import extract_partitions
from repro_torch.workspace.executors import InlineExecutor

from .process import _DEAD, ProcessExecutor, _publish_inputs, _remote_eligible
from .worker import WorkerProcess, fork_context


class ZoneRunner:
    """One remote runner process hosting a topology zone's partition."""

    def __init__(self, manager, zone: str, partition, segment_path) -> None:
        self.zone = zone
        self.partition = partition
        self.segment_path = segment_path
        self.worker = WorkerProcess(
            manager,
            worker_id=f"zone-{zone}",
            segment_path=segment_path,
            segment_zone=zone,
        )
        self.firings = 0

    def describe(self) -> dict:
        return {
            "zone": self.zone,
            "pid": self.worker.pid,
            "alive": self.worker.alive(),
            "segment": self.segment_path,
            "firings": self.firings,
            "tasks": list(self.partition.tasks) if self.partition else [],
        }

    def __repr__(self) -> str:
        return f"ZoneRunner({self.zone!r}, pid={self.worker.pid})"


class ZonedProcessExecutor(InlineExecutor):
    """Partition each wave by zone and run every partition in that zone's
    runner process. ``KOALJA_EXECUTOR=zoned-process`` selects it.

    Single-task waves stay inline (the ConcurrentExecutor precedent — no
    pipe hop for pull-mode nodes), and circuits without a topology degrade
    to a flat :class:`ProcessExecutor` pool: the zone concept needs zones.
    Zone groups dispatch in topology declaration order and results return
    in wave order, so merge-FCFS arrival seqs — and the whole determinism
    fingerprint — stay bit-identical to the in-process backends.
    """

    def __init__(
        self,
        topology=None,
        *,
        max_workers: int = 8,
        retry_budget: int = 2,
    ) -> None:
        super().__init__()
        self.topology = topology
        self.max_workers = int(max_workers)
        self.retry_budget = max(0, int(retry_budget))
        self._manager = None
        self._runners: dict = {}  # zone -> ZoneRunner
        self._flat: Optional[ProcessExecutor] = None  # topology-less fallback
        self.partitions: dict = {}
        self.zone_waves: dict = {}  # zone -> {"waves": n, "tasks": n}
        self.tasks_remote = 0
        self.tasks_inline = 0
        self.worker_restarts = 0
        self.retries = 0
        self.inline_fallbacks = 0
        self.revoked_windows = 0
        self._retired_bytes_sent = 0
        self._retired_bytes_received = 0

    # -- runner fleet --------------------------------------------------------
    def _prepare(self, manager, topo) -> None:
        if self._manager is manager:
            return
        if self._manager is not None:
            self.shutdown()
        manager.store.ensure_object_dir()
        self._manager = manager
        # the deployment snapshot: one partition per zone, journaled so a
        # replay can answer "which tasks were shipped where"
        self.partitions = extract_partitions(topo, manager.pipeline)
        if manager.journal is not None:
            for zone in topo.zone_names():
                manager.journal.append(
                    "partition", self.partitions[zone].describe()
                )

    @staticmethod
    def _segment_path(journal, zone: str) -> Optional[str]:
        if journal is None:
            return None
        safe = re.sub(r"[^A-Za-z0-9_.-]", "-", zone)
        return f"{journal.path}.seg-{safe}"

    def _runner(self, manager, zone: str) -> ZoneRunner:
        r = self._runners.get(zone)
        if r is None or not r.worker.alive():
            if r is not None:
                self._retire(zone)
            r = ZoneRunner(
                manager,
                zone,
                self.partitions.get(zone),
                self._segment_path(manager.journal, zone),
            )
            self._runners[zone] = r
        return r

    def _retire(self, zone: str) -> None:
        r = self._runners.pop(zone, None)
        if r is None:
            return
        self._retired_bytes_sent += r.worker.bytes_sent
        self._retired_bytes_received += r.worker.bytes_received
        r.worker.kill()
        self.worker_restarts += 1

    def kill_runner(self, zone: str) -> bool:
        """Chaos/test helper: SIGKILL one zone's runner process."""
        r = self._runners.get(zone)
        if r is not None and r.worker.alive():
            r.worker.proc.kill()
            r.worker.proc.join(timeout=5)
            return True
        return False

    def segment_paths(self) -> list:
        """Every segment *base* path the runner fleet has written (for
        ``replay_segments`` / ``Workspace.from_journal([main, *segments])``
        / ``Journal.compact``). Base paths, not files: a long-lived zone
        segment rotates under ``KOALJA_JOURNAL_ROTATE`` just like the main
        journal, and the chain-aware readers expand each base into its
        rotated parts + live tail."""
        from repro_torch.provenance import discover_chain

        out = []
        if self._manager is not None and self._manager.journal is not None:
            for zone in sorted(self.partitions):
                path = self._segment_path(self._manager.journal, zone)
                if path is None:
                    continue
                chain = discover_chain(path)
                if chain["live"] or chain["segments"]:
                    out.append(path)
        return out

    def runners(self) -> dict:
        return {z: r.describe() for z, r in sorted(self._runners.items())}

    def shutdown(self) -> None:
        for zone in list(self._runners):
            r = self._runners.pop(zone)
            self._retired_bytes_sent += r.worker.bytes_sent
            self._retired_bytes_received += r.worker.bytes_received
            r.worker.stop()
        if self._flat is not None:
            self._flat.shutdown()
        self._manager = None

    def __del__(self) -> None:
        try:
            for r in self._runners.values():
                r.worker.kill()
        except Exception:
            pass

    # -- wave execution ------------------------------------------------------
    def run_wave(self, manager, tasks: list) -> list:
        topo = self.topology or getattr(manager, "topology", None)
        if fork_context() is None:
            return super().run_wave(manager, tasks)
        if topo is None:
            # flat circuit: no zones to partition by — behave as a pool
            if self._flat is None:
                self._flat = ProcessExecutor(
                    max_workers=self.max_workers, retry_budget=self.retry_budget
                )
            self.waves_run += 1
            return self._flat.run_wave(manager, tasks)
        if len(tasks) <= 1:
            for t in tasks:
                zone = t.zone or topo.default_zone
                zw = self.zone_waves.setdefault(zone, {"waves": 0, "tasks": 0})
                zw["waves"] += 1
                zw["tasks"] += 1
            return super().run_wave(manager, tasks)
        self._prepare(manager, topo)
        self.waves_run += 1
        results: dict = {}
        pending: list = []
        for t in tasks:
            status, payload = t.begin_execution(
                manager.store, manager.registry, manager.cache
            )
            if status == "hit":
                results[t.name] = payload
            else:
                pending.append((t, payload))
        # group by zone, in topology declaration order (the ZonedExecutor
        # convention — partition order must not leak downstream)
        groups: dict = {}
        for t, plan in pending:
            groups.setdefault(t.zone or topo.default_zone, []).append((t, plan))
        order = {z: i for i, z in enumerate(topo.zone_names())}
        zones = sorted(groups, key=lambda z: (order.get(z, len(order)), z))
        remote_items: list = []
        for zone in zones:
            zw = self.zone_waves.setdefault(zone, {"waves": 0, "tasks": 0})
            zw["waves"] += 1
            zw["tasks"] += len(groups[zone])
            for t, plan in groups[zone]:
                if _remote_eligible(manager.store, plan):
                    remote_items.append((zone, t, plan))
        outcomes, errors = self._run_remote(manager, remote_items)
        if errors:
            task_name, exc, tb = errors[0]
            if exc is not None:
                raise exc
            raise RuntimeError(
                f"task {task_name!r} failed in zone runner:\n{tb}"
            )
        remote_names = {t.name for _z, t, _p in remote_items}
        for t, plan in pending:
            outcome = outcomes.get(t.name)
            if outcome is not None:
                results[t.name] = self._adopt(manager, t, plan, outcome)
                self.tasks_remote += 1
            else:
                if t.name in remote_names:
                    self.inline_fallbacks += 1
                result, dt = t.run_user_fn(plan, manager.store)
                results[t.name] = t.finish_execution(
                    plan, result, dt, manager.store, manager.registry,
                    manager.cache, emit=False,
                )
                self.tasks_inline += 1
        return [(t.name, results[t.name]) for t in tasks]

    # -- remote protocol -----------------------------------------------------
    def _make_request(self, manager, t, plan) -> tuple:
        """Reserve this firing's seq/uid windows and build the work order.
        Reservations happen at dispatch, on the scheduler thread, in
        deterministic (zone-group, wave) order."""
        n_out = len(t.outputs)
        jseq = None
        if manager.journal is not None:
            jseq = manager.journal.reserve(1 + 2 * n_out)
        vseq = manager.registry.reserve_seqs(1 + n_out)
        uid_nos = reserve_uid_numbers(n_out)
        req = {
            "op": "exec_zoned",
            "task": t.name,
            "zone": t.zone,
            "snapshot": plan.snapshot_refs(),
            "parent_uids": list(plan.parent_uids),
            "uid_nos": uid_nos,
            "visit_seq": vseq,
            "journal_seq": jseq,
        }
        return req, {"jseq": jseq, "count": 1 + 2 * n_out}

    def _revoke(self, manager, task_name: str, resv) -> None:
        """Void a dead runner's reserved journal window: it may have
        appended records for a firing the parent is about to retry under
        fresh seqs, and the merge must not resurrect them."""
        if resv is None or resv.get("jseq") is None or manager.journal is None:
            return
        manager.journal.append(
            "revoked",
            {"task": task_name, "start": resv["jseq"], "count": resv["count"]},
        )
        self.revoked_windows += 1

    def _run_remote(self, manager, items: list) -> tuple:
        """items: ``[(zone, task, plan)]`` in dispatch order. Same retry
        contract as ProcessExecutor._run_remote, plus per-casualty
        revocation of the reserved journal windows."""
        outcomes: dict = {t.name: None for _z, t, _p in items}
        errors: list = []
        if not items:
            return outcomes, errors
        for _z, _t, plan in items:
            _publish_inputs(manager.store, plan)
        todo = list(items)
        attempts = {t.name: 0 for _z, t, _p in items}
        while todo:
            by_zone: dict = {}
            for zone, t, plan in todo:
                by_zone.setdefault(zone, []).append((t, plan))
            retry: list = []
            sent: dict = {}
            runners: dict = {}
            reservations: dict = {}
            for zone, batch in by_zone.items():
                r = self._runner(manager, zone)
                runners[zone] = r
                ssent: list = []
                for t, plan in batch:
                    req, resv = self._make_request(manager, t, plan)
                    reservations[t.name] = resv
                    try:
                        r.worker.send(req)
                        ssent.append((t, plan))
                    except _DEAD:
                        break
                sent[zone] = ssent
            for zone, batch in by_zone.items():
                r = runners[zone]
                answered = 0
                for t, _plan in sent[zone]:
                    try:
                        reply = r.worker.recv()
                    except _DEAD:
                        break
                    answered += 1
                    if reply.get("ok"):
                        outcomes[t.name] = reply["result"]
                        r.firings += 1
                    else:
                        self._revoke(manager, t.name, reservations.get(t.name))
                        errors.append(
                            (t.name, reply.get("exc"), reply.get("error", ""))
                        )
                casualties = sent[zone][answered:] + batch[len(sent[zone]):]
                if casualties:
                    pid = r.worker.pid
                    self._retire(zone)
                    for t, plan in casualties:
                        attempts[t.name] += 1
                        self._revoke(manager, t.name, reservations.get(t.name))
                        manager.registry.record_anomaly(
                            t.name,
                            f"worker_died zone={zone} pid={pid} "
                            f"attempt={attempts[t.name]}",
                        )
                        if attempts[t.name] <= self.retry_budget:
                            self.retries += 1
                            retry.append((zone, t, plan))
            todo = retry
        return outcomes, errors

    def _adopt(self, manager, t, plan, outcome: dict) -> dict:
        """Complete a zone-remote firing in the parent: restore the runner's
        streamed records verbatim, then replicate the non-registry side
        effects (ledger charges, counters, store adoption, memo insert) in
        exactly ``finish_execution``'s order."""
        t.account_remote_inputs(manager.store, plan)
        for sname, calls in (outcome.get("services") or {}).items():
            svc = t.services.get(sname)
            if svc is not None:
                svc.frozen_responses.extend(calls)
        t.executions += 1
        if t.zone is not None:
            t.zone_executions[t.zone] = t.zone_executions.get(t.zone, 0) + 1
        # the runner's forked ledger is invisible here: replicate the
        # compute-account charge exactly like account_remote_inputs does
        # for the transfer charges (finish_remote's order)
        t._charge_compute(manager.store, plan)
        for rec in outcome.get("records", ()):
            if rec["kind"] == "av":
                manager.registry.restore_av(rec["data"])
            elif rec["kind"] == "visit":
                manager.registry.restore_visit(rec["data"])
        out_avs, outputs_rec, out_uids, out_nbytes = {}, {}, {}, {}
        any_ghost = False
        for oname in t.outputs:
            spec = outcome["outputs"][oname]
            av = manager.registry.get_av(spec["uid"])
            if spec.get("ghost"):
                any_ghost = True
            else:
                nbytes = int(spec["nbytes"])
                manager.store.adopt(
                    spec["chash"], nbytes, existed=spec.get("existed", False)
                )
                if t.ledger is not None:
                    t.ledger.register_resident(spec["chash"], t.zone)
                outputs_rec[oname] = (spec["uri"], spec["chash"])
                out_uids[oname] = av.uid
                out_nbytes[oname] = nbytes
            out_avs[oname] = av
        if plan.use_cache and manager.cache is not None and not any_ghost:
            from repro_torch.cache import make_record

            manager.cache.insert(
                plan.key,
                make_record(
                    t.version, outputs_rec, out_uids, out_nbytes,
                    birth_zone=t.zone,
                ),
                ttl_s=t.cache_ttl_s,
            )
        return out_avs

    # -- introspection -------------------------------------------------------
    def stats(self) -> dict:
        out = super().stats()
        sent, received = self._retired_bytes_sent, self._retired_bytes_received
        for r in self._runners.values():
            sent += r.worker.bytes_sent
            received += r.worker.bytes_received
        out.update(
            {
                "max_workers": self.max_workers,
                "retry_budget": self.retry_budget,
                "zones": {z: dict(v) for z, v in sorted(self.zone_waves.items())},
                "runners": self.runners(),
                "tasks_remote": self.tasks_remote,
                "tasks_inline": self.tasks_inline,
                "worker_restarts": self.worker_restarts,
                "retries": self.retries,
                "inline_fallbacks": self.inline_fallbacks,
                "revoked_windows": self.revoked_windows,
                "control_bytes_sent": sent,
                "control_bytes_received": received,
                "payload_bytes_over_pipe": 0,
            }
        )
        if self._flat is not None:
            out["flat"] = self._flat.stats()
        return out

    def __repr__(self) -> str:
        return (
            f"ZonedProcessExecutor(runners={sorted(self._runners)}, "
            f"retry_budget={self.retry_budget})"
        )

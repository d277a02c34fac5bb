"""Pipeline (DCG) + PipelineManager (paper §III.B).

The manager owns the registry of processes, the scheduling of work, and the
assembly of metadata. Both trigger modes share one engine (the paper's point
that they are not orthogonal):

  - **reactive** (push): events arriving at the input end drive computation
    downstream — ``push()`` / ``sample()`` then ``propagate()``.
  - **make** (pull): a request for a target output triggers a hierarchical
    rebuild of dependencies backwards — ``pull()`` — with content-addressed
    cache hits standing in for up-to-date build artifacts.

Both modes are thin wrappers over the event-driven
:class:`~repro_torch.core.scheduler.Scheduler`: link notifications enqueue exactly
the tasks whose policies may have become ready, and waves of simultaneously
ready tasks execute through the pluggable ``run_wave`` seam (serial inline,
or concurrent via :class:`~repro_torch.workspace.executors.ConcurrentExecutor`).
There is no full-graph polling anywhere on the hot path.

Cycles are allowed (DCG, not DAG): each task gets a per-drain *fire budget*
(the ``max_rounds`` knob) rather than a topology restriction.
"""

from __future__ import annotations

import warnings
from typing import Any, Optional

from repro_torch.cache import MemoCache

from .av import AnnotatedValue, content_hash, is_ghost
from .link import SmartLink
from .provenance import ProvenanceRegistry
from .scheduler import Scheduler, SerialWaveRunner
from .store import ArtifactStore
from .task import SmartTask


def _deprecated(old: str, new: str) -> None:
    warnings.warn(
        f"{old} is deprecated; use {new} — see repro_torch.workspace.Workspace",
        DeprecationWarning,
        stacklevel=3,
    )


class Pipeline:
    """The wiring diagram: tasks and the links between them.

    This class is the *engine* behind :class:`repro_torch.workspace.Workspace`;
    the direct ``add_task``/``connect`` surface is deprecated in favour of
    the typed facade (``ws.task(...)``, ``src["out"] >> dst["in"]``)."""

    def __init__(self, name: str = "pipeline") -> None:
        self.name = name
        self.tasks: dict = {}
        self.links: list = []
        self.implicit_edges: list = []

    def add_task(self, task: SmartTask) -> SmartTask:
        _deprecated("Pipeline.add_task", "Workspace.task(...)")
        return self._add_task(task)

    def _add_task(self, task: SmartTask) -> SmartTask:
        if task.name in self.tasks:
            raise ValueError(f"duplicate task {task.name}")
        self.tasks[task.name] = task
        return task

    def connect(
        self,
        src: str,
        output: str,
        dst: str,
        dst_input: str,
        **link_kwargs: Any,
    ) -> SmartLink:
        _deprecated("Pipeline.connect", 'src["out"] >> dst["in"]')
        return self._connect(src, output, dst, dst_input, **link_kwargs)

    def _connect(
        self,
        src: str,
        output: str,
        dst: str,
        dst_input: str,
        **link_kwargs: Any,
    ) -> SmartLink:
        src_t, dst_t = self.tasks[src], self.tasks[dst]
        if output not in src_t.outputs:
            raise KeyError(f"{src} has no output {output!r}")
        if dst_input not in {s.name for s in dst_t.input_specs}:
            raise KeyError(f"{dst} has no input {dst_input!r}")
        if dst_input in dst_t.in_links:
            # One link per input: a second wire would silently shadow the
            # first (its AVs would never be ingested, and the scheduler's
            # quiescence sweep would spin on the undrainable queue forever).
            # Fan-in is modelled as distinct inputs on a merge-mode task.
            prior = dst_t.in_links[dst_input]
            raise ValueError(
                f"input {dst}.{dst_input} is already wired from "
                f"{prior.src_task}.{prior.name.split('->')[0].split('.')[-1]}; "
                f"declare one input per producer (merge mode FCFS-merges them)"
            )
        link = SmartLink(
            name=f"{src}.{output}->{dst}.{dst_input}",
            src_task=src,
            dst_task=dst,
            dst_input=dst_input,
            **link_kwargs,
        )
        src_t.out_links.setdefault(output, []).append(link)
        dst_t.in_links[dst_input] = link
        self.links.append(link)
        return link

    def producers_of(self, task_name: str) -> list:
        t = self.tasks[task_name]
        return [l.src_task for l in t.in_links.values()]

    def validate(self) -> list:
        """Every non-source input must be wired. Returns list of problems."""
        problems = []
        for t in self.tasks.values():
            for spec in t.input_specs:
                if spec.name not in t.in_links and not t.source:
                    problems.append(f"{t.name}.{spec.name} unwired")
        return problems


class PipelineManager:
    def __init__(
        self,
        pipeline: Pipeline,
        store: Optional[ArtifactStore] = None,
        registry: Optional[ProvenanceRegistry] = None,
        cache: Optional[MemoCache] = None,
        max_rounds: int = 100,
        executor: Any = None,
        topology: Any = None,
        placement: Any = None,
        journal: Any = None,
    ) -> None:
        self.pipeline = pipeline
        self.store = store or ArtifactStore()
        self.registry = registry or ProvenanceRegistry()
        # cache=None -> default MemoCache; cache=False -> caching disabled
        self.cache = MemoCache() if cache is None else (cache or None)
        # Durable provenance (repro_torch.provenance.Journal): registry, memo
        # cache, and transfer ledger write through one append-only event
        # log, so the forensic stories survive restarts (Workspace.
        # from_journal replays them). Bound before _register_design so the
        # design-map records land in the journal too.
        self.journal = journal
        if journal is not None:
            self.registry.bind_journal(journal)
            if self.cache is not None:
                self.cache.bind_journal(journal)
        # unstable-hash anomalies (unpicklable payloads whose digests are
        # process-local) surface in the visitor trail rather than vanishing
        self.store.bind_provenance(self.registry)
        # hash-backend fallbacks would surface the same way (API parity:
        # the port's hashing never falls back)
        from repro_torch.core.hashing import bind_fallback_anomalies

        bind_fallback_anomalies(
            lambda note: self.registry.record_anomaly("hashing", note)
        )
        # max_rounds survives as the per-task fire budget per drain (cycle
        # rate control); it no longer multiplies full-graph scans.
        self.max_rounds = max_rounds
        # anything exposing run_wave(manager, tasks) -> [(name, out_avs)];
        # Workspace passes its executor backend here.
        self.executor = executor if executor is not None else SerialWaveRunner()
        # Extended-cloud placement (repro_torch.topology): a Topology binds every
        # task to a zone, installs the transfer ledger, and gives the
        # scheduler a placement policy to run at wave formation.
        self.topology = topology
        if topology is not None:
            from repro_torch.topology import TransferLedger, make_placement

            self.ledger = TransferLedger(topology)
            self.placement = make_placement(placement, topology)
            for t in pipeline.tasks.values():
                t.bind_topology(topology, self.ledger)
            if journal is not None:
                # the zone/tier/link-cost spec rides the journal so a replay
                # can rebuild the ledger — energy prices and all
                journal.append("topology", topology.describe())
                self.ledger.bind_journal(journal)
        else:
            self.ledger = None
            self.placement = None
        self.scheduler = Scheduler(self, fire_budget=max_rounds)
        self._register_design()

    def _register_design(self) -> None:
        for t in self.pipeline.tasks.values():
            self.registry.register_task(
                t.name,
                [str(s) for s in t.input_specs],
                t.outputs,
                t.version,
            )
        for link in self.pipeline.links:
            self.registry.add_design_edge(link.src_task, "precedes", link.dst_task)

    # -- external data entry (edge sampling) -----------------------------------
    def inject(self, task: str, input_name: str, payload: Any, region: str = "local"):
        _deprecated("PipelineManager.inject", "Workspace.inject(...)")
        return self._inject(task, input_name, payload, region=region)

    def _inject(self, task: str, input_name: str, payload: Any, region: str = "local"):
        """Edge-node sampling: wrap an external payload as an AV and deliver it
        to a task input ('data are intentionally sampled by the edge nodes').
        Ghost payloads (shape specs) ride the AV itself and never hit the
        store — a wireframe run moves zero bytes end to end (§III.K).
        Under a topology the sample is born in the receiving task's zone —
        edge sampling happens where the edge node lives."""
        t = self.pipeline.tasks[task]
        zone = t.zone if self.topology is not None else None
        if is_ghost(payload):
            chash = content_hash(payload)
            meta = {"ghost": True, "ghost_spec": payload}
            if zone is not None:
                meta["zone"] = zone
            av = AnnotatedValue.produce(
                chash, f"ghost://{chash}", f"edge:{input_name}", "edge",
                region=region, meta=meta,
            )
        else:
            uri, chash = self.store.put(payload)
            meta = None
            if zone is not None:
                meta = {"zone": zone, "nbytes": self.store.nbytes_of(chash)}
                self.ledger.register_resident(chash, zone)
                self.store.note_zone_resident(chash, zone)
            av = AnnotatedValue.produce(
                chash, uri, f"edge:{input_name}", "edge", region=region, meta=meta
            )
        self.registry.register_av(av)
        av.stamp(t.name, "consumed", t.version, region=t.region)
        t.policy.arrive(input_name, av)
        # Edge arrivals bypass links, so there is no notification to ride:
        # tell the scheduler directly that this task may have become ready.
        self.scheduler.mark_dirty(t.name)
        return av

    def _emit_external(self, task: str, output: str, payload: Any, region: str = "local"):
        """Emit a payload *as* a source task's output ('the camera saw this
        image'). Restricted to sensors: letting arbitrary tasks emit
        externally-supplied payloads would let forged artifacts carry
        authentic-looking travel documents. The AV is marked external."""
        t = self.pipeline.tasks[task]
        if not t.source:
            raise ValueError(
                f"cannot emit {output!r} on non-source task {task!r}: "
                f"output-emission push is sensor semantics; wire data into "
                f"an input instead"
            )
        uri, chash = self.store.put(payload)
        meta = {"external": True}
        if self.topology is not None and t.zone is not None:
            # the sensor saw it where the sensor lives: the payload is
            # resident in the source task's zone at zero transport cost
            meta["zone"] = t.zone
            meta["nbytes"] = self.store.nbytes_of(chash)
            self.ledger.register_resident(chash, t.zone)
            self.store.note_zone_resident(chash, t.zone)
        av = AnnotatedValue.produce(
            chash, uri, t.name, t.version, region=region, meta=meta
        )
        self.registry.register_av(av)
        self.registry.log_visit(t.name, av.uid, "emitted", t.version, note="external")
        t._emit({output: av})
        return av

    # -- reactive (push) mode ----------------------------------------------------
    def push(self, task: str, region: str = "local", **payloads: Any) -> dict:
        _deprecated("PipelineManager.push", "Workspace.push(...)")
        return self._push(task, region=region, **payloads)

    def _push(self, task: str, region: str = "local", **payloads: Any) -> dict:
        """Deliver payloads and propagate downstream. A payload named after a
        task *input* is injected there; one named after an *output* is
        emitted as that output (sensor semantics for source tasks)."""
        t = self.pipeline.tasks[task]
        input_names = {s.name for s in t.input_specs}
        emitted: list = []
        for iname, payload in payloads.items():
            if iname in input_names:
                self._inject(task, iname, payload, region=region)
            elif iname in t.outputs:
                emitted.append({iname: self._emit_external(task, iname, payload, region)})
            else:
                raise KeyError(
                    f"task {task!r} has no input or output named {iname!r} "
                    f"(inputs={sorted(input_names)}, outputs={t.outputs})"
                )
        fired = self.propagate()
        if emitted:
            fired[task] = emitted + fired.get(task, [])
        return fired

    def sample(self, source_task: str) -> dict:
        _deprecated("PipelineManager.sample", "Workspace.sample(...)")
        return self._sample(source_task)

    def _sample(self, source_task: str) -> dict:
        """Fire a source task once (sample its sensor) and propagate."""
        t = self.pipeline.tasks[source_task]
        if not t.source:
            raise ValueError(f"{source_task} is not a source task")
        out = t.execute(self.store, self.registry, self.cache)
        fired = self.propagate()
        fired.setdefault(source_task, []).append(out)
        return fired

    def propagate(self) -> dict:
        """Drain the ready queue until quiescent (event-driven; no
        full-graph polling — see :class:`~repro_torch.core.scheduler.Scheduler`).
        Cycles are bounded by the per-task fire budget (``max_rounds``)."""
        return self.scheduler.drain()

    # -- make (pull) mode -----------------------------------------------------------
    def pull(self, target: str, _visiting: Optional[set] = None) -> dict:
        _deprecated("PipelineManager.pull", "Workspace.pull(...)")
        return self._pull(target, _visiting)

    def _pull(self, target: str, _visiting: Optional[set] = None) -> dict:
        """Request the target task's outputs, rebuilding dependencies
        backwards (iterative dependency-cone walk on the scheduler; the old
        recursion's cycle guard becomes a skipped back-edge). Unchanged
        subtrees resolve as cache hits or prior outputs.

        ``_visiting`` is accepted for signature compatibility with the original
        recursion; the scheduler tracks the cone itself.
        """
        if _visiting and target in _visiting:  # legacy re-entry: old guard
            return self.pipeline.tasks[target].last_outputs
        return self.scheduler.pull(target)

    # -- convenience -------------------------------------------------------------
    def value_of(self, av: AnnotatedValue) -> Any:
        return self.store.get(av.uri)

    def stats(self) -> dict:
        store_stats = self.store.stats()
        cache_stats = self.cache.stats() if self.cache else None
        tasks = self.pipeline.tasks.values()
        executions = sum(t.executions for t in tasks)
        cache_hits = sum(t.cache_hits for t in tasks)
        return {
            "store": store_stats,
            "cache": cache_stats,
            "sustainability": {
                # §III.F: work and transport avoided, not just work done.
                # Derived from per-task counters so the scorecard stays
                # per-pipeline even when the MemoCache/store are shared
                # across workspaces (the "cache" block above is cache-global).
                "executions": executions,
                "cache_hits": cache_hits,
                "executions_avoided": cache_hits,
                "bytes_not_moved": store_stats["bytes_not_moved"]
                + sum(t.bytes_saved for t in tasks),
            },
            "tasks": {
                n: {"executions": t.executions, "cache_hits": t.cache_hits}
                for n, t in self.pipeline.tasks.items()
            },
            "links": {l.name: l.stats() for l in self.pipeline.links},
            # trigger-work scorecard: enqueued (event-driven) vs the
            # polling-scan equivalent the original engine would have burned
            "scheduler": self.scheduler.stats(),
            # extended-cloud scorecard (repro_torch.topology): where work ran and
            # what transport the zone boundaries cost — None on flat circuits
            "topology": self._topology_stats(),
        }

    def _topology_stats(self) -> Optional[dict]:
        if self.topology is None:
            return None
        tasks = self.pipeline.tasks.values()
        zones = {}
        for zname in self.topology.zone_names():
            residents = sorted(
                t.name for t in tasks if (t.zone or self.topology.default_zone) == zname
            )
            zones[zname] = {
                "tier": self.topology.tier_of(zname),
                "tasks": residents,
                "executions": sum(
                    t.zone_executions.get(zname, 0) for t in tasks
                ),
            }
        return {
            "name": self.topology.name,
            "default_zone": self.topology.default_zone,
            "placement": self.placement.stats(),
            "ledger": self.ledger.stats(),
            "zones": zones,
            "crosszone_refs": sum(l.crosszone_refs for l in self.pipeline.links),
        }

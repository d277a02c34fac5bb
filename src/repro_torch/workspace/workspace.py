"""The Workspace facade — one typed entry point over the Koalja circuit.

The paper's promise is that users wire plugin code on a breadboard and
promote it "with a minimum of infrastructure knowledge". The original engine exposed
four disjoint idioms (``Pipeline.add_task``/``connect``,
``PipelineManager.push/pull/inject``, ``parse_wiring``, ``EvalLoop``); this
facade subsumes them:

    ws = Workspace("demo")
    camera = ws.source(read_sensor, name="camera", outputs=["image"])
    detect = ws.task(detect_fn, name="detect", inputs=["frame"],
                     outputs=["boxes"])
    camera["image"] >> detect["frame"]          # typed operator wiring
    detect["frame"].buffer(10, slide=2)         # the paper's [N/k]

    ws.push(camera, image=img)                  # reactive (event-driven)
    boxes = ws.pull(detect)["boxes"]            # make-mode (result-oriented)

Both trigger modes run on the *same* engine (PipelineManager) — the facade
adds types, declarativity, and a pluggable executor backend
(:class:`InlineExecutor` in-process, :class:`ConcurrentExecutor` on a
thread pool, zone and process backends, :class:`MeshExecutor` on one torch
device), not new semantics. Provenance (travel
documents, visitor logs, design map) is captured on every run and queryable
from the same object.

Port of ``repro.workspace.workspace``. Payloads may be torch tensors on a
card; the store keeps them there and content hashing digests the large ones
with the ``hash_tree`` kernel. Ghost runs take
:class:`repro_torch.core.wireframe.ShapeDtypeStruct` specs.
"""

from __future__ import annotations

import os
from typing import Any, Callable, Iterable, Mapping, Optional, Union

from repro_torch.cache import MemoCache
from repro_torch.core.av import AnnotatedValue
from repro_torch.core.pipeline import Pipeline, PipelineManager
from repro_torch.core.policy import InputSpec
from repro_torch.core.provenance import ProvenanceRegistry
from repro_torch.core.store import ArtifactStore
from repro_torch.core.task import ServiceCall, SmartTask
from repro_torch.topology import Topology, default_topology

from .executors import Executor, InlineExecutor, default_executor
from .handles import Port, TaskDecl, TaskHandle, Wire, WireDecl, WiringError

TaskRef = Union[str, TaskHandle, Port]


class WorkspaceFrozenError(RuntimeError):
    """Structural edit after the circuit was materialized."""


class TaskResult(Mapping):
    """Outputs of one task firing: ``result["out"]`` is the payload;
    ``result.av("out")`` is the AnnotatedValue (provenance handle)."""

    def __init__(self, ws: "Workspace", task: str, out_avs: dict) -> None:
        self._ws = ws
        self.task = task
        self._avs = dict(out_avs)

    def __getitem__(self, output: str) -> Any:
        return self._ws.value_of(self._avs[output])

    def __iter__(self):
        return iter(self._avs)

    def __len__(self) -> int:
        return len(self._avs)

    def av(self, output: str) -> AnnotatedValue:
        return self._avs[output]

    @property
    def avs(self) -> dict:
        return dict(self._avs)

    def lineage(self, output: str) -> dict:
        return self._ws.registry.lineage(self._avs[output].uid)

    def __repr__(self) -> str:
        return f"TaskResult({self.task}: {sorted(self._avs)})"


class RunResult(Mapping):
    """Everything that fired during one reactive run, keyed by task name.
    ``run[task]`` is the latest :class:`TaskResult` of that task."""

    def __init__(self, ws: "Workspace", fired: dict) -> None:
        self._ws = ws
        self._fired = fired  # task -> [ {output: AV} ]

    def __getitem__(self, task: TaskRef) -> TaskResult:
        name = self._ws._name_of(task)
        return TaskResult(self._ws, name, self._fired[name][-1])

    def __iter__(self):
        return iter(self._fired)

    def __len__(self) -> int:
        return len(self._fired)

    def firings(self, task: TaskRef) -> list:
        name = self._ws._name_of(task)
        return [
            TaskResult(self._ws, name, avs) for avs in self._fired.get(name, [])
        ]

    def value(self, task: TaskRef, output: str) -> Any:
        return self[task][output]

    def __repr__(self) -> str:
        return f"RunResult(fired={sorted(self._fired)})"


class Watcher:
    """Reactive observer on a task's output: collects a TaskResult per
    firing and invokes the callback (the facade's replacement for hand-rolled
    EvalLoop-style polling)."""

    def __init__(self, ws: "Workspace", task: str, callback: Optional[Callable]) -> None:
        self._ws = ws
        self.task = task
        self.callback = callback
        self.events: list = []
        self.active = True

    def _notify(self, result: TaskResult) -> None:
        if not self.active:
            return
        self.events.append(result)
        if self.callback is not None:
            self.callback(result)

    def latest(self) -> Optional[TaskResult]:
        return self.events[-1] if self.events else None

    def cancel(self) -> None:
        self.active = False


class Workspace:
    """Declarative breadboard + typed runtime over the Koalja engine."""

    def __init__(
        self,
        name: str = "workspace",
        *,
        executor: Optional[Executor] = None,
        store: Optional[ArtifactStore] = None,
        registry: Optional[ProvenanceRegistry] = None,
        cache=None,
        max_rounds: int = 100,
        topology: Union[Topology, bool, None] = None,
        placement=None,
        journal_path: Union[str, bool, None] = None,
        journal_flush_every_n: Optional[int] = None,
        journal_rotate_bytes: Optional[int] = None,
        journal_rotate_records: Optional[int] = None,
    ) -> None:
        self.name = name
        # executor=None defers to KOALJA_EXECUTOR (inline | concurrent) so
        # whole suites can smoke the threaded scheduler path via env.
        self.executor = executor or default_executor()
        # topology=None defers to KOALJA_TOPOLOGY (flat | 3zone);
        # topology=False forces flat regardless of env. placement is
        # "pin" | "data_gravity" | a PlacementPolicy; None defers to
        # KOALJA_PLACEMENT, then to the data_gravity default.
        if topology is False:
            self._topology = None
        else:
            self._topology = topology if topology is not None else default_topology()
        self._placement = (
            placement
            if placement is not None
            else (os.environ.get("KOALJA_PLACEMENT", "").strip().lower() or None)
        )
        # Validate the policy *name* now, at construction — not lazily at
        # first build (and never at all on flat circuits, where a typo'd
        # KOALJA_PLACEMENT used to be silently ignored).
        if isinstance(self._placement, str):
            from repro_torch.topology.placement import _POLICIES

            if self._placement not in _POLICIES:
                source = (
                    "placement=" if placement is not None else "KOALJA_PLACEMENT="
                )
                raise ValueError(
                    f"{source}{self._placement!r} is not a known placement "
                    f"policy (choose from {' | '.join(sorted(_POLICIES))})"
                )
        self._store = store or ArtifactStore()
        self._registry = registry or ProvenanceRegistry()
        # cache=None -> default MemoCache; cache=False -> caching disabled
        self._cache = MemoCache() if cache is None else cache
        # journal_path=None defers to KOALJA_JOURNAL ("1" -> a per-workspace
        # file under the system tempdir; any other non-empty value -> a
        # directory to create per-workspace journals in); journal_path=False
        # forces the journal off regardless of env.
        self._journal = self._make_journal(
            journal_path,
            journal_flush_every_n,
            journal_rotate_bytes,
            journal_rotate_records,
        )
        self._replay = None  # set by from_journal (rehydrated workspaces)
        self._max_rounds = max_rounds
        self._decls: dict = {}
        self._wires: list = []
        self._implicit_edges: list = []
        self._handles: dict = {}
        self._manager: Optional[PipelineManager] = None
        self._watchers: list = []

    def _make_journal(
        self, journal_path, flush_every_n, rotate_bytes=None, rotate_records=None
    ):
        if journal_path is False:
            return None
        if hasattr(journal_path, "append_batch"):
            # a pre-built Journal instance (multi-tenant hubs hand each
            # workspace a per-tenant journal drawing seqs from the hub)
            return journal_path
        if journal_path is None:
            env = os.environ.get("KOALJA_JOURNAL", "").strip()
            if env.lower() in ("", "0", "false", "no", "off"):
                return None
            import tempfile

            if env.lower() in ("1", "true", "yes", "on"):
                root = os.path.join(tempfile.gettempdir(), "koalja-journals")
            else:
                root = env  # a directory to keep per-workspace journals in
            os.makedirs(root, exist_ok=True)
            import uuid

            journal_path = os.path.join(
                root, f"{self.name}-{os.getpid()}-{uuid.uuid4().hex[:8]}.jsonl"
            )
        from repro_torch.provenance import Journal

        return Journal(
            journal_path,
            flush_every_n=flush_every_n,
            workspace=self.name,
            rotate_bytes=rotate_bytes,
            rotate_records=rotate_records,
        )

    @classmethod
    def from_journal(cls, path, **ws_kwargs: Any) -> "Workspace":
        """Rehydrate the forensic stories from a provenance journal written
        by a previous (possibly crashed) process.

        ``path`` is a journal *base* path — the whole segment chain is
        discovered from it: rotated segments (``<path>.000N``), the best
        checkpoint snapshot (``<path>.ckpt-*``, if the journal was
        compacted), and the live tail replay as one seq-ordered stream, so
        restart cost after compaction is checkpoint + tail rather than full
        history. For a multi-process run under
        :class:`~repro_torch.runtime.ZonedProcessExecutor`, pass a list/tuple of
        ``[main_journal, *runner_segments]``: the segments merge back into
        one seq-ordered stream before replay
        (:func:`repro_torch.provenance.replay_segments`).

        The returned workspace holds a replayed registry — ``lineage()``,
        ``visitor_log()``, ``design_map()``, ``visits_of`` and, when the run
        had a topology, ``stats()["topology"]["ledger"]`` answer exactly as
        the writing process would have (a torn final line from a mid-write
        crash is detected and dropped, per file). It is a forensic view,
        not a runnable circuit: the journal records events, not user code,
        so declare tasks on a fresh Workspace to compute again."""
        from repro_torch.provenance import replay_journal, replay_segments

        if isinstance(path, (list, tuple)):
            main, *segments = path
            replayed = replay_segments(main, segments)
        else:
            replayed = replay_journal(path)
        ws = cls(
            name=replayed.workspace or "rehydrated",
            registry=replayed.registry,
            topology=False,  # the replayed ledger is the topology story
            cache=False,
            journal_path=False,  # rehydration must never re-journal history
            **ws_kwargs,
        )
        ws._replay = replayed
        return ws

    # ------------------------------------------------------------------
    # breadboard: declaring tasks and wires
    # ------------------------------------------------------------------

    def _assert_mutable(self) -> None:
        if self._manager is not None:
            raise WorkspaceFrozenError(
                "the circuit is already materialized — a run (push/pull/"
                "sample) or an engine access (.pipeline, .stats(), "
                ".design_map()) happened; declare tasks, wires, and buffers "
                "before that"
            )

    def task(
        self,
        fn: Optional[Callable] = None,
        *,
        name: Optional[str] = None,
        inputs: Iterable = (),
        outputs: Iterable = ("out",),
        mode: str = "all_new",
        region: str = "local",
        source: Optional[bool] = None,
        services: Optional[dict] = None,
        min_interval_s: float = 0.0,
        cache_ttl_s: Optional[float] = None,
    ) -> TaskHandle:
        """Declare a task (direct call or decorator). Inputs accept the
        paper's ``name[N]`` / ``name[N/k]`` annotations."""

        def register(f: Callable) -> TaskHandle:
            self._assert_mutable()
            tname = name or f.__name__
            if tname in self._decls:
                raise WiringError(f"duplicate task {tname!r}")
            specs = [
                s if isinstance(s, InputSpec) else InputSpec.parse(s) for s in inputs
            ]
            decl = TaskDecl(
                name=tname,
                fn=f,
                inputs=specs,
                outputs=list(outputs),
                mode=mode,
                region=region,
                source=(len(specs) == 0) if source is None else bool(source),
                services=dict(services) if services else None,
                min_interval_s=min_interval_s,
                cache_ttl_s=cache_ttl_s,
            )
            self._decls[tname] = decl
            handle = TaskHandle(self, decl)
            self._handles[tname] = handle
            return handle

        return register if fn is None else register(fn)

    def source(
        self,
        fn: Optional[Callable] = None,
        *,
        name: Optional[str] = None,
        outputs: Iterable = ("out",),
        **kwargs: Any,
    ) -> TaskHandle:
        """Declare an edge sensor: no inputs, fires when sampled/pulled."""
        return self.task(fn, name=name, inputs=(), outputs=outputs, source=True, **kwargs)

    def wire(self, src: Port, dst: Port, **link_kwargs: Any) -> Wire:
        """Connect an output port to an input port (``>>`` sugar calls this)."""
        self._assert_mutable()
        if src.direction != "out" or dst.direction != "in":
            raise WiringError(
                f"wire needs (output, input) ports, got "
                f"({src.direction}, {dst.direction})"
            )
        decl = WireDecl(
            src_task=src.task.name,
            output=src.name,
            dst_task=dst.task.name,
            dst_input=dst.name,
            link_kwargs=dict(link_kwargs),
        )
        self._wires.append(decl)
        return Wire(self, decl)

    def implicit(self, service: str, task: TaskRef) -> None:
        """Record a client-server side channel in the design map (§III.D)."""
        self._assert_mutable()
        self._implicit_edges.append((service, self._name_of(task)))

    @classmethod
    def from_wiring(
        cls,
        text: str,
        impls: dict,
        *,
        default_mode: str = "all_new",
        modes: Optional[dict] = None,
        **ws_kwargs: Any,
    ) -> "Workspace":
        """Build a Workspace from the paper's breadboard DSL (fig. 5) —
        the wiring language becomes one constructor.

        The parsed circuit is lifted back into *declarations*, so the
        result is indistinguishable from a hand-built breadboard: ports,
        ``.buffer(...)`` edits, and extra wires all still work before the
        first run."""
        from repro_torch.core.wiring import build_wiring

        ws = cls(**ws_kwargs)
        pipe = build_wiring(text, impls, default_mode=default_mode, modes=modes)
        ws.name = pipe.name
        ws._implicit_edges = list(getattr(pipe, "implicit_edges", []))
        for t in pipe.tasks.values():
            decl = TaskDecl(
                name=t.name,
                fn=t.fn,
                inputs=list(t.input_specs),
                outputs=list(t.outputs),
                mode=t.policy.mode,
                region=t.region,
                source=t.source,
                services=dict(t.services) if t.services else None,
                min_interval_s=t.policy.min_interval_s,
                cache_ttl_s=t.cache_ttl_s,
            )
            ws._decls[t.name] = decl
            ws._handles[t.name] = TaskHandle(ws, decl)
        for t in pipe.tasks.values():
            for oname, links in t.out_links.items():
                for link in links:
                    ws._wires.append(
                        WireDecl(
                            src_task=t.name,
                            output=oname,
                            dst_task=link.dst_task,
                            dst_input=link.dst_input,
                            link_kwargs={
                                "region": link.region,
                                "fenced_regions": link.fenced_regions,
                                "notify_threshold_s": link.notify_threshold_s,
                            },
                        )
                    )
        return ws

    def __getitem__(self, task: str) -> TaskHandle:
        try:
            return self._handles[task]
        except KeyError:
            raise KeyError(
                f"no task {task!r} in workspace {self.name!r} "
                f"(tasks: {sorted(self._handles)})"
            ) from None

    # ------------------------------------------------------------------
    # materialization
    # ------------------------------------------------------------------

    def _build(self) -> PipelineManager:
        if self._manager is not None:
            return self._manager
        pipe = Pipeline(self.name)
        for decl in self._decls.values():
            pipe._add_task(
                SmartTask(
                    name=decl.name,
                    fn=decl.fn,
                    inputs=list(decl.inputs),
                    outputs=list(decl.outputs),
                    mode=decl.mode,
                    region=decl.region,
                    source=decl.source,
                    services=decl.services,
                    min_interval_s=decl.min_interval_s,
                    cache_ttl_s=decl.cache_ttl_s,
                    zone=decl.zone,
                    coalesce_max=decl.coalesce_max,
                )
            )
        for w in self._wires:
            pipe._connect(w.src_task, w.output, w.dst_task, w.dst_input, **w.link_kwargs)
        pipe.implicit_edges = list(self._implicit_edges)
        self._manager = PipelineManager(
            pipe,
            store=self._store,
            registry=self._registry,
            cache=self._cache,
            max_rounds=self._max_rounds,
            # the scheduler hands waves of ready tasks to this backend
            executor=self.executor,
            topology=self._topology,
            placement=self._placement,
            journal=self._journal,
        )
        return self._manager

    def validate(self) -> list:
        """Unwired-input problems (empty list = breadboard is complete).

        Works on the declarations, so the breadboard stays editable: fix
        the reported problems and validate again before the first run."""
        if self._manager is not None:
            return self._manager.pipeline.validate()
        wired = {(w.dst_task, w.dst_input) for w in self._wires}
        problems = []
        for decl in self._decls.values():
            if decl.source:
                continue
            for spec in decl.inputs:
                if (decl.name, spec.name) not in wired:
                    problems.append(f"{decl.name}.{spec.name} unwired")
        return problems

    def _name_of(self, task: TaskRef) -> str:
        if isinstance(task, TaskHandle):
            return task.name
        if isinstance(task, Port):
            return task.task.name
        return str(task)

    # ------------------------------------------------------------------
    # runtime: the two trigger modes (one engine)
    # ------------------------------------------------------------------

    def push(self, task: TaskRef, *, region: str = "local", **payloads: Any) -> RunResult:
        """Reactive mode: deliver payloads to the task's inputs and let the
        event drive computation downstream."""
        mgr = self._build()
        fired = self.executor.push(mgr, self._name_of(task), payloads, region)
        self._notify_watchers(fired)
        return RunResult(self, fired)

    def sample(self, source: TaskRef) -> RunResult:
        """Fire an edge sensor once and propagate."""
        mgr = self._build()
        fired = self.executor.sample(mgr, self._name_of(source))
        self._notify_watchers(fired)
        return RunResult(self, fired)

    def pull(self, target: TaskRef) -> TaskResult:
        """Make mode: name the result you want; dependencies rebuild
        backwards, unchanged subtrees resolve as cache hits."""
        mgr = self._build()
        name = self._name_of(target)
        before = self._watch_counts(mgr)
        out = self.executor.pull(mgr, name)
        # watchers observe make-mode firings too (fresh AVs, incl. cache
        # hits, are events — the EvalLoop contract)
        for w in self._watchers:
            if not w.active:
                continue
            t = mgr.pipeline.tasks.get(w.task)
            if t is not None and self._fire_count(t) > before.get(w.task, 0):
                if t.last_outputs:
                    w._notify(TaskResult(self, w.task, dict(t.last_outputs)))
        return TaskResult(self, name, out)

    def inject(
        self, task: TaskRef, input_name: str, payload: Any, *, region: str = "local"
    ) -> AnnotatedValue:
        """Deliver one external payload without propagating (edge sampling)."""
        mgr = self._build()
        return self.executor.inject(mgr, self._name_of(task), input_name, payload, region)

    def watch(self, target: TaskRef, callback: Optional[Callable] = None) -> Watcher:
        """Observe a task reactively: each firing appends a TaskResult and
        invokes the callback."""
        w = Watcher(self, self._name_of(target), callback)
        self._watchers.append(w)
        return w

    @staticmethod
    def _fire_count(task) -> int:
        return task.executions + task.cache_hits

    def _watch_counts(self, mgr: PipelineManager) -> dict:
        return {
            w.task: self._fire_count(mgr.pipeline.tasks[w.task])
            for w in self._watchers
            if w.active and w.task in mgr.pipeline.tasks
        }

    def _notify_watchers(self, fired: dict) -> None:
        for w in self._watchers:
            if not w.active:
                continue
            for out_avs in fired.get(w.task, []):
                w._notify(TaskResult(self, w.task, out_avs))

    def ghost(self, injections: dict, pulls: Optional[list] = None) -> dict:
        """Wireframe the circuit with ghost batches (ShapeDtypeStructs):
        expose routing and shape contracts without moving a byte (§III.K).
        injection keys: Port, (task, input), or "task.input"."""
        from repro_torch.core.wireframe import ghost_run

        mgr = self._build()
        normalized = {}
        for key, spec in injections.items():
            if isinstance(key, Port):
                normalized[(key.task.name, key.name)] = spec
            elif isinstance(key, tuple):
                normalized[(self._name_of(key[0]), key[1])] = spec
            else:
                task, _, iname = str(key).partition(".")
                normalized[(task, iname)] = spec
        return ghost_run(mgr, normalized, pulls=[self._name_of(p) for p in pulls or []])

    # ------------------------------------------------------------------
    # introspection & provenance (the three stories, one surface)
    # ------------------------------------------------------------------

    @property
    def pipeline(self) -> Pipeline:
        return self._build().pipeline

    @property
    def manager(self) -> PipelineManager:
        """The underlying engine (escape hatch; prefer the facade)."""
        return self._build()

    @property
    def registry(self) -> ProvenanceRegistry:
        return self._registry

    @property
    def store(self) -> ArtifactStore:
        return self._store

    @property
    def topology(self) -> Optional[Topology]:
        return self._topology

    @property
    def ledger(self):
        """The extended-cloud transfer ledger (None on flat circuits; the
        replayed ledger on a journal-rehydrated workspace)."""
        if self._replay is not None:
            return self._replay.ledger
        return self._build().ledger

    @property
    def journal(self):
        """The durable provenance journal (None when journaling is off)."""
        return self._journal

    def compact_journal(
        self,
        *,
        retire_evicted: bool = False,
        archive_dir: Optional[str] = None,
    ) -> dict:
        """Fold the journal's rotated history into a checkpoint snapshot
        (:meth:`repro_torch.provenance.Journal.compact`), so the next
        ``from_journal`` replays checkpoint + tail instead of full history.

        ``retire_evicted=True`` first trims the forensic horizon: AVs whose
        payloads the store can no longer resolve (evicted local-only
        artifacts) and AVs stamped ``dropped`` (streaming-window members the
        merge policy aged out) are retired from the registry — journaled as
        a ``retired`` record, so replays agree — before the fold. That is
        what keeps checkpoint size proportional to *live* state on an
        unbounded stream; the default keeps the drop-forensics story intact
        (dropped travellers stay queryable forever).

        Per-zone runner segment files (multi-process runs) are folded in
        automatically; call between drains, not mid-flight. ``archive_dir``
        moves folded segments aside instead of deleting them — the
        cold-tier hook, and the uncompacted oracle for audits
        (:func:`repro_torch.provenance.replay_files`). Returns the compaction
        report."""
        if self._journal is None:
            raise ValueError(
                f"workspace {self.name!r} has no journal to compact "
                "(enable with journal_path= or KOALJA_JOURNAL=1)"
            )
        if retire_evicted:
            doomed = []
            for uid in self._registry.all_avs():
                av = self._registry.get_av(uid)
                if any(s.event == "dropped" for s in av.travel_document):
                    doomed.append(uid)
                elif not av.uri.startswith("ghost://") and not self._store.resolvable(
                    av.uri
                ):
                    doomed.append(uid)
            if doomed:
                self._registry.retire_avs(
                    doomed, note="compaction horizon: evicted/dropped payloads"
                )
        self._journal.flush()
        seg_fn = getattr(self.executor, "segment_paths", None)
        segments = seg_fn() if seg_fn is not None else ()
        return self._journal.compact(
            segment_paths=segments, archive_dir=archive_dir
        )

    def value_of(self, av: AnnotatedValue) -> Any:
        return self._store.get(av.uri)

    def traveller_log(self, av: AnnotatedValue) -> list:
        return self._registry.traveller_log(av.uid)

    def visitor_log(self, task: TaskRef) -> list:
        return self._registry.visitor_log(self._name_of(task))

    def lineage(self, av: AnnotatedValue) -> dict:
        return self._registry.lineage(av.uid)

    def design_map(self) -> dict:
        self._build()
        return self._registry.design_map()

    def design_map_text(self) -> str:
        self._build()
        return self._registry.design_map_text()

    def stats(self) -> dict:
        """Engine stats plus this workspace's executor counters. The
        ``sustainability`` block is the paper's §III.F scorecard: executions
        avoided by the memo layer and bytes the circuit never moved. The
        ``scheduler`` block is the trigger-work scorecard: waves, queue
        depth high-water, and tasks-enqueued vs the polling-scan equivalent
        a round-robin polling engine would have burned. The ``topology``
        block (None on flat circuits) is the extended-cloud scorecard:
        per-zone residents/executions, placement decisions, and the
        transfer ledger's cross-zone bytes and energy."""
        out = self._build().stats()
        stats_fn = getattr(self.executor, "stats", None)
        out["executor"] = stats_fn() if stats_fn is not None else None
        # a ZonedExecutor partitions waves by zone; surface its per-zone
        # wave counters inside the topology block where readers look first
        zone_waves = getattr(self.executor, "zone_waves", None)
        if out.get("topology") is not None and zone_waves is not None:
            out["topology"]["executor_zones"] = {
                z: dict(v) for z, v in sorted(zone_waves.items())
            }
        # durable-journal scorecard: what the forensic stories cost on disk
        out["journal"] = self._journal.stats() if self._journal is not None else None
        if self._replay is not None:
            out["journal"] = {
                "path": None,
                "rehydrated": True,
                "replayed_records": self._replay.records,
                "truncated_lines": self._replay.truncated,
                "replayed_counts": dict(self._replay.counts),
                # segment-chain shape of the replayed journal: how many
                # files held the history and how much of it compaction had
                # already folded into checkpoints before this replay
                "segments": self._replay.segments,
                "checkpoints": self._replay.checkpoints,
                "records_compacted": self._replay.records_compacted,
                # AdaptiveExecutor resize decisions, in journal order — the
                # autoscaling history survives restarts like everything else
                "scale_events": list(self._replay.scales),
            }
            if self._replay.ledger is not None:
                # the replayed transfer ledger answers where the engine's
                # would have — same stats shape readers already know
                out["topology"] = {
                    "name": self._replay.topology.name,
                    "default_zone": self._replay.topology.default_zone,
                    "rehydrated": True,
                    "ledger": self._replay.ledger.stats(),
                }
        return out

    def tasks(self) -> list:
        return sorted(self._handles)

    def __repr__(self) -> str:
        state = "materialized" if self._manager is not None else "breadboard"
        return f"Workspace({self.name!r}, tasks={self.tasks()}, {state}, executor={self.executor!r})"


def service(name: str, fn: Callable) -> ServiceCall:
    """Wrap an out-of-band client-server lookup as a traceable ServiceCall
    (frozen responses, §III.D) for ``ws.task(..., services={...})``."""
    return ServiceCall(name, fn)

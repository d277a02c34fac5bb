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
thread pool), not new semantics. Provenance (travel documents, visitor logs,
design map) is captured on every run and queryable from the same object.

Port of ``repro.workspace.workspace``. Payloads may be torch tensors on a
card; the store keeps them there and content hashing digests the large ones
with the ``hash_tree`` kernel. Flat circuits only, for now: a topology other
than None/False or a flat ``KOALJA_TOPOLOGY``, placement, journals
(``journal_path``/``KOALJA_JOURNAL``, ``from_journal``, ``compact_journal``)
and ghost runs raise ``NotImplementedError`` naming their ROADMAP item.
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

from .executors import Executor, InlineExecutor, default_executor
from .handles import Port, TaskDecl, TaskHandle, Wire, WireDecl, WiringError

TaskRef = Union[str, TaskHandle, Port]


_ITEM_7 = "ROADMAP queue 1 item 7: durable and extended engine"
_PLACEMENTS = ("data_gravity", "energy", "pin")  # the JAX package's policy names


def _flat_topology(topology) -> None:
    """Check that a circuit is flat: ``topology`` None (then
    ``KOALJA_TOPOLOGY`` must be unset or flat) or False."""
    if topology is False:
        return
    if topology is not None:
        raise NotImplementedError(f"topologies are not ported yet ({_ITEM_7})")
    name = os.environ.get("KOALJA_TOPOLOGY", "flat").strip().lower()
    if name in ("", "flat", "none"):
        return
    if name in ("3zone", "three_zone", "three-zone"):
        raise NotImplementedError(f"KOALJA_TOPOLOGY={name!r} is not ported yet ({_ITEM_7})")
    raise ValueError(f"KOALJA_TOPOLOGY={name!r} is not a known topology (flat | 3zone)")


def _check_no_journal(journal_path) -> None:
    """Journals are not ported: ``journal_path`` must be None (then
    ``KOALJA_JOURNAL`` must be off) or False."""
    if journal_path is False:
        return
    env = os.environ.get("KOALJA_JOURNAL", "").strip()
    if journal_path is not None or env.lower() not in ("", "0", "false", "no", "off"):
        raise NotImplementedError(f"provenance journals are not ported yet ({_ITEM_7})")


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
        topology: Any = None,
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
        # topology=None defers to KOALJA_TOPOLOGY, which must be flat;
        # topology=False forces flat. placement only matters under a
        # topology, but its name is validated here, as the reference does.
        _flat_topology(topology)
        self._topology = None
        env_placement = os.environ.get("KOALJA_PLACEMENT", "").strip().lower() or None
        self._placement = placement if placement is not None else env_placement
        if isinstance(self._placement, str) and self._placement not in _PLACEMENTS:
            source = "placement=" if placement is not None else "KOALJA_PLACEMENT="
            raise ValueError(
                f"{source}{self._placement!r} is not a known placement "
                f"policy (choose from {' | '.join(_PLACEMENTS)})"
            )
        self._store = store or ArtifactStore()
        self._registry = registry or ProvenanceRegistry()
        # cache=None -> default MemoCache; cache=False -> caching disabled
        self._cache = MemoCache() if cache is None else cache
        # journal_path=None defers to KOALJA_JOURNAL, which must be off;
        # journal_path=False forces the journal off
        _check_no_journal(journal_path)
        self._journal = None
        self._max_rounds = max_rounds
        self._decls: dict = {}
        self._wires: list = []
        self._implicit_edges: list = []
        self._handles: dict = {}
        self._manager: Optional[PipelineManager] = None
        self._watchers: list = []

    @classmethod
    def from_journal(cls, path, **ws_kwargs: Any) -> "Workspace":
        """Rehydrating the forensic stories from a provenance journal is not
        ported yet."""
        raise NotImplementedError(f"Workspace.from_journal is not ported yet ({_ITEM_7})")

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
        """Wireframing the circuit with ghost batches needs the port's ghost
        type, which comes with ``wireframe`` on the training slice."""
        raise NotImplementedError(
            "ghost runs are not ported yet (ROADMAP queue 1 item 2: wireframe "
            "comes with the training slice)"
        )

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
    def topology(self):
        return self._topology

    @property
    def ledger(self):
        """The extended-cloud transfer ledger: None on flat circuits."""
        return self._build().ledger

    @property
    def journal(self):
        """The durable provenance journal (None when journaling is off)."""
        return self._journal

    def compact_journal(self, **kwargs: Any) -> dict:
        """Journal compaction is not ported yet."""
        raise NotImplementedError(f"journal compaction is not ported yet ({_ITEM_7})")

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
        and ``journal`` blocks are None: the port runs flat circuits without
        a journal."""
        out = self._build().stats()
        stats_fn = getattr(self.executor, "stats", None)
        out["executor"] = stats_fn() if stats_fn is not None else None
        out["journal"] = None
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

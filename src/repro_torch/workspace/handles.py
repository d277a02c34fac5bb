"""Typed handles for the Workspace breadboard: TaskHandle, Port, Wire.

These are *declarations*, not live objects — a Workspace materializes them
into SmartTasks and SmartLinks on first run. That split is what makes the
facade fluent: ``camera["image"] >> detect["frame"]`` and
``detect["frame"].buffer(10, slide=2)`` edit the breadboard; nothing touches
the engine until data moves.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Optional

from repro_torch.core.policy import InputSpec


class WiringError(ValueError):
    """A breadboard edit that cannot be realized (bad port, direction, ...)."""


@dataclasses.dataclass
class TaskDecl:
    """Declarative description of one task (pre-materialization)."""

    name: str
    fn: Callable
    inputs: list  # [InputSpec]
    outputs: list  # [str]
    mode: str = "all_new"
    region: str = "local"
    source: bool = False
    services: Optional[dict] = None
    min_interval_s: float = 0.0
    cache_ttl_s: Optional[float] = None
    zone: Optional[str] = None  # extended-cloud pin (TaskHandle.place)
    coalesce_max: Optional[int] = None  # arrival coalescing (TaskHandle.coalesce)

    def input_named(self, name: str) -> Optional[InputSpec]:
        for s in self.inputs:
            if s.name == name:
                return s
        return None

    def replace_input(self, spec: InputSpec) -> None:
        for i, s in enumerate(self.inputs):
            if s.name == spec.name:
                self.inputs[i] = spec
                return
        raise WiringError(f"task {self.name!r} has no input {spec.name!r}")


@dataclasses.dataclass
class WireDecl:
    src_task: str
    output: str
    dst_task: str
    dst_input: str
    link_kwargs: dict = dataclasses.field(default_factory=dict)


class Wire:
    """Handle on a declared wire — lets link policy be set fluently:
    ``(a["s"] >> b["t"]).region("us").fence("eu")``."""

    def __init__(self, ws, decl: WireDecl) -> None:
        self._ws = ws
        self.decl = decl

    def region(self, region: str) -> "Wire":
        self._ws._assert_mutable()
        self.decl.link_kwargs["region"] = region
        return self

    def fence(self, *regions: str) -> "Wire":
        """Refuse AVs originating in the given regions (paper §III.L)."""
        self._ws._assert_mutable()
        self.decl.link_kwargs["fenced_regions"] = tuple(regions)
        return self

    def notify_threshold(self, seconds: float) -> "Wire":
        """Poll-mode fast path (§III.J): arrivals faster than this coalesce
        instead of notifying per event (suppressions are counted in link
        stats; the scheduler batch-polls them at quiescence)."""
        self._ws._assert_mutable()
        self.decl.link_kwargs["notify_threshold_s"] = seconds
        return self

    def capacity(
        self, n: int, overflow: str = "block", block_timeout_s: Optional[float] = None
    ) -> "Wire":
        """Bound this wire's queue to n AVs with a backpressure policy:
        ``block`` (wait for the consumer), ``drop_oldest`` (ring buffer),
        or ``error`` (fail fast)."""
        self._ws._assert_mutable()
        self.decl.link_kwargs["capacity"] = n
        self.decl.link_kwargs["overflow"] = overflow
        if block_timeout_s is not None:
            self.decl.link_kwargs["block_timeout_s"] = block_timeout_s
        return self

    def __repr__(self) -> str:
        d = self.decl
        return f"Wire({d.src_task}.{d.output} >> {d.dst_task}.{d.dst_input})"


class Port:
    """One named input or output of a task. ``>>`` wires output to input."""

    def __init__(self, task: "TaskHandle", name: str, direction: str) -> None:
        assert direction in ("in", "out")
        self.task = task
        self.name = name
        self.direction = direction

    def buffer(self, n: int, slide: Optional[int] = None) -> "Port":
        """Declare the paper's ``[N]`` buffer / ``[N/k]`` sliding window on
        this input: snapshots carry the last N values, advancing by k."""
        if self.direction != "in":
            raise WiringError(
                f"{self.task.name}.{self.name} is an output; buffers apply to inputs"
            )
        self.task._ws._assert_mutable()
        self.task._decl.replace_input(InputSpec(self.name, n, slide))
        return self

    def __rshift__(self, other) -> Wire:
        if self.direction != "out":
            raise WiringError(
                f"wire must start at an output port, got input "
                f"{self.task.name}.{self.name}"
            )
        if isinstance(other, TaskHandle):
            dst = other._input_port(self.name)
        elif isinstance(other, Port):
            dst = other
        else:
            raise WiringError(f"cannot wire into {other!r}")
        if dst.direction != "in":
            raise WiringError(
                f"wire must end at an input port, got output "
                f"{dst.task.name}.{dst.name}"
            )
        return self.task._ws.wire(self, dst)

    def __repr__(self) -> str:
        arrow = "->" if self.direction == "out" else "<-"
        return f"Port({self.task.name}{arrow}{self.name})"


class TaskHandle:
    """Typed reference to a declared task. ``handle["port"]`` resolves a
    Port (KeyError on unknown names — typos fail at wiring time, not at
    run time)."""

    def __init__(self, ws, decl: TaskDecl) -> None:
        self._ws = ws
        self._decl = decl

    @property
    def name(self) -> str:
        return self._decl.name

    @property
    def outputs(self) -> tuple:
        return tuple(self._decl.outputs)

    @property
    def inputs(self) -> tuple:
        return tuple(s.name for s in self._decl.inputs)

    def __getitem__(self, port: str) -> Port:
        if port in self._decl.outputs:
            return Port(self, port, "out")
        if self._decl.input_named(port) is not None:
            return Port(self, port, "in")
        raise KeyError(
            f"task {self.name!r} has no port {port!r} "
            f"(inputs={list(self.inputs)}, outputs={list(self.outputs)})"
        )

    def _input_port(self, name: str) -> Port:
        if self._decl.input_named(name) is None:
            raise WiringError(
                f"task {self.name!r} has no input {name!r} to receive the wire "
                f"(inputs={list(self.inputs)})"
            )
        return Port(self, name, "in")

    def place(self, zone: str) -> "TaskHandle":
        """Pin this task to an extended-cloud zone (paper §IV). Pinned tasks
        always execute there; under ``data_gravity`` placement only
        *unpinned* tasks are pulled toward their input bytes. Requires the
        workspace to carry a :class:`repro.topology.Topology`."""
        self._ws._assert_mutable()
        topo = getattr(self._ws, "_topology", None)
        if topo is None:
            raise WiringError(
                f"cannot place task {self.name!r}: workspace {self._ws.name!r} "
                f"has no topology (pass Workspace(topology=...))"
            )
        if not topo.has_zone(zone):
            raise WiringError(
                f"cannot place task {self.name!r}: topology {topo.name!r} has "
                f"no zone {zone!r} (zones: {topo.zone_names()})"
            )
        self._decl.zone = zone
        return self

    @property
    def zone(self) -> Optional[str]:
        """The declared pin (None = unpinned; placement policy decides)."""
        return self._decl.zone

    def coalesce(self, max_batch: int) -> "TaskHandle":
        """Opt in to arrival coalescing: when a scheduler wave finds this
        task ready with several snapshots buffered, it fires up to
        ``max_batch`` of them in one ``execute`` call — one journal staging
        window per firing, batched hashing per firing — instead of one
        wave round-trip each. Firing order, emissions, and provenance are
        bit-identical to the uncoalesced schedule."""
        self._ws._assert_mutable()
        if max_batch < 1:
            raise WiringError(
                f"coalesce(max_batch={max_batch}) on task {self.name!r}: "
                f"max_batch must be >= 1"
            )
        self._decl.coalesce_max = int(max_batch)
        return self

    def buffer(self, n: int, slide: Optional[int] = None) -> "TaskHandle":
        """Buffer/window annotation on this task's sole input."""
        if len(self._decl.inputs) != 1:
            raise WiringError(
                f"task {self.name!r} has {len(self._decl.inputs)} inputs; "
                f"use handle['input'].buffer(...) to pick one"
            )
        Port(self, self._decl.inputs[0].name, "in").buffer(n, slide)
        return self

    def __rshift__(self, other) -> Wire:
        """Name-matched wiring: ``a >> b`` connects a's single output to
        b's same-named input ('each promise of an output is matched by the
        promise to consume it')."""
        if len(self._decl.outputs) == 1:
            return Port(self, self._decl.outputs[0], "out") >> other
        if isinstance(other, (TaskHandle, Port)):
            dst_decl = other._decl if isinstance(other, TaskHandle) else other.task._decl
            matches = [o for o in self._decl.outputs if dst_decl.input_named(o)]
            if len(matches) == 1:
                return Port(self, matches[0], "out") >> other
        raise WiringError(
            f"task {self.name!r} has outputs {list(self.outputs)}; "
            f"pick one with handle['output'] >> ..."
        )

    def __repr__(self) -> str:
        ins = ", ".join(str(s) for s in self._decl.inputs)
        return f"TaskHandle(({ins}) {self.name} ({', '.join(self.outputs)}))"

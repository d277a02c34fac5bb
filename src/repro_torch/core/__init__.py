"""Koalja core: smart tasks + smart links + annotated values + provenance.

The paper's contribution (Burgess & Prangsma, 2019) as a composable layer:
data circuitry where payloads live in a tiered store, references (Annotated
Values) flow on links, every artifact carries its travel document, and both
'make' (pull) and 'reactive' (push) trigger modes share one engine.

Port of ``repro.core``: payloads may be torch tensors on a card; ghost runs
take :class:`~repro_torch.core.wireframe.ShapeDtypeStruct` specs.
"""

from repro_torch.cache import ContentCache, MemoCache, snapshot_key

from .av import AnnotatedValue, Stamp, content_hash, is_ghost
from .evalloop import EvalLoop, build_eval_circuit
from .link import LinkBackpressureError, RegionFenceError, SmartLink
from .pipeline import Pipeline, PipelineManager
from .policy import InputSpec, SnapshotPolicy
from .provenance import ProvenanceRegistry
from .scheduler import Scheduler, SerialWaveRunner
from .store import ArtifactStore
from .task import ServiceCall, SmartTask, software_version_of
from .wireframe import GhostValue, ShapeDtypeStruct, ghost_run
from .wiring import build_wiring, parse_wiring

__all__ = [
    "AnnotatedValue", "Stamp", "content_hash", "is_ghost",
    "ContentCache", "MemoCache", "snapshot_key",
    "EvalLoop", "build_eval_circuit",
    "LinkBackpressureError", "RegionFenceError", "SmartLink",
    "Pipeline", "PipelineManager",
    "InputSpec", "SnapshotPolicy",
    "ProvenanceRegistry", "ArtifactStore",
    "Scheduler", "SerialWaveRunner",
    "ServiceCall", "SmartTask", "software_version_of",
    "GhostValue", "ShapeDtypeStruct", "ghost_run", "build_wiring", "parse_wiring",
]

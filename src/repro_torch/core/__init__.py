"""Koalja core: smart tasks + smart links + annotated values + provenance.

The paper's contribution (Burgess & Prangsma, 2019) as a composable layer:
data circuitry where payloads live in a tiered store, references (Annotated
Values) flow on links, every artifact carries its travel document, and both
'make' (pull) and 'reactive' (push) trigger modes share one engine.

Port of ``repro.core``: payloads may be torch tensors on a card. Ghost runs
(``GhostValue``, ``ghost_run``) and the evaluation loop (``EvalLoop``,
``build_eval_circuit``) are not ported yet; they come with the training slice
(ROADMAP queue 1 item 2).
"""

from repro_torch.cache import ContentCache, MemoCache, snapshot_key

from .av import AnnotatedValue, Stamp, content_hash, is_ghost
from .link import LinkBackpressureError, RegionFenceError, SmartLink
from .pipeline import Pipeline, PipelineManager
from .policy import InputSpec, SnapshotPolicy
from .provenance import ProvenanceRegistry
from .scheduler import Scheduler, SerialWaveRunner
from .store import ArtifactStore
from .task import ServiceCall, SmartTask, software_version_of
from .wiring import build_wiring, parse_wiring

__all__ = [
    "AnnotatedValue", "Stamp", "content_hash", "is_ghost",
    "ContentCache", "MemoCache", "snapshot_key",
    "LinkBackpressureError", "RegionFenceError", "SmartLink",
    "Pipeline", "PipelineManager",
    "InputSpec", "SnapshotPolicy",
    "ProvenanceRegistry", "ArtifactStore",
    "Scheduler", "SerialWaveRunner",
    "ServiceCall", "SmartTask", "software_version_of",
    "build_wiring", "parse_wiring",
]

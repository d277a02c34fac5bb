"""Annotated Values — the unit of data handover in Koalja (paper §III.I).

An AnnotatedValue (AV) is *not* data. It is a message that points to a storage
location for the data, plus the metadata needed for forensic tracing:

  - a unique identifier,
  - the source task that produced it,
  - pointers (URIs) to the links and storage locations of the actual data,
  - a local timestamp referring to the clock of the source agent,
  - the accumulated travel document (stamped at every checkpoint it passes).

Payloads live in an :class:`repro_torch.core.store.ArtifactStore`; links and tasks
move AVs only. This is the paper's central transport optimization: moving a
reference is free, moving the payload is the thing to avoid.
"""

from __future__ import annotations

import dataclasses
import itertools
import time
from typing import Any, Optional

# Content hashing lives in repro_torch.core.hashing; the names are
# re-exported here because av is the historical import site for them
# throughout the engine.
from .hashing import _stable_hash_bytes, content_hash, is_ghost  # noqa: F401

_AV_COUNTER = itertools.count()


def reserve_uid_numbers(n: int) -> list:
    """Claim ``n`` consecutive-draw uid numbers from the process-global AV
    counter without minting AVs yet.

    The multi-process runtime (:mod:`repro.runtime`) mints output AVs in a
    *runner* process but their identity must live in the parent's uid space:
    the parent reserves the numbers up front, ships them with the work
    order, and the runner builds uids via ``produce(..., uid_no=...)`` — so
    a merged registry can never collide with AVs minted locally in between.
    """
    return [next(_AV_COUNTER) for _ in range(max(0, int(n)))]


@dataclasses.dataclass
class Stamp:
    """One entry in an AV's travel document (paper fig. 8/9)."""

    task: str
    event: str  # "produced" | "consumed" | "cached" | "transit" | "region" | "dropped"
    software_version: str  # code hash of the task that touched it
    timestamp: float
    region: str = "local"
    note: str = ""

    def to_record(self) -> dict:
        return dataclasses.asdict(self)


@dataclasses.dataclass
class AnnotatedValue:
    """Metadata wrapper around a stored payload reference."""

    uid: str
    source_task: str
    uri: str  # storage location in the ArtifactStore
    chash: str  # content hash of the payload
    created_at: float  # clock of the source agent
    region: str = "local"
    meta: dict = dataclasses.field(default_factory=dict)
    travel_document: list = dataclasses.field(default_factory=list)

    @classmethod
    def produce(
        cls,
        payload_hash: str,
        uri: str,
        source_task: str,
        software_version: str,
        region: str = "local",
        meta: Optional[dict] = None,
        uid_no: Optional[int] = None,
    ) -> "AnnotatedValue":
        if uid_no is None:
            uid_no = next(_AV_COUNTER)
        uid = f"av-{uid_no:08d}-{payload_hash[:8]}"
        av = cls(
            uid=uid,
            source_task=source_task,
            uri=uri,
            chash=payload_hash,
            created_at=time.time(),
            region=region,
            meta=dict(meta or {}),
        )
        av.stamp(source_task, "produced", software_version, region=region)
        return av

    def stamp(
        self,
        task: str,
        event: str,
        software_version: str,
        region: str = "local",
        note: str = "",
    ) -> None:
        self.travel_document.append(
            Stamp(
                task=task,
                event=event,
                software_version=software_version,
                timestamp=time.time(),
                region=region,
                note=note,
            )
        )

    @property
    def zone(self) -> Optional[str]:
        """Extended-cloud zone this AV's payload was born in (repro.topology);
        None outside a topology-bound circuit."""
        return self.meta.get("zone")

    @property
    def payload_nbytes(self) -> Optional[int]:
        """Declared payload size riding the AV (set at produce time under a
        topology) — lets placement and ledgers price transfers from metadata
        alone, never touching the payload."""
        return self.meta.get("nbytes")

    @property
    def journey(self) -> list:
        """The traveller log: ordered (task, event) pairs."""
        return [(s.task, s.event) for s in self.travel_document]

    def crossed_regions(self) -> list:
        """Region transitions — audits 'data may not leave region X' policy."""
        regions, out = [], []
        for s in self.travel_document:
            if not regions or regions[-1] != s.region:
                regions.append(s.region)
        for a, b in zip(regions, regions[1:]):
            out.append((a, b))
        return out

    def to_record(self) -> dict:
        d = dataclasses.asdict(self)
        return d

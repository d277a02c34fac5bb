"""Zone partition extraction — what ships to a remote zone runner.

The multi-process runtime (:mod:`repro_torch.runtime`) promotes each extended-cloud
zone to its own runner *process*: the zone's slice of the pipeline — resident
tasks, their placement pins, and the links that stay inside vs. cross the
zone boundary — is the unit of deployment. This module computes that slice
from a :class:`~repro_torch.topology.Topology` plus a built pipeline, in topology
declaration order (the same deterministic order the zoned executors already
use for wave partitions).

The partition is also the journal story of the deployment: the runtime
journals one typed ``partition`` record per zone, so a replay can answer
"which tasks were shipped where" without the runner processes.
"""

from __future__ import annotations

import dataclasses
from typing import Dict

from .topology import Topology


@dataclasses.dataclass
class ZonePartition:
    """One zone's slice of a pipeline: the work order for its runner."""

    zone: str
    tier: str
    tasks: list  # task names resident in this zone (pipeline declaration order)
    pinned: list  # subset of `tasks` the user pinned here (TaskHandle.place)
    internal_links: list  # link names with both endpoints in this zone
    boundary_links: list  # link names crossing into or out of this zone

    def describe(self) -> dict:
        """JSON-safe spec — journaled as a ``partition`` record."""
        return {
            "zone": self.zone,
            "tier": self.tier,
            "tasks": list(self.tasks),
            "pinned": list(self.pinned),
            "internal_links": list(self.internal_links),
            "boundary_links": list(self.boundary_links),
        }

    def __repr__(self) -> str:
        return (
            f"ZonePartition({self.zone!r}, tasks={self.tasks}, "
            f"boundary={len(self.boundary_links)})"
        )


def extract_partitions(topology: Topology, pipeline) -> Dict[str, ZonePartition]:
    """Partition a built pipeline by zone assignment.

    Returns ``{zone_name: ZonePartition}`` with one entry per topology zone
    (declaration order — empty zones included, so a runner fleet is sized by
    the topology, not by which zones happen to hold work right now). A task
    belongs to its current ``zone`` assignment, falling back to the pin and
    then the topology default — the same resolution the zoned executors use
    when they group a wave.
    """
    zone_tasks: dict = {z: [] for z in topology.zone_names()}
    zone_of: dict = {}
    for t in pipeline.tasks.values():
        zone = t.zone or t.pinned_zone or topology.default_zone
        if zone not in zone_tasks:
            raise ValueError(
                f"task {t.name!r} assigned to unknown zone {zone!r} "
                f"(topology {topology.name!r} has {topology.zone_names()})"
            )
        zone_tasks[zone].append(t.name)
        zone_of[t.name] = zone
    out: Dict[str, ZonePartition] = {}
    for zone in topology.zone_names():
        internal, boundary = [], []
        for link in pipeline.links:
            src_in = zone_of.get(link.src_task) == zone
            dst_in = zone_of.get(link.dst_task) == zone
            if src_in and dst_in:
                internal.append(link.name)
            elif src_in or dst_in:
                boundary.append(link.name)
        tasks = zone_tasks[zone]
        out[zone] = ZonePartition(
            zone=zone,
            tier=topology.tier_of(zone),
            tasks=tasks,
            pinned=[
                n for n in tasks if pipeline.tasks[n].pinned_zone == zone
            ],
            internal_links=internal,
            boundary_links=boundary,
        )
    return out

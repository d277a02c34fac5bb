"""Placement policies — move code to data, not data to code.

Both DataX (arXiv 2111.04959) and Bauplan's zero-copy FaaS (2410.17465)
identify *where the function runs relative to its input bytes* as the
decisive cost lever for streaming pipelines; Koalja's edge story says the
same ("minimizing energy expenditure … especially with regard to edge
computing"). A :class:`PlacementPolicy` decides, at **wave-formation
time**, which zone each about-to-fire task executes in:

  - :class:`PinPlacement` (``"pin"``) — a task runs where it was pinned
    (``TaskHandle.place(zone)``), or in the topology's default zone. This is
    the naive all-to-default baseline: every unpinned consumer drags its
    input bytes to the default (cloud) zone.
  - :class:`DataGravityPlacement` (``"data_gravity"``) — an *unpinned* task
    is co-located with the zone holding the largest share of its pending
    input bytes, recomputed from AV sizes each wave. Pinned tasks stay
    pinned (pins are constraints, gravity is an optimization). With the
    snapshot already ingested into the policy buffers, the shares are exact
    for the bytes about to be consumed; ``swap_new_for_old`` reuse of stale
    values is not counted (only data that just arrived exerts gravity).
  - :class:`EnergyAwarePlacement` (``"energy"``) — an unpinned task runs in
    the zone minimizing *total joules*: the transfer energy of pulling its
    pending input bytes from their resident zones **plus** the compute
    energy of processing them there (the zone's ``compute_j_per_mb``
    coefficient). Gravity minimizes bytes moved; energy placement also
    weighs how expensive each zone's silicon is per byte, so it ships data
    off a power-hungry device to a nearby efficient edge site whenever the
    radio joules cost less than the compute joules saved — the paper's §IV
    sustainability objective as a placement rule.

Placement runs on the scheduler thread before ``run_wave`` hands the wave
to the executor, so zone assignment is deterministic: same pipeline, same
pushes → same placements, ledgers, and provenance under every backend.
"""

from __future__ import annotations

from typing import TYPE_CHECKING, Optional, Union

from .topology import Topology, TopologyError

if TYPE_CHECKING:  # pragma: no cover
    from repro_torch.core.pipeline import PipelineManager
    from repro_torch.core.task import SmartTask


class PlacementPolicy:
    """Assigns a zone to each task of a wave (subclass hook: ``zone_for``)."""

    name = "abstract"

    def __init__(self, topology: Topology) -> None:
        self.topology = topology
        self.placements = 0
        self.moves = 0  # assignments that changed a task's zone
        self.by_zone: dict = {}

    def place_wave(self, manager: "PipelineManager", tasks: list) -> None:
        for t in tasks:
            zone = self.zone_for(t, manager)
            self.placements += 1
            self.by_zone[zone] = self.by_zone.get(zone, 0) + 1
            if t.zone != zone:
                if t.zone is not None:
                    self.moves += 1
                t.zone = zone

    def zone_for(self, task: "SmartTask", manager: "PipelineManager") -> str:
        raise NotImplementedError

    def stats(self) -> dict:
        return {
            "policy": self.name,
            "placements": self.placements,
            "moves": self.moves,
            "by_zone": dict(sorted(self.by_zone.items())),
        }

    def __repr__(self) -> str:
        return f"{type(self).__name__}({self.topology.name!r})"


class PinPlacement(PlacementPolicy):
    """Pinned zone, else the topology default — the all-to-default baseline."""

    name = "pin"

    def zone_for(self, task: "SmartTask", manager: "PipelineManager") -> str:
        return task.pinned_zone or self.topology.default_zone


class DataGravityPlacement(PinPlacement):
    """Co-locate an unpinned task with the largest share of its input bytes."""

    name = "data_gravity"

    def zone_for(self, task: "SmartTask", manager: "PipelineManager") -> str:
        if task.pinned_zone is not None:
            return task.pinned_zone
        shares = self._byte_shares(task)
        if not shares:
            return task.zone or self.topology.default_zone
        order = {z: i for i, z in enumerate(self.topology.zone_names())}
        # most bytes wins; ties break to the earliest-declared zone, so the
        # assignment is a pure function of (topology, pending AVs)
        return max(shares, key=lambda z: (shares[z], -order.get(z, len(order))))

    @staticmethod
    def _byte_shares(task: "SmartTask") -> dict:
        shares: dict = {}
        seen: set = set()
        for buf in task.policy.buffers.values():
            # a sliding-window consumer (``input[N/k]``) holds a fresh value
            # in both buf.fresh and buf.window until a snapshot consumes it
            # — dedupe by AV uid so each pending value exerts gravity once
            for av in list(buf.fresh) + list(buf.window):
                uid = getattr(av, "uid", None)
                if uid is not None:
                    if uid in seen:
                        continue
                    seen.add(uid)
                meta = getattr(av, "meta", None)
                if not isinstance(meta, dict):
                    continue
                zone, nbytes = meta.get("zone"), meta.get("nbytes")
                if zone is None or not nbytes:
                    continue
                shares[zone] = shares.get(zone, 0) + int(nbytes)
        return shares


class EnergyAwarePlacement(DataGravityPlacement):
    """Place an unpinned task in the zone minimizing transfer + compute
    joules for its pending input bytes.

    The assignment is a *pure function* of (topology, pending AV byte
    shares, per-zone compute coefficients): candidate cost is

        cost(z) = Σ_src transfer_energy_j(src → z, bytes_src)
                + compute_energy_j(z, Σ bytes)

    evaluated over the topology's zones in declaration order with ties
    breaking to the earliest-declared zone — so placements, ledgers, and
    provenance fingerprints stay identical across every executor backend.
    """

    name = "energy"

    def zone_for(self, task: "SmartTask", manager: "PipelineManager") -> str:
        if task.pinned_zone is not None:
            return task.pinned_zone
        shares = self._byte_shares(task)
        if not shares:
            return task.zone or self.topology.default_zone
        total = sum(shares.values())
        topo = self.topology
        best_zone, best_cost = None, None
        for z in topo.zone_names():
            cost = topo.compute_energy_j(z, total)
            for src in sorted(shares):
                if src == z:
                    continue
                cost += topo.transfer_energy_j(src, z, shares[src])
            # strict < keeps the earliest-declared zone on exact ties
            if best_cost is None or cost < best_cost:
                best_zone, best_cost = z, cost
        return best_zone or self.topology.default_zone


_POLICIES = {
    PinPlacement.name: PinPlacement,
    DataGravityPlacement.name: DataGravityPlacement,
    EnergyAwarePlacement.name: EnergyAwarePlacement,
}


def make_placement(
    spec: Union[str, PlacementPolicy, None], topology: Topology
) -> PlacementPolicy:
    """Resolve ``"pin"`` / ``"data_gravity"`` / ``"energy"`` / a policy
    instance / None (→ data_gravity, the smart default) into a bound
    policy."""
    if isinstance(spec, PlacementPolicy):
        if spec.topology is not topology:
            # A policy bound elsewhere would place tasks into zones this
            # topology never declared — the failure would only surface as a
            # TopologyError deep inside a later stats()/cost() read.
            raise TopologyError(
                f"placement policy {spec!r} is bound to topology "
                f"{spec.topology.name!r}, not {topology.name!r} — construct "
                f"it against the workspace's topology"
            )
        return spec
    name = (spec or DataGravityPlacement.name).strip().lower()
    cls = _POLICIES.get(name)
    if cls is None:
        raise TopologyError(
            f"unknown placement policy {spec!r} (choose from {sorted(_POLICIES)})"
        )
    return cls(topology)

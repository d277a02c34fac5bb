"""repro_torch.topology — the extended-cloud placement layer.

    from repro_torch.topology import Topology

    topo = Topology("iot")
    topo.zone("cloud", tier="cloud")
    topo.zone("edge-a", tier="edge")
    topo.link("cloud", "edge-a", bandwidth_mbps=50, energy_j_per_mb=0.05)

    ws = Workspace("demo", topology=topo, placement="data_gravity")
    sensor = ws.source(read_fn, name="sensor", outputs=["reading"]).place("edge-a")
    ...
    ws.stats()["topology"]["ledger"]["bytes_moved_crosszone"]

Three pieces: :class:`Topology` (named cloud/edge/device zones + per-link
bandwidth/latency/energy costs), :class:`PlacementPolicy` (``pin`` /
``data_gravity`` — where each wave's tasks execute, decided on the
scheduler thread), and :class:`TransferLedger` (bytes and energy charged
only when a payload is *materialized* across a zone edge; references cross
for free). See docs/extended-cloud.md for the runnable walkthrough.
"""

from .ledger import TransferLedger
from .partition import ZonePartition, extract_partitions
from .placement import (
    DataGravityPlacement,
    EnergyAwarePlacement,
    PinPlacement,
    PlacementPolicy,
    make_placement,
)
from .topology import (
    TIERS,
    Topology,
    TopologyError,
    Zone,
    ZoneLink,
    default_topology,
)

__all__ = [
    "TIERS", "Topology", "TopologyError", "Zone", "ZoneLink",
    "default_topology",
    "TransferLedger",
    "PlacementPolicy", "PinPlacement", "DataGravityPlacement",
    "EnergyAwarePlacement", "make_placement",
    "ZonePartition", "extract_partitions",
]

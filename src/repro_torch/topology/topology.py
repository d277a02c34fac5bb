"""Extended-cloud topology model (paper title, §IV).

The paper's pipelines "span the extended cloud": cloud datacenters, edge
sites, and devices form one continuum, and the platform — not the user —
decides where code runs and what bytes cross which boundary. This module
gives that continuum a name: a :class:`Topology` of named :class:`Zone`\\ s
(each in a *tier*: ``cloud`` / ``edge`` / ``device``) connected by
:class:`ZoneLink`\\ s carrying bandwidth / latency / energy costs per
direction.

Zones are *placement domains* — where a task executes and where its output
payloads are born. They are orthogonal to the existing region policy
(regions are jurisdiction labels for fences and audits; zones are physical
locality for transport cost). A link between two zones that was never
declared falls back to tier-pair defaults, so a topology is usable the
moment its zones are named.

The costs matter because the circuit charges them: moving an AV reference
across a zone edge is free (hash-only ghost transfer), but *materializing*
a payload in a zone where it is not resident moves real bytes, and the
:class:`~repro_torch.topology.ledger.TransferLedger` prices that movement with
this topology's per-link ``energy_j_per_mb`` — the paper's "minimizing
energy expenditure and waste … especially with regard to edge computing"
made a number.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Optional

TIERS = ("cloud", "edge", "device")

# Default per-link costs by (tier, tier) pair, used when a zone pair has no
# declared link: (bandwidth_mbps, latency_ms, energy_j_per_mb). Values are
# order-of-magnitude stand-ins for DC backbone / metro edge / last-hop radio.
_TIER_DEFAULTS = {
    ("cloud", "cloud"): (10_000.0, 1.0, 0.01),
    ("cloud", "edge"): (100.0, 20.0, 0.05),
    ("cloud", "device"): (10.0, 50.0, 0.15),
    ("edge", "edge"): (1_000.0, 5.0, 0.02),
    ("edge", "device"): (50.0, 5.0, 0.08),
    ("device", "device"): (10.0, 10.0, 0.10),
}

# Default compute-energy coefficient by tier: joules burned per MB of input
# processed in a zone of that tier. Datacenter silicon is the most efficient
# per byte; battery-powered device hardware the least. Overridable per zone
# (``Topology.zone(..., compute_j_per_mb=...)``) so a topology can model an
# efficient edge accelerator or a power-hungry legacy site.
_TIER_COMPUTE_DEFAULTS = {
    "cloud": 0.02,
    "edge": 0.05,
    "device": 0.12,
}


class TopologyError(ValueError):
    """Bad topology declaration (unknown tier, duplicate/unknown zone)."""


@dataclasses.dataclass(frozen=True)
class Zone:
    """One placement domain in the extended cloud.

    ``compute_j_per_mb`` is the zone's compute-energy coefficient: joules
    per MB of input bytes processed by a task executing here (resolved from
    the tier default at declaration when not set explicitly). It is what
    :class:`~repro_torch.topology.placement.EnergyAwarePlacement` trades against
    link transfer energy, and what the ledger prices executions with."""

    name: str
    tier: str = "cloud"
    compute_j_per_mb: float = _TIER_COMPUTE_DEFAULTS["cloud"]


@dataclasses.dataclass(frozen=True)
class ZoneLink:
    """Directed transport edge between two zones, with its cost model."""

    src: str
    dst: str
    bandwidth_mbps: float
    latency_ms: float
    energy_j_per_mb: float

    def transfer_time_s(self, nbytes: int) -> float:
        return self.latency_ms / 1e3 + (nbytes * 8 / 1e6) / max(
            self.bandwidth_mbps, 1e-9
        )

    def transfer_energy_j(self, nbytes: int) -> float:
        return (nbytes / 1e6) * self.energy_j_per_mb


# Zero-cost self-edge: materializing in the zone where the payload is
# resident is a reference handover, not a transfer.
_SELF_LINK_COSTS = (float("inf"), 0.0, 0.0)


class Topology:
    """Named zones + inter-zone link costs. Insertion order of zones is the
    deterministic tie-break order everywhere (placement, executor partition
    order), so two runs over the same topology always agree."""

    def __init__(self, name: str = "topology", default_zone: Optional[str] = None) -> None:
        self.name = name
        self._zones: dict = {}  # name -> Zone (insertion ordered)
        self._links: dict = {}  # (src, dst) -> ZoneLink
        self._default_zone = default_zone

    # -- declaration --------------------------------------------------------
    def zone(
        self,
        name: str,
        tier: str = "cloud",
        compute_j_per_mb: Optional[float] = None,
    ) -> Zone:
        if tier not in TIERS:
            raise TopologyError(f"unknown tier {tier!r} (choose from {TIERS})")
        if name in self._zones:
            raise TopologyError(f"duplicate zone {name!r}")
        coeff = (
            float(compute_j_per_mb)
            if compute_j_per_mb is not None
            else _TIER_COMPUTE_DEFAULTS[tier]
        )
        if coeff < 0:
            raise TopologyError(
                f"zone {name!r}: compute_j_per_mb must be >= 0, got {coeff}"
            )
        z = Zone(name, tier, coeff)
        self._zones[name] = z
        return z

    def link(
        self,
        a: str,
        b: str,
        *,
        bandwidth_mbps: Optional[float] = None,
        latency_ms: Optional[float] = None,
        energy_j_per_mb: Optional[float] = None,
        symmetric: bool = True,
    ) -> ZoneLink:
        """Declare transport costs between two zones (both directions by
        default). Unset costs fall back to the tier-pair defaults."""
        for z in (a, b):
            if z not in self._zones:
                raise TopologyError(f"unknown zone {z!r} (declare it first)")
        bw, lat, en = self._tier_defaults(a, b)
        link = ZoneLink(
            a,
            b,
            bandwidth_mbps if bandwidth_mbps is not None else bw,
            latency_ms if latency_ms is not None else lat,
            energy_j_per_mb if energy_j_per_mb is not None else en,
        )
        self._links[(a, b)] = link
        if symmetric:
            self._links[(b, a)] = dataclasses.replace(link, src=b, dst=a)
        return link

    # -- lookup -------------------------------------------------------------
    @property
    def default_zone(self) -> str:
        """Explicit default, else the first zone declared."""
        if self._default_zone is not None:
            return self._default_zone
        if not self._zones:
            raise TopologyError(f"topology {self.name!r} has no zones")
        return next(iter(self._zones))

    def zone_names(self) -> list:
        return list(self._zones)

    def has_zone(self, name: str) -> bool:
        return name in self._zones

    def tier_of(self, name: str) -> str:
        return self._zones[name].tier

    def _tier_defaults(self, a: str, b: str) -> tuple:
        ta, tb = self._zones[a].tier, self._zones[b].tier
        key = (ta, tb) if (ta, tb) in _TIER_DEFAULTS else (tb, ta)
        return _TIER_DEFAULTS[key]

    def cost(self, src: str, dst: str) -> ZoneLink:
        """The link that a transfer src→dst rides: declared, or tier-pair
        defaults, or the zero-cost self edge."""
        if src == dst:
            return ZoneLink(src, dst, *_SELF_LINK_COSTS)
        declared = self._links.get((src, dst))
        if declared is not None:
            return declared
        for z in (src, dst):
            if z not in self._zones:
                raise TopologyError(f"unknown zone {z!r} in topology {self.name!r}")
        return ZoneLink(src, dst, *self._tier_defaults(src, dst))

    def compute_j_per_mb(self, zone: str) -> float:
        """The zone's compute-energy coefficient (joules per MB processed)."""
        if zone not in self._zones:
            raise TopologyError(f"unknown zone {zone!r} in topology {self.name!r}")
        return self._zones[zone].compute_j_per_mb

    def compute_energy_j(self, zone: str, nbytes: int) -> float:
        """Joules to process ``nbytes`` of input in ``zone``."""
        return (nbytes / 1e6) * self.compute_j_per_mb(zone)

    def transfer_energy_j(self, src: str, dst: str, nbytes: int) -> float:
        return self.cost(src, dst).transfer_energy_j(nbytes)

    def transfer_time_s(self, src: str, dst: str, nbytes: int) -> float:
        return self.cost(src, dst).transfer_time_s(nbytes)

    def describe(self) -> dict:
        return {
            "name": self.name,
            "default_zone": self.default_zone,
            "zones": {z.name: z.tier for z in self._zones.values()},
            "compute": {
                z.name: z.compute_j_per_mb for z in self._zones.values()
            },
            "links": {
                f"{s}->{d}": {
                    "bandwidth_mbps": l.bandwidth_mbps,
                    "latency_ms": l.latency_ms,
                    "energy_j_per_mb": l.energy_j_per_mb,
                }
                for (s, d), l in self._links.items()
            },
        }

    @classmethod
    def from_spec(cls, spec: dict) -> "Topology":
        """Reconstruct a Topology from a :meth:`describe` dict — the inverse
        used by journal replay, so a rehydrated transfer ledger prices
        energy with the same zone tiers and link costs as the original
        process."""
        topo = cls(spec.get("name", "topology"), default_zone=spec.get("default_zone"))
        compute = spec.get("compute") or {}
        for zname, tier in (spec.get("zones") or {}).items():
            # pre-"compute" journals carry no coefficients; the tier default
            # applies, matching what the live process priced with
            topo.zone(zname, tier=tier, compute_j_per_mb=compute.get(zname))
        for pair, costs in (spec.get("links") or {}).items():
            src, _, dst = pair.partition("->")
            topo.link(
                src,
                dst,
                bandwidth_mbps=costs.get("bandwidth_mbps"),
                latency_ms=costs.get("latency_ms"),
                energy_j_per_mb=costs.get("energy_j_per_mb"),
                symmetric=False,  # describe() lists both directions
            )
        return topo

    # -- canned shapes ------------------------------------------------------
    @classmethod
    def three_zone(cls, name: str = "three-zone") -> "Topology":
        """The canonical extended-cloud chain: cloud ↔ edge ↔ device.
        ``cloud`` is the default zone (unplaced tasks run there)."""
        topo = cls(name)
        topo.zone("cloud", tier="cloud")
        topo.zone("edge", tier="edge")
        topo.zone("device", tier="device")
        topo.link("cloud", "edge")
        topo.link("edge", "device")
        topo.link("cloud", "device")
        return topo

    def __repr__(self) -> str:
        return f"Topology({self.name!r}, zones={self.zone_names()})"


def default_topology() -> Optional[Topology]:
    """Topology selected by the ``KOALJA_TOPOLOGY`` env var: ``flat`` (or
    unset) means no topology — the original single-site semantics — while
    ``3zone`` gives every Workspace the canonical cloud/edge/device chain.
    Lets CI matrix the whole suite over topologies without code changes."""
    name = os.environ.get("KOALJA_TOPOLOGY", "flat").strip().lower()
    if name in ("", "flat", "none"):
        return None
    if name in ("3zone", "three_zone", "three-zone"):
        return Topology.three_zone()
    raise ValueError(
        f"KOALJA_TOPOLOGY={name!r} is not a known topology (flat | 3zone)"
    )

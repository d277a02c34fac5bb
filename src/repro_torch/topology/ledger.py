"""Transfer ledger — the extended-cloud sustainability scorecard (§III.F).

The circuit's transport rule under a topology is *data gravity in reverse*:
AV references cross zone edges freely (hash-only ghost transfer — a few
hundred bytes of metadata), and payload bytes move only when a consumer in
another zone actually **materializes** them. This ledger is where that rule
becomes auditable:

  - ``register_resident(chash, zone)`` — a payload was *born* in a zone
    (task output, edge injection): content is resident there at zero cost.
  - ``on_materialize(chash, nbytes, src, dst)`` — a consumer in ``dst``
    needed the bytes. Same zone, or already resident in ``dst``: nothing
    moves (counted as a local handover / a cross-zone dedup credit). First
    materialization in a new zone: the bytes cross, the (src, dst) pair is
    charged, and the content becomes resident in ``dst`` too.

Energy is *derived*, never accumulated: ``transfer_energy_j`` prices the
per-pair byte totals with the topology's link costs at read time, so the
number is identical no matter which executor ran the waves or in what order
threads finished — the ledger is part of the determinism contract.

Two further accounts ride the same contract (paper §IV sustainability):

  - ``on_execute(zone, nbytes)`` — a task processed ``nbytes`` of input in
    ``zone``. Per-zone processed-byte totals are accumulated and priced at
    read time with the zone's ``compute_j_per_mb`` coefficient
    (``compute_energy_j``); ``total_energy_j`` is transfer + compute.
  - ``credit_zone_local(chash, nbytes, zone)`` — a memo hit was served from
    a replica already resident in the consumer's zone, so a cross-zone
    materialization that the birth zone would otherwise have billed never
    happened. The avoided bytes are credited.
"""

from __future__ import annotations

import threading
from typing import TYPE_CHECKING, Optional

if TYPE_CHECKING:  # pragma: no cover
    from .topology import Topology


class TransferLedger:
    """Byte/energy accounting for payload movement across a Topology."""

    def __init__(self, topology: "Topology") -> None:
        self.topology = topology
        self._lock = threading.Lock()
        self._resident: set = set()  # (chash, zone): content materialized there
        self._pair_bytes: dict = {}  # (src_zone, dst_zone) -> bytes moved
        self._zone_compute_bytes: dict = {}  # zone -> input bytes processed
        self.bytes_moved_crosszone = 0
        self.bytes_not_moved_crosszone = 0  # dedup: already resident in dst
        self.crosszone_transfers = 0
        self.local_handovers = 0  # same-zone materializations (free)
        self.executions_charged = 0  # on_execute calls (compute account)
        self.zone_local_hits = 0  # memo hits served from a same-zone replica
        self.bytes_served_zone_local = 0  # transfer bytes those hits avoided
        # optional durable write-through (repro_torch.provenance.Journal)
        self._journal = None

    def bind_journal(self, journal) -> None:
        """Attach a provenance journal: every residency registration and
        materialization charge appends a typed ``ledger`` record (emitted
        under the ledger lock, so journal order *is* charge order), letting
        a replay rebuild byte/energy totals bit-identically."""
        with self._lock:
            self._journal = journal

    def register_resident(self, chash: str, zone: Optional[str]) -> None:
        if zone is None:
            return
        with self._lock:
            self._resident.add((chash, zone))
            if self._journal is not None:
                self._journal.append(
                    "ledger", {"op": "resident", "chash": chash, "zone": zone}
                )

    def on_materialize(
        self,
        chash: str,
        nbytes: int,
        src_zone: Optional[str],
        dst_zone: Optional[str],
    ) -> bool:
        """Record one consumer materializing a payload. Returns True iff
        bytes actually crossed a zone boundary (first arrival in dst)."""
        if src_zone is None or dst_zone is None:
            return False
        with self._lock:
            if self._journal is not None:
                self._journal.append(
                    "ledger",
                    {
                        "op": "materialize",
                        "chash": chash,
                        "nbytes": int(nbytes),
                        "src": src_zone,
                        "dst": dst_zone,
                    },
                )
            if src_zone == dst_zone:
                self.local_handovers += 1
                self._resident.add((chash, dst_zone))
                return False
            if (chash, dst_zone) in self._resident:
                self.bytes_not_moved_crosszone += nbytes
                return False
            self._resident.add((chash, dst_zone))
            pair = (src_zone, dst_zone)
            self._pair_bytes[pair] = self._pair_bytes.get(pair, 0) + nbytes
            self.bytes_moved_crosszone += nbytes
            self.crosszone_transfers += 1
            return True

    def is_resident(self, chash: str, zone: Optional[str]) -> bool:
        """Is this content already materialized in ``zone``?"""
        if zone is None:
            return False
        with self._lock:
            return (chash, zone) in self._resident

    def on_execute(self, zone: Optional[str], nbytes: int) -> None:
        """Charge the compute account: a task processed ``nbytes`` of input
        in ``zone``. Totals are per-zone sums, so the account is independent
        of thread finish order (same contract as the transfer account)."""
        if zone is None:
            return
        with self._lock:
            if self._journal is not None:
                self._journal.append(
                    "ledger",
                    {"op": "execute", "zone": zone, "nbytes": int(nbytes)},
                )
            self._zone_compute_bytes[zone] = (
                self._zone_compute_bytes.get(zone, 0) + int(nbytes)
            )
            self.executions_charged += 1

    def credit_zone_local(
        self, chash: str, nbytes: int, zone: Optional[str]
    ) -> None:
        """Credit a memo hit served from a replica already resident in the
        consumer's zone: the bytes that a birth-zone billing would have
        moved cross-zone never crossed."""
        if zone is None:
            return
        with self._lock:
            if self._journal is not None:
                self._journal.append(
                    "ledger",
                    {
                        "op": "zone_local",
                        "chash": chash,
                        "nbytes": int(nbytes),
                        "zone": zone,
                    },
                )
            self.zone_local_hits += 1
            self.bytes_served_zone_local += int(nbytes)

    # -- checkpoint snapshot (journal compaction support) --------------------
    def snapshot_state(self) -> dict:
        """Serialize the ledger as the ``ledger`` payload of a journal
        checkpoint: residency set, per-pair byte totals, counters. This is
        the big fold win — thousands of per-materialization ``ledger``
        records collapse to one bounded blob, and energy stays *derived*
        (priced from the restored pair totals at read time)."""
        with self._lock:
            return {
                "resident": sorted(list(p) for p in self._resident),
                "pair_bytes": [
                    [s, d, n] for (s, d), n in sorted(self._pair_bytes.items())
                ],
                "zone_compute_bytes": [
                    [z, n] for z, n in sorted(self._zone_compute_bytes.items())
                ],
                "bytes_moved_crosszone": self.bytes_moved_crosszone,
                "bytes_not_moved_crosszone": self.bytes_not_moved_crosszone,
                "crosszone_transfers": self.crosszone_transfers,
                "local_handovers": self.local_handovers,
                "executions_charged": self.executions_charged,
                "zone_local_hits": self.zone_local_hits,
                "bytes_served_zone_local": self.bytes_served_zone_local,
            }

    def restore_state(self, state: dict) -> None:
        """Rehydrate from a checkpoint snapshot (inverse of
        :meth:`snapshot_state`); tail ``ledger`` records replayed afterwards
        charge on top of the restored totals."""
        with self._lock:
            self._resident = {tuple(p) for p in state.get("resident", [])}
            self._pair_bytes = {
                (s, d): int(n) for s, d, n in state.get("pair_bytes", [])
            }
            self._zone_compute_bytes = {
                z: int(n) for z, n in state.get("zone_compute_bytes", [])
            }
            self.bytes_moved_crosszone = int(state.get("bytes_moved_crosszone", 0))
            self.bytes_not_moved_crosszone = int(
                state.get("bytes_not_moved_crosszone", 0)
            )
            self.crosszone_transfers = int(state.get("crosszone_transfers", 0))
            self.local_handovers = int(state.get("local_handovers", 0))
            self.executions_charged = int(state.get("executions_charged", 0))
            self.zone_local_hits = int(state.get("zone_local_hits", 0))
            self.bytes_served_zone_local = int(
                state.get("bytes_served_zone_local", 0)
            )

    @property
    def transfer_energy_j(self) -> float:
        """Energy priced from per-pair byte totals — order-independent, so
        ledgers agree bit-for-bit across Inline/Concurrent/Zoned backends."""
        with self._lock:
            pairs = dict(self._pair_bytes)
        return sum(
            self.topology.transfer_energy_j(s, d, n) for (s, d), n in sorted(pairs.items())
        )

    @property
    def compute_energy_j(self) -> float:
        """Compute energy priced from per-zone processed-byte totals with
        the zones' ``compute_j_per_mb`` coefficients — derived at read time,
        order-independent like :attr:`transfer_energy_j`."""
        with self._lock:
            zones = dict(self._zone_compute_bytes)
        return sum(
            self.topology.compute_energy_j(z, n) for z, n in sorted(zones.items())
        )

    @property
    def total_energy_j(self) -> float:
        """Transfer + compute joules: the one number the §IV sustainability
        story (and :class:`EnergyAwarePlacement`) minimizes."""
        return self.transfer_energy_j + self.compute_energy_j

    def by_pair(self) -> dict:
        with self._lock:
            return {f"{s}->{d}": n for (s, d), n in sorted(self._pair_bytes.items())}

    def stats(self) -> dict:
        with self._lock:
            pairs = {f"{s}->{d}": n for (s, d), n in sorted(self._pair_bytes.items())}
            zones = dict(sorted(self._zone_compute_bytes.items()))
            out = {
                "bytes_moved_crosszone": self.bytes_moved_crosszone,
                "bytes_not_moved_crosszone": self.bytes_not_moved_crosszone,
                "crosszone_transfers": self.crosszone_transfers,
                "local_handovers": self.local_handovers,
                "executions_charged": self.executions_charged,
                "zone_local_hits": self.zone_local_hits,
                "bytes_served_zone_local": self.bytes_served_zone_local,
                "by_pair": pairs,
                "zone_compute_bytes": zones,
            }
        out["transfer_energy_j"] = self.transfer_energy_j
        out["compute_energy_j"] = self.compute_energy_j
        out["total_energy_j"] = out["transfer_energy_j"] + out["compute_energy_j"]
        return out

    def __repr__(self) -> str:
        return (
            f"TransferLedger(crosszone={self.bytes_moved_crosszone}B, "
            f"energy={self.transfer_energy_j:.4f}J)"
        )

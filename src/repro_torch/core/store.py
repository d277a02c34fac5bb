"""Tiered artifact store with the paper's rho placement policy (§III.F eq. 1).

Port of ``repro.core.store``. Payloads may be torch tensors on a card: the
local tier holds them where they are (the default ``Workspace`` store has no
object tier, so nothing spills), and the object tier writes them with their
own tag, so a round trip returns the same bytes, dtype and device.

Two tiers model the paper's "near and far" storage (§III.G):

  - ``local``  — in-process dict (device/host memory analogue): fast, bounded,
                 LRU-managed.
  - ``object`` — a directory on disk standing in for S3/MinIO object storage:
                 slower, durable, unbounded.

The critical ratio  rho = avg latency(local) / avg latency(object)  is measured
online from actual get() calls; placement policy consults it. The paper "bets on
network attached storage" — we encode that as: artifacts above
``local_bytes_limit`` go to the object tier, small/hot artifacts stay local
(evicting least-recently-used entries to the object tier on pressure), and
Principle 2 (cache close to dependents) lets a consumer *pin* a remote artifact
into its local tier — ``prefetch`` does so for a whole snapshot's inputs ahead
of execution, counting cross-region traffic for the region audit.

Transport avoidance is counted, not just claimed: a ``put`` whose content hash
is already resident moves zero bytes and credits ``bytes_not_moved`` — the
reference-handover half of the paper's sustainability argument (the memo layer
in :mod:`repro_torch.cache` counts the recompute-avoidance half).
"""

from __future__ import annotations

import io
import os
import pickle
import threading
import time
from collections import OrderedDict
from typing import Any, Iterable, Optional, Union

import numpy as np
import torch

from .hashing import content_hash_batch, pickled_nbytes


class _Timer:
    def __init__(self) -> None:
        self.total = 0.0
        self.count = 0

    def add(self, dt: float) -> None:
        self.total += dt
        self.count += 1

    @property
    def avg(self) -> float:
        return self.total / self.count if self.count else 0.0


def _holds_card_tensor(payload: Any) -> bool:
    """True for a tensor off the host, or a dict/list/tuple holding one."""
    if isinstance(payload, torch.Tensor):
        return payload.device.type != "cpu"
    if isinstance(payload, dict):
        return any(_holds_card_tensor(v) for v in payload.values())
    if isinstance(payload, (list, tuple)):
        return any(_holds_card_tensor(v) for v in payload)
    return False


class ArtifactStore:
    """Content-addressed, tiered payload store. URIs: ``local://h``, ``object://h``.

    The local tier is an LRU: ``get``/``put``/``pin_local`` refresh recency,
    and inserts over ``local_bytes_limit`` spill the least-recently-used
    entries to the object tier. Without an object tier there is nowhere safe
    to spill, so the local tier is allowed to grow past the limit rather than
    drop the only copy of a payload.
    """

    def __init__(
        self,
        object_dir: Optional[str] = None,
        local_bytes_limit: int = 1 << 28,  # 256 MiB of "device/host" tier
        region: str = "local",
    ) -> None:
        self._local: OrderedDict = OrderedDict()  # hash -> payload, LRU order
        self._local_bytes = 0
        self._sizes: dict = {}  # hash -> nbytes (every hash ever seen)
        self.local_bytes_limit = local_bytes_limit
        self.object_dir = object_dir
        self.region = region
        self._lock = threading.RLock()
        self._lat = {"local": _Timer(), "object": _Timer()}
        self.puts = 0
        self.gets = 0
        self.pins = 0
        self.prefetches = 0
        self.bytes_moved_to_object = 0
        self.bytes_not_moved = 0
        self.bytes_spilled = 0
        self.evictions_local = 0
        self.cross_region_pins = 0
        self.cross_region_bytes = 0
        # cross-process sharing counters (repro.runtime): payloads staged
        # into / registered from the shared object tier — the bytes that
        # moved via storage so they would NOT have to move over a pipe
        self.publishes = 0
        self.bytes_published = 0
        self.adopts = 0
        # payloads whose content hash fell back to a process-local repr
        # digest (not even picklable) — each one is journaled as an
        # ``unstable_hash`` anomaly through the bound registry
        self.unstable_hashes = 0
        # zone-local tier (repro.topology adaptive runtime): which content
        # hashes have a replica resident in which zone. Fed by task births,
        # cross-zone materializations, and edge injections; consulted on
        # memo hits so a cache hit in zone Z is served from a Z-local
        # replica (never forcing a cross-zone transfer) when one exists.
        self._zone_residents: dict = {}  # zone -> set of content hashes
        self.zone_local_serves = 0  # zone_resident() checks that said yes
        # content hashes whose payload holds a tensor on a card: the process
        # runtime keeps plans reading them in the parent (on_card)
        self._card: set = set()
        self._provenance = None
        if object_dir:
            os.makedirs(object_dir, exist_ok=True)

    # -- zone-local resident index (adaptive runtime, repro.topology) --------
    def note_zone_resident(self, chash: str, zone: Optional[str]) -> None:
        """Record that a replica of ``chash`` is resident in ``zone``."""
        if zone is None:
            return
        with self._lock:
            self._zone_residents.setdefault(zone, set()).add(chash)

    def zone_resident(self, chash: str, zone: Optional[str]) -> bool:
        """Is a replica of ``chash`` resident in ``zone``? A True answer on
        a memo hit means the hit is served zone-locally (counted)."""
        if zone is None:
            return False
        with self._lock:
            hit = chash in self._zone_residents.get(zone, ())
            if hit:
                self.zone_local_serves += 1
            return hit

    def zone_resident_counts(self) -> dict:
        with self._lock:
            return {z: len(s) for z, s in sorted(self._zone_residents.items())}

    def bind_provenance(self, registry: Any) -> None:
        """Give the store a registry to journal ``unstable_hash`` anomalies
        through: a payload that defeats even the pickle hash tier gets a
        process-local digest, which silently breaks memo dedup across
        workers — that deserves a forensic record, not a silent repr."""
        self._provenance = registry

    def _on_unstable(self, note: str) -> None:
        self.unstable_hashes += 1
        reg = self._provenance
        if reg is not None:
            try:
                reg.record_anomaly("store", note)
            except Exception:
                pass

    # -- rho policy ---------------------------------------------------------
    @property
    def rho(self) -> float:
        """avg latency(internal storage) / avg latency(network storage).

        rho < 1 means local is faster (the usual case); the placement policy
        only spills to the object tier on capacity, mirroring the paper's
        conclusion to bet on network storage for bulk, local for hot sets.
        """
        lo, ob = self._lat["local"].avg, self._lat["object"].avg
        if ob == 0.0:
            return 0.0
        return lo / ob

    @staticmethod
    def _nbytes(payload: Any) -> int:
        # a container of tensors is charged the length of its pickle with the
        # tensors by value, as the pickle tier digests it
        if hasattr(payload, "nbytes") and payload.nbytes is not None:
            return int(payload.nbytes)
        try:
            return pickled_nbytes(payload)
        except Exception:
            return 1 << 12

    def _object_path(self, h: str) -> Optional[str]:
        if self.object_dir is None:
            return None
        return os.path.join(self.object_dir, h + ".pkl")

    def _in_object(self, h: str) -> bool:
        path = self._object_path(h)
        return path is not None and os.path.exists(path)

    def _write_object(self, h: str, payload: Any, nbytes: int) -> None:
        path = self._object_path(h)
        if os.path.exists(path):
            return
        t0 = time.perf_counter()
        # Write-then-rename: the object tier is shared across worker
        # processes (repro.runtime), and a writer killed mid-write must
        # never leave a half-file at the content-addressed path — existence
        # of the final path is the "resident" signal everyone trusts.
        tmp = f"{path}.tmp.{os.getpid()}"
        with open(tmp, "wb") as f:
            self._dump(payload, f)
        os.replace(tmp, path)
        self._lat["object"].add(time.perf_counter() - t0)
        self.bytes_moved_to_object += nbytes

    # -- LRU management -----------------------------------------------------
    def _insert_local(self, h: str, payload: Any, nbytes: int) -> None:
        """Caller holds the lock. Insert (or refresh) a local entry, then
        shed LRU entries to the object tier if over the limit — never the
        entry just inserted (a pin must stick even when oversized)."""
        if h in self._local:
            self._local.move_to_end(h)
            return
        self._local[h] = payload
        self._local_bytes += nbytes
        self._sizes[h] = nbytes
        self._enforce_limit(keep=h)

    def _enforce_limit(self, keep: Optional[str] = None) -> None:
        if self.object_dir is None:
            return  # nowhere safe to spill
        while self._local_bytes > self.local_bytes_limit:
            victim = next((h for h in self._local if h != keep), None)
            if victim is None:
                break
            payload = self._local.pop(victim)
            nbytes = self._sizes.get(victim, self._nbytes(payload))
            self._local_bytes -= nbytes
            if not self._in_object(victim):
                self._write_object(victim, payload, nbytes)
                self.bytes_spilled += nbytes
            self.evictions_local += 1

    # -- API ----------------------------------------------------------------
    def put(self, payload: Any, prefer: Optional[str] = None) -> tuple:
        """Store payload; return (uri, content_hash). Reference-dedup by hash:
        re-putting resident content moves zero bytes (counted). Thin wrapper
        over :meth:`put_batch` — the engine's ingest seam."""
        uri, h, _ = self.put_batch((payload,), prefer=prefer)[0]
        return uri, h

    def put_batch(
        self,
        payloads: Iterable[Any],
        prefer: Optional[str] = None,
        hashes: Optional[list] = None,
    ) -> list:
        """Store a wave's payloads in one fused call: all content hashes are
        computed through :func:`content_hash_batch` (one buffer pass for the
        small-array tier), then every placement decision happens under ONE
        lock acquisition. Per-payload semantics and counters are identical
        to N calls to :meth:`put`. ``hashes`` lets a caller that already
        batch-hashed the payloads (e.g. ``finish_execution``) skip the
        rehash. Returns ``[(uri, chash, nbytes), ...]``."""
        payloads = list(payloads)
        if hashes is None:
            hashes = content_hash_batch(payloads, on_unstable=self._on_unstable)
        sizes = [self._nbytes(p) for p in payloads]
        out = []
        with self._lock:
            for payload, h, nbytes in zip(payloads, hashes, sizes):
                out.append((self._put_locked(payload, h, nbytes, prefer), h, nbytes))
        return out

    def _put_locked(self, payload: Any, h: str, nbytes: int, prefer: Optional[str]) -> str:
        self.puts += 1
        self._sizes.setdefault(h, nbytes)
        if _holds_card_tensor(payload):
            self._card.add(h)
        if h in self._local:
            self._local.move_to_end(h)
            self.bytes_not_moved += nbytes
            return f"local://{h}"
        if prefer != "local" and self._in_object(h):
            self.bytes_not_moved += nbytes
            return f"object://{h}"
        tier = prefer
        if tier is None:
            tier = "local" if nbytes <= self.local_bytes_limit else "object"
        if tier == "object" and self.object_dir is None:
            tier = "local"  # no object tier configured
        if tier == "local":
            self._insert_local(h, payload, nbytes)
            return f"local://{h}"
        self._write_object(h, payload, nbytes)
        return f"object://{h}"

    def get(self, uri: str) -> Any:
        """Resolve a reference to its payload. The tier in the URI is a
        placement *hint*, not a location contract: a ``local://`` reference
        whose entry was LRU-spilled after the URI was issued falls back to
        the object tier transparently (content addressing means the hash is
        the identity; the tier may drift underneath old AVs and memo
        records)."""
        tier, h = uri.split("://", 1)
        if tier == "ghost":
            raise KeyError(
                f"ghost artifact {uri} has no payload — ghost runs never "
                f"materialize (§III.K); the spec rides on the AV metadata"
            )
        self.gets += 1
        t0 = time.perf_counter()
        if tier == "local":
            with self._lock:
                if h in self._local:
                    payload = self._local[h]
                    self._local.move_to_end(h)
                    self._lat["local"].add(time.perf_counter() - t0)
                    return payload
            if not self._in_object(h):
                raise KeyError(h)
        path = self._object_path(h)
        with open(path, "rb") as f:
            payload = self._load(f)
        self._lat["object"].add(time.perf_counter() - t0)
        return payload

    def pin_local(self, uri: str, *, region: Optional[str] = None) -> str:
        """Principle 2: cache a (possibly remote) artifact close to a
        dependent. Idempotent — re-pinning a resident hash refreshes recency
        and counts no bytes. ``region`` is the artifact's origin region;
        pins crossing into this store's region are tallied for the audit."""
        tier, h = uri.split("://", 1)
        with self._lock:
            if h in self._local:
                self._local.move_to_end(h)
                return f"local://{h}"
        payload = self.get(uri)
        nbytes = self._sizes.get(h) or self._nbytes(payload)
        with self._lock:
            if h not in self._local:
                self.pins += 1
                if region is not None and region != self.region:
                    self.cross_region_pins += 1
                    self.cross_region_bytes += nbytes
                self._insert_local(h, payload, nbytes)
        return f"local://{h}"

    def prefetch(self, refs: Iterable[Union[str, tuple]]) -> int:
        """Pin a batch of artifacts ahead of a consumer forming a snapshot.

        ``refs`` holds ``uri`` strings or ``(uri, origin_region)`` pairs;
        ghost references are skipped (nothing to move). Returns the number
        of artifacts now resident in the local tier.
        """
        n = 0
        self.prefetches += 1
        for ref in refs:
            uri, region = ref if isinstance(ref, tuple) else (ref, None)
            if uri.startswith("ghost://"):
                continue
            self.pin_local(uri, region=region)
            n += 1
        return n

    def evict_local(self, uri: str) -> None:
        """Drop a local entry. With an object tier configured, the payload is
        spilled there first if it holds no copy, so the artifact stays
        resolvable. Without an object tier the caller is explicitly
        discarding the only copy — later ``get``s of this hash will raise."""
        _, h = uri.split("://", 1)
        with self._lock:
            payload = self._local.pop(h, None)
            if payload is None:
                return
            nbytes = self._sizes.get(h, self._nbytes(payload))
            self._local_bytes -= nbytes
            if self.object_dir is not None and not self._in_object(h):
                self._write_object(h, payload, nbytes)
                self.bytes_spilled += nbytes
            self.evictions_local += 1

    # -- cross-process sharing (repro.runtime) -------------------------------
    def ensure_object_dir(self) -> str:
        """Make sure this store has an on-disk object tier and return its
        path. The object directory is the only payload channel worker
        processes share with the parent — a store born without one (the
        common in-memory default) gets a per-store temp directory the first
        time a process pool spins up."""
        import tempfile

        with self._lock:
            if self.object_dir is None:
                self.object_dir = tempfile.mkdtemp(prefix="koalja-store-")
            else:
                os.makedirs(self.object_dir, exist_ok=True)
            return self.object_dir

    def publish(self, chash: str) -> int:
        """Ensure a content hash resident in the local tier also has an
        object-tier copy, so a worker process can resolve it by hash.
        Returns the bytes written (0 when the object tier already had it —
        the reference crossed, the payload did not move again)."""
        with self._lock:
            if self.object_dir is None:
                raise RuntimeError(
                    "publish() needs an object tier — call ensure_object_dir()"
                )
            if self._in_object(chash):
                return 0
            if chash not in self._local:
                raise KeyError(chash)
            payload = self._local[chash]
            nbytes = self._sizes.get(chash) or self._nbytes(payload)
            self._write_object(chash, payload, nbytes)
            self.publishes += 1
            self.bytes_published += nbytes
            return nbytes

    def export(self, payload: Any) -> tuple:
        """Worker-side ``put``: write a produced payload straight to the
        *shared* object tier (never this process's private local tier) and
        report whether the bytes already existed there.

        Returns ``(uri, chash, nbytes, existed)``. ``existed`` reflects the
        object tier *before* this write — the parent's ``adopt`` uses it to
        keep ``bytes_not_moved`` accounting identical to an in-process
        ``put`` of the same content."""
        return self.export_batch((payload,))[0]

    def export_batch(self, payloads: Iterable[Any], hashes: Optional[list] = None) -> list:
        """Worker-side batch ingest: hash a whole firing's outputs in one
        fused call, then write them to the shared object tier under one
        lock. Returns ``[(uri, chash, nbytes, existed), ...]`` — the same
        tuples N :meth:`export` calls would have produced."""
        payloads = list(payloads)
        if hashes is None:
            hashes = content_hash_batch(payloads, on_unstable=self._on_unstable)
        sizes = [self._nbytes(p) for p in payloads]
        out = []
        with self._lock:
            if self.object_dir is None:
                raise RuntimeError(
                    "export() needs an object tier — call ensure_object_dir()"
                )
            for payload, h, nbytes in zip(payloads, hashes, sizes):
                self.puts += 1
                self._sizes.setdefault(h, nbytes)
                existed = self._in_object(h)
                if not existed:
                    self._write_object(h, payload, nbytes)
                out.append((f"object://{h}", h, nbytes, bool(existed)))
        return out

    def adopt(self, chash: str, nbytes: int, existed: bool = False) -> str:
        """Parent-side bookkeeping for a payload a worker already exported
        to the shared object tier: register the size, count the put, and
        credit ``bytes_not_moved`` exactly when an in-process ``put`` would
        have (content already in this local tier, or already in the object
        tier before the worker wrote). Returns the URI to mint the AV with."""
        nbytes = int(nbytes)
        with self._lock:
            self.puts += 1
            self.adopts += 1
            self._sizes.setdefault(chash, nbytes)
            if chash in self._local:
                self._local.move_to_end(chash)
                self.bytes_not_moved += nbytes
                return f"local://{chash}"
            if existed:
                self.bytes_not_moved += nbytes
            return f"object://{chash}"

    def on_card(self, chash: str) -> bool:
        """Does the payload of ``chash`` hold a tensor on a card?"""
        with self._lock:
            return chash in self._card

    def nbytes_of(self, chash: str) -> Optional[int]:
        """Known size of a content hash (any hash ever put/seen), or None.
        The transfer ledger and data-gravity placement price movement by
        size without ever touching the payload itself."""
        with self._lock:
            return self._sizes.get(chash)

    def has(self, uri: str) -> bool:
        """Tier-strict residency check (is it in *that* tier right now)."""
        tier, h = uri.split("://", 1)
        if tier == "local":
            return h in self._local
        return self._in_object(h)

    def resolvable(self, uri: str) -> bool:
        """Content check: can this store produce the payload from *either*
        tier, regardless of the tier hint in the URI? (Used to reject memo
        records minted against a different store.)"""
        tier, h = uri.split("://", 1)
        if tier == "ghost":
            return False
        with self._lock:
            if h in self._local:
                return True
        return self._in_object(h)

    def _uris(self):
        return {f"local://{k}" for k in self._local}

    # Arrays via np.save for fidelity; tensors via torch.save, so a round
    # trip returns the same bytes, dtype, device and requires_grad (a view is
    # written as a compact copy, not with the whole storage it views);
    # everything else via pickle.
    @staticmethod
    def _dump(payload: Any, f: io.IOBase) -> None:
        if isinstance(payload, np.ndarray):
            f.write(b"NPY0")
            np.save(f, payload, allow_pickle=False)
        elif isinstance(payload, torch.Tensor):
            f.write(b"PT00")
            compact = payload.detach().clone(memory_format=torch.contiguous_format)
            torch.save(compact.requires_grad_(payload.requires_grad), f)
        else:
            f.write(b"PKL0")
            pickle.dump(payload, f, protocol=4)

    @staticmethod
    def _load(f: io.IOBase) -> Any:
        tag = f.read(4)
        if tag == b"NPY0":
            return np.load(f, allow_pickle=False)
        if tag == b"PT00":
            return torch.load(io.BytesIO(f.read()), weights_only=True)
        return pickle.load(f)

    def stats(self) -> dict:
        return {
            "puts": self.puts,
            "gets": self.gets,
            "pins": self.pins,
            "prefetches": self.prefetches,
            "local_bytes": self._local_bytes,
            "local_items": len(self._local),
            "bytes_moved_to_object": self.bytes_moved_to_object,
            "bytes_not_moved": self.bytes_not_moved,
            "bytes_spilled": self.bytes_spilled,
            "evictions_local": self.evictions_local,
            "cross_region_pins": self.cross_region_pins,
            "cross_region_bytes": self.cross_region_bytes,
            "publishes": self.publishes,
            "bytes_published": self.bytes_published,
            "adopts": self.adopts,
            "unstable_hashes": self.unstable_hashes,
            "zone_residents": self.zone_resident_counts(),
            "zone_local_serves": self.zone_local_serves,
            "rho": self.rho,
        }

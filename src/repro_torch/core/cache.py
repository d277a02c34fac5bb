"""Compatibility shim — the memoization subsystem lives in :mod:`repro_torch.cache`.

This file grew into a full subsystem (memo records with forensic
back-pointers, sustainability counters, TTL purge classes); it moved out of
``repro_torch.core`` so the engine and the policy layer can evolve separately.
All earlier imports keep working.
"""

from repro_torch.cache.memo import (  # noqa: F401
    ContentCache,
    MemoCache,
    make_record,
    snapshot_key,
)

__all__ = ["ContentCache", "MemoCache", "make_record", "snapshot_key"]

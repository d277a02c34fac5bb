"""repro_torch.cache — semantic memoization for the Koalja circuit (§III.F).

The engine (``repro_torch.core.pipeline`` / ``repro_torch.core.task``) consults a
:class:`MemoCache` before firing any non-source task: a snapshot whose
(software version, input content hashes, policy mode) key was seen before
short-circuits to the stored output references, emitting ``cache_hit``
visitor-log entries and ``memo_of`` lineage pointers instead of recomputing
and re-transporting payloads.
"""

from .memo import ContentCache, MemoCache, make_record, snapshot_key

__all__ = ["ContentCache", "MemoCache", "make_record", "snapshot_key"]

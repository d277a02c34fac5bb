"""repro_torch.provenance — durable persistence for the forensic stories.

The in-memory registry lives in :mod:`repro_torch.core.provenance` (it is part of
the engine); this package holds what makes it *survive the process*: the
append-only :class:`Journal` (with segment rotation and checkpoint
compaction, so replay cost tracks live state rather than history), the
crash-tolerant readers, and the :func:`replay_journal` rehydrator behind
``Workspace.from_journal``.
"""

from .journal import (
    FORMAT_VERSION,
    Journal,
    JournalCorruptError,
    ReplayedJournal,
    discover_chain,
    merge_segments,
    read_chain,
    read_records,
    replay_files,
    replay_journal,
    replay_segments,
)

__all__ = [
    "FORMAT_VERSION",
    "Journal",
    "JournalCorruptError",
    "ReplayedJournal",
    "discover_chain",
    "merge_segments",
    "read_chain",
    "read_records",
    "replay_files",
    "replay_journal",
    "replay_segments",
]

"""Training data pipeline as a Koalja Workspace (port of
``repro.data.pipeline``).

The circuit, the synthetic generator and the three task functions are the
reference's, line for line, on the ported engine: every ``doc``, ``panel``
and ``batch`` payload is the same numpy array, so its content hash, and each
task's software version (a hash of its source), equal the JAX package's.
Batches stay host numpy arrays here; ``repro_torch.launch.train`` moves them
to the device.

The stages — sample -> tokenize/pack -> batch — are declared on the typed
:class:`repro_torch.workspace.Workspace` breadboard and wired with ports, so every
training batch is an AnnotatedValue whose travel document names the source
shard, the packing code version, and the batch content hash. A checkpoint
restored at step N can therefore name exactly which data batches went into
it (forensic reconstruction, paper §III.C).

The generator is synthetic (deterministic per (seed, step): a Zipf-ish token
sampler) — the "sensor at the edge". Real deployments drop a loader into the
`sample` task; the wiring does not change.
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from repro_torch.models.common import ArchConfig
from repro_torch.workspace import Workspace


def synthetic_batch(
    cfg: ArchConfig, global_batch: int, seq_len: int, step: int, seed: int = 0
) -> dict:
    """Deterministic synthetic LM batch (Zipf-distributed token ids)."""
    rng = np.random.RandomState((seed * 1_000_003 + step) % (2**31 - 1))
    zipf = rng.zipf(1.3, size=(global_batch, seq_len + 1))
    tokens_full = (zipf % cfg.vocab).astype(np.int32)
    batch = {
        "tokens": tokens_full[:, :-1],
        "labels": tokens_full[:, 1:].copy(),
    }
    if cfg.encoder_layers:
        batch["frames"] = rng.randn(global_batch, cfg.frontend_len, cfg.d_model).astype(
            np.float32
        )
    if cfg.frontend == "vision":
        batch["prefix"] = rng.randn(global_batch, cfg.frontend_len, cfg.d_model).astype(
            np.float32
        )
    return batch


class TokenSource:
    """The edge sensor: emits raw document chunks at its own rate."""

    def __init__(self, cfg: ArchConfig, seq_len: int, seed: int = 0):
        self.cfg = cfg
        self.seq_len = seq_len
        self.seed = seed
        self.cursor = 0

    def sample(self) -> np.ndarray:
        rng = np.random.RandomState((self.seed * 7_368_787 + self.cursor) % (2**31 - 1))
        self.cursor += 1
        doc_len = int(rng.randint(self.seq_len // 2, self.seq_len * 2))
        return (rng.zipf(1.3, size=(doc_len,)) % self.cfg.vocab).astype(np.int32)


def build_data_pipeline(
    cfg: ArchConfig,
    global_batch: int,
    seq_len: int,
    seed: int = 0,
    rows_per_pack: Optional[int] = None,
    store=None,
    cache=None,
) -> Workspace:
    """sample -> pack -> batch declared as a Workspace circuit.

    Drive it with ``next_batch(ws, cfg)`` (samples the source until a fresh
    batch AV lands) or ``ws.sample("sample")`` for single reactive ticks.
    A lone ``ws.pull("batch")`` cannot fill the ``doc[4]``/``panel[N]``
    buffers — one pull fires the sensor once — so pull only resolves after
    the circuit has produced a batch (it then returns the cached artifact).

    ``store``/``cache`` pass through to the Workspace: a bounded
    :class:`~repro_torch.core.store.ArtifactStore` gives the batch stream an LRU
    local tier, and the shared :class:`~repro_torch.cache.MemoCache` means a
    replayed shard (identical docs) re-packs and re-batches for free.
    """
    src = TokenSource(cfg, seq_len, seed)
    rows = rows_per_pack or max(1, global_batch // 8)

    def sample() -> dict:
        return {"doc": src.sample()}

    def pack(doc) -> dict:
        # documents are packed/truncated into fixed (rows, seq_len+1) panels
        docs = doc if isinstance(doc, list) else [doc]
        flat = np.concatenate(docs)
        need = rows * (seq_len + 1)
        reps = int(np.ceil(need / max(flat.size, 1)))
        flat = np.tile(flat, reps)[:need]
        return {"panel": flat.reshape(rows, seq_len + 1)}

    def batch(panel) -> dict:
        panels = panel if isinstance(panel, list) else [panel]
        full = np.concatenate(panels, axis=0)[:global_batch]
        while full.shape[0] < global_batch:
            full = np.concatenate([full, full], axis=0)[:global_batch]
        return {"batch": {"tokens": full[:, :-1], "labels": full[:, 1:].copy()}}

    ws = Workspace("data", store=store, cache=cache)
    sample_t = ws.source(sample, name="sample", outputs=["doc"])
    # pack buffers 4 docs per panel; batch consumes n_panels fresh panels
    n_panels = max(1, global_batch // rows)
    pack_t = ws.task(pack, name="pack", inputs=["doc"], outputs=["panel"]).buffer(4)
    batch_t = ws.task(batch, name="batch", inputs=["panel"], outputs=["batch"]).buffer(
        n_panels
    )
    sample_t["doc"] >> pack_t["doc"]
    pack_t["panel"] >> batch_t["panel"]
    return ws


def next_batch(ws: Workspace, cfg: ArchConfig) -> dict:
    """Drive the circuit until a fresh batch AV is produced; return payload."""
    task = ws.pipeline.tasks["batch"]
    before = task.last_outputs.get("batch")
    for _ in range(64):
        ws.sample("sample")
        out = task.last_outputs.get("batch")
        if out is not None and out is not before:
            return ws.value_of(out)
    raise RuntimeError("data pipeline did not produce a batch")

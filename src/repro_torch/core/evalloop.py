"""Make-mode evaluation: 'pull("eval")' recomputes only when something in
its dependency cone changed (paper §III.B/F applied to ML evaluation).

The eval circuit is::

    (checkpoint) eval (report)     # + a frozen eval-set dependency

Pulling ``eval`` after a new checkpoint AV arrives recomputes perplexity;
pulling it again — or after a checkpoint that hashes identically — resolves
from the content cache with zero forward passes. A code change to the eval
fn (new software version) also invalidates, exactly as the paper prescribes
for 'software updates trigger recomputation'.

Port of ``repro.core.evalloop``. The checkpoint payload ``{"params": ...,
"step": ...}`` is a dict of tensors, which digests in the pickle tier, as the
JAX package's dict of arrays does. Tensors pickle there by value, so equal
tensors republished, copied or reloaded digest the same (a memo hit) and
tensors updated in place digest anew.
"""

from __future__ import annotations

from typing import Callable, Optional

from .pipeline import Pipeline, PipelineManager
from .task import SmartTask


def build_eval_circuit(
    eval_fn: Callable,  # (params, eval_batch) -> dict of metrics
    eval_batch,  # frozen eval set (hashed once; a 'cached service response')
    name: str = "eval",
) -> PipelineManager:
    pipe = Pipeline(f"{name}-circuit")

    def run_eval(checkpoint):
        metrics = eval_fn(checkpoint["params"], eval_batch)
        return {"report": {"step": checkpoint.get("step", -1), **metrics}}

    pipe._add_task(
        SmartTask(name, run_eval, inputs=["checkpoint"], outputs=["report"],
                  mode="swap_new_for_old")
    )
    return PipelineManager(pipe)


class EvalLoop:
    """Publish checkpoints; pull reports. Unchanged checkpoints cache-hit."""

    def __init__(self, manager: PipelineManager, name: str = "eval"):
        self.manager = manager
        self.name = name

    def publish(self, params, step: int):
        self.manager._inject(self.name, "checkpoint", {"params": params, "step": step})

    def report(self) -> Optional[dict]:
        task = self.manager.pipeline.tasks[self.name]
        task.ingest()
        if task.ready() or task.last_outputs:
            out = self.manager._pull(self.name)
            return self.manager.value_of(out["report"])
        return None

    @property
    def evals_run(self) -> int:
        return self.manager.pipeline.tasks[self.name].executions

    @property
    def cache_hits(self) -> int:
        return self.manager.pipeline.tasks[self.name].cache_hits

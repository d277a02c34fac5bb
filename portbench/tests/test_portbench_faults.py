"""With the timed path broken underneath, a run (on a cell cut to CPU size,
with the cell's own limits) comes out not correct: once for each fault the
cell can have. One chip: no exchange between chips to leave out."""

import pytest
import torch

from portbench import harness
from portbench.tests.smoke import control_cell

SEED = 2**31 + 11


def correct(name: str) -> bool:
    cell = control_cell(name)
    out = harness.driver(cell.traffic["kind"]).run(cell, SEED, 0.3, False, torch.device("cpu"), 0.0)
    return harness.judge(out["checks"])


@pytest.mark.parametrize("name", ["jamba-serve-prefill-4096", "jamba-serve-decode-b64", "stablelm-serve-prefill-4096",
                                  "minicpm3-serve-mla"])
def test_sound_runs_are_correct(name):
    assert correct(name)


@pytest.mark.parametrize("name", ["jamba-serve-prefill-4096", "jamba-serve-decode-b64", "stablelm-serve-prefill-4096",
                                  "minicpm3-serve-mla"])
def test_serve_token_altered(name, monkeypatch):
    import repro_torch.dist.step as step

    whole = step.decode_step

    def altered(*a, **kw):
        logits, state = whole(*a, **kw)
        logits = logits.clone()
        logits[0] = -logits[0]  # the first request's next token becomes its least likely
        return logits, state

    monkeypatch.setattr(step, "decode_step", altered)
    assert not correct(name)


@pytest.mark.parametrize("name", ["jamba-serve-prefill-4096", "stablelm-serve-prefill-4096", "minicpm3-serve-mla"])
def test_serve_decode_state_left_unchanged(name, monkeypatch):
    import repro_torch.dist.step as step

    whole = step.decode_step

    def stale(model, params, tokens, state, *a, **kw):
        logits, _ = whole(model, params, tokens, state, *a, **kw)
        return logits, state  # caches and position never advance

    monkeypatch.setattr(step, "decode_step", stale)
    assert not correct(name)

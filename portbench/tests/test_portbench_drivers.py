"""Each driver runs a cell cut to CPU size through the whole of a run (the
look for a card skipped) and prints a well-formed last line; the port agrees
with the reference there, so the run is correct."""

import argparse
import json

import pytest
import torch

from portbench import harness
from portbench.run import report
from portbench.tests.smoke import smoke_cell

SEED = 2**31 + 7  # seeds may exceed what 32 signed bits hold


def run_cell(name: str, trace: bool, capsys):
    cell = smoke_cell(name)
    out = harness.driver(cell.traffic["kind"]).run(cell, SEED, 0.5, trace, torch.device("cpu"), 0.0)
    capsys.readouterr()
    assert report(cell, argparse.Namespace(seed=SEED, trace=int(trace)), out) == 0
    printed = capsys.readouterr()
    line = json.loads(printed.out.strip().splitlines()[-1])
    assert list(line)[-1] == "checks"
    assert printed.err.strip().splitlines()[-1].startswith("check ")
    return cell, out, line


@pytest.mark.parametrize("trace", [False, True])
@pytest.mark.parametrize("name", ["jamba-serve-prefill-4096", "jamba-serve-decode-b64", "stablelm-serve-prefill-4096",
                                  "minicpm3-serve-mla"])
def test_a_cell_runs_and_prints_its_line(name, trace, capsys):
    cell, out, line = run_cell(name, trace, capsys)
    for key in ("correct", "attempted", "failed", "metrics", "device"):
        assert key in line
    assert line["correct"] is True, line["checks"]
    assert line["attempted"] > 0 and line["failed"] == 0
    want = {m["name"] for m in (cell.per_layer if trace else cell.end_to_end)}
    got = set(line["metrics"])
    assert got <= want
    if trace:
        assert {"busy_s", "window_s"} <= set(line["device"]) and "breakdown" in line
        # on the host no device operation runs, so no kernel metric has anything to read
        assert not any("roofline" in m for m in got)
    else:  # a window this short may finish no whole round, which a tail needs
        assert "setup_s" in got and got >= want - {"ttft_p95_ms", "itl_p95_ms"}
    for m in line["metrics"].values():
        assert m["value"] == m["value"] and m["unit"]

"""Every cell's files resolve and keep to the contract's forms; each
configuration file is the port's configuration, and the weights the
benchmark draws have the port's parameter layout."""

import json
import re

import pytest
import torch

from portbench import harness, weights

BENCH = json.loads((harness.ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
CELLS = [w["name"] for w in BENCH["workloads"]]
CONFIGS = [c["name"] for c in BENCH["configs"]]


def test_names_units_and_keys():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}
    metrics = BENCH["end_to_end"] + BENCH["per_layer"]
    for m in metrics:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for entry in BENCH["configs"] + BENCH["workloads"]:
        assert NAME.match(entry["name"]) and 1 <= len(entry["why"]) <= 200 and "\n" not in entry["why"]
    assert len({m["name"] for m in metrics}) == len(metrics)
    pairs = {(w["config"], w["traffic"]) for w in BENCH["workloads"]}
    assert len(set(CELLS)) == len(CELLS) == len(pairs)
    e2e = {m["name"] for m in BENCH["end_to_end"]}
    for m in BENCH["per_layer"]:
        assert m["moves"] in e2e and set(m["workloads"]) <= set(CELLS)
    for m in BENCH["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace") and 0 < m["bound"] <= 0.25
    assert 1 <= BENCH["run_seconds"] <= 51 and BENCH["paths"] == ["portbench"]


@pytest.mark.parametrize("cell", CELLS)
def test_every_workload_resolves(cell):
    c = harness.load_cell(cell)
    names = {m["name"] for m in c.end_to_end}
    assert "setup_s" in names and len(names) >= 2 and c.per_layer
    assert (harness.PKG / "drivers" / f"{c.traffic['kind']}.py").exists()
    for m in c.per_layer:
        assert hasattr(harness.reader(m["name"]), "read")
        assert m["moves"] in names
    assert c.limits and all(isinstance(v, (int, float)) for v in c.limits.values())


@pytest.mark.parametrize("name", CONFIGS)
def test_config_file_is_the_ports_configuration(name):
    from repro_torch.models.registry import build_model

    conf = next(c for c in BENCH["configs"] if c["name"] == name)
    config = json.loads((harness.ROOT / conf["file"]).read_text())
    assert set(conf["reduced"]) == set(config["reduced"])
    cfg = harness.arch_config(config)
    model = build_model(cfg)
    want = weights.shapes(model.init(0, "meta"))
    plan = weights.leaves(weights.plan(config))
    stored = weights.DTYPES[config["torch_dtype"]]
    got = [(tuple(leaf[1]), torch.float32 if leaf[0] in ("dt_bias", "a_log") else stored) for leaf in plan]
    assert want == got


def test_port_refuses_a_file_that_differs():
    config = json.loads((harness.ROOT / "portbench/configs/stablelm-1.6b.json").read_text())
    config["intermediate_size"] = 4096
    with pytest.raises(SystemExit, match="intermediate_size"):
        harness.arch_config(config)

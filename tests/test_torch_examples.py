"""The port's examples (``examples/torch_*.py``) on the CPU, each against the
reference's example of the same name where the two can be compared: the
quickstart's result, executions and design map; the wireframe audit's
printed ghost routes, region crossings and fence error; the twin pipelines'
losses and served tokens with the reference's seed-0 weights carried over
(``convert.params_from_jax``). train_lm trains a 128M model: a short run of
the port's alone, whose losses must be finite and whose checkpoint must be
written. The examples are loaded from their files, as a user runs them."""

import contextlib
import importlib.util
import io
import os
import re
from pathlib import Path

import numpy as np
import pytest

REPO = Path(__file__).resolve().parents[1]

# tests/test_torch_train.py's f32 tolerances: a step's loss, and the metrics
# of later steps (parameters moved by AdamW in either package)
LOSS_TOL = dict(rtol=1e-6, atol=1e-5)
METRIC_TOL = dict(rtol=2e-3, atol=1e-6)


def _load(name: str):
    spec = importlib.util.spec_from_file_location(f"example_{name}", REPO / "examples" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _captured(fn, *args, **kwargs):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        out = fn(*args, **kwargs)
    return out, buf.getvalue()


def _recording(mod, seen: dict, instances: list):
    """A Workspace class for ``mod`` that keeps its instances and what each
    task returns, by task name."""

    class Recording(mod.Workspace):
        def __init__(self, *args, **kwargs):
            super().__init__(*args, **kwargs)
            instances.append(self)

        def task(self, fn, *args, name=None, **kwargs):
            def recorded(**inputs):
                out = fn(**inputs)
                seen.setdefault(name, []).append(out)
                return out

            return super().task(recorded, *args, name=name, **kwargs)

    return Recording


def test_quickstart_matches_the_reference(monkeypatch):
    ref = _load("quickstart")
    instances = []
    monkeypatch.setattr(ref, "Workspace", _recording(ref, {}, instances))
    _, ref_out = _captured(ref.main)
    (ws,) = instances
    got, out = _captured(_load("torch_quickstart").main, ["--device", "cpu"])
    want_result = float(re.search(r"^result: (\S+)", ref_out, re.M).group(1))
    np.testing.assert_allclose(got["result"], want_result, rtol=1e-12)
    assert got["executions"] == {n: t.executions for n, t in ws.pipeline.tasks.items()}
    assert got["design_map"] == ws.design_map_text()
    assert "zero re-executions" in out and "story 3" in out


def _mask_uids(text: str) -> str:
    """An AV's uid names its content and the process's count of AVs, which
    other tests run in the same process advance in one package or the other."""
    return re.sub(r"av-\d+-[0-9a-f]+", "av-<uid>", text)


def test_wireframe_audit_matches_the_reference():
    _, ref_out = _captured(_load("wireframe_audit").main)
    got, out = _captured(_load("torch_wireframe_audit").main, ["--device", "cpu"])
    # ghost routes, the lineage's crossings and the fence's refusal; the
    # summary's and report's digests differ (f32 jnp vs f64 torch results)
    assert _mask_uids(out) == _mask_uids(ref_out)
    assert got["routes"] == {"eu_sensor.eu_raw->eu_summarize.eu_raw": 1,
                             "eu_summarize.summary->hq_aggregate.summary": 1}
    assert [(d, t, c) for d, t, c in got["audit"] if c] == [(1, "eu_summarize", [("eu", "us")]),
                                                            (3, "edge:x", [("local", "eu")])]
    assert got["fence"] is not None and "fenced on link eu_sensor.eu_raw->exfil.eu_raw" in got["fence"]
    assert _mask_uids(got["fence"]) in _mask_uids(ref_out)


def test_twin_pipelines_match_the_reference_on_its_weights(monkeypatch):
    import jax

    from repro_torch.configs import get_config
    from repro_torch.models.convert import params_from_jax

    ref = _load("twin_pipelines")
    seen = {}
    monkeypatch.setattr(ref, "Workspace", _recording(ref, seen, []))
    _captured(ref.main)
    want_losses = [out["model_ref"]["loss"] for out in seen["train"]]
    want_labels = [out["label"] for out in seen["recognize"]]

    cfg = get_config("stablelm-1.6b").reduced()
    jparams, _ = ref.build_model(ref.get_config("stablelm-1.6b").reduced()).init(jax.random.key(0))
    got, out = _captured(_load("torch_twin_pipelines").run, "cpu", params_from_jax(cfg, jparams, "cpu"))
    assert len(got["losses"]) == len(want_losses) == 6 and got["frozen"] == 3
    np.testing.assert_allclose(got["losses"][0], want_losses[0], **LOSS_TOL)
    np.testing.assert_allclose(got["losses"], want_losses, **METRIC_TOL)
    assert got["labels"] == want_labels, (got["labels"], want_labels)
    assert "round 2: served with model v6" in out


def test_twin_pipelines_train_from_the_ports_own_init():
    got, _ = _captured(_load("torch_twin_pipelines").main, ["--device", "cpu"])
    assert [label["model_version"] for label in got["labels"]] == [2, 4, 6]
    assert all(np.isfinite(got["losses"])) and got["losses"][-1] < got["losses"][0]
    assert all(len(label["tokens"][0]) == 4 for label in got["labels"])


def test_train_lm_trains_and_checkpoints(tmp_path):
    from repro_torch.launch import train as train_driver

    get_config = train_driver.get_config
    state, out = _captured(_load("torch_train_lm").main,
                           ["--device", "cpu", "--steps", "2", "--batch", "2", "--seq", "32",
                            "--ckpt-dir", str(tmp_path)])
    assert train_driver.get_config is get_config  # the registration is undone
    assert "training stablelm-100m: 128M params" in out
    losses = [float(x) for x in re.findall(r"^step\s+\d+ loss (\S+)", out, re.M)]
    assert len(losses) == 2 and all(np.isfinite(losses)), out
    assert int(state["step"]) == 2
    assert os.listdir(tmp_path) == ["step_00000002"] and os.listdir(tmp_path / "step_00000002")
    with pytest.raises(KeyError):
        get_config("stablelm-100m")


@pytest.mark.parametrize("name", ["torch_quickstart", "torch_wireframe_audit", "torch_twin_pipelines",
                                  "torch_train_lm"])
def test_examples_run_on_the_card_by_default_and_raise_without_one(name, monkeypatch, tmp_path):
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr("tempfile.tempdir", str(tmp_path))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        _load(name).main([])
    assert os.listdir(tmp_path) == []  # nothing made before the refusal

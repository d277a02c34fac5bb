"""The port's host spans (``repro_torch.obs``) on its serve path, on the CPU.

A reduced jamba-v0.1-52b cut to one layout period (Mamba, attention, MoE
and dense FFN layers) serves a prefill and a few decode steps through
``make_serve_fns``: with the profiler off nothing is recorded; under
``torch.profiler`` each layer kind's span counts once a step per layer of
that kind, every span is a host operation inside its step, the logits do
not change, and the benchmark's five ``*_host_ms.decode`` readers read the
registry per step. ``graph_share.decode`` reads the counters of the decode
paths (``obs.count``): the share of the traced steps a CUDA graph's replay
served, 0 for the CPU's eager steps.
"""

import dataclasses
import sys
from pathlib import Path

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from repro_torch import obs
from repro_torch.configs import get_config
from repro_torch.dist.step import make_serve_fns
from repro_torch.models.registry import build_model, init_serve_state

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from portbench import harness  # noqa: E402

B, PROMPT, MAX_LEN = 2, 8, 16
READERS = ["moe_host_ms.decode", "mamba_host_ms.decode", "attn_host_ms.decode", "kernel_host_ms.decode",
           "rest_host_ms.decode"]


@pytest.fixture(scope="module")
def served():
    cfg = get_config("jamba-v0.1-52b").reduced()
    cfg = dataclasses.replace(cfg, n_layers=len(cfg.layout))
    model = build_model(cfg)
    params = model.init(0, "cpu")
    prefill_fn, decode_fn = make_serve_fns(model, "cpu", max_len=MAX_LEN, global_batch=B)
    prompts = torch.randint(0, cfg.vocab, (B, PROMPT), generator=torch.Generator().manual_seed(1))
    return cfg, model, params, prefill_fn, decode_fn, prompts


def _serve(served, steps: int, traced: bool):
    """Prefill, then ``steps`` decode steps, the steps alone under the
    profiler when ``traced``; (every step's logits, the profiler or None)."""
    cfg, model, params, prefill_fn, decode_fn, prompts = served
    state = init_serve_state(model, B, MAX_LEN, "cpu")
    logits, state = prefill_fn(params, prompts, state)
    out = [logits]

    def steps_():
        nonlocal logits, state
        for _ in range(steps):
            logits, state = decode_fn(params, logits.argmax(dim=-1)[:, None], state)
            out.append(logits)

    prof = None
    if traced:
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            steps_()
    else:
        steps_()
    return out, prof


def _kinds(cfg) -> dict:
    layers = [cfg.layout[i % len(cfg.layout)] for i in range(cfg.n_layers)]
    return {"moe": sum(s.ffn == "moe" for s in layers), "ffn": sum(s.ffn == "dense" for s in layers),
            "mamba": sum(s.mixer == "mamba" for s in layers), "attention": sum(s.mixer == "attention" for s in layers)}


def test_off_records_nothing(served):
    obs.reset_spans()
    _serve(served, 3, traced=False)
    assert obs.span_totals() == {}
    assert obs.span("serve.decode", phase="decode") is obs.span("moe")  # the one shared no-op


@pytest.mark.parametrize("steps", [1, 3])
def test_each_kind_counts_once_a_step_per_layer(served, steps):
    cfg = served[0]
    kinds = _kinds(cfg)
    assert all(kinds.values())  # the cut holds every kind
    obs.reset_spans()
    _serve(served, steps, traced=True)
    totals = obs.span_totals()
    assert set(totals) == {"decode"}  # the prefill ran untraced
    dec = totals["decode"]
    assert dec["repro_torch.serve.decode"][0] == steps
    assert dec["repro_torch.serve.check"][0] == steps
    assert dec["repro_torch.embed"][0] == dec["repro_torch.head"][0] == steps
    for kind, n in kinds.items():
        assert dec[f"repro_torch.{kind}"][0] == steps * n, kind
    for part in ("route", "dispatch", "experts", "combine"):
        assert dec[f"repro_torch.moe.{part}"][0] == steps * kinds["moe"], part
    # ln1 and ln2 of every layer (each has an FFN) and the head's final norm
    assert dec["repro_torch.norm"][0] == steps * (2 * cfg.n_layers + 1)
    assert dec["repro_torch.kernel.moe_gmm"][0] == steps * kinds["moe"]
    assert dec["repro_torch.kernel.flash_decode"][0] == steps * kinds["attention"]
    assert all(c > 0 and s >= 0 for c, s in dec.values())
    step_s = dec["repro_torch.serve.decode"][1]
    assert sum(dec[f"repro_torch.{k}"][1] for k in kinds) < step_s


def test_prefill_counts_under_its_phase(served):
    cfg, model, params, prefill_fn, _, prompts = served
    obs.reset_spans()
    with profile(activities=[ProfilerActivity.CPU]):
        prefill_fn(params, prompts, init_serve_state(model, B, MAX_LEN, "cpu"))
    totals = obs.span_totals()
    assert set(totals) == {"prefill"}
    pre = totals["prefill"]
    assert pre["repro_torch.serve.prefill"][0] == pre["repro_torch.serve.check"][0] == 1
    assert pre["repro_torch.mamba"][0] == _kinds(cfg)["mamba"]
    assert pre["repro_torch.kernel.mamba_scan"][0] == _kinds(cfg)["mamba"]
    assert pre["repro_torch.kernel.flash_attention"][0] == _kinds(cfg)["attention"]


def test_spans_are_host_ops_inside_their_step(served):
    obs.reset_spans()
    _, prof = _serve(served, 3, traced=True)
    events = [e for e in prof.events() if e.name.startswith("repro_torch.")]
    steps = [e for e in events if e.name == "repro_torch.serve.decode"]
    assert len(steps) == 3
    names = {e.name for e in events}
    assert {"repro_torch.moe", "repro_torch.mamba", "repro_torch.attention", "repro_torch.kernel.moe_gmm"} <= names
    for e in events:
        assert e.is_user_annotation is False, e.name
        assert str(e.device_type).endswith("CPU"), e.name
        assert any(s.time_range.start <= e.time_range.start and e.time_range.end <= s.time_range.end
                   for s in steps), e.name
    # the registry counts what the trace holds
    dec = obs.span_totals()["decode"]
    for name in names:
        assert dec[name][0] == sum(e.name == name for e in events), name


def test_logits_bit_equal_with_and_without_the_profiler(served):
    plain, _ = _serve(served, 3, traced=False)
    traced, _ = _serve(served, 3, traced=True)
    assert len(plain) == len(traced) == 4
    for a, b in zip(plain, traced):
        assert torch.equal(a, b)


@pytest.mark.parametrize("name", READERS + ["graph_share.decode"])
def test_reader_gives_none_on_an_empty_registry(name):
    obs.reset_spans()
    assert harness.reader(name).read({}) is None


@pytest.mark.parametrize("name", READERS)
def test_reader_reads_host_ms_a_step(served, name):
    steps = 3
    obs.reset_spans()
    _serve(served, steps, traced=True)
    dec = obs.span_totals()["decode"]
    ms = {k: 1e3 * s / steps for k, (_, s) in dec.items()}
    want = {
        "moe_host_ms.decode": ms["repro_torch.moe"],
        "mamba_host_ms.decode": ms["repro_torch.mamba"],
        "attn_host_ms.decode": ms["repro_torch.attention"],
        "kernel_host_ms.decode": sum(v for k, v in ms.items() if k.startswith("repro_torch.kernel.")),
        "rest_host_ms.decode": ms["repro_torch.serve.decode"] - ms["repro_torch.moe"] - ms["repro_torch.mamba"]
        - ms["repro_torch.attention"],
    }
    got = harness.reader(name).read({})
    assert got == pytest.approx(want[name], rel=1e-12) and got >= 0
    # the three blocks and the rest make the whole step
    parts = sum(harness.reader(n).read({}) for n in ("moe_host_ms.decode", "mamba_host_ms.decode",
                                                     "attn_host_ms.decode", "rest_host_ms.decode"))
    assert parts == pytest.approx(ms["repro_torch.serve.decode"], rel=1e-9)


def test_graph_share_reads_the_replayed_share(served):
    obs.reset_spans()
    _serve(served, 3, traced=True)  # on the CPU every step is eager
    assert obs.count_totals() == {"decode": {"repro_torch.graph.eager": 3}}
    assert harness.reader("graph_share.decode").read({}) == 0.0
    obs.reset_spans()
    with profile(activities=[ProfilerActivity.CPU]):
        obs.count("graph.eager")  # outside a serve phase: not a decode step
        with obs.span("serve.decode", phase="decode"):
            for name in ("graph.eager", "graph.capture", "graph.copy_in", "graph.replay", "graph.replay",
                         "graph.replay"):
                obs.count(name)
    assert obs.count_totals()["decode"]["repro_torch.graph.replay"] == 3
    assert harness.reader("graph_share.decode").read({}) == 75.0

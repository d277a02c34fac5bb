"""The plain reference agrees with the port at a tiny size on the CPU (f32
both): served logits and tokens through the caches, with capacity drops at
prefill, the q, k and v biases, and MLA's absorbed decode over its latent
cache."""

import pytest
import torch

from portbench import harness
from portbench.reference import model as ref_model
from portbench.tests.smoke import control_cell, smoke_cell
from portbench.weights import make_params


@pytest.mark.parametrize("name", ["jamba-serve-prefill-4096", "stablelm-serve-prefill-4096", "minicpm3-serve-mla"])
def test_served_logits_follow_the_port_through_its_caches(name):
    from repro_torch.dist.step import make_serve_fns
    from repro_torch.models.registry import build_model, init_serve_state

    cell = smoke_cell(name)
    conf, dev = cell.config, torch.device("cpu")
    moe = conf["arch"] == "jamba-v0.1-52b"
    if moe:
        conf["capacity_factor"] = 0.5  # bins of 16 slots for the prefill's 120: the capacity rule drops
    elif conf["arch"] == "stablelm-1.6b":
        assert conf["use_qkv_bias"]
    cfg = harness.arch_config(conf)
    model = build_model(cfg)
    B, Lp, G = 3, 20, 5
    prefill, decode = make_serve_fns(model, dev, max_len=Lp + G + 8, global_batch=B)
    params = make_params(conf, 5, dev)
    prompts = torch.randint(0, conf["vocab_size"], (B, Lp), generator=torch.Generator().manual_seed(1))
    state = init_serve_state(model, B, Lp + G + 8, dev)
    logits, state = prefill(params, prompts, state)
    got, toks = [logits], [logits.argmax(-1)[:, None]]
    for _ in range(G - 1):
        logits, state = decode(params, toks[-1], state)
        got.append(logits)
        toks.append(logits.argmax(-1)[:, None])
    served = torch.cat(toks, dim=1)
    ref, dropped = ref_model.served_logits(conf, params, prompts, served, ref_model.Precision("f32"))
    assert (dropped > 0) == moe
    torch.testing.assert_close(torch.stack(got, dim=1), ref, rtol=1e-4, atol=1e-4)
    assert float(ref_model.logit_gaps(ref, served).max()) < 1e-4


def test_the_fp8_control_reads_far_above_the_reference():
    """At the control study's CPU size (hidden 256, 16 served tokens), where
    float8 products move some served token off the reference's best."""
    cell = control_cell("stablelm-serve-prefill-4096")
    conf, dev = cell.config, torch.device("cpu")
    params = make_params(conf, 9, dev)
    prompts = torch.randint(0, conf["vocab_size"], (2, 32), generator=torch.Generator().manual_seed(2))
    served = torch.randint(0, conf["vocab_size"], (2, 16), generator=torch.Generator().manual_seed(3))
    ref, _ = ref_model.served_logits(conf, params, prompts, served, ref_model.Precision("f32"))
    low, _ = ref_model.served_logits(conf, params, prompts, served, ref_model.Precision("fp8"))
    assert float(ref_model.logit_gaps(ref, ref.argmax(-1)).max()) == 0.0
    assert float(ref_model.logit_gaps(ref, low.argmax(-1)).max()) > 1e-3
    assert float((low - ref).abs().max()) > 1e-2


def _control_reading(name: str, seed: int) -> dict:
    import json
    import subprocess
    import sys

    proc = subprocess.run([sys.executable, "portbench/control.py", "--workload", name, "--control-seeds", str(seed)],
                          cwd=harness.ROOT, capture_output=True, text=True, timeout=1800)
    assert proc.returncode == 0, proc.stderr[-2000:]
    print(proc.stdout.strip().splitlines()[-1])
    return json.loads(proc.stdout.strip().splitlines()[-1])


@pytest.mark.card
@pytest.mark.parametrize("name", ["jamba-serve-prefill-4096", "jamba-serve-decode-b64", "stablelm-serve-prefill-4096",
                                  "minicpm3-serve-mla"])
def test_the_control_fails_at_the_cells_size(name, card):
    """On the card, at the cell's own size: the program is within every
    limit and the control is beyond one of them."""
    cell = harness.load_cell(name)
    line = _control_reading(name, 2**31 + 101)
    compared = lambda numbers: {k: (v, cell.limits[k]) for k, v in numbers.items() if k in cell.limits}  # noqa: E731
    assert harness.judge(compared(line["program"]))
    assert not harness.judge(compared(line["control"]))


@pytest.mark.parametrize("name", ["jamba-serve-prefill-4096", "jamba-serve-decode-b64", "stablelm-serve-prefill-4096",
                                  "minicpm3-serve-mla"])
def test_the_control_study_at_cpu_size(name):
    """``control.py``'s readings on a cell cut to CPU size, against the
    cell's own limits: the program (f32 here) within every one and the
    altered token beyond one; the control (float8 products) wider than the
    program, since the limits are set for the depth and widths of the cell,
    where float8 drifts further (the card test holds it at the cell's own
    size)."""
    control = harness.load_module(harness.PKG / "control.py", "portbench_control")
    cell = control_cell(name)
    line = control.serve_readings(cell, 2**31 + 21, torch.device("cpu"), True)

    def within(numbers: dict) -> bool:
        return harness.judge({k: (v, cell.limits[k]) for k, v in numbers.items() if k in cell.limits})

    assert within(line["program"])
    assert not within(line["fault_token_altered"]), line["fault_token_altered"]
    for k, v in line["control"].items():
        assert v > 10 * line["program"][k] and v > 0

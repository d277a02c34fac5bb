"""Phase 3b's gate of ``chip_smoke.py`` (``forced_routing_gate``), on CPU
tensors: the logits, greedy tokens and router probabilities of a kernels run
against the plain versions run on the kernels' routing, in bf16 and in f32;
phase 4's bound for ``mamba_scan`` (``scan_bound``); phase 3c's count of
device-to-host copies (``device_to_host_copies``), which on the CPU can only
show that work that never leaves its device counts no copy; and the gradient
gate of phases 5c, 5g and 5h (``gradient_gate``)."""

import importlib.util
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
_spec = importlib.util.spec_from_file_location("chip_smoke", ROOT / "chip_smoke.py")
chip_smoke = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(chip_smoke)

LOGIT_TOL = chip_smoke.LOGIT_TOL["bfloat16"]
PROB_TOL = chip_smoke.ROUTER_PROB_TOL


def _run(seed=0, B=2, steps=3, V=50, calls=(64, 4, 4), E=16, K=2):
    """Logits (B, steps, V), and per MoE call router probabilities (T, E) and
    their top-K experts, as a kernels run records them."""
    g = torch.Generator().manual_seed(seed)
    logits = torch.randn(B, steps, V, generator=g) * 3
    probs = [torch.softmax(torch.randn(T, E, generator=g), -1) for T in calls]
    experts = [torch.sort(p, dim=-1, descending=True, stable=True)[1][:, :K] for p in probs]
    return logits, probs, experts


def _gate(kernels, forced, probs_k, probs_f, experts):
    return chip_smoke.forced_routing_gate(kernels, forced, probs_k, probs_f, experts, logit_tol=LOGIT_TOL,
                                          prob_tol=PROB_TOL)


def test_tolerances_are_fixed():
    assert LOGIT_TOL == 0.25
    assert 0 < PROB_TOL < 0.1


def test_equal_runs_pass():
    logits, probs, experts = _run()
    failures, st = _gate(logits, logits.clone(), probs, [p.clone() for p in probs], experts)
    assert failures == []
    assert st["diff"] == st["dprob"] == 0 and st["rerouted"] == 0
    assert st["agree"] == st["n"] == 6 and st["tokens"] == 72


def test_differences_within_the_tolerances_pass():
    logits, probs, experts = _run(1)
    forced = logits + 0.6 * LOGIT_TOL  # same greedy tokens
    probs_f = [p.clone() for p in probs]
    probs_f[0][3, 5] += 0.9 * PROB_TOL
    failures, st = _gate(logits, forced, probs, probs_f, experts)
    assert failures == [], failures
    assert st["dprob"] == pytest.approx(0.9 * PROB_TOL, rel=1e-5)


@pytest.mark.parametrize("scale", [1.01, 1.5, 10.0])
def test_a_router_prob_difference_over_the_tolerance_fails(scale):
    logits, probs, experts = _run(2)
    probs_f = [p.clone() for p in probs]
    probs_f[1][2, 7] += scale * PROB_TOL
    failures, _ = _gate(logits, logits.clone(), probs, probs_f, experts)
    assert any("max |router prob diff|" in f for f in failures), failures


def test_every_router_prob_moved_within_the_tolerance_passes():
    logits, probs, experts = _run(3)
    probs_f = [p + 0.5 * PROB_TOL for p in probs]
    failures, st = _gate(logits, logits.clone(), probs, probs_f, experts)
    assert failures == [] and st["dprob"] == pytest.approx(0.5 * PROB_TOL, rel=1e-4)


@pytest.mark.parametrize("where", ["kernels", "forced"])
@pytest.mark.parametrize("bad", [float("nan"), float("inf"), -float("inf")])
def test_non_finite_logits_fail(where, bad):
    logits, probs, experts = _run(4)
    kernels, forced = logits.clone(), logits.clone()
    (kernels if where == "kernels" else forced)[1, 2, 3] = bad
    failures, _ = _gate(kernels, forced, probs, [p.clone() for p in probs], experts)
    assert "non-finite logits" in failures


def test_non_finite_router_probabilities_fail():
    logits, probs, experts = _run(5)
    probs_f = [p.clone() for p in probs]
    probs_f[2][0, 0] = float("nan")
    failures, _ = _gate(logits, logits.clone(), probs, probs_f, experts)
    assert "non-finite router probabilities" in failures


def test_a_logit_difference_over_the_tolerance_fails():
    logits, probs, experts = _run(6)
    forced = logits.clone()
    forced[0, 1] += 1.2 * LOGIT_TOL
    failures, st = _gate(logits, forced, probs, [p.clone() for p in probs], experts)
    assert any("max |logit diff|" in f for f in failures)
    assert st["diff"] == pytest.approx(1.2 * LOGIT_TOL, rel=1e-5)


def test_a_tie_within_error_passes():
    """A greedy token that differs is a tie within error when the plain run's
    top logit beats the kernels' token by at most twice the row's logit
    difference (with the row's max difference, every flip inside the logit
    tolerance is one)."""
    logits, probs, experts = _run(8)
    logits[0, 2, :2] = torch.tensor([5.0, 4.99])  # a near tie, the kernels pick token 0
    logits[0, 2, 2:] = logits[0, 2, 2:].clamp(max=4.0)
    forced = logits.clone()
    forced[0, 2, 0] -= 0.02  # the plain run picks token 1, by less than twice its logit difference
    failures, st = _gate(logits, forced, probs, [p.clone() for p in probs], experts)
    assert failures == [], failures
    assert st["ties"] == 1


def test_rerouted_tokens_are_counted_not_gated():
    logits, probs, experts = _run(9, calls=(32,))
    probs[0][:5] = torch.softmax(torch.arange(16.0), -1)
    probs[0][:5, 13] = probs[0][:5, 14] - 1e-7  # experts 14 and 13 nearly tied at second place
    experts = [torch.sort(p, dim=-1, descending=True, stable=True)[1][:, :2] for p in probs]
    probs_f = [p.clone() for p in probs]
    probs_f[0][:3, 13] += 2e-7  # the plain run's own router picks 13 for three tokens
    failures, st = _gate(logits, logits.clone(), probs, probs_f, experts)
    assert failures == [] and st["rerouted"] == 3


def test_a_missing_router_call_fails():
    logits, probs, experts = _run(10)
    failures, _ = _gate(logits, logits.clone(), probs, [p.clone() for p in probs[:-1]], experts)
    assert any("router calls recorded" in f for f in failures)


@pytest.mark.parametrize("tol", [1e-3, 0.25])
def test_logit_comparison_alone(tol):
    """The free-routing and f32 comparisons: the same logit rules, no router."""
    logits, _, _ = _run(11)
    assert chip_smoke.logit_comparison(logits, logits + 0.5 * tol, tol)[0] == []
    failures, st = chip_smoke.logit_comparison(logits, logits + 2 * tol, tol)
    assert [f for f in failures if "max |logit diff|" in f] and st["diff"] == pytest.approx(2 * tol, rel=1e-4)


@pytest.mark.parametrize("scale,passes", [(0.5, True), (2.0, False)])
def test_the_f32_gate_holds_the_logits_at_the_f32_tolerance(scale, passes):
    """In f32 the same gate runs at LOGIT_TOL["float32"]: a difference far
    inside the bf16 tolerance still fails there."""
    tol = chip_smoke.LOGIT_TOL["float32"]
    logits, probs, experts = _run(12)
    failures, st = chip_smoke.forced_routing_gate(logits, logits + scale * tol, probs, [p.clone() for p in probs],
                                                  experts, logit_tol=tol, prob_tol=PROB_TOL)
    assert (failures == []) == passes, failures
    assert st["diff"] == pytest.approx(scale * tol, rel=1e-3)


# jamba-v0.1-52b's prefill scan: B 4, L 512, Di 8192, N 16, bf16 xc, f32 dt,
# B/C, A and h0 read once, y and the final h written once
SCAN_ELEMENTS = 4 * 512 * 8192 * 16
SCAN_BYTES = 4 * 512 * 8192 * (2 + 4 + 4) + 2 * 4 * 512 * 16 * 4 + 8192 * 16 * 4 + 2 * 4 * 8192 * 16 * 4


def test_scan_bound_at_jambas_prefill_is_bytes():
    """On 132 SMs at 1980 MHz the exponentials alone on the SFU would take
    longer than the bytes, but shared with the FMA pipes they take less."""
    ms, by, sfu_ms = chip_smoke.scan_bound(SCAN_ELEMENTS, SCAN_BYTES, 132, 1980.0)
    assert by == "bytes" and ms == pytest.approx(SCAN_BYTES / chip_smoke.PEAK_BYTES_PER_S * 1e3)
    assert sfu_ms == pytest.approx(SCAN_ELEMENTS / (16 * 132 * 1980e6) * 1e3) and sfu_ms > ms


@pytest.mark.parametrize("n_sms,clock", [(132, 1980.0), (132, 1000.0), (2000, 1980.0)])
def test_scan_bound_operations(n_sms, clock):
    """With no bytes the bound is the operations: the exponentials shared so
    that the SFU and the FMA pipes finish together, which is below the SFU
    alone and above the FMA pipes' own work, or that work alone where the
    SFU is fast enough to take every exponential."""
    ms, by, sfu_ms = chip_smoke.scan_bound(SCAN_ELEMENTS, 0, n_sms, clock)
    fma_ms = chip_smoke.SCAN_FMA_INSTRS * SCAN_ELEMENTS / (chip_smoke.PEAK_FLOPS["float32"] / 2) * 1e3
    assert by == "operations" and ms >= fma_ms
    if sfu_ms <= fma_ms:
        assert ms == pytest.approx(fma_ms)
    else:
        assert fma_ms < ms < sfu_ms


@pytest.mark.parametrize("device", ["cpu", "meta"])
def test_device_to_host_copies_none_within_a_device(device):
    """Work that stays on one device, host reads of host tensors included,
    counts no copy from a device to the host."""
    x = torch.ones(8, device=device)

    def work():
        y = (x * 2 + 1).sum()
        torch.empty(8, device=device).copy_(x)
        if device == "cpu":
            y.item(), x.cpu(), x.numpy()

    assert chip_smoke.device_to_host_copies(work) == []


def _grads(seed, scale=1.0):
    g = torch.Generator().manual_seed(seed)
    return [torch.randn(8, 4, generator=g) * scale, torch.randn(16, generator=g) * scale]


def _gradient_gate(grads_k, grads_p, want=None):
    from repro_torch.kernels import ops

    return chip_smoke.gradient_gate("test", ["/a", "/b"], lambda: (1.0, {"aux": 0.0}, grads_k),
                                    lambda: (1.0, {"aux": 0.0}, grads_p), want or ops.launch_counts())


def test_gradient_gate_passes_gradients_within_grad_rel_tol():
    """Phases 5c, 5g and 5h's gate: each leaf's relative L2 error within
    ``GRAD_REL_TOL`` passes."""
    grads = _grads(0)
    noise = _grads(1, scale=0.5 * chip_smoke.GRAD_REL_TOL)
    _gradient_gate([g + n for g, n in zip(grads, noise)], grads)


@pytest.mark.parametrize("fault", ["beyond_tol", "non_finite", "launches"])
def test_gradient_gate_fails(fault):
    """A leaf beyond ``GRAD_REL_TOL``, a non-finite gradient, or launches
    other than the ones wanted fail the gate."""
    from repro_torch.kernels import ops

    grads = _grads(0)
    got, want = [g.clone() for g in grads], None
    if fault == "beyond_tol":
        got[1] = got[1] * (1 + 2 * chip_smoke.GRAD_REL_TOL)
    elif fault == "non_finite":
        got[0][1, 2] = float("nan")
    else:
        want = {**ops.launch_counts(), "flash_attention_bwd": 1}
    with pytest.raises(RuntimeError, match="chip_smoke: test gradient"):
        _gradient_gate(got, grads, want)

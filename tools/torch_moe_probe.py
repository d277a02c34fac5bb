#!/usr/bin/env python3
"""Two measurements of the PyTorch port's jamba-v0.1-52b path on one card,
beside ``chip_smoke.py`` phase 3b (full width, 8 of 32 layers, bf16, batch 4,
prompt 512; random weights from each seed):

  python3 tools/torch_moe_probe.py [--seeds 0 1 2 ...] [--part routing|timing|both] [--faults]

routing: for each seed, prefill + 8 decode steps through the kernels (greedy),
  then teacher-forced on those tokens through the plain versions and through
  the kernels with ``moe_gmm`` on its FMA route. For the kernels and the FMA
  run it prints phase 3b's free-routing comparison (top-k sets that differ
  from the plain run's, max |logit diff| over all compared rows and over the
  rows no flip reaches; it does not gate), then phase 3b's gate
  (``chip_smoke.forced_routing_gate``): the plain versions run on that run's
  routing, logits within 0.25, greedy tokens equal or tied within error, and
  every router probability within ``chip_smoke.ROUTER_PROB_TOL``; then, in
  f32, the kernels against the plain versions with free routing (printed)
  and phase 3b's f32 gate, the same gate on the kernels' routing with the
  f32 logit tolerance (1e-3). With ``--faults`` the same
  runs take two planted faults, which live here only: expert 0's
  ``moe_gmm`` output scaled by 1.05, and one Mamba layer's scan carrying no
  state from the first half of the prompt into the second.
timing: ``moe_gmm`` (and the same function as 3 ``torch.bmm`` + ``F.silu``)
  in the served prefill, timed by CUDA events around each call, beside the
  same calls on the captured inputs and on phase 4's random inputs, timed as
  phase 4 times them (L2 flushed, median) and back to back, on mixes of the
  two (served x or weights with random ones, x's zero rows moved or filled),
  with each pass's time from ``torch.profiler`` and the card's SM clock and
  power sampled by ``nvidia-smi`` over each window.

``--device cpu --reduced`` rehearses the routing part on the host (there the
kernel wrappers compute the plain versions).
"""

from __future__ import annotations

import argparse
import dataclasses
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

import torch  # noqa: E402
import torch.nn.functional as F  # noqa: E402
from torch.profiler import ProfilerActivity, profile  # noqa: E402

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402
import repro_torch.kernels.moe_gmm as gmm_module  # noqa: E402
from repro_torch.launch.serve import make_prompts  # noqa: E402
from repro_torch.models import moe as moe_mod  # noqa: E402
from repro_torch.models.registry import build_model, decode_step, init_serve_state, prefill  # noqa: E402
from repro_torch.kernels.mamba_scan import mamba_scan  # noqa: E402

sys.path.insert(0, str(ROOT))
from chip_smoke import LOGIT_TOL as SMOKE_LOGIT_TOL  # noqa: E402
from chip_smoke import ROUTER_PROB_TOL, forced_routing_gate, logit_comparison  # noqa: E402

BATCH, PROMPT, N_CHECK, N_LAYERS = 4, 512, 8, 8
LOGIT_TOL = SMOKE_LOGIT_TOL["bfloat16"]
ROUTE = moe_mod.route
PLAIN = {
    "flash_attention": ref.reference_attention,
    "flash_decode": ref.reference_decode,
    "moe_gmm": ref.reference_gmm,
    "mamba_scan": lambda xc, dt, Bm, Cm, a, h0=None, chunk_len=0: ref.reference_selective_scan(
        xc, dt, Bm, Cm, a, h0),
}


def library_gmm(x, wg, wu, wd):
    """The function moe_gmm computes, as three torch.bmm calls and F.silu."""
    return torch.bmm(F.silu(torch.bmm(x, wg)) * torch.bmm(x, wu), wd)


def fma_gmm(x, wg, wu, wd):
    """moe_gmm with its route forced to "fma"."""
    chosen = gmm_module._route
    gmm_module._route = lambda *args: "fma"
    try:
        return gmm_module.moe_gmm(x, wg, wu, wd)
    finally:
        gmm_module._route = chosen


def fma_gmm_set():
    return dict(ops.kernel_set(), moe_gmm=fma_gmm)


def run_steps(model, params, prompts, kernels, teacher=None):
    """Prefill + N_CHECK decode steps; greedy unless ``teacher`` (B, N_CHECK)
    gives each step's input. Returns (logits (B, 1 + N_CHECK, V) f32, the
    tokens fed)."""
    with torch.inference_mode():
        state = init_serve_state(model, BATCH, PROMPT + N_CHECK + 8, prompts.device)
        lg, state = prefill(model, params, prompts, state, kernels=kernels)
        steps, fed = [lg.float()], []
        for t in range(N_CHECK):
            tok = lg.argmax(-1)[:, None] if teacher is None else teacher[:, t : t + 1]
            fed.append(tok)
            lg, state = decode_step(model, params, tok, state, kernels=kernels)
            steps.append(lg.float())
    return torch.stack(steps, dim=1), torch.cat(fed, dim=1)


def free_comparison(run, plain, routes_run, routes_plain, n_moe):
    """Phase 3b's free-routing comparison of ``run`` against ``plain``."""
    n_flip = 0
    rerouted = torch.zeros(run.shape[:2], dtype=torch.bool, device=run.device)
    for i, ((pk, _, ek), (pp, _, ep)) in enumerate(zip(routes_run, routes_plain)):
        flip = (torch.zeros_like(pk, dtype=torch.bool).scatter_(1, ek, True)
                != torch.zeros_like(pp, dtype=torch.bool).scatter_(1, ep, True)).any(-1)
        n_flip += int(flip.sum())
        rerouted[flip.view(BATCH, -1).any(-1), i // n_moe :] = True
    row_diff = (run - plain).abs().amax(-1)
    mine = run.argmax(-1)
    agree = plain.argmax(-1) == mine
    gap = plain.amax(-1) - plain.gather(-1, mine[..., None])[..., 0]
    near_tie = (~agree) & (gap <= 2 * row_diff)
    diff = row_diff.max().item()
    ok = diff <= LOGIT_TOL and bool((agree | near_tie).all())
    other = row_diff[~rerouted].max().item() if (~rerouted).any() else float("nan")
    return dict(flips=n_flip, rows_reached=int(rerouted.sum()), diff=diff, diff_unreached=other, passes=ok)


def forced(model, params, prompts, run_routes, teacher, kernels=PLAIN):
    """``kernels`` (the plain versions by default) teacher-forced on
    ``teacher``, each MoE call dispatched by ``run_routes`` (the routing a run
    under test recorded), while this run's own router is recorded too.
    Returns (logits, this run's own routings)."""
    replay, own = iter(run_routes), []

    def replay_route(p, c, xf):
        own.append(ROUTE(p, c, xf))
        return next(replay)

    moe_mod.route = replay_route
    try:
        logits, _ = run_steps(model, params, prompts, kernels, teacher=teacher)
    finally:
        moe_mod.route = ROUTE
    if next(replay, None) is not None:
        raise RuntimeError("the forced run used fewer routings than the run it replays")
    return logits, own


def gate(run, run_routes, forced_logits, forced_routes, logit_tol=LOGIT_TOL):
    """chip_smoke.py phase 3b's gate of ``run`` against the plain versions on
    its routing (bf16's logit tolerance unless given)."""
    return forced_routing_gate(run, forced_logits, [r[0] for r in run_routes], [r[0] for r in forced_routes],
                               [r[2] for r in run_routes], logit_tol=logit_tol, prob_tol=ROUTER_PROB_TOL)


def expert_fault(x, wg, wu, wd):
    """A planted fault: moe_gmm with expert 0's output scaled by 1.05."""
    out = gmm_module.moe_gmm(x, wg, wu, wd)
    out[0] *= 1.05
    return out


def carry_fault(n_mamba: int, faulty_call: int):
    """A planted fault: the ``faulty_call``-th mamba_scan of each prefill (one
    Mamba layer) scans its second half from a zero state where it should
    carry the first half's final state as h0. (The served prefill's own h0 is
    the zero state of a fresh cache, so dropping it would change nothing.)"""
    calls = [0]

    def scan(xc, dt, Bm, Cm, a, h0=None, chunk_len=256):
        i = calls[0]
        calls[0] += 1
        if i % n_mamba != faulty_call:
            return mamba_scan(xc, dt, Bm, Cm, a, h0)
        m = xc.shape[1] // 2
        half = lambda t, sl: t[:, sl].contiguous()  # noqa: E731
        y1, _ = mamba_scan(*(half(t, slice(0, m)) for t in (xc, dt, Bm, Cm)), a, h0)
        y2, h = mamba_scan(*(half(t, slice(m, None)) for t in (xc, dt, Bm, Cm)), a, None)
        return torch.cat([y1, y2], dim=1), h

    return scan


def routing(seeds, cfg, dev, faults: bool):
    """Phase 3b's comparisons over seeds: its gate is the plain versions run
    on each run's own routing, in bf16 and in f32; the f32 comparison with
    free routing is printed beside it."""
    routes: list = []

    def recording_route(p, c, xf):
        out = ROUTE(p, c, xf)
        routes.append(out)
        return out

    n_moe = sum(s.ffn == "moe" for s in cfg.layout) * cfg.n_groups
    n_mamba = sum(cfg.layout[i % len(cfg.layout)].mixer == "mamba" for i in range(cfg.n_layers))
    planted = {"expert 0 x1.05": dict(ops.kernel_set(), moe_gmm=expert_fault),
               "carry dropped": dict(ops.kernel_set(), mamba_scan=carry_fault(n_mamba, n_mamba // 2))
               } if faults else {}
    bf16_runs = ("kernels", "moe_gmm fma", *planted)
    free_passes = {"kernels": 0, "moe_gmm fma": 0}
    results: dict = {}  # label -> per seed (bf16 gate stats, failures, f32 failures)
    for seed in seeds:
        model = build_model(cfg)
        params = model.init(seed, dev)
        prompts = make_prompts(cfg.vocab, BATCH, PROMPT, seed + 1, dev)
        runs, rec = {}, {}
        moe_mod.route = recording_route
        try:
            for label, kernels in (("kernels", None), ("plain", PLAIN), ("moe_gmm fma", fma_gmm_set()),
                                   *planted.items()):
                routes.clear()
                runs[label], fed = run_steps(model, params, prompts, kernels,
                                             teacher=None if label == "kernels" else tokens)
                if label == "kernels":
                    tokens = fed
                rec[label] = list(routes)
        finally:
            moe_mod.route = ROUTE
        n_tok = sum(r[2].shape[0] for r in rec["kernels"])
        for label in ("kernels", "moe_gmm fma"):
            r = free_comparison(runs[label], runs["plain"], rec[label], rec["plain"], n_moe)
            free_passes[label] += r["passes"]
            print(f"  seed {seed} {label}: {r['flips']} of {n_tok} top-k sets differ from the plain run's, "
                  f"reaching {r['rows_reached']} of {BATCH * (1 + N_CHECK)} (row, step); max |logit diff| "
                  f"{r['diff']:.4e}, on the rows no flip reaches {r['diff_unreached']:.4e}; "
                  f"free comparison {'passes' if r['passes'] else 'FAILS'} (does not gate)", flush=True)
        bf16 = {}
        for label in bf16_runs:
            f_logits, f_routes = forced(model, params, prompts, rec[label], tokens)
            bf16[label] = gate(runs[label], rec[label], f_logits, f_routes)
        del model, params, runs, rec, f_logits, f_routes
        routes.clear()
        # f32: the kernels, and each planted fault, against the plain versions,
        # with free routing (printed) and on the run's own routing (phase 3b's
        # f32 gate: the arithmetic alone)
        f32_cfg = dataclasses.replace(cfg, dtype="float32")
        model = build_model(f32_cfg)
        params = model.init(seed, dev)
        f32, rec32 = {}, {}
        moe_mod.route = recording_route
        try:
            for label, kernels in (("plain", PLAIN), ("kernels", None), *planted.items()):
                routes.clear()
                f32[label], _ = run_steps(model, params, prompts, kernels, teacher=tokens)
                rec32[label] = list(routes)
        finally:
            moe_mod.route = ROUTE
        free32, forced32 = {}, {}
        for label in ("kernels", *planted):
            flips = free_comparison(f32[label], f32["plain"], rec32[label], rec32["plain"], n_moe)["flips"]
            free32[label] = (logit_comparison(f32[label], f32["plain"], SMOKE_LOGIT_TOL["float32"]), flips)
            f_logits, f_routes = forced(model, params, prompts, rec32[label], tokens)
            forced32[label] = gate(f32[label], rec32[label], f_logits, f_routes, SMOKE_LOGIT_TOL["float32"])
        for table in (free32, forced32):
            table["moe_gmm fma"] = table["kernels"]  # f32 moe_gmm always takes its FMA route
        del model, params, f32, rec32, f_logits, f_routes
        routes.clear()
        for label in bf16_runs:
            (fails, st), ((fails32, st32), flips32), (ffails32, fst32) = bf16[label], free32[label], forced32[label]
            results.setdefault(label, []).append((st, fails, fails32, ffails32, fst32))
            print(f"  seed {seed} {label}{' (planted fault)' if label in planted else ''}: bf16 on its routing: "
                  f"max |logit diff| {st['diff']:.4e}, greedy tokens agree {st['agree']}/{st['n']} (ties "
                  f"{st['ties']}), max |router prob diff| {st['dprob']:.4e} (tol {ROUTER_PROB_TOL:.4e}), the "
                  f"plain run's own router would choose another top-k set for {st['rerouted']} of {st['tokens']} "
                  f"tokens: {'FAILS: ' + '; '.join(fails) if fails else 'passes'}; f32 vs plain, free routing "
                  f"({flips32} top-k sets differ): max |logit diff| {st32['diff']:.4e} (tol "
                  f"{SMOKE_LOGIT_TOL['float32']}): {'FAILS' if fails32 else 'passes'} (does not gate); f32 on its "
                  f"routing: max |logit diff| {fst32['diff']:.4e}, max |router prob diff| {fst32['dprob']:.4e}: "
                  f"{'FAILS: ' + '; '.join(ffails32) if ffails32 else 'passes'}", flush=True)
        if dev.type == "cuda":
            torch.cuda.empty_cache()
    for label, n in free_passes.items():
        print(f"routing: {label}: the free comparison passes for {n} of {len(seeds)} seeds")
    honest = [r[0] for label in ("kernels", "moe_gmm fma") for r in results[label]]
    print(f"routing: honest bf16 runs ({len(honest)}): max |router prob diff| "
          f"{min(st['dprob'] for st in honest):.4e} .. {max(st['dprob'] for st in honest):.4e}, max |logit diff| "
          f"{min(st['diff'] for st in honest):.4e} .. {max(st['diff'] for st in honest):.4e}")
    honest32 = [r[4] for r in results["kernels"]]  # f32 moe_gmm always takes its FMA route
    print(f"routing: honest f32 runs ({len(honest32)}) on their routing: max |logit diff| "
          f"{min(st['diff'] for st in honest32):.4e} .. {max(st['diff'] for st in honest32):.4e}, max |router "
          f"prob diff| {min(st['dprob'] for st in honest32):.4e} .. {max(st['dprob'] for st in honest32):.4e}")
    for label, per_seed in results.items():
        print(f"routing: {'planted ' if label in planted else ''}{label}: the bf16 gate on its routing passes for "
              f"{sum(not r[1] for r in per_seed)} of {len(per_seed)} seeds, the f32 gate on its routing for "
              f"{sum(not r[3] for r in per_seed)} (max |logit diff| {min(r[4]['diff'] for r in per_seed):.4e} .. "
              f"{max(r[4]['diff'] for r in per_seed):.4e}); phase 3b's gate (both) for "
              f"{sum(not r[1] and not r[3] for r in per_seed)}; the f32 comparison with free routing (printed) "
              f"for {sum(not r[2] for r in per_seed)}")


class Sampler:
    """nvidia-smi's SM clock (MHz) and power draw (W) every 20 ms while open."""

    def __enter__(self):
        self.proc = subprocess.Popen(
            ["nvidia-smi", "--query-gpu=clocks.sm,power.draw", "--format=csv,noheader,nounits", "-lms", "20"],
            stdout=subprocess.PIPE, stderr=subprocess.DEVNULL, text=True)
        time.sleep(1.0)  # nvidia-smi's own start-up
        return self

    def __exit__(self, *exc):
        time.sleep(0.1)
        self.proc.terminate()
        out, _ = self.proc.communicate()
        vals = []
        for line in out.splitlines()[2:]:  # drop the start-up samples
            try:
                vals.append(tuple(float(v) for v in line.split(",")))
            except ValueError:
                pass
        busy = [v for v in vals if v[1] > 150.0] or vals  # the window's loaded samples
        self.text = (f"{len(busy)} samples: SM clock median {statistics.median(v[0] for v in busy):.0f} MHz "
                     f"(min {min(v[0] for v in busy):.0f}), power median {statistics.median(v[1] for v in busy):.1f} W"
                     if busy else "no samples")
        return False


def timing(cfg, dev):
    seed = 0
    model = build_model(cfg)
    params = model.init(seed, dev)
    prompts = make_prompts(cfg.vocab, BATCH, PROMPT, seed + 1, dev)
    flush = torch.empty(256 * 2**20, dtype=torch.uint8, device=dev)
    captured: list = []
    events: list = []

    def timed(fn, capture=False):
        def call(x, wg, wu, wd):
            if capture and len(captured) < 4:  # the first served prefill's 4 calls
                captured.append((x.clone(), wg, wu, wd))
            s, e = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            s.record()
            out = fn(x, wg, wu, wd)
            e.record()
            events.append((s, e))
            return out
        return call

    def in_context(fn, n_pass=6, capture=False):
        """Per-call ms of fn inside warm served prefills (CUDA events)."""
        kernels = dict(ops.kernel_set(), moe_gmm=timed(fn, capture))
        with torch.inference_mode():
            for i in range(n_pass):
                if i == 1:  # the first pass warms up
                    torch.cuda.synchronize()
                    events.clear()
                state = init_serve_state(model, BATCH, PROMPT + 40, dev)
                prefill(model, params, prompts, state, kernels=kernels)
                del state
        torch.cuda.synchronize()
        return [s.elapsed_time(e) for s, e in events]

    def time_ms(fn, reps=10, warmup=3):  # chip_smoke.py phase 4's method
        for _ in range(warmup):
            fn()
        evs = []
        for _ in range(reps):
            flush.zero_()
            s, e = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            s.record()
            fn()
            e.record()
            evs.append((s, e))
        torch.cuda.synchronize()
        return statistics.median(s.elapsed_time(e) for s, e in evs)

    def back_to_back(fn, args, n=40):
        """Median ms per call of n calls queued back to back (no flush)."""
        fn(*args)
        evs = []
        for _ in range(n):
            s, e = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            s.record()
            fn(*args)
            e.record()
            evs.append((s, e))
        torch.cuda.synchronize()
        return statistics.median(s.elapsed_time(e) for s, e in evs)

    def passes(args, n=5):
        """moe_gmm's two launches, ms per call each (torch.profiler)."""
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(n):
                gmm_module.moe_gmm(*args)
            torch.cuda.synchronize()
        by = {"gated": 0.0, "down": 0.0}
        for e in prof.events():
            if str(getattr(e, "device_type", "")).endswith("CUDA") and "gemm_kernel" in e.name:
                by["gated" if "<true" in e.name else "down"] += e.time_range.elapsed_us() / 1e3 / n
        return "passes (profiler, ms per call): " + ", ".join(f"{k} {v:.4f}" for k, v in by.items())

    def rng(*shape, scale):
        return (torch.randn(shape, generator=gen, device=dev) * scale).to(torch.bfloat16)

    fmt = lambda ms: f"median {statistics.median(ms):.4f} (min {min(ms):.4f}, max {max(ms):.4f})"  # noqa: E731
    with Sampler() as smp:
        k_ctx = in_context(gmm_module.moe_gmm, capture=True)
    print(f"timing: moe_gmm in the served prefill, {len(k_ctx)} calls: ms {fmt(k_ctx)}; {smp.text}")
    with Sampler() as smp:
        l_ctx = in_context(library_gmm)
    print(f"timing: library (3x torch.bmm + F.silu) in the served prefill, {len(l_ctx)} calls: ms {fmt(l_ctx)}; "
          f"{smp.text}")
    E, C, D = captured[0][0].shape
    Fd = captured[0][1].shape[2]
    for i, (x, wg, wu, wd) in enumerate(captured):
        zero = (x == 0).all(-1).float().mean().item()
        print(f"timing: served call {i}: x (E{E}, C{C}, D{D}) std {x.float().std().item():.3f}, "
              f"zero rows {zero:.4f}; Wg std {wg.float().std().item():.5f}")
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    rnd = (rng(E, C, D, scale=1.0), rng(E, D, Fd, scale=D**-0.5), rng(E, D, Fd, scale=D**-0.5),
           rng(E, Fd, D, scale=Fd**-0.5))
    x0, wg0, wu0, wd0 = captured[0]
    zero_rows = (x0 == 0).all(-1, keepdim=True)
    perm = torch.randperm(E * C, generator=gen, device=dev)
    inputs = {
        "served call 0": captured[0], "served call 3": captured[3], "phase-4 random": rnd,
        "served x, random weights": (x0, *rnd[1:]), "random x, served weights": (rnd[0], wg0, wu0, wd0),
        "random x with served x's zero rows": (rnd[0].masked_fill(zero_rows, 0), *rnd[1:]),
        "served x, zero rows filled at random": (torch.where(zero_rows, rnd[0], x0), *rnd[1:]),
        "served x, rows shuffled across bins": (x0.view(E * C, D)[perm].view(E, C, D), *rnd[1:]),
    }
    for label, args in inputs.items():
        with Sampler() as smp:
            k = time_ms(lambda: gmm_module.moe_gmm(*args))
            lib = time_ms(lambda: library_gmm(*args))
        kb, lb = back_to_back(gmm_module.moe_gmm, args), back_to_back(library_gmm, args)
        print(f"timing: {label}: phase-4 method (L2 flushed, median of 10) moe_gmm {k:.4f} ms, library "
              f"{lib:.4f} ms; back to back (median of 40) moe_gmm {kb:.4f} ms, library {lb:.4f} ms; "
              f"{passes(args)}; {smp.text}")
    with Sampler() as smp:
        sustained = back_to_back(gmm_module.moe_gmm, captured[0], n=400)
    print(f"timing: served call 0, 400 calls back to back: moe_gmm median {sustained:.4f} ms; {smp.text}")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--seeds", type=int, nargs="+", default=list(range(8)))
    ap.add_argument("--part", choices=("routing", "timing", "both"), default="both")
    ap.add_argument("--faults", action="store_true",
                    help="also run the two planted faults through the routing part's gate")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--reduced", action="store_true", help="the reduced config (for a rehearsal on the host)")
    args = ap.parse_args()
    dev = torch.device(args.device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        print("torch_moe_probe: no CUDA device", file=sys.stderr)
        return 2
    cfg = get_config("jamba-v0.1-52b")
    cfg = cfg.reduced() if args.reduced else dataclasses.replace(cfg, n_layers=N_LAYERS)
    if dev.type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
        print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                             capture_output=True, text=True).stdout.strip())
    if args.part in ("routing", "both"):
        routing(args.seeds, cfg, dev, args.faults)
    if args.part in ("timing", "both"):
        if dev.type != "cuda":
            raise SystemExit("the timing part needs the card")
        timing(cfg, dev)
    return 0


if __name__ == "__main__":
    sys.exit(main())

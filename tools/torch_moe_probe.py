#!/usr/bin/env python3
"""Two measurements of the PyTorch port's jamba-v0.1-52b path on one card,
beside ``chip_smoke.py`` phase 3b (full width, 8 of 32 layers, bf16, batch 4,
prompt 512; random weights from each seed):

  python3 tools/torch_moe_probe.py [--seeds 0 1 2 ...] [--part routing|timing|both]

routing: for each seed, prefill + 8 decode steps through the kernels (greedy),
  then teacher-forced on those tokens through the plain versions, through the
  plain versions on the kernels' routing, and through the kernels with
  ``moe_gmm`` on its FMA route. For the kernels and the FMA run it prints what
  phase 3b's free-routing comparison prints (top-k sets that differ from the
  plain run's, max |logit diff| over all compared rows and over the rows no
  flip reaches) and whether that comparison would pass; for the kernels also
  the forced-routing difference.
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

BATCH, PROMPT, N_CHECK, N_LAYERS = 4, 512, 8, 8
LOGIT_TOL = 0.25  # chip_smoke.py's LOGIT_TOL["bfloat16"]
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


def routing(seeds, cfg, dev):
    routes: list = []
    route = moe_mod.route

    def recording_route(p, c, xf):
        out = route(p, c, xf)
        routes.append(out)
        return out

    n_moe = sum(s.ffn == "moe" for s in cfg.layout) * cfg.n_groups
    fma_set = dict(ops.kernel_set(), moe_gmm=fma_gmm)
    summary = {"kernels": 0, "moe_gmm fma": 0}
    moe_mod.route = recording_route
    try:
        for seed in seeds:
            model = build_model(cfg)
            params = model.init(seed, dev)
            prompts = make_prompts(cfg.vocab, BATCH, PROMPT, seed + 1, dev)
            rec = {}
            routes.clear()
            runs = {"kernels": None}
            runs["kernels"], tokens = run_steps(model, params, prompts, None)
            rec["kernels"] = list(routes)
            for label, kernels in (("plain", PLAIN), ("moe_gmm fma", fma_set)):
                routes.clear()
                runs[label], _ = run_steps(model, params, prompts, kernels, teacher=tokens)
                rec[label] = list(routes)
            replay = iter(rec["kernels"])
            moe_mod.route = lambda p, c, xf: next(replay)
            forced, _ = run_steps(model, params, prompts, PLAIN, teacher=tokens)
            moe_mod.route = recording_route
            fdiff = (runs["kernels"] - forced).abs().max().item()
            n_tok = sum(r[2].shape[0] for r in rec["kernels"])
            for label in ("kernels", "moe_gmm fma"):
                r = free_comparison(runs[label], runs["plain"], rec[label], rec["plain"], n_moe)
                summary[label] += r["passes"]
                extra = f"; on the kernels' routing {fdiff:.4e}" if label == "kernels" else ""
                print(f"  seed {seed} {label}: {r['flips']} of {n_tok} top-k sets differ from the plain run's, "
                      f"reaching {r['rows_reached']} of {BATCH * (1 + N_CHECK)} (row, step); max |logit diff| "
                      f"{r['diff']:.4e}, on the rows no flip reaches {r['diff_unreached']:.4e}{extra}; "
                      f"free comparison {'passes' if r['passes'] else 'FAILS'}", flush=True)
            del model, params, runs, forced, rec
            routes.clear()
            if dev.type == "cuda":
                torch.cuda.empty_cache()
    finally:
        moe_mod.route = route
    for label, n in summary.items():
        print(f"routing: {label}: the free comparison passes for {n} of {len(seeds)} seeds")


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
        routing(args.seeds, cfg, dev)
    if args.part in ("timing", "both"):
        if dev.type != "cuda":
            raise SystemExit("the timing part needs the card")
        timing(cfg, dev)
    return 0


if __name__ == "__main__":
    sys.exit(main())

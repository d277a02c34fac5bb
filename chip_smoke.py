#!/usr/bin/env python3
"""Drive the PyTorch port (``src/repro_torch``) on one CUDA card.

  python3 chip_smoke.py

Phases, in order; any failure raises and exits non-zero:
  1. name the card, build the CUDA kernels from ``src/repro_torch/kernels/csrc``;
  2. hold each kernel against its plain PyTorch version on the card, over the
     shape sweeps of the reference kernel tests (f32 tol 2e-5, bf16 tol 2e-2);
  3. serve stablelm-1.6b at full width (24 layers, bf16, batch 4, prompt 512,
     32 generated tokens) through ``repro_torch.launch.serve.main``, count the
     kernel launches of that run, then run prefill and the first decode steps
     again through the plain versions on the card and compare logits and
     greedy tokens;
  4. time each kernel at the serving shapes beside its plain version, one
     PyTorch library call that computes the same function, and its bound.
The last line is ``{"ok": true, "device": {...}}``. The compiler's reports
(registers, spills) go to ``build/repro_torch_kernels/nvcc_report.txt``.
"""

from __future__ import annotations

import dataclasses
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

# H100 SXM published peaks (dense): memory rate, and operations per type
PEAK_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}
TOL = {"float32": (2e-5, 2e-5), "bfloat16": (2e-2, 2e-2)}  # (rtol, atol)

ATTN_CASES = [  # (B, Lq, Lk, H, KVH, Dh, causal, window): tests/test_kernels.py sweep
    (2, 128, 128, 4, 2, 64, True, 0),
    (1, 256, 256, 8, 8, 32, True, 0),
    (2, 200, 200, 4, 1, 64, True, 0),  # ragged lengths
    (1, 256, 256, 4, 2, 64, True, 96),  # sliding window
    (1, 64, 256, 4, 2, 64, False, 0),  # cross attention
    (1, 128, 128, 6, 2, 16, True, 0),  # small head dim
    (2, 96, 112, 40, 8, 128, True, 0),  # qwen2.5 / internlm2 head dim, gq 5
    (4, 512, 552, 32, 32, 64, True, 0),  # stablelm prefill over the serve cache
]
DECODE_CASES = [  # (B, S, H, KVH, Dh, window, n_valid, q_pos, ring): tests/test_flash_decode.py
    (2, 256, 8, 2, 64, 0, 200, 199, False),
    (1, 300, 4, 4, 32, 0, 300, 299, False),  # ragged S, MHA
    (2, 128, 4, 1, 64, 48, 100, 99, False),  # SWA window
    (1, 64, 8, 2, 64, 0, 10, 9, False),  # mostly-empty cache
    (1, 64, 4, 2, 32, 64, 64, 100, True),  # SWA ring: positions rotated by 13
    (2, 200, 48, 8, 128, 0, 150, 149, False),  # internlm2 head dim, gq 6
    (2, 64, 16, 2, 16, 0, 40, 39, False),  # reduced-config head dim, gq 8
    (4, 552, 32, 32, 64, 0, 528, 527, False),  # stablelm decode at the serve cache
]
SERVE = dict(arch="stablelm-1.6b", batch=4, prompt_len=512, gen=32, seed=0)
N_CHECK = 8  # decode steps compared with the plain versions
N_STEADY = 16  # decode steps timed after warm-up
# kernel vs plain logits after the 24 layers. bf16: each layer's attention
# output may differ by an ulp or two, compounded over depth and the 2048-wide
# head, on logits of magnitude ~1-5 (bf16 ulp 2^-7..2^-5 there). f32: each
# attention output differs at ~1e-6 relative.
LOGIT_TOL = {"bfloat16": 0.25, "float32": 1e-3}


def fail(msg: str):
    raise RuntimeError(f"chip_smoke: {msg}")


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    from repro_torch.configs import get_config
    from repro_torch.kernels import build, ops, ref
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.kernels.flash_decode import flash_decode
    from repro_torch.launch import serve
    from repro_torch.models.registry import build_model, decode_step, init_serve_state, prefill

    torch.backends.cuda.matmul.allow_tf32 = False  # f32 references stay f32
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)

    # -- 1. card and build ---------------------------------------------------
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip().splitlines()
    print(smi[0])
    print(f"torch {torch.__version__} cuda {torch.version.cuda} device {torch.cuda.get_device_name(0)}")
    t0 = time.perf_counter()
    reports = build.build_all()
    print(f"build: {time.perf_counter() - t0:.1f}s for {sorted(reports)} (nvcc in parallel)")
    if reports:
        (build.BUILD_DIR / "nvcc_report.txt").write_text(
            "\n".join(f"== {n}\n{r}" for n, r in reports.items()))
    for n, r in reports.items():
        spills = [l.strip() for l in r.splitlines() if "spill" in l and " 0 bytes spill" not in l]
        regs = sorted({l.split("Used ")[1].split(" registers")[0] for l in r.splitlines() if "Used " in l})
        print(f"  {n}: registers per thread {regs}; spilling entries: {spills or 'none'}")

    def rand(*shape, dtype):
        return torch.randn(shape, generator=gen, device=dev, dtype=torch.float32).to(dtype)

    def check(name, got, want, dtype):
        rtol, atol = TOL[str(dtype).split(".")[-1]]
        err = (got.float() - want.float()).abs()
        if not torch.isfinite(got.float()).all():
            fail(f"{name}: non-finite output")
        bad = err > atol + rtol * want.float().abs()
        print(f"  {name}: max_abs_err {err.max().item():.3e} ({'ok' if not bad.any() else 'FAIL'})")
        if bad.any():
            fail(f"{name}: {int(bad.sum())} elements beyond rtol {rtol} atol {atol}")
        return err.max().item()

    # -- 2. each kernel against its plain version ------------------------------
    print("phase 2: kernels vs plain versions on the card")
    for dtype in (torch.float32, torch.bfloat16):
        for B, Lq, Lk, H, KVH, Dh, causal, window in ATTN_CASES:
            q, k, v = rand(B, Lq, H, Dh, dtype=dtype), rand(B, Lk, KVH, Dh, dtype=dtype), rand(B, Lk, KVH, Dh, dtype=dtype)
            got = flash_attention(q, k, v, causal=causal, window=window)
            want = ref.reference_attention(q, k, v, causal=causal, window=window)
            name = f"flash_attention {dtype} B{B} Lq{Lq} Lk{Lk} H{H}/{KVH} Dh{Dh} causal={causal} window={window}"
            check(name, got, want, dtype)
        for B, S, H, KVH, Dh, window, nv, qp, ring in DECODE_CASES:
            q, k, v = rand(B, 1, H, Dh, dtype=dtype), rand(B, S, KVH, Dh, dtype=dtype), rand(B, S, KVH, Dh, dtype=dtype)
            kpos = torch.arange(S, dtype=torch.int32, device=dev)
            if ring:  # absolute time qp: slot i holds position qp - S + 1 + i, rotated by 13
                kpos = torch.roll(kpos + (qp - S + 1), 13)
            kpos = kpos.expand(B, S).contiguous()
            qpos = torch.full((B,), qp, dtype=torch.int32, device=dev)
            nval = torch.full((B,), nv, dtype=torch.int32, device=dev)
            got = flash_decode(q, k, v, kpos, qpos, nval, window=window)
            want = ref.reference_decode(q, k, v, kpos, qpos, nval, window=window)
            name = f"flash_decode {dtype} B{B} S{S} H{H}/{KVH} Dh{Dh} window={window} n_valid={nv} ring={ring}"
            check(name, got, want, dtype)
    # rows with no live key anywhere must stay finite (finite NEG_INF masking)
    q, k = rand(1, 128, 4, 32, dtype=torch.bfloat16), rand(1, 32, 2, 32, dtype=torch.bfloat16)
    dead = flash_attention(q, k, k, causal=True, window=16)  # rows >= 47 see no key
    i32 = dict(dtype=torch.int32, device=dev)
    dead_dec = flash_decode(q[:, :1], k, k, torch.arange(32, **i32)[None].contiguous(),
                            torch.full((1,), -1, **i32), torch.full((1,), 32, **i32))
    torch.cuda.synchronize()
    if not (torch.isfinite(dead.float()).all() and torch.isfinite(dead_dec.float()).all()):
        fail("fully masked rows produced non-finite output")
    print("  fully masked rows: finite")

    # -- 3. serve at full width --------------------------------------------------
    print("phase 3: serve", SERVE["arch"])
    argv = ["--arch", SERVE["arch"], "--batch", str(SERVE["batch"]), "--prompt-len",
            str(SERVE["prompt_len"]), "--gen", str(SERVE["gen"]), "--seed", str(SERVE["seed"]),
            "--device", "cuda"]
    ops.reset_launch_counts()
    tokens = serve.main(argv)
    torch.cuda.synchronize()
    launches = ops.launch_counts()
    cfg = get_config(SERVE["arch"])
    want_launches = {"flash_attention": cfg.n_layers, "flash_decode": cfg.n_layers * (SERVE["gen"] - 1)}
    print(f"  launches {launches} (want {want_launches})")
    if launches != want_launches:
        fail(f"launch counts {launches} != {want_launches}")
    if tokens.shape != (SERVE["batch"], SERVE["gen"]) or not bool(((tokens >= 0) & (tokens < cfg.vocab)).all()):
        fail(f"bad generations {tuple(tokens.shape)}")

    max_len = SERVE["prompt_len"] + SERVE["gen"] + 8
    prompts = serve.make_prompts(cfg.vocab, SERVE["batch"], SERVE["prompt_len"], SERVE["seed"] + 1, dev)
    plain = {"flash_attention": ref.reference_attention, "flash_decode": ref.reference_decode}
    served = tokens[:, : N_CHECK + 1]
    # the served bf16 model, then the same seed's weights in f32, where the
    # kernels should match the plain versions to f32 rounding
    for dtype in ("bfloat16", "float32"):
        model = build_model(dataclasses.replace(cfg, dtype=dtype))
        params = model.init(SERVE["seed"], dev)
        runs = {}
        for label, kernels in (("kernels", None), ("plain", plain)):
            with torch.inference_mode():
                state = init_serve_state(model, SERVE["batch"], max_len, dev)
                lg, state = prefill(model, params, prompts, state, kernels=kernels)
                steps = [lg.float()]
                for t in range(N_CHECK):  # teacher-forced with the served tokens
                    lg, state = decode_step(model, params, tokens[:, t : t + 1], state, kernels=kernels)
                    steps.append(lg.float())
            runs[label] = torch.stack(steps, dim=1)  # (B, 1 + N_CHECK, V)
            del state
        if dtype == cfg.dtype and not torch.equal(runs["kernels"].argmax(-1), served):
            fail("re-run through the kernels does not reproduce the served tokens")
        row_diff = (runs["kernels"] - runs["plain"]).abs().amax(-1)  # (B, 1 + N_CHECK)
        diff = row_diff.max().item()
        mine = runs["kernels"].argmax(-1)
        agree = runs["plain"].argmax(-1) == mine
        # where the tokens differ, the plain run's top logit may beat the
        # kernels' token by at most twice that row's logit difference: a tie within error
        gap = runs["plain"].amax(-1) - runs["plain"].gather(-1, mine[..., None])[..., 0]
        near_tie = (~agree) & (gap <= 2 * row_diff)
        print(f"  {dtype}: prefill + {N_CHECK} decode steps, kernels vs plain on the card: max |logit diff| "
              f"{diff:.4e} (tol {LOGIT_TOL[dtype]}); greedy tokens agree {int(agree.sum())}/{agree.numel()}, "
              f"ties within error {int(near_tie.sum())}")
        if diff > LOGIT_TOL[dtype] or not bool((agree | near_tie).all()) or not torch.isfinite(runs["kernels"]).all():
            fail(f"{dtype}: greedy tokens or logits through the kernels disagree with the plain versions")
        del params, runs
        torch.cuda.empty_cache()

    # steady-state serve times and the device's busy share (not part of the
    # counted run: the launch counts above are final)
    model = build_model(cfg)
    params = model.init(SERVE["seed"], dev)
    box = {}

    def run_prefill():
        box["state"] = init_serve_state(model, SERVE["batch"], max_len, dev)
        lg, box["state"] = prefill(model, params, prompts, box["state"])
        box["tok"] = lg.argmax(-1)[:, None]

    def run_decode():
        for _ in range(N_STEADY):
            lg, box["state"] = decode_step(model, params, box["tok"], box["state"])
            box["tok"] = lg.argmax(-1)[:, None]

    def wall(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        return time.perf_counter() - t0

    from torch.profiler import ProfilerActivity, profile

    with torch.inference_mode():
        for _ in range(2):  # the second pass is warm
            prefill_s, decode_s = wall(run_prefill), wall(run_decode)
        step_ms = decode_s / N_STEADY * 1e3
        print(f"  steady: prefill {SERVE['batch']}x{SERVE['prompt_len']} {prefill_s * 1e3:.2f} ms; "
              f"decode {step_ms:.2f} ms/step ({SERVE['batch'] * N_STEADY / decode_s:.1f} tok/s)")
        for name, fn in (("prefill", run_prefill), ("decode", run_decode)):
            if name == "decode":
                run_prefill()
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                t = wall(fn)
            kern = [e for e in prof.events() if str(getattr(e, "device_type", "")).endswith("CUDA")]
            busy = sum(e.time_range.elapsed_us() for e in kern) / 1e6
            by_name: dict = {}
            for e in kern:
                by_name[e.name[:48]] = by_name.get(e.name[:48], 0.0) + e.time_range.elapsed_us() / 1e3
            top = sorted(by_name.items(), key=lambda kv: -kv[1])[:6]
            print(f"  profiled {name}: wall {t * 1e3:.2f} ms, device busy {busy * 1e3:.2f} ms "
                  f"(idle share {1 - busy / t:.3f}), {len(kern)} kernels; top ms: "
                  + "; ".join(f"{n} {ms:.3f}" for n, ms in top))
    del params, box
    torch.cuda.empty_cache()

    # -- 4. time each kernel at the serving shapes -------------------------------
    print("phase 4: timing at the serving shapes (bf16, L2 flushed before each launch)")
    import torch.nn.functional as F

    flush = torch.empty(256 * 2**20, dtype=torch.uint8, device=dev)

    def time_ms(fn, reps=30, warmup=3):
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

    def bound(nbytes, flops, dtype):
        t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
        t_ops = flops / PEAK_FLOPS[dtype] * 1e3
        return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")

    bf = torch.bfloat16
    B, Lp, S, H, Dh = SERVE["batch"], SERVE["prompt_len"], max_len, cfg.n_heads, cfg.head_dim
    KVH, es = cfg.n_kv_heads, 2
    rows = []

    q, k, v = rand(B, Lp, H, Dh, dtype=bf), rand(B, S, KVH, Dh, dtype=bf), rand(B, S, KVH, Dh, dtype=bf)
    pairs = int(torch.ones(Lp, S).tril().sum().item())  # causal (q, k) pairs
    live = min(S, Lp)  # slots some query sees
    nbytes = 2 * B * Lp * H * Dh * es + 2 * B * live * KVH * Dh * es
    b_ms, b_by = bound(nbytes, 4 * B * H * Dh * pairs, "bfloat16")
    qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
    gqa = dict(enable_gqa=True) if H != KVH else {}
    err = check("flash_attention at serve shape", flash_attention(q, k, v), ref.reference_attention(q, k, v), bf)
    lib_err = (F.scaled_dot_product_attention(qt, kt, vt, is_causal=True, **gqa).transpose(1, 2)
               - ref.reference_attention(q, k, v)).abs().max().item()
    rows.append(dict(
        name="flash_attention", route="cuda", source="src/repro_torch/kernels/csrc/flash_attention.cu",
        replaces="src/repro/kernels/flash_attention.py:116", launches=launches["flash_attention"],
        max_abs_err=err,
        ms=time_ms(lambda: flash_attention(q, k, v)),
        plain_ms=time_ms(lambda: ref.reference_attention(q, k, v)),
        bound_ms=b_ms, bound_by=b_by,
        library_ms=time_ms(lambda: F.scaled_dot_product_attention(qt, kt, vt, is_causal=True, **gqa)),
    ))
    print(f"  library (scaled_dot_product_attention, is_causal) vs plain: max_abs_err {lib_err:.3e}")

    nv = Lp + N_CHECK * 2  # a mid-generation decode step
    q1 = rand(B, 1, H, Dh, dtype=bf)
    kpos = torch.arange(S, dtype=torch.int32, device=dev).expand(B, S).contiguous()
    qpos = torch.full((B,), nv - 1, dtype=torch.int32, device=dev)
    nval = torch.full((B,), nv, dtype=torch.int32, device=dev)
    nbytes = 2 * B * nv * KVH * Dh * es + 2 * B * H * Dh * es + B * nv * 4 + 2 * B * 4
    b_ms, b_by = bound(nbytes, 4 * B * H * Dh * nv, "bfloat16")
    mask = ((torch.arange(S, device=dev)[None] < nval[:, None]) & (kpos <= qpos[:, None]))[:, None, None]
    q1t = q1.transpose(1, 2)
    err = check("flash_decode at serve shape", flash_decode(q1, k, v, kpos, qpos, nval),
                ref.reference_decode(q1, k, v, kpos, qpos, nval), bf)
    rows.append(dict(
        name="flash_decode", route="cuda", source="src/repro_torch/kernels/csrc/flash_decode.cu",
        replaces="src/repro/kernels/flash_decode.py:89", launches=launches["flash_decode"],
        max_abs_err=err,
        ms=time_ms(lambda: flash_decode(q1, k, v, kpos, qpos, nval)),
        plain_ms=time_ms(lambda: ref.reference_decode(q1, k, v, kpos, qpos, nval)),
        bound_ms=b_ms, bound_by=b_by,
        library_ms=time_ms(lambda: F.scaled_dot_product_attention(q1t, kt, vt, attn_mask=mask, **gqa)),
    ))
    for r in rows:
        print(f"  {r['name']}: kernel_ms {r['ms']:.4f} library_ms {r['library_ms']:.4f} "
              f"plain_ms {r['plain_ms']:.4f} bound_ms {r['bound_ms']:.4f} ({r['bound_by']})")
    torch.cuda.synchronize()

    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

#!/usr/bin/env python3
"""Drive the PyTorch port (``src/repro_torch``) on one CUDA card.

  python3 chip_smoke.py

Phases, in order; any failure raises and exits non-zero:
  1. name the card, build the five CUDA kernels from
     ``src/repro_torch/kernels/csrc`` (one nvcc each, in parallel);
  2. hold each kernel against its plain PyTorch version on the card, over the
     shape sweeps of the reference kernel tests and the full-width serve
     shapes (attention f32 tol 2e-5, bf16 2e-2; moe_gmm the same; mamba_scan
     1e-4), including empty capacity bins; ``hash_tree`` bit-equal to its
     plain version and to the host (numpy) digest of the same bytes, over
     random words, ragged payloads, bf16/bool/int32, a non-contiguous view, a
     misaligned slice and a one-byte flip;
  3. serve stablelm-1.6b at full width (24 layers, bf16, batch 4, prompt 512,
     32 generated tokens) through ``repro_torch.launch.serve.main``, count the
     kernel launches of that run, then run prefill and the first decode steps
     again through the plain versions on the card and compare logits and
     greedy tokens; steady and profiled serve times;
  3b. serve jamba-v0.1-52b at full width, cut to one layout period (8 of its
     32 layers: the full depth does not fit the card's 80 GB), bf16, batch 4,
     prompt 512, 32 tokens, through ``repro_torch.launch.serve.run``: exact
     launch counts of all four kernels, kernels vs plain versions in bf16 and
     f32 with a routing diagnostic, steady and profiled serve times;
  3c. the Koalja circuit on the card: a ``repro_torch.workspace.Workspace``
     (flat, inline executor, default store) with one task ``normalize``;
     push B14's wave of 64 card-resident f32 tensors of 4.5 MiB, the same
     wave again (64 memo hits), then one 1 GiB tensor: every tree-tier digest
     runs ``hash_tree`` (exact launch count), every chash equals the host
     digest of the ``.cpu()`` copy, and a profiled ``content_hash_batch`` of
     the wave copies at most 64 x (32 KiB + 12 B) to the host;
  4. time each kernel at the shapes of its main path beside its plain
     version, one PyTorch library call that computes the same function (three
     for moe_gmm; none exists for mamba_scan or hash_tree), and its bound.
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

import numpy as np

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

# H100 SXM published peaks (dense): memory rate, and operations per type
PEAK_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}
TOL = {"float32": (2e-5, 2e-5), "bfloat16": (2e-2, 2e-2)}  # (rtol, atol)
# the scan's output is f32 in both dtypes (bf16 only for its xc input):
# exp and FMA rounding over L steps, as the reference kernel tests
SCAN_TOL = (1e-4, 1e-4)

ATTN_CASES = [  # (B, Lq, Lk, H, KVH, Dh, causal, window): tests/test_kernels.py sweep
    (2, 128, 128, 4, 2, 64, True, 0),
    (1, 256, 256, 8, 8, 32, True, 0),
    (2, 200, 200, 4, 1, 64, True, 0),  # ragged lengths
    (1, 256, 256, 4, 2, 64, True, 96),  # sliding window
    (1, 64, 256, 4, 2, 64, False, 0),  # cross attention
    (1, 128, 128, 6, 2, 16, True, 0),  # small head dim
    (2, 96, 112, 40, 8, 128, True, 0),  # qwen2.5 / internlm2 head dim, gq 5
    (4, 512, 552, 32, 32, 64, True, 0),  # stablelm prefill over the serve cache
    (4, 512, 552, 32, 8, 128, True, 0),  # jamba prefill over the serve cache
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
    (4, 552, 32, 8, 128, 0, 528, 527, False),  # jamba decode at the serve cache
]
GMM_CASES = [  # (E, C, D, F): tests/test_kernels.py::test_moe_gmm_sweep (then jamba's, below)
    (4, 32, 64, 96),
    (2, 100, 48, 80),  # ragged capacity
    (8, 16, 32, 32),
    (1, 64, 128, 64),
]
SCAN_CASES = [  # (B, L, Di, N, h0): tests/test_kernels.py::test_mamba_scan_sweep (then jamba's)
    (2, 64, 32, 8, False),
    (1, 100, 48, 16, True),  # ragged L + seeded state
    (2, 256, 64, 16, False),
    (1, 32, 24, 4, True),
]
# B14's data-plane wave (benchmarks/bench_koalja.py): 64 arrays of 4.5 MiB
WAVE = dict(n=64, nbytes=(1 << 22) + (1 << 19), big_nbytes=1 << 30, seed=7)
SERVE = dict(arch="stablelm-1.6b", batch=4, prompt_len=512, gen=32, seed=0)
HYBRID = dict(arch="jamba-v0.1-52b", n_layers=8, batch=4, prompt_len=512, gen=32, seed=0)
N_CHECK = 8  # decode steps compared with the plain versions
N_STEADY = 16  # decode steps timed after warm-up
# kernel vs plain logits after the trunk. bf16: each layer's kernel output
# may differ by an ulp or two, compounded over depth and the vocab head, on
# logits of magnitude ~1-5 (bf16 ulp 2^-7..2^-5 there); in an MoE model those
# differences also break some near-tied top-k routings the other way. f32:
# each kernel output differs at ~1e-6 relative.
LOGIT_TOL = {"bfloat16": 0.25, "float32": 1e-3}


def fail(msg: str):
    raise RuntimeError(f"chip_smoke: {msg}")


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    import torch.nn.functional as F

    from repro_torch.configs import get_config
    from repro_torch.core import hashing
    from repro_torch.kernels import build, ops, ref
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.kernels.flash_decode import flash_decode
    from repro_torch.kernels.hash_tree import CHUNK_BLOCKS, hash_tree_state
    from repro_torch.kernels.mamba_scan import mamba_scan
    from repro_torch.kernels.moe_gmm import moe_gmm
    from repro_torch.launch import serve
    from repro_torch.models import moe as moe_mod
    from repro_torch.models.registry import build_model, decode_step, init_serve_state, prefill
    from repro_torch.workspace import InlineExecutor, Workspace

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

    def rand(*shape, dtype, scale=1.0):
        return (torch.randn(shape, generator=gen, device=dev, dtype=torch.float32) * scale).to(dtype)

    def check(name, got, want, dtype, tol=None):
        rtol, atol = tol or TOL[str(dtype).split(".")[-1]]
        err = (got.float() - want.float()).abs()
        if not torch.isfinite(got.float()).all():
            fail(f"{name}: non-finite output")
        bad = err > atol + rtol * want.float().abs()
        print(f"  {name}: max_abs_err {err.max().item():.3e} ({'ok' if not bad.any() else 'FAIL'})")
        if bad.any():
            fail(f"{name}: {int(bad.sum())} elements beyond rtol {rtol} atol {atol}")
        return err.max().item()

    def gmm_inputs(E, C, D, Fd, scale, dtype):
        if scale == "sweep":  # the reference test's scales
            s = (0.5, 0.1, 0.1, 0.1)
        else:  # fan-in scales, as the model's init: g, u, h and out of order 1
            s = (1.0, D**-0.5, D**-0.5, Fd**-0.5)
        return (rand(E, C, D, dtype=dtype, scale=s[0]), rand(E, D, Fd, dtype=dtype, scale=s[1]),
                rand(E, D, Fd, dtype=dtype, scale=s[2]), rand(E, Fd, D, dtype=dtype, scale=s[3]))

    def scan_inputs(B, L, Di, N, with_h0, dtype):
        return (rand(B, L, Di, dtype=dtype), rand(B, L, Di, dtype=torch.float32).abs() * 0.1,
                rand(B, L, N, dtype=torch.float32), rand(B, L, N, dtype=torch.float32),
                -rand(Di, N, dtype=torch.float32).abs() - 0.1,
                rand(B, Di, N, dtype=torch.float32) if with_h0 else None)

    # -- 2. each kernel against its plain version ------------------------------
    print("phase 2: kernels vs plain versions on the card")
    jamba = get_config(HYBRID["arch"])
    E, D, Fd = jamba.n_experts, jamba.d_model, jamba.d_ff
    c_prefill = moe_mod.expert_capacity(HYBRID["batch"] * HYBRID["prompt_len"], jamba)  # 320: drops
    c_decode = moe_mod.expert_capacity(HYBRID["batch"], jamba)  # 4: drop-free
    gmm_cases = [c + ("sweep",) for c in GMM_CASES] + [
        (E, c_decode, D, Fd, "fan_in"), (E, c_prefill, D, Fd, "fan_in")]
    scan_cases = SCAN_CASES + [(HYBRID["batch"], HYBRID["prompt_len"], jamba.d_inner, jamba.ssm_state, True)]
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
        for e, c, d, f, scale in gmm_cases:
            ins = gmm_inputs(e, c, d, f, scale, dtype)
            check(f"moe_gmm {dtype} E{e} C{c} D{d} F{f}", moe_gmm(*ins), ref.reference_gmm(*ins), dtype)
            del ins
        # partly empty bins, as a decode step's dispatch leaves them: 8
        # token-slots over 16 experts of 4 rows; empty rows must give exact zeros
        ins = gmm_inputs(E, c_decode, D, Fd, "fan_in", dtype)
        live = torch.zeros(E, c_decode, dtype=torch.bool, device=dev)
        slots = torch.arange(HYBRID["batch"] * jamba.top_k, device=dev)
        live[slots * E // len(slots), slots % c_decode] = True
        ins[0].mul_(live[..., None])
        got = moe_gmm(*ins)
        check(f"moe_gmm {dtype} E{E} C{c_decode} D{D} F{Fd}, {int(live.sum())} of {live.numel()} rows live",
              got, ref.reference_gmm(*ins), dtype)
        if got[~live].any():
            fail("moe_gmm: empty capacity rows gave non-zero output")
        del ins, got
        for B, L, Di, N, with_h0 in scan_cases:
            xc, dt, Bm, Cm, a, h0 = scan_inputs(B, L, Di, N, with_h0, dtype)
            y, h = mamba_scan(xc, dt, Bm, Cm, a, h0)
            yr, hr = ref.reference_selective_scan(xc, dt, Bm, Cm, a, h0)
            name = f"mamba_scan {dtype} B{B} L{L} Di{Di} N{N} h0={with_h0}"
            check(name + " y", y, yr, torch.float32, SCAN_TOL)
            check(name + " h", h, hr, torch.float32, SCAN_TOL)
        torch.cuda.empty_cache()
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

    # hash_tree: integer arithmetic mod 2**32, so every comparison is bit-equal
    chunk_words = hashing.TREE_BLOCK_WORDS * CHUNK_BLOCKS

    def u32(state):
        return tuple(int(x) & 0xFFFFFFFF for x in state.tolist())

    def host_state(words):
        return hashing.tree_state_np(words.cpu().numpy().view(np.uint8))

    def check_state(name, words):
        got, want = u32(hash_tree_state(words)), u32(ref.reference_hash_tree(words))
        host = host_state(words)
        print(f"  hash_tree {name}: kernel {got[0]:08x}.. plain {'=' if got == want else '!='} "
              f"host {'=' if got == host else '!='}")
        if not got == want == host:
            fail(f"hash_tree {name}: kernel {got} plain {want} host {host}")

    def check_digest(name, t):
        """The card route (kernel on the chunk-aligned bulk, the rest on the
        host) against the host digest of the .cpu() copy, and the kernel on
        the bulk against its plain version."""
        card, host = hashing.content_hash(t), hashing.content_hash(t.cpu())
        bulk = t.contiguous().reshape(-1).view(torch.uint8)
        n = (bulk.numel() // 4 // chunk_words) * chunk_words
        print(f"  hash_tree digest {name}: card {card} host {host}")
        if card != host:
            fail(f"hash_tree digest {name}: card {card} != host {host}")
        check_state(f"{name} bulk ({n} words)", bulk[: 4 * n].clone().view(torch.int32))

    i32_span = dict(dtype=torch.int32, generator=gen, device=dev)
    for n in (8192, 3 * 8192):
        check_state(f"{n} random words", torch.randint(-2**31, 2**31, (n,), **i32_span))
    big = 1 << 22
    check_digest("randn(1_300_001) f64", torch.randn(1_300_001, generator=gen, device=dev, dtype=torch.float64))
    check_digest("4 MiB + 13 uint8", torch.randint(0, 255, (big + 13,), dtype=torch.uint8, generator=gen, device=dev))
    check_digest("bf16 (4 MiB + 14 B)", rand(big // 2 + 7, dtype=torch.bfloat16))
    check_digest("bool (4 MiB + 5 B)", rand(big + 5, dtype=torch.float32) > 0)
    check_digest("int32 (4 MiB + 12 B)", torch.randint(-2**31, 2**31, (big // 4 + 3,), **i32_span))
    check_digest("non-contiguous view (2048, 1024).T f32", rand(2048, 1024, dtype=torch.float32).T)
    odd = torch.randint(0, 255, (2 * big + 64,), dtype=torch.uint8, generator=gen, device=dev)[1:]
    check_digest(f"misaligned slice (data_ptr % 16 = {odd.data_ptr() % 16})", odd)
    w = torch.randint(-2**31, 2**31, (chunk_words + 1,), **i32_span)[1:]
    check_state(f"misaligned words (data_ptr % 16 = {w.data_ptr() % 16})", w)
    x = rand(2 * big // 4, dtype=torch.float32)  # 8 MiB
    h0 = hashing.content_hash(x)
    x.view(torch.uint8)[5_000_001] ^= 1
    h1 = hashing.content_hash(x)
    print(f"  hash_tree one flipped byte at 5,000,001 of 8 MiB: {h0} -> {h1}")
    if h1 == h0 or h1 != hashing.content_hash(x.cpu()):
        fail("hash_tree: a flipped byte did not change the digest, or the card and host disagree")
    # a mixed wave: small card tensors share one host copy, large ones the kernel
    mixed = [rand(64, dtype=torch.float32), rand(7, 5, dtype=torch.bfloat16), torch.zeros(0, device=dev),
             rand(big // 4 + 1, dtype=torch.float32), np.arange(12.0), {"k": [1, 2]}, rand(3, dtype=torch.float16)]
    host_view = [p.cpu() if isinstance(p, torch.Tensor) else p for p in mixed]
    if hashing.content_hash_batch(mixed) != hashing.content_hash_batch(host_view):
        fail("content_hash_batch of a mixed card/host wave differs from its host copy")
    print("  content_hash_batch of a mixed card/host wave: equal to the host digests")
    del x, odd, w

    plain = {
        "flash_attention": ref.reference_attention,
        "flash_decode": ref.reference_decode,
        "moe_gmm": ref.reference_gmm,
        "mamba_scan": lambda xc, dt, Bm, Cm, a, h0=None, chunk_len=0: ref.reference_selective_scan(
            xc, dt, Bm, Cm, a, h0),
    }

    # every MoE layer's routing (probs, top-k experts) and dropped share,
    # recorded while kernels and plain versions are compared (diagnostic only)
    routes: list = []
    drops: list = []
    route, moe_ffn = moe_mod.route, moe_mod.moe_ffn

    def recording_route(p, cfg, xf):
        out = route(p, cfg, xf)
        routes.append((out[0], out[2]))
        return out

    def recording_moe_ffn(p, cfg, x, kernels=None):
        y, aux = moe_ffn(p, cfg, x, kernels=kernels)
        drops.append(aux["dropped_frac"])
        return y, aux

    def expected_launches(cfg, gen):
        n = {"attention": 0, "mamba": 0, "moe": 0}
        for i in range(cfg.n_layers):
            spec = cfg.layout[i % len(cfg.layout)]
            n[spec.mixer] += 1
            n["moe"] += spec.ffn == "moe"
        return {"flash_attention": n["attention"], "flash_decode": n["attention"] * (gen - 1),
                "moe_gmm": n["moe"] * gen, "mamba_scan": n["mamba"], "hash_tree": 0}

    def serve_checked(label, cfg, run_serve, spec):
        """Drive the serve entry once with every count at 0; returns (tokens, launches)."""
        ops.reset_launch_counts()
        tokens = run_serve()
        torch.cuda.synchronize()
        launches = ops.launch_counts()
        want = expected_launches(cfg, spec["gen"])
        print(f"  {label}: launches {launches} (want {want})")
        if launches != want:
            fail(f"{label}: launch counts {launches} != {want}")
        if tokens.shape != (spec["batch"], spec["gen"]) or not bool(((tokens >= 0) & (tokens < cfg.vocab)).all()):
            fail(f"{label}: bad generations {tuple(tokens.shape)}")
        return tokens, launches

    def compare_with_plain(cfg, spec, prompts, served, max_len):
        """Prefill + N_CHECK teacher-forced decode steps through the kernels and
        through the plain versions, in bf16 (the served model) and then in f32
        (the same seed's weights; one dtype's weights at a time)."""
        moe_mod.route, moe_mod.moe_ffn = recording_route, recording_moe_ffn
        try:
            for dtype in ("bfloat16", "float32"):
                model = build_model(dataclasses.replace(cfg, dtype=dtype))
                params = model.init(spec["seed"], dev)
                runs, rec = {}, {}
                for label, kernels in (("kernels", None), ("plain", plain)):
                    routes.clear()
                    drops.clear()
                    with torch.inference_mode():
                        state = init_serve_state(model, spec["batch"], max_len, dev)
                        lg, state = prefill(model, params, prompts, state, kernels=kernels)
                        steps = [lg.float()]
                        for t in range(N_CHECK):  # teacher-forced with the served tokens
                            lg, state = decode_step(model, params, served[:, t : t + 1], state, kernels=kernels)
                            steps.append(lg.float())
                    runs[label] = torch.stack(steps, dim=1)  # (B, 1 + N_CHECK, V)
                    rec[label] = (list(routes), [d.item() for d in drops])
                    del state
                report_logits(cfg, dtype, runs, rec, spec["batch"], served)
                del params, runs, rec
                torch.cuda.empty_cache()
        finally:
            moe_mod.route, moe_mod.moe_ffn = route, moe_ffn

    def report_logits(cfg, dtype, runs, rec, batch, served):
        name = cfg.name
        if dtype == cfg.dtype and not torch.equal(runs["kernels"].argmax(-1), served[:, : N_CHECK + 1]):
            fail(f"{name}: re-run through the kernels does not reproduce the served tokens")
        n_moe = sum(s.ffn == "moe" for s in cfg.layout) * cfg.n_groups
        (rk, dk), (rp, dp) = rec["kernels"], rec["plain"]
        if len(rk) != n_moe * (1 + N_CHECK) or len(rp) != len(rk):
            fail(f"{name}: recorded {len(rk)}/{len(rp)} routings, want {n_moe * (1 + N_CHECK)}")
        # Routing diagnostic: tokens whose top-k expert set differs between the
        # two runs (a near-tie of router probabilities that the two runs'
        # rounding resolves differently), and the (batch row, step) logits such
        # a flip can reach: it says whether a logit gap comes from routing or
        # from arithmetic.
        n_tok = n_flip = n_order = 0
        max_dprob = 0.0
        rerouted = torch.zeros(batch, 1 + N_CHECK, dtype=torch.bool, device=dev)
        for i, ((pk, ek), (pp, ep)) in enumerate(zip(rk, rp)):
            n_tok += ek.shape[0]
            flip = (torch.zeros_like(pk, dtype=torch.bool).scatter_(1, ek, True)
                    != torch.zeros_like(pp, dtype=torch.bool).scatter_(1, ep, True)).any(-1)
            n_flip += int(flip.sum())
            n_order += int(((ek != ep).any(-1) & ~flip).sum())
            max_dprob = max(max_dprob, (pk - pp).abs().max().item())
            rerouted[flip.view(batch, -1).any(-1), i // n_moe :] = True
        row_diff = (runs["kernels"] - runs["plain"]).abs().amax(-1)  # (B, 1 + N_CHECK)
        diff = row_diff.max().item()
        mine = runs["kernels"].argmax(-1)
        agree = runs["plain"].argmax(-1) == mine
        # where the tokens differ, the plain run's top logit may beat the
        # kernels' token by at most twice that row's logit difference: a tie within error
        gap = runs["plain"].amax(-1) - runs["plain"].gather(-1, mine[..., None])[..., 0]
        near_tie = (~agree) & (gap <= 2 * row_diff)
        print(f"  {name} {dtype}: prefill + {N_CHECK} decode steps, kernels vs plain on the card: max |logit diff| "
              f"{diff:.4e} (tol {LOGIT_TOL[dtype]}); greedy tokens agree {int(agree.sum())}/{agree.numel()}, "
              f"ties within error {int(near_tie.sum())}")
        if n_moe:
            def worst(mask):
                return f"{row_diff[mask].max().item():.4e}" if mask.any() else "-"

            print(f"    routing: {n_flip} of {n_tok} token top-k sets differ (+{n_order} in order only), "
                  f"max |router prob diff| {max_dprob:.3e}; max |logit diff| on the {int(rerouted.sum())} "
                  f"(row, step) a flip reaches {worst(rerouted)}, on the other {int((~rerouted).sum())} "
                  f"{worst(~rerouted)}; prefill slots dropped (capacity) kernels {sum(dk[:n_moe]) / n_moe:.4%} "
                  f"plain {sum(dp[:n_moe]) / n_moe:.4%}")
        if diff > LOGIT_TOL[dtype] or not bool((agree | near_tie).all()) or not torch.isfinite(runs["kernels"]).all():
            fail(f"{name} {dtype}: greedy tokens or logits through the kernels disagree with the plain versions")

    from torch.profiler import ProfilerActivity, profile

    def wall(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        return time.perf_counter() - t0

    def device_profile(fn):
        """Run fn once under torch.profiler: (wall s, device-busy s, the CUDA
        events, the profile)."""
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t = wall(fn)
        kern = [e for e in prof.events() if str(getattr(e, "device_type", "")).endswith("CUDA")]
        return t, sum(e.time_range.elapsed_us() for e in kern) / 1e6, kern, prof

    def steady_and_profiled(cfg, spec, prompts, max_len):
        """Warm serve times and the device's busy share (not part of the counted
        run: the launch counts are final)."""
        model = build_model(cfg)
        params = model.init(spec["seed"], dev)
        box = {}

        def run_prefill():
            box["state"] = init_serve_state(model, spec["batch"], max_len, dev)
            lg, box["state"] = prefill(model, params, prompts, box["state"])
            box["tok"] = lg.argmax(-1)[:, None]

        def run_decode():
            for _ in range(N_STEADY):
                lg, box["state"] = decode_step(model, params, box["tok"], box["state"])
                box["tok"] = lg.argmax(-1)[:, None]

        with torch.inference_mode():
            for _ in range(2):  # the second pass is warm
                prefill_s, decode_s = wall(run_prefill), wall(run_decode)
            step_ms = decode_s / N_STEADY * 1e3
            print(f"  {cfg.name} steady: prefill {spec['batch']}x{spec['prompt_len']} {prefill_s * 1e3:.2f} ms; "
                  f"decode {step_ms:.2f} ms/step ({spec['batch'] * N_STEADY / decode_s:.1f} tok/s)")
            for name, fn in (("prefill", run_prefill), ("decode", run_decode)):
                if name == "decode":
                    run_prefill()
                t, busy, kern, _ = device_profile(fn)
                by_name: dict = {}
                for e in kern:
                    by_name[e.name[:48]] = by_name.get(e.name[:48], 0.0) + e.time_range.elapsed_us() / 1e3
                top = sorted(by_name.items(), key=lambda kv: -kv[1])[:6]
                print(f"  {cfg.name} profiled {name}: wall {t * 1e3:.2f} ms, device busy {busy * 1e3:.2f} ms "
                      f"(idle share {1 - busy / t:.3f}), {len(kern)} kernels; top ms: "
                      + "; ".join(f"{n} {ms:.3f}" for n, ms in top))
        del params, box
        torch.cuda.empty_cache()

    # -- 3. serve stablelm-1.6b at full width ----------------------------------
    print("phase 3: serve", SERVE["arch"])
    argv = ["--arch", SERVE["arch"], "--batch", str(SERVE["batch"]), "--prompt-len",
            str(SERVE["prompt_len"]), "--gen", str(SERVE["gen"]), "--seed", str(SERVE["seed"]),
            "--device", "cuda"]
    cfg = get_config(SERVE["arch"])
    tokens, launches = serve_checked(SERVE["arch"], cfg, lambda: serve.main(argv), SERVE)
    max_len = SERVE["prompt_len"] + SERVE["gen"] + 8
    prompts = serve.make_prompts(cfg.vocab, SERVE["batch"], SERVE["prompt_len"], SERVE["seed"] + 1, dev)
    compare_with_plain(cfg, SERVE, prompts, tokens, max_len)
    steady_and_profiled(cfg, SERVE, prompts, max_len)
    torch.cuda.empty_cache()

    # -- 3b. serve jamba-v0.1-52b at full width, one layout period deep ---------
    hcfg = dataclasses.replace(get_config(HYBRID["arch"]), n_layers=HYBRID["n_layers"])
    print(f"phase 3b: serve {HYBRID['arch']} at full width, {hcfg.n_layers} of 32 layers")
    htokens, hlaunches = serve_checked(
        HYBRID["arch"], hcfg,
        lambda: serve.run(hcfg, HYBRID["batch"], HYBRID["prompt_len"], HYBRID["gen"], HYBRID["seed"], "cuda"),
        HYBRID)
    hmax_len = HYBRID["prompt_len"] + HYBRID["gen"] + 8
    hprompts = serve.make_prompts(hcfg.vocab, HYBRID["batch"], HYBRID["prompt_len"], HYBRID["seed"] + 1, dev)
    compare_with_plain(hcfg, HYBRID, hprompts, htokens, hmax_len)
    steady_and_profiled(hcfg, HYBRID, hprompts, hmax_len)

    del hprompts
    torch.cuda.empty_cache()

    # -- 3c. the Koalja circuit on the card --------------------------------------
    n_wave, wave_el, big_el = WAVE["n"], WAVE["nbytes"] // 4, WAVE["big_nbytes"] // 4
    print(f"phase 3c: the circuit on the card: {n_wave} pushes of {WAVE['nbytes']} B f32, "
          f"the same {n_wave} again, then one of {WAVE['big_nbytes']} B")
    wgen = torch.Generator(device=dev)
    wgen.manual_seed(WAVE["seed"])
    wave = [torch.randn(wave_el, generator=wgen, device=dev) for _ in range(n_wave)]
    big_x = torch.randn(big_el, generator=wgen, device=dev)

    def normalize(x):
        return {"y": (x - x.mean()) / x.std()}

    def circuit():
        ws = Workspace("normalize-on-card", executor=InlineExecutor(), topology=False)
        return ws, ws.task(normalize, name="normalize", inputs=["x"], outputs=["y"])

    def push_all(ws, task, xs):
        return [ws.push(task, x=x) for x in xs]

    ws, task = circuit()
    ops.reset_launch_counts()
    trees0 = hashing.hashing_stats()["tree_hashes"]
    first, last = [], []
    first_s = wall(lambda: first.extend(push_all(ws, task, wave)))
    after_first = dict(ws.stats()["tasks"]["normalize"])
    replay_s = wall(lambda: push_all(ws, task, wave))
    after_replay = dict(ws.stats()["tasks"]["normalize"])
    wave_launches = ops.launch_counts()["hash_tree"]  # the 4.5 MiB digests
    big_s = wall(lambda: last.append(ws.push(task, x=big_x)))
    launches3c = ops.launch_counts()
    trees = hashing.hashing_stats()["tree_hashes"] - trees0
    # pipeline.py _inject -> store.put hashes each pushed input (1 digest);
    # task.py _finish_execution hashes each executed output (1 digest); a memo
    # hit hashes no output. All payloads are > 4 MiB and on the card.
    want_trees = n_wave * 2 + n_wave + 2
    print(f"  normalize after pass 1 {after_first}, after the replay {after_replay}, after 1 GiB "
          f"{ws.stats()['tasks']['normalize']}")
    print(f"  hash_tree launches {launches3c['hash_tree']}, tree-tier digests {trees} (want {want_trees} = "
          f"{n_wave} inputs + {n_wave} outputs, {n_wave} replayed inputs, 1 GiB input + output)")
    if after_first != {"executions": n_wave, "cache_hits": 0} or after_replay != {
            "executions": n_wave, "cache_hits": n_wave}:
        fail(f"circuit: want {n_wave} executions then {n_wave} memo hits, got {after_first} / {after_replay}")
    if not launches3c["hash_tree"] == trees == want_trees or any(
            v for k, v in launches3c.items() if k != "hash_tree"):
        fail(f"circuit: launches {launches3c}, tree-tier digests {trees}, want {want_trees}")
    seen = {}
    for uid in ws.registry.all_avs():
        av = ws.registry.get_av(uid)
        if av.uri not in seen:
            payload = ws.value_of(av)
            seen[av.uri] = (av.chash, hashing.content_hash(payload.cpu()), payload)
    bad = [(c, h) for c, h, _ in seen.values() if c != h]
    print(f"  {len(ws.registry.all_avs())} AVs over {len(seen)} payloads: chash == host digest of the "
          f".cpu() copy for {len(seen) - len(bad)}")
    if bad or len(seen) != 2 * n_wave + 2:
        fail(f"circuit: {len(bad)} chashes differ from the host digest, {len(seen)} payloads")
    for y in (first[0]["normalize"]["y"], last[0]["normalize"]["y"]):
        m, sd = y.mean().item(), y.std().item()
        print(f"  normalize output of {y.numel()} elements: mean {m:.3e}, std {sd:.6f}")
        if not (bool(torch.isfinite(y).all()) and abs(m) < 1e-3 and abs(sd - 1) < 1e-3):
            fail(f"circuit: normalize output of {y.numel()} elements has mean {m}, std {sd}")
    del seen, first, last
    hash_s = min(wall(lambda: hashing.content_hash_batch(wave)) for _ in range(3))
    wave_gb = n_wave * WAVE["nbytes"] / 1e9
    print(f"  pass 1: {first_s * 1e3:.2f} ms, {n_wave / first_s:.1f} pushes/s; replay: {replay_s * 1e3:.2f} ms, "
          f"{n_wave / replay_s:.1f} pushes/s; 1 GiB push {big_s * 1e3:.2f} ms; content_hash_batch of the wave "
          f"(warm, best of 3) {hash_s * 1e3:.3f} ms, {wave_gb / hash_s:.1f} GB/s hashed")
    t, busy, kern, prof = device_profile(lambda: hashing.content_hash_batch(wave))
    trace = build.BUILD_DIR / "hash_wave_trace.json"
    prof.export_chrome_trace(str(trace))
    copies = [e for e in json.loads(trace.read_text())["traceEvents"]
              if e.get("cat") == "gpu_memcpy" and "DtoH" in e.get("name", "")]
    d2h = sum(int(e.get("args", {}).get("bytes", 0)) for e in copies)
    d2h_bound = n_wave * (32 * 1024 + 12)
    print(f"  profiled content_hash_batch of the wave: wall {t * 1e3:.3f} ms, device busy {busy * 1e3:.3f} ms "
          f"(idle share {1 - busy / t:.3f}), {len(kern)} device events; device-to-host {d2h} B in "
          f"{len(copies)} copies (bound {d2h_bound} B)")
    if not copies or d2h > d2h_bound:
        fail(f"circuit: {d2h} B copied device-to-host in {len(copies)} copies, bound {d2h_bound}")
    ws2, task2 = circuit()
    t, busy, kern, _ = device_profile(lambda: push_all(ws2, task2, wave))
    print(f"  profiled first pass on a fresh workspace: wall {t * 1e3:.2f} ms ({n_wave / t:.1f} pushes/s), "
          f"device busy {busy * 1e3:.3f} ms (idle share {1 - busy / t:.3f}), {len(kern)} device events")
    del ws, ws2, wave, big_x, prof
    torch.cuda.empty_cache()

    # -- 4. time each kernel at the serving shapes -------------------------------
    print("phase 4: timing at the serving shapes (bf16, L2 flushed before each launch)")
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
    es = 2
    rows = []

    def attention_rows(c, spec, n_launch_prefill, n_launch_decode):
        path = spec["arch"]
        B, Lp, S = spec["batch"], spec["prompt_len"], spec["prompt_len"] + spec["gen"] + 8
        H, KVH, Dh = c.n_heads, c.n_kv_heads, c.head_dim
        q, k, v = rand(B, Lp, H, Dh, dtype=bf), rand(B, S, KVH, Dh, dtype=bf), rand(B, S, KVH, Dh, dtype=bf)
        pairs = int(torch.ones(Lp, S).tril().sum().item())  # causal (q, k) pairs
        live = min(S, Lp)  # slots some query sees
        nbytes = 2 * B * Lp * H * Dh * es + 2 * B * live * KVH * Dh * es
        b_ms, b_by = bound(nbytes, 4 * B * H * Dh * pairs, "bfloat16")
        qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
        gqa = dict(enable_gqa=True) if H != KVH else {}
        err = check(f"flash_attention at {path} prefill shape", flash_attention(q, k, v),
                    ref.reference_attention(q, k, v), bf)
        lib_err = (F.scaled_dot_product_attention(qt, kt, vt, is_causal=True, **gqa).transpose(1, 2)
                   - ref.reference_attention(q, k, v)).abs().max().item()
        rows.append(dict(
            name="flash_attention", path=f"{path} prefill", route="cuda",
            source="src/repro_torch/kernels/csrc/flash_attention.cu",
            replaces="src/repro/kernels/flash_attention.py:116", launches=n_launch_prefill,
            max_abs_err=err,
            ms=time_ms(lambda: flash_attention(q, k, v)),
            plain_ms=time_ms(lambda: ref.reference_attention(q, k, v)),
            bound_ms=b_ms, bound_by=b_by,
            library_ms=time_ms(lambda: F.scaled_dot_product_attention(qt, kt, vt, is_causal=True, **gqa)),
            library="scaled_dot_product_attention(is_causal=True)",
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
        err = check(f"flash_decode at {path} decode shape", flash_decode(q1, k, v, kpos, qpos, nval),
                    ref.reference_decode(q1, k, v, kpos, qpos, nval), bf)
        rows.append(dict(
            name="flash_decode", path=f"{path} decode", route="cuda",
            source="src/repro_torch/kernels/csrc/flash_decode.cu",
            replaces="src/repro/kernels/flash_decode.py:89", launches=n_launch_decode,
            max_abs_err=err,
            ms=time_ms(lambda: flash_decode(q1, k, v, kpos, qpos, nval)),
            plain_ms=time_ms(lambda: ref.reference_decode(q1, k, v, kpos, qpos, nval)),
            bound_ms=b_ms, bound_by=b_by,
            library_ms=time_ms(lambda: F.scaled_dot_product_attention(q1t, kt, vt, attn_mask=mask, **gqa)),
            library="scaled_dot_product_attention(boolean mask)",
        ))

    attention_rows(cfg, SERVE, launches["flash_attention"], launches["flash_decode"])
    attention_rows(hcfg, HYBRID, hlaunches["flash_attention"], hlaunches["flash_decode"])

    n_moe = sum(s.ffn == "moe" for s in hcfg.layout) * hcfg.n_groups
    for phase, C, n_launch, reps in (
        ("prefill", c_prefill, n_moe, 10),
        ("decode", c_decode, n_moe * (HYBRID["gen"] - 1), 30),
    ):
        x, wg, wu, wd = gmm_inputs(E, C, D, Fd, "fan_in", bf)
        nbytes = 2 * E * C * D * es + 3 * E * D * Fd * es  # x and out once; every expert's weights once
        b_ms, b_by = bound(nbytes, 6 * E * C * D * Fd, "bfloat16")
        err = check(f"moe_gmm at {HYBRID['arch']} {phase} shape (E{E} C{C})", moe_gmm(x, wg, wu, wd),
                    ref.reference_gmm(x, wg, wu, wd), bf)

        def library():  # three torch.bmm calls and F.silu compute the same function
            return torch.bmm(F.silu(torch.bmm(x, wg)) * torch.bmm(x, wu), wd)

        lib_err = (library().float() - ref.reference_gmm(x, wg, wu, wd).float()).abs().max().item()
        rows.append(dict(
            name="moe_gmm", path=f"{HYBRID['arch']} {phase} (C {C})", route="cuda",
            source="src/repro_torch/kernels/csrc/moe_gmm.cu",
            replaces="src/repro/kernels/moe_gmm.py:59", launches=n_launch,
            max_abs_err=err,
            ms=time_ms(lambda: moe_gmm(x, wg, wu, wd), reps=reps),
            plain_ms=time_ms(lambda: ref.reference_gmm(x, wg, wu, wd), reps=reps),
            bound_ms=b_ms, bound_by=b_by,
            library_ms=time_ms(library, reps=reps),
            library="3 calls: torch.bmm x3 + F.silu",
        ))
        print(f"  library (3x torch.bmm + F.silu) vs plain at {phase}: max_abs_err {lib_err:.3e}")
        del x, wg, wu, wd
        torch.cuda.empty_cache()

    B, L, Di, N = HYBRID["batch"], HYBRID["prompt_len"], hcfg.d_inner, hcfg.ssm_state
    xc, dt, Bm, Cm, a, h0 = scan_inputs(B, L, Di, N, True, bf)
    # xc (bf16) and dt read once, B/C/a/h0 read once, y and h written once
    nbytes = B * L * Di * (es + 4 + 4) + 2 * B * L * N * 4 + Di * N * 4 + 2 * B * Di * N * 4
    b_ms, b_by = bound(nbytes, 7 * B * L * Di * N, "float32")  # exp, 2 mul, 2 fma, mul-add for y
    y, h = mamba_scan(xc, dt, Bm, Cm, a, h0)
    yr, hr = ref.reference_selective_scan(xc, dt, Bm, Cm, a, h0)
    err = max(check(f"mamba_scan at {HYBRID['arch']} prefill shape y", y, yr, torch.float32, SCAN_TOL),
              check(f"mamba_scan at {HYBRID['arch']} prefill shape h", h, hr, torch.float32, SCAN_TOL))
    rows.append(dict(
        name="mamba_scan", path=f"{HYBRID['arch']} prefill", route="cuda",
        source="src/repro_torch/kernels/csrc/mamba_scan.cu",
        replaces="src/repro/kernels/mamba_scan.py:69", launches=hlaunches["mamba_scan"],
        max_abs_err=err,
        ms=time_ms(lambda: mamba_scan(xc, dt, Bm, Cm, a, h0)),
        plain_ms=time_ms(lambda: ref.reference_selective_scan(xc, dt, Bm, Cm, a, h0), reps=5),
        bound_ms=b_ms, bound_by=b_by,
        library_ms=None, library="none",
    ))
    del xc, dt, Bm, Cm, a, h0, y, h, yr, hr
    # hash_tree at phase 3c's payloads: reads 4 bytes a word once, writes 12;
    # about one integer add per word is far below any rate of the card, so
    # the bound is bytes. No PyTorch call computes this function.
    for label, nbytes, n_launch in (("4.5 MiB", WAVE["nbytes"], wave_launches),
                                    ("1 GiB", WAVE["big_nbytes"], launches3c["hash_tree"] - wave_launches)):
        w = torch.randint(-2**31, 2**31, (nbytes // 4,), dtype=torch.int32, generator=gen, device=dev)
        got, want = hash_tree_state(w), ref.reference_hash_tree(w)
        if not torch.equal(got, want):
            fail(f"hash_tree at {label}: kernel {got.tolist()} != plain {want.tolist()}")
        rows.append(dict(
            name="hash_tree", path=f"circuit digest of a {label} payload", route="cuda",
            source="src/repro_torch/kernels/csrc/hash_tree.cu",
            replaces="src/repro/kernels/hash_tree.py:74", launches=n_launch,
            max_abs_err=0.0,
            ms=time_ms(lambda: hash_tree_state(w)),
            plain_ms=time_ms(lambda: ref.reference_hash_tree(w), reps=5),
            bound_ms=(nbytes + 12) / PEAK_BYTES_PER_S * 1e3, bound_by="bytes",
            library_ms=None, library="none",
        ))
        del w
        torch.cuda.empty_cache()
    for r in rows:
        lib = "none" if r["library_ms"] is None else f"{r['library_ms']:.4f}"
        print(f"  {r['name']} [{r['path']}]: kernel_ms {r['ms']:.4f} library_ms {lib} "
              f"plain_ms {r['plain_ms']:.4f} bound_ms {r['bound_ms']:.4f} ({r['bound_by']}) launches {r['launches']}")
    torch.cuda.synchronize()

    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

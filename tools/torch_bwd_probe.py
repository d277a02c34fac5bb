#!/usr/bin/env python3
"""Check and time the PyTorch port's training backward kernels K1
(``flash_attention_bwd``), K7a (``moe_gmm_bwd``) and K7b (``mamba_scan_bwd``)
on one card, at their training shapes, against variants of their CUDA
sources in the same call:

  python3 tools/torch_bwd_probe.py [--kernels flash_attention_bwd moe_gmm_bwd mamba_scan_bwd]
      [--variant NAME=DIR ...] [--part check|timing|both]

A variant is a directory holding a copy of ``src/repro_torch/kernels/csrc``
with edits (its C entries keeping the repo's signatures); it is built with
``build.NVCC_FLAGS`` into ``build/bwd_probe/NAME/``, as the repo's sources
are into ``build/bwd_probe/repo/``, and swapped in for the repo's library
while it runs. Each build's registers a thread (ptxas) are printed for K1's
wgmma entries and for every entry that spills.
check: each kernel (the repo's sources and each variant) against its plain
  version over ragged cases and the training shapes (bf16 within
  ``chip_smoke.BWD_TOL``; the scan also f32), bit-equal when run twice at the
  training shapes; the scan's backward in 3 segments (offset limit patched
  small) bit-equal to one call. A variant whose C entry refuses a shape is
  reported so.
timing: at the training shapes, CUDA events around each call (median of 10,
  L2 flushed before each by writing 256 MiB, as ``chip_smoke.py`` times
  them), the repo and the variants in turns (forward then backward order,
  twice for K1), beside K7's first design (mma, per_step); each launch's
  device time from torch.profiler (3 calls, L2 warm).
"""

from __future__ import annotations

import argparse
import ctypes
import re
import statistics
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
SOURCE = {"flash_attention_bwd": "flash_attention_bwd", "moe_gmm_bwd": "moe_gmm", "mamba_scan_bwd": "mamba_scan"}
# (B, Lq, Lk, H, KVH, Dk, Dv, causal, training): ragged edges, then the
# training shapes of stablelm-1.6b, qwen2.5-32b's heads (chip_smoke.K1_QWEN),
# minicpm3-4b, seamless-m4t-medium's decoder, cross-attention and encoder,
# and internvl2-1b
K1_CASES = [(2, 200, 200, 8, 8, 96, 64, True, False), (2, 77, 150, 8, 4, 64, 64, False, False),
            (2, 131, 131, 14, 2, 64, 64, True, False), (8, 2048, 2048, 32, 32, 64, 64, True, True),
            (1, 4096, 4096, 40, 8, 128, 128, True, True), (4, 1024, 1024, 40, 40, 96, 64, True, True),
            (4, 1024, 1024, 16, 16, 64, 64, True, True), (4, 1024, 4096, 16, 16, 64, 64, False, True),
            (4, 4096, 4096, 16, 16, 64, 64, False, True), (4, 2048, 2048, 14, 2, 64, 64, True, True)]
GMM_CASES = [(4, 32, 64, 96), (3, 1, 200, 328), (3, 129, 200, 328), (16, 640, 4096, 14336)]  # (E, C, D, F)
SCAN_CASES = [(2, 77, 136, 16), (2, 45, 130, 4), (2, 45, 130, 32), (4, 1024, 8192, 16)]  # (B, L, Di, N)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--kernels", nargs="+", choices=tuple(SOURCE), default=tuple(SOURCE))
    ap.add_argument("--variant", action="append", default=[], metavar="NAME=DIR")
    ap.add_argument("--part", choices=("check", "timing", "both"), default="both")
    args = ap.parse_args()
    sys.path.insert(0, str(ROOT / "src"))
    sys.path.insert(0, str(ROOT))
    import torch
    from torch.profiler import ProfilerActivity, profile

    from chip_smoke import BWD_TOL, on_k7_baseline
    import repro_torch.kernels.mamba_scan as scan_module
    from repro_torch.kernels import build, ref
    from repro_torch.kernels.flash_attention import flash_attention, flash_attention_bwd
    from repro_torch.kernels.mamba_scan import mamba_scan_bwd
    from repro_torch.kernels.moe_gmm import moe_gmm_bwd

    if not torch.cuda.is_available():
        print("torch_bwd_probe: no CUDA device", file=sys.stderr)
        return 2
    variants = dict(v.split("=", 1) for v in args.variant)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip())
    procs = {}  # every build started at once, one nvcc each
    for kernel in args.kernels:
        for name, d in {"repo": build.CSRC, **variants}.items():
            out = ROOT / "build" / "bwd_probe" / name / f"lib{SOURCE[kernel]}.so"
            out.parent.mkdir(parents=True, exist_ok=True)
            procs[kernel, name] = out, subprocess.Popen(
                [build.nvcc_path(), *build.NVCC_FLAGS, "-o", str(out), str(Path(d) / f"{SOURCE[kernel]}.cu")],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    libs = {}
    for (kernel, name), (out, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc {name} {SOURCE[kernel]}.cu:\n{log}")
        for entry, line in entry_reports(log, build.cuda_tool("cu++filt")):
            if ("wg::" in entry and kernel == "flash_attention_bwd") or "spill" in line:
                print(f"  {SOURCE[kernel]} {name} {entry}: {line}")
        libs.setdefault(SOURCE[kernel], {})[name] = ctypes.CDLL(str(out))
    for src in libs:
        build._LIBS[src] = libs[src]["repo"]
    names = ["repo", *variants]
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    flush = torch.empty(256 * 2**20, dtype=torch.uint8, device=dev)

    def rand(*shape, dtype=torch.float32, scale=1.0):
        return (torch.randn(shape, generator=gen, device=dev) * scale).to(dtype)

    def on(src, name, fn):
        build._LIBS[src] = libs[src][name]
        try:
            return fn()
        finally:
            build._LIBS[src] = libs[src]["repo"]

    def err_ok(got, want):
        rtol, atol = BWD_TOL[str(want.dtype).split(".")[-1]]
        w = want.float()
        return bool(((got.float() - w).abs() <= atol * w.abs().max() + rtol * w.abs()).all())

    def time_ms(fn, reps=10):
        for _ in range(2):
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

    def split(fn):
        fn()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(3):
                fn()
            torch.cuda.synchronize()
        out: dict = {}
        for e in prof.events():
            if m := re.search(r"(\w+_kernel(?:<[^()]*>)?)", e.name):
                out.setdefault(m[1], []).append(e.time_range.elapsed_us() / 1e3)
        return {k: round(statistics.mean(v), 4) for k, v in out.items()}

    ok = True
    if "flash_attention_bwd" in args.kernels:
        src, bf = "flash_attention_bwd", torch.bfloat16
        for B, Lq, Lk, H, KVH, Dk, Dv, causal, training in K1_CASES:
            case = f"({B}, {Lq} x {Lk}, {H}/{KVH}, {Dk}/{Dv}, {'causal' if causal else 'non-causal'})"
            q, do = rand(B, Lq, H, Dk, dtype=bf), rand(B, Lq, H, Dv, dtype=bf)
            k, v = rand(B, Lk, KVH, Dk, dtype=bf), rand(B, Lk, KVH, Dv, dtype=bf)
            o, lse = flash_attention(q, k, v, causal=causal, return_lse=True)

            def call():
                return flash_attention_bwd(q, k, v, o, do, lse, causal=causal)

            live = []
            if args.part in ("check", "both"):
                want = ref.reference_attention_bwd(q, k, v, o, do, lse, causal=causal)
                for name in names:
                    try:
                        got = on(src, name, call)
                    except RuntimeError as e:  # a variant's C entry that does not take the shape
                        print(f"flash_attention_bwd {case} {name}: refused ({e})")
                        continue
                    line = [all(err_ok(g, w) for g, w in zip(got, want))]
                    if training:
                        line.append(all(torch.equal(a, b) for a, b in zip(got, on(src, name, call))))
                    ok &= all(line)
                    live.append(name)
                    print(f"flash_attention_bwd {case} {name}: within BWD_TOL, bit-equal twice: {line}")
                del want
            if args.part in ("timing", "both") and training:
                timed = live if args.part == "both" else names
                ms = {n: [] for n in timed}
                for n in (timed + timed[::-1]) * 2:
                    ms[n].append(on(src, n, lambda: time_ms(call)))
                print(f"flash_attention_bwd {case} ms (in turns): {ms}")
                for n in timed:
                    print(f"  device ms by launch, {n}: {on(src, n, lambda: split(call))}")
            del q, k, v, o, do, lse
            torch.cuda.empty_cache()
    for kernel in [k for k in args.kernels if k != "flash_attention_bwd"]:
        src = SOURCE[kernel]
        cases = GMM_CASES if kernel == "moe_gmm_bwd" else SCAN_CASES
        for case in cases:
            if kernel == "moe_gmm_bwd":
                E, C, D, F = case
                bf = torch.bfloat16
                ins = (rand(E, C, D, dtype=bf), rand(E, D, F, dtype=bf, scale=D**-0.5),
                       rand(E, D, F, dtype=bf, scale=D**-0.5), rand(E, F, D, dtype=bf, scale=F**-0.5),
                       rand(E, C, D, dtype=bf, scale=D**-0.5))
                dtypes = (bf,)
            else:
                B, L, Di, N = case
                dtypes = (torch.float32, torch.bfloat16)
            for dtype in dtypes:
                training = case in (GMM_CASES[-1], SCAN_CASES[-1])
                if kernel == "mamba_scan_bwd":  # h0 and dh_final but at the training shape, which has neither
                    carry = None if training else rand(B, Di, N)
                    ins = (rand(B, L, Di, dtype=dtype), rand(B, L, Di).abs() * 0.1, rand(B, L, N), rand(B, L, N),
                           -rand(Di, N).abs() - 0.1, carry, rand(B, L, Di), carry)
                call = (lambda: moe_gmm_bwd(*ins)) if kernel == "moe_gmm_bwd" else (lambda: mamba_scan_bwd(*ins))
                if args.part in ("check", "both"):
                    want = (ref.reference_gmm_bwd if kernel == "moe_gmm_bwd" else ref.reference_selective_scan_bwd)(*ins)
                    for name in names:
                        got = on(src, name, call)
                        line = [all(err_ok(g, w) for g, w in zip(got, want))]
                        if training:
                            line.append(all(torch.equal(a, b) for a, b in zip(got, on(src, name, call))))
                        if training and kernel == "mamba_scan_bwd":
                            limit = scan_module.OFFSET_LIMIT
                            scan_module.OFFSET_LIMIT = (400 + scan_module.MAX_AHEAD) * Di + 1
                            try:
                                segs = on(src, name, call)
                            finally:
                                scan_module.OFFSET_LIMIT = limit
                            line.append(all(torch.equal(a, b) for a, b in zip(got, segs)))
                        ok &= all(line)
                        print(f"{kernel} {case} {dtype} {name}: within BWD_TOL, bit-equal twice, segments "
                              f"bit-equal: {line}")
                    del want
                if args.part in ("timing", "both") and training and dtype == torch.bfloat16:
                    ms = {n: [] for n in names}
                    for n in names + names[::-1]:
                        ms[n].append(on(src, n, lambda: time_ms(call)))
                    ms["first design"] = [time_ms(lambda: on_k7_baseline(kernel, call))]
                    print(f"{kernel} {case} ms (in turns): {ms}")
                    for n in names:
                        print(f"  device ms by launch, {n}: {on(src, n, lambda: split(call))}")
                    print(f"  device ms by launch, first design: {split(lambda: on_k7_baseline(kernel, call))}")
                torch.cuda.empty_cache()
    print("OK" if ok else "FAILED")
    return 0 if ok else 1


def entry_reports(report: str, cxxfilt: str) -> list:
    """(demangled kernel, its line) for each "Used N registers" and spill
    line of a ptxas report, by the entry it belongs to."""
    found, entry = [], None
    for line in report.splitlines():
        if "Function properties for " in line or "Compiling entry function" in line:
            entry = line.split("'")[1] if "Compiling" in line else line.split(" for ")[1].strip()
        elif entry and ("Used " in line or ("spill" in line and " 0 bytes spill" not in line)):
            found.append((entry, line.split(":", 1)[-1].strip() if "Used " in line else line.strip()))
    if not found:
        return []
    names = subprocess.run([cxxfilt], input="\n".join(e for e, _ in found), capture_output=True, text=True,
                           check=True).stdout.splitlines()
    kernel = re.compile(r"(?:\w+::)*\w+_kernel(?:<[^<>]*>)?")
    return [(m[0] if (m := kernel.search(n)) else n, l) for n, (_, l) in zip(names, found)]


if __name__ == "__main__":
    sys.exit(main())

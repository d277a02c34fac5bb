#!/usr/bin/env python3
"""Check and time the PyTorch port's training backward kernels K7a
(``moe_gmm_bwd``) and K7b (``mamba_scan_bwd``) on one card, at jamba-v0.1-52b's
training shapes, against variants of their CUDA sources in the same call:

  python3 tools/torch_k7_probe.py [--kernels moe_gmm_bwd mamba_scan_bwd]
      [--variant NAME=DIR ...] [--part check|timing|both]

A variant is a directory holding a copy of ``src/repro_torch/kernels/csrc``
with edits (its C entries keeping the repo's signatures); it is built with
``build.NVCC_FLAGS`` into ``build/k7_probe/NAME/`` and swapped in for the
repo's library while it runs.
check: each kernel (the repo's sources and each variant) against its plain
  version over ragged cases and the training shape (bf16 within
  ``chip_smoke.BWD_TOL``; the scan also f32), bit-equal when run twice at the
  training shape; the scan's backward in 3 segments (offset limit patched
  small) bit-equal to one call.
timing: at the training shape, CUDA events around each call (median of 10,
  L2 flushed before each by writing 256 MiB, as ``chip_smoke.py`` times
  them), the repo and the variants in turns (forward then backward order),
  beside the first design (mma, per_step); each launch's device time from
  torch.profiler (3 calls, L2 warm).
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
SOURCE = {"moe_gmm_bwd": "moe_gmm", "mamba_scan_bwd": "mamba_scan"}
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
    from repro_torch.kernels.mamba_scan import mamba_scan_bwd
    from repro_torch.kernels.moe_gmm import moe_gmm_bwd

    if not torch.cuda.is_available():
        print("torch_k7_probe: no CUDA device", file=sys.stderr)
        return 2
    variants = dict(v.split("=", 1) for v in args.variant)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip())
    libs = {}
    for kernel in args.kernels:
        src = SOURCE[kernel]
        libs[src] = {"repo": build.load(src)}
        for name, d in variants.items():
            out = ROOT / "build" / "k7_probe" / name / f"lib{src}.so"
            out.parent.mkdir(parents=True, exist_ok=True)
            subprocess.run([build.nvcc_path(), *build.NVCC_FLAGS, "-o", str(out), str(Path(d) / f"{src}.cu")],
                           check=True, capture_output=True)
            libs[src][name] = ctypes.CDLL(str(out))
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
    for kernel in args.kernels:
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


if __name__ == "__main__":
    sys.exit(main())

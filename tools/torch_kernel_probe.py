#!/usr/bin/env python3
"""Check and time the PyTorch port's ``flash_decode``, ``mamba_scan`` and
``hash_tree`` kernels on one card, at the shapes of ``chip_smoke.py``'s serve
paths and circuit:

  python3 tools/torch_kernel_probe.py [--src DIR] [--part check|timing|both] [--sweep]
      [--kernels flash_decode mamba_scan hash_tree]

check: each kernel against its plain version over ``chip_smoke.py``'s phase 2
  cases (flash_decode f32 2e-5, bf16 2e-2; mamba_scan 1e-4), flash_decode
  also at n_split 1, 2, 3, 4, 6 and 8 with ``--sweep``; mamba_scan also cut
  into segments (offset limit patched small) against one launch, bit for
  bit; hash_tree's states of ragged payloads (many in one launch) bit-equal
  to the plain version and the host's, and their tree digests to the host's.
timing: flash_decode at stablelm-1.6b's and jamba-v0.1-52b's decode shapes
  (B 4, cache 552 slots, 528 written, bf16) and mamba_scan at jamba's
  prefill shape (B 4, L 512, Di 8192, N 16, bf16 xc, h0): CUDA events
  around each launch (median of 30) with L2 flushed before each by writing
  256 MiB, as phase 4 times them; the launches' device time from
  torch.profiler; SDPA and the bound beside; flash_decode's host time per
  call (its wrapper, launched back to back, and ``split_for`` alone);
  hash_tree at 4.5 MiB and 1 GiB (one payload a call) and on B14's wave of
  64 x 4.5 MiB (one call, where the tree has ``hash_tree_states``), with the
  host time of a call launched back to back, and the
  host clock of ``content_hash_batch`` over that wave (median of 5) and of
  one payload, as a push hashes it, with its parts. With
  ``--sweep`` flash_decode at each ``n_split`` (``split_for`` replaced here),
  at stablelm's bytes and pairs with each pair's K/V one contiguous run
  (B 128, one KV head), and ``k.sum()`` + ``v.sum()``.

``--src DIR`` imports ``repro_torch`` from another checkout's ``src`` (its
wrappers' defaults only), so two trees can be timed in one call.
"""

from __future__ import annotations

import argparse
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--src", default=str(ROOT / "src"))
    ap.add_argument("--part", choices=("check", "timing", "both"), default="both")
    ap.add_argument("--sweep", action="store_true", help="flash_decode at each n_split, and on a contiguous cache")
    ap.add_argument("--kernels", nargs="+", choices=("flash_decode", "mamba_scan", "hash_tree"),
                    default=("flash_decode", "mamba_scan", "hash_tree"))
    args = ap.parse_args()
    sys.path.insert(0, str(ROOT))
    from chip_smoke import DECODE_CASES, SCAN_CASES, SCAN_TOL, TOL, WAVE

    sys.path.insert(0, args.src)  # ahead of the path chip_smoke put first
    import torch
    import torch.nn.functional as F

    if not torch.cuda.is_available():
        print("torch_kernel_probe: no CUDA device", file=sys.stderr)
        return 2
    import repro_torch.kernels.flash_decode as fd_module
    import repro_torch.kernels.hash_tree as ht_module
    import repro_torch.kernels.mamba_scan as scan_module
    from repro_torch.core import hashing
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.kernels import build, ref
    from repro_torch.kernels.flash_decode import flash_decode
    from repro_torch.kernels.mamba_scan import mamba_scan

    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit,clocks.max.sm", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip(), f"(src {args.src})")
    kernels = set(args.kernels)
    reports = build.build_all(tuple(args.kernels))
    for name, rep in reports.items():
        entry = None
        for line in rep.splitlines():
            if "Compiling entry function" in line:
                entry = line.split("'")[1][:60]
            elif "Used" in line and entry:
                print(f"  {name} {entry}: {line.split(':', 1)[-1].strip()}")
            elif "spill" in line and " 0 bytes spill" not in line:
                print(f"  {name} {entry}: {line.strip()}")
    splits = [None] + ([1, 2, 3, 4, 6, 8] if args.sweep and hasattr(fd_module, "split_for") else [])

    def decode(q, k, v, kp, qp, nv, window=0, n_split=None):
        """flash_decode with ``n_split`` blocks a (batch, KV head), or with its
        own choice for None."""
        if n_split is None:
            return flash_decode(q, k, v, kp, qp, nv, window=window)
        chosen = fd_module.split_for
        fd_module.split_for = lambda q, k: n_split
        try:
            return flash_decode(q, k, v, kp, qp, nv, window=window)
        finally:
            fd_module.split_for = chosen

    def rand(*shape, dtype, scale=1.0):
        return (torch.randn(shape, generator=gen, device=dev) * scale).to(dtype)

    def err_ok(got, want, rtol, atol):
        e = (got.float() - want.float()).abs()
        return e.max().item(), bool(torch.isfinite(got.float()).all()) and not bool(
            (e > atol + rtol * want.float().abs()).any())

    bad = 0
    if args.part in ("check", "both"):
        for dtype in (torch.float32, torch.bfloat16):
            rtol, atol = TOL[str(dtype).split(".")[-1]]
            for B, S, H, KVH, Dh, window, nv, qp, ring_pos in DECODE_CASES if "flash_decode" in kernels else []:
                q, k, v = rand(B, 1, H, Dh, dtype=dtype), rand(B, S, KVH, Dh, dtype=dtype), rand(B, S, KVH, Dh, dtype=dtype)
                kpos = torch.arange(S, dtype=torch.int32, device=dev)
                if ring_pos:
                    kpos = torch.roll(kpos + (qp - S + 1), 13)
                kpos = kpos.expand(B, S).contiguous()
                qpos = torch.full((B,), qp, dtype=torch.int32, device=dev)
                nval = torch.full((B,), nv, dtype=torch.int32, device=dev)
                want = ref.reference_decode(q, k, v, kpos, qpos, nval, window=window)
                res = []
                for n_split in splits:
                    e, ok = err_ok(decode(q, k, v, kpos, qpos, nval, window, n_split), want, rtol, atol)
                    bad += not ok
                    res.append(f"{n_split or 'auto'} {e:.2e}{'' if ok else ' FAIL'}")
                print(f"  flash_decode {dtype} B{B} S{S} H{H}/{KVH} Dh{Dh} w{window} nv{nv}: " + ", ".join(res))
            for B, L, Di, N, with_h0 in SCAN_CASES + [(4, 512, 8192, 16, True)] if "mamba_scan" in kernels else []:
                xc = rand(B, L, Di, dtype=dtype)
                dt = rand(B, L, Di, dtype=torch.float32).abs() * 0.1
                Bm, Cm = rand(B, L, N, dtype=torch.float32), rand(B, L, N, dtype=torch.float32)
                a = -rand(Di, N, dtype=torch.float32).abs() - 0.1
                h0 = rand(B, Di, N, dtype=torch.float32) if with_h0 else None
                yr, hr = ref.reference_selective_scan(xc, dt, Bm, Cm, a, h0)
                y, h = mamba_scan(xc, dt, Bm, Cm, a, h0)
                (ey, oy), (eh, oh) = err_ok(y, yr, *SCAN_TOL), err_ok(h, hr, *SCAN_TOL)
                bad += not (oy and oh)
                print(f"  mamba_scan {dtype} B{B} L{L} Di{Di} N{N} h0={with_h0}: y {ey:.2e} h {eh:.2e}"
                      f"{'' if oy and oh else ' FAIL'}")
        if "mamba_scan" in kernels and hasattr(scan_module, "OFFSET_LIMIT"):
            B, L, Di, N = 4, 512, 8192, 16  # jamba's prefill, cut into segments of 200 steps
            ins = (rand(B, L, Di, dtype=torch.bfloat16), rand(B, L, Di, dtype=torch.float32).abs() * 0.1,
                   rand(B, L, N, dtype=torch.float32), rand(B, L, N, dtype=torch.float32),
                   -rand(Di, N, dtype=torch.float32).abs() - 0.1, rand(B, Di, N, dtype=torch.float32))
            y, h = mamba_scan(*ins)
            limit, scan_module.OFFSET_LIMIT = scan_module.OFFSET_LIMIT, (200 + scan_module.MAX_AHEAD) * Di + 1
            try:
                n0 = mamba_scan.launches
                ys, hs = mamba_scan(*ins)
                n_seg = mamba_scan.launches - n0
            finally:
                scan_module.OFFSET_LIMIT = limit
            equal = torch.equal(y, ys) and torch.equal(h, hs)
            bad += not equal or n_seg != 3
            print(f"  mamba_scan in {n_seg} segments vs one launch: max |diff| "
                  f"{max((y - ys).abs().max().item(), (h - hs).abs().max().item()):.3e}, bit-equal {equal}")
        if "hash_tree" in kernels and hasattr(ht_module, "hash_tree_states"):
            def u8_rand(n):
                return torch.randint(0, 256, (n,), dtype=torch.uint8, generator=gen, device=dev)

            big = 1 << 22
            ragged = [u8_rand(n) for n in (1, 2, 3, 4, 5, 300, 511, 512, 513, 512 * 7 + 129, 8192 * 4 + 2,
                                           big + 1, big + 2, big + 3, 3 * big + 511, 0)] + [u8_rand(big + 64)[5:]]
            for label, u8s in (("ragged", ragged), ("ragged, again", ragged),
                               ("300 payloads", [u8_rand(n) for n in range(0, 300 * 4099, 4099)]),
                               ("the wave", [u8_rand(WAVE["nbytes"]) for _ in range(WAVE["n"])])):
                n0 = ht_module.hash_tree_states.launches
                got = ht_module.hash_tree_states(u8s)
                n_launch = ht_module.hash_tree_states.launches - n0
                diff = [i for i, u8 in enumerate(u8s)
                        if not torch.equal(got[i], ref.reference_hash_tree_bytes(u8))
                        or tuple(int(x) & 0xFFFFFFFF for x in got[i].tolist()) != hashing.tree_state_np(u8.cpu().numpy())
                        or hashing.tree_digest(u8) != hashing.tree_digest(u8.cpu())]
                bad += bool(diff)
                print(f"  hash_tree {label}: {len(u8s)} payloads in {n_launch} launch(es); kernel, plain, host "
                      f"and digests differ for {diff[:8]}")
        print(f"check: {bad} failures")

    if args.part in ("timing", "both"):
        flush = torch.empty(256 * 2**20, dtype=torch.uint8, device=dev)  # written to flush L2, as phase 4
        torch.cuda.synchronize()

        def flushed(fn, reps=30):
            for _ in range(3):
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

        def device_ms(fn, kernel, reps=20):
            """Median device time of the launches of ``kernel`` (torch.profiler),
            L2 flushed before each."""
            fn()
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                for _ in range(reps):
                    flush.zero_()
                    fn()
                torch.cuda.synchronize()
            durs = [e.time_range.elapsed_us() / 1e3 for e in prof.events()
                    if str(getattr(e, "device_type", "")).endswith("CUDA") and kernel in e.name]
            return statistics.median(durs) if durs else float("nan")

        pick_fn = hasattr(fd_module, "split_for")

        def host_us(fn, reps=2000, sync=True):
            """Host clock per call of ``fn`` over ``reps`` calls back to back
            (median of 5 rounds), the queue drained before and, with
            ``sync``, after each round."""
            rounds = []
            for _ in range(5):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                for _ in range(reps):
                    fn()
                if sync:
                    torch.cuda.synchronize()
                rounds.append((time.perf_counter() - t0) / reps * 1e6)
            return statistics.median(rounds)

        bf = torch.bfloat16
        shapes = [("stablelm-1.6b", 4, 32, 32, 64), ("jamba-v0.1-52b", 4, 32, 8, 128)]
        if args.sweep:  # stablelm's bytes and pairs, each pair's K/V one contiguous run
            shapes.append(("contiguous-cache probe", 128, 1, 1, 64))
        for label, B, H, KVH, Dh in shapes if "flash_decode" in kernels else []:
            S, nv = 552, 528
            q1, k, v = rand(B, 1, H, Dh, dtype=bf), rand(B, S, KVH, Dh, dtype=bf), rand(B, S, KVH, Dh, dtype=bf)
            kpos = torch.arange(S, dtype=torch.int32, device=dev).expand(B, S).contiguous()
            qpos = torch.full((B,), nv - 1, dtype=torch.int32, device=dev)
            nval = torch.full((B,), nv, dtype=torch.int32, device=dev)
            nbytes = 2 * B * nv * KVH * Dh * 2 + 2 * B * H * Dh * 2 + B * nv * 4 + 2 * B * 4
            mask = ((torch.arange(S, device=dev)[None] < nval[:, None]) & (kpos <= qpos[:, None]))[:, None, None]
            qt, kt, vt = (x.transpose(1, 2) for x in (q1, k, v))
            gqa = dict(enable_gqa=True) if H != KVH else {}
            sdpa = flushed(lambda: F.scaled_dot_product_attention(qt, kt, vt, attn_mask=mask, **gqa))
            pick = fd_module.split_for(q1, k) if hasattr(fd_module, "split_for") else 1
            print(f"timing: flash_decode at {label} decode (B{B} S{S} nv{nv} H{H}/{KVH} Dh{Dh} bf16): bound "
                  f"{nbytes / 3.35e12 * 1e3:.4f} ms (bytes), SDPA {sdpa:.4f} ms; default n_split {pick}")
            print(f"  host time a call: {host_us(lambda: flash_decode(q1, k, v, kpos, qpos, nval)):.2f} us "
                  f"launched back to back (the wrapper, or the device where it is slower); split_for alone "
                  f"{host_us(lambda: fd_module.split_for(q1, k), sync=False) if pick_fn else float('nan'):.3f} us")
            if args.sweep:  # what reading the same K and V once takes, as two PyTorch reductions
                fn = lambda: (k.sum(), v.sum())  # noqa: E731
                print(f"  k.sum() + v.sum(): {flushed(fn):.4f} ms, device (profiler) "
                      f"{device_ms(fn, 'reduce'):.4f} ms a kernel")
            for n_split in splits:
                fn = lambda: decode(q1, k, v, kpos, qpos, nval, 0, n_split)  # noqa: E731
                print(f"  n_split {n_split or 'default'}: {flushed(fn):.4f} ms, device (profiler) "
                      f"{device_ms(fn, 'flash_decode'):.4f} ms")
        if "mamba_scan" in kernels:
            B, L, Di, N = 4, 512, 8192, 16
            xc = rand(B, L, Di, dtype=bf)
            dt = rand(B, L, Di, dtype=torch.float32).abs() * 0.1
            Bm, Cm = rand(B, L, N, dtype=torch.float32), rand(B, L, N, dtype=torch.float32)
            a = -rand(Di, N, dtype=torch.float32).abs() - 0.1
            h0 = rand(B, Di, N, dtype=torch.float32)
            nbytes = B * L * Di * (2 + 4 + 4) + 2 * B * L * N * 4 + Di * N * 4 + 2 * B * Di * N * 4
            clock = torch.cuda.get_device_properties(0).clock_rate if hasattr(
                torch.cuda.get_device_properties(0), "clock_rate") else None
            sms = torch.cuda.get_device_properties(0).multi_processor_count
            print(f"timing: mamba_scan at jamba-v0.1-52b prefill (B{B} L{L} Di{Di} N{N}, bf16 xc, h0): bytes bound "
                  f"{nbytes / 3.35e12 * 1e3:.4f} ms; exponentials {B * L * Di * N} over {sms} SMs x 16 a clock "
                  f"(clock_rate {clock} kHz)")
            fn = lambda: mamba_scan(xc, dt, Bm, Cm, a, h0)  # noqa: E731
            print(f"  {flushed(fn):.4f} ms, device (profiler) {device_ms(fn, 'mamba_scan'):.4f} ms")
        if "hash_tree" in kernels:
            def words(nbytes):
                return torch.randint(-2**31, 2**31, (nbytes // 4,), dtype=torch.int32, generator=gen, device=dev)

            for label, nbytes in (("4.5 MiB", WAVE["nbytes"]), ("1 GiB", WAVE["big_nbytes"])):
                w = words(nbytes)
                fn = lambda: ht_module.hash_tree_state(w)  # noqa: E731
                print(f"timing: hash_tree at {label} (one payload a call): bound {(nbytes + 12) / 3.35e12 * 1e3:.4f} ms "
                      f"(bytes); {flushed(fn):.4f} ms, device (profiler) {device_ms(fn, 'hash_tree'):.4f} ms; host "
                      f"{host_us(fn, reps=200):.2f} us a call launched back to back")
                del w
            wave = [words(WAVE["nbytes"]).view(torch.float32) for _ in range(WAVE["n"])]
            bound = WAVE["n"] * (WAVE["nbytes"] + 12) / 3.35e12 * 1e3
            if hasattr(ht_module, "hash_tree_states"):
                u8s = [x.view(torch.uint8) for x in wave]
                fn = lambda: ht_module.hash_tree_states(u8s)  # noqa: E731
                print(f"timing: hash_tree on the wave ({WAVE['n']} x 4.5 MiB, one call): bound {bound:.4f} ms "
                      f"(bytes); {flushed(fn):.4f} ms, device (profiler) {device_ms(fn, 'hash_tree'):.4f} ms; host "
                      f"{host_us(fn, reps=50):.2f} us a call launched back to back")
            counter = getattr(ht_module, "hash_tree_states", ht_module.hash_tree_state)
            n0 = counter.launches
            hashing.content_hash_batch(wave)
            n_launch = counter.launches - n0
            med = host_us(lambda: hashing.content_hash_batch(wave), reps=1)
            print(f"timing: content_hash_batch of the wave: {n_launch} hash_tree launches; host clock (median of 5, "
                  f"synchronised) {med / 1e3:.3f} ms ({WAVE['n'] * WAVE['nbytes'] / med / 1e3:.1f} GB/s hashed)")
            # a push hashes one payload a call: that call's host time, and its parts
            x, state = wave[0], torch.zeros(3, dtype=torch.int32, device=dev)
            parts = {
                "content_hash_batch([x])": lambda: hashing.content_hash_batch([x]),
                "_tensor_bytes(x)": lambda: hashing._tensor_bytes(x),
                "hash_tree_state(x's words)": lambda: ht_module.hash_tree_state(x.view(torch.int32)),
                "a (3,) state's .cpu()": lambda: state.cpu(),
                "_tree_finish (sha256)": lambda: hashing._tree_finish((1, 2, 3), WAVE["nbytes"], "(1179648,)",
                                                                     "float32"),
            }
            print("timing: host us a call, one 4.5 MiB payload, launched back to back: "
                  + "; ".join(f"{k} {host_us(fn, reps=200):.2f}" for k, fn in parts.items()))
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())

#!/usr/bin/env python3
"""Time the port's ``flash_decode`` with and without its log-sum-exp, on one
card, L2 flushed before each launch by writing 256 MiB, as phase 4 of
``chip_smoke.py`` times it (CUDA events, median of 30):

  python3 tools/torch_decode_lse_probe.py [--src DIR] [--rounds N]

phase4: without lse at phase 4's decode shapes (stablelm-1.6b, jamba-v0.1-52b,
  mixtral-8x7b's wrapped ring, internvl2-1b, seamless-m4t-medium's
  cross-attention and decoder self-attention), N rounds; ``--src`` imports
  ``repro_torch`` from another checkout's ``src``, so run it once a tree in
  turns to compare two trees on one card.
slices: phase 6d's local decode slices ((i)-(iv): the slice that holds the
  newest slot of a mid-generation step), without lse, with lse and an f32
  output, and with lse in q's dtype, in turns (the order reversed every other
  round); skipped for a tree whose ``flash_decode`` takes no ``return_lse``.
Prints one JSON object: the card, the tree, and each shape's times (ms).
"""

from __future__ import annotations

import argparse
import inspect
import json
import statistics
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]

# (label, B, S, H, KVH, Dh, window, n_valid, q_pos, slots): chip_smoke.py's
# FOUR_DECODE_ROWS and phase 4's stablelm and jamba decode shapes
PHASE4 = [
    ("stablelm decode", 4, 552, 32, 32, 64, 0, 528, 527, "cache"),
    ("jamba decode", 4, 552, 32, 8, 128, 0, 528, 527, "cache"),
    ("mixtral decode over the wrapped ring", 4, 4096, 32, 8, 128, 4096, 4096, 4100, "ring:5"),
    ("internvl2 decode", 4, 1576, 14, 2, 64, 0, 1552, 1551, "cache"),
    ("seamless cross-attention decode", 4, 4096, 16, 16, 64, 0, 4096, 0, "memory"),
    ("seamless decoder self-attention decode", 4, 552, 16, 16, 64, 0, 528, 527, "cache"),
]
# (label, B, slots of the slice, H, KVH, Dh, first slot, slots written): chip_smoke.py's SERVE_MESH runs
SLICES = [
    ("(i) stablelm on (1, 2)", 4, 552, 16, 16, 64, 0, 528),
    ("(ii) stablelm batch 1 on (2, 1)", 1, 2048, 32, 32, 64, 2048, 4072),
    ("(iii) jamba on (1, 2)", 4, 552, 16, 4, 128, 0, 528),
    ("(iv) internvl2 on (1, 4)", 4, 394, 14, 2, 64, 1182, 1552),
]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--src", default=str(ROOT / "src"))
    ap.add_argument("--rounds", type=int, default=3)
    args = ap.parse_args()
    sys.path.insert(0, args.src)
    import torch

    from repro_torch.kernels.flash_decode import flash_decode

    if not torch.cuda.is_available():
        print("torch_decode_lse_probe: no CUDA device", file=sys.stderr)
        return 2
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip()
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    flush = torch.empty(256 * 2**20, dtype=torch.uint8, device=dev)
    i32 = dict(dtype=torch.int32, device=dev)

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

    def rand(*shape):
        return torch.randn(shape, generator=gen, device=dev).bfloat16()

    out = {"card": card, "src": args.src, "phase4": {}, "slices": {}}
    for label, B, S, H, KVH, Dh, window, nv, qp, slots in PHASE4:
        q, k, v = rand(B, 1, H, Dh), rand(B, S, KVH, Dh), rand(B, S, KVH, Dh)
        kpos = torch.arange(S, **i32)
        if slots.startswith("ring:"):
            kpos = torch.roll(kpos + (qp - S + 1), int(slots[5:]))
        elif slots == "memory":
            kpos = torch.zeros(S, **i32)
        kpos = kpos.expand(B, S).contiguous()
        qpos, nval = torch.full((B,), qp, **i32), torch.full((B,), nv, **i32)
        out["phase4"][label] = [round(time_ms(lambda: flash_decode(q, k, v, kpos, qpos, nval, window=window)), 5)
                                for _ in range(args.rounds)]
    if "return_lse" in inspect.signature(flash_decode).parameters:
        for label, B, S, H, KVH, Dh, base, written in SLICES:
            q, k, v = rand(B, 1, H, Dh), rand(B, S, KVH, Dh), rand(B, S, KVH, Dh)
            kpos = (base + torch.arange(S, **i32)).expand(B, S).contiguous()
            qpos, nval = torch.full((B,), written - 1, **i32), torch.full((B,), min(written - base, S), **i32)
            calls = {"no_lse": lambda: flash_decode(q, k, v, kpos, qpos, nval),
                     "lse_f32": lambda: flash_decode(q, k, v, kpos, qpos, nval, return_lse=True,
                                                     out_dtype=torch.float32),
                     "lse": lambda: flash_decode(q, k, v, kpos, qpos, nval, return_lse=True)}
            res = {name: [] for name in calls}
            for r in range(args.rounds + 1):
                for name in (list(calls) if r % 2 == 0 else list(reversed(list(calls)))):
                    res[name].append(round(time_ms(calls[name]), 5))
            out["slices"][label] = res
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())

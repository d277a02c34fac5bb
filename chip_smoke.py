#!/usr/bin/env python3
"""Drive the PyTorch port (``src/repro_torch``) on one CUDA card.

  python3 chip_smoke.py
  python3 chip_smoke.py --mesh-only   # phases 1 and 6 alone (no summary line)
  python3 chip_smoke.py --examples-only   # phases 1 and 9 alone (no summary line)

Phases, in order; any failure exits non-zero (a disagreement between the
kernels' and the plain versions' logits is recorded and the later phases run
on, so that their numbers are still printed):
  1. name the card, build the six CUDA sources (eight kernels) from
     ``src/repro_torch/kernels/csrc`` (one nvcc each, in parallel), and count
     the tensor-core instructions in the built ``moe_gmm``,
     ``flash_attention`` and ``flash_attention_bwd`` libraries
     (``cuobjdump -sass``: HGMMA, HMMA);
  2. hold each kernel against its plain PyTorch version on the card, over the
     shape sweeps of the reference kernel tests, the ragged edges of the
     tensor-core tiles and the full-width serve shapes (attention f32 tol
     2e-5, bf16 2e-2; moe_gmm the same; mamba_scan 1e-4), including empty
     capacity bins; ``flash_attention`` at each (Dk, Dv) pair (MLA's (96,
     64) too) and at phase 3d's prefills (non-causal 4096 x 4096, gq 7,
     window 4096); ``flash_decode`` over a wrapped ring of 4096 slots and
     over an encoder memory; ``moe_gmm`` at mixtral's bins; ``hash_tree`` bit-equal to its
     plain version and to the host (numpy) state and digest of the same bytes,
     over random words, ragged payloads (tails of 1-3 bytes, partial last
     blocks, payloads shorter than a block, an empty one, odd-offset slices;
     many in one launch, twice, on a side stream, and 300 in 3 launches),
     bf16/bool/int32, a non-contiguous view and a one-byte flip; the
     forward's log-sum-exp on both routes and the backward
     ``flash_attention_bwd`` (dQ, dK, dV) against ``reference_attention_bwd``
     at stablelm-1.6b's training shape, GQA (gq 4, Dh 128), a window and
     ragged L, and phase 5h's: MLA's (Dk 96, Dv 64) at minicpm3-4b's heads,
     non-causal with Lq != Lk (seamless's cross-attention, 1024 x 4096),
     its encoder's 4096 x 4096, internvl2's gq 7, and their ragged edges, in
     f32 and bf16 (``BWD_TOL``), bf16 at Dh 64 and 128 on both its wgmma
     and mma routes, and bit-equal when run twice at the training shapes
     (``BWD_BIT_EQUAL``); K7, the backward kernels ``moe_gmm_bwd`` (against
     ``reference_gmm_bwd``, at the moe_gmm cases above, on bins partly
     filled and empty, and at jamba's and mixtral's training bins, E 16 C 640
     and E 8 C 1280; bf16 on wgmma and on the mma baseline) and
     ``mamba_scan_bwd`` (against ``reference_selective_scan_bwd``, at the
     mamba_scan cases with h0 and dh_final, and at jamba's training scan (4,
     1024, 8192, 16) with and without them; the chunked design and the
     per_step baseline), in f32 and bf16 (``BWD_TOL``), each chosen design
     bit-equal when run twice at the training shapes, the scan's backward in
     3 segments (offset limit patched small) bit-equal to one;
  3. serve stablelm-1.6b at full width (24 layers, bf16, batch 4, prompt 512,
     32 generated tokens) through ``repro_torch.launch.serve.main``, count the
     kernel launches of that run (every bf16 launch on its tensor-core
     route), then run prefill and the first decode steps again through the
     plain versions on the card and compare logits and greedy tokens; steady
     and profiled serve times;
  3b. serve jamba-v0.1-52b at full width, cut to one layout period (8 of its
     32 layers: the full depth does not fit the card's 80 GB), bf16, batch 4,
     prompt 512, 32 tokens, through ``repro_torch.launch.serve.run``: exact
     launch counts of all four kernels and of their routes, kernels vs plain
     versions in bf16 and f32 with a routing diagnostic (printed: near-tied
     top-k routings flip between the two runs, in bf16 with exact and inexact
     kernels alike, in f32 on some seeds), and in each dtype once more with
     the plain run dispatched through the kernels run's routing, which gates
     (``forced_routing_gate``: logits, greedy tokens, and the router
     probabilities of the two runs, whose hidden states differ by arithmetic
     alone); steady and profiled serve times;
  3c. the Koalja circuit on the card: a ``repro_torch.workspace.Workspace``
     (flat, inline executor, default store) with one task ``normalize``;
     push B14's wave of 64 card-resident f32 tensors of 4.5 MiB, the same
     wave again (64 memo hits), then one 1 GiB tensor: every tree-tier digest
     runs ``hash_tree`` (exact launch count), every chash equals the host
     digest of the ``.cpu()`` copy; ``content_hash_batch`` of the whole wave
     is exactly 1 ``hash_tree`` launch, its digests equal the host's, and,
     profiled, it copies at most 64 x 12 B to the host in one copy; where a
     first pass spends its host time, by layer (a ``torch.profiler`` CPU
     trace);
  3e. the durable, zoned circuit on card payloads: B10's IoT fan-in (3 zones
     x 8 sensors x 3 rounds) with readings of 4.5 MiB on the card, under
     ``pin``, ``data_gravity`` and ``data_gravity`` on
     ``ZonedExecutor(inner=ConcurrentExecutor(4))``, each journaled: equal
     merge order and provenance events, an equal ledger for zoned and inline,
     ``bytes_moved_crosszone`` equal to the bytes the placement implies, and
     ``hash_tree`` launches equal to the tree-tier digests; phase 3c's wave
     and its replay journaled (pushes/s beside 3c's), ``Workspace.from_journal``
     equal to the live workspace (lineage, visitor logs, design map, ledger),
     again after ``compact_journal`` and after the last line is cut in half;
     a ghost run of the wave's shape (routes as the real run's, 0 puts, 0
     launches, no new device memory); a ``ProcessExecutor`` after CUDA is
     live (host plans in workers, bit-equal; card plans in the parent) and a
     ``ZonedProcessExecutor`` whose merged journal segments replay to the
     inline run;
  3f. the multi-tenant hub (``repro_torch.tenancy``) on card payloads: B15
     uncut (64 tenants push a working set of 8, rotated, through src ->
     (left, right) -> join; payloads of 4.5 MiB on the card, drawn from a
     seed; journaled, inline, no topology): 2016 of 2048 firings avoided
     (64.0x), ``hash_tree`` launches equal to the tree-tier digests (4 a
     push), pushes/s, push p50/p99, journal records/s; a replaying tenant's
     device-to-host copies are digest states of <= 12 B, and another's idle
     share; four tenants fingerprint as private runs of their scripts and as
     the hub's rehydration; a joule quota on a zoned tenant admits exactly
     ``JOULE_PUSHES`` pushes, the refused one leaves the ledger as it was, and
     the warning and the refusal are journaled once each; a tenant under
     zone runners keeps its card plans in the parent and replays, with its
     runners' segments, to the inline run;
  3d. serve mixtral-8x7b (8 of its 32 layers: all 32 hold ~93 GB of bf16
     weights; prompt 4080, so that its cache is a ring of 4096 slots that
     decode wraps), minicpm3-4b (MLA), internvl2-1b (a vision prefix of
     1024 stub embeddings) and seamless-m4t-medium (an encoder over 4096
     stub frames) at full width, bf16, batch 4, prompt 512 (but mixtral's),
     32 tokens, through ``repro_torch.launch.serve``: exact launch counts,
     every bf16 launch on its tensor-core route, no plain version called, the
     calls of each kernel by input shape; kernels vs plain versions in bf16
     and f32 as phase 3b (mixtral gated on the kernels' routing; the f32
     comparison of mixtral peaks at ~63 GiB); steady and profiled serve times;
  4. time each kernel at the shapes of its main path (CUDA events, L2
     flushed before each launch by writing 256 MiB) beside its plain
     version, one PyTorch library call that computes the same function (three
     for moe_gmm; none exists for mamba_scan or hash_tree), and its bound
     (hash_tree at 4.5 MiB and 1 GiB, and the wave of 64 in one launch);
     each bf16 route's share of outputs equal to the plain version's, and
     for moe_gmm also its FMA route (which serves bf16 shapes without
     16-byte rows) on the same inputs; flash_decode's n_split at each serve
     shape; mamba_scan's bound counts its exponentials, shared between the
     special-function units and the FMA pipes, beside its bytes, and the
     scan cut into 3 segments (offset limit patched small) is bit-equal to
     one launch. moe_gmm's bins are filled as phase
     3b's served run filled them (the slots past each bin's tokens are
     zeros, which slows the wgmma route); its time on fully random bins is
     printed beside. Then each kernel at phase 3d's shapes, its launches
     the calls of that shape in phase 3d's served run, beside its bound
     (operations 2 B H pairs (Dk + Dv) for attention), its plain version and
     SDPA (``enable_gqa``; a boolean mask where a window bites) or three
     ``torch.bmm``;
  5. train stablelm-1.6b at full width (24 layers, bf16, batch 8, seq 2048,
     remat "block") through ``repro_torch.launch.train.main``: exact launch
     counts a step (the forward twice a layer, once more under remat, and
     the backward once), every launch on its tensor-core route (the
     backward's on wgmma), no plain
     version called (a spy on ``ref``), finite loss, grad norm and clip
     scale, the final checkpoint's copy and write times; then
     ``make_train_step`` on one repeated batch, whose loss must fall at every
     step (step time, tokens/s, MFU against 6 N tokens, peak memory, a
     profiled step, the optimizer alone); one step's gradient, every leaf, against the same step
     through the plain versions (batch 2, relative L2 error within
     ``GRAD_REL_TOL``); the ``--fail-at-step`` drill on a reduced bf16 model,
     whose restored checkpoint must equal the saved state bit for bit and
     whose run goes on to ``--steps``; 5f, the evaluation loop on 5b's
     trained state (a frozen 4 x 2048 batch, the forward loss under
     ``no_grad``): publish and report is one eval of exactly 24
     ``flash_attention`` launches, an unchanged republish a memo hit with no
     launch, one more train step a recompute (the checkpoint's pickle-tier
     digest, equal for the dict copied to the host and cloned on the card;
     the eval's and the hit's seconds); and the forward (o and lse checked
     against the plain forward's) and K1 timed at the
     training shape (K1 also at qwen2.5-32b's heads, Dh 128) beside their
     bounds, their plain versions and SDPA, K1 on wgmma and on mma in turns,
     with each launch's device time from the profiler (dq and dkdv; on mma
     also dot_do_o), null where the profiler kept no record of a launch;
  5g. train jamba-v0.1-52b at full width, cut to its first 2 of 32 layers
     (mamba + dense FFN, mamba + MoE), bf16, batch 4, seq 1024, remat
     "block", 3 steps through ``repro_torch.launch.train.run`` (its final
     checkpoint counted, not written): exact launches a step (per mamba layer
     mamba_scan 2 and mamba_scan_bwd 1, per MoE layer moe_gmm 2 and
     moe_gmm_bwd 1, every moe_gmm and moe_gmm_bwd launch on wgmma, every
     mamba_scan_bwd call on the chunked design), no plain version called,
     finite losses; ``make_train_step`` on a
     repeated batch, whose loss must fall at every step (step time,
     tokens/s, peak memory, each kernel's share of a profiled step); one
     step's gradient of every leaf against the plain versions run on the
     kernels run's routing (``GRAD_REL_TOL``), for jamba and for mixtral-8x7b
     cut to 1 layer (attention with window 4096 through K1, MoE at E 8, C
     1280); then K7a and K7b timed at jamba's training shapes as phase 4
     times the kernels, each beside its first design in turns (K7a wgmma
     and mma, K7b chunked and per_step: new, old, old, new; the new one must
     be faster), their bounds, their plain versions, for K7a the autograd
     backward of three ``torch.bmm`` and SiLU, and each launch's device time
     from the profiler (K7a's passes, K7b's ckpt, rev, reduce_bc, reduce_a);
  5h. train minicpm3-4b (62 layers, MLA at Dk 96 / Dv 64),
     seamless-m4t-medium (12 encoder layers over 4096 stub frames a sample,
     12 decoder layers with cross-attention) and internvl2-1b (24 layers, a
     prefix of 1024 stub embeddings, gq 7) at full width, uncut, bf16, batch
     4, seq 1024, remat "block", 3 steps each through
     ``repro_torch.launch.train.run`` (final checkpoint counted, not
     written): exact launches a step (flash_attention twice and
     flash_attention_bwd once an attention call: decoder, cross-attention,
     encoder), every forward on mma and every backward on wgmma, the
     backward's calls by input shapes, no plain version called, finite
     losses; ``make_train_step`` on a repeated batch, whose loss must fall at
     every step (step time, tokens/s, MFU at 6 N tokens with attention's own
     FLOPs beside it, peak memory, each kernel's share of a profiled step);
     one step's gradient of every leaf against the plain versions at full
     width, batch 2 and 2 layers (seamless 1 + 1; ``GRAD_REL_TOL``); and at
     each training shape the forward's o and lse checked against the plain
     forward, then K1 checked and timed as phase 5e times it, beside its
     bound, its plain version and SDPA's backward. Phases 5b, 5g and 5h share
     the repeated batch (``repeated_batch``), 5c, 5g and 5h the gradient
     gate (``gradient_gate``), 5g and 5h the checked ``launch.train.run``
     (``checked_train_run``), 5e and 5h K1's row (``k1_row``).
  8. the roofline and the multi-pod dry-run: (a) ``python -m
     repro_torch.launch.dryrun`` for DRYRUN_CELLS, each in a subprocess of
     its own (all at once: the fake process-group backend must not share a
     process with another group), every record checked as the reference's
     integration test checks its own; (b) the steps phases 3, 5 and 5g timed
     on this card, priced with ``roofline.H100_SXM`` at one device (counted
     on meta tensors, kernel regions credited at their kernels' IO): fails
     where a measured time is below its bound, the larger of its compute,
     memory and collective terms (counted work the card beat: an
     over-count);
  9. the port's four examples (``examples/torch_*.py``) on the card, in this
     process through their ``main(argv)``: each one's wall time and launches
     by kernel and route; twin_pipelines must launch flash_attention, its
     backward and flash_decode, train_lm (128M params, f32) flash_attention
     and its backward, every attention launch on its f32 ``fma`` route, and
     no plain version may run; then each of those kernels on every input
     the examples gave it (their first call of each shape and options)
     against its plain version, timed beside its bound and SDPA
     (``examples_kernel_rows``). (The walkthroughs stay off the card: they
     never touch the device, and the runtime one forks workers.)
The last line is ``{"ok": true, "device": {...}}``. The compiler's reports
(registers, spills) go to ``build/repro_torch_kernels/nvcc_report.txt``.
"""

from __future__ import annotations

import dataclasses
import json
import os
import re
import shutil
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

# the tensor-core instructions each library's routes must contain (phase 1)
TENSOR_CORE_SASS = {"moe_gmm": ("HGMMA", "HMMA"), "flash_attention": ("HMMA",),
                    "flash_attention_bwd": ("HGMMA", "HMMA")}
# H100 SXM published peaks (dense): memory rate, and operations per type
PEAK_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}
SFU_PER_CLOCK = 16  # exponentials an sm_90 SM retires a clock (special-function units)
# FMA-pipe instructions of an exp2 computed without the SFU: round (an FFMA
# by a magic number), 2 FADD for the fraction, 3 FFMA for a cubic; the
# exponent goes in by an integer shift and add, on the integer pipe
EXP_FMA_INSTRS = 6
SCAN_FMA_INSTRS = 4  # of mamba_scan's (b, t, d, n) step beside its exponential
TOL = {"float32": (2e-5, 2e-5), "bfloat16": (2e-2, 2e-2)}  # (rtol, atol)
# the scan's output is f32 in both dtypes (bf16 only for its xc input):
# exp and FMA rounding over L steps, as the reference kernel tests
SCAN_TOL = (1e-4, 1e-4)

ATTN_CASES = [  # (B, Lq, Lk, H, KVH, Dk, Dv, causal, window): tests/test_kernels.py sweep
    (2, 128, 128, 4, 2, 64, 64, True, 0),
    (1, 256, 256, 8, 8, 32, 32, True, 0),
    (2, 200, 200, 4, 1, 64, 64, True, 0),  # ragged lengths
    (1, 256, 256, 4, 2, 64, 64, True, 96),  # sliding window
    (1, 64, 256, 4, 2, 64, 64, False, 0),  # cross attention
    (1, 128, 128, 6, 2, 16, 16, True, 0),  # small head dim
    (2, 96, 112, 40, 8, 128, 128, True, 0),  # qwen2.5 / internlm2 head dim, gq 5
    (4, 512, 552, 32, 32, 64, 64, True, 0),  # stablelm prefill over the serve cache
    (4, 512, 552, 32, 8, 128, 128, True, 0),  # jamba prefill over the serve cache
    # the ragged edges of the 64-key tiles of the mma route
    (2, 200, 231, 40, 8, 128, 128, True, 64),  # Lq, Lk not multiples of 64, gq 5, window
    (2, 96, 112, 16, 2, 16, 16, True, 0),  # head dim 16, gq 8
    (1, 256, 256, 4, 2, 64, 64, True, 16),  # window < tile: rows fully masked inside a live tile
    # phase 3d's prefills, and MLA's head dims (Dk 96 in padded rows, Dv 64)
    (4, 512, 552, 40, 40, 96, 64, True, 0),  # minicpm3 prefill over its latent cache
    (2, 200, 231, 8, 8, 96, 64, True, 0),  # (96, 64), Lq and Lk not multiples of 64
    (2, 77, 150, 8, 4, 96, 64, False, 0),  # (96, 64), non-causal, gq 2, ragged
    (4, 1536, 1576, 14, 2, 64, 64, True, 0),  # internvl2 prefill: prefix 1024 + prompt 512, gq 7
    (4, 4096, 4096, 16, 16, 64, 64, False, 0),  # seamless encoder
    (4, 512, 4096, 16, 16, 64, 64, False, 0),  # seamless cross-attention
    (4, 4080, 4080, 32, 8, 128, 128, True, 4096),  # mixtral prefill, window 4096
]
DECODE_CASES = [  # (B, S, H, KVH, Dh, window, n_valid, q_pos, slots): tests/test_flash_decode.py
    # slots: "cache" (slot i holds position i), "ring:r" (absolute time q_pos:
    # slot i holds position q_pos - S + 1 + i, rotated by r), "memory"
    # (every slot at position 0: cross-attention over an encoder memory)
    (2, 256, 8, 2, 64, 0, 200, 199, "cache"),
    (1, 300, 4, 4, 32, 0, 300, 299, "cache"),  # ragged S, MHA
    (2, 128, 4, 1, 64, 48, 100, 99, "cache"),  # SWA window
    (1, 64, 8, 2, 64, 0, 10, 9, "cache"),  # mostly-empty cache
    (1, 64, 4, 2, 32, 64, 64, 100, "ring:13"),  # SWA ring: positions rotated by 13
    (2, 200, 48, 8, 128, 0, 150, 149, "cache"),  # internlm2 head dim, gq 6
    (2, 64, 16, 2, 16, 0, 40, 39, "cache"),  # reduced-config head dim, gq 8
    (4, 552, 32, 32, 64, 0, 528, 527, "cache"),  # stablelm decode at the serve cache
    (4, 552, 32, 8, 128, 0, 528, 527, "cache"),  # jamba decode at the serve cache
    # the edges of the cluster split (n_split 8 at B * KVH 32, 4 at 128)
    (2, 256, 8, 2, 64, 0, 1, 0, "cache"),  # one written slot
    (4, 552, 32, 8, 128, 0, 5, 4, "cache"),  # n_valid < n_split: empty chunks
    (4, 552, 32, 32, 64, 0, 40, 39, "cache"),  # n_valid < one chunk of the cache
    (4, 551, 32, 8, 128, 0, 551, 550, "cache"),  # S not a multiple of n_split
    (8, 300, 40, 40, 64, 0, 290, 289, "cache"),  # B * KVH 320 >= 2 x 132 SMs: n_split 1
    (4, 552, 48, 8, 128, 64, 528, 527, "cache"),  # gq 6 at Dh 128, a window masking whole chunks
    # phase 3d's decodes
    (4, 4096, 32, 8, 128, 4096, 4096, 4100, "ring:5"),  # mixtral's ring, wrapped: position 4100 in slot 4
    (4, 4096, 16, 16, 64, 0, 4096, 0, "memory"),  # seamless cross-attention decode
    (4, 1576, 14, 2, 64, 0, 1560, 1559, "cache"),  # internvl2 decode, gq 7
]
GMM_CASES = [  # (E, C, D, F): tests/test_kernels.py::test_moe_gmm_sweep (then jamba's and mixtral's, below)
    (4, 32, 64, 96),
    (2, 100, 48, 80),  # ragged capacity
    (8, 16, 32, 32),
    (1, 64, 128, 64),
    # the edges of the tensor-core tiles: bins of 1, 8 (swap_ab) and 9, 65,
    # 129 rows (wgmma's 128-row tiles), D and F not multiples of 64
    (3, 1, 200, 328),
    (3, 8, 200, 328),
    (3, 9, 200, 328),
    (3, 65, 200, 328),
    (3, 129, 200, 328),
    # D not a multiple of 8: no TMA, no 16-byte copies, the FMA route in bf16 too
    (2, 9, 44, 36),
    (2, 5, 44, 36),
]
SCAN_CASES = [  # (B, L, Di, N, h0): tests/test_kernels.py::test_mamba_scan_sweep (then jamba's)
    (2, 64, 32, 8, False),
    (1, 100, 48, 16, True),  # ragged L + seeded state
    (2, 256, 64, 16, False),
    (1, 32, 24, 4, True),
    # the edges of the one-thread-per-channel kernel (128 channels a block,
    # B and C staged 32 steps at a time, dt and xc loaded 16 steps ahead)
    (2, 1, 200, 16, True),  # L = 1
    (2, 77, 136, 16, False),  # L not a multiple of 32 or 16, Di not of 128
] + [(2, 45, 130, n, h0) for n in (4, 8, 16, 32) for h0 in (False, True)]  # every N, with and without h0
BWD_CASES = [  # (B, Lq, Lk, H, KVH, Dk, Dv, causal, window): the backward's checks
    (8, 2048, 2048, 32, 32, 64, 64, True, 0),  # stablelm-1.6b's training shape
    (2, 512, 512, 32, 8, 128, 128, True, 0),  # GQA: gq 4, Dh 128
    (2, 300, 300, 16, 4, 64, 64, True, 128),  # a window, L not a multiple of the tiles
    (3, 197, 197, 8, 2, 32, 32, True, 0),  # ragged L
    (1, 77, 77, 4, 4, 16, 16, True, 5),  # Dh 16, a window shorter than a tile
    # phase 5h's attention: MLA's (Dk 96, Dv 64) at minicpm3-4b's 40 heads;
    # seamless-m4t-medium's cross-attention (1024 decoder tokens over 4096
    # memory slots) and encoder (4096 x 4096), both non-causal; internvl2-1b's
    # gq 7 over prefix + tokens; and their ragged edges (keys past Lk in a
    # tile with no causal edge, queries past Lq, dq's padding row at gq 7)
    (2, 1024, 1024, 40, 40, 96, 64, True, 0),
    (2, 200, 200, 8, 8, 96, 64, True, 0),
    (2, 77, 150, 8, 4, 96, 64, False, 0),
    (2, 1024, 4096, 16, 16, 64, 64, False, 0),
    (2, 77, 150, 8, 4, 64, 64, False, 0),
    (2, 4096, 4096, 16, 16, 64, 64, False, 0),
    (2, 2048, 2048, 14, 2, 64, 64, True, 0),
    (2, 131, 131, 14, 2, 64, 64, True, 0),
]
# dQ, dK, dV against the plain backward: sums over up to L products in
# another order (f32), and one rounding of each output to bf16 on top of
# bf16 inputs (bf16). (rtol, atol as a share of the tensor's largest |value|)
BWD_TOL = {"float32": (1e-4, 1e-4), "bfloat16": (2e-2, 2e-2)}
# the BWD_CASES (B, Lq, Lk, H, KVH, Dk) whose backward, on its own route, must
# be bit-equal when run twice: the training shapes (stablelm's, minicpm3's
# MLA, seamless's cross-attention) and GQA
BWD_BIT_EQUAL = {(8, 2048, 2048, 32, 32, 64), (2, 512, 512, 32, 8, 128), (2, 1024, 1024, 40, 40, 96),
                 (2, 1024, 4096, 16, 16, 64)}
# phase 5e's Dh 128 row: qwen2.5-32b's heads (40 query, 8 KV) over one
# causal sequence of 4096 (B, L, H, KVH, Dh)
K1_QWEN = (1, 4096, 40, 8, 128)
TRAIN = dict(arch="stablelm-1.6b", batch=8, seq=2048, steps=3, seed=0, lr=3e-4)
TRAIN_REPEAT = 4  # make_train_step steps on one repeated batch
# their constant lr: at launch.train's default 3e-4, Adam's first steps (each weight
# moves by ~lr, 1.4% of a d^-1/2 = 0.022 weight) overshoot on this random
# model (losses 11.82, 12.92, 18.89, 10.46, ...); at 3e-5 the loss falls at
# every step (phase 5b at seed 0 on an H100, at each lr)
REPEAT_LR = 3e-5
GRAD_BATCH = 2  # rows of the gradient comparison with the plain versions
# one step's gradient of each leaf, kernels vs plain versions, as a relative
# L2 error. Both runs are bf16 and round at different places (the forward
# kernel rounds P to bf16 before P.V, the plain version keeps f32): one bf16
# rounding is 2^-9 relative, and ~20 rounding steps a layer (forward and
# backward) over 24 layers add up like a random walk, sqrt(480) x 2^-9 ~ 0.04.
# Phases 5g and 5h gate at 1 or 2 layers (seamless: 1 decoder + 1 encoder
# layer, ~40 steps on the encoder's path): a shorter walk, sqrt(40) x 2^-9
# ~ 0.012, under the same bound.
GRAD_REL_TOL = 2**-4
DRILL = ["--arch", "stablelm-1.6b", "--reduced", "--dtype", "bfloat16", "--steps", "6", "--batch", "4",
         "--seq", "64", "--ckpt-every", "2", "--fail-at-step", "3", "--seed", "0"]
# B14's data-plane wave (benchmarks/bench_koalja.py): 64 arrays of 4.5 MiB
WAVE = dict(n=64, nbytes=(1 << 22) + (1 << 19), big_nbytes=1 << 30, seed=7)
SERVE = dict(arch="stablelm-1.6b", batch=4, prompt_len=512, gen=32, seed=0)
HYBRID = dict(arch="jamba-v0.1-52b", n_layers=8, batch=4, prompt_len=512, gen=32, seed=0)
# phase 3d: the four architectures of the last serving slice, at full width;
# mixtral cut to 8 of 32 layers (all 32 hold ~93 GB of bf16 weights). Its
# prompt of 4080 makes its cache a ring of 4096 slots (max_len 4120 >= the
# window) that decode wraps at its 16th step.
FOUR = [
    dict(arch="mixtral-8x7b", n_layers=8, batch=4, prompt_len=4080, gen=32, seed=0),
    dict(arch="minicpm3-4b", batch=4, prompt_len=512, gen=32, seed=0),
    dict(arch="internvl2-1b", batch=4, prompt_len=512, gen=32, seed=0),
    dict(arch="seamless-m4t-medium", batch=4, prompt_len=512, gen=32, seed=0),
]
# phase 4's rows at phase 3d's shapes: (arch, label, B, Lq, Lk, H, KVH, Dk, Dv,
# causal, window) of flash_attention, (arch, label, B, S, H, KVH, Dh, window,
# n_valid, q_pos, slots) of flash_decode (a mid-generation step)
FOUR_ATTN_ROWS = [
    ("mixtral-8x7b", "prefill into the ring", 4, 4080, 4080, 32, 8, 128, 128, True, 4096),
    ("minicpm3-4b", "prefill over the latent cache", 4, 512, 552, 40, 40, 96, 64, True, 0),
    ("internvl2-1b", "prefill, prefix + prompt", 4, 1536, 1576, 14, 2, 64, 64, True, 0),
    ("seamless-m4t-medium", "encoder", 4, 4096, 4096, 16, 16, 64, 64, False, 0),
    ("seamless-m4t-medium", "cross-attention prefill", 4, 512, 4096, 16, 16, 64, 64, False, 0),
    ("seamless-m4t-medium", "decoder self-attention prefill", 4, 512, 552, 16, 16, 64, 64, True, 0),
]
FOUR_DECODE_ROWS = [
    ("mixtral-8x7b", "decode over the wrapped ring", 4, 4096, 32, 8, 128, 4096, 4096, 4100, "ring:5"),
    ("internvl2-1b", "decode", 4, 1576, 14, 2, 64, 0, 1552, 1551, "cache"),
    ("seamless-m4t-medium", "cross-attention decode", 4, 4096, 16, 16, 64, 0, 4096, 0, "memory"),
    ("seamless-m4t-medium", "decoder self-attention decode", 4, 552, 16, 16, 64, 0, 528, 527, "cache"),
]
N_CHECK = 8  # decode steps compared with the plain versions
N_STEADY = 16  # decode steps timed after warm-up
# kernel vs plain logits after the trunk. bf16: each layer's kernel output
# may differ by an ulp or two, compounded over depth and the vocab head, on
# logits of magnitude ~1-5 (bf16 ulp 2^-7..2^-5 there); in an MoE model those
# differences also break some near-tied top-k routings the other way. f32:
# each kernel output differs at ~1e-6 relative.
LOGIT_TOL = {"bfloat16": 0.25, "float32": 1e-3}
# Phase 3b's router check (MoE): max |diff| of the router probabilities of the
# kernels run and of the plain versions run on the kernels' routing, over every
# (token, expert) of every MoE call, in bf16 and in f32 (where it is loose: the
# f32 logits, within 1e-3, catch what bf16 rounding hides). 2x the largest bf16
# value measured over seeds 0-7 with moe_gmm on its tensor-core and its FMA
# routes, before flash_decode and mamba_scan were redesigned
# (tools/torch_moe_probe.py, NVIDIA H100 80GB HBM3 at 700 W):
# 7.4454e-03 .. 1.1415e-02 (seed 1, tensor cores).
ROUTER_PROB_TOL = 2 * 1.1415e-02


def scan_bound(n_el: int, nbytes: int, n_sms: int, sm_clock_mhz: float):
    """The least time (ms) of a selective scan of ``n_el`` (b, t, d, n)
    elements moving ``nbytes``, and what bounds it ("bytes" or "operations");
    and, as a diagnostic, the time of its exponentials on the special-function
    units alone. An element is SCAN_FMA_INSTRS on the FMA pipes (dt*A,
    dA*h + dt*x*B, y += C*h) and one exponential, which the SFU retires at
    SFU_PER_CLOCK a clock per SM or the FMA pipes in EXP_FMA_INSTRS. The
    least time for the operations shares the exponentials between the two
    units so that both are busy to the end, or is the FMA pipes' own work
    where the SFU takes every exponential in less."""
    fma_rate = PEAK_FLOPS["float32"] / 2  # FMA-pipe instructions a second; an FFMA is 2 operations
    sfu_rate = SFU_PER_CLOCK * n_sms * sm_clock_mhz * 1e6
    t_ops = max(SCAN_FMA_INSTRS * n_el / fma_rate,
                (SCAN_FMA_INSTRS + EXP_FMA_INSTRS) * n_el / (fma_rate + EXP_FMA_INSTRS * sfu_rate)) * 1e3
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations"), n_el / sfu_rate * 1e3


def engine_layers():
    """(layer, owner, attribute) of the circuit engine's entry points that
    phase 3c's host trace times, from the push down to the task's function."""
    from repro_torch.cache.memo import MemoCache
    from repro_torch.core import store as store_mod
    from repro_torch.core import task as task_mod
    from repro_torch.core.provenance import ProvenanceRegistry
    from repro_torch.core.scheduler import Scheduler
    from repro_torch.workspace import Workspace

    return [
        ("workspace, pipeline", Workspace, "push"),
        ("hashing", store_mod, "content_hash_batch"),
        ("hashing", task_mod, "content_hash_batch"),
        ("store", store_mod.ArtifactStore, "put"),
        ("store", store_mod.ArtifactStore, "put_batch"),
        ("store", store_mod.ArtifactStore, "get"),
        ("provenance", ProvenanceRegistry, "register_av"),
        ("provenance", ProvenanceRegistry, "log_visit"),
        ("memo", MemoCache, "lookup"),
        ("memo", MemoCache, "insert"),
        ("scheduler", Scheduler, "drain"),
        ("task engine", task_mod.SmartTask, "_begin_execution"),
        ("task engine", task_mod.SmartTask, "_finish_execution"),
        ("task function", task_mod.SmartTask, "run_user_fn"),
    ]


def host_time_by_layer(run, layers, sync=lambda: None):
    """Run ``run()`` once under a CPU-only ``torch.profiler`` trace, each
    (layer, owner, attribute) of ``layers`` wrapped in a ``record_function``
    range named after its layer. Returns ({layer: exclusive host ms, "other":
    the rest of the wall time}, {layer: {torch operation: its own ms inside
    the layer}}, wall ms); a range's exclusive time is its own less the layer
    ranges nested in it, its torch operations included."""
    from torch.profiler import ProfilerActivity, profile, record_function

    saved = []
    for layer, owner, attr in layers:
        fn = getattr(owner, attr)

        def traced(*args, _fn=fn, _name=f"layer:{layer}", **kwargs):
            with record_function(_name):
                return _fn(*args, **kwargs)

        saved.append((owner, attr, owner.__dict__[attr]))
        setattr(owner, attr, traced)
    try:
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            t0 = time.perf_counter()
            run()
            sync()
            wall_ms = (time.perf_counter() - t0) * 1e3
    finally:
        for owner, attr, fn in reversed(saved):
            setattr(owner, attr, fn)

    by_layer = {layer: 0.0 for layer, _, _ in layers}
    ops = {layer: {} for layer in by_layer}
    for e in prof.events():
        if not e.name.startswith("layer:"):
            continue
        layer, own = e.name[6:], e.cpu_time_total
        stack = list(e.cpu_children)
        while stack:  # down to the layer ranges nested in e
            c = stack.pop()
            if c.name.startswith("layer:"):
                own -= c.cpu_time_total
            else:
                ops[layer][c.name] = ops[layer].get(c.name, 0.0) + c.self_cpu_time_total / 1e3
                stack.extend(c.cpu_children)
        by_layer[layer] += own / 1e3
    by_layer["other"] = wall_ms - sum(by_layer.values())
    return by_layer, ops, wall_ms


def fail(msg: str):
    raise RuntimeError(f"chip_smoke: {msg}")


def device_to_host_copies(fn) -> list:
    """Bytes of each copy from a device to the host that ``fn()`` asks of
    PyTorch, in order, counted at the dispatcher: a ``.cpu()`` / ``.to()``
    whose result lies on the host, a ``copy_`` into a host tensor, or an
    ``.item()``. Unlike torch.profiler's device records, it drops none."""
    import torch
    import torch.utils._pytree as pytree
    from torch.utils._python_dispatch import TorchDispatchMode

    aten = torch.ops.aten
    copies: list = []

    def on_device(t):
        return isinstance(t, torch.Tensor) and t.device.type != "cpu"

    class Count(TorchDispatchMode):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            kwargs = kwargs or {}
            out = func(*args, **kwargs)
            if not any(on_device(t) for t in pytree.tree_leaves((args, kwargs))):
                return out
            if func is aten._local_scalar_dense.default:
                copies.append(args[0].element_size())
            elif func is aten.copy_.default:
                if not on_device(args[0]) and on_device(args[1]):
                    copies.append(args[0].nbytes)
            else:
                copies.extend(t.nbytes for t in pytree.tree_leaves(out)
                              if isinstance(t, torch.Tensor) and not on_device(t))
            return out

    with Count():
        fn()
    return copies


def logit_comparison(kernels, other, logit_tol: float):
    """Logits (B, steps, V) of a kernels run against another run of the same
    tokens. Returns (failures, stats): non-finite logits, a max |logit diff|
    over ``logit_tol``, and greedy tokens that differ beyond a tie within
    error (where they differ, the other run's top logit may beat the kernels'
    token by at most twice that row's logit difference)."""
    import torch

    failures = []
    if not (torch.isfinite(kernels).all() and torch.isfinite(other).all()):
        failures.append("non-finite logits")
    row_diff = (kernels - other).abs().amax(-1)  # (B, steps)
    diff = row_diff.max().item()
    mine = kernels.argmax(-1)
    agree = other.argmax(-1) == mine
    gap = other.amax(-1) - other.gather(-1, mine[..., None])[..., 0]
    near_tie = (~agree) & (gap <= 2 * row_diff)
    if not diff <= logit_tol:
        failures.append(f"max |logit diff| {diff} > {logit_tol}")
    if not bool((agree | near_tie).all()):
        failures.append(f"{int((~(agree | near_tie)).sum())} greedy tokens differ beyond a tie within error")
    return failures, dict(diff=diff, row_diff=row_diff, agree=int(agree.sum()), ties=int(near_tie.sum()),
                          n=agree.numel())


def forced_routing_gate(kernels, forced, probs_kernels, probs_forced, experts_kernels, *,
                        logit_tol: float, prob_tol: float):
    """Phase 3b's gate for an MoE model, on the plain versions run with the
    kernels run's routing (both runs dispatch the same slots, so the hidden
    states that reach each router differ by arithmetic alone).

    kernels, forced: logits (B, steps, V) of the two runs; probs_kernels,
    probs_forced: each MoE call's router probabilities (T, E), in call order;
    experts_kernels: each call's top-k experts (T, K) in the kernels run.
    Returns (failures, stats): the gate holds iff failures is empty. It holds
    the logits as ``logit_comparison`` does, and every router probability
    within ``prob_tol``. ``stats["rerouted"]`` counts the tokens whose top-k
    set the forced run's own router would have chosen differently (printed,
    not gated)."""
    import torch

    failures, stats = logit_comparison(kernels, forced, logit_tol)
    if len(probs_kernels) != len(probs_forced) or len(experts_kernels) != len(probs_kernels):
        failures.append(f"{len(probs_kernels)} / {len(probs_forced)} router calls recorded")
    dprob, rerouted, n_tok = 0.0, 0, 0
    for pk, pf, ek in zip(probs_kernels, probs_forced, experts_kernels):
        if not (torch.isfinite(pk).all() and torch.isfinite(pf).all()):
            failures.append("non-finite router probabilities")
            break
        dprob = max(dprob, (pk - pf).abs().max().item())
        own = torch.sort(pf, dim=-1, descending=True, stable=True)[1][:, : ek.shape[1]]
        rerouted += int((torch.zeros_like(pf, dtype=torch.bool).scatter_(1, own, True)
                         != torch.zeros_like(pf, dtype=torch.bool).scatter_(1, ek, True)).any(-1).sum())
        n_tok += ek.shape[0]
    if not dprob <= prob_tol:
        failures.append(f"max |router prob diff| {dprob} > {prob_tol}")
    return failures, dict(stats, dprob=dprob, rerouted=rerouted, tokens=n_tok)


class PlainSpy:
    """Counts the calls of the plain versions (``reference_attention``,
    ``reference_attention_bwd``, ``reference_decode``, ``reference_gmm``,
    ``reference_gmm_bwd``, ``reference_selective_scan``,
    ``reference_selective_scan_bwd``) made through ``repro_torch.kernels.ref`` or
    the names the kernels' wrapper modules hold: on card tensors the main
    path must make none. (The ``plain`` dict of the comparisons keeps the
    unwrapped functions.)"""

    NAMES = ("reference_attention", "reference_attention_bwd", "reference_decode", "reference_gmm",
             "reference_gmm_bwd", "reference_selective_scan", "reference_selective_scan_bwd")

    def __enter__(self):
        from repro_torch.kernels import flash_attention, flash_decode, mamba_scan, moe_gmm, ref

        self.calls = dict.fromkeys(self.NAMES, 0)
        self.saved = []
        for mod in (ref, flash_attention, flash_decode, moe_gmm, mamba_scan):
            for name in self.NAMES:
                orig = getattr(mod, name, None)
                if orig is None:
                    continue
                self.saved.append((mod, name, orig))

                def spy(*args, _orig=orig, _name=name, **kwargs):
                    self.calls[_name] += 1
                    return _orig(*args, **kwargs)

                setattr(mod, name, spy)
        return self

    def __exit__(self, *exc):
        for mod, name, orig in self.saved:
            setattr(mod, name, orig)
        return False


def spilling_entries(report: str) -> list:
    """(demangled entry, its spill line) for each entry of a ptxas report
    that spills."""
    from repro_torch.kernels import build

    found, entry = [], None
    for line in report.splitlines():
        if "Function properties for " in line:
            entry = line.split("Function properties for ")[1].strip()
        elif "spill" in line and " 0 bytes spill" not in line:
            found.append((entry, line.strip()))
    if not found:
        return []
    names = subprocess.run([build.cuda_tool("cu++filt")], input="\n".join(e for e, _ in found),
                           capture_output=True, text=True, check=True).stdout.splitlines()
    kernel = re.compile(r"(?:\w+::)*\w+_kernel(?:<[^<>]*>)?")
    return [(m[0] if (m := kernel.search(name)) else name, l) for name, (_, l) in zip(names, found)]


def forcing(module, chooser: str, choice: str, fn):
    """fn() with ``module.<chooser>`` (a wrapper's route or design choice)
    answering ``choice``: another design on the same inputs."""
    chosen = getattr(module, chooser)
    setattr(module, chooser, lambda *args: choice)
    try:
        return fn()
    finally:
        setattr(module, chooser, chosen)


def on_bwd_route(route: str, fn):
    """fn() with flash_attention_bwd's route forced to ``route``, as phase
    4's ``on_fma`` forces moe_gmm's."""
    import repro_torch.kernels.flash_attention as fa_module

    return forcing(fa_module, "_bwd_route", route, fn)


def on_k7_baseline(kernel: str, fn):
    """fn() with K7a (``kernel`` "moe_gmm_bwd") on its first design, route
    mma, or K7b ("mamba_scan_bwd") on its first, per_step: the baselines
    phases 2 and 5g hold and time beside the designs the wrappers choose."""
    import repro_torch.kernels.mamba_scan as scan_module
    import repro_torch.kernels.moe_gmm as gmm_module

    if kernel == "moe_gmm_bwd":
        return forcing(gmm_module, "_bwd_route", "mma", fn)
    return forcing(scan_module, "_bwd_design", "per_step", fn)


def k1_checks(rand, check, check_grad):
    """Phase 2's K1 part: the forward's log-sum-exp on both routes, then the
    backward against its plain version on the route it takes and, where that
    is wgmma at Dk = Dv (bf16 at Dh 64 and 128), on mma too; on its own route,
    bit-equal when run twice at the ``BWD_BIT_EQUAL`` shapes."""
    import torch

    import repro_torch.kernels.flash_attention as fa_module
    from repro_torch.kernels import ref
    from repro_torch.kernels.flash_attention import flash_attention, flash_attention_bwd

    for dtype in (torch.float32, torch.bfloat16):
        for B, Lq, Lk, H, KVH, Dk, Dv, causal, window in BWD_CASES:
            q, do = rand(B, Lq, H, Dk, dtype=dtype), rand(B, Lq, H, Dv, dtype=dtype)
            k, v = rand(B, Lk, KVH, Dk, dtype=dtype), rand(B, Lk, KVH, Dv, dtype=dtype)
            mask = dict(causal=causal, window=window)
            routes0 = dict(flash_attention.route_launches)
            o, lse = flash_attention(q, k, v, **mask, return_lse=True)
            fwd = [r for r in routes0 if flash_attention.route_launches[r] != routes0[r]][0]
            ro, rl = ref.reference_attention(q, k, v, **mask, return_lse=True)
            name = f"{dtype} B{B} Lq{Lq} Lk{Lk} H{H}/{KVH} Dk{Dk} Dv{Dv} causal={causal} window={window}"
            check(f"flash_attention lse ({fwd}) {name}", lse, rl, torch.float32)
            check(f"flash_attention o ({fwd}) {name}", o, ro, dtype)
            want = ref.reference_attention_bwd(q, k, v, o, do, rl, **mask)
            own = fa_module._bwd_route(dtype, Dk, Dv)
            for route in (own, "mma") if own == "wgmma" and Dk == Dv else (own,):
                n0 = flash_attention_bwd.route_launches[route]
                got = on_bwd_route(route, lambda: flash_attention_bwd(q, k, v, o, do, lse, **mask))
                if flash_attention_bwd.route_launches[route] != n0 + 1:
                    fail(f"flash_attention_bwd {name}: no launch on route {route}")
                for n, g, w in zip(("dq", "dk", "dv"), got, want):
                    check_grad(f"flash_attention_bwd ({route}) {n} {name}", g, w, dtype)
                if route == own and (B, Lq, Lk, H, KVH, Dk) in BWD_BIT_EQUAL:
                    again = flash_attention_bwd(q, k, v, o, do, lse, **mask)
                    if not all(torch.equal(a, b) for a, b in zip(got, again)):
                        fail(f"flash_attention_bwd ({route}) {name}: two runs on one input differ")
                    print(f"  flash_attention_bwd ({route}) {name}: a second run is bit-equal")
                    del again
                del got
            del q, k, v, do, o, lse, ro, rl, want
            torch.cuda.empty_cache()


# K7's checks (phase 2): the backward kernels against their plain versions,
# under BWD_TOL in each output's dtype. moe_gmm_bwd: f32 sums in another
# order; in bf16 the outputs, and dG, dU and h, which may round the other way
# where g and u were summed in another order. mamba_scan_bwd (f32 but dxc, in
# xc's dtype): ex2.approx against exp over L steps, taken three times
# (checkpoints, recompute, reverse), and sums over Di, N and (B, L) in other
# orders.
# jamba-v0.1-52b's and mixtral-8x7b's training bins (batch 4 x seq 1024:
# 4096 tokens > moe_exact_tokens, capacity 4096 x 2 x 1.25 / E)
K7_GMM_TRAIN = [(16, 640, 4096, 14336), (8, 1280, 4096, 14336)]
K7_SCAN_TRAIN = (4, 1024, 8192, 16)  # jamba's training scan (B, L, Di, N)


def k7_checks(rand, check_grad, gmm_inputs, scan_inputs, gmm_cases, scan_cases):
    """Phase 2's K7 part: moe_gmm_bwd against reference_gmm_bwd over phase
    2's moe_gmm cases, partly empty bins and the training bins
    (``K7_GMM_TRAIN``), on the route it picks and, where that is wgmma, on
    the mma baseline; mamba_scan_bwd against reference_selective_scan_bwd
    over phase 2's scan cases (dh_final given where h0 is) and jamba's
    training scan with and without h0 and dh_final, on the chunked design
    and the per_step baseline; in f32 and bf16; each chosen design bit-equal
    when run twice at the training shapes; the scan's backward cut into 3
    segments (offset limit patched small) bit-equal to one call."""
    import torch

    import repro_torch.kernels.mamba_scan as scan_module
    import repro_torch.kernels.moe_gmm as gmm_module
    from repro_torch.kernels import ref
    from repro_torch.kernels.mamba_scan import mamba_scan_bwd
    from repro_torch.kernels.moe_gmm import moe_gmm_bwd

    def gmm_routes(dtype, D, Fd):
        """(route, call wrapper) for the route the wrapper picks and, where that
        is wgmma, the mma baseline on the same inputs."""
        own = gmm_module._bwd_route(dtype, D, Fd)
        both = [(own, lambda f: f())]
        if own == "wgmma":
            both.append(("mma", lambda f: on_k7_baseline("moe_gmm_bwd", f)))
        return both

    names = ("dx", "dwg", "dwu", "dwd")
    for dtype in (torch.float32, torch.bfloat16):
        for E, C, D, Fd, scale in gmm_cases + [c + ("fan_in",) for c in K7_GMM_TRAIN]:
            ins = gmm_inputs(E, C, D, Fd, scale, dtype)
            dy = rand(E, C, D, dtype=dtype, scale=D**-0.5 if scale == "fan_in" else 1.0)
            want = ref.reference_gmm_bwd(*ins, dy)
            for i, (route, on) in enumerate(gmm_routes(dtype, D, Fd)):
                n0 = moe_gmm_bwd.route_launches[route]
                got = on(lambda: moe_gmm_bwd(*ins, dy))
                if moe_gmm_bwd.route_launches[route] != n0 + 1:
                    fail(f"moe_gmm_bwd {dtype} E{E} C{C}: no launch on route {route}")
                for n, g, w in zip(names, got, want):
                    check_grad(f"moe_gmm_bwd ({route}) {n} {dtype} E{E} C{C} D{D} F{Fd}", g, w, dtype)
                if i == 0 and (E, C, D, Fd) in K7_GMM_TRAIN and dtype == torch.bfloat16:
                    again = moe_gmm_bwd(*ins, dy)
                    if not all(torch.equal(a, b) for a, b in zip(got, again)):
                        fail(f"moe_gmm_bwd ({route}) E{E} C{C}: two runs on one input differ")
                    print(f"  moe_gmm_bwd ({route}) E{E} C{C} D{D} F{Fd}: a second run is bit-equal")
                    del again
                del got
            del ins, dy, want
            torch.cuda.empty_cache()
        # partly filled and empty bins, as a training dispatch leaves them: the
        # rows past each bin's fill are zeros in x and in dY, and give exact zeros in dX
        E, C, D, Fd = 6, 40, 64, 96
        ins = gmm_inputs(E, C, D, Fd, "fan_in", dtype)
        fill = torch.tensor([0, 1, 17, 40, 0, 33], device=ins[0].device)
        live = torch.arange(C, device=fill.device)[None] < fill[:, None]
        ins[0].mul_(live[..., None])
        dy = rand(E, C, D, dtype=dtype, scale=D**-0.5) * live[..., None]
        want = ref.reference_gmm_bwd(*ins, dy)
        for route, on in gmm_routes(dtype, D, Fd):
            got = on(lambda: moe_gmm_bwd(*ins, dy))
            for n, g, w in zip(names, got, want):
                check_grad(f"moe_gmm_bwd ({route}) {n} {dtype}, bins filled {fill.tolist()} of {C}", g, w, dtype)
            if got[0][~live].any():
                fail(f"moe_gmm_bwd ({route}): empty capacity rows gave a non-zero dX")
            print(f"  moe_gmm_bwd ({route}) {dtype}: empty rows give exact zeros in dX")

        cases = [(B, L, Di, N, h0, h0) for B, L, Di, N, h0 in scan_cases] + [
            K7_SCAN_TRAIN + (False, False), K7_SCAN_TRAIN + (True, True)]
        for B, L, Di, N, with_h0, with_dh in cases:
            xc, dt, Bm, Cm, a, h0 = scan_inputs(B, L, Di, N, with_h0, dtype)
            dy = rand(B, L, Di, dtype=torch.float32)
            dh = rand(B, Di, N, dtype=torch.float32) if with_dh else None
            want = ref.reference_selective_scan_bwd(xc, dt, Bm, Cm, a, h0, dy, dh)
            name = f"{dtype} B{B} L{L} Di{Di} N{N} h0={with_h0} dh_final={with_dh}"
            own = scan_module._bwd_design()
            for design, on in ((own, lambda f: f()), ("per_step", lambda f: on_k7_baseline("mamba_scan_bwd", f))):
                n0 = mamba_scan_bwd.route_launches[design]
                out = on(lambda: mamba_scan_bwd(xc, dt, Bm, Cm, a, h0, dy, dh))
                if mamba_scan_bwd.route_launches[design] != n0 + 1:
                    fail(f"mamba_scan_bwd {name}: no call on design {design}")
                for n, g, w in zip(("dxc", "ddt", "dB", "dC", "da", "dh0"), out, want):
                    check_grad(f"mamba_scan_bwd ({design}) {n} {name}", g, w, g.dtype)
                if design == own:
                    got = out
                del out
            if (B, L, Di, N) == K7_SCAN_TRAIN:
                again = mamba_scan_bwd(xc, dt, Bm, Cm, a, h0, dy, dh)
                if not all(torch.equal(x, y) for x, y in zip(got, again)):
                    fail(f"mamba_scan_bwd ({own}) {name}: two runs on one input differ")
                print(f"  mamba_scan_bwd ({own}) {name}: a second run is bit-equal")
                # the segmented path: 3 segments (offset limit patched small) against one call
                limit = scan_module.OFFSET_LIMIT
                scan_module.OFFSET_LIMIT = (400 + scan_module.MAX_AHEAD) * Di + 1
                try:
                    n0 = mamba_scan_bwd.launches
                    segs = mamba_scan_bwd(xc, dt, Bm, Cm, a, h0, dy, dh)
                    n_calls = mamba_scan_bwd.launches - n0
                finally:
                    scan_module.OFFSET_LIMIT = limit
                equal = all(torch.equal(x, y) for x, y in zip(got, segs))
                print(f"  mamba_scan_bwd ({own}) {name} in 3 segments of <= 400 steps ({n_calls} call): bit-equal "
                      f"to one segment {equal}")
                if n_calls != 1 or not equal:
                    fail(f"mamba_scan_bwd ({own}) {name}: segmented in {n_calls} calls, bit-equal {equal}")
                del again, segs
            del xc, dt, Bm, Cm, a, h0, dy, dh, got, want
            torch.cuda.empty_cache()


def decode_lse_checks(rand, check, decode_positions):
    """flash_decode with its log-sum-exp (``return_lse``, f32 and q's-dtype
    outputs) against the plain version at every DECODE_CASES case, in f32 and
    bf16 (the lse at f32's tolerance in both); each case cut into 4 slices of its slots (positions kept, written
    counts clamped, so some slices are empty or masked) whose partials,
    merged by ``dist.comm.combine_partials``, equal the whole-cache call; and
    a row with no written slot, which gives 0 and an lse of NEG_INF exactly."""
    import torch

    from repro_torch.dist.comm import combine_partials
    from repro_torch.kernels import ref
    from repro_torch.kernels.flash_decode import flash_decode
    from repro_torch.models.common import NEG_INF

    f32 = torch.float32
    for dtype in (f32, torch.bfloat16):
        for B, S, H, KVH, Dh, window, nv, qp, slots in DECODE_CASES:
            q, k, v = rand(B, 1, H, Dh, dtype=dtype), rand(B, S, KVH, Dh, dtype=dtype), rand(B, S, KVH, Dh, dtype=dtype)
            kpos, qpos, nval = decode_positions(B, S, nv, qp, slots)
            name = f"flash_decode with lse {dtype} B{B} S{S} H{H}/{KVH} Dh{Dh} window={window} n_valid={nv} slots={slots}"
            o, lse = flash_decode(q, k, v, kpos, qpos, nval, window=window, return_lse=True, out_dtype=f32)
            ro, rl = ref.reference_decode(q, k, v, kpos, qpos, nval, window=window, return_lse=True, out_dtype=f32)
            check(name + " o", o, ro, dtype)
            check(name + " lse", lse, rl, f32)  # f32 computed in f32 on both sides
            o_own, _ = flash_decode(q, k, v, kpos, qpos, nval, window=window, return_lse=True)
            if o_own.dtype != dtype or not torch.equal(o_own, flash_decode(q, k, v, kpos, qpos, nval, window=window)):
                fail(f"{name}: the output in q's dtype differs from the call without lse")
            part = S // 4
            outs, lses = [], []
            for r in range(4):
                cut = slice(r * part, (r + 1) * part if r < 3 else S)
                n_r = (nval - r * part).clamp(0, cut.stop - cut.start).to(torch.int32)
                a, b = flash_decode(q, k[:, cut].contiguous(), v[:, cut].contiguous(), kpos[:, cut].contiguous(), qpos,
                                    n_r, window=window, return_lse=True, out_dtype=f32)
                outs.append(a)
                lses.append(b)
            check(name + ", 4 slices merged", combine_partials(torch.stack(outs), torch.stack(lses)), o, dtype)
    q, k = rand(2, 1, 8, 64, dtype=torch.bfloat16), rand(2, 64, 2, 64, dtype=torch.bfloat16)
    i32 = dict(dtype=torch.int32, device=q.device)
    o, lse = flash_decode(q, k, k, torch.arange(64, **i32).expand(2, 64).contiguous(), torch.full((2,), 63, **i32),
                          torch.tensor([0, 64], **i32), return_lse=True, out_dtype=f32)
    if not (torch.equal(o[0], torch.zeros_like(o[0])) and bool((lse[0] == NEG_INF).all()) and bool(lse[1].gt(-1e30).all())):
        fail(f"flash_decode: a row with no written slot gave |o| {o[0].abs().max().item()}, lse {lse[0].tolist()}")
    print("  flash_decode with lse: a row with no written slot gives 0 and NEG_INF")


def leaf_names(tree, prefix=""):
    if isinstance(tree, dict):
        return [n for k in sorted(tree) for n in leaf_names(tree[k], f"{prefix}/{k}")]
    if isinstance(tree, list):
        return [n for i, t in enumerate(tree) for n in leaf_names(t, f"{prefix}/{i}")]
    return [prefix]


def run_main_captured(main_fn, argv):
    """Run an entry point's main(argv), its standard output captured and echoed
    indented; returns (result, output)."""
    import contextlib
    import io

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        result = main_fn(argv)
    out = buf.getvalue()
    for line in out.splitlines():
        print(f"    | {line}")
    return result, out


def step_losses(out: str) -> list:
    return [(int(s), float(l)) for s, l in re.findall(r"^step\s+(\d+) loss (\S+)", out, re.M)]


def checked_train_run(cfg, dev, B, L, steps, lr, seed, want, routes_of, want_routes, spies=None):
    """Phases 5g and 5h: ``launch.train.run`` of ``cfg``, as a user runs a
    config built in code, its final checkpoint counted, not written (5a
    writes stablelm's); exact launches (``want``) and routes (``routes_of()``
    against ``want_routes``), no plain version, a finite loss at every step.
    ``spies``: kernel name -> a callable that stands in ``ops.KERNELS`` for
    the run (installed after the counts are zeroed, removed before they are
    read). Returns the final state."""
    import shutil

    import torch

    from repro_torch.checkpoint import checkpoint as ckpt_mod
    from repro_torch.kernels import ops
    from repro_torch.launch import train
    from repro_torch.optim.adamw import tree_leaves

    ckpt_dir = ROOT / "build" / "chip_smoke_ckpt_run"
    saves = []
    save_async = ckpt_mod.CheckpointManager.save_async
    ckpt_mod.CheckpointManager.save_async = lambda self, state, step, meta=None: saves.append(step)
    ops.reset_launch_counts()
    kept = dict(ops.KERNELS)
    ops.KERNELS.update(spies or {})
    try:
        torch.cuda.reset_peak_memory_stats()
        with PlainSpy() as spy:
            state, out = run_main_captured(
                lambda _: train.run(cfg, steps=steps, batch=B, seq=L, lr=lr, ckpt_every=1000, ckpt_dir=str(ckpt_dir),
                                    seed=seed, device=dev), None)
        torch.cuda.synchronize()
    finally:
        ckpt_mod.CheckpointManager.save_async = save_async
        ops.KERNELS.update(kept)
    shutil.rmtree(ckpt_dir, ignore_errors=True)
    launches, routes, losses = ops.launch_counts(), routes_of(), step_losses(out)
    print(f"  train.run: launches {launches} (want {want}); by route {routes}; plain versions called {spy.calls}; "
          f"saves {saves}; {sum(p.numel() for p in tree_leaves(state['params']))} params; peak memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    if launches != want or routes != want_routes:
        fail(f"train.run {cfg.name}: launches {launches}, routes {routes}: want {want}, {want_routes}")
    if any(spy.calls.values()):
        fail(f"train.run {cfg.name}: the plain versions ran on the card path: {spy.calls}")
    if [s for s, _ in losses] != list(range(steps)) or not all(np.isfinite(l) for _, l in losses):
        fail(f"train.run {cfg.name}: step losses {losses}")
    if int(state["step"]) != steps or saves != [steps]:
        fail(f"train.run {cfg.name}: step {int(state['step'])}, saves {saves}")
    return state


def repeated_batch(name, step, state, batch, per_step):
    """Phases 5b, 5g and 5h: ``TRAIN_REPEAT`` steps of ``make_train_step`` on
    one repeated batch, with exact launches (``per_step`` a step), no plain
    version, finite metrics, and a loss that falls at every step. Returns
    (the state, the median time of steps 1 on in s, the peak memory in
    bytes)."""
    import torch

    from repro_torch.kernels import ops

    mets, times = [], []
    ops.reset_launch_counts()
    torch.cuda.reset_peak_memory_stats()
    with PlainSpy() as spy:
        for _ in range(TRAIN_REPEAT):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            state, met = step(state, batch)
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
            mets.append({k: v.item() for k, v in met.items()})
    launches, peak = ops.launch_counts(), torch.cuda.max_memory_allocated()
    for i, m in enumerate(mets):
        print(f"  repeated batch step {i}: " + ", ".join(f"{k} {v:.6g}" for k, v in m.items())
              + f" ({times[i]:.3f} s)")
    want = {k: v * TRAIN_REPEAT for k, v in per_step.items()}
    if launches != want or any(spy.calls.values()):
        fail(f"make_train_step {name}: launches {launches} (want {want}), plain calls {spy.calls}")
    if not all(np.isfinite(v) for m in mets for v in m.values()):
        fail(f"make_train_step {name}: non-finite metrics {mets}")
    losses = [m["loss"] for m in mets]
    if not all(b < a for a, b in zip(losses, losses[1:])):
        fail(f"make_train_step {name}: the loss on a repeated batch did not fall at every step: {losses}")
    return state, statistics.median(times[1:]), peak


def grads_of(model, params, batch, kernels):
    """(loss, metrics, the gradient of every leaf of ``params``) of one
    ``train_loss`` on ``batch``; ``kernels``: None, or the plain versions."""
    import torch

    from repro_torch.models.registry import train_loss
    from repro_torch.optim.adamw import tree_leaves, tree_map

    leaves = [p.detach().requires_grad_() for p in tree_leaves(params)]
    it = iter(leaves)
    live = tree_map(lambda _: next(it), params)
    loss, met = train_loss(model, live, batch, kernels=kernels)
    return loss.item(), {k: v.item() for k, v in met.items()}, torch.autograd.grad(loss, leaves)


def gradient_gate(label, names, run_kernels, run_plain, want):
    """Phases 5c, 5g and 5h: one step's gradient of every leaf (``names``),
    ``run_kernels()`` against ``run_plain()`` (each ``grads_of``): exact
    launches (``want``, and as many with the plain versions), finite loss
    and metrics, and each leaf's relative L2 error within ``GRAD_REL_TOL``."""
    import torch

    from repro_torch.kernels import ops

    ops.reset_launch_counts()
    loss_k, met_k, grads_k = run_kernels()
    n_k = ops.launch_counts()
    loss_p, met_p, grads_p = run_plain()
    n_p = ops.launch_counts()
    if n_k != want or n_p != n_k:
        fail(f"{label} gradient gate: launches {n_k} (want {want}), then {n_p} with the plain versions")
    rel = []
    for name, gk, gp in zip(names, grads_k, grads_p):
        gk, gp = gk.float(), gp.float()
        if not torch.isfinite(gk).all():
            fail(f"{label} gradient of {name}: non-finite")
        rel.append(((gk - gp).norm() / gp.norm().clamp_min(1e-30)).item())
    worst = sorted(zip(rel, names), reverse=True)[:4]
    print(f"  {label}, kernels vs plain versions: loss {loss_k:.6f} vs {loss_p:.6f}"
          + "".join(f", {k} {met_k[k]:.6f} vs {met_p[k]:.6f}" for k in met_k)
          + f"; relative L2 error per leaf max {max(rel):.4e} (tol {GRAD_REL_TOL}), median "
          f"{statistics.median(rel):.4e} over {len(rel)} leaves; worst " + "; ".join(f"{n} {r:.3e}" for r, n in worst))
    if not max(rel) <= GRAD_REL_TOL or not all(np.isfinite(v) for v in (loss_k, *met_k.values())):
        fail(f"{label} gradient gate: relative L2 error {max(rel)} > {GRAD_REL_TOL}, loss {loss_k}, metrics {met_k}")


# phase 3e: B10's IoT fan-in (benchmarks/bench_koalja.py: 437-480) with its
# readings on the card at B14's payload size: 3 zones x 8 sensors x 3 rounds
FANIN = dict(zones=3, sensors=8, rounds=3, seed=11)
# phase 3e's process runtime: a fan-out of squarers over host and card tensors
# of the wave's size, and zone runners over host readings of B10's own 1 KiB
POOL = dict(width=4, rounds=2, workers=4, host_reading_el=256)


def fanin_workspace(Workspace, Topology, placement, executor, journal_path):
    """B10's fan-in: per-zone sensors (sources, pinned) -> per-zone aggregator
    (floating) -> a merge reducer pinned to the cloud."""
    topo = Topology("iot")
    topo.zone("cloud", tier="cloud")
    zones = [f"edge-{i}" for i in range(FANIN["zones"])]
    for z in zones:
        topo.zone(z, tier="edge")
        topo.link("cloud", z, bandwidth_mbps=50, latency_ms=20, energy_j_per_mb=0.05)
    ws = Workspace("edge-fanin", topology=topo, placement=placement, executor=executor, cache=False,
                   journal_path=journal_path)
    for z in zones:
        for i in range(FANIN["sensors"]):
            ws.source(lambda: {"reading": None}, name=f"s_{z}_{i}", outputs=["reading"]).place(z)
        agg = ws.task(lambda **kw: {"agg": sum(kw.values())}, name=f"agg_{z}",
                      inputs=[f"r{i}" for i in range(FANIN["sensors"])], outputs=["agg"])
        for i in range(FANIN["sensors"]):
            ws[f"s_{z}_{i}"]["reading"] >> agg[f"r{i}"]
    red = ws.task(lambda merged: {"total": [float(m.double().sum()) for m in merged]}, name="reduce",
                  inputs=[f"a_{z}" for z in zones], outputs=["total"], mode="merge").place("cloud")
    for z in zones:
        ws[f"agg_{z}"]["agg"] >> red[f"a_{z}"]
    return ws, zones


def crosszone_bytes_implied(ws) -> int:
    """The bytes the placement implies must cross zones, worked out from the
    circuit and its payloads, not from the ledger: each AV a task emitted,
    once per (content, consuming zone), where its producer's zone is not the
    consumer's; its size is the tensor's numel x element size."""
    zone_of = {t: z for z, v in ws.stats()["topology"]["zones"].items() for t in v["tasks"]}
    consumers = {}
    for link in ws.pipeline.links:
        consumers.setdefault(link.src_task, set()).add(link.dst_task)
    resident, total = set(), 0
    for uid in ws.registry.all_avs():
        av = ws.registry.get_av(uid)
        src_zone = zone_of.get(av.source_task)
        if src_zone is None:
            continue
        resident.add((av.chash, src_zone))
    for uid in ws.registry.all_avs():
        av = ws.registry.get_av(uid)
        for dst in sorted(consumers.get(av.source_task, ())):
            dz = zone_of[dst]
            if (av.chash, dz) in resident:
                continue
            resident.add((av.chash, dz))
            payload = ws.value_of(av)
            total += payload.numel() * payload.element_size()
    return total


def rehydration_view(ws) -> dict:
    """What a rehydrated workspace must answer as the live one does: every
    AV's lineage, every task's visitor log, the design map, the ledger."""
    reg = ws.registry
    topo = ws.stats()["topology"]
    return {
        "lineage": [reg.lineage(u) for u in reg.all_avs()],
        "visitor_logs": {t: ws.visitor_log(t) for t in ws.design_map()["tasks"]},
        "design_map": ws.design_map(),
        "ledger": None if topo is None else topo["ledger"],
    }


def durable_phase(dev, wall, time_ms, rows, flat_s):
    """Phase 3e: the durable, zoned circuit on card payloads (B10's fan-in at
    4.5 MiB under three placements and executors, journaled), phase 3c's wave
    with the journal on and its rehydration (after compaction and a torn
    tail too), a ghost run, and the process runtime after CUDA is live."""
    import os
    import shutil
    import tempfile

    import torch

    from repro_torch.core import ShapeDtypeStruct, hashing
    from repro_torch.kernels import ops, ref
    from repro_torch.kernels.hash_tree import hash_tree_state
    from repro_torch.runtime import ProcessExecutor, ZonedProcessExecutor
    from repro_torch.topology import Topology
    from repro_torch.workspace import ConcurrentExecutor, InlineExecutor, Workspace, ZonedExecutor

    tmp = Path(tempfile.mkdtemp(prefix="chip-smoke-journals-"))
    n_el = WAVE["nbytes"] // 4
    Z, S, R = FANIN["zones"], FANIN["sensors"], FANIN["rounds"]
    print(f"phase 3e: the durable, zoned circuit on the card: B10's fan-in ({Z} zones x {S} sensors x {R} "
          f"rounds) with readings of {WAVE['nbytes']} B f32 on the card, journaled")
    g = torch.Generator(device=dev)
    g.manual_seed(FANIN["seed"])
    readings = [torch.randn(n_el, generator=g, device=dev) for _ in range(Z * S * R)]
    runs, launches3e = {}, 0
    for label, placement, executor in (
            ("all_to_cloud", "pin", InlineExecutor()),
            ("data_gravity", "data_gravity", InlineExecutor()),
            ("data_gravity_zoned", "data_gravity", ZonedExecutor(inner=ConcurrentExecutor(max_workers=4)))):
        ws, zones = fanin_workspace(Workspace, Topology, placement, executor, str(tmp / f"{label}.jsonl"))
        it = iter(readings)
        ops.reset_launch_counts()
        trees0 = hashing.hashing_stats()["tree_hashes"]

        def drive():
            for _ in range(R):
                for z in zones:
                    for i in range(S):
                        ws.push(f"s_{z}_{i}", reading=next(it))

        t = wall(drive)
        launches = ops.launch_counts()
        trees = hashing.hashing_stats()["tree_hashes"] - trees0
        launches3e += launches["hash_tree"]
        stats = ws.stats()
        led = stats["topology"]["ledger"]
        implied = crosszone_bytes_implied(ws)
        want_trees = Z * S * R + Z * R  # every reading, and each aggregate
        runs[label] = dict(
            ws=ws, ledger=led, merge_order=ws.value_of(ws.pipeline.tasks["reduce"].last_outputs["total"]),
            events=sorted((t_, e["event"]) for t_ in ws.tasks() for e in ws.visitor_log(t_)))
        print(f"  {label}: {len(readings) / t:.1f} pushes/s ({t * 1e3:.1f} ms); bytes_moved_crosszone "
              f"{led['bytes_moved_crosszone']} (implied by the placement {implied}); transfer "
              f"{led['transfer_energy_j']:.6f} J, compute {led['compute_energy_j']:.6f} J; hash_tree launches "
              f"{launches['hash_tree']}, tree-tier digests {trees} (want {want_trees}); journal "
              f"{stats['journal']['records_written']} records")
        if led["bytes_moved_crosszone"] != implied:
            fail(f"fan-in {label}: bytes_moved_crosszone {led['bytes_moved_crosszone']} != {implied} implied")
        if not launches["hash_tree"] == trees == want_trees or any(v for k, v in launches.items() if k != "hash_tree"):
            fail(f"fan-in {label}: launches {launches}, tree-tier digests {trees}, want {want_trees}")
        shut = getattr(executor, "inner", None)
        if shut is not None:
            shut.shutdown()
    pin, grav, zoned = runs["all_to_cloud"], runs["data_gravity"], runs["data_gravity_zoned"]
    red = pin["ledger"]["bytes_moved_crosszone"] / max(grav["ledger"]["bytes_moved_crosszone"], 1)
    print(f"  bytes reduction all_to_cloud / data_gravity {red:.2f}x; merge order equal "
          f"{pin['merge_order'] == grav['merge_order'] == zoned['merge_order']}, provenance events equal "
          f"{pin['events'] == grav['events'] == zoned['events']}, zoned ledger == inline {zoned['ledger'] == grav['ledger']}")
    if not (pin["merge_order"] == grav["merge_order"] == zoned["merge_order"]
            and pin["events"] == grav["events"] == zoned["events"] and zoned["ledger"] == grav["ledger"]):
        fail("fan-in: merge order, provenance events or the zoned ledger differ between runs")
    if not all(np.isfinite(pin["merge_order"])):
        fail(f"fan-in: non-finite totals {pin['merge_order']}")
    del readings

    # -- the journal: phase 3c's wave and its replay, journaled -----------------
    wgen = torch.Generator(device=dev)
    wgen.manual_seed(WAVE["seed"])
    wave = [torch.randn(n_el, generator=wgen, device=dev) for _ in range(WAVE["n"])]

    def normalize(x):
        return {"y": (x - x.mean()) / x.std()}

    jws = Workspace("normalize-on-card", executor=InlineExecutor(), topology=False,
                    journal_path=str(tmp / "wave.jsonl"))
    task = jws.task(normalize, name="normalize", inputs=["x"], outputs=["y"])
    ops.reset_launch_counts()
    first_s = wall(lambda: [jws.push(task, x=x) for x in wave])
    replay_s = wall(lambda: [jws.push(task, x=x) for x in wave])
    jl = ops.launch_counts()["hash_tree"]
    launches3e += jl
    jws.journal.flush()
    js = jws.stats()["journal"]
    n = WAVE["n"]
    print(f"  journaled wave: pass 1 {n / first_s:.1f} pushes/s, replay {n / replay_s:.1f} pushes/s (flat, phase "
          f"3c: {n / flat_s[0]:.1f} and {n / flat_s[1]:.1f}); {js['records_written']} records, "
          f"{js['bytes_on_disk']} B on disk, {js['flushes']} flushes (every {js['flush_every_n']}); hash_tree "
          f"launches {jl} (want {3 * n})")
    if jl != 3 * n or jws.stats()["tasks"]["normalize"] != {"executions": n, "cache_hits": n}:
        fail(f"journaled wave: {jl} hash_tree launches, tasks {jws.stats()['tasks']}")
    for label, live_ws, path in (("wave", jws, jws.journal.path), ("fan-in", grav["ws"], grav["ws"].journal.path)):
        live_ws.journal.flush()
        live = rehydration_view(live_ws)
        before = live_ws.journal.stats()["bytes_on_disk"]
        t_re = wall(lambda: Workspace.from_journal(path))
        same = rehydration_view(Workspace.from_journal(path)) == live
        t_co = wall(lambda: live_ws.compact_journal())
        after = live_ws.journal.stats()["bytes_on_disk"]
        same_co = rehydration_view(Workspace.from_journal(path)) == live
        live_ws.journal.close()
        with open(path, "rb") as f:
            lines = f.read().splitlines(keepends=True)
        with open(path, "wb") as f:  # the last line, cut in half: a torn tail
            f.write(b"".join(lines[:-1]) + lines[-1][: len(lines[-1]) // 2])
        torn = Workspace.from_journal(path)
        same_torn = rehydration_view(torn) == live
        cut = torn.stats()["journal"]["truncated_lines"]
        print(f"  {label} journal: from_journal {t_re:.3f} s, equal to the live workspace {same}; compaction "
              f"{t_co:.3f} s, {before} -> {after} B on disk, equal after it {same_co}; torn tail ({cut} line "
              f"dropped) equal {same_torn}")
        if not (same and same_co and same_torn and cut == 1):
            fail(f"{label} journal: rehydration equal {same}, after compaction {same_co}, torn {same_torn} ({cut})")

    # -- a ghost run of the wave's shape through the same circuit, one stage on --
    def circuit2(W):
        ws2 = W("ghost-twin", executor=InlineExecutor(), topology=False)
        a = ws2.task(normalize, name="normalize", inputs=["x"], outputs=["y"])
        b = ws2.task(lambda y: {"z": y * 2.0}, name="scale", inputs=["y"], outputs=["z"])
        a["y"] >> b["y"]
        return ws2, a

    real, a = circuit2(Workspace)
    for x in wave:
        real.push(a, x=x)
    real_routes = {link.name: link.avs_carried for link in real.pipeline.links}
    gws, ga = circuit2(Workspace)
    torch.cuda.synchronize()
    mem0 = torch.cuda.memory_allocated()
    ops.reset_launch_counts()
    box = {}
    t_g = wall(lambda: box.update(report=gws.ghost({ga["x"]: [ShapeDtypeStruct((n_el,), "float32")] * n})))
    ghost_launches = ops.launch_counts()
    mem1 = torch.cuda.memory_allocated()
    routes = {k: v["carried"] for k, v in box["report"]["routes"].items()}
    puts = gws.store.stats()["puts"]
    spec = gws.pipeline.tasks["scale"].last_outputs["z"].meta["ghost_spec"]
    print(f"  ghost run of {n} specs ({n_el},) f32: {t_g * 1e3:.1f} ms; routes carried {routes} (real run "
          f"{real_routes}); store puts {puts}; launches {sum(ghost_launches.values())}; memory_allocated "
          f"{mem0} -> {mem1} B; last spec {spec!r}")
    if not routes or routes != real_routes or puts != 0 or any(ghost_launches.values()) or mem1 != mem0:
        fail(f"ghost run: routes {routes} vs {real_routes}, puts {puts}, launches {ghost_launches}, "
             f"memory {mem0} -> {mem1}")
    if spec != ShapeDtypeStruct((n_el,), "float32"):
        fail(f"ghost run: the wire's spec is {spec!r}")
    del real, gws

    # -- the process runtime, after CUDA is live -------------------------------
    def fan(executor, xs):
        ws3 = Workspace("fan", executor=executor, cache=False, topology=False)
        src = ws3.task(lambda x: {"out": x}, name="src", inputs=["x"], outputs=["out"])
        for i in range(POOL["width"]):
            sq = ws3.task(lambda y, i=i: {"sq": y * y + i}, name=f"sq{i}", inputs=["y"], outputs=["sq"])
            src["out"] >> sq["y"]
        for x in xs:
            ws3.push(src, x=x)
        return ws3, [ws3.value_of(ws3.pipeline.tasks[f"sq{i}"].last_outputs["sq"]) for i in range(POOL["width"])]

    n_tasks = POOL["width"] * POOL["rounds"]
    xs = {"host": [x.cpu() for x in wave[: POOL["rounds"]]], "card": wave[: POOL["rounds"]]}
    pool = {}
    for kind in ("host", "card"):
        want = fan(InlineExecutor(), xs[kind])[1]
        ex = ProcessExecutor(max_workers=POOL["workers"])
        try:
            box = {}
            t_ = wall(lambda: box.update(out=fan(ex, xs[kind])[1]))
            st = dict(ex.stats())
        finally:
            ex.shutdown()
        equal = all(torch.equal(g_, w_) and g_.device == w_.device for g_, w_ in zip(box["out"], want))
        pool[kind] = (st["tasks_remote"], st["tasks_inline"], equal, box["out"][0].device.type)
        print(f"  ProcessExecutor({POOL['workers']}), {kind} wave of {n_tasks} plans: remote {st['tasks_remote']}, "
              f"inline {st['tasks_inline']}, outputs on {box['out'][0].device.type} and bit-equal to the inline "
              f"run's {equal}; {t_ * 1e3:.1f} ms; workers forked {st['worker_restarts'] + st['workers_alive']}")
    if pool["host"] != (n_tasks, 0, True, "cpu") or pool["card"] != (0, n_tasks, True, "cuda"):
        fail(f"process runtime: (remote, inline, equal, device) host {pool['host']} (want ({n_tasks}, 0, "
             f"True, 'cpu')), card {pool['card']} (want (0, {n_tasks}, True, 'cuda'))")
    hg = np.random.RandomState(FANIN["seed"])
    host_readings = [torch.from_numpy(hg.randn(POOL["host_reading_el"]).astype(np.float32)) for _ in range(R)]

    def host_fanin(executor, journal_path):
        """B10's topology with the fan-in turned round: a cloud source feeds one
        task pinned to each edge zone, whose results a cloud reducer merges, so
        that each push makes a wave of one task a zone (B10's sensors make
        waves of one task, which stay in the parent)."""
        topo = Topology("iot")
        topo.zone("cloud", tier="cloud")
        zones = [f"edge-{i}" for i in range(Z)]
        for z in zones:
            topo.zone(z, tier="edge")
            topo.link("cloud", z, bandwidth_mbps=50, latency_ms=20, energy_j_per_mb=0.05)
        ws4 = Workspace("zone-runners", topology=topo, placement="pin", executor=executor, cache=False,
                        journal_path=journal_path)
        src = ws4.task(lambda x: {"out": x}, name="src", inputs=["x"], outputs=["out"]).place("cloud")
        red = ws4.task(lambda merged: {"total": [float(m.double().sum()) for m in merged]}, name="reduce",
                       inputs=[f"a_{z}" for z in zones], outputs=["total"], mode="merge").place("cloud")
        for k, z in enumerate(zones):
            t_ = ws4.task(lambda x, k=k: {"out": x * 2.0 + k}, name=f"prod_{z}", inputs=["x"],
                          outputs=["out"]).place(z)
            src["out"] >> t_["x"]
            t_["out"] >> red[f"a_{z}"]
        for x in host_readings:
            ws4.push(src, x=x)
        return ws4

    inline = host_fanin(InlineExecutor(), None)
    zex = ZonedProcessExecutor(max_workers=POOL["workers"])
    zpath = str(tmp / "zoned-process.jsonl")
    try:
        zws = host_fanin(zex, zpath)
        zst = zex.stats()
        zws.journal.flush()
        merged = Workspace.from_journal([zpath, *zex.segment_paths()])
        n_segments = len(zex.segment_paths())
    finally:
        zex.shutdown()

    def fingerprint(w):
        return {"events": {t_: [e["event"] for e in w.visitor_log(t_)] for t_ in w.design_map()["tasks"]},
                "lineage": [(w.registry.get_av(u).source_task, w.registry.get_av(u).chash,
                             [p["source_task"] for p in w.registry.lineage(u, depth=1)["parents"]])
                            for u in w.registry.all_avs()],
                "ledger": w.stats()["topology"]["ledger"]}

    same_fp = fingerprint(merged) == fingerprint(inline)
    print(f"  ZonedProcessExecutor over the edge zones (host readings of {POOL['host_reading_el'] * 4} B): remote "
          f"{zst['tasks_remote']}, inline {zst['tasks_inline']}, runners {sorted(zst['runners'])}; {n_segments} "
          f"segments merged with the main journal replay to the inline run's fingerprint: {same_fp}")
    if not same_fp or zst["tasks_remote"] != Z * R or n_segments != Z:
        fail(f"zoned process runtime: merged replay equal {same_fp}, remote {zst['tasks_remote']} (want {Z * R}), "
             f"{n_segments} segments (want {Z})")
    del wave, jws
    shutil.rmtree(tmp, ignore_errors=True)
    torch.cuda.empty_cache()

    # hash_tree at phase 3e's payloads, as phase 4 times it
    w = torch.randint(-2**31, 2**31, (n_el,), dtype=torch.int32, device=dev)
    got, want_state = hash_tree_state(w), ref.reference_hash_tree(w)
    if not torch.equal(got, want_state):
        fail(f"hash_tree at phase 3e's payloads: kernel {got.tolist()} != plain {want_state.tolist()}")
    rows.append(dict(
        name="hash_tree", path="phase 3e: the journaled fan-in's and wave's digests, 4.5 MiB, one launch",
        route="cuda", source="src/repro_torch/kernels/csrc/hash_tree.cu",
        replaces="src/repro/kernels/hash_tree.py:74", launches=launches3e, max_abs_err=0.0,
        ms=time_ms(lambda: hash_tree_state(w)), plain_ms=time_ms(lambda: ref.reference_hash_tree(w), reps=5),
        bound_ms=(WAVE["nbytes"] + 12) / PEAK_BYTES_PER_S * 1e3, bound_by="bytes", library_ms=None, library="none",
    ))
    del w


# phase 3f: B15 (benchmarks/bench_koalja.py: 848-917), uncut: 64 tenants each
# push the working set of 8 (rotated) through src -> (left, right) -> join,
# with each payload grown from 256 floats to B14's 4.5 MiB on the card. B15's
# payload p is full(p); at 4.5 MiB that goes to the tree tier, whose block sums
# (128 equal words: 128 x word mod 2**32) drop a float's top 7 bits, so
# full(0.0), full(2.0) and full(8.0) digest alike in both packages; each payload
# is drawn from the seed instead. Four tenants spread over the 64 are held
# against a private run of their script; the joule drill admits JOULE_PUSHES
# pushes of a zoned tenant
B15 = dict(tenants=64, working_set=8, checked=(0, 21, 42, 63), host_el=256, seed=15)
JOULE_PUSHES = 3


def _mt_src(x):
    return {"out": x * 2.0}


def _mt_left(v):
    return {"y": v + 1.0}


def _mt_right(v):
    return {"y": v - 1.0}


def _mt_join(a, b):
    return {"out": float(a.sum() + b.sum())}


def wire_b15(api, zoned=False):
    """B15's circuit on a session or a workspace; ``zoned``: the placement of
    ``tests/test_tenancy.py``'s ``_wire(zoned=True)`` on its two zones."""
    src = api.task(_mt_src, name="src", inputs=["x"], outputs=["out"])
    left = api.task(_mt_left, name="left", inputs=["v"], outputs=["y"])
    right = api.task(_mt_right, name="right", inputs=["v"], outputs=["y"])
    join = api.task(_mt_join, name="join", inputs=["a", "b"], outputs=["out"])
    if zoned:
        src.place("edge")
        left.place("edge")
        right.place("cloud")
        join.place("cloud")
    api.wire(src["out"], left["v"])
    api.wire(src["out"], right["v"])
    api.wire(left["y"], join["a"])
    api.wire(right["y"], join["b"])


def duo_topology(Topology):
    """``tests/test_tenancy.py``'s ``duo``: an edge zone and a cloud zone,
    0.05 J/MB on the link between them."""
    t = Topology("duo")
    t.zone("cloud", tier="cloud")
    t.zone("edge", tier="edge")
    t.link("cloud", "edge", bandwidth_mbps=50, latency_ms=10, energy_j_per_mb=0.05)
    return t


def hub_phase(dev, card, wall, time_ms, rows, device_profile):
    """Phase 3f: the multi-tenant hub on card payloads. B15 uncut and
    journaled (dedup counts, ``hash_tree`` launches == tree digests, pushes/s,
    latency, records/s); a replaying tenant's device-to-host copies (digest
    states only) and its idle share; four tenants against private runs of
    their scripts and against the hub's rehydration; a joule quota on a zoned
    tenant; a tenant under zone runners whose card plans stay in the parent
    and whose merged segments replay to the inline run."""
    import os
    import shutil
    import tempfile

    import torch

    from repro_torch.core import hashing
    from repro_torch.kernels import ops, ref
    from repro_torch.kernels.hash_tree import hash_tree_state
    from repro_torch.provenance import read_chain
    from repro_torch.runtime import ZonedProcessExecutor
    from repro_torch.tenancy import QuotaExceededError, TenantQuota, WorkspaceHub, tenant_fingerprint
    from repro_torch.topology import Topology
    from repro_torch.workspace import InlineExecutor, Workspace

    tmp = Path(tempfile.mkdtemp(prefix="chip-smoke-hub-"))
    n_el = WAVE["nbytes"] // 4
    T, K = B15["tenants"], B15["working_set"]
    print(f"phase 3f: the multi-tenant hub on the card: B15 ({T} tenants x a working set of {K}, rotated) with "
          f"payloads of {WAVE['nbytes']} B f32 on the card, journaled, inline, no topology ({card})")
    g = torch.Generator(device=dev)
    g.manual_seed(B15["seed"])

    def draw():
        return torch.randn(n_el, generator=g, device=dev)

    payloads = [draw() for _ in range(K)]

    def script(i):
        return [payloads[(i + k) % K] for k in range(K)]

    hub = WorkspaceHub("bench-hub", journal_path=str(tmp / "hub.jsonl"), executor_factory=InlineExecutor,
                       workspace_defaults={"topology": False})
    sessions = []
    for i in range(T):
        s = hub.create(f"tenant-{i:03d}", owner="bench")
        wire_b15(s)
        sessions.append(s)
    launches3f = 0
    ops.reset_launch_counts()
    trees0 = hashing.hashing_stats()["tree_hashes"]
    lat = []

    def drive():
        for i, s in enumerate(sessions):
            for x in script(i):
                t1 = time.perf_counter()
                s.push("src", x=x)
                lat.append(time.perf_counter() - t1)
        hub.flush()

    t_all = wall(drive)
    launches = ops.launch_counts()
    trees = hashing.hashing_stats()["tree_hashes"] - trees0
    launches3f += launches["hash_tree"]
    memo = hub.memo.stats()
    logical = T * K * 4
    executed = logical - memo["executions_avoided"]
    records = hub.journal.stats()["records_written"] + sum(s.ws.journal.stats()["records_written"] for s in sessions)
    # pipeline.py _inject -> store.put digests each pushed input; task.py
    # _finish_execution digests the outputs of each firing, executed or
    # replayed from another tenant's run: src, left and right one 4.5 MiB
    # tensor each, join a float (no tree digest). One launch a digest.
    want_trees = T * K * (1 + 3)
    lat.sort()
    p50, p99 = lat[len(lat) // 2] * 1e3, lat[int(len(lat) * 0.99)] * 1e3
    print(f"  B15: {T * K} pushes in {t_all:.3f} s, {T * K / t_all:.1f} pushes/s; push p50 {p50:.3f} ms, p99 "
          f"{p99:.3f} ms; logical firings {logical}, executions avoided {memo['executions_avoided']}, executed "
          f"{executed}, dedup {logical / max(executed, 1):.1f}x, bytes_saved {memo['bytes_saved']}; journal "
          f"{records} records, {records / t_all:.1f} records/s; hash_tree launches {launches['hash_tree']}, "
          f"tree-tier digests {trees} (want {want_trees}); store {hub.store.stats()['puts']} puts ({card})")
    if (memo["executions_avoided"], executed) != (logical - K * 4, K * 4):
        fail(f"hub: executions avoided {memo['executions_avoided']} of {logical}, want {logical - K * 4}")
    if not launches["hash_tree"] == trees == want_trees or any(v for k, v in launches.items() if k != "hash_tree"):
        fail(f"hub: launches {launches}, tree-tier digests {trees}, want {want_trees}")

    # a replaying tenant's pushes: the device-to-host copies are the digests'
    # 12-byte states, no payload; then another's, profiled
    extra = []
    for name in ("tenant-replay-copies", "tenant-replay-profiled"):
        s = hub.create(name, owner="bench")
        wire_b15(s)
        extra.append(s)
    trees0 = hashing.hashing_stats()["tree_hashes"]
    avoided0 = hub.memo.stats()["executions_avoided"]
    ops.reset_launch_counts()
    copies = device_to_host_copies(lambda: [extra[0].push("src", x=x) for x in payloads])
    n_dig = hashing.hashing_stats()["tree_hashes"] - trees0
    launches3f += ops.launch_counts()["hash_tree"]
    avoided = hub.memo.stats()["executions_avoided"] - avoided0
    print(f"  a replaying tenant's {K} pushes: {avoided} of {K * 4} firings avoided; device-to-host copies counted "
          f"at the dispatcher: {len(copies)}, {sum(copies)} B, largest {max(copies, default=0)} B, for {n_dig} "
          f"tree digests (a payload is {WAVE['nbytes']} B)")
    if avoided != K * 4 or not copies or max(copies) > 12 or sum(copies) > 12 * n_dig:
        fail(f"hub: a replaying tenant avoided {avoided} of {K * 4} firings; device-to-host copies {copies} B, "
             f"want each <= 12 B and <= 12 B a digest ({n_dig})")
    ops.reset_launch_counts()
    t_p, busy, kern, _ = device_profile(lambda: [extra[1].push("src", x=x) for x in payloads])
    launches3f += ops.launch_counts()["hash_tree"]
    print(f"  a replaying tenant's {K} pushes, profiled: wall {t_p * 1e3:.2f} ms, device busy {busy * 1e3:.3f} ms, "
          f"idle share {1 - busy / t_p:.3f}, {len(kern)} device events ({card})")

    # four tenants against private runs of their scripts on the card
    ops.reset_launch_counts()
    live = {}
    for i in B15["checked"]:
        solo = Workspace("solo", executor=InlineExecutor(), topology=False, journal_path=False)
        wire_b15(solo)
        for x in script(i):
            solo.push("src", x=x)
        live[sessions[i].tenant] = sessions[i].fingerprint()
        if live[sessions[i].tenant] != tenant_fingerprint(solo):
            fail(f"hub: {sessions[i].tenant}'s fingerprint differs from a private run of its script")
    launches3f += ops.launch_counts()["hash_tree"]
    hub.flush()
    t_re = wall(lambda: WorkspaceHub.from_journal(str(tmp / "hub.jsonl")))
    re = WorkspaceHub.from_journal(str(tmp / "hub.jsonl"))
    replayed = {name: tenant_fingerprint(re.workspace(name)) for name in live}
    print(f"  tenants {sorted(live)}: fingerprints equal to private runs of their scripts; from_journal "
          f"{t_re:.3f} s, {len(re.tenants())} tenants, {len(re.dedup_events)} dedup events, rehydrated "
          f"fingerprints equal to the live ones {replayed == live}")
    if replayed != live or len(re.dedup_events) != hub.memo.stats()["dedup_hits"] or len(re.tenants()) != T + 2:
        fail(f"hub: rehydration: fingerprints equal {replayed == live}, {len(re.dedup_events)} dedup events "
             f"(want {hub.memo.stats()['dedup_hits']}), {len(re.tenants())} tenants")
    hub.shutdown()
    del hub, sessions, extra, re

    # a joule quota on a zoned tenant: the joules of one push, from a private
    # run, price the limits; exactly JOULE_PUSHES pushes are admitted
    ops.reset_launch_counts()
    probe = Workspace("probe", executor=InlineExecutor(), topology=duo_topology(Topology), journal_path=False)
    wire_b15(probe, zoned=True)
    probe.push("src", x=draw())
    e = probe.ledger.stats()["transfer_energy_j"]
    quota = TenantQuota(hard_joules=(JOULE_PUSHES - 0.5) * e, soft_joules=1.5 * e)
    jhub = WorkspaceHub("joule-hub", journal_path=str(tmp / "joule" / "hub.jsonl"))
    js = jhub.create("edge-team", owner="ops", quota=quota, topology=duo_topology(Topology))
    wire_b15(js, zoned=True)
    admitted, before, after, refused = 0, None, None, None
    for _ in range(JOULE_PUSHES + 1):
        before = js.ws.ledger.stats()
        try:
            js.push("src", x=draw())
            admitted += 1
        except QuotaExceededError as err:
            refused = str(err)
            after = js.ws.ledger.stats()
            break
    jhub.flush()
    seg = js.ws.journal.path
    notes = [r["data"]["note"] for r in read_chain(seg)[0] if r.get("kind") == "anomaly"]
    rejected = [n for n in notes if n.startswith("quota_rejected axis=joules")]
    warned = [n for n in notes if n.startswith("quota_warning axis=joules")]
    qs = js.quota_stats()
    launches3f += ops.launch_counts()["hash_tree"]
    print(f"  joule quota on a zoned tenant ({WAVE['nbytes']} B card pushes, {e:.6f} J a push; hard "
          f"{quota.hard_joules:.6f} J, soft {quota.soft_joules:.6f} J): admitted {admitted}, refused: {refused!r}; "
          f"ledger unchanged by the refusal {after == before}; journaled: {len(warned)} warning, {len(rejected)} "
          f"rejection; {qs['joules_used']:.6f} J used, {qs['bytes_used']} B")
    if (admitted != JOULE_PUSHES or refused is None or after != before or len(rejected) != 1 or len(warned) != 1
            or qs["rejections"] != 1 or not e > 0):
        fail(f"hub: joule quota admitted {admitted} (want {JOULE_PUSHES}), ledger unchanged {after == before}, "
             f"journaled {len(warned)} warnings and {len(rejected)} rejections (want 1 and 1)")
    jhub.shutdown()

    # zone runners: card plans stay in the parent, host plans go to the
    # runners; the tenant's merged segments replay to the inline run
    ops.reset_launch_counts()
    hg = np.random.RandomState(B15["working_set"])
    drill = [draw() for _ in range(2)] + [
        torch.from_numpy(hg.randn(B15["host_el"]).astype(np.float32)) for _ in range(2)]
    zhub = WorkspaceHub("zoned-hub", journal_path=str(tmp / "zoned" / "hub.jsonl"),
                        executor_factory=lambda: ZonedProcessExecutor(max_workers=2))
    zs = zhub.create("zone-team", owner="ops", topology=duo_topology(Topology))
    wire_b15(zs, zoned=True)
    try:
        for x in drill[:2]:
            zs.push("src", x=x)
        card_st = dict(zs.ws.executor.stats())
        for x in drill[2:]:
            zs.push("src", x=x)
        st = dict(zs.ws.executor.stats())
        n_zone_segs = len(zs.ws.executor.segment_paths())
        zhub.flush()
        live_fp = zs.fingerprint()
    finally:
        zhub.shutdown()
    inline = Workspace("inline", executor=InlineExecutor(), topology=duo_topology(Topology), journal_path=False)
    wire_b15(inline, zoned=True)
    for x in drill:
        inline.push("src", x=x)
    zre = WorkspaceHub.from_journal(str(tmp / "zoned" / "hub.jsonl"))
    merged_fp = tenant_fingerprint(zre.workspace("zone-team"))
    launches3f += ops.launch_counts()["hash_tree"]
    print(f"  zone runners: 2 card pushes: {card_st['tasks_remote']} plans remote, {card_st['tasks_inline']} in the "
          f"parent; then 2 host pushes: {st['tasks_remote'] - card_st['tasks_remote']} remote, {n_zone_segs} zone "
          f"runner segments; the hub's replay of the tenant, its segments merged, equals the inline run's "
          f"fingerprint {merged_fp == tenant_fingerprint(inline)} and the live one's {merged_fp == live_fp}")
    # each push's second wave (left, right) is the one a zone runner may take
    if (card_st["tasks_remote"] != 0 or card_st["tasks_inline"] != 2 * 2 or st["tasks_remote"] != 2 * 2
            or n_zone_segs < 1 or merged_fp != tenant_fingerprint(inline) or merged_fp != live_fp):
        fail(f"hub: zone runners: card plans remote {card_st['tasks_remote']} (want 0), inline "
             f"{card_st['tasks_inline']}; host plans remote {st['tasks_remote']}; {n_zone_segs} zone segments; "
             f"merged replay equal to inline {merged_fp == tenant_fingerprint(inline)}, to live {merged_fp == live_fp}")
    del payloads, drill, probe, inline, zre
    shutil.rmtree(tmp, ignore_errors=True)
    torch.cuda.empty_cache()

    # hash_tree at phase 3f's payloads, as phase 4 times it
    w = torch.randint(-2**31, 2**31, (n_el,), dtype=torch.int32, device=dev)
    got, want_state = hash_tree_state(w), ref.reference_hash_tree(w)
    if not torch.equal(got, want_state):
        fail(f"hash_tree at phase 3f's payloads: kernel {got.tolist()} != plain {want_state.tolist()}")
    rows.append(dict(
        name="hash_tree", path="phase 3f: the hub's digests (B15 on card payloads and its drills), 4.5 MiB, one launch",
        route="cuda", source="src/repro_torch/kernels/csrc/hash_tree.cu",
        replaces="src/repro/kernels/hash_tree.py:74", launches=launches3f, max_abs_err=0.0,
        ms=time_ms(lambda: hash_tree_state(w)), plain_ms=time_ms(lambda: ref.reference_hash_tree(w), reps=5),
        bound_ms=(WAVE["nbytes"] + 12) / PEAK_BYTES_PER_S * 1e3, bound_by="bytes", library_ms=None, library="none",
    ))
    del w


def training_phase(dev, rand, check, check_grad, time_ms, bound, rows, plain, device_profile, fail):
    """Phase 5: the training run of stablelm-1.6b at full width, and K1 timed.
    Returns the repeated batch's median step seconds (5b)."""
    import shutil

    import torch

    from repro_torch.checkpoint import checkpoint as ckpt_mod
    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import build_data_pipeline, next_batch
    from repro_torch.dist.step import make_train_step
    from repro_torch.kernels import ops
    from repro_torch.kernels.flash_attention import flash_attention, flash_attention_bwd
    from repro_torch.launch import train
    from repro_torch.models.registry import build_model
    from repro_torch.optim import adamw_init, adamw_update, constant_lr
    from repro_torch.optim.adamw import tree_leaves, tree_map

    cfg = get_config(TRAIN["arch"])
    B, L = TRAIN["batch"], TRAIN["seq"]
    tokens_a_step = B * L
    # remat "block": each layer's attention forward runs in the forward pass and
    # again when the backward pass recomputes the layer; its backward once
    if cfg.remat != "block":
        fail(f"{cfg.name}: remat {cfg.remat!r}, the launch counts below assume 'block'")
    per_step = {"flash_attention": 2 * cfg.n_layers, "flash_attention_bwd": cfg.n_layers}

    def wall_s(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        return time.perf_counter() - t0

    def want_launches(n_steps):
        out = dict.fromkeys(ops.KERNELS, 0)
        out.update({k: v * n_steps for k, v in per_step.items()})
        return out

    print(f"phase 5: train {cfg.name} at full width, bf16, batch {B}, seq {L}, remat {cfg.remat!r}")
    # 5a. launch/train.py, as a user runs it
    ckpt_dir = ROOT / "build" / "chip_smoke_ckpt"
    shutil.rmtree(ckpt_dir, ignore_errors=True)
    argv = ["--arch", cfg.name, "--batch", str(B), "--seq", str(L), "--steps", str(TRAIN["steps"]),
            "--ckpt-every", "1000", "--seed", str(TRAIN["seed"]), "--lr", str(TRAIN["lr"]), "--device", "cuda",
            "--ckpt-dir", str(ckpt_dir)]
    copy_s, write_s = [], []
    save_async, save_checkpoint = ckpt_mod.CheckpointManager.save_async, ckpt_mod.save_checkpoint

    def timed_save_async(self, *args, **kwargs):
        t0 = time.perf_counter()
        save_async(self, *args, **kwargs)
        copy_s.append(time.perf_counter() - t0)

    def timed_save_checkpoint(*args, **kwargs):
        t0 = time.perf_counter()
        av = save_checkpoint(*args, **kwargs)
        write_s.append(time.perf_counter() - t0)
        return av

    ckpt_mod.CheckpointManager.save_async, ckpt_mod.save_checkpoint = timed_save_async, timed_save_checkpoint
    try:
        ops.reset_launch_counts()
        torch.cuda.reset_peak_memory_stats()
        with PlainSpy() as spy:
            state, out = run_main_captured(train.main, argv)
        torch.cuda.synchronize()
    finally:
        ckpt_mod.CheckpointManager.save_async, ckpt_mod.save_checkpoint = save_async, save_checkpoint
    launches = main_launches = ops.launch_counts()
    routes = {"flash_attention": dict(flash_attention.route_launches),
              "flash_attention_bwd": dict(flash_attention_bwd.route_launches)}
    want_main = want_launches(TRAIN["steps"])
    losses = step_losses(out)
    ckpt_bytes = sum(f.stat().st_size for f in ckpt_dir.rglob("*.npz"))
    print(f"  train.main: launches {launches} (want {want_main}); by route {routes}; plain versions "
          f"called {spy.calls}; peak memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    print(f"  final checkpoint ({ckpt_bytes / 2**30:.2f} GiB): device-to-host copy {copy_s} s, npz write {write_s} s")
    want_routes = {"flash_attention": {"fma": 0, "mma": want_main["flash_attention"]},
                   "flash_attention_bwd": {"fma": 0, "mma": 0, "wgmma": want_main["flash_attention_bwd"]}}
    if launches != want_main or routes != want_routes:
        fail(f"train.main: launch counts {launches}, routes {routes}: want {want_main}, routes {want_routes}")
    if any(spy.calls.values()):
        fail(f"train.main: the plain versions ran on the card path: {spy.calls}")
    if [s for s, _ in losses] != list(range(TRAIN["steps"])) or not all(np.isfinite(l) for _, l in losses):
        fail(f"train.main: step losses {losses}")
    if int(state["step"]) != TRAIN["steps"] or len(copy_s) != 1 or len(write_s) != 1:
        fail(f"train.main: step {int(state['step'])}, {len(copy_s)} / {len(write_s)} checkpoint saves")
    n_params = sum(p.numel() for p in tree_leaves(state["params"]))
    del state
    shutil.rmtree(ckpt_dir, ignore_errors=True)
    torch.cuda.empty_cache()

    # 5b. make_train_step on one repeated batch: the loss falls; time, MFU, memory
    model = build_model(cfg)
    params = model.init(TRAIN["seed"], dev)
    state = {"params": params, "opt": adamw_init(params), "step": torch.zeros((), dtype=torch.int32, device=dev)}
    data = build_data_pipeline(cfg, B, L, seed=TRAIN["seed"])
    batch = {k: torch.from_numpy(np.asarray(v, dtype=np.int32)).to(dev) for k, v in next_batch(data, cfg).items()}
    step = make_train_step(model, dev, constant_lr(REPEAT_LR), global_batch=B)
    state, step_s, peak = repeated_batch(cfg.name, step, state, batch, want_launches(1))
    flops = 6 * n_params * tokens_a_step
    print(f"  step time {step_s:.4f} s (median of steps 1-{TRAIN_REPEAT - 1}), {tokens_a_step / step_s:.1f} tokens/s, "
          f"MFU {flops / step_s / PEAK_FLOPS['bfloat16']:.4f} (6 N tokens = {flops:.4e} FLOP, N = {n_params}, "
          f"against {PEAK_FLOPS['bfloat16']:.3e} FLOP/s bf16), peak memory {peak / 2**30:.2f} GiB")
    t, busy, kern, _ = device_profile(lambda: step(state, batch))
    by_name: dict = {}
    for e in kern:
        by_name[e.name[:48]] = by_name.get(e.name[:48], 0.0) + e.time_range.elapsed_us() / 1e3
    k1_ms = sum(ms for n, ms in by_name.items() if any(x in n for x in ("dq_kernel", "dkdv_kernel", "dot_do_o")))
    fwd_ms = sum(ms for n, ms in by_name.items() if "attn_kernel" in n)
    gemm_ms = sum(ms for n, ms in by_name.items() if "nvjet" in n or "gemm" in n.lower())
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:8]
    print(f"  profiled step: wall {t * 1e3:.2f} ms, device busy {busy * 1e3:.2f} ms (idle share {1 - busy / t:.3f}), "
          f"{len(kern)} kernels; flash_attention_bwd {k1_ms:.2f} ms, flash_attention {fwd_ms:.2f} ms, cuBLAS "
          f"matmuls {gemm_ms:.2f} ms; top ms: " + "; ".join(f"{n} {ms:.3f}" for n, ms in top))
    # the optimizer alone (plain torch elementwise ops over every leaf; its
    # time does not depend on the gradient's values)
    zeros = tree_map(torch.zeros_like, state["params"])
    with torch.no_grad():
        opt_s = [wall_s(lambda: adamw_update(state["params"], zeros, state["opt"],
                                             torch.tensor(REPEAT_LR, device=dev))) for _ in range(2)]
    print(f"  adamw_update alone: {min(opt_s) * 1e3:.2f} ms of the step ({n_params} params, f32 moments)")
    del zeros

    # 5f. the evaluation loop on the trained state
    eval_phase(model, state, step, batch, dev, rows, time_ms, bound, rand)
    del state, params, step
    torch.cuda.empty_cache()

    # 5c. one step's gradient of every leaf, kernels vs plain versions
    params = model.init(TRAIN["seed"], dev)
    small = {k: v[:GRAD_BATCH] for k, v in batch.items()}
    gradient_gate(f"{cfg.name}: one step's gradient at batch {GRAD_BATCH}", leaf_names(params),
                  lambda: grads_of(model, params, small, None), lambda: grads_of(model, params, small, plain),
                  want_launches(1))
    del params, batch, small, data
    torch.cuda.empty_cache()

    # 5d. the --fail-at-step drill (reduced, bf16): the restored checkpoint is
    # the state saved at that step, bit for bit, and the run goes on
    drill_dir = ROOT / "build" / "chip_smoke_drill"
    shutil.rmtree(drill_dir, ignore_errors=True)
    saved, restored = {}, []
    restore = ckpt_mod.CheckpointManager.restore

    def keeping_save_async(self, state, step, meta=None):
        saved[step] = {k: v.detach().cpu().clone() for k, v in ckpt_mod._flatten_with_paths(state).items()}
        return save_async(self, state, step, meta)

    def keeping_restore(self, like, step=None):
        st, manifest = restore(self, like, step)
        # a copy: the run goes on updating the restored state in place
        restored.append((manifest["step"], {k: v.clone() for k, v in ckpt_mod._flatten_with_paths(st).items()}))
        return st, manifest

    ckpt_mod.CheckpointManager.save_async, ckpt_mod.CheckpointManager.restore = keeping_save_async, keeping_restore
    try:
        state, out = run_main_captured(train.main, DRILL + ["--device", "cuda", "--ckpt-dir", str(drill_dir)])
    finally:
        ckpt_mod.CheckpointManager.save_async, ckpt_mod.CheckpointManager.restore = save_async, restore
    steps_run = [s for s, _ in step_losses(out)]
    if [s for s, _ in restored] != [2] or steps_run != [0, 1, 2, 2, 3, 4, 5] or int(state["step"]) != 6:
        fail(f"drill: restored {[s for s, _ in restored]}, steps {steps_run}, final step {int(state['step'])}")
    for line in ("[done] 6 steps; checkpoints: [2, 4, 6]", "[provenance] visitor log entries: 8"):
        if line not in out:
            fail(f"drill: no line {line!r}")
    back, kept = restored[0][1], saved[2]
    dtypes = sorted({str(t.dtype) for t in back.values()})
    bits = lambda t: t.view(torch.int16) if t.dtype == torch.bfloat16 else t
    differ = [k for k in kept if not (back[k].dtype == kept[k].dtype and back[k].device.type == dev.type
                                      and torch.equal(bits(back[k].cpu()), bits(kept[k])))]
    print(f"  drill: restored step 2, {len(back)} leaves ({dtypes}) bit-equal to the saved state: "
          f"{len(kept) - len(differ)} of {len(kept)}; steps run {steps_run}")
    if "torch.bfloat16" not in dtypes or sorted(back) != sorted(kept) or differ:
        fail(f"drill: restore not bit-equal for {differ[:5]} (dtypes {dtypes})")
    del state, saved, restored, back, kept
    shutil.rmtree(drill_dir, ignore_errors=True)
    torch.cuda.empty_cache()

    # 5e. K1 and the forward (with lse) at the training shape, timed as phase 4
    k1_timing(rand, check, check_grad, time_ms, bound, rows, main_launches, step_s)
    return step_s


# phase 5g: jamba-v0.1-52b trained at full width, cut to its first 2 of 32
# layers (mamba + dense FFN, mamba + MoE: ~3.74 B params, ~45 GB of bf16
# params and grads and f32 moments; all 32 layers cannot train on one 80 GB
# card), batch 4 x seq 1024: 4096 tokens > moe_exact_tokens, so capacity
# bins of C 640 with drops, the reference's training semantics; then one
# gated step of mixtral-8x7b cut to 1 layer (attention with window 4096 and
# MoE at E 8, C 1280)
TRAIN_HYBRID = dict(arch="jamba-v0.1-52b", n_layers=2, batch=4, seq=1024, steps=3, seed=0, lr=3e-4)
TRAIN_MIXTRAL = dict(arch="mixtral-8x7b", n_layers=1, batch=4, seq=1024, seed=0)
# mamba_scan_bwd's least FMA-pipe work a (b, t, d, n) element beside one
# exponential: the states recomputed (dt*A, a*h + dt*x*B: 3) and the reverse
# step (g = C*dy + carry, dx's and ddt's sums, dA, the dB and dC terms, the
# carry: 10)
SCAN_BWD_FMA_INSTRS = 13


def kernel_shares(kern) -> dict:
    """Device ms by kernel family of a profiled step (torch.profiler CUDA
    events): the port's kernels by their CUDA names, cuBLAS's matmuls, and the
    rest (PyTorch's elementwise and reduction kernels)."""
    fam = {"moe_gmm_bwd": ("wg::bwd_kernel", "bwd::tc::gemm_kernel", "bwd::ffma::gemm_kernel"),
           "mamba_scan_bwd": ("ckpt_ahead_kernel", "rev_chunk_kernel", "ckpt_kernel", "rev_kernel",
                              "reduce_bc_kernel", "reduce_a_kernel"),
           "moe_gmm": ("wg::gemm_kernel", "swap_ab_kernel", "gmm_kernel"),
           "mamba_scan": ("mamba_scan_kernel",),
           "flash_attention_bwd": ("dq_kernel", "dkdv_kernel", "dot_do_o"),
           "flash_attention": ("attn_kernel",)}
    out: dict = {}
    for e in kern:
        name = next((f for f, keys in fam.items() if any(k in e.name for k in keys)), None)
        if name is None:
            name = "cuBLAS matmuls" if ("nvjet" in e.name or "gemm" in e.name.lower()) else "other"
        out[name] = out.get(name, 0.0) + e.time_range.elapsed_us() / 1e3
    return out


def k7_part(name: str):
    """The part of a K7 call that a CUDA kernel name is: K7a's passes
    ("pass0" .. "pass4": ``wg::bwd_kernel<P>`` on wgmma; "pass1" ..
    "pass4": ``bwd::tc::gemm_kernel`` on mma by its epilogue, the last
    template argument), K7b's launches ("ckpt", "rev", "reduce_bc",
    "reduce_a", in either design); else None."""
    if m := re.search(r"wg::bwd_kernel<(\d)>", name):
        return f"pass{m[1]}"
    if m := re.search(r"bwd::tc::gemm_kernel<[^<>]*?(\d+)>", name):
        return f"pass{int(m[1]) + 1}"
    for part, keys in (("ckpt", ("ckpt_ahead_kernel", "ckpt_kernel")), ("rev", ("rev_chunk_kernel", "rev_kernel")),
                       ("reduce_bc", ("reduce_bc_kernel",)), ("reduce_a", ("reduce_a_kernel",))):
        if any(k in name for k in keys):
            return part
    return None


def k1_part(name: str):
    """The part of a K1 call that a CUDA kernel name is ("dot_do_o", "dq",
    "dkdv", on any route), else None."""
    return next((part for part in ("dot_do_o", "dq", "dkdv") if f"{part}_kernel" in name), None)


def launch_split(fn, parts, part_of):
    """Each launch's mean device ms over the calls of a 3-call window whose
    records the profiler kept (L2 warm), by ``part_of`` (a CUDA kernel name
    -> its part, or None): up to 5 windows, then null (the profiler has kept
    no record of the part in 5 windows in a row)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    split = dict.fromkeys(parts)
    for _ in range(5):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(3):
                fn()
            torch.cuda.synchronize()
            time.sleep(0.2)  # the device's records reach the profiler before it stops
        for part in parts:
            ms = [e.time_range.elapsed_us() / 1e3 for e in prof.events() if part_of(e.name) == part]
            if ms and split[part] is None:
                split[part] = statistics.mean(ms)
        if all(v is not None for v in split.values()):
            break
    return split


def hybrid_training_phase(dev, rand, check_grad, time_ms, bound, rows, plain, device_profile, n_sms, sm_clock_mhz):
    """Phase 5g: train jamba-v0.1-52b at full width (2 layers) through
    ``launch.train.run`` with exact launch counts of the four model kernels
    and their backward kernels, then on a repeated batch (the loss falls;
    step time, tokens/s, peak memory, each kernel's share of a profiled
    step); one step's gradient of every leaf against the plain versions on
    the kernels run's routing (``GRAD_REL_TOL``), for jamba and for mixtral
    (1 layer); K7a and K7b timed at jamba's training shapes. Returns the
    repeated batch's median step seconds."""
    import torch
    import torch.nn.functional as F

    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import build_data_pipeline, next_batch
    from repro_torch.dist.step import make_train_step
    import repro_torch.kernels.mamba_scan as scan_module
    import repro_torch.kernels.moe_gmm as gmm_module
    from repro_torch.kernels import ops, ref
    from repro_torch.kernels.mamba_scan import mamba_scan_bwd
    from repro_torch.kernels.moe_gmm import moe_gmm, moe_gmm_bwd
    from repro_torch.models import moe as moe_mod
    from repro_torch.models.registry import build_model
    from repro_torch.optim import adamw_init, adamw_update, constant_lr
    from repro_torch.optim.adamw import tree_leaves, tree_map

    def wall_s(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        return time.perf_counter() - t0

    spec = TRAIN_HYBRID
    cfg = dataclasses.replace(get_config(spec["arch"]), n_layers=spec["n_layers"])
    B, L = spec["batch"], spec["seq"]
    if cfg.remat != "block" or cfg.dtype != "bfloat16":
        fail(f"{cfg.name}: remat {cfg.remat!r}, dtype {cfg.dtype}: the counts below assume 'block', bf16")

    def per_step(c):
        """Launches a step under remat "block": each layer's forward kernels run
        in the forward pass and again when the backward pass recomputes the
        layer's period, its backward kernels once."""
        n = dict.fromkeys(ops.KERNELS, 0)
        for i in range(c.n_layers):
            s = c.layout[i % len(c.layout)]
            fwd, bwd = ("mamba_scan", "mamba_scan_bwd") if s.mixer == "mamba" else (
                "flash_attention", "flash_attention_bwd")
            n[fwd] += 2
            n[bwd] += 1
            if s.ffn == "moe":
                n["moe_gmm"] += 2
                n["moe_gmm_bwd"] += 1
        return n

    def times(n, k):
        return {name: v * k for name, v in n.items()}

    want1 = per_step(cfg)
    print(f"phase 5g: train {cfg.name} at full width, {cfg.n_layers} of 32 layers "
          f"({', '.join(f'{s.mixer} + {s.ffn}' for s in cfg.layout[: cfg.n_layers])}), bf16, batch {B}, seq {L}, "
          f"remat {cfg.remat!r}; launches a step {({k: v for k, v in want1.items() if v})}")
    t_phase = time.perf_counter()

    # 5g-a. launch.train.run, as a user runs a config built in code; the final
    # checkpoint (~45 GB with the f32 moments) is counted, not written
    want_main = times(want1, spec["steps"])
    n_moe_calls = want_main["moe_gmm"]
    want_routes = {"moe_gmm": {"fma": 0, "wgmma": n_moe_calls, "swap_ab": 0},
                   "moe_gmm_bwd": {"fma": 0, "mma": 0, "wgmma": want_main["moe_gmm_bwd"]},
                   "mamba_scan_bwd": {"chunked": want_main["mamba_scan_bwd"], "per_step": 0}}
    state = checked_train_run(
        cfg, dev, B, L, spec["steps"], spec["lr"], spec["seed"], want_main,
        lambda: {"moe_gmm": dict(moe_gmm.route_launches), "moe_gmm_bwd": dict(moe_gmm_bwd.route_launches),
                 "mamba_scan_bwd": dict(mamba_scan_bwd.route_launches)}, want_routes)
    main_launches = ops.launch_counts()
    n_params = sum(p.numel() for p in tree_leaves(state["params"]))
    del state
    torch.cuda.empty_cache()

    # 5g-b. make_train_step on one repeated batch: the loss falls; time, memory, shares
    model = build_model(cfg)
    params = model.init(spec["seed"], dev)
    state = {"params": params, "opt": adamw_init(params), "step": torch.zeros((), dtype=torch.int32, device=dev)}
    data = build_data_pipeline(cfg, B, L, seed=spec["seed"])
    batch = {k: torch.from_numpy(np.asarray(v, dtype=np.int32)).to(dev) for k, v in next_batch(data, cfg).items()}
    step = make_train_step(model, dev, constant_lr(REPEAT_LR), global_batch=B)
    state, step_s, peak = repeated_batch(cfg.name, step, state, batch, want1)
    print(f"  step time {step_s:.4f} s (median of steps 1-{TRAIN_REPEAT - 1}), {B * L / step_s:.1f} tokens/s, "
          f"peak memory {peak / 2**30:.2f} GiB")
    t, busy, kern, _ = device_profile(lambda: step(state, batch))
    shares = kernel_shares(kern)
    print(f"  profiled step: wall {t * 1e3:.2f} ms, device busy {busy * 1e3:.2f} ms (idle share {1 - busy / t:.3f}); "
          "device ms (share of busy): " + "; ".join(
              f"{n} {ms:.2f} ({ms / (busy * 1e3):.3f})" for n, ms in sorted(shares.items(), key=lambda kv: -kv[1])))
    # the optimizer alone, as phase 5b times stablelm's
    zeros = tree_map(torch.zeros_like, state["params"])
    with torch.no_grad():
        opt_s = [wall_s(lambda: adamw_update(state["params"], zeros, state["opt"],
                                             torch.tensor(REPEAT_LR, device=dev))) for _ in range(2)]
    print(f"  adamw_update alone: {min(opt_s) * 1e3:.2f} ms of the step ({n_params} params, f32 moments)")
    del state, params, step, zeros
    torch.cuda.empty_cache()

    # 5g-c. one step's gradient of every leaf, kernels vs plain versions on the
    # kernels run's routing: the plain run's own router picks the kernels run's
    # experts (its probabilities, renormalised over them, weight the slots), so
    # both dispatch the same slots and the gradients differ by arithmetic alone
    route = moe_mod.route

    def routed_gate(gcfg, label, gbatch):
        gmodel = build_model(gcfg)
        gparams = gmodel.init(spec["seed"], dev)
        chosen: list = []

        def recording_route(p, c, xf):
            out = route(p, c, xf)
            chosen.append(out[2])
            return out

        replay = iter(chosen)

        def forced_route(p, c, xf):
            probs, _, _ = route(p, c, xf)
            experts = next(replay)
            gate_w = probs.gather(1, experts)
            return probs, gate_w / gate_w.sum(-1, keepdim=True).clamp_min(1e-9), experts

        def routed(route_fn, kernels):
            moe_mod.route = route_fn
            try:
                return grads_of(gmodel, gparams, gbatch, kernels)
            finally:
                moe_mod.route = route

        gradient_gate(f"{label}: one step's gradient at batch {gbatch['tokens'].shape[0]} x "
                      f"{gbatch['tokens'].shape[1]} (the plain versions on the kernels' routing)",
                      leaf_names(gparams), lambda: routed(recording_route, None), lambda: routed(forced_route, plain),
                      per_step(gcfg))
        if next(replay, None) is not None:
            fail(f"{label} gradient gate: {len(chosen)} routings recorded, fewer replayed")
        del gparams
        torch.cuda.empty_cache()

    routed_gate(cfg, cfg.name, batch)
    mspec = TRAIN_MIXTRAL
    mcfg = dataclasses.replace(get_config(mspec["arch"]), n_layers=mspec["n_layers"])
    mdata = build_data_pipeline(mcfg, mspec["batch"], mspec["seq"], seed=mspec["seed"])
    mbatch = {k: torch.from_numpy(np.asarray(v, dtype=np.int32)).to(dev)
              for k, v in next_batch(mdata, mcfg).items()}
    routed_gate(mcfg, f"{mcfg.name} ({mcfg.n_layers} layer, window {mcfg.window})", mbatch)
    del batch, mbatch
    torch.cuda.empty_cache()
    print(f"  phase 5g's training and gradient gates: {time.perf_counter() - t_phase:.1f} s")

    # 5g-d. K7a and K7b at jamba's training shapes, timed as phase 4 (L2 flushed):
    # each on the design its wrapper picks and on its first design in turns
    # (new, old, old, new), and each launch's device time from the profiler
    def in_turns(call, baseline):
        """(new ms, baseline ms): the two designs timed new, old, old, new."""
        new = [time_ms(call, reps=10)]
        old = [time_ms(baseline, reps=10), time_ms(baseline, reps=10)]
        new.append(time_ms(call, reps=10))
        return new, old

    bf, es = torch.bfloat16, 2
    E, D, Fd = cfg.n_experts, cfg.d_model, cfg.d_ff
    C = moe_mod.expert_capacity(B * L, cfg)
    x, wg, wu, wd = (rand(E, C, D, dtype=bf), rand(E, D, Fd, dtype=bf, scale=D**-0.5),
                     rand(E, D, Fd, dtype=bf, scale=D**-0.5), rand(E, Fd, D, dtype=bf, scale=Fd**-0.5))
    dy = rand(E, C, D, dtype=bf, scale=D**-0.5)
    want = ref.reference_gmm_bwd(x, wg, wu, wd, dy)
    err = max(check_grad(f"moe_gmm_bwd {n} at {cfg.name} training (E{E} C{C})", g, w, bf)
              for n, g, w in zip(("dx", "dwg", "dwu", "dwd"), moe_gmm_bwd(x, wg, wu, wd, dy), want))
    del want
    torch.cuda.empty_cache()
    # x, dY and dX; Wg, Wu, Wd and their gradients: each read or written once
    b_ms, b_by = bound(3 * E * C * D * es + 6 * E * D * Fd * es, 16 * E * C * D * Fd, "bfloat16")

    def gmm_call():
        return moe_gmm_bwd(x, wg, wu, wd, dy)

    def gmm_old():
        return on_k7_baseline("moe_gmm_bwd", gmm_call)

    route = gmm_module._bwd_route(bf, D, Fd)
    new, old = in_turns(gmm_call, gmm_old)
    split = {route: launch_split(gmm_call, [f"pass{i}" for i in range(5)], k7_part),
             "mma": launch_split(gmm_old, [f"pass{i}" for i in range(1, 5)], k7_part)}
    leaves = [t.detach().requires_grad_() for t in (x, wg, wu, wd)]
    lib_out = torch.bmm(F.silu(torch.bmm(leaves[0], leaves[1])) * torch.bmm(leaves[0], leaves[2]), leaves[3])
    lib_ms = time_ms(lambda: torch.autograd.grad(lib_out, leaves, dy, retain_graph=True), reps=10)
    del lib_out
    ms = statistics.mean(new)
    rows.append(dict(
        name="moe_gmm_bwd", path=f"{cfg.name} training (E {E}, C {C}, D {D}, F {Fd}), bf16, route {route}",
        route="cuda", source="src/repro_torch/kernels/csrc/moe_gmm.cu",
        replaces="src/repro/models/moe.py:128 (no Pallas kernel: jax autodiff of the grouped SwiGLU einsums)",
        launches=main_launches["moe_gmm_bwd"], max_abs_err=err, ms=ms,
        plain_ms=time_ms(lambda: ref.reference_gmm_bwd(x, wg, wu, wd, dy), reps=3),
        bound_ms=b_ms, bound_by=b_by, library_ms=lib_ms,
        library="autograd backward of torch.bmm x3 + F.silu (torch.autograd.grad)",
        mma_ms=statistics.mean(old), pass_ms=split[route], mma_pass_ms=split["mma"],
    ))
    r = rows[-1]
    print(f"  moe_gmm_bwd at {r['path']}: {route} {new[0]:.4f}, {new[1]:.4f} ms; mma {old[0]:.4f}, {old[1]:.4f} ms "
          f"(in turns; mma {statistics.mean(old) / ms:.2f}x); bound {b_ms:.4f} ms ({b_by}; {ms / b_ms:.2f}x), "
          f"library {lib_ms:.4f} ms ({ms / lib_ms:.2f}x), plain {r['plain_ms']:.4f} ms; device ms by pass "
          f"(profiler, mean of the recorded calls of 3, L2 warm): {split}")
    if ms >= statistics.mean(old):
        fail(f"moe_gmm_bwd: {route} {ms:.4f} ms is not faster than mma {statistics.mean(old):.4f} ms")
    del x, wg, wu, wd, dy, leaves
    torch.cuda.empty_cache()

    Di, N = cfg.d_inner, cfg.ssm_state
    xc, dt = rand(B, L, Di, dtype=bf), rand(B, L, Di, dtype=torch.float32).abs() * 0.1
    Bm, Cm = rand(B, L, N, dtype=torch.float32), rand(B, L, N, dtype=torch.float32)
    a = -rand(Di, N, dtype=torch.float32).abs() - 0.1
    dys = rand(B, L, Di, dtype=torch.float32)
    want = ref.reference_selective_scan_bwd(xc, dt, Bm, Cm, a, None, dys)
    got = mamba_scan_bwd(xc, dt, Bm, Cm, a, None, dys)
    err = max(check_grad(f"mamba_scan_bwd {n} at {cfg.name} training ({B}, {L}, {Di}, {N})", g, w, g.dtype)
              for n, g, w in zip(("dxc", "ddt", "dB", "dC", "da", "dh0"), got, want))
    del want, got
    # xc, dt and dy read and dxc, ddt written once; B, C read and dB, dC written
    # once; a read and da, dh0 written once (training: no h0 and no dh_final)
    nbytes = B * L * Di * (es + 4 + 4 + es + 4) + 4 * B * L * N * 4 + 2 * Di * N * 4 + B * Di * N * 4
    n_el = B * L * Di * N
    fma_rate = PEAK_FLOPS["float32"] / 2
    sfu_rate = SFU_PER_CLOCK * n_sms * sm_clock_mhz * 1e6
    t_ops = max(SCAN_BWD_FMA_INSTRS * n_el / fma_rate,
                (SCAN_BWD_FMA_INSTRS + EXP_FMA_INSTRS) * n_el / (fma_rate + EXP_FMA_INSTRS * sfu_rate)) * 1e3
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3

    def scan_call():
        return mamba_scan_bwd(xc, dt, Bm, Cm, a, None, dys)

    def scan_old():
        return on_k7_baseline("mamba_scan_bwd", scan_call)

    design = scan_module._bwd_design()
    new, old = in_turns(scan_call, scan_old)
    parts = ("ckpt", "rev", "reduce_bc", "reduce_a")
    split = {design: launch_split(scan_call, parts, k7_part), "per_step": launch_split(scan_old, parts, k7_part)}
    ms = statistics.mean(new)
    rows.append(dict(
        name="mamba_scan_bwd", path=f"{cfg.name} training ({B}, {L}, {Di}, {N}), bf16 xc, design {design}",
        route="cuda", source="src/repro_torch/kernels/csrc/mamba_scan.cu",
        replaces="src/repro/models/mamba.py:71 (no Pallas kernel: jax autodiff of the chunked selective_scan)",
        launches=main_launches["mamba_scan_bwd"], max_abs_err=err, ms=ms,
        plain_ms=time_ms(lambda: ref.reference_selective_scan_bwd(xc, dt, Bm, Cm, a, None, dys), reps=2),
        bound_ms=max(t_ops, t_bytes), bound_by="bytes" if t_bytes >= t_ops else "operations",
        library_ms=None, library="none", per_step_ms=statistics.mean(old), launch_ms=split[design],
        per_step_launch_ms=split["per_step"],
    ))
    r = rows[-1]
    print(f"  mamba_scan_bwd at {r['path']}: {design} {new[0]:.4f}, {new[1]:.4f} ms; per_step {old[0]:.4f}, "
          f"{old[1]:.4f} ms (in turns; per_step {statistics.mean(old) / ms:.2f}x); bound {r['bound_ms']:.4f} ms "
          f"({r['bound_by']}; bytes {t_bytes:.4f} ms, operations {t_ops:.4f} ms; {ms / r['bound_ms']:.2f}x), plain "
          f"{r['plain_ms']:.4f} ms; device ms by launch (profiler, mean of the recorded calls of 3, L2 warm): "
          f"{split}")
    if ms >= statistics.mean(old):
        fail(f"mamba_scan_bwd: {design} {ms:.4f} ms is not faster than per_step {statistics.mean(old):.4f} ms")
    del xc, dt, Bm, Cm, a, dys
    torch.cuda.empty_cache()
    return step_s


# phase 5h: the three layouts that train since MLA, the encoder-decoder and
# the vision prefix got their gradient, each at full width and uncut, bf16,
# remat "block" (their configs'), batch x seq TRAIN_5H_SHAPE, launch.train.run
# for TRAIN["steps"] steps at TRAIN's seed and lr, as 5a: minicpm3-4b (62 layers,
# MLA at Dk 96 / Dv 64; 4.26 B params, ~48 GiB of bf16 params and grads and
# f32 moments), seamless-m4t-medium (12 encoder layers over 4096 stub frames a
# sample, 12 decoder layers with cross-attention), internvl2-1b (24 layers,
# gq 7, a prefix of 1024 stub embeddings before the 1024 tokens). The
# gradient gate runs each at full width, batch 2, and the depth of
# grad_layers (decoder, encoder). repeat_lr: the repeated batch's constant
# lr. At REPEAT_LR minicpm3-4b's 62 random layers overshoot at the fourth
# step (losses 11.5747, 10.0097, 9.7881, 9.8439), with its kernels and with
# the plain versions alike (tools/torch_train_probe.py --plain, seed 0, on an
# H100): Adam's first steps move every weight by ~lr whatever its gradient;
# at 1e-5 the loss falls at every step
TRAIN_5H_SHAPE = (4, 1024)
TRAIN_5H = [
    dict(arch="minicpm3-4b", repeat_lr=1e-5, grad_layers=(2, 0)),
    dict(arch="seamless-m4t-medium", repeat_lr=REPEAT_LR, grad_layers=(1, 1)),
    dict(arch="internvl2-1b", repeat_lr=REPEAT_LR, grad_layers=(2, 0)),
]


def attention_calls(cfg, B: int, L: int) -> list:
    """The attention calls of one training step of ``cfg`` at batch B x L
    tokens: [(label, (B, Lq, Lk, H, KVH, Dk, Dv, causal), calls a step)], each
    call one flash_attention_bwd launch and, under remat "block", two
    flash_attention launches. A vision prefix goes before the tokens; an
    encoder attends over its frames, cross-attention from the tokens to them."""
    H, T = cfg.n_heads_eff, cfg.frontend_len
    Lt = L + (T if cfg.frontend == "vision" else 0)
    if cfg.attention == "mla":
        self_shape = (B, Lt, Lt, H, H, cfg.qk_nope_dim + cfg.qk_rope_dim, cfg.v_head_dim, True)
    else:
        self_shape = (B, Lt, Lt, H, cfg.n_kv_heads, cfg.head_dim, cfg.head_dim, True)
    calls = [("self-attention", self_shape, cfg.n_layers)]
    if cfg.cross_attention:
        calls.append(("cross-attention", (B, Lt, T) + self_shape[3:7] + (False,), cfg.n_layers))
    if cfg.encoder_layers:
        calls.append(("encoder", (B, T, T) + self_shape[3:7] + (False,), cfg.encoder_layers))
    return calls


def attention_pairs(Lq: int, Lk: int, causal: bool) -> int:
    """(query, key) pairs a query sees: causal aligned at the top left, or all."""
    return sum(min(q + 1, Lk) for q in range(Lq)) if causal else Lq * Lk


def frontend_training_phase(dev, rand, check, check_grad, time_ms, bound, rows, plain, device_profile):
    """Phase 5h: train minicpm3-4b, seamless-m4t-medium and internvl2-1b at
    full width through ``launch.train.run`` (exact launches by kernel, route
    and input shape; no plain version), then each on a repeated batch (the
    loss falls; step time, tokens/s, MFU, peak memory, kernel shares), one
    step's gradient of every leaf against the plain versions at a reduced
    depth (``GRAD_REL_TOL``), and K1 timed at each of its training shapes."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import build_data_pipeline, next_batch
    from repro_torch.dist.step import make_train_step
    from repro_torch.kernels import ops
    from repro_torch.kernels.flash_attention import flash_attention, flash_attention_bwd
    from repro_torch.launch import train
    from repro_torch.models.registry import build_model
    from repro_torch.optim import adamw_init, constant_lr
    from repro_torch.optim.adamw import tree_leaves

    t_phase = time.perf_counter()
    B, L = TRAIN_5H_SHAPE
    for spec in TRAIN_5H:
        cfg = get_config(spec["arch"])
        if cfg.remat != "block" or cfg.dtype != "bfloat16":
            fail(f"{cfg.name}: remat {cfg.remat!r}, dtype {cfg.dtype}: the counts below assume 'block', bf16")
        calls = attention_calls(cfg, B, L)
        n_calls = sum(n for _, _, n in calls)
        per_step = dict.fromkeys(ops.KERNELS, 0)
        per_step.update(flash_attention=2 * n_calls, flash_attention_bwd=n_calls)
        frontend = (f", {cfg.encoder_layers} encoder layers over {cfg.frontend_len} stub frames a sample"
                    if cfg.encoder_layers else
                    f", a prefix of {cfg.frontend_len} stub embeddings" if cfg.frontend == "vision" else "")
        print(f"phase 5h: train {cfg.name} at full width, uncut ({cfg.n_layers} layers{frontend}), bf16, batch {B}, "
              f"seq {L}, remat {cfg.remat!r}; attention calls a step "
              + "; ".join(f"{label} {shape} x{n}" for label, shape, n in calls))

        # 5h-a. launch.train.run, the backward's calls counted by input shapes
        n_steps, by_shape = TRAIN["steps"], {}

        def counted_bwd(q, k, v, *args, **kwargs):
            key = (tuple(q.shape), tuple(k.shape), tuple(v.shape), kwargs.get("causal", True))
            by_shape[key] = by_shape.get(key, 0) + 1
            return flash_attention_bwd(q, k, v, *args, **kwargs)

        def shape_key(shape):
            b, lq, lk, h, kvh, dk, dv, causal = shape
            return (b, lq, h, dk), (b, lk, kvh, dk), (b, lk, kvh, dv), causal

        want_main = {k: v * n_steps for k, v in per_step.items()}
        state = checked_train_run(
            cfg, dev, B, L, n_steps, TRAIN["lr"], TRAIN["seed"], want_main,
            lambda: {"flash_attention": dict(flash_attention.route_launches),
                     "flash_attention_bwd": dict(flash_attention_bwd.route_launches)},
            {"flash_attention": {"fma": 0, "mma": want_main["flash_attention"]},
             "flash_attention_bwd": {"fma": 0, "mma": 0, "wgmma": want_main["flash_attention_bwd"]}},
            spies={"flash_attention_bwd": counted_bwd})
        want_shapes = {shape_key(shape): n * n_steps for _, shape, n in calls}
        print(f"  backward calls by input shapes {by_shape}")
        if by_shape != want_shapes:
            fail(f"train.run {cfg.name}: backward calls by shapes {by_shape}, want {want_shapes}")
        n_params = sum(p.numel() for p in tree_leaves(state["params"]))
        n_enc = sum(p.numel() for p in tree_leaves(state["params"].get("encoder", {})))
        del state
        torch.cuda.empty_cache()

        # 5h-b. make_train_step on one repeated batch (the data circuit's
        # tokens, the stub frames or prefix run draws at step 0)
        model = build_model(cfg)
        params = model.init(TRAIN["seed"], dev)
        state = {"params": params, "opt": adamw_init(params), "step": torch.zeros((), dtype=torch.int32, device=dev)}
        data = build_data_pipeline(cfg, B, L, seed=TRAIN["seed"])
        batch = {k: torch.from_numpy(np.asarray(v, dtype=np.int32)).to(dev) for k, v in next_batch(data, cfg).items()}
        if cfg.encoder_layers:
            batch["frames"] = train._stub_embeddings(cfg, B, 0, dev)
        if cfg.frontend == "vision":
            batch["prefix"] = train._stub_embeddings(cfg, B, 0, dev)
        step = make_train_step(model, dev, constant_lr(spec["repeat_lr"]), global_batch=B)
        state, step_s, peak = repeated_batch(cfg.name, step, state, batch, per_step)
        positions = B * (L + (cfg.frontend_len if cfg.frontend == "vision" else 0))
        frames = B * cfg.frontend_len if cfg.encoder_layers else 0
        # 6 N a position: the encoder's params see the frames, the rest the decoder's positions
        dense = 6 * ((n_params - n_enc) * positions + n_enc * frames)
        attn_flops = sum(n * 6 * b * h * attention_pairs(lq, lk, c) * (dk + dv)
                         for _, (b, lq, lk, h, kvh, dk, dv, c), n in calls)  # forward and backward, 3x the forward
        peak_flops = PEAK_FLOPS["bfloat16"]
        print(f"  step time {step_s:.4f} s (median of steps 1-{TRAIN_REPEAT - 1}), {positions / step_s:.1f} tokens/s "
              f"({positions} decoder positions a step" + (f", {frames} encoder frames" if frames else "") + "), "
              f"MFU {dense / step_s / peak_flops:.4f} at 6 N tokens ({dense:.4e} FLOP, N = {n_params}"
              + (f", {n_enc} of them the encoder's, counted at its frames" if n_enc else "")
              + f"); attention's own {attn_flops:.4e} FLOP (3x its forward), MFU with it "
              f"{(dense + attn_flops) / step_s / peak_flops:.4f}; peak memory {peak / 2**30:.2f} GiB")
        t, busy, kern, _ = device_profile(lambda: step(state, batch))
        shares = kernel_shares(kern)
        print(f"  profiled step: wall {t * 1e3:.2f} ms, device busy {busy * 1e3:.2f} ms (idle share "
              f"{1 - busy / t:.3f}); device ms (share of busy): " + "; ".join(
                  f"{n} {ms:.2f} ({ms / (busy * 1e3):.3f})" for n, ms in sorted(shares.items(), key=lambda kv: -kv[1])))
        del state, params, step, model
        torch.cuda.empty_cache()

        # 5h-c. one step's gradient of every leaf, kernels vs plain versions, at
        # full width, batch 2 and a reduced depth
        n_dec, n_enc_layers = spec["grad_layers"]
        gcfg = dataclasses.replace(cfg, n_layers=n_dec, encoder_layers=n_enc_layers if cfg.encoder_layers else 0)
        gmodel = build_model(gcfg)
        gparams = gmodel.init(TRAIN["seed"], dev)
        small = {k: v[:GRAD_BATCH] for k, v in batch.items()}
        gcalls = sum(n for _, _, n in attention_calls(gcfg, GRAD_BATCH, L))
        want1 = dict.fromkeys(ops.KERNELS, 0)
        want1.update(flash_attention=2 * gcalls, flash_attention_bwd=gcalls)
        depth = f"{n_dec} layer{'s' * (n_dec > 1)}" + (f" + {n_enc_layers} encoder" if gcfg.encoder_layers else "")
        gradient_gate(f"{cfg.name}: one step's gradient at batch {GRAD_BATCH}, {depth}", leaf_names(gparams),
                      lambda: grads_of(gmodel, gparams, small, None), lambda: grads_of(gmodel, gparams, small, plain),
                      want1)
        del gparams, gmodel, batch, small, data
        torch.cuda.empty_cache()

        # 5h-d. K1 at each of the step's attention shapes, timed as phase 5e
        for label, shape, _ in calls:
            k1_row(f"{cfg.name} training {label}", shape, by_shape.get(shape_key(shape), 0), rand, check, check_grad,
                   time_ms, bound, rows)
    print(f"  phase 5h: {time.perf_counter() - t_phase:.1f} s")


def k1_row(label, shape, n_main, rand, check, check_grad, time_ms, bound, rows, with_mma=False):
    """K1 at one training shape (B, Lq, Lk, H, KVH, Dk, Dv, causal), bf16: the
    forward's o and lse there against the plain forward's, the backward
    against the plain backward on the route it takes, timed as phase 4 (L2
    flushed) beside its bound, its plain version and SDPA's backward where
    SDPA takes the shape; each launch's device time from the profiler (dq,
    dkdv). ``with_mma``: also on the mma route, in turns (own, mma, mma,
    own). ``n_main``: its launches on the main path. Returns its ms."""
    import torch
    import torch.nn.functional as F

    import repro_torch.kernels.flash_attention as fa_module
    from repro_torch.kernels import ref
    from repro_torch.kernels.flash_attention import flash_attention, flash_attention_bwd

    B, Lq, Lk, H, KVH, Dk, Dv, causal = shape
    bf, es = torch.bfloat16, 2
    q, do = rand(B, Lq, H, Dk, dtype=bf), rand(B, Lq, H, Dv, dtype=bf)
    k, v = rand(B, Lk, KVH, Dk, dtype=bf), rand(B, Lk, KVH, Dv, dtype=bf)
    o, lse = flash_attention(q, k, v, causal=causal, return_lse=True)
    name = f"({B}, {Lq} x {Lk}, {H}/{KVH}, {Dk}/{Dv}, {'causal' if causal else 'non-causal'})"
    ro, rl = ref.reference_attention(q, k, v, causal=causal, return_lse=True)
    check(f"flash_attention lse at {label} {name}", lse, rl, torch.float32)
    check(f"flash_attention o at {label} {name}", o, ro, bf)
    want = ref.reference_attention_bwd(q, k, v, o, do, rl, causal=causal)
    del ro, rl
    err = max(check_grad(f"flash_attention_bwd {n} at {label} {name}", g, w, bf)
              for n, g, w in zip(("dq", "dk", "dv"), flash_attention_bwd(q, k, v, o, do, lse, causal=causal), want))
    del want
    torch.cuda.empty_cache()
    pairs = attention_pairs(Lq, Lk, causal)
    # q, dq, o and dO; k, dk, v and dv; lse: each read or written once. The five
    # products Q.K^T, dO.V^T, P^T.dO, dS.K, dS^T.Q: 6 Dk + 4 Dv FLOP a visible pair
    nbytes = B * Lq * H * (2 * Dk + 2 * Dv) * es + B * Lk * KVH * (2 * Dk + 2 * Dv) * es + B * H * Lq * 4
    b_ms, b_by = bound(nbytes, B * H * pairs * (6 * Dk + 4 * Dv), "bfloat16")

    def call():
        return flash_attention_bwd(q, k, v, o, do, lse, causal=causal)

    def on_mma():
        return on_bwd_route("mma", call)

    own = [time_ms(call, reps=10)]
    mma = [time_ms(on_mma, reps=10), time_ms(on_mma, reps=10)] if with_mma else []
    own.append(time_ms(call, reps=10))
    qt, kt, vt = (x.transpose(1, 2).detach().requires_grad_() for x in (q, k, v))
    dot = do.transpose(1, 2)
    try:  # the yardstick only: a shape SDPA does not take has no library time
        lib_out = F.scaled_dot_product_attention(qt, kt, vt, is_causal=causal, enable_gqa=H != KVH)
        lib_ms = time_ms(lambda: torch.autograd.grad(lib_out, (qt, kt, vt), dot, retain_graph=True), reps=10)
        library = "scaled_dot_product_attention backward (torch.autograd.grad)"
        del lib_out
    except RuntimeError as e:
        lib_ms, library = None, f"none (SDPA: {str(e).splitlines()[0][:80]})"
    plain_ms = time_ms(lambda: ref.reference_attention_bwd(q, k, v, o, do, lse, causal=causal), reps=3)
    torch.cuda.empty_cache()
    split = launch_split(call, ("dq", "dkdv"), k1_part)
    ms = statistics.mean(own)
    route = fa_module._bwd_route(bf, Dk, Dv)
    rows.append(dict(
        name="flash_attention_bwd", path=f"{label} {name}, bf16, route {route}", route="cuda",
        source="src/repro_torch/kernels/csrc/flash_attention_bwd.cu",
        replaces="src/repro/models/attention.py:48 (no Pallas kernel: jax autodiff of blocked_attention)",
        launches=n_main, max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
        library_ms=lib_ms, library=library, dq_ms=split["dq"], dkdv_ms=split["dkdv"],
    ))
    lib = "none" if lib_ms is None else f"{lib_ms:.4f} ms ({ms / lib_ms:.2f}x)"
    turns = ""
    if with_mma:
        mma_split = launch_split(on_mma, ("dot_do_o", "dq", "dkdv"), k1_part)
        rows[-1].update(mma_ms=statistics.mean(mma), mma_split_ms=mma_split)
        turns = (f"; mma {mma[0]:.4f}, {mma[1]:.4f} ms (in turns; {statistics.mean(mma) / ms:.2f}x), device time by "
                 f"launch {mma_split}")
    print(f"  flash_attention_bwd at {label} {name}: {route} {own[0]:.4f}, {own[1]:.4f} ms{turns}; bound "
          f"{b_ms:.4f} ms ({b_by}; {ms / b_ms:.2f}x); SDPA's backward {lib}; plain {plain_ms:.4f} ms; device time by "
          f"launch (profiler, mean of the recorded calls of 3, L2 warm): {split}; {n_main} launches on the main path")
    del q, k, v, do, o, lse, qt, kt, vt, dot
    torch.cuda.empty_cache()
    return ms


# phase 5f: the eval circuit's frozen batch (rows x seq), made from this seed
EVAL = dict(batch=4, seq=2048, seed=5)


def map_tensors(fn, tree):
    """``fn`` of every tensor of a tree of dicts, lists and tuples, each
    container rebuilt in its own order (a dict's order is in its pickle)."""
    import torch

    if isinstance(tree, dict):
        return {k: map_tensors(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(map_tensors(fn, v) for v in tree)
    return fn(tree) if isinstance(tree, torch.Tensor) else tree


def eval_phase(model, state, step, batch, dev, rows, time_ms, bound, rand):
    """Phase 5f: ``EvalLoop`` over the trained state at full width. The eval
    function is the forward loss under ``no_grad`` on a frozen batch, through
    ``flash_attention``; the checkpoint ``{"params", "step"}`` digests in the
    pickle tier. Publish and report: one eval; republish unchanged: a memo
    hit with no launch; one more train step, publish and report: a
    recompute."""
    import torch
    import torch.nn.functional as F

    from repro_torch.core import EvalLoop, build_eval_circuit, content_hash
    from repro_torch.data.pipeline import build_data_pipeline, next_batch
    from repro_torch.kernels import ops, ref
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.models.registry import train_loss
    from repro_torch.optim.adamw import tree_leaves

    cfg = model.cfg
    B, L = EVAL["batch"], EVAL["seq"]
    data = build_data_pipeline(cfg, B, L, seed=EVAL["seed"])
    eval_batch = {k: torch.from_numpy(np.asarray(v, dtype=np.int32)).to(dev) for k, v in next_batch(data, cfg).items()}

    def eval_fn(params, b):
        with torch.no_grad():
            loss, _ = train_loss(model, params, b)
        return {"loss": float(loss)}

    def wall_s(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, time.perf_counter() - t0

    loop = EvalLoop(build_eval_circuit(eval_fn, eval_batch))
    n_bytes = sum(p.numel() * p.element_size() for p in tree_leaves(state["params"]))
    print(f"phase 5f: the evaluation loop on {cfg.name}'s trained state ({n_bytes / 2**30:.2f} GiB of params), "
          f"a frozen {B} x {L} batch")
    ckpt = {"params": state["params"], "step": int(state["step"])}
    digest, hash_s = wall_s(lambda: content_hash(ckpt))
    # the pickle tier digests tensors by value: the same dict copied to the
    # host, and cloned on the card, digests alike
    host_ckpt = {"params": map_tensors(lambda t: t.cpu(), state["params"]), "step": ckpt["step"]}
    host_digest, host_s = wall_s(lambda: content_hash(host_ckpt))
    del host_ckpt
    clone_ckpt = {"params": map_tensors(torch.clone, state["params"]), "step": ckpt["step"]}
    clone_digest, clone_s = wall_s(lambda: content_hash(clone_ckpt))
    del clone_ckpt
    print(f"  checkpoint digest (pickle tier, tensors by value) {hash_s:.3f} s; the dict copied to the host "
          f"digests alike {host_digest == digest} ({host_s:.3f} s), cloned on the card alike {clone_digest == digest} "
          f"({clone_s:.3f} s)")
    if host_digest != digest or clone_digest != digest:
        fail(f"eval loop: the checkpoint digests {digest}, its host copy {host_digest}, its clone {clone_digest}")
    want = {**dict.fromkeys(ops.KERNELS, 0), "flash_attention": cfg.n_layers}
    none = dict.fromkeys(ops.KERNELS, 0)
    seen = []
    for label, train_first, want_launches, want_counts in (
            ("publish, report", False, want, (1, 0)),
            ("republish unchanged, report", False, none, (1, 1)),
            ("one more train step, publish, report", True, want, (2, 1))):
        if train_first:
            step(state, batch)
            torch.cuda.synchronize()
        s_step = int(state["step"])
        ops.reset_launch_counts()
        with PlainSpy() as spy:
            _, pub_s = wall_s(lambda: loop.publish(state["params"], step=s_step))
            report, rep_s = wall_s(loop.report)
        launches = ops.launch_counts()
        counts = (loop.evals_run, loop.cache_hits)
        seen.append(report)
        print(f"  {label}: publish {pub_s:.3f} s, report {rep_s:.3f} s; evals_run {counts[0]}, cache_hits "
              f"{counts[1]}; launches {launches}; report {report}")
        if launches != want_launches or counts != want_counts or any(spy.calls.values()):
            fail(f"eval loop, {label}: launches {launches} (want {want_launches}), (evals_run, cache_hits) "
                 f"{counts} (want {want_counts}), plain calls {spy.calls}")
        if not np.isfinite(report["loss"]) or report["step"] != s_step:
            fail(f"eval loop, {label}: report {report}")
    chash = loop.manager.registry.get_av(loop.manager.registry.all_avs()[0]).chash
    print(f"  checkpoint digest (pickle tier) {hash_s:.3f} s, {n_bytes / hash_s / 1e9:.2f} GB/s of params; equal to "
          f"the first publish's {digest == chash}; hit report equal to the eval's {seen[1] == seen[0]}; after a "
          f"step loss {seen[0]['loss']:.6f} -> {seen[2]['loss']:.6f}")
    if digest != chash or seen[1] != seen[0] or seen[2]["loss"] == seen[0]["loss"]:
        fail(f"eval loop: digest twice {digest} / {chash}, hit report {seen[1]} vs {seen[0]}, after a step {seen[2]}")
    del ckpt, data, eval_batch

    # flash_attention at the eval forward's shape
    H, Dh, bf, es = cfg.n_heads, cfg.head_dim, torch.bfloat16, 2
    q, k, v = (rand(B, L, H, Dh, dtype=bf) for _ in range(3))
    o, want_o = flash_attention(q, k, v), ref.reference_attention(q, k, v)
    err = (o.float() - want_o.float()).abs()
    rtol, atol = TOL["bfloat16"]
    if not torch.isfinite(o.float()).all() or (err > atol + rtol * want_o.float().abs()).any():
        fail(f"flash_attention at the eval shape: max_abs_err {err.max().item()}")
    print(f"  flash_attention at the eval shape ({B}, {L}, {H}, {Dh}): max_abs_err {err.max().item():.3e} (ok)")
    pairs = L * (L + 1) // 2
    qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
    b_ms, b_by = bound(4 * B * L * H * Dh * es, 4 * B * H * Dh * pairs, "bfloat16")
    rows.append(dict(
        name="flash_attention", path=f"{cfg.name} eval forward ({B} x {L}), route mma", route="cuda",
        source="src/repro_torch/kernels/csrc/flash_attention.cu",
        replaces="src/repro/kernels/flash_attention.py:116", launches=2 * cfg.n_layers,
        max_abs_err=err.max().item(),
        ms=time_ms(lambda: flash_attention(q, k, v), reps=10),
        plain_ms=time_ms(lambda: ref.reference_attention(q, k, v), reps=3),
        bound_ms=b_ms, bound_by=b_by,
        library_ms=time_ms(lambda: F.scaled_dot_product_attention(qt, kt, vt, is_causal=True), reps=10),
        library="scaled_dot_product_attention(is_causal=True)",
    ))
    del q, k, v, o, want_o, err, qt, kt, vt
    torch.cuda.empty_cache()


def k1_timing(rand, check, check_grad, time_ms, bound, rows, launches, step_s):
    """Phase 5e: the forward with lse at stablelm-1.6b's training shape,
    checked and timed as phase 4 (L2 flushed) beside its bound, its plain
    version and SDPA; K1 there and at qwen2.5-32b's heads (``K1_QWEN``: Dh
    128, gq 5) by ``k1_row``, also on mma in turns. ``launches``: the main
    path's counts by kernel; the qwen2.5 row, a shape the main path does not
    run, has 0."""
    import torch
    import torch.nn.functional as F

    from repro_torch.configs import get_config
    from repro_torch.kernels import ref
    from repro_torch.kernels.flash_attention import flash_attention

    cfg = get_config(TRAIN["arch"])
    B, L, H, Dh, bf, es = TRAIN["batch"], TRAIN["seq"], cfg.n_heads, cfg.head_dim, torch.bfloat16, 2
    q, k, v = (rand(B, L, H, Dh, dtype=bf) for _ in range(3))
    o, lse = flash_attention(q, k, v, return_lse=True)
    ro, rl = ref.reference_attention(q, k, v, return_lse=True)
    fwd_err = max(check(f"flash_attention lse at {cfg.name} training", lse, rl, torch.float32),
                  check(f"flash_attention o at {cfg.name} training", o, ro, bf))
    del ro, rl
    pairs = L * (L + 1) // 2  # causal (q, k) pairs
    qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
    b_ms, b_by = bound(4 * B * L * H * Dh * es + B * H * L * 4, 4 * B * H * Dh * pairs, "bfloat16")
    rows.append(dict(
        name="flash_attention", path=f"{cfg.name} training ({B} x {L}), with lse, route mma", route="cuda",
        source="src/repro_torch/kernels/csrc/flash_attention.cu",
        replaces="src/repro/kernels/flash_attention.py:116", launches=launches["flash_attention"],
        max_abs_err=fwd_err,
        ms=time_ms(lambda: flash_attention(q, k, v, return_lse=True), reps=10),
        plain_ms=time_ms(lambda: ref.reference_attention(q, k, v, return_lse=True), reps=3),
        bound_ms=b_ms, bound_by=b_by,
        library_ms=time_ms(lambda: F.scaled_dot_product_attention(qt, kt, vt, is_causal=True), reps=10),
        library="scaled_dot_product_attention(is_causal=True)",
    ))
    del q, k, v, o, lse, qt, kt, vt
    torch.cuda.empty_cache()

    ms = k1_row(f"{cfg.name} training", (B, L, L, H, cfg.n_kv_heads, Dh, Dh, True), launches["flash_attention_bwd"],
                rand, check, check_grad, time_ms, bound, rows, with_mma=True)
    print(f"  {cfg.n_layers} a step: {cfg.n_layers * ms:.1f} ms of the {step_s * 1e3:.1f} ms step")
    B, L, H, KVH, Dh = K1_QWEN
    k1_row("qwen2.5-32b heads, not on the main path", (B, L, L, H, KVH, Dh, Dh, True), 0, rand, check, check_grad,
           time_ms, bound, rows, with_mma=True)


# phase 6: the train step on a DeviceMesh. 6a: one rank (NCCL, its own
# card), make_host_mesh() = (data 1, model 1), stablelm-1.6b at phase 5b's
# repeated batch: losses and params bit-equal to the device path's. 6b: two
# ranks sharing the card (gloo: NCCL refuses two ranks on one GPU), spawned,
# on (data 1, model 2) and (data 2, model 1) with FSDP, stablelm-1.6b uncut
# and jamba-v0.1-52b at full width cut to its first 2 of 32 layers (as 5g),
# each on the data circuit's first batch of MESH's batch x seq: every rank's
# loss at every step, and the params and first moments after the last step,
# gathered, within GRAD_REL_TOL (phase 5's gradient gate; the first moment is
# a sum of gradients) of the one-device step's on the same batch, with every
# kernel launched at the local shapes. 6c: each kernel at those shapes.
MESH = dict(batch=2, seq=1024, steps=2, seed=0, shapes=((1, 2), (2, 1)), world=2, one_rank_steps=3)
MESH_TIMEOUT = 900  # s, the spawned ranks' whole run; each collective 600 s
MESH_KERNELS = ("flash_attention", "flash_attention_bwd", "moe_gmm", "moe_gmm_bwd", "mamba_scan", "mamba_scan_bwd")


def mesh_models() -> list:
    from repro_torch.configs import get_config

    return [get_config(TRAIN["arch"]), dataclasses.replace(get_config(HYBRID["arch"]), n_layers=2)]


def mesh_expect(cfg, shape) -> dict:
    """kernel -> (launches a step, its first input's shape) on one rank of a
    (data, model) mesh: the model's heads, experts and Mamba channels split
    over model, the batch rows over data (remat "block": each forward twice
    a layer, each backward once)."""
    from repro_torch.models import moe as moe_mod

    data, model = shape
    B, L = MESH["batch"], MESH["seq"]
    specs = [cfg.layout[i % len(cfg.layout)] for i in range(cfg.n_layers)]
    out = {}
    n = sum(s.mixer == "attention" for s in specs)
    if n:
        q = (B // data, L, cfg.n_heads // model, cfg.head_dim)
        out.update(flash_attention=(2 * n, q), flash_attention_bwd=(n, q))
    n = sum(s.mixer == "mamba" for s in specs)
    if n:
        xc = (B // data, L, cfg.d_inner // model)
        out.update(mamba_scan=(2 * n, xc), mamba_scan_bwd=(n, xc))
    n = sum(s.ffn == "moe" for s in specs)
    if n:
        C = moe_mod.expert_capacity(B * L, cfg)
        x = (cfg.n_experts // model, C if data == 1 else min(C, B * L // data), cfg.d_model)
        out.update(moe_gmm=(2 * n, x), moe_gmm_bwd=(n, x))
    return out


def mesh_batch(cfg, dev) -> dict:
    import torch

    from repro_torch.data.pipeline import build_data_pipeline, next_batch

    data = build_data_pipeline(cfg, MESH["batch"], MESH["seq"], seed=MESH["seed"])
    return {k: torch.from_numpy(np.asarray(v, dtype=np.int32)).to(dev) for k, v in next_batch(data, cfg).items()}


def fresh_train_state(model, seed, dev) -> dict:
    import torch

    from repro_torch.optim import adamw_init

    params = model.init(seed, dev)
    return {"params": params, "opt": adamw_init(params), "step": torch.zeros((), dtype=torch.int32, device=dev)}


def fsdp_gather_bound(cfg, params) -> int:
    """The most FSDP may hold gathered at once a rank under remat "block"
    (phase 6b's runs): the leaves outside the trunk and the largest unit of
    the trunk (``dist.step.fsdp_units``), each leaf's bytes gathered over the
    data axes its placements split it on."""
    from torch.distributed.tensor import Shard

    from repro_torch.dist.step import fsdp_units
    from repro_torch.optim.adamw import tree_leaves

    def gathered(tree) -> int:
        n = 0
        for t in tree_leaves(tree):
            mesh, k = t.device_mesh, 1
            for name, pl in zip(mesh.mesh_dim_names, t.placements):
                if isinstance(pl, Shard) and name in ("pod", "data"):
                    k *= mesh.size(mesh.mesh_dim_names.index(name))
            n += t.to_local().nbytes * k if k > 1 else 0
        return n

    outside, units = fsdp_units(cfg, params)
    return gathered(outside) + max(gathered(u) for u in units)


def mesh_rank(rank: int, world: int) -> list:
    """Phase 6b on one of the ranks sharing the card (``dist.spawn
    .run_ranks``): per model, rank 0 first runs the one-device step alone on
    the card and keeps its losses, params and first moments on the host; then
    every rank runs the sharded step on each mesh, its kernels spied for their
    input shapes (``ops.KERNELS``, zeroed counts, no plain version), and the
    placed params and moments are gathered leaf by leaf and held against rank
    0's copies there. An MoE model's sharded runs replay the one-device run's
    expert choice (each rank its own tokens' rows), as phase 5g's gate
    replays the kernels run's: near-tied top-2 routings flip between any two
    bf16 runs. Returns a record per (model, mesh)."""
    import torch
    import torch.distributed as dist

    from repro_torch.dist.comm import track_gathers
    from repro_torch.dist.step import gather_full, make_train_step, placed_train_state
    from repro_torch.kernels import ops
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import moe as moe_mod
    from repro_torch.models.common import parallel
    from repro_torch.models.registry import build_model
    from repro_torch.optim import constant_lr
    from repro_torch.optim.adamw import tree_leaves

    os.environ.setdefault("PYTORCH_CUDA_ALLOC_CONF", "expandable_segments:True")  # two ranks share the card
    torch.cuda.set_device(0)
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0)
    B, steps = MESH["batch"], MESH["steps"]
    route = moe_mod.route
    out = []
    for cfg in mesh_models():
        model = build_model(cfg)
        batch = mesh_batch(cfg, dev)
        ref, chosen = None, []

        def recording_route(p, c, xf):
            probs, gate_w, gate_e = route(p, c, xf)
            chosen.append(gate_e.cpu())
            return probs, gate_w, gate_e

        if rank == 0:  # alone on the card: the other rank waits at the barrier
            step = make_train_step(model, dev, constant_lr(REPEAT_LR), global_batch=B)
            state = fresh_train_state(model, MESH["seed"], dev)
            losses = []
            moe_mod.route = recording_route
            try:
                for _ in range(steps):
                    state, met = step(state, batch)
                    losses.append(met["loss"].item())
            finally:
                moe_mod.route = route
            ref = {"losses": losses, "params": [t.cpu() for t in tree_leaves(state["params"])],
                   "m": [t.cpu() for t in tree_leaves(state["opt"]["m"])],
                   "peak": torch.cuda.max_memory_allocated()}
            del state, step, met
            torch.cuda.empty_cache()
        box = [chosen]
        dist.broadcast_object_list(box, src=0)  # the expert choice of every MoE call, in call order
        chosen = box[0]
        names = leaf_names(model.init(MESH["seed"], "meta"))
        for shape in MESH["shapes"]:
            mesh = make_host_mesh(model=shape[1], device="cuda")
            step, _, shard, _ = make_train_step(model, mesh, constant_lr(REPEAT_LR), global_batch=B)
            state = placed_train_state(model.init(MESH["seed"], dev), shard, mesh)
            replay = iter(chosen)

            def forced_route(p, c, xf):
                probs, _, _ = route(p, c, xf)
                par, T = parallel(), xf.shape[0]
                experts = next(replay)[par.dp_rank * T : (par.dp_rank + 1) * T].to(xf.device)
                gate_w = probs.gather(1, experts)
                return probs, gate_w / gate_w.sum(-1, keepdim=True).clamp_min(1e-9), experts
            torch.cuda.empty_cache()
            placed = torch.cuda.memory_allocated()
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            seen: dict = {}
            ops.reset_launch_counts()  # before the spies stand in for the wrappers, whose counts it zeroes
            kept = dict(ops.KERNELS)
            for name in MESH_KERNELS:
                def spy(*args, _fn=kept[name], _name=name, **kwargs):
                    seen.setdefault(_name, set()).add(tuple(args[0].shape))
                    return _fn(*args, **kwargs)

                ops.KERNELS[name] = spy
            losses, times = [], []
            moe_mod.route = forced_route
            try:
                with PlainSpy() as spy_plain, track_gathers(("pod", "data")) as gathered:
                    for _ in range(steps):
                        torch.cuda.synchronize()
                        t0 = time.perf_counter()
                        state, met = step(state, batch)
                        losses.append(met["loss"].item())
                        times.append(time.perf_counter() - t0)
            finally:
                ops.KERNELS.update(kept)
                moe_mod.route = route
            if next(replay, None) is not None:
                fail(f"phase 6b {cfg.name} {shape}: {len(chosen)} routings recorded, fewer replayed")
            launches = ops.launch_counts()
            peak = torch.cuda.max_memory_allocated()
            gathered_bound = fsdp_gather_bound(cfg, state["params"])
            gaps: dict = {"params": [], "m": []}
            for part, sub in (("params", state["params"]), ("m", state["opt"]["m"])):
                for i, t in enumerate(tree_leaves(sub)):
                    full = gather_full(t)
                    if rank == 0:  # (|difference|^2, |one device's|^2) of the leaf
                        want = ref[part][i].to(dev).float()
                        gaps[part].append(((full.float() - want).norm().item() ** 2, want.norm().item() ** 2))
                        del want
                    del full
            del state, step, met, t, sub
            torch.cuda.empty_cache()
            out.append(dict(arch=cfg.name, shape=shape, rank=rank, losses=losses, names=names, routings=len(chosen),
                            ref_losses=None if ref is None else ref["losses"], times=times, peak=peak,
                            gathered=gathered.peak, gathered_bound=gathered_bound,
                            ref_peak=None if ref is None else ref["peak"], held=torch.cuda.memory_allocated(),
                            launches=launches, shapes={k: sorted(v) for k, v in seen.items()},
                            plain=dict(spy_plain.calls), gaps=gaps, backend=str(dist.get_backend()), placed=placed))
            dist.barrier()
        del ref
    return out


def mesh_phase(dev, rand, check, check_grad, time_ms, bound, rows, n_sms, sm_clock_mhz):
    """Phase 6 (see MESH): 6a in this process, 6b on spawned ranks, 6c the
    kernels at the local shapes."""
    import torch
    import torch.distributed as dist

    from repro_torch.dist.sharding import make_rules
    from repro_torch.dist.spawn import run_ranks
    from repro_torch.dist.step import make_train_step, place_state
    from repro_torch.kernels import ops
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models.registry import build_model
    from repro_torch.optim import constant_lr
    from repro_torch.optim.adamw import tree_leaves

    t_phase = time.perf_counter()
    # 6a. one rank: the (1, 1) mesh against the device path, bit for bit
    cfg = mesh_models()[0]
    B, L, n = TRAIN["batch"], TRAIN["seq"], MESH["one_rank_steps"]
    print(f"phase 6a: make_train_step on make_host_mesh() over one NCCL rank, {cfg.name}, batch {B} x {L}, {n} "
          f"steps of phase 5b's repeated batch")
    from repro_torch.data.pipeline import build_data_pipeline, next_batch

    model = build_model(cfg)
    data = build_data_pipeline(cfg, B, L, seed=TRAIN["seed"])
    batch = {k: torch.from_numpy(np.asarray(v, dtype=np.int32)).to(dev) for k, v in next_batch(data, cfg).items()}
    step = make_train_step(model, dev, constant_lr(REPEAT_LR), global_batch=B)
    state = fresh_train_state(model, TRAIN["seed"], dev)
    want_losses = []
    for _ in range(n):
        state, met = step(state, batch)
        want_losses.append(met["loss"].item())
    want = [t.cpu() for t in tree_leaves(state["params"])]
    del state, step
    torch.cuda.empty_cache()
    pg_file = ROOT / "build" / "chip_smoke_pg_one"
    pg_file.parent.mkdir(parents=True, exist_ok=True)
    pg_file.unlink(missing_ok=True)
    dist.init_process_group("nccl", init_method=f"file://{pg_file}", rank=0, world_size=1)
    try:
        mesh = make_host_mesh()
        rules = make_rules(cfg, mesh, "train", B)
        step, _, shard, _ = make_train_step(model, mesh, constant_lr(REPEAT_LR), rules=rules, global_batch=B)
        state = place_state(fresh_train_state(model, TRAIN["seed"], dev), shard, mesh)
        ops.reset_launch_counts()
        losses = []
        for _ in range(n):
            state, met = step(state, batch)
            losses.append(met["loss"].item())
        launches = ops.launch_counts()
        same = [torch.equal(t.to_local(), w.to(dev)) for t, w in zip(tree_leaves(state["params"]), want)]
        print(f"  mesh {tuple(mesh.shape)} {mesh.mesh_dim_names}, backend {dist.get_backend()}: losses {losses}, the "
              f"device path's {want_losses}; params bit-equal {sum(same)} of {len(same)} leaves; launches {launches}")
        if losses != want_losses or not all(same):
            fail(f"phase 6a: the one-rank mesh differs from the device path: losses {losses} vs {want_losses}, "
                 f"{len(same) - sum(same)} leaves differ")
        if launches["flash_attention"] != 2 * cfg.n_layers * n or launches["flash_attention_bwd"] != cfg.n_layers * n:
            fail(f"phase 6a: launches {launches}")
        del state, step, want
    finally:
        dist.destroy_process_group()
        pg_file.unlink(missing_ok=True)
    del model, batch, met
    torch.cuda.empty_cache()
    print(f"  this process holds {torch.cuda.memory_allocated() / 2**30:.2f} GiB of the card "
          f"({torch.cuda.memory_reserved() / 2**30:.2f} reserved) while the ranks run")

    # 6b. two ranks sharing the card
    print(f"phase 6b: {MESH['world']} ranks sharing the card (gloo), spawned; meshes (data, model) "
          f"{list(MESH['shapes'])}, FSDP over data; batch {MESH['batch']} x {MESH['seq']}, {MESH['steps']} steps at lr "
          f"{REPEAT_LR}; gloo's collectives on CUDA tensors: all_reduce and the list all_gather "
          f"(dist.comm.MeshComm.native by the backend's name), reduce-scatter as all_reduce and a slice")
    t0 = time.perf_counter()
    ranks = run_ranks(mesh_rank, MESH["world"], str(ROOT / "build" / "chip_smoke_ranks"), backend="gloo",
                      timeout=MESH_TIMEOUT, pg_timeout=600)
    print(f"  {MESH['world']} ranks ran in {time.perf_counter() - t0:.1f} s (spawn and build included)")
    main_launches: dict = {}
    worst = 0.0
    for rec0, rec1 in zip(*ranks):
        arch, shape = rec0["arch"], rec0["shape"]
        cfg = next(c for c in mesh_models() if c.name == arch)
        expect = mesh_expect(cfg, shape)
        leaf_gap = {part: [(d / max(r, 1e-60)) ** 0.5 for d, r in v] for part, v in rec0["gaps"].items()}
        # the first moments (a sum of gradients) leaf by leaf, as phase 5's
        # gradient gate; the params as one tree: a zero-initialised leaf
        # (Mamba's conv_b) holds only Adam's steps, of about lr each, whose
        # sign flips for an element whose gradient sits at the noise floor
        gaps = {"m": max(leaf_gap["m"]),
                "params": (sum(d for d, _ in rec0["gaps"]["params"]) / sum(r for _, r in rec0["gaps"]["params"])) ** 0.5}
        loss_gap = max(abs(a - b) / abs(b) for rec in (rec0, rec1) for a, b in zip(rec["losses"], rec0["ref_losses"]))
        worst = max(worst, loss_gap, *gaps.values())
        top = {part: sorted(zip(v, rec0["names"]), reverse=True)[:3] for part, v in leaf_gap.items()}
        print(f"  {arch} on (data {shape[0]}, model {shape[1]}): losses by rank {[r['losses'] for r in (rec0, rec1)]}, "
              f"one device {rec0['ref_losses']} (peak {rec0['ref_peak'] / 2**30:.2f} GiB); largest gaps (tol "
              f"{GRAD_REL_TOL}): loss {loss_gap:.3e}, first moments {gaps['m']:.3e} (relative L2, the worst leaf), params "
              f"{gaps['params']:.3e} (relative L2 of the tree); worst leaves "
              + "; ".join(f"{part} " + ", ".join(f"{n} {g:.3e}" for g, n in top[part]) for part in top)
              + (f"; on the one-device run's expert choice ({rec0['routings']} MoE calls replayed)"
                 if rec0["routings"] else ""))
        for rec in (rec0, rec1):
            print(f"    rank {rec['rank']} ({rec['backend']}): step s {[round(t, 3) for t in rec['times']]}, peak memory "
                  f"{rec['peak'] / 2**30:.2f} GiB (the placed state {rec['placed'] / 2**30:.2f}, left after "
                  f"{rec['held'] / 2**30:.2f}; FSDP's gathered weights at most {rec['gathered'] / 2**30:.3f} GiB live "
                  f"at once, bound {rec['gathered_bound'] / 2**30:.3f}: outside the trunk and one layout period), "
                  f"launches {rec['launches']}, input shapes {rec['shapes']}, plain versions called {rec['plain']}")
            if rec["gathered"] > rec["gathered_bound"]:
                fail(f"phase 6b {arch} {shape} rank {rec['rank']}: {rec['gathered']} B gathered at once, more than "
                     f"the trunk's one period and the leaves outside it ({rec['gathered_bound']} B)")
            want_launches = dict.fromkeys(ops.KERNELS, 0)
            want_launches.update({k: v[0] * MESH["steps"] for k, v in expect.items()})
            if rec["launches"] != want_launches or rec["shapes"] != {k: [v[1]] for k, v in expect.items()}:
                fail(f"phase 6b {arch} {shape} rank {rec['rank']}: launches {rec['launches']} at {rec['shapes']}; "
                     f"want {want_launches} at {expect}")
            if any(rec["plain"].values()):
                fail(f"phase 6b {arch} {shape} rank {rec['rank']}: plain versions called {rec['plain']}")
        if not (loss_gap <= GRAD_REL_TOL and max(gaps.values()) <= GRAD_REL_TOL):
            fail(f"phase 6b {arch} {shape}: gaps loss {loss_gap}, {gaps} beyond {GRAD_REL_TOL}")
        for k, v in expect.items():
            main_launches[k, v[1]] = rec0["launches"][k]
    print(f"  phase 6b: the largest gap {worst:.3e} (tol {GRAD_REL_TOL})")

    # 6c. each kernel at the local shapes of (data 1, model 2), against its plain version, timed
    print("phase 6c: the kernels at the model-2 shards' shapes, against their plain versions, timed as phase 4")
    mesh_kernel_rows(rand, check, check_grad, time_ms, bound, rows, main_launches, n_sms, sm_clock_mhz)
    print(f"  phase 6: {time.perf_counter() - t_phase:.1f} s")


def mesh_kernel_rows(rand, check, check_grad, time_ms, bound, rows, launches, n_sms, sm_clock_mhz):
    """Phase 6c: flash_attention (with lse) and K1 at stablelm-1.6b's 16 of
    32 heads, moe_gmm and K7a at jamba-v0.1-52b's 8 of 16 experts, mamba_scan
    and K7b at its 4096 of 8192 channels (batch 2 x 1024, model 2), each
    checked against its plain version and timed as phase 4 beside its bound,
    its plain version and a library call where there is one; ``launches``:
    (kernel, shape) -> its launches on one rank in phase 6b."""
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels import ref
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.kernels.mamba_scan import mamba_scan, mamba_scan_bwd
    from repro_torch.kernels.moe_gmm import moe_gmm, moe_gmm_bwd
    from repro_torch.models import moe as moe_mod

    bf, es = torch.bfloat16, 2
    stablelm, jamba = mesh_models()
    shape = (1, 2)
    ex_s, ex_j = mesh_expect(stablelm, shape), mesh_expect(jamba, shape)
    label = "on (data 1, model 2)"

    B, L, H, Dh = ex_s["flash_attention"][1]
    q, k, v = (rand(B, L, H, Dh, dtype=bf) for _ in range(3))
    o, lse = flash_attention(q, k, v, return_lse=True)
    ro, rl = ref.reference_attention(q, k, v, return_lse=True)
    err = max(check(f"flash_attention lse at {stablelm.name} {label}", lse, rl, torch.float32),
              check(f"flash_attention o at {stablelm.name} {label}", o, ro, bf))
    qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
    b_ms, b_by = bound(4 * B * L * H * Dh * es + B * H * L * 4, 4 * B * H * Dh * (L * (L + 1) // 2), "bfloat16")
    rows.append(dict(
        name="flash_attention", path=f"{stablelm.name} training {label} ({B}, {L}, {H}, {Dh}), with lse, route mma",
        route="cuda", source="src/repro_torch/kernels/csrc/flash_attention.cu",
        replaces="src/repro/kernels/flash_attention.py:116",
        launches=launches["flash_attention", (B, L, H, Dh)], max_abs_err=err,
        ms=time_ms(lambda: flash_attention(q, k, v, return_lse=True), reps=10),
        plain_ms=time_ms(lambda: ref.reference_attention(q, k, v, return_lse=True), reps=3),
        bound_ms=b_ms, bound_by=b_by,
        library_ms=time_ms(lambda: F.scaled_dot_product_attention(qt, kt, vt, is_causal=True), reps=10),
        library="scaled_dot_product_attention(is_causal=True)",
    ))
    del q, k, v, o, lse, ro, rl, qt, kt, vt
    torch.cuda.empty_cache()
    k1_row(f"{stablelm.name} training {label}", (B, L, L, H, H, Dh, Dh, True),
           launches["flash_attention_bwd", (B, L, H, Dh)], rand, check, check_grad, time_ms, bound, rows)

    E, C, D = ex_j["moe_gmm"][1]
    Fd = jamba.d_ff
    x, wg, wu, wd = (rand(E, C, D, dtype=bf), rand(E, D, Fd, dtype=bf, scale=D**-0.5),
                     rand(E, D, Fd, dtype=bf, scale=D**-0.5), rand(E, Fd, D, dtype=bf, scale=Fd**-0.5))
    dy = rand(E, C, D, dtype=bf, scale=D**-0.5)
    err = check(f"moe_gmm at {jamba.name} {label} (E{E} C{C})", moe_gmm(x, wg, wu, wd),
                ref.reference_gmm(x, wg, wu, wd), bf)
    b_ms, b_by = bound(2 * E * C * D * es + 3 * E * D * Fd * es, 6 * E * C * D * Fd, "bfloat16")
    rows.append(dict(
        name="moe_gmm", path=f"{jamba.name} training {label} (E {E}, C {C}, D {D}, F {Fd}), bf16", route="cuda",
        source="src/repro_torch/kernels/csrc/moe_gmm.cu", replaces="src/repro/kernels/moe_gmm.py:59",
        launches=launches["moe_gmm", (E, C, D)], max_abs_err=err,
        ms=time_ms(lambda: moe_gmm(x, wg, wu, wd), reps=10),
        plain_ms=time_ms(lambda: ref.reference_gmm(x, wg, wu, wd), reps=3), bound_ms=b_ms, bound_by=b_by,
        library_ms=time_ms(lambda: torch.bmm(F.silu(torch.bmm(x, wg)) * torch.bmm(x, wu), wd), reps=10),
        library="3 calls: torch.bmm x3 + F.silu",
    ))
    want = ref.reference_gmm_bwd(x, wg, wu, wd, dy)
    err = max(check_grad(f"moe_gmm_bwd {n} at {jamba.name} {label} (E{E} C{C})", g, w, bf)
              for n, g, w in zip(("dx", "dwg", "dwu", "dwd"), moe_gmm_bwd(x, wg, wu, wd, dy), want))
    del want
    leaves = [t.detach().requires_grad_() for t in (x, wg, wu, wd)]
    lib_out = torch.bmm(F.silu(torch.bmm(leaves[0], leaves[1])) * torch.bmm(leaves[0], leaves[2]), leaves[3])
    b_ms, b_by = bound(3 * E * C * D * es + 6 * E * D * Fd * es, 16 * E * C * D * Fd, "bfloat16")
    rows.append(dict(
        name="moe_gmm_bwd", path=f"{jamba.name} training {label} (E {E}, C {C}, D {D}, F {Fd}), bf16", route="cuda",
        source="src/repro_torch/kernels/csrc/moe_gmm.cu",
        replaces="src/repro/models/moe.py:128 (no Pallas kernel: jax autodiff of the grouped SwiGLU einsums)",
        launches=launches["moe_gmm_bwd", (E, C, D)], max_abs_err=err,
        ms=time_ms(lambda: moe_gmm_bwd(x, wg, wu, wd, dy), reps=10),
        plain_ms=time_ms(lambda: ref.reference_gmm_bwd(x, wg, wu, wd, dy), reps=3), bound_ms=b_ms, bound_by=b_by,
        library_ms=time_ms(lambda: torch.autograd.grad(lib_out, leaves, dy, retain_graph=True), reps=10),
        library="autograd backward of torch.bmm x3 + F.silu (torch.autograd.grad)",
    ))
    del x, wg, wu, wd, dy, leaves, lib_out
    torch.cuda.empty_cache()

    B, L, Di = ex_j["mamba_scan"][1]
    N = jamba.ssm_state
    xc, dt = rand(B, L, Di, dtype=bf), rand(B, L, Di, dtype=torch.float32).abs() * 0.1
    Bm, Cm = rand(B, L, N, dtype=torch.float32), rand(B, L, N, dtype=torch.float32)
    a = -rand(Di, N, dtype=torch.float32).abs() - 0.1
    y, h = mamba_scan(xc, dt, Bm, Cm, a)
    yr, hr = ref.reference_selective_scan(xc, dt, Bm, Cm, a)
    err = max(check(f"mamba_scan y at {jamba.name} {label}", y, yr, torch.float32, SCAN_TOL),
              check(f"mamba_scan h at {jamba.name} {label}", h, hr, torch.float32, SCAN_TOL))
    # xc (bf16) and dt read once, B and C once, a once; y and h written once
    n_el = B * L * Di * N
    b_ms, b_by, _ = scan_bound(n_el, B * L * Di * (es + 4 + 4) + 2 * B * L * N * 4 + Di * N * 4 + B * Di * N * 4,
                               n_sms, sm_clock_mhz)
    rows.append(dict(
        name="mamba_scan", path=f"{jamba.name} training {label} ({B}, {L}, {Di}, {N}), bf16 xc", route="cuda",
        source="src/repro_torch/kernels/csrc/mamba_scan.cu", replaces="src/repro/kernels/mamba_scan.py:69",
        launches=launches["mamba_scan", (B, L, Di)], max_abs_err=err,
        ms=time_ms(lambda: mamba_scan(xc, dt, Bm, Cm, a), reps=10),
        plain_ms=time_ms(lambda: ref.reference_selective_scan(xc, dt, Bm, Cm, a), reps=2),
        bound_ms=b_ms, bound_by=b_by, library_ms=None, library="none",
    ))
    del y, h, yr, hr
    dys = rand(B, L, Di, dtype=torch.float32)
    want = ref.reference_selective_scan_bwd(xc, dt, Bm, Cm, a, None, dys)
    got = mamba_scan_bwd(xc, dt, Bm, Cm, a, None, dys)
    err = max(check_grad(f"mamba_scan_bwd {n} at {jamba.name} {label}", g, w, g.dtype)
              for n, g, w in zip(("dxc", "ddt", "dB", "dC", "da", "dh0"), got, want) if w is not None)
    del want, got
    nbytes = B * L * Di * (es + 4 + 4 + es + 4) + 4 * B * L * N * 4 + 2 * Di * N * 4 + B * Di * N * 4
    fma_rate, sfu_rate = PEAK_FLOPS["float32"] / 2, SFU_PER_CLOCK * n_sms * sm_clock_mhz * 1e6
    t_ops = max(SCAN_BWD_FMA_INSTRS * n_el / fma_rate,
                (SCAN_BWD_FMA_INSTRS + EXP_FMA_INSTRS) * n_el / (fma_rate + EXP_FMA_INSTRS * sfu_rate)) * 1e3
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    rows.append(dict(
        name="mamba_scan_bwd", path=f"{jamba.name} training {label} ({B}, {L}, {Di}, {N}), bf16 xc", route="cuda",
        source="src/repro_torch/kernels/csrc/mamba_scan.cu",
        replaces="src/repro/models/mamba.py:71 (no Pallas kernel: jax autodiff of the chunked selective_scan)",
        launches=launches["mamba_scan_bwd", (B, L, Di)], max_abs_err=err,
        ms=time_ms(lambda: mamba_scan_bwd(xc, dt, Bm, Cm, a, None, dys), reps=10),
        plain_ms=time_ms(lambda: ref.reference_selective_scan_bwd(xc, dt, Bm, Cm, a, None, dys), reps=2),
        bound_ms=max(t_ops, t_bytes), bound_by="bytes" if t_bytes >= t_ops else "operations",
        library_ms=None, library="none",
    ))
    for r in rows[-6:]:
        print(f"  {r['name']} at {r['path']}: {r['ms']:.4f} ms, bound {r['bound_ms']:.4f} ({r['bound_by']}; "
              f"{r['ms'] / r['bound_ms']:.2f}x), plain {r['plain_ms']:.4f}, library "
              f"{'none' if r['library_ms'] is None else format(r['library_ms'], '.4f')}, {r['launches']} launches a "
              f"rank in 6b")
    del xc, dt, Bm, Cm, a, dys
    torch.cuda.empty_cache()


# phase 6d: serving on a DeviceMesh (gloo ranks spawned from this script,
# sharing the card), each run against the same serve on one device (rank 0
# alone on the card first): prefill and SERVE_MESH_GEN - 1 decode steps, the
# mesh teacher-forced with the one-device greedy tokens, its logits gathered
# (``dist.step.gather_full``); an MoE run replays the one-device run's expert
# choice, as phase 3b's gate replays the kernels run's.
#   (i) heads, KV heads, vocab and MLP split; (ii) the flash-decoding fallback
#   over data (global batch 1: 2048 slots a rank); (iii) experts and Mamba
#   channels split (phase 3b's cut); (iv) the fallback over model (2 KV heads
#   on 4 ranks, heads and vocab replicated, 394 slots a rank).
SERVE_MESH = [
    dict(run="i", arch="stablelm-1.6b", batch=4, prompt_len=512, shape=(1, 2), seed=0),
    dict(run="ii", arch="stablelm-1.6b", batch=1, prompt_len=4056, shape=(2, 1), seed=0),
    dict(run="iii", arch="jamba-v0.1-52b", n_layers=8, batch=4, prompt_len=512, shape=(1, 2), seed=0),
    dict(run="iv", arch="internvl2-1b", batch=4, prompt_len=512, shape=(1, 4), seed=0),
]
SERVE_MESH_GEN = 32
SERVE_MESH_KERNELS = ("flash_attention", "flash_decode", "moe_gmm", "mamba_scan")


def serve_mesh_config(spec):
    from repro_torch.configs import get_config

    full = get_config(spec["arch"])
    return dataclasses.replace(full, n_layers=spec.get("n_layers", full.n_layers))


def serve_mesh_expect(cfg, spec) -> dict:
    """kernel -> {(its first input's shape, its second's): launches} on one
    rank of a run: per attention layer flash_attention once (prefill: the
    local query heads over the whole local cache, or over the prompt's own
    K/V where the slots are split; no ring among the runs) and flash_decode a
    decode step (over this rank's slots; every query head where the KV heads
    are replicated over ``model``); per MoE layer moe_gmm a step at E/tp
    local bins; per Mamba layer mamba_scan once at Di/tp channels."""
    from repro_torch.launch import serve
    from repro_torch.models import moe as moe_mod

    data, tp = spec["shape"]
    B, gen = spec["batch"], SERVE_MESH_GEN
    L = spec["prompt_len"] + (cfg.frontend_len if cfg.frontend == "vision" else 0)
    over_data = B % data != 0 or B < data  # the batch cannot fill the data axis: the slots split over it
    b = B if over_data else B // data
    n = (data if over_data else 1) * (tp if cfg.n_kv_heads % tp else 1)  # the slots' split
    S = serve.serve_max_len(cfg, spec["prompt_len"], gen)
    specs = [cfg.layout[i % len(cfg.layout)] for i in range(cfg.n_layers)]
    h_loc = cfg.n_heads // tp if cfg.n_heads % tp == 0 else cfg.n_heads
    h_dec = cfg.n_heads if cfg.n_kv_heads % tp else h_loc
    kvh = cfg.n_kv_heads // tp if cfg.n_kv_heads % tp == 0 else cfg.n_kv_heads
    # at prefill, local query heads over replicated KV heads read one KV head each
    kv_pre = h_loc if cfg.n_heads % tp == 0 and cfg.n_kv_heads % tp else kvh
    Dh, out = cfg.head_dim, {}
    n_calls = sum(s.mixer == "attention" for s in specs)
    if n_calls:
        out["flash_attention"] = {((b, L, h_loc, Dh), (b, L if n > 1 else S, kv_pre, Dh)): n_calls}
        out["flash_decode"] = {((b, 1, h_dec, Dh), (b, S // n, kvh, Dh)): n_calls * (gen - 1)}
    n_calls = sum(s.ffn == "moe" for s in specs)
    if n_calls:
        e, f = (cfg.n_experts // tp, cfg.d_ff) if cfg.n_experts % tp == 0 else (cfg.n_experts, cfg.d_ff // tp)
        c_pre, c_dec = moe_mod.expert_capacity(B * L, cfg), moe_mod.expert_capacity(B, cfg)
        out["moe_gmm"] = {((e, c_pre, cfg.d_model), (e, cfg.d_model, f)): n_calls,
                          ((e, c_dec, cfg.d_model), (e, cfg.d_model, f)): n_calls * (gen - 1)}
    n_calls = sum(s.mixer == "mamba" for s in specs)
    if n_calls:
        out["mamba_scan"] = {((b, L, cfg.d_inner // tp),) * 2: n_calls}
    return out


def serve_mesh_rank(rank: int, world: int) -> list:
    """Phase 6d on one of the ranks sharing the card: for each run of this
    world size, rank 0 serves alone on one device (its logits, greedy tokens,
    router choices and probabilities kept), then every rank serves on the mesh
    through ``make_serve_fns`` with the params placed by
    ``place_serve_params`` (the ranks init and place in turns: a whole jamba
    cut to 8 layers and its shard would not fit twice beside each other) and
    this rank's cache shards (``init_serve_state(..., mesh)``), its kernels
    spied for their first two inputs' shapes, no plain version called. Returns a record a
    run."""
    import torch
    import torch.distributed as dist

    from repro_torch.dist.step import gather_full, make_serve_fns, place_serve_params
    from repro_torch.kernels import ops
    from repro_torch.launch import serve
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import moe as moe_mod
    from repro_torch.models.common import parallel
    from repro_torch.models.registry import build_model, init_serve_state

    os.environ.setdefault("PYTORCH_CUDA_ALLOC_CONF", "expandable_segments:True")  # the ranks share the card
    torch.cuda.set_device(0)
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0)
    gen = SERVE_MESH_GEN
    route = moe_mod.route
    out = []

    def served(prefill_fn, decode_fn, params, state, prompts, frames, prefix, forced=None, gather=lambda t: t):
        """Logits (B, gen, V) f32 of a prefill and gen - 1 decode steps (fed
        the greedy tokens, or ``forced``); (prefill s, decode s) beside."""
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        lg, state = prefill_fn(params, prompts, state, frames, prefix)
        steps = [gather(lg).float()]
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        for t in range(gen - 1):
            tok = steps[-1].argmax(-1)[:, None] if forced is None else forced[:, t : t + 1]
            lg, state = decode_fn(params, tok, state)
            steps.append(gather(lg).float())
        torch.cuda.synchronize()
        return torch.stack(steps, dim=1), (t1 - t0, time.perf_counter() - t1)

    for spec in SERVE_MESH:
        if spec["shape"][0] * spec["shape"][1] != world:
            continue
        cfg = serve_mesh_config(spec)
        model = build_model(cfg)
        B = spec["batch"]
        max_len = serve.serve_max_len(cfg, spec["prompt_len"], gen)
        prompts = serve.make_prompts(cfg.vocab, B, spec["prompt_len"], spec["seed"] + 1, dev)
        frames, prefix = serve.make_frontend(cfg, B, spec["seed"], dev)
        chosen, probs = [], []

        def recording_route(p, c, xf):
            pr, gate_w, gate_e = route(p, c, xf)
            chosen.append(gate_e.cpu())
            probs.append(pr.cpu())
            return pr, gate_w, gate_e

        ref = None
        if rank == 0:  # alone on the card: the other ranks wait at the broadcast
            torch.cuda.reset_peak_memory_stats()
            params = model.init(spec["seed"], dev)
            fns = make_serve_fns(model, dev, max_len=max_len, global_batch=B)
            moe_mod.route = recording_route
            try:
                with torch.inference_mode():
                    logits, times = served(*fns, params, init_serve_state(model, B, max_len, dev), prompts, frames,
                                           prefix)
            finally:
                moe_mod.route = route
            ref = {"logits": logits, "times": times, "peak": torch.cuda.max_memory_allocated(),
                   "probs": list(probs)}
            del params, fns
            torch.cuda.empty_cache()
        box = [None if ref is None else ref["logits"].argmax(-1).cpu(), list(chosen)]
        dist.broadcast_object_list(box, src=0)  # the greedy tokens and every MoE call's expert choice
        forced, chosen = box[0].to(dev), box[1]
        probs.clear()

        mesh = make_host_mesh(model=spec["shape"][1], device="cuda")
        prefill_fn, decode_fn, _, shards = make_serve_fns(model, mesh, max_len=max_len, global_batch=B)
        params = None
        for r in range(world):  # in turns: each rank's whole init is freed before the next one's
            if r == rank:
                params = place_serve_params(model.init(spec["seed"], dev), shards, mesh)
                torch.cuda.empty_cache()
            dist.barrier()
        state = init_serve_state(model, B, max_len, mesh)
        replay = iter(chosen)

        def forced_route(p, c, xf):
            pr, _, _ = route(p, c, xf)
            probs.append(pr.cpu())
            par, T = parallel(), xf.shape[0]
            experts = next(replay)[par.dp_rank * T : (par.dp_rank + 1) * T].to(xf.device)
            gate_w = pr.gather(1, experts)
            return pr, gate_w / gate_w.sum(-1, keepdim=True).clamp_min(1e-9), experts

        placed = torch.cuda.memory_allocated()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        seen: dict = {}
        ops.reset_launch_counts()  # before the spies stand in for the wrappers, whose counts it zeroes
        kept = dict(ops.KERNELS)
        for name in SERVE_MESH_KERNELS:
            def spy(*args, _fn=kept[name], _name=name, **kwargs):
                per, key = seen.setdefault(_name, {}), (tuple(args[0].shape), tuple(args[1].shape))
                per[key] = per.get(key, 0) + 1
                return _fn(*args, **kwargs)

            ops.KERNELS[name] = spy
        moe_mod.route = forced_route
        try:
            with PlainSpy() as spy_plain:
                logits, times = served(prefill_fn, decode_fn, params, state, prompts, frames, prefix, forced,
                                       gather_full)
        finally:
            ops.KERNELS.update(kept)
            moe_mod.route = route
        if chosen and next(replay, None) is not None:
            fail(f"phase 6d ({spec['run']}): {len(chosen)} routings recorded, fewer replayed")
        rec = dict(run=spec["run"], arch=cfg.name, shape=spec["shape"], rank=rank, times=times,
                   peak=torch.cuda.max_memory_allocated(), placed=placed, launches=ops.launch_counts(),
                   shapes={k: dict(v) for k, v in seen.items()}, plain=dict(spy_plain.calls),
                   backend=str(dist.get_backend()), routings=len(chosen),
                   split=[c.get("split") for c in state["caches"] if "split" in c][:1],
                   cache_shapes=sorted({(k, tuple(c[k].shape)) for c in state["caches"] for k in ("k", "h", "c_kv")
                                        if k in c}))
        if rank == 0:
            one = ref["logits"]
            # the gate: logits and greedy tokens; the router probabilities of
            # the two runs (on one routing) are printed beside
            failures, st = logit_comparison(one, logits, LOGIT_TOL[cfg.dtype])
            dprob = max(((a - b).abs().max().item() for a, b in zip(ref["probs"], probs)), default=None)
            rec.update(failures=failures, diff=st["diff"], agree=st["agree"], ties=st["ties"], n=st["n"],
                       dprob=dprob, ref_times=ref["times"], ref_peak=ref["peak"],
                       finite=bool(torch.isfinite(logits).all()), vocab=logits.shape[-1])
        del params, state, logits, prefill_fn, decode_fn, shards
        ref = None
        torch.cuda.empty_cache()
        dist.barrier()
        out.append(rec)
    return out


def serve_mesh_phase(rand, check, time_ms, bound, rows, n_sms, sm_clock_mhz):
    """Phase 6d (see SERVE_MESH): the runs on spawned ranks, then each kernel
    of their path at the runs' local shapes (``serve_mesh_kernel_rows``)."""
    import torch

    from repro_torch.dist.spawn import run_ranks

    t_phase = time.perf_counter()
    print(f"phase 6d: serving on a mesh, gloo ranks sharing the card, spawned; {SERVE_MESH_GEN} tokens, bf16, each "
          f"run against the same serve on one device (logits within {LOGIT_TOL['bfloat16']}, greedy tokens equal "
          f"or tied within error)")
    records = []
    for world in sorted({s["shape"][0] * s["shape"][1] for s in SERVE_MESH}):
        t0 = time.perf_counter()
        ranks = run_ranks(serve_mesh_rank, world, str(ROOT / "build" / f"chip_smoke_serve_ranks_{world}"),
                          backend="gloo", timeout=MESH_TIMEOUT, pg_timeout=600)
        print(f"  {world} ranks ran in {time.perf_counter() - t0:.1f} s (spawn included)")
        records.extend(zip(*ranks))
    worst = 0.0
    for recs in records:
        rec0 = recs[0]
        spec = next(s for s in SERVE_MESH if s["run"] == rec0["run"])
        cfg = serve_mesh_config(spec)
        expect = serve_mesh_expect(cfg, spec)
        worst = max(worst, rec0["diff"])
        p_s, d_s = rec0["ref_times"]
        print(f"  ({spec['run']}) {cfg.name} ({cfg.n_layers} layers) on (data {spec['shape'][0]}, model "
              f"{spec['shape'][1]}), batch {spec['batch']}, prompt {spec['prompt_len']}"
              + (f" after a prefix of {cfg.frontend_len}" if cfg.frontend == "vision" else "")
              + f": max |logit diff| {rec0['diff']:.4e} (tol {LOGIT_TOL[cfg.dtype]}); greedy tokens agree "
              f"{rec0['agree']}/{rec0['n']}, ties within error {rec0['ties']}"
              + (f"; on the one-device run's expert choice ({rec0['routings']} MoE calls replayed), max |router "
                 f"prob diff| {rec0['dprob']:.4e} (printed; phase 3b's kernels vs plain bound {ROUTER_PROB_TOL:.4e})"
                 if rec0["routings"] else "")
              + f"; one device: prefill {p_s:.3f} s, decode {spec['batch'] * (SERVE_MESH_GEN - 1) / d_s:.1f} tok/s, "
              f"peak {rec0['ref_peak'] / 2**30:.2f} GiB")
        for rec in recs:
            p_s, d_s = rec["times"]
            print(f"    rank {rec['rank']} ({rec['backend']}): prefill {p_s:.3f} s, decode "
                  f"{spec['batch'] * (SERVE_MESH_GEN - 1) / d_s:.1f} tok/s (logits gathered each step), peak "
                  f"{rec['peak'] / 2**30:.2f} GiB (placed {rec['placed'] / 2**30:.2f}); cache shards "
                  f"{rec['cache_shapes']}, split {rec['split']}; launches by input shape {rec['shapes']}; plain "
                  f"versions called {rec['plain']}")
            want = dict.fromkeys(rec["launches"], 0)
            want.update({k: sum(v.values()) for k, v in expect.items()})
            if rec["launches"] != want or rec["shapes"] != expect:
                fail(f"phase 6d ({spec['run']}) rank {rec['rank']}: launches {rec['launches']} at {rec['shapes']}; "
                     f"want {want} at {expect}")
            if any(rec["plain"].values()):
                fail(f"phase 6d ({spec['run']}) rank {rec['rank']}: plain versions called {rec['plain']}")
        if rec0["failures"] or not rec0["finite"]:
            fail(f"phase 6d ({spec['run']}) {cfg.name}: {'; '.join(rec0['failures']) or 'non-finite logits'}")
    print(f"  phase 6d: the largest logit gap {worst:.4e} (tol {LOGIT_TOL['bfloat16']})")
    serve_mesh_kernel_rows(rand, check, time_ms, bound, rows, n_sms, sm_clock_mhz)
    print(f"  phase 6d: {time.perf_counter() - t_phase:.1f} s")


def serve_mesh_kernel_rows(rand, check, time_ms, bound, rows, n_sms, sm_clock_mhz):
    """Phase 6d's kernel rows at each run's local shapes (``serve_mesh_expect``),
    each against its plain version and timed as phase 4 (L2 flushed), with
    the launches a rank of the run: flash_attention at the prefill (SDPA
    beside); flash_decode at a mid-generation step on the slice that holds the
    newest slot, called as the run calls it: with its log-sum-exp and an f32
    output where the slots are split (lse held at f32's tolerance; the same
    call without lse timed beside), else without (SDPA over the slots beside);
    moe_gmm at (iii)'s prefill and decode bins (8 of 16 experts, every slot
    live) and mamba_scan at its 4096 of 8192 channels."""
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels import ref
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.kernels.flash_decode import flash_decode, split_for
    from repro_torch.kernels.mamba_scan import mamba_scan
    from repro_torch.kernels.moe_gmm import moe_gmm
    from repro_torch.launch import serve

    bf, f32, es, dev = torch.bfloat16, torch.float32, 2, torch.device("cuda", 0)
    i32 = dict(dtype=torch.int32, device=dev)
    for spec in SERVE_MESH:
        cfg = serve_mesh_config(spec)
        ex = serve_mesh_expect(cfg, spec)
        data, tp = spec["shape"]
        on = f"{cfg.name} ({spec['run']}) on (data {data}, model {tp})"

        ((qs, ks), n_pre), = ex["flash_attention"].items()
        (B, Lq, H, Dh), (_, Lk, KVH, _) = qs, ks
        q, k, v = rand(*qs, dtype=bf), rand(*ks, dtype=bf), rand(*ks, dtype=bf)
        pairs = Lq * (Lq + 1) // 2  # causal (q, k) pairs, Lq <= Lk; slots past Lq are dead
        b_ms, b_by = bound(2 * B * Lq * H * Dh * es + 2 * B * Lq * KVH * Dh * es, 4 * B * H * Dh * pairs, "bfloat16")
        qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
        gqa = dict(enable_gqa=True) if H != KVH else {}
        err = check(f"flash_attention at {on} prefill", flash_attention(q, k, v), ref.reference_attention(q, k, v), bf)
        rows.append(dict(
            name="flash_attention", path=f"{on} prefill: q {qs} over {Lk} slots of {KVH} KV heads, route mma",
            route="cuda", source="src/repro_torch/kernels/csrc/flash_attention.cu",
            replaces="src/repro/kernels/flash_attention.py:116", launches=n_pre, max_abs_err=err,
            ms=time_ms(lambda: flash_attention(q, k, v), reps=10),
            plain_ms=time_ms(lambda: ref.reference_attention(q, k, v), reps=3), bound_ms=b_ms, bound_by=b_by,
            library_ms=time_ms(lambda: F.scaled_dot_product_attention(qt, kt, vt, is_causal=True, **gqa), reps=10),
            library="scaled_dot_product_attention(is_causal=True)",
        ))
        del q, k, v, qt, kt, vt
        torch.cuda.empty_cache()

        ((qs, ks), n_dec), = ex["flash_decode"].items()
        (B, _, H, Dh), (_, S_loc, KVH, _) = qs, ks
        n = serve.serve_max_len(cfg, spec["prompt_len"], SERVE_MESH_GEN) // S_loc
        written = spec["prompt_len"] + (cfg.frontend_len if cfg.frontend == "vision" else 0) + N_CHECK * 2
        r = min(n - 1, (written - 1) // S_loc)  # the slice holding the newest slot
        nv = min(written - r * S_loc, S_loc)
        q, k, v = rand(*qs, dtype=bf), rand(*ks, dtype=bf), rand(*ks, dtype=bf)
        kpos = (r * S_loc + torch.arange(S_loc, **i32)).expand(B, S_loc).contiguous()
        qpos, nval = torch.full((B,), written - 1, **i32), torch.full((B,), nv, **i32)
        lse_out = dict(return_lse=True, out_dtype=f32) if n > 1 else {}  # as the run calls it
        call = lambda: flash_decode(q, k, v, kpos, qpos, nval, **lse_out)  # noqa: E731
        plain = lambda: ref.reference_decode(q, k, v, kpos, qpos, nval, **lse_out)  # noqa: E731
        label = f"{on} decode, slice {r} of {n}"
        if n > 1:
            (o, lse), (ro, rl) = call(), plain()
            err = max(check(f"flash_decode o with lse at {label}", o, ro, bf),
                      check(f"flash_decode lse at {label}", lse, rl, f32))
        else:
            err = check(f"flash_decode at {label}", call(), plain(), bf)
        # K, V of the written slots and their positions read once; q read, o (and lse) written once
        o_bytes = B * H * Dh * (4 if n > 1 else es) + (B * H * 4 if n > 1 else 0)
        nbytes = 2 * B * nv * KVH * Dh * es + B * nv * 4 + B * H * Dh * es + o_bytes + 2 * B * 4
        b_ms, b_by = bound(nbytes, 4 * B * H * Dh * nv, "bfloat16")
        ok = (torch.arange(S_loc, device=dev)[None] < nval[:, None]) & (kpos <= qpos[:, None])
        qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
        gqa = dict(enable_gqa=True) if H != KVH else {}
        rows.append(dict(
            name="flash_decode", path=f"{label}: q {qs}, {S_loc} slots ({nv} written)"
            + (", with lse, f32 out" if n > 1 else ""), route="cuda", source="src/repro_torch/kernels/csrc/flash_decode.cu",
            replaces="src/repro/kernels/flash_decode.py:89", launches=n_dec, max_abs_err=err,
            ms=time_ms(call), plain_ms=time_ms(plain), bound_ms=b_ms, bound_by=b_by,
            library_ms=time_ms(lambda: F.scaled_dot_product_attention(qt, kt, vt, attn_mask=ok[:, None, None], **gqa)),
            library="scaled_dot_product_attention(boolean mask; no lse)", n_split=split_for(q, k),
        ))
        if n > 1:
            rows[-1]["no_lse_ms"] = time_ms(lambda: flash_decode(q, k, v, kpos, qpos, nval))
        del q, k, v, qt, kt, vt

    spec = next(s for s in SERVE_MESH if s["run"] == "iii")
    jamba = serve_mesh_config(spec)
    ex = serve_mesh_expect(jamba, spec)
    by_c = sorted(ex["moe_gmm"].items(), key=lambda kv: -kv[0][0][1])  # the prefill's bins, then decode's
    for phase, (((E, C, D), (_, _, Fd)), n_gmm) in zip(("prefill", "decode"), by_c):
        x, wg, wu, wd = (rand(E, C, D, dtype=bf), rand(E, D, Fd, dtype=bf, scale=D**-0.5),
                         rand(E, D, Fd, dtype=bf, scale=D**-0.5), rand(E, Fd, D, dtype=bf, scale=Fd**-0.5))
        label = f"{jamba.name} (iii) {phase} on (data 1, model 2)"
        err = check(f"moe_gmm at {label} (E{E} C{C})", moe_gmm(x, wg, wu, wd), ref.reference_gmm(x, wg, wu, wd), bf)
        b_ms, b_by = bound(2 * E * C * D * es + 3 * E * D * Fd * es, 6 * E * C * D * Fd, "bfloat16")
        rows.append(dict(
            name="moe_gmm", path=f"{label} (E {E} of {jamba.n_experts}, C {C}, D {D}, F {Fd}), bf16", route="cuda",
            source="src/repro_torch/kernels/csrc/moe_gmm.cu", replaces="src/repro/kernels/moe_gmm.py:59",
            launches=n_gmm, max_abs_err=err, ms=time_ms(lambda: moe_gmm(x, wg, wu, wd), reps=10),
            plain_ms=time_ms(lambda: ref.reference_gmm(x, wg, wu, wd), reps=3), bound_ms=b_ms, bound_by=b_by,
            library_ms=time_ms(lambda: torch.bmm(F.silu(torch.bmm(x, wg)) * torch.bmm(x, wu), wd), reps=10),
            library="3 calls: torch.bmm x3 + F.silu",
        ))
        del x, wg, wu, wd
    ((Bs, Ls, Di), _), n_scan = next(iter(ex["mamba_scan"].items()))
    N = jamba.ssm_state
    xc, dt = rand(Bs, Ls, Di, dtype=bf), rand(Bs, Ls, Di, dtype=f32).abs() * 0.1
    Bm, Cm = rand(Bs, Ls, N, dtype=f32), rand(Bs, Ls, N, dtype=f32)
    a = -rand(Di, N, dtype=f32).abs() - 0.1
    y, h = mamba_scan(xc, dt, Bm, Cm, a)
    yr, hr = ref.reference_selective_scan(xc, dt, Bm, Cm, a)
    label = f"{jamba.name} (iii) prefill on (data 1, model 2)"
    err = max(check(f"mamba_scan y at {label}", y, yr, f32, SCAN_TOL),
              check(f"mamba_scan h at {label}", h, hr, f32, SCAN_TOL))
    n_el = Bs * Ls * Di * N
    b_ms, b_by, _ = scan_bound(n_el, Bs * Ls * Di * (es + 4 + 4) + 2 * Bs * Ls * N * 4 + Di * N * 4 + Bs * Di * N * 4,
                               n_sms, sm_clock_mhz)
    rows.append(dict(
        name="mamba_scan", path=f"{label} ({Bs}, {Ls}, {Di} of {jamba.d_inner}, {N}), bf16 xc", route="cuda",
        source="src/repro_torch/kernels/csrc/mamba_scan.cu", replaces="src/repro/kernels/mamba_scan.py:69",
        launches=n_scan, max_abs_err=err, ms=time_ms(lambda: mamba_scan(xc, dt, Bm, Cm, a), reps=10),
        plain_ms=time_ms(lambda: ref.reference_selective_scan(xc, dt, Bm, Cm, a), reps=2),
        bound_ms=b_ms, bound_by=b_by, library_ms=None, library="none",
    ))
    for r in rows[-(2 * len(SERVE_MESH) + 3):]:
        lse = f", without lse {r['no_lse_ms']:.4f} (the same inputs)" if "no_lse_ms" in r else ""
        print(f"  {r['name']} at {r['path']}: {r['ms']:.4f} ms{lse}, bound {r['bound_ms']:.4f} ({r['bound_by']}; "
              f"{r['ms'] / r['bound_ms']:.2f}x), plain {r['plain_ms']:.4f}, library "
              f"{'none' if r['library_ms'] is None else format(r['library_ms'], '.4f')}, {r['launches']} launches a "
              f"rank in 6d" + (f", n_split {r['n_split']}" if "n_split" in r else ""))
    del xc, dt, Bm, Cm, a, y, h, yr, hr
    torch.cuda.empty_cache()


# phase 8a: the dry-run's cells (arch, shape, two pods); the last is a skip row
DRYRUN_CELLS = [("stablelm-1.6b", "train_4k", False), ("stablelm-1.6b", "train_4k", True),
                ("stablelm-1.6b", "decode_32k", False), ("stablelm-1.6b", "decode_32k", True),
                ("jamba-v0.1-52b", "prefill_32k", False), ("internlm2-20b", "long_500k", False)]
DRYRUN_TIMEOUT_S = 300


def dryrun_records(out_dir: Path) -> None:
    """Phase 8a: the dry-run CLI for every DRYRUN_CELLS cell, in subprocesses
    started together (CPU only: the ranks are meta tensors), each checked as
    tests/test_dryrun_integration.py checks the reference's record."""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    procs = []
    for arch, shape, pods in DRYRUN_CELLS:
        argv = [sys.executable, "-W", "ignore", "-m", "repro_torch.launch.dryrun", "--arch", arch, "--shape", shape,
                "--out", str(out_dir)] + (["--multipod"] if pods else [])
        procs.append(((arch, shape, pods), time.perf_counter(),
                      subprocess.Popen(argv, env=env, cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                                       text=True)))
    failures = []
    try:
        for (arch, shape, pods), t0, proc in procs:
            out, err = proc.communicate(timeout=max(1.0, DRYRUN_TIMEOUT_S - (time.perf_counter() - t0)))
            wall = time.perf_counter() - t0
            mesh = "pod2x16x16" if pods else "pod16x16"
            name = f"{arch} x {shape} ({mesh})"
            path = out_dir / mesh / f"{arch}__{shape}.json"
            if proc.returncode != 0 or not path.exists():
                failures.append(f"{name}: rc {proc.returncode}: {err[-1500:]}")
                continue
            rec = json.loads(path.read_text())
            if "skip" in rec:
                print(f"  {name}: [SKIP] {rec['skip']} ({wall:.1f} s)")
                if "[SKIP]" not in out:
                    failures.append(f"{name}: a skip row without [SKIP] in its output")
                continue
            bad = [k for k, ok in (
                ("n_devices", rec["n_devices"] == (512 if pods else 256)), ("t_memory", rec["t_memory"] > 0),
                ("bottleneck", rec["bottleneck"] in ("compute", "memory", "collective")),
                ("memory_analysis", rec["memory_analysis"] is not None),
                ("state_gb_per_device", rec["state_gb_per_device"] < 80.0),
                ("collectives", rec["collectives"]["total_weighted"] >= 0),
                ("[OK]", f"[OK] {arch} x {shape}" in out)) if not ok]
            print(f"  {name}: compute {rec['t_compute'] * 1e3:.4f} ms, memory {rec['t_memory'] * 1e3:.4f} ms "
                  f"(raw {rec['t_memory_raw'] * 1e3:.4f}), collective {rec['t_collective'] * 1e3:.4f} ms -> "
                  f"{rec['bottleneck']}-bound; state {rec['state_gb_per_device']:.4f} GB, peak "
                  f"{rec['per_device_peak_memory'] / 1e9:.4f} GB a device; counted in {rec['compile_seconds']:.2f} s, "
                  f"{wall:.1f} s in all")
            if bad:
                failures.append(f"{name}: record fails {bad}")
    finally:
        for _, _, proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    if failures:
        fail("phase 8a: " + "; ".join(failures))


def priced_steps(measured: dict) -> None:
    """Phase 8b: the steps phases 5, 5g and 3 timed on this card, counted on
    meta tensors at one device and priced with ``H100_SXM``: no measured time
    may be below its bound."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.dist.step import make_batch_specs, make_serve_fns, make_train_step
    from repro_torch.models.registry import build_model
    from repro_torch.optim import adamw_init, constant_lr
    from repro_torch.roofline import H100_SXM, OpCounter, analyze

    meta = lambda shape, dtype: torch.empty(shape, dtype=dtype, device="meta")

    def train_run(cfg, B, L):
        model = build_model(cfg)
        params = model.init(0, "meta")
        state = {"params": params, "opt": adamw_init(params), "step": meta((), torch.int32)}
        batch = make_batch_specs(cfg, "train", B, L)
        step = make_train_step(model, "meta", constant_lr(REPEAT_LR), global_batch=B)
        return (lambda: step(state, batch)), (state, batch)

    def decode_run(cfg, B, max_len, index):
        model = build_model(cfg)
        params = model.init(0, "meta")
        _, decode_fn = make_serve_fns(model, "meta", max_len=max_len, global_batch=B)
        state = {"caches": model.init_cache(B, max_len, "meta"), "t": index}
        for c in state["caches"]:
            c["index"] = index
        tokens = meta((B, 1), torch.int32)
        return (lambda: decode_fn(params, tokens, state)), (params, state, tokens)

    hcfg = dataclasses.replace(get_config(TRAIN_HYBRID["arch"]), n_layers=TRAIN_HYBRID["n_layers"])
    serve_max_len = SERVE["prompt_len"] + SERVE["gen"] + 8
    serve_index = SERVE["prompt_len"] + N_STEADY // 2  # the middle of the timed decode steps
    steps = [
        ("phase 5: stablelm-1.6b train step, 8 x 2048", get_config(TRAIN["arch"]), "train", TRAIN["batch"],
         TRAIN["seq"], lambda c: train_run(c, TRAIN["batch"], TRAIN["seq"]), measured["train_step_s"]),
        (f"phase 5g: jamba-v0.1-52b train step, {hcfg.n_layers} layers, 4 x 1024", hcfg, "train",
         TRAIN_HYBRID["batch"], TRAIN_HYBRID["seq"],
         lambda c: train_run(c, TRAIN_HYBRID["batch"], TRAIN_HYBRID["seq"]), measured["hybrid_step_s"]),
        (f"phase 3: stablelm-1.6b decode step, batch {SERVE['batch']}, cache at {serve_index}",
         get_config(SERVE["arch"]), "decode", SERVE["batch"], serve_index,
         lambda c: decode_run(c, SERVE["batch"], serve_max_len, serve_index), measured["decode_step_s"]),
    ]
    failures = []
    for label, cfg, kind, B, L, make, measured_s in steps:
        run, args = make(cfg)
        t0 = time.perf_counter()
        with OpCounter(args=args) as counter:
            run()
        count_s = time.perf_counter() - t0
        costs = counter.costs()
        rep = analyze(costs, arch=cfg.name, shape=label, mesh_name="one device", n_devices=1, kind=kind, cfg=cfg,
                      seq_len=L, global_batch=B, hw=H100_SXM, mesh_shape={}, rules={})
        bound = max(rep.t_compute, rep.t_memory, rep.t_collective)
        print(f"  {label}: compute {rep.t_compute * 1e3:.4f} ms ({costs['dot_flops'] / 1e12:.4f} TFLOP in matrix "
              f"products, {costs['other_flops'] / 1e12:.4f} other), memory {rep.t_memory * 1e3:.4f} ms (raw "
              f"{rep.t_memory_raw * 1e3:.4f}), collective {rep.t_collective * 1e3:.4f} ms; bound "
              f"{bound * 1e3:.4f} ms ({rep.bottleneck}); measured {measured_s * 1e3:.4f} ms, "
              f"{measured_s / bound:.4f}x the bound; counted peak {costs['peak_bytes'] / 2**30:.2f} GiB "
              f"({count_s:.1f} s, {costs['n_ops']} ops)")
        if measured_s < bound:
            failures.append(f"{label}: measured {measured_s * 1e3:.4f} ms < bound {bound * 1e3:.4f} ms")
    if failures:
        fail("phase 8b: the counter over-counts: " + "; ".join(failures))


# phase 9: the port's examples (examples/torch_*.py) on the card, in this
# process through main(argv): (example, extra arguments, the kernels it must
# launch; every attention launch of the f32 models on the fma routes)
EXAMPLES = [
    ("torch_quickstart", [], ()),
    ("torch_wireframe_audit", [], ()),
    ("torch_twin_pipelines", [], ("flash_attention", "flash_attention_bwd", "flash_decode")),
    ("torch_train_lm", ["--ckpt-dir", str(ROOT / "build" / "chip_smoke_examples_ckpt")],
     ("flash_attention", "flash_attention_bwd")),
]


# phase 9's kernels, recorded at every input the examples give them, and the
# plain version (``kernels.ref``) each is held against there
EXAMPLE_KERNELS = {"flash_attention": "reference_attention", "flash_attention_bwd": "reference_attention_bwd",
                   "flash_decode": "reference_decode"}


def examples_phase(check, check_grad, time_ms, bound, rows) -> None:
    """Phase 9: each example's main(["--device", "cuda", ...]), its wall
    time, its launches by kernel and route; fails if a plain version ran
    (every tensor of these runs is on the card, or meta in the ghost run),
    if an expected kernel did not launch, or if an attention launch missed
    its f32 route. Spies on ``ops.KERNELS`` count the launches by input
    (shapes and options) and keep each input's first call; then each kernel
    is held against its plain version on those inputs (``examples_kernel_rows``)."""
    import importlib.util

    import torch

    from repro_torch.kernels import ops
    from repro_torch.kernels.flash_attention import flash_attention, flash_attention_bwd

    t_phase = time.perf_counter()
    recorded: dict = {}  # (example, kernel, shapes, options) -> [launches, the first call's (args, kwargs)]
    for name, argv, want in EXAMPLES:
        spec = importlib.util.spec_from_file_location(f"example_{name}", ROOT / "examples" / f"{name}.py")
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        print(f"phase 9: examples/{name}.py on the card")
        ops.reset_launch_counts()  # before the spies stand in for the wrappers, whose counts it zeroes
        kept = dict(ops.KERNELS)
        for kname in EXAMPLE_KERNELS:
            def spy(*args, _fn=kept[kname], _k=kname, **kwargs):
                key = (name, _k, tuple(tuple(a.shape) for a in args), tuple(sorted(kwargs.items(), key=str)))
                rec = recorded.setdefault(key, [0, None])
                rec[0] += 1
                if rec[1] is None:
                    rec[1] = ([a.detach().clone() for a in args], dict(kwargs))
                return _fn(*args, **kwargs)

            ops.KERNELS[kname] = spy
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        try:
            with PlainSpy() as spy_plain:
                run_main_captured(mod.main, ["--device", "cuda", *argv])
        finally:
            ops.KERNELS.update(kept)
        torch.cuda.synchronize()
        wall_s = time.perf_counter() - t0
        launches = {k: v for k, v in ops.launch_counts().items() if v}
        routes = {k: {r: n for r, n in fn.route_launches.items() if n}
                  for k, fn in (("flash_attention", flash_attention), ("flash_attention_bwd", flash_attention_bwd))
                  if k in launches}
        by_input = {k: sum(n for (ex, kk, _, _), (n, _) in recorded.items() if ex == name and kk == k)
                    for k in EXAMPLE_KERNELS}
        print(f"  {name}: {wall_s:.2f} s; launches {launches}; attention by route {routes}; plain versions called "
              f"{spy_plain.calls}")
        if any(spy_plain.calls.values()):
            fail(f"phase 9 {name}: the plain versions ran on the card path: {spy_plain.calls}")
        if [k for k in want if not launches.get(k)]:
            fail(f"phase 9 {name}: launches {launches}, want every one of {want}")
        if any(set(r) != {"fma"} for r in routes.values()):
            fail(f"phase 9 {name}: f32 attention off its fma routes: {routes}")
        if any(by_input[k] != launches.get(k, 0) for k in EXAMPLE_KERNELS):
            fail(f"phase 9 {name}: the spies saw {by_input}, the wrappers counted {launches}")
    shutil.rmtree(ROOT / "build" / "chip_smoke_examples_ckpt", ignore_errors=True)
    examples_kernel_rows(recorded, check, check_grad, time_ms, bound, rows)
    print(f"  phase 9: {time.perf_counter() - t_phase:.1f} s")


def examples_kernel_rows(recorded, check, check_grad, time_ms, bound, rows) -> None:
    """Phase 9's kernel rows: each kernel of the examples' path on each input
    it was given there (the first call of each shape and options), against
    its plain version (``TOL``; the backward ``BWD_TOL``) and timed as phase
    4 (L2 flushed) beside its bound and SDPA (forward, backward through
    ``torch.autograd.grad``, or over the written slots with a boolean mask),
    with its launches in the example's run. The bound counts the (query,
    key) pairs the mask keeps and, in decode, the slots written."""
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels import ops, ref

    sources = {"flash_attention": ("src/repro_torch/kernels/csrc/flash_attention.cu",
                                   "src/repro/kernels/flash_attention.py:116"),
               "flash_attention_bwd": ("src/repro_torch/kernels/csrc/flash_attention_bwd.cu",
                                       "src/repro/models/attention.py:48 (no Pallas kernel: jax autodiff of "
                                       "blocked_attention)"),
               "flash_decode": ("src/repro_torch/kernels/csrc/flash_decode.cu",
                                "src/repro/kernels/flash_decode.py:89")}
    for (example, kname, shapes, opts), (n_main, (args, kw)) in recorded.items():
        kernel, plain = ops.KERNELS[kname], getattr(ref, EXAMPLE_KERNELS[kname])
        q, k, v = args[:3]
        dtype = str(q.dtype).split(".")[-1]
        es = q.element_size()
        B, Lq, H, Dk = q.shape
        Lk, KVH, Dv = k.shape[1], k.shape[2], v.shape[3]
        gqa = dict(enable_gqa=True) if H != KVH else {}
        label = f"examples/{example}.py {kname} at {list(shapes)}{' ' + str(dict(opts)) if opts else ''}"
        call = lambda: kernel(*args, **kw)  # noqa: E731
        want = plain(*args, **kw)
        got = call()
        qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
        if kname == "flash_decode":
            kpos, qpos, nval = args[3:6]
            ok = (torch.arange(Lk, device=q.device)[None] < nval[:, None]) & (kpos <= qpos[:, None])
            if kw.get("window", 0) > 0:
                ok &= kpos > qpos[:, None] - kw["window"]
            written, visible = int(nval.clamp(0, Lk).sum()), int(ok.sum())
            if kw.get("return_lse"):
                err = max(check(f"{label} o", got[0], want[0], got[0].dtype),
                          check(f"{label} lse", got[1], want[1], torch.float32))
            else:
                err = check(label, got, want, got.dtype)
            out_es = torch.empty((), dtype=kw.get("out_dtype") or q.dtype).element_size()
            # K, V of the written slots and their positions read once; q read, o (and lse) written once
            nbytes = (2 * written * KVH * Dk * es + written * 4 + B * H * Dk * es + B * H * Dk * out_es
                      + (B * H * 4 if kw.get("return_lse") else 0) + 2 * B * 4)
            b_ms, b_by = bound(nbytes, 4 * H * Dk * visible, dtype)
            lib = lambda: F.scaled_dot_product_attention(qt, kt, vt, attn_mask=ok[:, None, None], **gqa)  # noqa: E731
            library = "scaled_dot_product_attention(boolean mask)"
        else:
            mask = ref._attention_mask(Lq, Lk, kw.get("causal", True), kw.get("window", 0), q.device)
            pairs = int(mask.sum())
            if kname == "flash_attention":
                if kw.get("return_lse"):
                    err = max(check(f"{label} o", got[0], want[0], q.dtype),
                              check(f"{label} lse", got[1], want[1], torch.float32))
                else:
                    err = check(label, got, want, q.dtype)
                nbytes = (B * Lq * H * (Dk + Dv) + B * Lk * KVH * (Dk + Dv)) * es + (
                    B * H * Lq * 4 if kw.get("return_lse") else 0)
                b_ms, b_by = bound(nbytes, 2 * B * H * pairs * (Dk + Dv), dtype)
                lib = lambda: F.scaled_dot_product_attention(qt, kt, vt, attn_mask=mask, **gqa)  # noqa: E731
                library = "scaled_dot_product_attention(boolean mask)"
            else:
                err = max(check_grad(f"{label} {n}", g, w, q.dtype) for n, g, w in zip(("dq", "dk", "dv"), got, want))
                # q, dq, o and dO; k, dk, v and dv; lse: each read or written once. The five
                # products Q.K^T, dO.V^T, P^T.dO, dS.K, dS^T.Q: 6 Dk + 4 Dv FLOP a visible pair
                nbytes = B * Lq * H * (2 * Dk + 2 * Dv) * es + B * Lk * KVH * (2 * Dk + 2 * Dv) * es + B * H * Lq * 4
                b_ms, b_by = bound(nbytes, B * H * pairs * (6 * Dk + 4 * Dv), dtype)
                qt, kt, vt = (x.detach().requires_grad_() for x in (qt, kt, vt))
                lib_out = F.scaled_dot_product_attention(qt, kt, vt, attn_mask=mask, **gqa)
                dot = args[4].transpose(1, 2)
                lib = lambda: torch.autograd.grad(lib_out, (qt, kt, vt), dot, retain_graph=True)  # noqa: E731
                library = "scaled_dot_product_attention(boolean mask) backward (torch.autograd.grad)"
        del got, want
        source, replaces = sources[kname]
        rows.append(dict(
            name=kname, path=f"{label}, {dtype}", route="cuda", source=source, replaces=replaces, launches=n_main,
            max_abs_err=err, ms=time_ms(call, reps=10), plain_ms=time_ms(lambda: plain(*args, **kw), reps=3),
            bound_ms=b_ms, bound_by=b_by, library_ms=time_ms(lib, reps=10), library=library,
        ))
        r = rows[-1]
        print(f"  {label}: {r['ms']:.4f} ms, bound {b_ms:.4f} ms ({b_by}; {r['ms'] / b_ms:.2f}x), plain "
              f"{r['plain_ms']:.4f} ms, SDPA {r['library_ms']:.4f} ms; {n_main} launches in the example")
        torch.cuda.empty_cache()


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    import torch.nn.functional as F

    from repro_torch.configs import get_config
    from repro_torch.core import hashing
    from repro_torch.kernels import build, ops, ref
    from repro_torch.kernels.flash_attention import flash_attention, flash_attention_bwd
    from repro_torch.kernels.flash_decode import flash_decode, split_for
    from repro_torch.kernels.hash_tree import CHUNK_BLOCKS, hash_tree_state, hash_tree_states, max_payloads
    from repro_torch.kernels.mamba_scan import mamba_scan
    import repro_torch.kernels.mamba_scan as scan_module
    from repro_torch.kernels.moe_gmm import moe_gmm
    from repro_torch.kernels.moe_gmm import _route as gmm_route
    import repro_torch.kernels.moe_gmm as gmm_module
    from repro_torch.launch import serve
    from repro_torch.models import moe as moe_mod
    from repro_torch.models.registry import build_model, decode_step, init_serve_state, prefill
    from repro_torch.workspace import InlineExecutor, Workspace

    t_start = time.perf_counter()
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
    n_sms = torch.cuda.get_device_properties(0).multi_processor_count
    sm_clock_mhz = float(subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm", "--format=csv,noheader,nounits"],
        capture_output=True, text=True, check=True).stdout.split()[0])
    print(f"  {n_sms} SMs, highest SM clock {sm_clock_mhz} MHz")
    t0 = time.perf_counter()
    reports = build.build_all()
    print(f"build: {time.perf_counter() - t0:.1f}s for {sorted(reports)} (nvcc in parallel)")
    if reports:
        (build.BUILD_DIR / "nvcc_report.txt").write_text(
            "\n".join(f"== {n}\n{r}" for n, r in reports.items()))
    for n, r in reports.items():
        spills = spilling_entries(r)
        regs = sorted({l.split("Used ")[1].split(" registers")[0] for l in r.splitlines() if "Used " in l})
        print(f"  {n}: registers per thread {regs}; spilling entries: {spills or 'none'}")
        if any(name.startswith("wg::") for name, _ in spills):  # the wgmma routes hold their tiles in registers
            fail(f"{n}: a wgmma entry spills: {spills}")
        for l in r.splitlines():  # e.g. ptxas C7520: wgmma serialised
            if "Potential Performance Loss" in l:
                print(f"  {n}: {l.strip()}")
    for n, wanted in TENSOR_CORE_SASS.items():
        sass = subprocess.run([build.cuda_tool("cuobjdump"), "-sass", str(build.library_path(n))],
                              capture_output=True, text=True, check=True).stdout
        counts = {op: sass.count(op + ".") + sass.count(op + " ") for op in ("HGMMA", "HMMA")}
        print(f"  {n}: tensor-core instructions in the SASS {counts}")
        if not all(counts[op] for op in wanted):
            fail(f"{n}: the built library lacks {[op for op in wanted if not counts[op]]}")

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

    def decode_positions(B, S, nv, qp, slots):
        """(k_pos (B, S), q_pos (B,), n_valid (B,)) int32 for a DECODE_CASES layout."""
        i32 = dict(dtype=torch.int32, device=dev)
        kpos = torch.arange(S, **i32)
        if slots.startswith("ring:"):
            kpos = torch.roll(kpos + (qp - S + 1), int(slots[5:]))
        elif slots == "memory":
            kpos = torch.zeros(S, **i32)
        return kpos.expand(B, S).contiguous(), torch.full((B,), qp, **i32), torch.full((B,), nv, **i32)

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

    def check_grad(name, got, want, dtype):
        rtol, atol = BWD_TOL[str(dtype).split(".")[-1]]
        want = want.float()
        err = (got.float() - want).abs()
        if not torch.isfinite(got.float()).all():
            fail(f"{name}: non-finite output")
        bad = err > atol * want.abs().max() + rtol * want.abs()
        print(f"  {name}: max_abs_err {err.max().item():.3e} of max |value| {want.abs().max().item():.3e} "
              f"({'ok' if not bad.any() else 'FAIL'})")
        if bad.any():
            fail(f"{name}: {int(bad.sum())} elements beyond rtol {rtol} atol {atol} x max |value|")
        return err.max().item()

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

    # kernel times (phases 4 and 5e): L2 flushed before each launch by writing 256 MiB
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

    rows = []
    if sys.argv[1:] == ["--mesh-only"]:  # phases 6 and 6d alone, after phase 1's build (a probe; no summary line)
        mesh_phase(dev, rand, check, check_grad, time_ms, bound, rows, n_sms, sm_clock_mhz)
        serve_mesh_phase(rand, check, time_ms, bound, rows, n_sms, sm_clock_mhz)
        print(json.dumps({"kernels": rows}))
        return 0
    if sys.argv[1:] == ["--examples-only"]:  # phase 9 alone, after phase 1's build (a probe; no summary line)
        examples_phase(check, check_grad, time_ms, bound, rows)
        print(json.dumps({"kernels": rows}))
        return 0
    # -- 2. each kernel against its plain version ------------------------------
    print("phase 2: kernels vs plain versions on the card")
    jamba = get_config(HYBRID["arch"])
    E, D, Fd = jamba.n_experts, jamba.d_model, jamba.d_ff
    c_prefill = moe_mod.expert_capacity(HYBRID["batch"] * HYBRID["prompt_len"], jamba)  # 320: drops
    c_decode = moe_mod.expert_capacity(HYBRID["batch"], jamba)  # 4: drop-free
    mixtral = get_config(FOUR[0]["arch"])
    mix_shape = (mixtral.n_experts, mixtral.d_model, mixtral.d_ff)
    mix_c = {"prefill": moe_mod.expert_capacity(FOUR[0]["batch"] * FOUR[0]["prompt_len"], mixtral),  # 5104
             "decode": moe_mod.expert_capacity(FOUR[0]["batch"], mixtral)}  # 4
    gmm_cases = [c + ("sweep",) for c in GMM_CASES] + [
        (E, c_decode, D, Fd, "fan_in"), (E, c_prefill, D, Fd, "fan_in")] + [
        (mix_shape[0], mix_c[p], *mix_shape[1:], "fan_in") for p in ("decode", "prefill")]
    scan_cases = SCAN_CASES + [(HYBRID["batch"], HYBRID["prompt_len"], jamba.d_inner, jamba.ssm_state, True)]
    for dtype in (torch.float32, torch.bfloat16):
        for B, Lq, Lk, H, KVH, Dk, Dv, causal, window in ATTN_CASES:
            q, k, v = rand(B, Lq, H, Dk, dtype=dtype), rand(B, Lk, KVH, Dk, dtype=dtype), rand(B, Lk, KVH, Dv, dtype=dtype)
            got = flash_attention(q, k, v, causal=causal, window=window)
            want = ref.reference_attention(q, k, v, causal=causal, window=window)
            name = f"flash_attention {dtype} B{B} Lq{Lq} Lk{Lk} H{H}/{KVH} Dk{Dk} Dv{Dv} causal={causal} window={window}"
            check(name, got, want, dtype)
            del q, k, v, got, want
        torch.cuda.empty_cache()
        for B, S, H, KVH, Dh, window, nv, qp, slots in DECODE_CASES:
            q, k, v = rand(B, 1, H, Dh, dtype=dtype), rand(B, S, KVH, Dh, dtype=dtype), rand(B, S, KVH, Dh, dtype=dtype)
            kpos, qpos, nval = decode_positions(B, S, nv, qp, slots)
            got = flash_decode(q, k, v, kpos, qpos, nval, window=window)
            want = ref.reference_decode(q, k, v, kpos, qpos, nval, window=window)
            name = f"flash_decode {dtype} B{B} S{S} H{H}/{KVH} Dh{Dh} window={window} n_valid={nv} slots={slots}"
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
    # flash_decode's log-sum-exp (serving with the cache's slots split): each
    # case, its slices merged, and a row with no written slot
    decode_lse_checks(rand, check, decode_positions)
    # K1: the forward's log-sum-exp on both routes, then the backward on each
    # of its bf16 routes against its plain version, and bit-equal when run twice
    k1_checks(rand, check, check_grad)
    # K7: the moe_gmm and mamba_scan backward kernels against their plain
    # versions, bit-equal when run twice, and the scan's backward in segments
    k7_checks(rand, check_grad, gmm_inputs, scan_inputs, gmm_cases, scan_cases)

    # rows with no live key anywhere must stay finite (finite NEG_INF masking);
    # a decode step with every written slot masked weighs them all alike, as
    # the plain version does when every slot is written
    q, k = rand(1, 128, 4, 32, dtype=torch.bfloat16), rand(1, 32, 2, 32, dtype=torch.bfloat16)
    dead = flash_attention(q, k, k, causal=True, window=16)  # rows >= 47 see no key
    i32 = dict(dtype=torch.int32, device=dev)
    dead_args = (q[:, :1].contiguous(), k, k, torch.arange(32, **i32)[None].contiguous(),
                 torch.full((1,), -1, **i32), torch.full((1,), 32, **i32))
    dead_dec = flash_decode(*dead_args)
    torch.cuda.synchronize()
    if not (torch.isfinite(dead.float()).all() and torch.isfinite(dead_dec.float()).all()):
        fail("fully masked rows produced non-finite output")
    check("flash_decode with every slot masked by position", dead_dec, ref.reference_decode(*dead_args),
          torch.bfloat16)
    print("  fully masked rows: finite")

    # hash_tree: integer arithmetic mod 2**32, so every comparison is bit-equal
    chunk_words = hashing.TREE_BLOCK_WORDS * CHUNK_BLOCKS

    def u32(state):
        return tuple(int(x) & 0xFFFFFFFF for x in state.tolist())

    def check_state(name, words):
        got, want = u32(hash_tree_state(words)), u32(ref.reference_hash_tree(words))
        host = hashing.tree_state_np(words.cpu().numpy().view(np.uint8))
        print(f"  hash_tree {name}: kernel {got[0]:08x}.. plain {'=' if got == want else '!='} "
              f"host {'=' if got == host else '!='}")
        if not got == want == host:
            fail(f"hash_tree {name}: kernel {got} plain {want} host {host}")

    def check_states(name, u8s):
        """One hash_tree_states call on card payloads of any length: each state
        against its plain version and the host's numpy state, and each tree
        digest against the host digest of the .cpu() copy."""
        n0 = hash_tree_states.launches
        got = [u32(row) for row in hash_tree_states(u8s)]
        n_launch = hash_tree_states.launches - n0
        bad = []
        for i, (g, u8) in enumerate(zip(got, u8s)):
            want, host = u32(ref.reference_hash_tree_bytes(u8)), hashing.tree_state_np(u8.cpu().numpy())
            if not g == want == host or hashing.tree_digest(u8) != hashing.tree_digest(u8.cpu()):
                bad.append((i, u8.numel(), g, want, host))
        print(f"  hash_tree {name}: {len(u8s)} payloads in {n_launch} launch(es), kernel = plain = host "
              f"and card digest = host digest for {len(u8s) - len(bad)}")
        if bad or n_launch != -(-len(u8s) // max_payloads()):
            fail(f"hash_tree {name}: {n_launch} launches; (payload, bytes, kernel, plain, host) differing: {bad[:4]}")

    def check_digest(name, t):
        """The card route (the kernel on the whole payload) against the host
        digest of the .cpu() copy, and the kernel against its plain version."""
        card, host = hashing.content_hash(t), hashing.content_hash(t.cpu())
        print(f"  hash_tree digest {name}: card {card} host {host}")
        if card != host:
            fail(f"hash_tree digest {name}: card {card} != host {host}")
        check_states(f"{name} ({t.nbytes} B)", [t.contiguous().reshape(-1).view(torch.uint8)])

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

    def u8_rand(n):
        return torch.randint(0, 256, (n,), dtype=torch.uint8, generator=gen, device=dev)

    # ragged payloads in one launch: tails of 1-3 bytes, partial last blocks,
    # payloads shorter than one block (one CTA each) and long ones (many CTAs,
    # whose last reduces), an empty one and an odd-offset slice; run twice
    # (the tickets are back at 0), on a side stream, and 300 at once (3 launches)
    ragged = [u8_rand(n) for n in (1, 2, 3, 4, 5, 300, 511, 512, 513, 512 * 7 + 129, 8192 * 4 + 2,
                                   big + 1, big + 2, big + 3, 3 * big + 511, 0)]
    ragged.append(u8_rand(big + 64)[5:])
    check_states("ragged", ragged)
    check_states("ragged, again", ragged)
    side = torch.cuda.Stream(dev)
    side.wait_stream(torch.cuda.current_stream(dev))
    with torch.cuda.stream(side):
        check_states("ragged, on a side stream", ragged)
    torch.cuda.current_stream(dev).wait_stream(side)
    check_states("300 payloads", [u8_rand(n) for n in range(0, 300 * 4099, 4099)])
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
        "flash_attention_bwd": ref.reference_attention_bwd,
        "flash_decode": ref.reference_decode,
        "moe_gmm": ref.reference_gmm,
        "moe_gmm_bwd": ref.reference_gmm_bwd,
        "mamba_scan": lambda xc, dt, Bm, Cm, a, h0=None, chunk_len=0: ref.reference_selective_scan(
            xc, dt, Bm, Cm, a, h0),
        "mamba_scan_bwd": ref.reference_selective_scan_bwd,
    }

    # every MoE layer's routing (probs, top-k experts) and dropped share,
    # recorded while kernels and plain versions are compared (diagnostic only)
    routes: list = []
    drops: list = []
    # live slots per expert bin of the served run's first prefill and first
    # decode MoE call, by (arch, phase): phase 4 times moe_gmm on bins filled the same way
    served_fill: dict = {}
    route, moe_ffn = moe_mod.route, moe_mod.moe_ffn

    def recording_route(p, cfg, xf):
        out = route(p, cfg, xf)  # (probs, gate_w, gate_e)
        routes.append(out)
        return out

    def recording_moe_ffn(p, cfg, x, kernels=None):
        y, aux = moe_ffn(p, cfg, x, kernels=kernels)
        drops.append(aux["dropped_frac"])
        return y, aux

    def expected_launches(cfg, gen):
        """Each attention layer launches flash_attention once at prefill (and
        its cross-attention once more, as each encoder layer does) and
        flash_decode once a decode step (MLA decodes with plain matmuls; the
        cross-attention decodes too); Mamba and MoE layers one launch a step."""
        n = {"attention": 0, "mamba": 0, "moe": 0}
        for i in range(cfg.n_layers):
            spec = cfg.layout[i % len(cfg.layout)]
            n[spec.mixer] += 1
            n["moe"] += spec.ffn == "moe"
        cross = n["attention"] if cfg.cross_attention else 0
        self_decode = 0 if cfg.attention == "mla" else n["attention"]
        return {"flash_attention": n["attention"] + cross + cfg.encoder_layers, "flash_attention_bwd": 0,
                "flash_decode": (self_decode + cross) * (gen - 1),
                "moe_gmm": n["moe"] * gen, "moe_gmm_bwd": 0, "mamba_scan": n["mamba"], "mamba_scan_bwd": 0,
                "hash_tree": 0}

    def prefill_tokens(cfg, spec):
        """Token positions of one prefill: the vision prefix and the prompt."""
        return (cfg.frontend_len if cfg.frontend == "vision" else 0) + spec["prompt_len"]

    def expected_routes(cfg, spec, want):
        """The served model is bf16: every launch of flash_attention and
        moe_gmm takes its tensor-core route (moe_gmm by its bins' rows)."""
        n_moe_calls = want["moe_gmm"] // spec["gen"]  # per prefill or decode step
        steps = ((spec["batch"] * prefill_tokens(cfg, spec), 1), (spec["batch"], spec["gen"] - 1))
        gmm = dict.fromkeys(moe_gmm.route_launches, 0)
        for n_tokens, n_steps in steps:
            if n_moe_calls:
                c = moe_mod.expert_capacity(n_tokens, cfg)
                gmm[gmm_route(torch.bfloat16, cfg.n_experts, c, cfg.d_model, cfg.d_ff)] += n_moe_calls * n_steps
        return {"flash_attention": {"fma": 0, "mma": want["flash_attention"]}, "moe_gmm": gmm}

    def serve_checked(label, cfg, run_serve, spec, shapes=None):
        """Drive the serve entry once with every count at 0; returns (tokens,
        launches). Fails if a plain version ran (``PlainSpy``). With a dict
        ``shapes``, also counts each kernel's calls by its inputs' shapes
        there, {name: {shapes: calls}} (each call is one launch: the totals
        must equal the launch counts)."""
        calls_by_shape: dict = {}
        ops.reset_launch_counts()
        saved = dict(ops.KERNELS)
        if shapes is not None:
            for name in ("flash_attention", "flash_decode", "moe_gmm"):
                def counted(*args, _fn=saved[name], _name=name, **kwargs):
                    key = tuple(tuple(a.shape) for a in args[:3])
                    per = calls_by_shape.setdefault(_name, {})
                    per[key] = per.get(key, 0) + 1
                    return _fn(*args, **kwargs)

                ops.KERNELS[name] = counted
        try:
            with PlainSpy() as spy:
                tokens = run_serve()
                torch.cuda.synchronize()
        finally:
            ops.KERNELS.update(saved)
        launches = ops.launch_counts()
        routes_run = {"flash_attention": dict(flash_attention.route_launches),
                      "moe_gmm": dict(moe_gmm.route_launches)}
        want = expected_launches(cfg, spec["gen"])
        want_routes = expected_routes(cfg, spec, want)
        print(f"  {label}: launches {launches} (want {want}); by route {routes_run} (want {want_routes}); "
              f"plain versions called {spy.calls}")
        if launches != want:
            fail(f"{label}: launch counts {launches} != {want}")
        if cfg.dtype != "bfloat16" or routes_run != want_routes or want_routes["moe_gmm"]["fma"]:
            fail(f"{label}: route counts {routes_run} != {want_routes}: a bf16 launch missed its tensor-core route")
        if any(spy.calls.values()):
            fail(f"{label}: the plain versions ran on the card path: {spy.calls}")
        if tokens.shape != (spec["batch"], spec["gen"]) or not bool(((tokens >= 0) & (tokens < cfg.vocab)).all()):
            fail(f"{label}: bad generations {tuple(tokens.shape)}")
        if shapes is not None:
            for name, per in calls_by_shape.items():
                if sum(per.values()) != launches[name]:
                    fail(f"{label}: {name} called {sum(per.values())} times, launched {launches[name]}")
                print(f"    {name} calls by input shapes: {per}")
            shapes.update(calls_by_shape)
        return tokens, launches

    def compare_with_plain(cfg, spec, prompts, served, max_len, frontend=(None, None)):
        """Prefill + N_CHECK teacher-forced decode steps through the kernels and
        through the plain versions, in bf16 (the served model) and then in f32
        (the same seed's weights; one dtype's weights at a time). In each dtype, an MoE
        model runs the plain versions a second time with ``moe_mod.route``
        returning the kernels run's routing of the same call, so both runs
        dispatch the same slots and the logits differ by arithmetic alone;
        that run also records its own router's probabilities, for the gate.
        ``frontend``: the (frames, prefix) the served run took."""
        moe_mod.route, moe_mod.moe_ffn = recording_route, recording_moe_ffn
        n_moe = sum(s.ffn == "moe" for s in cfg.layout) * cfg.n_groups
        try:
            for dtype in ("bfloat16", "float32"):
                frames, prefix = frontend
                torch.cuda.reset_peak_memory_stats()
                model = build_model(dataclasses.replace(cfg, dtype=dtype))
                params = model.init(spec["seed"], dev)
                runs, rec = {}, {}
                passes = [("kernels", None), ("plain", plain)]
                if n_moe:
                    passes.append(("plain, kernels' routing", plain))
                for label, kernels in passes:
                    routes.clear()
                    drops.clear()
                    if label == "plain, kernels' routing":
                        replay = iter(rec["kernels"][0])

                        def replay_route(p, c, xf):
                            recording_route(p, c, xf)  # this run's own router, recorded
                            return next(replay)

                        moe_mod.route = replay_route
                    with torch.inference_mode():
                        state = init_serve_state(model, spec["batch"], max_len, dev)
                        lg, state = prefill(model, params, prompts, state, kernels=kernels, frames=frames,
                                            prefix=prefix)
                        steps = [lg.float()]
                        for t in range(N_CHECK):  # teacher-forced with the served tokens
                            lg, state = decode_step(model, params, served[:, t : t + 1], state, kernels=kernels)
                            steps.append(lg.float())
                    moe_mod.route = recording_route
                    if label == "plain, kernels' routing" and next(replay, None) is not None:
                        fail(f"{cfg.name}: the forced-routing run used fewer routings than the kernels run")
                    runs[label] = torch.stack(steps, dim=1)  # (B, 1 + N_CHECK, V)
                    rec[label] = (list(routes), [d.item() for d in drops])
                    del state
                    torch.cuda.empty_cache()
                if dtype == cfg.dtype and n_moe:
                    for phase, (_, _, gate_e) in (("prefill", rec["kernels"][0][0]),
                                                  ("decode", rec["kernels"][0][n_moe])):
                        C = moe_mod.expert_capacity(gate_e.shape[0], cfg)  # the dispatch keeps the first C
                        served_fill[cfg.name, phase] = torch.bincount(
                            gate_e.reshape(-1), minlength=cfg.n_experts).clamp(max=C)
                print(f"  {cfg.name} {dtype}: peak memory of the three runs "
                      f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
                report_logits(cfg, dtype, runs, rec, spec["batch"], served)
                del params, runs, rec
                torch.cuda.empty_cache()
        finally:
            moe_mod.route, moe_mod.moe_ffn = route, moe_ffn

    disagreements: list = []  # failed logit comparisons, reported at the end

    def disagree(msg):
        print(f"  FAIL: {msg}")
        disagreements.append(msg)

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
        for i, ((pk, _, ek), (pp, _, ep)) in enumerate(zip(rk, rp)):
            n_tok += ek.shape[0]
            flip = (torch.zeros_like(pk, dtype=torch.bool).scatter_(1, ek, True)
                    != torch.zeros_like(pp, dtype=torch.bool).scatter_(1, ep, True)).any(-1)
            n_flip += int(flip.sum())
            n_order += int(((ek != ep).any(-1) & ~flip).sum())
            max_dprob = max(max_dprob, (pk - pp).abs().max().item())
            rerouted[flip.view(batch, -1).any(-1), i // n_moe :] = True
        free_failures, st = logit_comparison(runs["kernels"], runs["plain"], LOGIT_TOL[dtype])
        row_diff = st["row_diff"]
        print(f"  {name} {dtype}: prefill + {N_CHECK} decode steps, kernels vs plain on the card: max |logit diff| "
              f"{st['diff']:.4e} (tol {LOGIT_TOL[dtype]}); greedy tokens agree {st['agree']}/{st['n']}, "
              f"ties within error {st['ties']}")
        if n_moe:
            def worst(mask):
                return f"{row_diff[mask].max().item():.4e}" if mask.any() else "-"

            print(f"    routing: {n_flip} of {n_tok} token top-k sets differ (+{n_order} in order only), "
                  f"max |router prob diff| {max_dprob:.3e}; max |logit diff| on the {int(rerouted.sum())} "
                  f"(row, step) a flip reaches {worst(rerouted)}, on the other {int((~rerouted).sum())} "
                  f"{worst(~rerouted)}; prefill slots dropped (capacity) kernels {sum(dk[:n_moe]) / n_moe:.4%} "
                  f"plain {sum(dp[:n_moe]) / n_moe:.4%}")
        forced = runs.get("plain, kernels' routing")
        if forced is None:
            if free_failures:
                disagree(f"{name} {dtype}: kernels vs plain versions: {'; '.join(free_failures)}")
            return
        # With a router, near-tied top-k routings flip between the two free
        # runs: in bf16 on every seed, with exact and inexact moe_gmm alike, and
        # in f32 on some seeds too, so the free comparison above measures which
        # ties flip. The gate is the run on the kernels' routing: both dispatch
        # the same slots, the gap is arithmetic.
        print(f"    the free-routing comparison above does not gate ({'would fail' if free_failures else 'would pass'}):"
              f" its outcome depends on which near-tied top-k routings flip; the run on the kernels' routing gates")
        (rf, _) = rec["plain, kernels' routing"]
        failures, st = forced_routing_gate(
            runs["kernels"], forced, [r[0] for r in rk], [r[0] for r in rf], [r[2] for r in rk],
            logit_tol=LOGIT_TOL[dtype], prob_tol=ROUTER_PROB_TOL)
        print(f"  {name} {dtype}, plain versions on the kernels' routing: max |logit diff| {st['diff']:.4e} "
              f"(tol {LOGIT_TOL[dtype]}); greedy tokens agree {st['agree']}/{st['n']}, ties within error "
              f"{st['ties']}; max |router prob diff| {st['dprob']:.4e} (tol {ROUTER_PROB_TOL:.4e}); the plain run's "
              f"own router would choose another top-k set for {st['rerouted']} of {st['tokens']} tokens")
        if failures:
            disagree(f"{name} {dtype}: on the kernels' routing: {'; '.join(failures)}")

    def steady_and_profiled(cfg, spec, prompts, max_len, frontend=(None, None)):
        """Warm serve times and the device's busy share (not part of the counted
        run: the launch counts are final). Returns {"prefill_s", "decode_tok_s",
        "decode_step_s" (the mean of N_STEADY warm steps), "prefill_idle",
        "decode_idle"}."""
        model = build_model(cfg)
        params = model.init(spec["seed"], dev)
        frames, prefix = frontend
        box, out = {}, {}

        def run_prefill():
            box["state"] = init_serve_state(model, spec["batch"], max_len, dev)
            lg, box["state"] = prefill(model, params, prompts, box["state"], frames=frames, prefix=prefix)
            box["tok"] = lg.argmax(-1)[:, None]

        def run_decode():
            for _ in range(N_STEADY):
                lg, box["state"] = decode_step(model, params, box["tok"], box["state"])
                box["tok"] = lg.argmax(-1)[:, None]

        with torch.inference_mode():
            for _ in range(2):  # the second pass is warm
                prefill_s, decode_s = wall(run_prefill), wall(run_decode)
            step_ms = decode_s / N_STEADY * 1e3
            out.update(prefill_s=prefill_s, decode_tok_s=spec["batch"] * N_STEADY / decode_s,
                       decode_step_s=decode_s / N_STEADY)
            print(f"  {cfg.name} steady: prefill {spec['batch']}x{prefill_tokens(cfg, spec)} {prefill_s * 1e3:.2f} ms; "
                  f"decode {step_ms:.2f} ms/step ({out['decode_tok_s']:.1f} tok/s)")
            for name, fn in (("prefill", run_prefill), ("decode", run_decode)):
                if name == "decode":
                    run_prefill()
                t, busy, kern, _ = device_profile(fn)
                by_name: dict = {}
                for e in kern:
                    by_name[e.name[:48]] = by_name.get(e.name[:48], 0.0) + e.time_range.elapsed_us() / 1e3
                top = sorted(by_name.items(), key=lambda kv: -kv[1])[:6]
                out[f"{name}_idle"] = 1 - busy / t
                print(f"  {cfg.name} profiled {name}: wall {t * 1e3:.2f} ms, device busy {busy * 1e3:.2f} ms "
                      f"(idle share {1 - busy / t:.3f}), {len(kern)} kernels; top ms: "
                      + "; ".join(f"{n} {ms:.3f}" for n, ms in top))
        del params, box
        torch.cuda.empty_cache()
        return out

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
    measured = {"decode_step_s": steady_and_profiled(cfg, SERVE, prompts, max_len)["decode_step_s"]}
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
    # the wave's 64 payloads in one content_hash_batch: one launch, digests
    # equal to the host's
    n0 = hash_tree_states.launches
    wave_digests = hashing.content_hash_batch(wave)
    wave_hash_launches = hash_tree_states.launches - n0
    host_digests = hashing.content_hash_batch([x.cpu() for x in wave])
    print(f"  content_hash_batch of the wave: {wave_hash_launches} hash_tree launch; digests equal to the host "
          f"digests of the .cpu() copies for {sum(a == b for a, b in zip(wave_digests, host_digests))} of {n_wave}")
    if wave_hash_launches != 1 or wave_digests != host_digests:
        fail(f"circuit: content_hash_batch of the wave made {wave_hash_launches} launches (want 1), "
             f"digests equal to the host's: {wave_digests == host_digests}")
    hash_s = min(wall(lambda: hashing.content_hash_batch(wave)) for _ in range(5))
    wave_gb = n_wave * WAVE["nbytes"] / 1e9
    print(f"  pass 1: {first_s * 1e3:.2f} ms, {n_wave / first_s:.1f} pushes/s; replay: {replay_s * 1e3:.2f} ms, "
          f"{n_wave / replay_s:.1f} pushes/s; 1 GiB push {big_s * 1e3:.2f} ms; content_hash_batch of the wave "
          f"(warm, best of 5) {hash_s * 1e3:.3f} ms, {wave_gb / hash_s:.1f} GB/s hashed")
    # each call makes one copy of <= 768 B to the host (its one launch is
    # counted by the wrapper above), counted at the dispatcher. torch.profiler
    # drops the device records of some calls of such a window (4 calls have
    # recorded 3 copies, and 2), so its copies are held only to at most one a
    # call and to the bound; they give the device-busy time of a recorded call
    n_calls, box = 4, {}
    d2h_bound = n_wave * 12  # the 12-byte states, in one copy a call
    counted = device_to_host_copies(lambda: [hashing.content_hash_batch(wave) for _ in range(n_calls)])
    print(f"  content_hash_batch of the wave ({n_calls} calls): device-to-host copies counted at the dispatcher "
          f"{counted} B (want 1 a call of <= {d2h_bound} B)")
    if len(counted) != n_calls or max(counted) > d2h_bound:
        fail(f"circuit: device-to-host copies {counted} B in {n_calls} calls, want 1 copy of <= {d2h_bound} B a call")

    def hash_calls():
        time.sleep(0.02)
        box["t"] = wall(lambda: [hashing.content_hash_batch(wave) for _ in range(n_calls)])

    _, busy, kern, prof = device_profile(hash_calls)
    t = box["t"]
    trace = build.BUILD_DIR / "hash_wave_trace.json"
    prof.export_chrome_trace(str(trace))
    copies = [int(e.get("args", {}).get("bytes", 0)) for e in json.loads(trace.read_text())["traceEvents"]
              if e.get("cat") == "gpu_memcpy" and "DtoH" in e.get("name", "")]
    n_rec = max(1, len(copies))
    print(f"  profiled content_hash_batch of the wave ({n_calls} calls): wall {t / n_calls * 1e3:.3f} ms a call; "
          f"{len(kern)} device events recorded ({sum('hash_tree' in e.name for e in kern)} hash_tree), device busy "
          f"{busy / n_rec * 1e3:.3f} ms a recorded call (idle share {1 - busy / n_rec / (t / n_calls):.3f}); "
          f"device-to-host copies recorded {copies} B (bound {d2h_bound} B in 1 a call)")
    if len(copies) > n_calls or any(c > d2h_bound for c in copies):
        fail(f"circuit: the profiler recorded device-to-host copies {copies} B in {n_calls} calls, "
             f"want at most 1 copy of <= {d2h_bound} B a call")
    ws2, task2 = circuit()
    t, busy, kern, _ = device_profile(lambda: push_all(ws2, task2, wave))
    print(f"  profiled first pass on a fresh workspace: wall {t * 1e3:.2f} ms ({n_wave / t:.1f} pushes/s), "
          f"device busy {busy * 1e3:.3f} ms (idle share {1 - busy / t:.3f}), {len(kern)} device events")
    ws3, task3 = circuit()
    by_layer, layer_ops, t_ms = host_time_by_layer(lambda: push_all(ws3, task3, wave), engine_layers(),
                                                   torch.cuda.synchronize)
    print(f"  host time of a first pass by layer (torch.profiler CPU trace, fresh workspace; exclusive ms, "
          f"us a push): wall {t_ms:.2f} ms; "
          + "; ".join(f"{k} {v:.3f} ({v / n_wave * 1e3:.1f})" for k, v in by_layer.items()))
    for layer in sorted(layer_ops, key=lambda k: -by_layer[k])[:3]:
        top = sorted(layer_ops[layer].items(), key=lambda kv: -kv[1])[:4]
        print(f"    {layer}: its torch operations' own ms: " + "; ".join(f"{n} {ms:.3f}" for n, ms in top))
    del ws, ws2, ws3, wave, big_x, prof
    torch.cuda.empty_cache()

    # -- 3e. the durable, zoned circuit on card payloads --------------------------
    durable_phase(dev, wall, time_ms, rows, (first_s, replay_s))

    # -- 3f. the multi-tenant hub on card payloads -------------------------------
    hub_phase(dev, smi[0], wall, time_ms, rows, device_profile)

    # -- 3d. serve the last four architectures at full width ---------------------
    four_shapes: dict = {}  # arch -> {kernel: {input shapes: calls}} of its served run
    for spec in FOUR:
        full = get_config(spec["arch"])
        cfg4 = dataclasses.replace(full, n_layers=spec.get("n_layers", full.n_layers))
        print(f"phase 3d: serve {spec['arch']} at full width, {cfg4.n_layers} of {full.n_layers} layers, bf16, "
              f"batch {spec['batch']}, prompt {spec['prompt_len']}, {spec['gen']} tokens"
              + (f", frontend {cfg4.frontend} of {cfg4.frontend_len}" if cfg4.frontend != "none" else ""))
        if cfg4.n_layers != full.n_layers:
            run_serve = lambda: serve.run(cfg4, spec["batch"], spec["prompt_len"], spec["gen"], spec["seed"], "cuda")
        else:
            argv4 = ["--arch", spec["arch"], "--batch", str(spec["batch"]), "--prompt-len", str(spec["prompt_len"]),
                     "--gen", str(spec["gen"]), "--seed", str(spec["seed"]), "--device", "cuda"]
            run_serve = lambda: serve.main(argv4)
        four_shapes[spec["arch"]] = {}
        tokens4, _ = serve_checked(spec["arch"], cfg4, run_serve, spec, four_shapes[spec["arch"]])
        max_len4 = serve.serve_max_len(cfg4, spec["prompt_len"], spec["gen"])
        prompts4 = serve.make_prompts(cfg4.vocab, spec["batch"], spec["prompt_len"], spec["seed"] + 1, dev)
        frontend = serve.make_frontend(cfg4, spec["batch"], spec["seed"], dev)
        compare_with_plain(cfg4, spec, prompts4, tokens4, max_len4, frontend)
        steady_and_profiled(cfg4, spec, prompts4, max_len4, frontend)
        del tokens4, prompts4, frontend
        torch.cuda.empty_cache()

    # -- 4. time each kernel at the serving shapes -------------------------------
    print("phase 4: timing at the serving shapes (bf16, L2 flushed before each launch)")
    bf = torch.bfloat16
    es = 2

    def on_fma(fn):
        """fn() with moe_gmm's route forced to "fma": its FMA kernel on the
        same bf16 inputs, timed beside the tensor-core route."""
        chosen = gmm_module._route
        gmm_module._route = lambda *args: "fma"
        try:
            return fn()
        finally:
            gmm_module._route = chosen

    def equal_share(got, want):
        """Share of the outputs bit-equal to the plain version's, in the working dtype."""
        return (got == want.to(got.dtype)).float().mean().item()

    def before_after(name, call, want):
        fma_ms = time_ms(lambda: on_fma(call))
        eq, eq_fma = equal_share(call(), want), equal_share(on_fma(call), want)
        print(f"  {name}: the FMA route on the same inputs {fma_ms:.4f} ms; outputs equal to the "
              f"plain version's: tensor-core route {eq:.5f}, FMA route {eq_fma:.5f}")

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
            name="flash_attention", path=f"{path} prefill, route mma", route="cuda",
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
        eq = equal_share(flash_attention(q, k, v), ref.reference_attention(q, k, v))
        print(f"  flash_attention at {path} prefill: outputs equal to the plain version's {eq:.5f}")

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
            n_split=split_for(q1, k),
        ))
        eq = equal_share(flash_decode(q1, k, v, kpos, qpos, nval), ref.reference_decode(q1, k, v, kpos, qpos, nval))
        print(f"  flash_decode at {path} decode: n_split {rows[-1]['n_split']} (clusters of "
              f"{rows[-1]['n_split']} blocks, {B * KVH * rows[-1]['n_split']} blocks on {n_sms} SMs); outputs "
              f"equal to the plain version's {eq:.5f}")

    attention_rows(cfg, SERVE, launches["flash_attention"], launches["flash_decode"])
    attention_rows(hcfg, HYBRID, hlaunches["flash_attention"], hlaunches["flash_decode"])

    def gmm_rows(gcfg, spec, launches, reps, plain_reps, with_fma=True):
        """moe_gmm at a served model's prefill and decode bins, filled as its
        served run filled them; ``launches``, ``reps``, ``plain_reps``: by
        phase. ``with_fma``: also time its FMA route on the same inputs."""
        E, D, Fd = gcfg.n_experts, gcfg.d_model, gcfg.d_ff
        for phase in ("prefill", "decode"):
            C = moe_mod.expert_capacity(spec["batch"] * (prefill_tokens(gcfg, spec) if phase == "prefill" else 1), gcfg)
            x_full, wg, wu, wd = gmm_inputs(E, C, D, Fd, "fan_in", bf)
            # the served run's bin fill: each bin's slots past its tokens are zeros
            fill = served_fill[gcfg.name, phase]
            x = x_full.masked_fill((torch.arange(C, device=dev) >= fill[:, None])[..., None], 0)
            nbytes = 2 * E * C * D * es + 3 * E * D * Fd * es  # x and out once; every expert's weights once
            b_ms, b_by = bound(nbytes, 6 * E * C * D * Fd, "bfloat16")
            err = check(f"moe_gmm at {spec['arch']} {phase} shape (E{E} C{C})", moe_gmm(x, wg, wu, wd),
                        ref.reference_gmm(x, wg, wu, wd), bf)

            def library_gmm(x):  # three torch.bmm calls and F.silu compute the same function
                return torch.bmm(F.silu(torch.bmm(x, wg)) * torch.bmm(x, wu), wd)

            lib_err = (library_gmm(x).float() - ref.reference_gmm(x, wg, wu, wd).float()).abs().max().item()
            rows.append(dict(
                name="moe_gmm", path=f"{spec['arch']} {phase} (C {C}), route {gmm_route(bf, E, C, D, Fd)}",
                route="cuda",
                source="src/repro_torch/kernels/csrc/moe_gmm.cu",
                replaces="src/repro/kernels/moe_gmm.py:59", launches=launches[phase],
                max_abs_err=err,
                ms=time_ms(lambda: moe_gmm(x, wg, wu, wd), reps=reps[phase]),
                plain_ms=time_ms(lambda: ref.reference_gmm(x, wg, wu, wd), reps=plain_reps[phase]),
                bound_ms=b_ms, bound_by=b_by,
                library_ms=time_ms(lambda: library_gmm(x), reps=reps[phase]),
                library="3 calls: torch.bmm x3 + F.silu",
            ))
            print(f"  library (3x torch.bmm + F.silu) vs plain at {spec['arch']} {phase}: max_abs_err {lib_err:.3e}")
            print(f"  moe_gmm at {spec['arch']} {phase}: {int(fill.sum())} of {E * C} slots live as in the served "
                  f"run; on fully random bins {time_ms(lambda: moe_gmm(x_full, wg, wu, wd), reps=reps[phase]):.4f} ms, "
                  f"library {time_ms(lambda: library_gmm(x_full), reps=reps[phase]):.4f} ms")
            if with_fma:
                before_after(f"moe_gmm at {spec['arch']} {phase}", lambda: moe_gmm(x, wg, wu, wd),
                             ref.reference_gmm(x, wg, wu, wd))
            del x, x_full, wg, wu, wd
            torch.cuda.empty_cache()

    n_moe = sum(s.ffn == "moe" for s in hcfg.layout) * hcfg.n_groups
    gmm_rows(hcfg, HYBRID, {"prefill": n_moe, "decode": n_moe * (HYBRID["gen"] - 1)},
             {"prefill": 10, "decode": 30}, {"prefill": 10, "decode": 30})

    # phase 3d's shapes: launches are the calls of that shape in its served run
    def served_calls(arch, name, *shapes):
        n = four_shapes[arch].get(name, {}).get(tuple(shapes), 0)
        if not n:
            fail(f"phase 4: {name} at {shapes} is not on {arch}'s main path")
        return n

    def attn_row(arch, label, B, Lq, Lk, H, KVH, Dk, Dv, causal, window):
        q, k, v = rand(B, Lq, H, Dk, dtype=bf), rand(B, Lk, KVH, Dk, dtype=bf), rand(B, Lk, KVH, Dv, dtype=bf)
        n = served_calls(arch, "flash_attention", q.shape, k.shape, v.shape)
        mask = ref._attention_mask(Lq, Lk, causal, window, dev)
        pairs, live = int(mask.sum()), int(mask.any(0).sum())  # (q, k) pairs; keys some query sees
        nbytes = B * Lq * H * (Dk + Dv) * es + B * live * KVH * (Dk + Dv) * es  # q, o; the live k, v
        b_ms, b_by = bound(nbytes, 2 * B * H * pairs * (Dk + Dv), "bfloat16")
        if causal and torch.equal(mask, ref._attention_mask(Lq, Lk, True, 0, dev)):
            sdpa_kw, lib = dict(is_causal=True), "scaled_dot_product_attention(is_causal=True)"
        elif not causal and window == 0:
            sdpa_kw, lib = {}, "scaled_dot_product_attention"
        else:
            sdpa_kw, lib = dict(attn_mask=mask), "scaled_dot_product_attention(boolean mask)"
        if H != KVH:
            sdpa_kw["enable_gqa"] = True
        qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
        call = lambda: flash_attention(q, k, v, causal=causal, window=window)
        plain_call = lambda: ref.reference_attention(q, k, v, causal=causal, window=window)
        want = plain_call()
        err = check(f"flash_attention at {arch} {label}", call(), want, bf)
        lib_err = (F.scaled_dot_product_attention(qt, kt, vt, **sdpa_kw).transpose(1, 2).float()
                   - want.float()).abs().max().item()
        print(f"  library ({lib}) vs plain at {arch} {label}: max_abs_err {lib_err:.3e}; flash_attention "
              f"outputs equal to the plain version's {equal_share(call(), want):.5f}")
        del want
        rows.append(dict(
            name="flash_attention", path=f"{arch} {label}, (Dk {Dk}, Dv {Dv}), route mma", route="cuda",
            source="src/repro_torch/kernels/csrc/flash_attention.cu",
            replaces="src/repro/kernels/flash_attention.py:116", launches=n,
            max_abs_err=err, ms=time_ms(call), plain_ms=time_ms(plain_call, reps=3),
            bound_ms=b_ms, bound_by=b_by,
            library_ms=time_ms(lambda: F.scaled_dot_product_attention(qt, kt, vt, **sdpa_kw)), library=lib,
        ))
        del q, k, v, qt, kt, vt
        torch.cuda.empty_cache()

    def decode_row(arch, label, B, S, H, KVH, Dh, window, nv, qp, slots):
        q1, k, v = rand(B, 1, H, Dh, dtype=bf), rand(B, S, KVH, Dh, dtype=bf), rand(B, S, KVH, Dh, dtype=bf)
        n = served_calls(arch, "flash_decode", q1.shape, k.shape, v.shape)
        kpos, qpos, nval = decode_positions(B, S, nv, qp, slots)
        nbytes = 2 * B * nv * KVH * Dh * es + 2 * B * H * Dh * es + B * nv * 4 + 2 * B * 4
        b_ms, b_by = bound(nbytes, 4 * B * H * Dh * nv, "bfloat16")
        ok = (torch.arange(S, device=dev)[None] < nval[:, None]) & (kpos <= qpos[:, None])
        if window > 0:
            ok &= kpos > qpos[:, None] - window
        q1t, kt, vt = (x.transpose(1, 2) for x in (q1, k, v))
        gqa = dict(enable_gqa=True) if H != KVH else {}
        call = lambda: flash_decode(q1, k, v, kpos, qpos, nval, window=window)
        plain_call = lambda: ref.reference_decode(q1, k, v, kpos, qpos, nval, window=window)
        err = check(f"flash_decode at {arch} {label}", call(), plain_call(), bf)
        rows.append(dict(
            name="flash_decode", path=f"{arch} {label}", route="cuda",
            source="src/repro_torch/kernels/csrc/flash_decode.cu",
            replaces="src/repro/kernels/flash_decode.py:89", launches=n,
            max_abs_err=err, ms=time_ms(call), plain_ms=time_ms(plain_call),
            bound_ms=b_ms, bound_by=b_by,
            library_ms=time_ms(lambda: F.scaled_dot_product_attention(q1t, kt, vt, attn_mask=ok[:, None, None],
                                                                      **gqa)),
            library="scaled_dot_product_attention(boolean mask)", n_split=split_for(q1, k),
        ))
        print(f"  flash_decode at {arch} {label}: n_split {rows[-1]['n_split']}; outputs equal to the plain "
              f"version's {equal_share(call(), plain_call()):.5f}")
        del q1, k, v, q1t, kt, vt
        torch.cuda.empty_cache()

    for args in FOUR_ATTN_ROWS:
        attn_row(*args)
    for args in FOUR_DECODE_ROWS:
        decode_row(*args)
    mix = dataclasses.replace(get_config(FOUR[0]["arch"]), n_layers=FOUR[0]["n_layers"])
    mix_calls = four_shapes[mix.name]["moe_gmm"]
    mix_launches = {}
    for phase in ("prefill", "decode"):
        C = moe_mod.expert_capacity(FOUR[0]["batch"] * (FOUR[0]["prompt_len"] if phase == "prefill" else 1), mix)
        E_, D_, F_ = mix.n_experts, mix.d_model, mix.d_ff
        mix_launches[phase] = served_calls(mix.name, "moe_gmm", (E_, C, D_), (E_, D_, F_), (E_, D_, F_))
    print(f"  mixtral moe_gmm calls by shape in its served run: {mix_calls}")
    # its FMA route is not timed here: at 14.4 TFLOP a prefill call it would take seconds a launch
    gmm_rows(mix, FOUR[0], mix_launches, {"prefill": 5, "decode": 30}, {"prefill": 2, "decode": 10}, with_fma=False)

    B, L, Di, N = HYBRID["batch"], HYBRID["prompt_len"], hcfg.d_inner, hcfg.ssm_state
    xc, dt, Bm, Cm, a, h0 = scan_inputs(B, L, Di, N, True, bf)
    # xc (bf16) and dt read once, B/C/a/h0 read once, y and h written once
    nbytes = B * L * Di * (es + 4 + 4) + 2 * B * L * N * 4 + Di * N * 4 + 2 * B * Di * N * 4
    b_ms, b_by, sfu_ms = scan_bound(B * L * Di * N, nbytes, n_sms, sm_clock_mhz)
    print(f"  mamba_scan bound at {HYBRID['arch']} prefill: {b_ms:.4f} ms ({b_by}; bytes "
          f"{nbytes / PEAK_BYTES_PER_S * 1e3:.4f} ms; {B * L * Di * N} exponentials shared between the SFU, "
          f"{SFU_PER_CLOCK} a clock per SM on {n_sms} SMs at {sm_clock_mhz} MHz, and the FMA pipes); the SFU "
          f"alone would take {sfu_ms:.4f} ms")
    y, h = mamba_scan(xc, dt, Bm, Cm, a, h0)
    yr, hr = ref.reference_selective_scan(xc, dt, Bm, Cm, a, h0)
    err = max(check(f"mamba_scan at {HYBRID['arch']} prefill shape y", y, yr, torch.float32, SCAN_TOL),
              check(f"mamba_scan at {HYBRID['arch']} prefill shape h", h, hr, torch.float32, SCAN_TOL))
    print(f"  mamba_scan at {HYBRID['arch']} prefill: outputs equal to the plain version's: y "
          f"{equal_share(y, yr):.5f}, h {equal_share(h, hr):.5f}")
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
    # F1: the same scan cut into segments of 200 steps (the offset limit
    # patched small: 3 launches, each seeded with the last one's h), against
    # the one launch above; the scan is sequential, so the two are bit-equal
    limit = scan_module.OFFSET_LIMIT
    scan_module.OFFSET_LIMIT = (200 + scan_module.MAX_AHEAD) * Di + 1
    try:
        n0 = mamba_scan.launches
        ys, hs = mamba_scan(xc, dt, Bm, Cm, a, h0)
        n_seg = mamba_scan.launches - n0
    finally:
        scan_module.OFFSET_LIMIT = limit
    seg_diff = max((ys - y).abs().max().item(), (hs - h).abs().max().item())
    seg_equal = torch.equal(ys, y) and torch.equal(hs, h)
    print(f"  mamba_scan at {HYBRID['arch']} prefill in {n_seg} segments (offset limit patched small) vs one "
          f"launch: max |diff| {seg_diff:.3e}, bit-equal {seg_equal}")
    if n_seg != 3 or not seg_equal:
        fail(f"mamba_scan: {n_seg} segment launches (want 3), bit-equal to one launch: {seg_equal}")
    del xc, dt, Bm, Cm, a, h0, y, h, yr, hr, ys, hs
    # hash_tree at phase 3c's payloads: reads each byte once, writes 12 bytes a
    # payload; about one integer add per word is far below any rate of the
    # card, so the bound is bytes. No PyTorch call computes this function.
    def payload(nbytes):
        return torch.randint(-2**31, 2**31, (nbytes // 4,), dtype=torch.int32, generator=gen, device=dev)

    for label, nbytes, n_launch in (("4.5 MiB", WAVE["nbytes"], wave_launches),
                                    ("1 GiB", WAVE["big_nbytes"], launches3c["hash_tree"] - wave_launches)):
        w = payload(nbytes)
        got, want = hash_tree_state(w), ref.reference_hash_tree(w)
        if not torch.equal(got, want):
            fail(f"hash_tree at {label}: kernel {got.tolist()} != plain {want.tolist()}")
        rows.append(dict(
            name="hash_tree", path=f"circuit digest of a {label} payload, one launch", route="cuda",
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
    # B14's wave (64 x 4.5 MiB) as phase 3c's content_hash_batch hashes it: one launch
    wave_u8 = [payload(WAVE["nbytes"]).view(torch.uint8) for _ in range(WAVE["n"])]
    got = hash_tree_states(wave_u8)
    want = torch.stack([ref.reference_hash_tree_bytes(u) for u in wave_u8])
    if not torch.equal(got, want):
        fail(f"hash_tree on the wave: {int((got != want).any(-1).sum())} of {WAVE['n']} states differ from the plain")
    rows.append(dict(
        name="hash_tree", path=f"content_hash_batch of the wave ({WAVE['n']} x 4.5 MiB), one launch", route="cuda",
        source="src/repro_torch/kernels/csrc/hash_tree.cu",
        replaces="src/repro/kernels/hash_tree.py:74", launches=wave_hash_launches,
        max_abs_err=0.0,
        ms=time_ms(lambda: hash_tree_states(wave_u8)),
        plain_ms=time_ms(lambda: torch.stack([ref.reference_hash_tree_bytes(u) for u in wave_u8]), reps=3),
        bound_ms=WAVE["n"] * (WAVE["nbytes"] + 12) / PEAK_BYTES_PER_S * 1e3, bound_by="bytes",
        library_ms=None, library="none",
    ))
    del wave_u8, got, want
    torch.cuda.empty_cache()

    # -- 5. train stablelm-1.6b at full width ----------------------------------
    measured["train_step_s"] = training_phase(dev, rand, check, check_grad, time_ms, bound, rows, plain,
                                              device_profile, fail)
    # -- 5g. train jamba-v0.1-52b at full width, 2 layers; mixtral's gated step -
    measured["hybrid_step_s"] = hybrid_training_phase(dev, rand, check_grad, time_ms, bound, rows, plain,
                                                      device_profile, n_sms, sm_clock_mhz)
    # -- 5h. train minicpm3-4b, seamless-m4t-medium and internvl2-1b at full width
    frontend_training_phase(dev, rand, check, check_grad, time_ms, bound, rows, plain, device_profile)
    # -- 6. the train step on a DeviceMesh: one rank, two ranks sharing the card, the local shapes
    mesh_phase(dev, rand, check, check_grad, time_ms, bound, rows, n_sms, sm_clock_mhz)
    # -- 6d. serving on a DeviceMesh: ranks sharing the card, against one device
    serve_mesh_phase(rand, check, time_ms, bound, rows, n_sms, sm_clock_mhz)
    # -- 8. the roofline and the multi-pod dry-run --------------------------------
    t8 = time.perf_counter()
    print("phase 8a: the multi-pod dry-run on a fake DeviceMesh over meta tensors, priced for the H100")
    out_dir = ROOT / "build" / "chip_smoke_dryrun"
    shutil.rmtree(out_dir, ignore_errors=True)
    dryrun_records(out_dir)
    shutil.rmtree(out_dir, ignore_errors=True)
    print(f"phase 8b: steps timed on this card against their roofline bound ({smi[0]})")
    priced_steps(measured)
    print(f"phase 8: {time.perf_counter() - t8:.1f} s")
    # -- 9. the port's examples on the card ----------------------------------------
    examples_phase(check, check_grad, time_ms, bound, rows)

    print(f"chip_smoke: {time.perf_counter() - t_start:.1f} s in all, the build included")
    for r in rows:
        lib = "none" if r["library_ms"] is None else f"{r['library_ms']:.4f}"
        print(f"  {r['name']} [{r['path']}]: kernel_ms {r['ms']:.4f} library_ms {lib} "
              f"plain_ms {r['plain_ms']:.4f} bound_ms {r['bound_ms']:.4f} ({r['bound_by']}) launches {r['launches']}")
    torch.cuda.synchronize()

    print(json.dumps({"kernels": rows}))
    if disagreements:
        fail("; ".join(disagreements))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""The ``serve`` driver: the calls of ``repro_torch.launch.serve.run``, back to
back, for a fixed time: a closed loop of static batches, as offline batch
inference runs them.

Set-up builds ``dist.step.make_serve_fns`` on the card, draws the weights
from the seed and serves one whole round at the cell's shapes (which builds
the kernels on a checkout's first run and warms every shape). A round is
``init_serve_state``, one prefill of ``batch`` fresh prompts of ``prompt``
tokens drawn from the seed, the argmax, then ``gen - 1`` greedy decode
steps, each ``decode_fn`` and its argmax, with no synchronise (the port has
none). A CUDA event is recorded when the round starts and after each
argmax, so every token's time is the device's. Rounds start until the
window's time has passed; the round under way then finishes. The rate counts
the tokens of every round finished in the window and the round under way at
its close by the share of that round's time inside it, since a round's
tokens come in bursts (a prefill gives none for its whole length) and a
count of the tokens out by the close would move with where in a round the
window ends.

After the window, the comparison draws ``check_rounds`` finished rounds from
the seed and runs the plain reference (``portbench.reference``) over their
prompts and served tokens, from the weights drawn again from the seed, and
reads how far below the reference's best logit each served token lies: the
widest gap and the mean gap. The cell's limits file names those compared.
"""

from __future__ import annotations

import gc
import random
import time

import torch

from portbench import costs, harness
from portbench.reference import model as ref_model
from portbench.weights import make_params


class Server:
    """The program under test: the one-device serve functions and weights."""

    def __init__(self, cell, seed: int, dev):
        from repro_torch.dist.step import make_serve_fns
        from repro_torch.kernels.build import build_all
        from repro_torch.launch.serve import serve_max_len
        from repro_torch.models.registry import build_model, init_serve_state

        t = cell.traffic
        self.dev, self.B, self.Lp, self.G = dev, t["batch"], t["prompt"], t["gen"]
        self.cfg = harness.arch_config(cell.config)
        if dev.type == "cuda":
            build_all()
        self.model = build_model(self.cfg)
        self.max_len = serve_max_len(self.cfg, self.Lp, self.G)
        self.prefill_fn, self.decode_fn = make_serve_fns(self.model, dev, max_len=self.max_len, global_batch=self.B)
        self.init_state = init_serve_state
        self.params = make_params(cell.config, seed, dev)
        harness.check_layout(self.model, self.params)
        self.gen = torch.Generator(device=dev)
        self.gen.manual_seed(seed + 1)
        self.vocab = cell.config["vocab_size"]
        self.dispatch_s: list = []

    def prompts(self) -> torch.Tensor:
        return torch.randint(0, self.vocab, (self.B, self.Lp), generator=self.gen, device=self.dev)

    def round(self, prompts: torch.Tensor, decode_steps=None, timed: bool = True) -> dict:
        """One round; its events (timed), served tokens (B, gen) and prompts.
        ``decode_steps`` stops it after that many decode steps (a traced
        session's share of a round)."""
        from torch.profiler import record_function

        ev = (lambda: harness.Mark(self.dev)) if timed else (lambda: None)
        start, first = ev(), ev()
        _record(start)
        with record_function("portbench.prefill"):
            state = self.init_state(self.model, self.B, self.max_len, self.dev)
            logits, state = self.prefill_fn(self.params, prompts, state)
            tok = logits.argmax(dim=-1)[:, None]
        _record(first)
        toks, steps = [tok], []
        for _ in range(self.G - 1 if decode_steps is None else decode_steps):
            h0 = time.perf_counter()
            with record_function("portbench.decode_step"):
                logits, state = self.decode_fn(self.params, tok, state)
                tok = logits.argmax(dim=-1)[:, None]
            self.dispatch_s.append(time.perf_counter() - h0)
            e = ev()
            _record(e)
            steps.append(e)
            toks.append(tok)
        return {"start": start, "first": first, "steps": steps, "tokens": torch.cat(toks, dim=1), "prompts": prompts,
                "state": state}

    def free(self) -> None:
        self.params = self.prefill_fn = self.decode_fn = None
        gc.collect()
        if self.dev.type == "cuda":
            torch.cuda.empty_cache()


def _record(e) -> None:
    if e is not None:
        e.record()


def served_gaps(cell, seed: int, dev, rounds: list) -> tuple:
    """How far each served token's logit lies below the reference's best:
    (the widest such gap, their mean over every served token of the
    rounds, the reference's capacity drops in slots)."""
    ref_model.strict_f32()
    params = make_params(cell.config, seed, dev)
    worst, total, n, dropped = 0.0, 0.0, 0, 0
    for r in rounds:
        logits, d = ref_model.served_logits(cell.config, params, r["prompts"], r["tokens"], ref_model.Precision("f32"))
        gaps = ref_model.logit_gaps(logits, r["tokens"])
        worst, total, n = max(worst, float(gaps.max())), total + float(gaps.sum()), n + gaps.numel()
        dropped += d
        del logits
    del params
    return worst, total / n, dropped


def _times(w0, r: dict) -> tuple:
    """(start, first token, each decode step's end) in seconds from the window's start mark."""
    return r["start"].since(w0), r["first"].since(w0), [e.since(w0) for e in r["steps"]]


def run(cell, seed: int, seconds: float, trace: bool, dev, t_start: float) -> dict:
    t, conf = cell.traffic, cell.config
    t_init = time.perf_counter()
    srv = Server(cell, seed, dev)
    t_warm = time.perf_counter()
    srv.round(srv.prompts(), timed=False)  # warm every shape
    srv.dispatch_s.clear()
    harness.sync(dev)
    harness.reset_peak(dev)
    w0 = harness.Mark(dev)
    t0 = time.perf_counter()
    w0.record()
    setup_s = t0 - t_start
    harness.say(f"set-up {setup_s:.2f} s: to the driver {t_init - t_start:.2f}, build and weights "
                f"{t_warm - t_init:.2f}, a warm round {t0 - t_warm:.2f}")
    rounds = []
    while time.perf_counter() - t0 < seconds:
        r = srv.round(srv.prompts())
        r.pop("state")
        rounds.append(r)
    n_dispatch = len(srv.dispatch_s)
    harness.sync(dev)
    memory = harness.device_info(dev, cell.chips)

    # the work of the window: every round finished in it, and the share of the round under way at its close
    work, ttft, itl, prefill_s, decode = 0.0, [], [], [], []
    finished = []
    for r in rounds:
        s, f, steps = _times(w0, r)
        ends = [f] + steps
        work += min(max((seconds - s) / (ends[-1] - s), 0.0), 1.0)
        itl += [(b, b - a) for a, b in zip(ends, ends[1:]) if b <= seconds]
        decode += [(srv.Lp + j + 1, b - a) for j, (a, b) in enumerate(zip(ends, ends[1:])) if b <= seconds]
        if ends[-1] <= seconds:
            finished.append(r)
            ttft += [f - s] * srv.B
            prefill_s.append(f - s)
    e2e = {"serve_tokens_per_s": work * srv.B * srv.G / seconds, "setup_s": setup_s}
    harness.say(f"rounds: {len(rounds)} started, {len(finished)} finished in the window; their first tokens "
                + ", ".join(f"{s * 1e3:.1f}" for s in prefill_s) + " ms")
    if ttft:
        e2e["ttft_p95_ms"] = harness.p95(ttft) * 1e3
    if itl:
        e2e["itl_p95_ms"] = harness.p95([g for _, g in itl]) * 1e3
        halves = [[g for e, g in itl if (e <= seconds / 2) == first] for first in (True, False)]
        harness.say("itl_p95_ms by half of the window: " + ", ".join(
            f"{harness.p95(h) * 1e3:.3f}" if h else "none" for h in halves))

    profile = {}
    if trace:
        pre, dec = [], []
        for _ in range(t["trace_rounds"]):
            prompts = srv.prompts()
            r, summ = harness.traced(lambda: srv.round(prompts, decode_steps=0, timed=False), dev, "prefill")
            pre.append(summ)
            state, tok = r["state"], r["tokens"][:, -1:]

            def steps(state=state, tok=tok):
                from torch.profiler import record_function

                for _ in range(t["trace_decode_steps"]):
                    with record_function("portbench.decode_step"):
                        logits, state = srv.decode_fn(srv.params, tok, state)
                        tok = logits.argmax(dim=-1)[:, None]

            dec.append(harness.traced(steps, dev, "decode")[1])
            del r, state
        profile = {"prefill": harness.merge_summaries(pre), "decode": harness.merge_summaries(dec)}

    pool = finished or rounds
    picked = random.Random(seed).sample(range(len(pool)), min(t["check_rounds"], len(pool)))
    checked = [pool[i] for i in sorted(picked)]
    srv.free()
    t_check = time.perf_counter()
    worst, mean, dropped = served_gaps(cell, seed, dev, checked)
    harness.say(f"the comparison with the reference {time.perf_counter() - t_check:.2f} s")
    attempted = len(rounds) * srv.B
    prefill_slots = max(1, costs.routed_slots(conf))  # a prompt token's expert slots over the layers
    numbers = {"max_logit_gap": worst, "mean_logit_gap": mean}
    return {
        "end_to_end": e2e, "attempted": attempted, "failed": 0, "device": memory, "profile": profile,
        "checks": {k: (v, cell.limits[k]) for k, v in numbers.items() if k in cell.limits},
        "readings": numbers,
        "layer": {"seconds": seconds, "prefill_s": prefill_s, "decode": decode, "config": conf, "traffic": t,
                  "tokens_per_s": e2e["serve_tokens_per_s"],
                  "dispatch_s": srv.dispatch_s[:n_dispatch],
                  "ref_prefill_drop_share": dropped / (len(checked) * srv.B * srv.Lp * prefill_slots)},
    }

"""The one-device decode step made capture-safe, and its CUDA graph.

On the CPU: every architecture's decode (reduced, f32) gives the greedy
tokens and every step's logits bit for bit as the host-int path did before
the step read its position from the device (``host_int_decode_step``, kept
here: the slot written and the written count from the host ints, Mamba's
state replaced); so does ``DecodeGraph`` driven by a stand-in for the CUDA
graph (``stub_capture``: the capture runs the step once on the graph's
buffers, a replay runs it again and writes its logits into the captured
output, leaving the launch and call counters alone, as a replay does). Mamba's
decode writes its cache in place; ``takes_graph`` picks the states a graph
serves; a replay adds the launches counted at capture; the logits of two
steps never alias; a copy of the latest state replays as it is, and a
state whose buffers later steps overwrote is refused.

On the card (tests marked ``card``, skipped without CUDA; run them with
``python -m pytest tests/test_torch_decode_graph.py -m card`` on an H100):
reduced stablelm-1.6b and jamba-v0.1-52b in bf16 and f32, 32 replayed steps
against 32 eager steps from the same state, bit for bit; a second round's
state copied in, never captured again; the launch counters, and the calls
by input shapes (``ops.count_calls``), as the eager steps leave them; the
kernels in a profiler trace of a replayed round as many as its launches
(``ops.calls_in_trace``).
"""

import dataclasses

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from repro_torch import obs
from repro_torch.configs import ARCH_IDS, get_config
from repro_torch.dist.step import DecodeGraph, make_serve_fns, takes_graph
from repro_torch.kernels import ops
from repro_torch.launch.serve import make_frontend, serve_max_len
from repro_torch.models import attention as attn
from repro_torch.models import mamba as mb
from repro_torch.models.registry import build_model, decode_step, init_serve_state

B, PROMPT, STEPS = 2, 6, 5


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: a CUDA graph captures and replays only on the card")
    return torch.device("cuda", 0)


def _host_int_cached_attention(real):
    """The host-int decode into a plain one-device cache: the slot and the
    written count from the cache's host index; everything else as ``real``."""

    def cached(p, q, k, v, positions, cache, par, window, kernels):
        if q.shape[1] > 1 or "pos" in cache or "split" in cache:
            return real(p, q, k, v, positions, cache, par, window, kernels)
        ck, cv, idx = cache["k"], cache["v"], cache["index"]
        S = ck.shape[1]
        if idx + 1 > S:
            raise ValueError(f"KV cache full: {idx} + 1 tokens > {S} slots")
        ck[:, idx] = k[:, 0]
        cv[:, idx] = v[:, 0]
        i32 = dict(dtype=torch.int32, device=q.device)
        k_pos = torch.arange(S, **i32).expand(q.shape[0], S).contiguous()
        n_valid = torch.full((q.shape[0],), idx + 1, **i32)
        o = kernels["flash_decode"](q, ck, cv, k_pos, positions[:, 0].to(torch.int32), n_valid, window=window)
        return attn._out_proj(p, o.to(q.dtype), par), {"k": ck, "v": cv, "index": idx + 1}

    return cached


def _replaced_mamba(real):
    """The replacing Mamba decode: new (h, conv window) tensors, the cache's
    own left as they were."""

    def block(p, cfg, x, positions, cache=None, kernels=None):
        if cache is not None and x.shape[1] == 1:
            cache = {k: t.clone() for k, t in cache.items()}
        return real(p, cfg, x, positions, cache, kernels=kernels)

    return block


def host_int_decode_step(model, params, tokens, state):
    """The host-int ``decode_step`` that the device position replaced:
    positions from ``torch.full`` of the host ``t``, the plain caches' slot
    and count from their host index, Mamba's state replaced."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(attn, "_cached_attention", _host_int_cached_attention(attn._cached_attention))
        mp.setattr(mb, "mamba_block", _replaced_mamba(mb.mamba_block))
        x = model.embed(params, tokens)
        positions = torch.full((tokens.shape[0], 1), state["t"], dtype=torch.int64, device=tokens.device)
        x, _, caches = model.trunk(params, x, positions, caches=state["caches"], cross_kvs=state.get("memory_kv"))
        logits = model.logits(params, x)[:, 0]
    return logits, {**state, "caches": caches, "t": state["t"] + 1}


def stub_capture(fn):
    """A CUDA graph's stand-in on the CPU (see the module note)."""
    out = fn()

    def replay():
        before = ops.launch_state()
        with ops.count_calls(ops.DEVICE_KERNELS) as calls:
            out.copy_(fn())
        ops.add_launches(ops.launches_since(before), -1)
        ops.add_calls(calls, -1)

    return replay, out


def _clone_state(state):
    return {k: ([{n: (a.clone() if isinstance(a, torch.Tensor) else a) for n, a in c.items()} for c in v]
                if k == "caches" else v) for k, v in state.items()}


def _setup(arch: str, dev="cpu", dtype=None, n_layers=None):
    cfg = get_config(arch).reduced()
    if dtype is not None:
        cfg = dataclasses.replace(cfg, dtype=dtype)
    if n_layers is not None:
        cfg = dataclasses.replace(cfg, n_layers=n_layers)
    model = build_model(cfg)
    params = model.init(0, dev)
    max_len = serve_max_len(cfg, PROMPT, 40)
    prefill_fn, decode_fn = make_serve_fns(model, dev, max_len=max_len, global_batch=B)
    prompts = torch.randint(0, cfg.vocab, (B, PROMPT), generator=torch.Generator().manual_seed(1)).to(dev)
    frames, prefix = make_frontend(cfg, B, 0, dev)
    state = init_serve_state(model, B, max_len, dev)
    logits, state = prefill_fn(params, prompts, state, frames, prefix)
    return cfg, model, params, decode_fn, logits, state


def _decode(fn, logits, state, steps: int):
    """Greedy steps of ``fn(tokens, state)``: (every step's logits, the last state)."""
    out = []
    for _ in range(steps):
        logits, state = fn(logits.argmax(dim=-1)[:, None], state)
        out.append(logits)
    return out, state


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_decode_bit_equal_to_the_host_int_path(arch):
    cfg, model, params, decode_fn, logits, state = _setup(arch)
    want, _ = _decode(lambda tok, s: host_int_decode_step(model, params, tok, s), logits, _clone_state(state), STEPS)
    got, _ = _decode(lambda tok, s: decode_fn(params, tok, s), logits, _clone_state(state), STEPS)
    paths = [got]
    if takes_graph(state):
        graph = DecodeGraph(model, capture=stub_capture)
        paths.append(_decode(lambda tok, s: graph.step(params, tok, s), logits, _clone_state(state), STEPS)[0])
    for out in paths:
        assert len(out) == len(want) == STEPS
        for a, b in zip(out, want):
            assert torch.equal(a, b)
            assert torch.equal(a.argmax(-1), b.argmax(-1))


def test_mamba_decode_writes_its_cache_in_place():
    cfg, model, params, _, logits, state = _setup("jamba-v0.1-52b", n_layers=8)
    kinds = [set(c) for c in state["caches"]]
    assert {"h", "conv"} in kinds and {"k", "v", "index"} in kinds
    before = [{n: (a.data_ptr(), a.clone()) for n, a in c.items() if n in ("h", "conv")} for c in state["caches"]]
    tok = logits.argmax(-1)[:, None]
    _, replaced = host_int_decode_step(model, params, tok, _clone_state(state))
    with torch.inference_mode():
        _, new = decode_step(model, params, tok, state)
    n_mamba = 0
    for old, c, n, r in zip(before, state["caches"], new["caches"], replaced["caches"]):
        for name, (ptr, value) in old.items():
            assert c[name].data_ptr() == ptr and n[name] is c[name]
            assert torch.equal(c[name], r[name]) and not torch.equal(c[name], value)  # advanced, in place
            n_mamba += name == "h"
    assert n_mamba == sum(s.mixer == "mamba" for s in cfg.layout)


def _kv(**extra):
    return {"k": torch.zeros(1), "v": torch.zeros(1), "index": 3, **extra}


@pytest.mark.parametrize("caches, extra, takes", [
    ([_kv()], {}, True),  # dense and MoE layouts
    ([{"h": torch.zeros(1), "conv": torch.zeros(1)}], {}, True),  # falcon-mamba
    ([{"h": torch.zeros(1), "conv": torch.zeros(1)}, _kv()], {}, True),  # the hybrid
    ([_kv(pos=torch.zeros(1))], {}, False),  # a ring
    ([{"c_kv": torch.zeros(1), "k_rope": torch.zeros(1), "index": 3}], {}, False),  # MLA
    ([_kv()], {"memory": torch.zeros(1), "memory_kv": []}, False),  # an encoder-decoder
    ([_kv(split=(0, ("data",)))], {}, False),  # a mesh's split slots
])
def test_which_states_take_the_graph(caches, extra, takes):
    assert takes_graph({"caches": caches, "t": 3, **extra}) is takes


def _counting(name: str, route=None):
    """A stand-in for the wrapper ``name`` that counts each call as a launch
    in the wrapper's counters (on ``route``), as the wrapper does on the card."""
    real = ops.KERNELS[name]

    def wrapped(*a, **kw):
        real.launches += 1
        if route is not None:
            real.route_launches[route] += 1
        return real(*a, **kw)

    return wrapped


def test_a_replay_adds_the_launches_counted_at_capture(monkeypatch):
    cfg, model, params, _, logits, state = _setup("jamba-v0.1-52b", n_layers=8)
    monkeypatch.setitem(ops.KERNELS, "moe_gmm", _counting("moe_gmm", "swap_ab"))
    monkeypatch.setitem(ops.KERNELS, "flash_decode", _counting("flash_decode"))
    graph = DecodeGraph(model, capture=stub_capture)
    counts, by_shape = [], []
    for fn in (lambda tok, s: decode_step(model, params, tok, s), lambda tok, s: graph.step(params, tok, s)):
        ops.reset_launch_counts()
        with ops.count_calls(("flash_decode", "moe_gmm")) as calls, torch.inference_mode():
            _decode(fn, logits, _clone_state(state), STEPS)
        counts.append(ops.launch_state())
        by_shape.append(calls)
    eager, replayed = counts
    assert graph.launches == {"moe_gmm": (4, {"swap_ab": 4}), "flash_decode": (1, {})}
    assert {k: sum(per.values()) for k, per in graph.calls.items()} == {"flash_attention": 0, "flash_decode": 1,
                                                                         "moe_gmm": 4, "mamba_scan": 0}
    assert eager["moe_gmm"] == (4 * STEPS, {"fma": 0, "wgmma": 0, "swap_ab": 4 * STEPS})
    assert eager["flash_decode"] == (STEPS, {})
    assert replayed == eager
    assert by_shape[1] == by_shape[0]  # the calls by input shapes too, replays included
    assert {name: sum(per.values()) for name, per in by_shape[0].items()} == {"flash_decode": STEPS,
                                                                               "moe_gmm": 4 * STEPS}
    ops.reset_launch_counts()


def test_launch_counts_add_and_subtract():
    ops.reset_launch_counts()
    before = ops.launch_state()
    ops.KERNELS["moe_gmm"].launches += 3
    ops.KERNELS["moe_gmm"].route_launches["swap_ab"] += 3
    ops.KERNELS["flash_decode"].launches += 1
    got = ops.launches_since(before)
    assert got == {"moe_gmm": (3, {"swap_ab": 3}), "flash_decode": (1, {})}
    ops.add_launches(got, 2)
    assert ops.launch_counts()["moe_gmm"] == 9 and ops.KERNELS["moe_gmm"].route_launches["swap_ab"] == 9
    ops.add_launches(got, -3)
    assert ops.launches_since(before) == {}


def test_counted_calls_nest_and_add():
    q, k = torch.zeros(2, 1, 4, 16), torch.zeros(2, 16, 2, 16)
    pos, n_valid = torch.zeros(2, 16, dtype=torch.int32), torch.ones(2, dtype=torch.int32)
    key = ((2, 1, 4, 16), (2, 16, 2, 16), (2, 16, 2, 16))
    with ops.count_calls(("flash_decode", "moe_gmm")) as outer:
        with ops.count_calls(("flash_decode",)) as inner:
            ops.kernel_set()["flash_decode"](q, k, k, pos, n_valid, n_valid)  # the plain version on the CPU
        assert inner == {"flash_decode": {key: 1}} and outer == {"flash_decode": {key: 1}, "moe_gmm": {}}
        ops.add_calls(inner, 3)  # as three replays of a graph that captured the call
        assert outer == {"flash_decode": {key: 4}, "moe_gmm": {}} and inner == {"flash_decode": {key: 1}}
        ops.add_calls(inner, -4)
        assert outer == {"flash_decode": {key: 0}, "moe_gmm": {}}
    assert ops.KERNELS["flash_decode"] is ops.flash_decode  # the wrapper stands there again
    ops.add_calls(inner)  # no block is open: nothing to add to
    assert outer == {"flash_decode": {key: 0}, "moe_gmm": {}}


def test_calls_in_trace_reads_the_wrappers_kernels_by_name():
    names = [
        "void (anonymous namespace)::wg::gemm_kernel<true>(CUtensorMap, CUtensorMap, int)",
        "void (anonymous namespace)::wg::gemm_kernel<false>(CUtensorMap, CUtensorMap, int)",
        "void (anonymous namespace)::swab::swap_ab_kernel<true>(CUtensorMap, int)",
        "void (anonymous namespace)::swab::swap_ab_kernel<false>(CUtensorMap, int)",
        "void (anonymous namespace)::flash_decode_kernel<__nv_bfloat16, 128>(__nv_bfloat16 const*)",
        "void (anonymous namespace)::mma::attn_kernel<128, 128>(__nv_bfloat16 const*)",
        "void (anonymous namespace)::mamba_scan_kernel<float, 16>(float const*)",
        "void (anonymous namespace)::bwd::ffma::gemm_kernel<float, 1>(Params)",  # moe_gmm_bwd's: not a call
        "sm90_xmma_gemm_bf16bf16_bf16f32_f32_tn_n_tilesize128x128x64",
        "void at::native::vectorized_elementwise_kernel<4, at::native::FillFunctor<long>>(int)",
        "Memcpy DtoD (Device -> Device)",
    ]
    assert ops.calls_in_trace(names) == {"flash_attention": 1, "flash_decode": 1, "moe_gmm": 2, "mamba_scan": 1}
    assert ops.calls_in_trace(names[:1]) == {"flash_attention": 0, "flash_decode": 0, "moe_gmm": 0.5,
                                             "mamba_scan": 0}


def test_returned_logits_never_alias():
    _, model, params, _, logits, state = _setup("stablelm-1.6b")
    graph = DecodeGraph(model, capture=stub_capture)
    out, state = _decode(lambda tok, s: graph.step(params, tok, s), logits, state, STEPS)
    kept = [o.clone() for o in out]
    ptrs = {o.data_ptr() for o in out}
    assert len(ptrs) == STEPS and graph.logits.data_ptr() not in ptrs
    _decode(lambda tok, s: graph.step(params, tok, s), out[-1], state, 3)
    for a, b in zip(out, kept):
        assert torch.equal(a, b)  # later replays left every returned step's logits alone


def test_copy_in_once_a_round_and_stale_states_refused():
    _, model, params, _, logits, state = _setup("jamba-v0.1-52b", n_layers=8)
    graph = DecodeGraph(model, capture=stub_capture)
    step = lambda tok, s: graph.step(params, tok, s)  # noqa: E731
    obs.reset_spans()
    with profile(activities=[ProfilerActivity.CPU]):
        with obs.span("serve.decode", phase="decode"):
            _, first = _decode(step, logits, _clone_state(state), 3)  # eager, capture, replay
            stale = first
            _, later = _decode(step, logits, first, 2)
            _decode(step, logits, _clone_state(state), 2)  # a new round: copied in
    counts = obs.count_totals()["decode"]
    assert counts == {"repro_torch.graph.eager": 1, "repro_torch.graph.capture": 1,
                      "repro_torch.graph.copy_in": 2, "repro_torch.graph.replay": 6}
    assert later["caches"] is not stale["caches"]
    with pytest.raises(ValueError, match="latest decode step"):
        graph.step(params, logits.argmax(-1)[:, None], stale)


def test_a_copy_of_the_latest_state_replays_without_a_copy_in():
    _, model, params, _, logits, state = _setup("jamba-v0.1-52b", n_layers=8)
    graph = DecodeGraph(model, capture=stub_capture)
    step = lambda tok, s: graph.step(params, tok, s)  # noqa: E731
    out, latest = _decode(step, logits, _clone_state(state), 3)  # eager, capture, replay
    copy = {"caches": [dict(c) for c in latest["caches"]], "t": latest["t"]}  # new dicts, the same tensors
    mixed = {"caches": [{n: (a.clone() if n == "h" else a) for n, a in c.items()} for c in copy["caches"]],
             "t": latest["t"]}
    with torch.inference_mode():
        want, _ = _decode(lambda tok, s: decode_step(model, params, tok, s), out[-1], _clone_state(latest), 2)
    with pytest.raises(ValueError, match="latest decode step"):
        step(out[-1].argmax(-1)[:, None], mixed)  # some of the graph's buffers, not all
    obs.reset_spans()
    with profile(activities=[ProfilerActivity.CPU]):
        with obs.span("serve.decode", phase="decode"):
            got, _ = _decode(step, out[-1], copy, 2)
    assert obs.count_totals()["decode"] == {"repro_torch.graph.replay": 2}
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    with pytest.raises(ValueError, match="latest decode step"):
        step(out[-1].argmax(-1)[:, None], copy)  # now older than the latest state returned


def test_a_full_cache_is_refused_before_a_replay():
    _, model, params, _, logits, state = _setup("stablelm-1.6b")
    graph = DecodeGraph(model, capture=stub_capture)
    _, state = _decode(lambda tok, s: graph.step(params, tok, s), logits, state, 2)
    slots = state["caches"][0]["k"].shape[1]
    with pytest.raises(ValueError, match="KV cache full"):
        graph.step(params, logits.argmax(-1)[:, None], {**state, "t": slots})


def test_decode_fn_counts_eager_steps_on_the_cpu():
    _, model, params, decode_fn, logits, state = _setup("jamba-v0.1-52b", n_layers=8)
    obs.reset_spans()
    _decode(lambda tok, s: decode_fn(params, tok, s), logits, state, 2)
    assert obs.count_totals() == {}  # the profiler is off
    with profile(activities=[ProfilerActivity.CPU]):
        _decode(lambda tok, s: decode_fn(params, tok, s), logits, state, 3)
    assert obs.count_totals() == {"decode": {"repro_torch.graph.eager": 3}}
    obs.reset_spans()
    assert obs.count_totals() == {}


# ---------------------------------------------------------------------------
# On the card
# ---------------------------------------------------------------------------


@pytest.mark.card
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("arch", ["stablelm-1.6b", "jamba-v0.1-52b"])
def test_replays_bit_equal_to_eager_steps_on_the_card(card, arch, dtype):
    steps = 32
    cfg, model, params, decode_fn, logits, state = _setup(arch, card, dtype)
    assert takes_graph(state)
    ops.reset_launch_counts()
    with ops.count_calls(ops.DEVICE_KERNELS) as eager_calls, torch.inference_mode():
        want, _ = _decode(lambda tok, s: decode_step(model, params, tok, s), logits, _clone_state(state), steps)
    eager = ops.launch_state()
    obs.reset_spans()
    ops.reset_launch_counts()
    rounds = []
    with profile(activities=[ProfilerActivity.CPU]):
        rounds.append(_decode(lambda tok, s: decode_fn(params, tok, s), logits, _clone_state(state), steps)[0])
    with ops.count_calls(ops.DEVICE_KERNELS) as calls, profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        before = ops.launch_state()  # the second round's fresh state is copied in, and every step replayed
        rounds.append(_decode(lambda tok, s: decode_fn(params, tok, s), logits, _clone_state(state), steps)[0])
        torch.cuda.synchronize()
        second = ops.launches_since(before)
    for got in rounds:
        for a, b in zip(got, want):
            assert torch.equal(a, b)
    counts = obs.count_totals()["decode"]
    assert counts == {"repro_torch.graph.eager": 1, "repro_torch.graph.capture": 1,
                      "repro_torch.graph.copy_in": 2, "repro_torch.graph.replay": 2 * steps - 1}
    replayed = ops.launch_state()
    assert replayed == {k: (2 * n, {r: 2 * c for r, c in routes.items()}) for k, (n, routes) in eager.items()}
    assert sum(n for n, _ in replayed.values()) > 0
    assert calls == eager_calls  # by input shapes, the round's replays as its eager steps
    assert {k: n for k, (n, _) in second.items()} == {k: n for k, (n, _) in eager.items() if n}
    # what the device ran in the replayed round, by its kernels' names in the trace
    ran = ops.calls_in_trace(e.name for e in prof.events() if str(e.device_type).endswith("CUDA"))
    assert ran == {k: eager[k][0] for k in ops.DEVICE_KERNELS}

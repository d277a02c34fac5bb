"""Runtime parity: the process pool, the zone runners and the adaptive pool
of ``repro_torch`` against its own inline run and the reference's, on the
CPU.

The circuits are those of ``test_runtime.py`` and ``test_adaptive.py`` (a
fan-out of squarers into a reducer; a three-zone fan-in; one fan per load
level). Host tensors and numpy arrays go to forked workers; every
provenance story, the ledger and the merge order must equal the inline
run's (as content: a pool mints arrivals before executions, so visit seqs
interleave otherwise), and equal the reference's same backend on the same
inputs exactly. The worker-kill drill must
give the crash-free fingerprint. A worker is forked after a large torch op
in the parent and must still answer (its start-up drops torch's OpenMP pool
to one thread). No test waits on a worker without a bound: each runs under
an alarm.
"""

import os
import signal

import numpy as np
import pytest
import torch

import repro.topology as jax_topo
import repro.workspace as jax_ws
import repro_torch.topology as torch_topo
import repro_torch.workspace as torch_ws
from repro_torch.core.store import ArtifactStore, _holds_card_tensor
from repro_torch.provenance import replay_segments
from repro_torch.runtime import ProcessExecutor, ZonedProcessExecutor, fork_context
from repro.runtime import ProcessExecutor as JaxProcessExecutor
from repro.runtime import ZonedProcessExecutor as JaxZonedProcessExecutor
from test_torch_engine import _content_view, _numpy, _tensor, fingerprint, fresh_uids  # noqa: F401

pytestmark = pytest.mark.skipif(fork_context() is None, reason="fork start method unavailable")
BOUND_S = 120  # a hung worker fails its test instead of stalling the run


class WorkerHang(Exception):
    """Raised by the alarm. Not an OSError: the pool takes an OSError from a
    pipe for a dead worker and retries on a fresh one."""


@pytest.fixture(autouse=True)
def bounded():
    def expire(signum, frame):
        raise WorkerHang(f"test exceeded {BOUND_S} s waiting on a worker")

    old = signal.signal(signal.SIGALRM, expire)
    signal.alarm(BOUND_S)
    yield
    signal.alarm(0)
    signal.signal(signal.SIGALRM, old)


# ---------------------------------------------------------------------------
# circuits
# ---------------------------------------------------------------------------


def _reduce(**kw):
    return {"total": [float(np.asarray(kw[k], dtype=np.float64).sum()) for k in sorted(kw)]}


def fan_ws(W, executor, width=4, **kw):
    ws = W.Workspace("fan", executor=executor, cache=False, topology=False, **kw)
    src = ws.task(lambda x: {"out": x}, name="src", inputs=["x"], outputs=["out"])
    red = ws.task(_reduce, name="reduce", inputs=[f"v{i}" for i in range(width)], outputs=["total"])
    for i in range(width):
        sq = ws.task(lambda y, i=i: {"sq": y * y + i}, name=f"sq{i}", inputs=["y"], outputs=["sq"])
        src["out"] >> sq["y"]
        sq["sq"] >> red[f"v{i}"]
    return ws


def drive_fan(ws, arr, rounds=2, n=32, seed=0):
    rng = np.random.RandomState(seed)
    for _ in range(rounds):
        ws.push("src", x=arr(rng.randn(n).astype(np.float32)))
    return ws


def _zone_reduce(**kw):
    return {"total": float(sum(np.asarray(v, dtype=np.float64).sum() for v in kw.values()))}


def zone_ws(W, T, executor, **kw):
    ws = W.Workspace("zones", executor=executor, cache=False, topology=T.Topology.three_zone(),
                     placement="pin", **kw)
    zones = ("edge", "device")
    src = ws.task(lambda x: {"out": x}, name="src", inputs=["x"], outputs=["out"]).place("cloud")
    red = ws.task(_zone_reduce, name="reduce", inputs=[f"a_{z}" for z in zones],
                  outputs=["total"]).place("cloud")
    for k, z in enumerate(zones):
        # distinct content per zone: two runners exporting equal bytes race on
        # which finds the other's object file, which moves bytes_not_moved
        t = ws.task(lambda x, k=k: {"out": x * 2.0 + k}, name=f"prod_{z}", inputs=["x"],
                    outputs=["out"]).place(z)
        src["out"] >> t["x"]
        t["out"] >> red[f"a_{z}"]
    return ws


def _engine_view(ws):
    """The fingerprint less what the backend changes by design: the store's
    object-tier counters (payloads cross through it) and the scheduler's
    backend name."""
    fp = fingerprint(ws)
    fp.pop("store")
    return fp


def _total(ws):
    return ws.value_of(ws.pipeline.tasks["reduce"].last_outputs["total"])


# ---------------------------------------------------------------------------
# ProcessExecutor
# ---------------------------------------------------------------------------


def _ref_run(make_ws, make_ex):
    ex = make_ex()
    try:
        return make_ws(ex)
    finally:
        ex.shutdown()


@pytest.mark.parametrize("arr", [_numpy, _tensor], ids=["numpy", "tensor"])
def test_process_pool_equals_inline_and_reference(arr, fresh_uids):
    fresh_uids()
    ref = _engine_view(_ref_run(lambda ex: drive_fan(fan_ws(jax_ws, ex), _numpy),
                                lambda: JaxProcessExecutor(max_workers=4)))
    fresh_uids()
    inline_ws = drive_fan(fan_ws(torch_ws, torch_ws.InlineExecutor()), arr)
    fresh_uids()
    ex = ProcessExecutor(max_workers=4)
    try:
        ws = drive_fan(fan_ws(torch_ws, ex), arr)
        st = ex.stats()
        assert st["tasks_remote"] == 8 and st["tasks_inline"] == 0
        assert st["payload_bytes_over_pipe"] == 0 and st["control_bytes_sent"] > 0
        got = _engine_view(ws)
    finally:
        ex.shutdown()
    assert got == ref
    assert _content_view(got) == _content_view(_engine_view(inline_ws))
    for i in range(4):
        a = ws.value_of(ws.pipeline.tasks[f"sq{i}"].last_outputs["sq"])
        b = inline_ws.value_of(inline_ws.pipeline.tasks[f"sq{i}"].last_outputs["sq"])
        assert type(a) is type(b)
        assert np.asarray(a).tobytes() == np.asarray(b).tobytes()


def test_card_plans_stay_in_the_parent(monkeypatch, fresh_uids):
    """A plan whose inputs hold a card tensor never goes to a worker: it runs
    in the parent and counts in ``tasks_inline``. On the CPU the store is
    told every payload is on a card."""
    monkeypatch.setattr(ArtifactStore, "on_card", lambda self, chash: True)
    fresh_uids()
    inline_ws = drive_fan(fan_ws(torch_ws, torch_ws.InlineExecutor()), _tensor)
    fresh_uids()
    ex = ProcessExecutor(max_workers=4)
    try:
        ws = drive_fan(fan_ws(torch_ws, ex), _tensor)
        st = ex.stats()
        assert st["tasks_remote"] == 0 and st["tasks_inline"] == 8
        assert st["workers_alive"] == 0  # no plan needed a worker
        assert ws.store.stats()["publishes"] == 0  # no input went to the object tier
        assert _content_view(_engine_view(ws)) == _content_view(_engine_view(inline_ws))
    finally:
        ex.shutdown()


def test_card_tensor_detection():
    meta = torch.empty(2, device="meta")  # any device that is not the host
    assert _holds_card_tensor(meta) and _holds_card_tensor({"a": [1, (meta,)]})
    assert not _holds_card_tensor({"a": [torch.ones(2), np.ones(2)], "b": 3})
    store = ArtifactStore()
    _, h = store.put(torch.ones(3))
    assert not store.on_card(h)


def test_fork_after_large_torch_op():
    """The parent's intra-op pool has run; a forked worker's first parallel
    op must not hang."""
    a = torch.randn(1024, 1024)
    (a @ a).sum()
    torch.randn(1 << 22).exp().sum()
    ex = ProcessExecutor(max_workers=2)
    ws = torch_ws.Workspace("fork", executor=ex, cache=False, topology=False)
    src = ws.task(lambda x: {"a": x, "b": x + 1}, name="src", inputs=["x"], outputs=["a", "b"])
    for name in ("a", "b"):
        t = ws.task(lambda y: {"z": (y @ y).sum() + torch.exp(y.reshape(-1)).sum()},
                    name=f"mm_{name}", inputs=["y"], outputs=["z"])
        src[name] >> t["y"]
    try:
        out = ws.push(src, x=torch.randn(512, 512))
        st = ex.stats()
        assert st["tasks_remote"] == 2
        z = ws.value_of(ws.pipeline.tasks["mm_a"].last_outputs["z"])
        assert torch.isfinite(z)
        assert out["mm_a"]["z"].shape == ()
    finally:
        ex.shutdown()


def test_worker_kill_drill_gives_the_crash_free_fingerprint(tmp_path, fresh_uids):
    flag = str(tmp_path / "crash-once")
    parent = os.getpid()

    def sq0(y):
        if os.getpid() != parent and os.path.exists(flag):
            os.remove(flag)  # one crash, then behave
            os._exit(1)
        return {"sq": y * y}

    def run(crash):
        fresh_uids()
        ex = ProcessExecutor(max_workers=2, retry_budget=2)
        ws = torch_ws.Workspace("crash", executor=ex, cache=False, topology=False)
        src = ws.task(lambda x: {"out": x}, name="src", inputs=["x"], outputs=["out"])
        red = ws.task(_reduce, name="reduce", inputs=[f"v{i}" for i in range(4)], outputs=["total"])
        for i, fn in enumerate([sq0] + [(lambda y, i=i: {"sq": y * y + i}) for i in range(1, 4)]):
            t = ws.task(fn, name=f"sq{i}", inputs=["y"], outputs=["sq"])
            src["out"] >> t["y"]
            t["sq"] >> red[f"v{i}"]
        if crash:
            open(flag, "w").close()
        try:
            ws.push("src", x=torch.full((8,), 2.0))
            st = ex.stats()
            fp = _engine_view(ws)
        finally:
            ex.shutdown()
        # the anomaly entries are the crash's own record (and take visit
        # seqs): compare the story without them, AVs and uids as they are
        fp["visits"] = {t: [e for e in es if e["event"] != "anomaly"] for t, es in fp["visits"].items()}
        fp["design_map"] = {**fp["design_map"], "anomalies": []}
        fp = {**_content_view(fp), "avs": fp["avs"]}
        return fp, st, _total(ws)

    clean, _, clean_total = run(crash=False)
    crashed, st, total = run(crash=True)
    assert st["worker_restarts"] >= 1 and st["retries"] >= 1
    assert total == clean_total
    assert crashed == clean


# ---------------------------------------------------------------------------
# ZonedProcessExecutor: runners and their journal segments
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arr", [_numpy, _tensor], ids=["numpy", "tensor"])
def test_zoned_process_segments_replay_to_the_inline_fingerprint(arr, tmp_path, fresh_uids):
    fresh_uids()
    ref = _ref_run(lambda ex: drive_fan(zone_ws(jax_ws, jax_topo, ex), _numpy, n=16, seed=3),
                   lambda: JaxZonedProcessExecutor(max_workers=2))
    fresh_uids()
    inline = zone_ws(torch_ws, torch_topo, torch_ws.InlineExecutor())
    drive_fan(inline, arr, n=16, seed=3)
    fresh_uids()
    jpath = str(tmp_path / "zp.jsonl")
    ex = ZonedProcessExecutor(max_workers=2)
    try:
        ws = zone_ws(torch_ws, torch_topo, ex, journal_path=jpath)
        drive_fan(ws, arr, n=16, seed=3)
        st = ex.stats()
        assert st["tasks_remote"] == 4 and set(st["runners"]) == {"device", "edge"}
        segs = ex.segment_paths()
        assert len(segs) == 2
        ws.journal.flush()
        replayed = replay_segments(jpath, segs)
        back = torch_ws.Workspace.from_journal([jpath, *segs])
        live = _engine_view(ws)
    finally:
        ex.shutdown()
    assert live == _engine_view(ref)
    assert _content_view(live) == _content_view(_engine_view(inline))
    assert _total(ws) == _total(inline) == _total(ref)
    assert ws.ledger.stats() == inline.ledger.stats() == ref.ledger.stats()
    assert replayed.ledger.stats() == ws.ledger.stats() and replayed.truncated == 0
    for t in ws.tasks():
        assert [(e["event"], e["av_uid"], e["seq"]) for e in back.visitor_log(t)] == [
            (e["event"], e["av_uid"], e["seq"]) for e in ws.visitor_log(t)]
    assert back.registry.all_avs() == ws.registry.all_avs()


def test_zoned_process_without_topology_is_a_pool(fresh_uids):
    fresh_uids()
    inline = drive_fan(fan_ws(torch_ws, torch_ws.InlineExecutor()), _tensor)
    fresh_uids()
    ex = ZonedProcessExecutor(max_workers=2)
    try:
        ws = drive_fan(fan_ws(torch_ws, ex), _tensor)
        assert ex.stats()["flat"]["tasks_remote"] == 8
        assert _content_view(_engine_view(ws)) == _content_view(_engine_view(inline))
    finally:
        ex.shutdown()


# ---------------------------------------------------------------------------
# AdaptiveExecutor (threads or processes) and zoned-adaptive
# ---------------------------------------------------------------------------


def _wan(T):
    t = T.Topology("wan")
    t.zone("cloud", tier="cloud")
    t.zone("edge", tier="edge")
    t.zone("device", tier="device")
    t.link("device", "edge", latency_ms=1, bandwidth_mbps=1000, energy_j_per_mb=0.01)
    t.link("edge", "cloud", latency_ms=20, bandwidth_mbps=100, energy_j_per_mb=0.05)
    t.link("device", "cloud", latency_ms=50, bandwidth_mbps=10, energy_j_per_mb=0.5)
    return t


def _red_sum(**kw):
    return {"total": sum(kw.values())}


def levels_ws(W, T, widths, executor, journal_path=None):
    ws = W.Workspace("adaptive", topology=_wan(T), placement="energy", executor=executor,
                     journal_path=journal_path, cache=False)
    for w in widths:
        src = ws.task(lambda x: {"out": x}, name=f"src{w}", inputs=["x"], outputs=["out"]).place("device")
        red = ws.task(_red_sum, name=f"red{w}", inputs=[f"v{i}" for i in range(w)],
                      outputs=["total"]).place("cloud")
        for i in range(w):
            sq = ws.task(lambda y, i=i: {"s": float(np.asarray(y, dtype=np.float64).sum()) + i},
                         name=f"sq{w}_{i}", inputs=["y"], outputs=["s"])
            src["out"] >> sq["y"]
            sq["s"] >> red[f"v{i}"]
    return ws


SCHEDULE = [1, 6, 6, 6, 1, 1, 1, 1, 6]


def _drive_levels(ws, arr, n=64, seed=0):
    rng = np.random.RandomState(seed)
    for w in SCHEDULE:
        ws.push(f"src{w}", x=arr(rng.randn(n).astype(np.float32)))
    return ws


ADAPTIVE = {
    "adaptive_threads": lambda W, P: W.AdaptiveExecutor(min_workers=1, max_workers=8),
    "adaptive_process": lambda W, P: W.AdaptiveExecutor(inner=P(max_workers=1), min_workers=1,
                                                        max_workers=4),
    "zoned_adaptive": lambda W, P: W.ZonedExecutor(inner=W.AdaptiveExecutor(max_workers=4)),
}


def _scale_view(ex):
    inner = getattr(ex, "scale_history", None)
    if inner is None:
        inner = ex.inner.scale_history
    return [{k: v for k, v in e.items() if k != "executor"} for e in inner]


@pytest.mark.parametrize("name", sorted(ADAPTIVE))
def test_adaptive_equals_inline_and_reference(name, tmp_path, fresh_uids):
    from repro.runtime import ProcessExecutor as JaxProcessExecutor

    runs = {}
    for label, W, T, P, arr in (("ref", jax_ws, jax_topo, JaxProcessExecutor, _numpy),
                                ("port", torch_ws, torch_topo, ProcessExecutor, _tensor)):
        if label == "ref" and name == "adaptive_process":
            P = None  # the reference's decisions over threads: the pool kind never changes them
            ex = W.AdaptiveExecutor(min_workers=1, max_workers=4)
        else:
            ex = ADAPTIVE[name](W, P)
        fresh_uids()
        try:
            ws = _drive_levels(levels_ws(W, T, [1, 6], ex, journal_path=str(tmp_path / f"{label}.jsonl")), arr)
            ws.journal.flush()
            back = W.Workspace.from_journal(ws.journal.path)
            runs[label] = {
                "totals": [ws.value_of(ws.pipeline.tasks[f"red{w}"].last_outputs["total"]) for w in (1, 6)],
                "ledger": ws.stats()["topology"]["ledger"],
                "events": sorted((t, e["event"]) for t in ws.tasks() for e in ws.visitor_log(t)),
                "scales": _scale_view(ex),
                "replayed_scales": [{k: v for k, v in e.items() if k != "executor"}
                                    for e in back.stats()["journal"]["scale_events"]],
            }
        finally:
            ex.shutdown() if hasattr(ex, "shutdown") else ex.inner.shutdown()
    fresh_uids()
    inline = _drive_levels(levels_ws(torch_ws, torch_topo, [1, 6], torch_ws.InlineExecutor()), _tensor)
    assert runs["port"] == runs["ref"]
    assert runs["port"]["totals"] == [inline.value_of(inline.pipeline.tasks[f"red{w}"].last_outputs["total"])
                                      for w in (1, 6)]
    assert runs["port"]["ledger"] == inline.stats()["topology"]["ledger"]
    assert runs["port"]["scales"] and runs["port"]["scales"] == runs["port"]["replayed_scales"]


def test_resize_grow_and_shrink():
    ex = ProcessExecutor(max_workers=2)
    ex.resize(4)
    assert ex.max_workers == 4 and len(ex._workers) == 4
    ex.resize(1)
    assert ex.max_workers == 1 and len(ex._workers) == 1
    with pytest.raises(ValueError):
        ex.resize(0)
    ex.shutdown()
    with pytest.raises(TypeError, match="resize"):
        torch_ws.AdaptiveExecutor(inner=torch_ws.InlineExecutor())


# ---------------------------------------------------------------------------
# KOALJA_EXECUTOR builds every backend the reference builds
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", ["inline", "concurrent", "zoned", "zoned-concurrent", "process",
                                  "zoned-process", "adaptive", "zoned-adaptive"])
def test_default_executor_builds_every_backend(monkeypatch, name):
    monkeypatch.setenv("KOALJA_EXECUTOR", name)
    monkeypatch.setenv("KOALJA_MAX_WORKERS", "3")
    want, got = jax_ws.default_executor(), torch_ws.default_executor()
    try:
        assert type(got).__name__ == type(want).__name__
        assert repr(got) == repr(want)
    finally:
        for ex in (want, got):
            shut = getattr(ex, "shutdown", None)
            if shut is not None:
                shut()

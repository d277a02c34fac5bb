"""Engine parity: the same circuit scripts through ``repro.workspace.Workspace``
(the reference) and ``repro_torch.workspace.Workspace`` (the port), on the CPU.

Each script builds a circuit through the facade, drives it, and is
fingerprinted: the set of content hashes, every AV (travel document and
all), every task's visitor log, the firing order across tasks (registry
seq), the memo, scheduler, store and sustainability counters, and the
design map. The two packages must give equal fingerprints. Canonical means
timestamps and the wall-clock note of ``executed`` entries are dropped,
nothing else; both packages' AV uid counters restart at 0 for each script,
so uids and seqs compare as they are.

The scripts come from ``test_workspace.py``, ``test_core_koalja.py``,
``test_memo.py``, ``test_scheduler.py`` and ``test_wiring.py``, with the
quickstart's fig. 5 wiring (its ``[10/2]`` window and ``swap_new_for_old``
mode). One family runs numpy payloads through the reference and CPU tensors
of the same bytes through the port: the digests, hence everything else,
must still agree.
"""

import contextlib
import itertools
import signal

import numpy as np
import pytest
import torch

import repro.core.av as jax_av
import repro.workspace as jax_ws
import repro_torch.core.av as torch_av
import repro_torch.workspace as torch_ws
from repro_torch.core import ArtifactStore, Pipeline, PipelineManager, ProvenanceRegistry, SmartTask

LARGE = 1 << 22


# ---------------------------------------------------------------------------
# the circuit scripts: each takes a Workspace class and an array constructor
# ---------------------------------------------------------------------------


def learn_tf(**inputs):
    return {"model": {"w": float(np.mean(inputs["in"])), "version": 1}}


def server(model):
    return {"lookup": {"scale": model["w"] * 2}}


def convert(**inputs):
    return {"json": {"series": [float(np.sum(w)) for w in inputs["in"]]}}


def predict(json, lookup):
    return {"result": float(sum(json["series"])) * lookup["scale"]}


FIG5 = """
[tfmodel]
(in) learn-tf (model)
(model) server (lookup)
(in[10/2]) convert (json)
(json, lookup) predict (result)
"""


def quickstart_fig5(W, arr, **kw):
    ws = W.from_wiring(
        FIG5,
        {"learn-tf": learn_tf, "server": server, "convert": convert, "predict": predict},
        modes={"predict": "swap_new_for_old"},
        **kw,
    )
    rng = np.random.RandomState(0)
    for _ in range(14):
        sample = rng.randn(8)
        ws.push("learn-tf", **{"in": sample})
        ws.push("convert", **{"in": sample})
    ws.pull("predict")
    ws.pull("predict")  # nothing new: memo hits and prior outputs
    return ws


def simple_swap(W, arr, **kw):
    ws = W("t", **kw)
    double = ws.task(lambda x: {"y": x * 2}, name="double", inputs=["x"], outputs=["y"])
    double2 = ws.task(lambda y: {"z": y + 1}, name="double2", inputs=["y"], outputs=["z"])
    add = ws.task(lambda y, z: {"w": y + z}, name="add", inputs=["y", "z"], outputs=["w"],
                  mode="swap_new_for_old")
    double["y"] >> double2["y"]
    double["y"] >> add["y"]
    double2["z"] >> add["z"]
    ws.push(double, x=21)
    ws.push(double, x=5)
    ws.push(double, x=21)  # memo hits all the way down
    ws.pull(add)
    return ws


def memo_two_stage(W, arr, **kw):
    ws = W("memo", **kw)
    a = ws.task(lambda x: {"y": x * 2.0}, name="a", inputs=["x"], outputs=["y"])
    b = ws.task(lambda y: {"z": y + 1.0}, name="b", inputs=["y"], outputs=["z"])
    a["y"] >> b["y"]
    x = np.arange(6, dtype=np.float32)
    for v in (x, x, x + 1, x):  # hit, miss on changed content, hit again
        ws.push(a, x=arr(v))
    ws.pull(b)
    return ws


def _fanout(W, width, **kw):
    ws = W("fanout", **kw)
    s = ws.task(lambda x: {f"o{i}": x + i for i in range(width)}, name="src", inputs=["x"],
                outputs=[f"o{i}" for i in range(width)])
    sink = ws.task(lambda merged: {"total": list(merged)}, name="sink",
                   inputs=[f"i{i}" for i in range(width)], outputs=["total"], mode="merge")
    for i in range(width):
        w = ws.task(lambda v: {"w": v * 10}, name=f"w{i}", inputs=["v"], outputs=["w"])
        s[f"o{i}"] >> w["v"]
        w["w"] >> sink[f"i{i}"]
    return ws


def fanout_merge(W, arr, **kw):
    ws = _fanout(W, 4, **kw)
    for x in (100, 7, 100):
        ws.push("src", x=x)
    return ws


def diamond(W, arr, **kw):
    ws = W("diamond", **kw)
    top = ws.task(lambda x: {"y": x * 2}, name="top", inputs=["x"], outputs=["y"])
    left = ws.task(lambda y: {"l": y + 1}, name="left", inputs=["y"], outputs=["l"])
    right = ws.task(lambda y: {"r": y + 2}, name="right", inputs=["y"], outputs=["r"])
    join = ws.task(lambda l, r: {"s": l + r}, name="join", inputs=["l", "r"], outputs=["s"],
                   mode="swap_new_for_old")
    top["y"] >> left["y"]
    top["y"] >> right["y"]
    left["l"] >> join["l"]
    right["r"] >> join["r"]
    for x in (1, 2, 3, 2):
        ws.push(top, x=x)
    return ws


def cycle_bounded(W, arr, **kw):
    ws = W("cyc", max_rounds=5, **{**kw, "cache": False})
    a = ws.task(lambda x: {"y": x + 1}, name="a", inputs=["x"], outputs=["y"])
    b = ws.task(lambda y: {"x": y}, name="b", inputs=["y"], outputs=["x"])
    a["y"] >> b["y"]
    b["x"] >> a["x"]
    ws.push(a, x=0)
    ws.push(a, x=0)  # the throttled cycle resumes with a fresh budget
    return ws


def buffer_window(W, arr, **kw):
    ws = W("win", **kw)
    s = ws.source(lambda: {"x": 0}, name="s", outputs=["x"])
    agg = ws.task(lambda x: {"n": len(x), "vals": list(x)}, name="agg", inputs=["x"],
                  outputs=["n", "vals"])
    agg["x"].buffer(4, slide=2)
    s["x"] >> agg["x"]
    for i in range(8):
        ws.push(s, x=i)  # sensor emission: the payload is the source's output
    return ws


def sensor_and_services(W, arr, **kw):
    ws = W("svc", **kw)
    ticks = itertools.count()
    cam = ws.source(lambda: {"frame": next(ticks)}, name="cam", outputs=["frame"])
    det = ws.task(lambda frame, dns: {"box": [frame, dns("cam.local")["ip"]]}, name="det",
                  inputs=["frame"], outputs=["box"],
                  services={"dns": lambda host: {"host": host, "ip": "10.0.0.7"}})
    cam["frame"] >> det["frame"]
    ws.implicit("dns", det)
    for _ in range(3):
        ws.sample(cam)
    ws.pull(det)
    return ws


def array_payloads(W, arr, **kw):
    """Array payloads through every tier: small and > 4 MiB (ragged), f32,
    bool and int64; elementwise maths only, so both array libraries make the
    same bytes."""
    ws = W("arrays", **kw)
    scale = ws.task(lambda x: {"y": x * 3.0, "m": x > 0}, name="scale", inputs=["x"],
                    outputs=["y", "m"])
    shift = ws.task(lambda y, m: {"z": y - 1.0, "k": m * 1}, name="shift", inputs=["y", "m"],
                    outputs=["z", "k"])
    scale["y"] >> shift["y"]
    scale["m"] >> shift["m"]
    rng = np.random.RandomState(1)
    small = rng.randn(33, 5).astype(np.float32)
    big = rng.randn(LARGE // 4 + 7).astype(np.float32)  # 4 MiB + 28 bytes
    for x in (small, big, small, big.reshape(-1)[: LARGE // 4 + 3]):
        ws.push(scale, x=arr(x))
    return ws


SCRIPTS = {
    "quickstart_fig5": quickstart_fig5,
    "simple_swap": simple_swap,
    "memo_two_stage": memo_two_stage,
    "fanout_merge": fanout_merge,
    "diamond": diamond,
    "cycle_bounded": cycle_bounded,
    "buffer_window": buffer_window,
    "sensor_and_services": sensor_and_services,
    "array_payloads": array_payloads,
}


# ---------------------------------------------------------------------------
# fingerprints
# ---------------------------------------------------------------------------


def _visit(e: dict) -> dict:
    e = {k: v for k, v in e.items() if k != "timestamp"}
    if e["event"] == "executed" and e["note"].startswith("wall="):
        e["note"] = ""
    return e


def _av(av) -> dict:
    rec = av.to_record()
    rec.pop("created_at")
    rec["travel_document"] = [{k: v for k, v in s.items() if k != "timestamp"}
                              for s in rec["travel_document"]]
    return rec


def fingerprint(ws) -> dict:
    reg = ws.registry
    avs = [reg.get_av(u) for u in reg.all_avs()]
    tasks = ws.tasks() + ["store", "hashing"]
    logs = {t: [_visit(e) for e in ws.visitor_log(t)] for t in tasks}
    stats = ws.stats()
    store = {k: v for k, v in stats["store"].items() if k != "rho"}  # rho is a latency ratio
    sched = {k: v for k, v in stats["scheduler"].items() if k not in ("load", "backend")}
    return {
        "chashes": sorted({av.chash for av in avs}),
        "avs": [_av(av) for av in avs],
        "visits": logs,
        "order": [(e["task"], e["event"], e["av_uid"])
                  for e in sorted((e for es in logs.values() for e in es), key=lambda e: e["seq"])],
        "cache": stats["cache"],
        "sustainability": stats["sustainability"],
        "tasks": stats["tasks"],
        "links": stats["links"],
        "scheduler": sched,
        "store": store,
        "design_map": ws.design_map(),
    }


def _content_view(fp: dict) -> dict:
    """The fingerprint with AV uids replaced by content hashes and seqs
    dropped: threads of one wave interleave their registry writes, so the
    uid counter and the seq order within a wave depend on scheduling; every
    task's own log, the emission order and the counters do not."""
    uid_to = {av["uid"]: (av["source_task"], av["chash"]) for av in fp["avs"]}
    visits = {t: [(e["task"], e["event"], uid_to.get(e["av_uid"], e["av_uid"]), e["software_version"],
                   e["note"].split("=")[0]) for e in es] for t, es in fp["visits"].items()}
    return {"chashes": fp["chashes"], "visits": visits, "cache": fp["cache"],
            "sustainability": fp["sustainability"], "tasks": fp["tasks"], "links": fp["links"],
            "design_map": fp["design_map"]}


@pytest.fixture
def fresh_uids(monkeypatch):
    """Restart both packages' AV uid counters, so uids compare as they are."""

    def reset():
        monkeypatch.setattr(jax_av, "_AV_COUNTER", itertools.count())
        monkeypatch.setattr(torch_av, "_AV_COUNTER", itertools.count())

    return reset


def _numpy(a):
    return a


def _tensor(a):
    return torch.from_numpy(np.ascontiguousarray(a))


@pytest.mark.parametrize("name", sorted(SCRIPTS))
def test_circuit_fingerprints_equal(name, fresh_uids):
    script = SCRIPTS[name]
    fresh_uids()
    want = fingerprint(script(jax_ws.Workspace, _numpy, executor=jax_ws.InlineExecutor()))
    got = fingerprint(script(torch_ws.Workspace, _numpy, executor=torch_ws.InlineExecutor()))
    assert got == want
    assert want["chashes"] and want["order"]


def test_tensor_payloads_give_the_reference_fingerprint(fresh_uids):
    """The port fed CPU tensors, the reference fed numpy arrays of the same
    bytes: equal digests, so equal fingerprints."""
    fresh_uids()
    want = fingerprint(array_payloads(jax_ws.Workspace, _numpy, executor=jax_ws.InlineExecutor()))
    got = fingerprint(array_payloads(torch_ws.Workspace, _tensor, executor=torch_ws.InlineExecutor()))
    assert got == want
    assert (want["cache"]["hits"], want["cache"]["misses"]) == (2, 6)


def test_memo_counts_equal():
    runs = {}
    for pkg in (jax_ws, torch_ws):
        ws = memo_two_stage(pkg.Workspace, _numpy, executor=pkg.InlineExecutor())
        runs[pkg.__name__] = (ws.stats()["cache"], ws.stats()["tasks"])
    assert runs["repro.workspace"] == runs["repro_torch.workspace"]
    cache, tasks = runs["repro_torch.workspace"]
    assert (cache["hits"], cache["misses"]) == (4, 4)
    assert tasks == {"a": {"executions": 2, "cache_hits": 2}, "b": {"executions": 2, "cache_hits": 2}}


@pytest.mark.parametrize("name", ["fanout_merge", "diamond", "quickstart_fig5", "array_payloads"])
def test_concurrent_executor_equals_inline(name):
    script = SCRIPTS[name]
    arr = _tensor if name == "array_payloads" else _numpy
    inline = fingerprint(script(torch_ws.Workspace, arr, executor=torch_ws.InlineExecutor()))
    conc_ex = torch_ws.ConcurrentExecutor(max_workers=4)
    try:
        conc = fingerprint(script(torch_ws.Workspace, arr, executor=conc_ex))
    finally:
        conc_ex.shutdown()
    assert _content_view(conc) == _content_view(inline)


def test_fanout_merge_order_is_wave_order():
    ws = _fanout(torch_ws.Workspace, 4, executor=torch_ws.ConcurrentExecutor(4))
    ws.push("src", x=100)
    sink = ws.pipeline.tasks["sink"]
    assert ws.value_of(sink.last_outputs["total"]) == [1000, 1010, 1020, 1030]  # wave (emission) order


# ---------------------------------------------------------------------------
# the store's object tier keeps tensors whole
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.int32, torch.bool])
def test_object_tier_round_trips_tensors(tmp_path, dtype):
    store = ArtifactStore(object_dir=str(tmp_path), local_bytes_limit=64)
    base = (torch.arange(60, dtype=torch.float32).reshape(6, 10) - 20).to(dtype)
    view = base[:, ::3]  # a strided view of a larger storage
    uri, h = store.put(view, prefer="object")
    assert uri.startswith("object://")
    back = store.get(uri)
    assert back.dtype == dtype and back.device == view.device and back.shape == view.shape
    assert torch.equal(back, view)
    assert back.untyped_storage().nbytes() == view.nbytes  # written compact
    uri2, h2 = store.put(back)
    assert h2 == h  # same content, same address


def test_object_tier_keeps_requires_grad(tmp_path):
    store = ArtifactStore(object_dir=str(tmp_path))
    w = torch.randn(3, 4, requires_grad=True)
    back = store.get(store.put(w, prefer="object")[0])
    assert back.requires_grad and torch.equal(back.detach(), w.detach())


# ---------------------------------------------------------------------------
# options of the durable and extended engine run as the reference runs them
# ---------------------------------------------------------------------------

TIME_KEYS = {"created_at", "timestamp", "produced_at", "compacted_at"}


def _canon(x):
    """Timestamps and ``executed`` wall notes dropped; folded-file sizes
    (which timestamps' print lengths move) reduced to "more than 0"."""
    if isinstance(x, dict):
        out = {k: _canon(v) for k, v in x.items() if k not in TIME_KEYS}
        if "bytes_reclaimed" in out:
            out["bytes_reclaimed"] = out["bytes_reclaimed"] > 0
        if out.get("event") == "executed" and str(out.get("note", "")).startswith("wall="):
            out["note"] = ""
        return out
    if isinstance(x, list):
        return [_canon(v) for v in x]
    return x


def _pkg(W):
    """(workspace, core, topology, provenance) modules of one package."""
    import repro.core as jax_core
    import repro.provenance as jax_prov
    import repro.topology as jax_topo
    import repro_torch.core as torch_core
    import repro_torch.provenance as torch_prov
    import repro_torch.topology as torch_topo

    if W is jax_ws:
        return jax_ws, jax_core, jax_topo, jax_prov
    return torch_ws, torch_core, torch_topo, torch_prov


def _journal_view(prov, path):
    return _canon(prov.read_chain(str(path))[0])


def _opt_topology(W, d):
    _, _, T, _ = _pkg(W)
    ws = fanout_merge(W.Workspace, _numpy, topology=T.Topology.three_zone(), placement="pin")
    return fingerprint(ws), ws.stats()["topology"]


def _opt_journal_path(W, d):
    _, _, _, P = _pkg(W)
    ws = simple_swap(W.Workspace, _numpy, journal_path=str(d / "j.jsonl"))
    ws.journal.flush()
    return fingerprint(ws), _journal_view(P, d / "j.jsonl")


def _opt_journal_path_true(W, d):
    _, _, _, P = _pkg(W)
    ws = simple_swap(W.Workspace, _numpy, journal_path=True)  # a file named "True" in the cwd
    ws.journal.flush()
    return fingerprint(ws), _journal_view(P, ws.journal.path), ws.journal.path


def _opt_from_journal(W, d):
    ws = diamond(W.Workspace, _numpy, journal_path=str(d / "j.jsonl"))
    ws.journal.close()
    back = W.Workspace.from_journal(str(d / "j.jsonl"))
    reg = back.registry
    return _canon({"lineage": [reg.lineage(u) for u in reg.all_avs()],
                   "logs": {t: back.visitor_log(t) for t in back.design_map()["tasks"]},
                   "design_map": back.design_map(), "journal": back.stats()["journal"]})


def _opt_compact_journal(W, d):
    _, _, _, P = _pkg(W)
    ws = fanout_merge(W.Workspace, _numpy, journal_path=str(d / "j.jsonl"), journal_rotate_records=9)
    report = ws.compact_journal()
    report.pop("checkpoint")
    return fingerprint(ws), _canon(report), _journal_view(P, d / "j.jsonl")


def _opt_ghost(W, d):
    _, core, _, _ = _pkg(W)
    if W is jax_ws:
        import jax

        spec = jax.ShapeDtypeStruct((4, 4), np.float32)
    else:
        spec = core.ShapeDtypeStruct((4, 4), "float32")
    ws = W.Workspace("g")
    f = ws.task(lambda x: {"y": x * 2.0}, name="f", inputs=["x"], outputs=["y"])
    g = ws.task(lambda y: {"z": y + 1}, name="g", inputs=["y"], outputs=["z"])
    f["y"] >> g["y"]
    return ws.ghost({"f.x": spec}), ws.store.stats()["puts"]


def _opt_zoned(W, d):
    _, _, T, _ = _pkg(W)
    ws = fanout_merge(W.Workspace, _numpy, executor=W.ZonedExecutor(), topology=T.Topology.three_zone())
    return fingerprint(ws), ws.stats()["topology"]


def _opt_adaptive(W, d):
    ex = W.AdaptiveExecutor(min_workers=1, max_workers=4)
    ws = fanout_merge(W.Workspace, _numpy, executor=ex)
    ex.shutdown()
    return _content_view(fingerprint(ws)), ex.scale_history


def _opt_bind_journal(W, d):
    _, core, _, P = _pkg(W)
    reg = core.ProvenanceRegistry()
    reg.bind_journal(P.Journal(str(d / "j.jsonl"), flush_every_n=1, workspace="r"))
    reg.register_task("t", ["x"], ["y"], "v1")
    reg.log_visit("t", "av-x", "arrived", "v1")
    reg.record_anomaly("t", "late")
    return _journal_view(P, d / "j.jsonl")


def _opt_manager_topology(W, d):
    _, core, T, _ = _pkg(W)
    pipe = core.Pipeline("p")
    pipe._add_task(core.SmartTask("a", lambda x: {"y": x * 2}, ["x"], ["y"]))
    pipe._add_task(core.SmartTask("b", lambda y: {"z": y + 1}, ["y"], ["z"]))
    pipe._connect("a", "y", "b", "y")
    mgr = core.PipelineManager(pipe, topology=T.Topology.three_zone(), placement="data_gravity")
    for x in (1, 2, 1):
        mgr._push("a", x=x)
    return mgr.stats()["topology"], mgr.ledger.stats()


def _opt_manager_journal(W, d):
    _, core, _, P = _pkg(W)
    pipe = core.Pipeline("p")
    pipe._add_task(core.SmartTask("a", lambda x: {"y": x * 2}, ["x"], ["y"]))
    j = P.Journal(str(d / "j.jsonl"), flush_every_n=1, workspace="p")
    mgr = core.PipelineManager(pipe, journal=j)
    mgr._push("a", x=3)
    mgr._push("a", x=3)
    j.flush()
    return _journal_view(P, d / "j.jsonl")


PORTED_OPTIONS = {
    "topology": _opt_topology, "journal_path": _opt_journal_path,
    "journal_path_true": _opt_journal_path_true, "from_journal": _opt_from_journal,
    "compact_journal": _opt_compact_journal, "ghost": _opt_ghost, "zoned": _opt_zoned,
    "adaptive": _opt_adaptive, "bind_journal": _opt_bind_journal,
    "manager_topology": _opt_manager_topology, "manager_journal": _opt_manager_journal,
}


@pytest.mark.parametrize("name", list(PORTED_OPTIONS))
def test_ported_options_match_reference(name, tmp_path, monkeypatch, fresh_uids):
    """Each option that once raised here runs in both packages alike."""
    out = {}
    for label, W in (("ref", jax_ws), ("port", torch_ws)):
        d = tmp_path / label
        d.mkdir()
        monkeypatch.chdir(d)
        fresh_uids()
        out[label] = PORTED_OPTIONS[name](W, d)
    if name == "journal_path_true":
        assert out["port"][2] == out["ref"][2] == "True"
        out = {k: v[:2] for k, v in out.items()}
    assert out["port"] == out["ref"]


def _mesh_rules_run(W):
    """A circuit on MeshExecutor(rules=...) and on MeshExecutor(cfg=...):
    its task reads the rules installed around the engine call."""
    if W is jax_ws:
        from repro.configs import get_config
        from repro.launch.mesh import make_host_mesh
        from repro.models.common import get_axis_rules

        mesh = make_host_mesh()
    else:
        from repro_torch.configs import get_config
        from repro_torch.launch.mesh import make_host_mesh
        from repro_torch.models.common import get_axis_rules

        mesh = make_host_mesh(device="cpu")
    seen = []

    def f(x):
        rules = get_axis_rules()[0]
        seen.append(dict(rules))
        return {"y": x * 2 + len(rules)}

    out = []
    for kw in ({"rules": {"batch": "data"}}, {"cfg": get_config("stablelm-1.6b"), "global_batch": 8}):
        ws = W.Workspace("m", executor=W.MeshExecutor(mesh, **kw))
        t = ws.task(f, name="f", inputs=["x"], outputs=["y"])
        ws.push(t, x=20)
        ws.push(t, x=20)  # a memo hit: the task does not run again
        out.append(fingerprint(ws))
    return out, seen


def test_mesh_executor_installs_its_rules_around_engine_calls(fresh_uids):
    """MeshExecutor(rules=...) and MeshExecutor(cfg=...) (rules through
    make_rules) install the rules around each engine call in both packages:
    the tasks see equal rules, and the circuits fingerprint alike."""
    out = {}
    for label, W in (("ref", jax_ws), ("port", torch_ws)):
        fresh_uids()
        out[label] = _mesh_rules_run(W)
    assert out["port"] == out["ref"]
    assert out["port"][1][0] == {"batch": "data"} and out["port"][1][1]["embed"] == "data"
    assert len(out["port"][1]) == 2


@contextlib.contextmanager
def _bounded(seconds):
    """Fail, rather than hang, when a worker does not answer in time."""

    def expire(signum, frame):
        # not a TimeoutError: that is an OSError, which the process pool
        # takes for a dead worker and retries
        raise RuntimeError(f"no answer within {seconds} s")

    old = signal.signal(signal.SIGALRM, expire)
    signal.alarm(seconds)
    try:
        yield
    finally:
        signal.alarm(0)
        signal.signal(signal.SIGALRM, old)


@pytest.mark.parametrize("env, value", [
    ("KOALJA_TOPOLOGY", "3zone"),
    ("KOALJA_JOURNAL", "1"),
    ("KOALJA_EXECUTOR", "zoned"),
    ("KOALJA_EXECUTOR", "process"),
    ("KOALJA_EXECUTOR", "zoned-adaptive"),
])
def test_ported_env_selections_match_reference(monkeypatch, tmp_path, fresh_uids, env, value):
    """Each environment selection that once raised here builds the same
    workspace in both packages: equal fingerprints and backends."""
    import tempfile

    monkeypatch.setattr(tempfile, "tempdir", str(tmp_path))  # KOALJA_JOURNAL=1 writes under it
    monkeypatch.setenv(env, value)
    out = {}
    with _bounded(120):  # the process backend waits on its workers
        for label, W in (("ref", jax_ws), ("port", torch_ws)):
            fresh_uids()
            ws = fanout_merge(W.Workspace, _numpy)
            view = _content_view(fingerprint(ws))
            stats = ws.stats()
            out[label] = (view, stats["executor"]["backend"], stats["topology"] is None,
                          stats["journal"] is None)
            shut = getattr(ws.executor, "shutdown", None)
            if shut is not None:
                shut()
    assert out["port"] == out["ref"]
    if env == "KOALJA_JOURNAL":
        assert not out["port"][3] and any((tmp_path / "koalja-journals").iterdir())


@pytest.mark.parametrize("env, value, match", [
    ("KOALJA_TOPOLOGY", "moon", "KOALJA_TOPOLOGY"),
    ("KOALJA_EXECUTOR", "warp", "KOALJA_EXECUTOR"),
    ("KOALJA_PLACEMENT", "gravty", "KOALJA_PLACEMENT"),
])
def test_typos_raise_value_error_in_both_packages(monkeypatch, env, value, match):
    monkeypatch.setenv(env, value)
    for pkg in (jax_ws, torch_ws):
        with pytest.raises(ValueError, match=match):
            pkg.Workspace()


def test_flat_env_and_concurrent_env_run(monkeypatch):
    monkeypatch.setenv("KOALJA_TOPOLOGY", "flat")
    monkeypatch.setenv("KOALJA_EXECUTOR", "concurrent")
    monkeypatch.setenv("KOALJA_MAX_WORKERS", "3")
    monkeypatch.setenv("KOALJA_PLACEMENT", "data_gravity")
    ws = torch_ws.Workspace(journal_path=False)
    t = ws.task(lambda x: {"y": x + 1}, name="inc", inputs=["x"], outputs=["y"])
    assert ws.push(t, x=1)["inc"]["y"] == 2
    assert ws.topology is None and ws.ledger is None and ws.journal is None
    assert ws.stats()["executor"]["max_workers"] == 3


def test_legacy_task_surface_is_carried():
    pipe = Pipeline("legacy")
    pipe._add_task(SmartTask("slow", lambda x: {"y": x * 2}, ["x"], ["y"]))
    mgr = PipelineManager(pipe)
    mgr._push("slow", x=5)
    mgr._push("slow", x=5)
    assert pipe.tasks["slow"].cache_hits == 1 and pipe.tasks["slow"].executions == 1

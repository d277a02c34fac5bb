"""Journal parity: the scripts of ``test_journal.py`` and ``test_compaction.py``
through ``repro.workspace`` (the reference) and ``repro_torch.workspace`` (the
port), each journaling to its own file, on the CPU.

Every record of the two journals must be equal once canonical, as the engine
tests canonicalize: timestamps (``created_at``, ``timestamp``,
``produced_at``, ``compacted_at``) and the wall-clock note of ``executed``
entries are dropped, and ``bytes_reclaimed`` (the size of folded files, whose
timestamps print at varying lengths) is compared as "more than 0"; nothing
else. Replays, rehydrated workspaces (torn tail
included), rotated chains and compacted chains must answer equally too. One
family feeds the port CPU tensors and the reference numpy arrays of the same
bytes.
"""

import json
import os

import numpy as np
import pytest
import torch

import repro.provenance as jax_prov
import repro.topology as jax_topo
import repro.workspace as jax_ws
import repro_torch.provenance as torch_prov
import repro_torch.topology as torch_topo
import repro_torch.workspace as torch_ws
from test_torch_engine import _canon as canon
from test_torch_engine import _numpy, _tensor, fresh_uids  # noqa: F401  (fresh_uids: a fixture)

REF = (jax_ws, jax_prov, jax_topo)
PORT = (torch_ws, torch_prov, torch_topo)
def records(prov, path):
    recs, truncated, _ = prov.read_chain(str(path))
    return canon(recs), truncated


# ---------------------------------------------------------------------------
# scripts: each takes (workspace module, topology module, journal path, arr)
# ---------------------------------------------------------------------------


def _norm(x):
    return {"y": x / (np.linalg.norm(x) + 1e-9)}


def _score(y):
    return {"s": float(y.sum())}


def _chain(W, path, name="journaled", topology=False, **kw):
    ws = W.Workspace(name, journal_path=str(path), topology=topology, **kw)
    norm = ws.task(_norm, name="normalize", inputs=["x"], outputs=["y"])
    score = ws.task(_score, name="score", inputs=["y"], outputs=["s"])
    norm["y"] >> score["y"]
    return ws, norm, score


def chain_memo_anomaly(W, T, path, arr):
    ws, norm, _ = _chain(W, path)
    x = np.arange(16.0)
    ws.push(norm, x=x)
    ws.push(norm, x=x)  # memo hits
    ws.push(norm, x=x + 1)
    ws.registry.record_anomaly("score", "drift detected")
    return ws


def three_zone_pin(W, T, path, arr):
    ws, norm, score = _chain(W, path, topology=T.Topology.three_zone(), placement="pin")
    norm.place("edge")
    score.place("cloud")
    ws.push(norm, x=np.arange(64.0))
    ws.push(norm, x=np.arange(64.0) + 1)
    return ws


def three_zone_gravity(W, T, path, arr):
    ws, norm, score = _chain(W, path, topology=T.Topology.three_zone(), placement="data_gravity")
    norm.place("device")
    for i in range(3):
        ws.push(norm, x=np.arange(32.0) * i)
    return ws


def rotation_chain(W, T, path, arr):
    ws, norm, _ = _chain(W, path, name="compacted", cache=False, journal_rotate_records=7,
                         journal_flush_every_n=1)
    for i in range(5):
        ws.push(norm, x=np.arange(4.0) + i)
    return ws


def compaction_rounds(W, T, path, arr):
    ws, norm, _ = _chain(W, path, name="compacted", journal_rotate_records=10,
                         journal_flush_every_n=1)
    for i in range(4):
        ws.push(norm, x=np.arange(4.0) + i)
    victim = ws.registry.all_avs()[0]
    ws.store.evict_local(ws.registry.get_av(victim).uri)
    ws.compact_journal(retire_evicted=True)
    for i in range(3):
        ws.push(norm, x=np.arange(4.0) + i)  # two memo hits, one fresh
    ws.compact_journal()
    ws.push(norm, x=np.arange(4.0) + 9)
    return ws


def resumed_run(W, T, path, arr):
    ws = None
    for run in range(2):
        ws = W.Workspace("resumed", journal_path=str(path))
        t = ws.task(lambda x: {"y": x + 1}, name="t", inputs=["x"], outputs=["y"])
        ws.push(t, x=float(run))
        if run == 0:
            ws.journal.close()
    return ws


def tensor_chain(W, T, path, arr):
    """Elementwise maths only, so numpy and torch make the same bytes; one
    payload > 4 MiB takes the tree digest."""
    ws = W.Workspace("tensors", journal_path=str(path), topology=T.Topology.three_zone(),
                     placement="data_gravity")
    a = ws.task(lambda x: {"y": x * 0.5 + 1.0}, name="a", inputs=["x"], outputs=["y"]).place("edge")
    b = ws.task(lambda y: {"z": y * y}, name="b", inputs=["y"], outputs=["z"]).place("cloud")
    a["y"] >> b["y"]
    rng = np.random.RandomState(0)
    small = rng.randn(16, 8).astype(np.float32)
    big = rng.randn((1 << 20) + 5).astype(np.float32)
    for x in (small, big, small):
        ws.push(a, x=arr(x))
    return ws


SCRIPTS = {
    "chain_memo_anomaly": chain_memo_anomaly,
    "three_zone_pin": three_zone_pin,
    "three_zone_gravity": three_zone_gravity,
    "rotation_chain": rotation_chain,
    "compaction_rounds": compaction_rounds,
    "resumed_run": resumed_run,
    "tensor_chain": tensor_chain,
}


def _run_both(name, tmp_path, fresh_uids, port_arr=_numpy):
    fresh_uids()
    out = {}
    for label, (W, prov, T), arr in (("ref", REF, _numpy), ("port", PORT, port_arr)):
        path = tmp_path / label / "j.jsonl"
        ws = SCRIPTS[name](W, T, path, arr)
        ws.journal.flush()
        out[label] = (ws, prov, str(path))
    return out


def _forensics(ws):
    reg = ws.registry
    avs = reg.all_avs()
    stats = ws.stats()
    topo = stats.get("topology")
    return canon({
        "lineage": {u: reg.lineage(u) for u in avs},
        "visitor_logs": {t: ws.visitor_log(t) for t in ws.design_map()["tasks"]},
        "visits_of": {u: reg.visits_of(u) for u in avs},
        "design_map": ws.design_map(),
        "ledger": topo["ledger"] if topo else None,
    })


# ---------------------------------------------------------------------------
# records, replay, rehydration
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", sorted(SCRIPTS))
def test_journal_records_equal(name, tmp_path, fresh_uids):
    runs = _run_both(name, tmp_path, fresh_uids)
    (_, jp, jpath), (_, tp, tpath) = runs["ref"], runs["port"]
    want, want_torn = records(jp, jpath)
    got, got_torn = records(tp, tpath)
    assert len(got) == len(want) > 5
    assert got == want
    assert got_torn == want_torn == 0
    assert len(torch_prov.discover_chain(tpath)["segments"]) == len(
        jax_prov.discover_chain(jpath)["segments"])


def test_tensor_payloads_journal_like_numpy(tmp_path, fresh_uids):
    runs = _run_both("tensor_chain", tmp_path, fresh_uids, port_arr=_tensor)
    want, _ = records(jax_prov, runs["ref"][2])
    got, _ = records(torch_prov, runs["port"][2])
    assert got == want
    text = open(runs["port"][2]).read()
    for leak in ("torch.", "Size(", "cuda", "device(type"):
        assert leak not in text
    ledger = runs["port"][0].stats()["topology"]["ledger"]
    assert ledger == runs["ref"][0].stats()["topology"]["ledger"]
    assert ledger["bytes_moved_crosszone"] > 4 << 20  # the big payload crossed


@pytest.mark.parametrize("name", sorted(SCRIPTS))
def test_from_journal_equals_live_and_reference(name, tmp_path, fresh_uids):
    runs = _run_both(name, tmp_path, fresh_uids)
    ws, _, path = runs["port"]
    live = _forensics(ws)
    back = torch_ws.Workspace.from_journal(path)
    ref_back = jax_ws.Workspace.from_journal(runs["ref"][2])
    got = _forensics(back)
    assert got == _forensics(ref_back)
    if name not in ("compaction_rounds", "resumed_run"):
        # compaction retires history from the live registry only as far as
        # the checkpoint; a resumed run's live registry holds run 2 alone
        assert got == live
    stats, ref_stats = back.stats()["journal"], ref_back.stats()["journal"]
    for key in ("rehydrated", "replayed_records", "truncated_lines", "replayed_counts",
                "segments", "checkpoints", "records_compacted"):
        assert stats[key] == ref_stats[key], key


@pytest.mark.parametrize("name", ["chain_memo_anomaly", "three_zone_pin", "rotation_chain"])
def test_torn_tail_replays_intact_prefix(name, tmp_path, fresh_uids):
    runs = _run_both(name, tmp_path, fresh_uids)
    answers = {}
    for label, (ws, prov, path) in runs.items():
        ws.journal.close()
        with open(path, "rb") as f:
            lines = f.read().splitlines(keepends=True)
        assert len(lines) >= 2
        last = lines[-1]
        with open(path, "wb") as f:
            f.write(b"".join(lines[:-1]) + last[: len(last) // 2])
        recs, truncated = records(prov, path)
        assert truncated == 1
        W = jax_ws if label == "ref" else torch_ws
        back = W.Workspace.from_journal(path)
        answers[label] = (recs, _forensics(back), back.stats()["journal"]["truncated_lines"])
    assert answers["port"] == answers["ref"]
    assert answers["port"][2] == 1


def test_compaction_report_and_checkpoint_equal(tmp_path, fresh_uids):
    runs = _run_both("rotation_chain", tmp_path, fresh_uids)
    reports = {}
    for label, (ws, prov, path) in runs.items():
        rep = ws.compact_journal(archive_dir=str(tmp_path / label / "archive"))
        rep.pop("checkpoint")
        rep = canon(rep)
        chain = prov.read_chain(path)
        reports[label] = (rep, canon(chain[2]["checkpoint_data"]), canon(chain[0]))
        oracle = prov.replay_files(
            sorted(str(p) for p in (tmp_path / label / "archive").iterdir())
            + prov.discover_chain(path)["segments"] + [path])
        assert canon(oracle.registry.snapshot_state()["avs"]) == canon(
            prov.replay_journal(path).registry.snapshot_state()["avs"])
    assert reports["port"] == reports["ref"]
    assert reports["port"][0]["records_folded"] > 0


# ---------------------------------------------------------------------------
# the journal file's own API
# ---------------------------------------------------------------------------


def _journal_api(prov, d):
    j = prov.Journal(os.path.join(d, "j.jsonl"), flush_every_n=3, workspace="api")
    seqs = [j.append("visit", {"n": i}) for i in range(4)]
    seqs += j.append_batch([("av", {"k": "a"}), ("anomaly", {"note": "b"}, 40)])
    with j.staging():
        j.append("memo", {"key": "x"})
        with j.staging():
            j.append("memo", {"key": "y"})
    start = j.reserve(3)
    seqs.append(j.append("ledger", {"op": "resident", "chash": "c", "zone": "edge"}))
    j.append("av", {"weird": (1, 2.5, None)})
    flushes_before = j.flushes
    j.flush()
    stats = {k: v for k, v in j.stats().items() if k not in ("path", "bytes_on_disk", "encode_wall_s")}
    j.close()
    j2 = prov.Journal(os.path.join(d, "j.jsonl"), flush_every_n=1, rotate_records=3)
    resumed = [j2.append("visit", {"n": 100 + i}) for i in range(7)]
    j2.close()
    recs, truncated, info = prov.read_chain(os.path.join(d, "j.jsonl"))
    return {
        "seqs": seqs, "reserved": start, "flushes": (flushes_before, stats), "resumed": resumed,
        "records": canon(recs), "truncated": truncated,
        "segments": len(info["segments"]) if isinstance(info["segments"], list) else info["segments"],
    }


def test_journal_file_api_equal(tmp_path):
    want = _journal_api(jax_prov, str(tmp_path / "ref"))
    got = _journal_api(torch_prov, str(tmp_path / "port"))
    assert got == want
    assert want["segments"] > 1 and want["resumed"][0] > 40  # seq resumed past the forced 40


def test_torn_final_line_and_mid_file_corruption(tmp_path):
    for prov in (jax_prov, torch_prov):
        d = tmp_path / prov.__name__
        j = prov.Journal(d / "j.jsonl", flush_every_n=1)
        j.append("visit", {"n": 0})
        j.close()
        with open(j.path, "a") as f:
            f.write('{"seq": 2, "kind": "visit", "da')
        recs, truncated = prov.read_records(j.path)
        assert truncated == 1 and [r["seq"] for r in recs] == [0, 1]
        j2 = prov.Journal(d / "j.jsonl", flush_every_n=1)  # truncates, not glues
        assert j2.append("visit", {"n": 1}) == 2
        j2.close()
        assert prov.read_records(j2.path) == (prov.read_records(j2.path)[0], 0)
        bad = d / "bad.jsonl"
        bad.write_text('{"seq": 0, "kind": "meta", "data": {}}\nnot json\n'
                       '{"seq": 2, "kind": "visit", "data": {}}\n')
        with pytest.raises(prov.JournalCorruptError):
            prov.read_records(str(bad))


def test_merge_segments_equal(tmp_path):
    """Zone-runner segment files merge back into one seq-ordered stream,
    revoked windows dropped, in both packages alike."""
    out = {}
    for prov in (jax_prov, torch_prov):
        d = tmp_path / prov.__name__
        main = prov.Journal(d / "m.jsonl", flush_every_n=1, workspace="m")
        lo = main.reserve(3)
        hi = main.reserve(3)
        main.append("revoked", {"task": "t", "start": lo, "count": 3})
        main.close()
        seg = prov.Journal(d / "m.jsonl.seg-edge", flush_every_n=1, segment="edge")
        for s in range(lo, hi + 3):
            seg.append("anomaly", {"task": "t", "note": f"n{s}"}, seq=s)
        seg.close()
        merged = prov.merge_segments(str(d / "m.jsonl"), [str(d / "m.jsonl.seg-edge")])
        out[prov.__name__] = canon(merged[0] if isinstance(merged, tuple) else merged)
    assert out["repro_torch.provenance"] == out["repro.provenance"]


# ---------------------------------------------------------------------------
# the knobs: KOALJA_JOURNAL, journal_flush_every_n, stats()["journal"]
# ---------------------------------------------------------------------------


def test_env_journal_and_stats_surface(tmp_path, monkeypatch):
    monkeypatch.setenv("KOALJA_JOURNAL", str(tmp_path / "envdir"))
    shapes = {}
    for W in (jax_ws, torch_ws):
        ws = W.Workspace("envy", journal_flush_every_n=2)
        t = ws.task(lambda x: {"y": x + 1}, name="t", inputs=["x"], outputs=["y"])
        ws.push(t, x=1)
        assert ws.journal.path.startswith(str(tmp_path / "envdir"))
        s = ws.stats()["journal"]
        shapes[W.__name__] = (sorted(s), s["records_written"], s["flushes"], s["flush_every_n"])
    assert shapes["repro_torch.workspace"] == shapes["repro.workspace"]
    monkeypatch.setenv("KOALJA_JOURNAL", "0")
    assert torch_ws.Workspace("off").journal is None
    monkeypatch.setenv("KOALJA_JOURNAL", "1")
    assert torch_ws.Workspace("forced-off", journal_path=False).journal is None
    monkeypatch.setenv("KOALJA_JOURNAL_ROTATE", "many")
    with pytest.raises(ValueError, match="KOALJA_JOURNAL_ROTATE"):
        torch_ws.Workspace("rot")


def test_rehydration_never_rejournals(tmp_path, monkeypatch, fresh_uids):
    runs = _run_both("chain_memo_anomaly", tmp_path, fresh_uids)
    monkeypatch.setenv("KOALJA_JOURNAL", "1")
    back = torch_ws.Workspace.from_journal(runs["port"][2])
    assert back.journal is None and back.registry.journal is None
    json.dumps(back.stats(), default=repr)  # the stats surface serializes

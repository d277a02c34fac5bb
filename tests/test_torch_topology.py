"""Topology parity: zones, tiers, link costs, the transfer ledger and the
placements, through ``repro`` (the reference) and ``repro_torch`` (the port),
on the CPU.

The scripts are those of ``test_topology.py``: the three-zone chain and the
IoT fan-in (per-zone sensors -> per-zone aggregator -> cloud merge reducer),
under every placement and the in-process zone backends. Ledger, placement
and zone stats, merge order and the engine fingerprint must be equal; one
family feeds the port CPU tensors and the reference numpy arrays of the
same bytes, so the ledger charges ``numel * element_size`` exactly as numpy's
``nbytes``.
"""

import pickle
from types import SimpleNamespace as NS

import numpy as np
import pytest
import torch

import repro.topology as jax_topo
import repro.workspace as jax_ws
import repro_torch.topology as torch_topo
import repro_torch.workspace as torch_ws
from repro.core.store import ArtifactStore as JaxStore
from repro_torch.core.store import ArtifactStore as TorchStore
from test_torch_engine import _content_view, _numpy, _tensor, fingerprint, fresh_uids  # noqa: F401

PKGS = {"ref": (jax_ws, jax_topo), "port": (torch_ws, torch_topo)}
EDGE_ZONES = ("edge-a", "edge-b", "edge-c")


def _iot_topology(T):
    topo = T.Topology("iot")
    topo.zone("cloud", tier="cloud")
    for z in EDGE_ZONES:
        topo.zone(z, tier="edge")
        topo.link("cloud", z, bandwidth_mbps=50, latency_ms=20, energy_j_per_mb=0.05)
    return topo


def _agg(**kw):
    return {"agg": sum(kw.values())}


def _reduce(merged):
    return {"total": [float(np.asarray(m, dtype=np.float64).sum()) for m in merged]}


def iot_ws(W, T, placement, executor=None, sensors=2, topology=None):
    ws = W.Workspace("iot", topology=topology or _iot_topology(T), placement=placement,
                     executor=executor, cache=False)
    for z in EDGE_ZONES:
        for i in range(sensors):
            ws.source(lambda i=i: {"reading": np.full(4, float(i), np.float32)},
                      name=f"s_{z}_{i}", outputs=["reading"]).place(z)
        agg = ws.task(_agg, name=f"agg_{z}", inputs=[f"r{i}" for i in range(sensors)],
                      outputs=["agg"])
        for i in range(sensors):
            ws[f"s_{z}_{i}"]["reading"] >> agg[f"r{i}"]
    red = ws.task(_reduce, name="reduce", inputs=[f"a_{z}" for z in EDGE_ZONES],
                  outputs=["total"], mode="merge").place("cloud")
    for z in EDGE_ZONES:
        ws[f"agg_{z}"]["agg"] >> red[f"a_{z}"]
    return ws


def drive(ws, arr, rounds=2, n=64, sensors=2, seed=0):
    rng = np.random.RandomState(seed)
    for _ in range(rounds):
        for z in EDGE_ZONES:
            for i in range(sensors):
                ws.push(f"s_{z}_{i}", reading=arr(rng.randn(n).astype(np.float32)))
    return ws


def topo_view(ws):
    stats = ws.stats()
    return {
        "topology": stats["topology"],
        "merge_order": ws.value_of(ws.pipeline.tasks["reduce"].last_outputs["total"]),
    }


EXECUTORS = {
    "inline": lambda W: W.InlineExecutor(),
    "zoned": lambda W: W.ZonedExecutor(),
    "zoned_concurrent": lambda W: W.ZonedExecutor(inner=W.ConcurrentExecutor(4)),
    "concurrent": lambda W: W.ConcurrentExecutor(4),
}


@pytest.mark.parametrize("executor", sorted(EXECUTORS))
@pytest.mark.parametrize("placement", ["pin", "data_gravity", "energy"])
def test_iot_fan_in_equal(placement, executor, fresh_uids):
    fresh_uids()
    runs = {}
    for label, (W, T) in PKGS.items():
        ex = EXECUTORS[executor](W)
        ws = drive(iot_ws(W, T, placement, executor=ex), _numpy)
        runs[label] = (topo_view(ws), fingerprint(ws))
    (want_topo, want_fp), (got_topo, got_fp) = runs["ref"], runs["port"]
    assert got_topo == want_topo
    if executor == "concurrent" or executor == "zoned_concurrent":
        assert _content_view(got_fp) == _content_view(want_fp)
    else:
        assert got_fp == want_fp
    led = got_topo["topology"]["ledger"]
    raw = 3 * 2 * 2 * 64 * 4  # every raw reading: 3 zones x 2 sensors x 2 rounds
    assert led["bytes_moved_crosszone"] == (raw if placement == "pin" else raw // 2)


@pytest.mark.parametrize("placement", ["pin", "data_gravity"])
def test_tensor_readings_charge_like_numpy(placement, fresh_uids):
    fresh_uids()
    want = topo_view(drive(iot_ws(jax_ws, jax_topo, placement), _numpy))
    fresh_uids()
    got = topo_view(drive(iot_ws(torch_ws, torch_topo, placement), _tensor))
    assert got == want
    assert got["topology"]["ledger"]["bytes_moved_crosszone"] > 0


def test_inline_and_zoned_equal_in_the_port(fresh_uids):
    """B10's gate: zoned and inline give the same merge order, events and
    ledger."""
    views = []
    for make in (EXECUTORS["inline"], EXECUTORS["zoned_concurrent"]):
        fresh_uids()
        ws = drive(iot_ws(torch_ws, torch_topo, "data_gravity", executor=make(torch_ws)), _tensor)
        view = topo_view(ws)
        view["topology"].pop("executor_zones", None)
        views.append(view)
    assert views[0] == views[1]


# ---------------------------------------------------------------------------
# the topology model, the ledger and the placements
# ---------------------------------------------------------------------------


def _model(T):
    three = T.Topology.three_zone()
    iot = _iot_topology(T)
    t = T.Topology("t")
    t.zone("cloud")
    t.zone("edge", tier="edge")
    t.link("cloud", "edge", bandwidth_mbps=100, energy_j_per_mb=0.05)
    t.zone("dev", tier="device")
    out = {
        "three": three.describe(),
        "iot": iot.describe(),
        "roundtrip": T.Topology.from_spec(iot.describe()).describe(),
        "names": (three.zone_names(), three.default_zone, three.tier_of("device")),
        "costs": [vars(t.cost(a, b)) if hasattr(t.cost(a, b), "__dict__") else repr(t.cost(a, b))
                  for a in ("cloud", "edge", "dev") for b in ("cloud", "edge", "dev")],
        "energy": t.transfer_energy_j("cloud", "edge", 2_000_000),
    }
    for bad in (lambda: t.zone("cloud"), lambda: t.zone("x", tier="orbit")):
        with pytest.raises(T.TopologyError):
            bad()
    return out


def test_topology_model_equal():
    assert _model(torch_topo) == _model(jax_topo)


def _ledger(T):
    led = T.TransferLedger(T.Topology.three_zone())
    led.register_resident("h1", "edge")
    moves = [led.on_materialize("h1", 1000, "edge", "cloud"),
             led.on_materialize("h1", 1000, "edge", "cloud"),
             led.on_materialize("h2", 1000, "edge", "edge"),
             led.on_materialize("h3", 2_000_000, "device", "cloud")]
    return moves, led.stats(), led.snapshot_state()


def test_ledger_equal():
    assert _ledger(torch_topo) == _ledger(jax_topo)
    moves, stats, _ = _ledger(torch_topo)
    assert moves == [True, False, False, True] and stats["by_pair"]["edge->cloud"] == 1000


def _placements(T):
    t = T.Topology("wan")
    t.zone("cloud", tier="cloud")
    t.zone("edge", tier="edge")
    t.zone("device", tier="device")
    t.link("device", "edge", latency_ms=1, bandwidth_mbps=1000, energy_j_per_mb=0.01)
    t.link("edge", "cloud", latency_ms=20, bandwidth_mbps=100, energy_j_per_mb=0.05)
    t.link("device", "cloud", latency_ms=50, bandwidth_mbps=10, energy_j_per_mb=0.5)
    av = NS(uid="u1", meta={"zone": "device", "nbytes": 1_000_000})
    task = NS(pinned_zone=None, zone=None, policy=NS(buffers={"x": NS(fresh=[av], window=[])}))
    pinned = NS(pinned_zone="device", zone=None, policy=NS(buffers={}))
    idle = NS(pinned_zone=None, zone=None, policy=NS(buffers={}))
    out = {}
    for name in ("pin", "data_gravity", "energy"):
        pol = T.make_placement(name, t)
        out[name] = (type(pol).__name__, pol.zone_for(task, None), pol.zone_for(pinned, None),
                     pol.zone_for(idle, None))
    with pytest.raises(T.TopologyError):
        T.make_placement("teleport", t)
    with pytest.raises(T.TopologyError, match="bound to topology"):
        T.make_placement(T.PinPlacement(T.Topology.three_zone()), t)
    return out


def test_placements_equal():
    got = _placements(torch_topo)
    assert got == _placements(jax_topo)
    assert got["energy"][1] == "edge" and got["data_gravity"][1] == "device"


@pytest.mark.parametrize("placement", ["pin", "data_gravity", "energy"])
def test_env_three_zone_and_placement_equal(monkeypatch, placement, fresh_uids):
    monkeypatch.setenv("KOALJA_TOPOLOGY", "3zone")
    monkeypatch.setenv("KOALJA_PLACEMENT", placement)
    views = {}
    fresh_uids()
    for label, (W, T) in PKGS.items():
        ws = W.Workspace("env", cache=False)
        src = ws.source(lambda x: {"x": x}, name="src", outputs=["x"]).place("device")
        t = ws.task(lambda x: {"y": x * 2.0}, name="double", inputs=["x"], outputs=["y"])
        u = ws.task(lambda y: {"z": y + 1.0}, name="inc", inputs=["y"], outputs=["z"]).place("cloud")
        src["x"] >> t["x"]
        t["y"] >> u["y"]
        for i in range(3):
            ws.push("src", x=np.full(256, float(i), np.float32))
        views[label] = (T.default_topology().describe(), ws.stats()["topology"], fingerprint(ws))
    assert views["port"] == views["ref"]
    assert views["port"][1]["ledger"]["executions_charged"] > 0


def test_unknown_topology_env_raises(monkeypatch):
    monkeypatch.setenv("KOALJA_TOPOLOGY", "klingon")
    for T in (jax_topo, torch_topo):
        with pytest.raises(ValueError):
            T.default_topology()
    monkeypatch.setenv("KOALJA_TOPOLOGY", "flat")
    assert torch_topo.default_topology() is None


# ---------------------------------------------------------------------------
# the ledger's bytes: ArtifactStore._nbytes
# ---------------------------------------------------------------------------


def test_payload_bytes_equal_for_arrays_and_json_dicts():
    x = np.arange(24, dtype=np.float32).reshape(4, 6)
    for a, b in ((x, torch.from_numpy(x)), (x[:, ::2].copy(), torch.from_numpy(x)[:, ::2]),
                 ({"w": 1.5, "tags": ["a", "b"]}, {"w": 1.5, "tags": ["a", "b"]}),
                 (7, 7), ("text", "text")):
        assert TorchStore._nbytes(b) == JaxStore._nbytes(a)
    assert TorchStore._nbytes(torch.zeros(3, 5, dtype=torch.bfloat16)) == 30


def test_dict_of_tensors_pickles_to_another_length():
    """A dict holding tensors has no ``nbytes`` and is charged its pickle
    length. The port pickles a tensor by value, as the numpy array of its
    values, so the charge equals the reference's for the dict of numpy
    arrays of the same bytes, and is no longer the length of torch's own
    pickle, whose storage record names the storage (fault F2, repaired)."""
    x = np.arange(64, dtype=np.float32)
    ref_payload, port_payload = {"w": x, "step": 3}, {"w": torch.from_numpy(x), "step": 3}
    ref_len, port_len = JaxStore._nbytes(ref_payload), TorchStore._nbytes(port_payload)
    assert ref_len == len(pickle.dumps(ref_payload, protocol=4))
    assert port_len == ref_len
    assert port_len != len(pickle.dumps(port_payload, protocol=4))

"""Tenancy parity: the scripts of ``test_tenancy.py`` through ``repro.tenancy``
(the reference) and ``repro_torch.tenancy`` (the port), on the CPU.

Each script runs once through each package, on the same drawn or fixed
session script, and the two must agree: every tenant's fingerprint
(``tenant_fingerprint``, byte-equal strings), the errors raised (type and
message) and the roles held, the quota stats and the journaled quota
anomalies, the hub memo's stats, and the hub's and the tenants' journal
records once canonical (timestamps and ``executed`` wall notes dropped, as
``test_torch_journal.py`` compares them). The port's tenants must also
fingerprint as the port's own solo run of the same script. One family feeds
the port CPU tensors and the reference numpy arrays of the same bytes. B15
(``benchmarks/bench_koalja.py::bench_multitenant``) runs at its defaults
through both. Every test runs under an alarm, since some fork workers.
"""

import os
import signal
import threading
from types import SimpleNamespace as NS

import numpy as np
import pytest
import torch

try:
    from hypothesis import given, settings, strategies as st
except ImportError:  # hermetic containers: seeded-random fallback
    from repro.testing.hypothesis_fallback import given, settings, strategies as st

import repro.provenance as jax_prov
import repro.runtime as jax_rt
import repro.tenancy as jax_ten
import repro.topology as jax_topo
import repro.workspace as jax_ws
import repro_torch.provenance as torch_prov
import repro_torch.runtime as torch_rt
import repro_torch.tenancy as torch_ten
import repro_torch.topology as torch_topo
import repro_torch.workspace as torch_ws
from test_torch_engine import _canon as canon
from test_torch_engine import fresh_uids  # noqa: F401  (a fixture)

PKGS = {
    "ref": NS(ten=jax_ten, W=jax_ws, T=jax_topo, rt=jax_rt, prov=jax_prov),
    "port": NS(ten=torch_ten, W=torch_ws, T=torch_topo, rt=torch_rt, prov=torch_prov),
}
FUZZ_EXAMPLES = int(os.environ.get("KOALJA_FUZZ_EXAMPLES", "20"))
BOUND_S = 120  # a hung worker fails its test instead of stalling the run


class WorkerHang(Exception):
    """Raised by the alarm. Not an OSError: the pool takes an OSError from a
    pipe for a dead worker and retries on a fresh one."""


@pytest.fixture(autouse=True)
def bounded():
    def expire(signum, frame):
        raise WorkerHang(f"test exceeded {BOUND_S} s")

    old = signal.signal(signal.SIGALRM, expire)
    signal.alarm(BOUND_S)
    yield
    signal.alarm(0)
    signal.signal(signal.SIGALRM, old)


# ---------------------------------------------------------------------------
# the circuit of test_tenancy.py (module-level functions: one software
# version in both packages)
# ---------------------------------------------------------------------------


def _fx_src(x):
    return {"out": [int(v) * 2 for v in x]}


def _fx_left(v):
    return {"y": [int(i) + 1 for i in v]}


def _fx_right(v):
    return {"y": [int(i) - 1 for i in v]}


def _fx_join(a, b):
    return {"out": sum(a) + sum(b)}


def _wire(api, zoned=False):
    src = api.task(_fx_src, name="src", inputs=["x"], outputs=["out"])
    left = api.task(_fx_left, name="left", inputs=["v"], outputs=["y"])
    right = api.task(_fx_right, name="right", inputs=["v"], outputs=["y"])
    join = api.task(_fx_join, name="join", inputs=["a", "b"], outputs=["out"])
    if zoned:
        src.place("edge")
        left.place("edge")
        right.place("cloud")
        join.place("cloud")
    api.wire(src["out"], left["v"])
    api.wire(src["out"], right["v"])
    api.wire(left["y"], join["a"])
    api.wire(right["y"], join["b"])


def _topo(T):
    t = T.Topology("duo")
    t.zone("cloud", tier="cloud")
    t.zone("edge", tier="edge")
    t.link("cloud", "edge", bandwidth_mbps=50, latency_ms=10, energy_j_per_mb=0.05)
    return t


def _payload(i):
    return [i, i + 1, i + 2]


def _array(i):
    return np.array(_payload(i), dtype=np.int64)


def _tensor(i):
    return torch.tensor(_payload(i), dtype=torch.int64)


# payload makers: JSON lists through both; numpy arrays (reference) against
# CPU tensors of the same bytes (port)
PAYLOADS = {"json": {"ref": _payload, "port": _payload}, "tensor": {"ref": _array, "port": _tensor}}


def _stop(ws):
    stop = getattr(ws.executor, "shutdown", None)
    if stop:
        stop()


def _solo(P, payloads, make=_payload, *, executor=None, topology=False, journal_path=False, zoned=False):
    ws = P.W.Workspace("solo", executor=executor, topology=topology, journal_path=journal_path)
    _wire(ws, zoned=zoned)
    for p in payloads:
        ws.push("src", x=make(p))
    return ws


def _solo_fp(P, payloads, make=_payload, **kw):
    ws = _solo(P, payloads, make, **kw)
    fp = P.ten.tenant_fingerprint(ws)
    _stop(ws)
    return fp


def _backends(P):
    return {
        "inline": P.W.InlineExecutor,
        "concurrent": lambda: P.W.ConcurrentExecutor(max_workers=4),
        "zoned": P.W.ZonedExecutor,
        "zoned-concurrent": lambda: P.W.ZonedExecutor(inner=P.W.ConcurrentExecutor(max_workers=4)),
        "process": lambda: P.rt.ProcessExecutor(max_workers=2),
        "zoned-process": lambda: P.rt.ZonedProcessExecutor(max_workers=2),
    }


BACKENDS = ["inline", "concurrent", "zoned", "zoned-concurrent", "process", "zoned-process"]
FORKING = {"process", "zoned-process"}


def _needs_fork(label):
    if label in FORKING and torch_rt.fork_context() is None:
        pytest.skip("fork start method unavailable")


def _journal(P, path):
    return canon(P.prov.read_chain(str(path))[0])


def _outcome(fn):
    """``("ok", result)`` or ``(error type name, message)``."""
    try:
        return ("ok", fn())
    except Exception as e:  # noqa: BLE001 - the error is the result compared
        return (type(e).__name__, str(e))


# ---------------------------------------------------------------------------
# the isolation property
# ---------------------------------------------------------------------------


def _interleaved(P, scripts, picks, make):
    hub = P.ten.WorkspaceHub("hub", journal_path=False, executor_factory=P.W.InlineExecutor,
                             workspace_defaults={"topology": False})
    sessions = [hub.create(f"t{i}", owner=f"u{i}") for i in range(len(scripts))]
    for s in sessions:
        _wire(s)
    cursors = [0] * len(scripts)
    for pick in picks:
        sessions[pick].push("src", x=make(scripts[pick][cursors[pick]]))
        cursors[pick] += 1
    return hub, sessions


class TestIsolationProperty:
    @settings(max_examples=FUZZ_EXAMPLES, deadline=None)
    @given(st.data())
    def test_any_interleaving_matches_solo_and_the_reference(self, data):
        n_tenants = data.draw(st.integers(min_value=2, max_value=4))
        scripts = [
            data.draw(st.lists(st.integers(min_value=0, max_value=3), min_size=1, max_size=4))
            for _ in range(n_tenants)
        ]
        cursors, picks = [0] * n_tenants, []
        while any(c < len(s) for c, s in zip(cursors, scripts)):
            live = [i for i in range(n_tenants) if cursors[i] < len(scripts[i])]
            pick = live[data.draw(st.integers(min_value=0, max_value=len(live) - 1))]
            picks.append(pick)
            cursors[pick] += 1
        runs = {}
        for label, P in PKGS.items():
            hub, sessions = _interleaved(P, scripts, picks, _payload)
            runs[label] = ([s.fingerprint() for s in sessions], [s.ws._cache.stats() for s in sessions],
                           hub.memo.stats())
        assert runs["port"] == runs["ref"]
        P = PKGS["port"]
        for i, fp in enumerate(runs["port"][0]):
            assert fp == _solo_fp(P, scripts[i], executor=P.W.InlineExecutor())

    @pytest.mark.parametrize("payloads", sorted(PAYLOADS))
    def test_cross_tenant_dedup_and_scoping(self, payloads):
        runs = {}
        for label, P in PKGS.items():
            make = PAYLOADS[payloads][label]
            hub = P.ten.WorkspaceHub("hub", journal_path=False, workspace_defaults={"topology": False})
            a = hub.create("team-a", owner="alice")
            b = hub.create("team-b", owner="bev")
            _wire(a)
            _wire(b)
            assert a.ws.store is b.ws.store
            a.push("src", x=make(7))
            before = hub.memo.stats()
            b.push("src", x=make(7))
            after = hub.memo.stats()
            assert after["executions_avoided"] - before["executions_avoided"] == 4
            assert after["by_tenant"]["team-b"]["hits"] == 4
            fa, fb = a.fingerprint(), b.fingerprint()
            assert fa == fb == _solo_fp(P, [7], make)
            assert "team-a" not in fb and "team-b" not in fa
            assert not set(a.ws.registry.all_avs()) & set(b.ws.registry.all_avs())
            runs[label] = (fa, after, hub.store.stats()["puts"])
        assert runs["port"] == runs["ref"]

    def test_dedup_falls_through_on_evicted_origin(self):
        runs = {}
        for label, P in PKGS.items():
            hub = P.ten.WorkspaceHub("hub", journal_path=False, workspace_defaults={"topology": False})
            a = hub.create("a", owner="u")
            b = hub.create("b", owner="u")
            _wire(a)
            _wire(b)
            a.push("src", x=_payload(1))
            for uid in a.ws.registry.all_avs():
                try:
                    hub.store.evict_local(a.ws.registry.get_av(uid).uri)
                except Exception:
                    pass
            b.push("src", x=_payload(1))  # recomputes instead of replaying
            runs[label] = ({t: b.ws.pipeline.tasks[t].executions for t in ("src", "left", "right", "join")},
                           hub.memo.stats(), b.fingerprint())
        assert runs["port"] == runs["ref"]
        assert runs["port"][0]["join"] >= 1

    def test_dedup_replay_hands_out_the_origin_tensors(self):
        """A cross-tenant replay takes the origin's payload objects out of the
        shared store by reference: tenant B's outputs are tenant A's tensors."""
        P = PKGS["port"]
        hub = P.ten.WorkspaceHub("hub", journal_path=False, workspace_defaults={"topology": False})
        a, b = hub.create("a", owner="u"), hub.create("b", owner="u")
        for s in (a, b):
            s.task(lambda x: {"y": x * 2.0}, name="double", inputs=["x"], outputs=["y"])
        x = torch.arange(16.0)
        out_a = a.push("double", x=x)["double"]["y"]
        out_b = b.push("double", x=x.clone())["double"]["y"]
        assert out_b is out_a
        assert hub.memo.stats()["executions_avoided"] == 1


# ---------------------------------------------------------------------------
# every executor backend
# ---------------------------------------------------------------------------

BACKEND_SCRIPTS = {"t0": [0, 1, 0], "t1": [0, 2], "t2": [2, 1]}


def _round_robin(sessions, scripts, make=_payload):
    step = 0
    while True:
        advanced = False
        for name, script in scripts.items():
            if step < len(script):
                sessions[name].push("src", x=make(script[step]))
                advanced = True
        if not advanced:
            return
        step += 1


class TestBackendDeterminism:
    @pytest.mark.parametrize("label", BACKENDS)
    def test_tenant_fingerprints_equal_the_reference(self, label, tmp_path, fresh_uids):
        """Per backend: each tenant's fingerprint equals the reference's and the
        port's solo run on the same backend; the hub's journal records equal
        the reference's; on the in-process serial backends the tenants'
        segments do too (threads and workers race the seqs of one wave)."""
        _needs_fork(label)
        runs = {}
        for pkg, P in PKGS.items():
            fresh_uids()  # memo records name uids: equal counters, equal records
            d = tmp_path / pkg
            d.mkdir()
            factory = _backends(P)[label]
            hub = P.ten.WorkspaceHub(f"hub-{label}", journal_path=str(d / "hub.jsonl"), executor_factory=factory)
            sessions = {n: hub.create(n, owner="op", topology=_topo(P.T)) for n in BACKEND_SCRIPTS}
            for s in sessions.values():
                _wire(s, zoned=True)
            _round_robin(sessions, BACKEND_SCRIPTS)
            fps = {n: s.fingerprint() for n, s in sessions.items()}
            hub.flush()
            segs = {n: _journal(P, d / os.path.basename(s.ws.journal.path)) for n, s in sessions.items()}
            runs[pkg] = dict(fps=fps, hub=_journal(P, d / "hub.jsonl"), segs=segs,
                             quota={n: s.quota_stats() for n, s in sessions.items()})
            hub.shutdown()
        assert runs["port"]["fps"] == runs["ref"]["fps"]
        assert runs["port"]["quota"] == runs["ref"]["quota"]
        assert runs["port"]["hub"] == runs["ref"]["hub"]
        if label in ("inline", "zoned"):
            assert runs["port"]["segs"] == runs["ref"]["segs"]
        P = PKGS["port"]
        for name, script in BACKEND_SCRIPTS.items():
            solo = _solo_fp(P, script, executor=_backends(P)[label](), topology=_topo(P.T), zoned=True)
            assert runs["port"]["fps"][name] == solo, f"tenant {name} diverged from solo under {label}"


# ---------------------------------------------------------------------------
# quotas
# ---------------------------------------------------------------------------


def _hub_one(P, quota, **hub_kw):
    hub = P.ten.WorkspaceHub("hub", journal_path=hub_kw.pop("journal_path", False),
                             workspace_defaults={"topology": False}, **hub_kw)
    s = hub.create("t", owner="u", quota=quota)
    _wire(s)
    return hub, s


def _quota_notes(ws):
    return [a["note"] for a in ws.registry.anomalies if a["note"].startswith("quota_")]


class TestQuotas:
    def test_soft_warning_journaled_exactly_once_per_crossing(self):
        runs = {}
        for label, P in PKGS.items():
            hub, s = _hub_one(P, P.ten.TenantQuota(soft_bytes=1))
            for i in range(4):
                s.push("src", x=_payload(i))
            runs[label] = (_quota_notes(s.ws), s.quota_stats())
        assert runs["port"] == runs["ref"]
        assert len(runs["port"][0]) == 1 and runs["port"][0][0].startswith("quota_warning axis=bytes")

    @pytest.mark.parametrize("payloads", sorted(PAYLOADS))
    def test_hard_rejection_is_deterministic_and_charges_zero(self, payloads):
        big = {"ref": np.zeros(500, np.uint8), "port": torch.zeros(500, dtype=torch.uint8)}
        runs = {}
        for label, P in PKGS.items():
            hub, s = _hub_one(P, P.ten.TenantQuota(hard_bytes=120 if payloads == "json" else 200))
            s.push("src", x=PAYLOADS[payloads][label](0))
            used = s.quota_stats()["ingress_bytes"]
            avs = len(s.ws.registry.all_avs())
            err = _outcome(lambda: s.push("src", x=bytes(500) if payloads == "json" else big[label]))
            assert err[0] == "QuotaExceededError"
            assert s.quota_stats()["ingress_bytes"] == used
            assert s.quota_stats()["rejections"] == 1
            assert len(s.ws.registry.all_avs()) == avs
            runs[label] = (err, _quota_notes(s.ws), s.quota_stats(), s.fingerprint())
        assert runs["port"] == runs["ref"]
        assert [n.split()[0] for n in runs["port"][1]] == ["quota_rejected"]

    @pytest.mark.parametrize("label", BACKENDS)
    def test_hard_rejection_identical_across_backends(self, label):
        _needs_fork(label)
        runs = {}
        for pkg, P in PKGS.items():
            hub = P.ten.WorkspaceHub("hub", journal_path=False, executor_factory=_backends(P)[label],
                                     workspace_defaults={"topology": False})
            s = hub.create("t", owner="u", quota=P.ten.TenantQuota(hard_bytes=120))
            _wire(s)
            s.push("src", x=_payload(0))
            err = _outcome(lambda: s.push("src", x=bytes(500)))
            s.push("src", x=_payload(1))  # life goes on after a rejection
            runs[pkg] = (err, s.fingerprint(), s.quota_stats())
            hub.shutdown()
        assert runs["port"] == runs["ref"]
        assert runs["port"][0][0] == "QuotaExceededError"

    def test_quota_story_replays_from_journal(self, tmp_path):
        runs = {}
        for label, P in PKGS.items():
            path = tmp_path / f"{label}-hub.jsonl"
            hub, s = _hub_one(P, P.ten.TenantQuota(hard_bytes=120, soft_bytes=1), journal_path=str(path))
            s.push("src", x=_payload(0))
            err = _outcome(lambda: s.push("src", x=bytes(500)))
            hub.flush()
            re = P.ten.WorkspaceHub.from_journal(str(path))
            replayed = re.workspace("t")
            runs[label] = (err, _quota_notes(replayed), re.quotas["t"].to_record(),
                           P.ten.tenant_fingerprint(replayed) == s.fingerprint())
        assert runs["port"] == runs["ref"]
        notes = runs["port"][1]
        assert [n.split()[:2] for n in notes] == [["quota_warning", "axis=bytes"], ["quota_rejected", "axis=bytes"]]
        assert runs["port"][2]["hard_bytes"] == 120 and runs["port"][3]

    @pytest.mark.parametrize("payloads", sorted(PAYLOADS))
    def test_joule_quota_on_zoned_circuit(self, payloads):
        runs = {}
        for label, P in PKGS.items():
            make = PAYLOADS[payloads][label]
            hub = P.ten.WorkspaceHub("hub", journal_path=False)
            s = hub.create("t", owner="u", quota=P.ten.TenantQuota(hard_joules=1e-9, soft_joules=1e-12),
                           topology=_topo(P.T))
            _wire(s, zoned=True)
            s.push("src", x=make(0))  # crosses a zone link: spends joules
            assert s.quota_stats()["joules_used"] > 0
            ledger = s.ws.ledger.stats()
            err = _outcome(lambda: s.push("src", x=make(1)))
            assert s.ws.ledger.stats() == ledger  # the refusal moved nothing
            runs[label] = (err, _quota_notes(s.ws), s.quota_stats(), ledger, s.fingerprint())
        assert runs["port"] == runs["ref"]
        assert runs["port"][0][0] == "QuotaExceededError"
        assert [n.split()[:2] for n in runs["port"][1]] == [["quota_warning", "axis=joules"],
                                                             ["quota_rejected", "axis=joules"]]


# ---------------------------------------------------------------------------
# memberships, roles, sessions
# ---------------------------------------------------------------------------


def _membership_hub(P):
    hub = P.ten.WorkspaceHub("hub", journal_path=False, workspace_defaults={"topology": False})
    owner = hub.create("team", owner="alice")
    _wire(owner)
    return hub, owner


def _roles_script(P):
    hub, owner = _membership_hub(P)
    out = [
        _outcome(lambda: hub.grant("team", "bob", "writer", by="alice")),
        _outcome(lambda: hub.grant("team", "carol", "reader", by="alice")),
        _outcome(lambda: bool(owner.push("src", x=_payload(0)))),
        _outcome(lambda: bool(hub.workspace("team", user="bob").push("src", x=_payload(1)))),
    ]
    carol = hub.workspace("team", user="carol")
    out += [
        _outcome(lambda: len(carol.visitor_log("join"))),
        _outcome(lambda: carol.push("src", x=_payload(2))),
        _outcome(lambda: carol.compact_journal()),
        _outcome(lambda: hub.grant("team", "dave", "writer", by="bob")),
        _outcome(lambda: hub.workspace("team", user="mallory")),
        _outcome(lambda: hub.grant("team", "erin", "admin", by="alice")),
        [(u, hub.role_of("team", u)) for u in ("alice", "bob", "carol", "dave", "mallory")],
        carol.role,
    ]
    return out, owner.fingerprint()


def _last_owner_script(P):
    hub, _ = _membership_hub(P)
    out = [
        _outcome(lambda: hub.revoke("team", "alice", by="alice")),
        _outcome(lambda: hub.grant("team", "alice", "reader", by="alice")),
        _outcome(lambda: hub.grant("team", "bob", "owner", by="alice")),
        _outcome(lambda: hub.revoke("team", "alice", by="bob")),
        _outcome(lambda: hub.revoke("team", "zed", by="bob")),
    ]
    return out, hub.role_of("team", "alice"), hub.role_of("team", "bob")


def _unknown_tenants_script(P):
    hub, _ = _membership_hub(P)
    return [
        _outcome(lambda: hub.create("team", owner="zed")),
        _outcome(lambda: hub.create("team?", owner="zed") and hub.create("team!", owner="zed")),
        _outcome(lambda: hub.workspace("nope")),
        _outcome(lambda: hub.role_of("nope", "u")),
        hub.tenants(),
    ]


MEMBERSHIP = {"roles": _roles_script, "last_owner": _last_owner_script, "unknown_tenants": _unknown_tenants_script}


class TestMembership:
    @pytest.mark.parametrize("script", sorted(MEMBERSHIP))
    def test_errors_and_roles_equal_the_reference(self, script):
        runs = {label: MEMBERSHIP[script](P) for label, P in PKGS.items()}
        assert runs["port"] == runs["ref"]

    def test_roles_enforced(self):
        out, _ = _roles_script(PKGS["port"])
        kinds = [o[0] if isinstance(o, tuple) else None for o in out[:10]]
        assert kinds == ["ok", "ok", "ok", "ok", "ok", "PermissionDeniedError", "PermissionDeniedError",
                         "PermissionDeniedError", "PermissionDeniedError", "TenancyError"]
        assert out[4][1] > 0  # readers see tenant forensics

    def test_koalja_tenant_env_selects_workspace(self, monkeypatch):
        runs = {}
        for label, P in PKGS.items():
            hub, _ = _membership_hub(P)
            monkeypatch.setenv("KOALJA_TENANT", "team")
            s = hub.workspace()
            monkeypatch.delenv("KOALJA_TENANT")
            runs[label] = ((s.tenant, s.user, s.role), _outcome(hub.workspace))
        assert runs["port"] == runs["ref"]
        assert runs["port"][0] == ("team", "alice", "owner") and runs["port"][1][0] == "TenancyError"


# ---------------------------------------------------------------------------
# concurrency, and a zone runner's death
# ---------------------------------------------------------------------------


class TestConcurrentTenants:
    def test_many_threads_one_hub(self, tmp_path):
        n_tenants, pushes = 8, 4
        scripts = {f"t{i}": [(i + k) % 3 for k in range(pushes)] for i in range(n_tenants)}
        runs = {}
        for label, P in PKGS.items():
            d = tmp_path / label
            d.mkdir()
            hub = P.ten.WorkspaceHub("hub", journal_path=str(d / "hub.jsonl"),
                                     executor_factory=lambda: P.W.ConcurrentExecutor(max_workers=2),
                                     workspace_defaults={"topology": False})
            sessions = {n: hub.create(n, owner="op") for n in scripts}
            for s in sessions.values():
                _wire(s)
            errors = []

            def drive(name):
                try:
                    for p in scripts[name]:
                        sessions[name].push("src", x=_payload(p))
                except Exception as e:  # pragma: no cover - surfaced below
                    errors.append((name, e))

            threads = [threading.Thread(target=drive, args=(n,)) for n in scripts]
            for t in threads:
                t.start()
            for t in threads:
                t.join()
            assert not errors
            assert hub.memo.stats()["executions_avoided"] > 0
            hub.flush()
            re = P.ten.WorkspaceHub.from_journal(str(d / "hub.jsonl"))
            assert re.tenants() == sorted(scripts)
            fps = {n: s.fingerprint() for n, s in sessions.items()}
            assert {n: P.ten.tenant_fingerprint(re.workspace(n)) for n in scripts} == fps
            runs[label] = fps
            hub.shutdown()
        assert runs["port"] == runs["ref"]
        P = PKGS["port"]
        for name, script in scripts.items():
            assert runs["port"][name] == _solo_fp(P, script, executor=P.W.ConcurrentExecutor(max_workers=2))

    def test_zone_runner_death_stays_contained(self, tmp_path):
        _needs_fork("zoned-process")
        parent_pid = os.getpid()
        runs = {}
        for label, P in PKGS.items():
            d = tmp_path / label
            d.mkdir()
            crash_flag = str(d / "crash-once")
            open(crash_flag, "w").close()

            def _left_boom(v, crash_flag=crash_flag):
                if os.getpid() != parent_pid and os.path.exists(crash_flag):
                    os.remove(crash_flag)
                    os._exit(1)
                return {"y": [int(i) + 1 for i in v]}

            hub = P.ten.WorkspaceHub("hub", journal_path=str(d / "hub.jsonl"),
                                     executor_factory=lambda: P.rt.ZonedProcessExecutor(max_workers=2))
            victim = hub.create("victim", owner="op", topology=_topo(P.T))
            bystander = hub.create("bystander", owner="op", topology=_topo(P.T))
            src = victim.task(_fx_src, name="src", inputs=["x"], outputs=["out"])
            left = victim.task(_left_boom, name="left", inputs=["v"], outputs=["y"])
            right = victim.task(_fx_right, name="right", inputs=["v"], outputs=["y"])
            join = victim.task(_fx_join, name="join", inputs=["a", "b"], outputs=["out"])
            src.place("edge")
            left.place("edge")
            right.place("cloud")
            join.place("cloud")
            victim.wire(src["out"], left["v"])
            victim.wire(src["out"], right["v"])
            victim.wire(left["y"], join["a"])
            victim.wire(right["y"], join["b"])
            _wire(bystander, zoned=True)
            bystander.push("src", x=_payload(5))
            victim.push("src", x=_payload(0))  # the runner dies; window revoked; retried
            victim.push("src", x=_payload(1))
            bystander.push("src", x=_payload(6))
            hub.flush()
            seg = d / os.path.basename(victim.ws.journal.path)
            assert any(r.get("kind") == "revoked" for r in P.prov.read_chain(str(seg))[0])
            re = P.ten.WorkspaceHub.from_journal(str(d / "hub.jsonl"))
            dead = re.workspace("victim")
            uids = dead.registry.all_avs()
            assert len(uids) == len(set(uids))
            assert any(a["note"].startswith("worker_died") for a in dead.registry.anomalies)
            runs[label] = (P.ten.tenant_fingerprint(re.workspace("bystander")), bystander.fingerprint(),
                           sorted((r[0], r[1]) for r in _avs(P.ten.tenant_fingerprint(dead))))
            hub.shutdown()
        assert runs["port"] == runs["ref"]
        assert runs["port"][0] == runs["port"][1]


def _avs(fp: str) -> list:
    import json

    return [(row["task"], row["chash"]) for row in json.loads(fp)["avs"]]


# ---------------------------------------------------------------------------
# the hub journal: control-plane replay, the merged operator view, compaction
# ---------------------------------------------------------------------------


class TestHubReplay:
    def test_control_plane_rehydrates(self, tmp_path, fresh_uids):
        runs = {}
        for label, P in PKGS.items():
            fresh_uids()  # memo_of names the origin's uids: equal counters, equal records
            (tmp_path / label).mkdir()
            path = str(tmp_path / label / "hub.jsonl")
            hub = P.ten.WorkspaceHub("hub", journal_path=path, workspace_defaults={"topology": False})
            a = hub.create("team-a", owner="alice", quota=P.ten.TenantQuota(hard_bytes=1 << 20))
            b = hub.create("team-b", owner="bev")
            hub.grant("team-a", "bob", "writer", by="alice")
            hub.set_quota("team-b", P.ten.TenantQuota(soft_bytes=10), by="bev")
            hub.revoke("team-a", "bob", by="alice")
            hub.grant("team-a", "carol", "reader", by="alice")
            _wire(a)
            _wire(b)
            a.push("src", x=_payload(3))
            b.push("src", x=_payload(3))  # hub-level cache_hit with memo_of
            hub.flush()
            re = P.ten.WorkspaceHub.from_journal(path)
            merged = re.merged_workspace()
            assert len(merged.registry.all_avs()) == len(a.ws.registry.all_avs()) + len(b.ws.registry.all_avs())
            runs[label] = dict(
                tenants=re.tenants(), memberships=re.memberships,
                quotas={t: q.to_record() if q else None for t, q in re.quotas.items()},
                dedup=re.dedup_events, memo=re.memo.stats(), hub_stats=_hub_view(hub.stats()),
                fps={t: P.ten.tenant_fingerprint(re.workspace(t)) for t in re.tenants()},
                journal=_journal(P, path), merged=P.ten.tenant_fingerprint(merged))
        assert runs["port"] == runs["ref"]
        port = runs["port"]
        assert port["memberships"]["team-a"] == {"alice": "owner", "carol": "reader"}
        assert len(port["dedup"]) == 4
        assert port["dedup"][0]["origin_tenant"] == "team-a" and port["dedup"][0]["memo_of"]

    def test_tenant_compaction_in_hub_seq_space(self, tmp_path):
        runs = {}
        for label, P in PKGS.items():
            (tmp_path / label).mkdir()
            path = str(tmp_path / label / "hub.jsonl")
            hub = P.ten.WorkspaceHub("hub", journal_path=path, workspace_defaults={"topology": False})
            s = hub.create("t", owner="u")
            _wire(s)
            for i in range(3):
                s.push("src", x=_payload(i))
            s.ws.journal.rotate()
            report = s.compact_journal()
            hub.flush()
            replayed = P.ten.WorkspaceHub.from_journal(path).workspace("t")
            assert len(replayed.registry.all_avs()) == len(s.ws.registry.all_avs())
            report = {**canon(report), "checkpoint": os.path.basename(report["checkpoint"])}
            runs[label] = (report, P.ten.tenant_fingerprint(replayed), s.fingerprint())
        assert runs["port"] == runs["ref"]
        assert runs["port"][1] == runs["port"][2]


def _hub_view(stats: dict) -> dict:
    """``WorkspaceHub.stats()`` without the store's latency ratio, the
    journal's wall times, its path and its byte counts (timestamps print at
    varying lengths)."""
    out = dict(stats)
    out["store"] = {k: v for k, v in stats["store"].items() if k != "rho"}
    out["journal"] = {k: v for k, v in stats["journal"].items()
                      if "bytes" not in k and not k.endswith("_s") and k != "path"}
    return out


# ---------------------------------------------------------------------------
# B15: the multi-tenant hub at benchmarks/bench_koalja.py's defaults
# ---------------------------------------------------------------------------


def _mt_src(x):
    return {"out": x * 2.0}


def _mt_left(v):
    return {"y": v + 1.0}


def _mt_right(v):
    return {"y": v - 1.0}


def _mt_join(a, b):
    return {"out": float(a.sum() + b.sum())}


def b15(P, path, full, tenants=64, working_set=8):
    """``bench_multitenant``'s hub and traffic, its counts without its times:
    each tenant pushes the whole working set, rotated."""
    hub = P.ten.WorkspaceHub("bench-hub", journal_path=str(path), executor_factory=P.W.InlineExecutor,
                             workspace_defaults={"topology": False})
    sessions = []
    for i in range(tenants):
        s = hub.create(f"tenant-{i:03d}", owner="bench")
        src = s.task(_mt_src, name="src", inputs=["x"], outputs=["out"])
        left = s.task(_mt_left, name="left", inputs=["v"], outputs=["y"])
        right = s.task(_mt_right, name="right", inputs=["v"], outputs=["y"])
        join = s.task(_mt_join, name="join", inputs=["a", "b"], outputs=["out"])
        s.wire(src["out"], left["v"])
        s.wire(src["out"], right["v"])
        s.wire(left["y"], join["a"])
        s.wire(right["y"], join["b"])
        sessions.append(s)
    payloads = [full(float(p)) for p in range(working_set)]
    for i, s in enumerate(sessions):
        for k in range(working_set):
            s.push("src", x=payloads[(i + k) % working_set])
    hub.flush()
    memo = hub.memo.stats()
    records = hub.journal.stats()["records_written"] + sum(s.ws.journal.stats()["records_written"]
                                                          for s in sessions)
    out = dict(logical_firings=tenants * working_set * 4, executions_avoided=memo["executions_avoided"],
               bytes_saved=memo["bytes_saved"], records_written=records,
               fingerprints=[s.fingerprint() for s in sessions[:4]])
    hub.shutdown()
    return out


def test_b15_counts_equal_the_reference(tmp_path):
    ref = b15(PKGS["ref"], tmp_path / "ref.jsonl", lambda v: np.full(256, v, np.float32))
    port = b15(PKGS["port"], tmp_path / "port.jsonl", lambda v: torch.full((256,), v))
    assert port == ref
    assert (port["logical_firings"], port["executions_avoided"]) == (2048, 2016)

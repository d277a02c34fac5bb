"""WorkspaceHub — the multi-tenant workspace control plane.

One hub hosts many named workspaces ("tenants") over **shared substrate**
and **private control state**:

* shared: one content-addressed :class:`~repro_torch.core.store.ArtifactStore`
  (identical payloads stored once, hub-wide) and one
  :class:`~repro_torch.tenancy.memo.HubMemoStore` (identical *computations* run
  once, hub-wide — see :mod:`repro_torch.tenancy.memo` for the scoping rules);
* private: per-tenant :class:`~repro_torch.workspace.Workspace` with its own
  registry (lineage/visitor-log reads are strictly tenant-scoped), its own
  executor, its own :class:`~repro_torch.tenancy.quota.TenantMeter`, and its own
  journal *segment*.

Journal layout reuses the reserved-seq-window machinery the zoned runtime
already trusts: the hub owns one :class:`~repro_torch.provenance.Journal` whose
monotonic counter is the **hub seq space**; each tenant gets a
``<hub>.seg-t-<name>`` journal constructed with ``seq_source=hub`` so every
tenant record carries a hub-unique seq, and zone-runner sub-segments
(``<hub>.seg-t-<name>.seg-<zone>``) nest for free because the runner
reserves windows through the tenant journal, which forwards to the hub.
One tenant's chain replays alone (``Workspace.from_journal``) for the
tenant-scoped story; all chains merge by seq for the operator's hub-wide
story (:meth:`WorkspaceHub.from_journal` → :class:`RehydratedHub`).

Memberships follow the EOEPCA workspace model the paper's ecosystem grew
into: a tenant workspace is (membership, storage, sessions) — here roles
``reader < writer < owner`` enforced per operation on a
:class:`TenantSession`, shared storage with tenant-scoped views, and
sessions bound to a (tenant, user) pair via :meth:`WorkspaceHub.workspace`
(``KOALJA_TENANT`` names the default tenant, mirroring how
``KOALJA_EXECUTOR`` names the default backend).

Port of ``repro.tenancy.hub``.
"""

from __future__ import annotations

import os
import re
import threading
from typing import Any, Callable, Optional

from repro_torch.core.store import ArtifactStore
from repro_torch.provenance import Journal, read_chain
from repro_torch.workspace import Workspace

from .fingerprint import tenant_fingerprint
from .memo import HubMemoStore, TenantMemoCache
from .quota import (
    PermissionDeniedError,
    TenancyError,
    TenantMeter,
    TenantQuota,
)

ROLES = ("reader", "writer", "owner")
_RANK = {role: i for i, role in enumerate(ROLES)}


def _safe(name: str) -> str:
    return re.sub(r"[^A-Za-z0-9_.-]", "-", name)


def _zone_segments(base: str) -> list:
    """Discover a tenant segment's zone-runner sub-segments on disk:
    ``<base>.seg-<zone>`` files, excluding rotated parts (``.NNNN``),
    checkpoints, and temp files — mirror of what the tenant's own
    ``executor.segment_paths()`` would have answered live."""
    parent = os.path.dirname(base) or "."
    prefix = os.path.basename(base) + ".seg-"
    out = []
    try:
        names = os.listdir(parent)
    except OSError:
        return out
    for name in names:
        if not name.startswith(prefix):
            continue
        rest = name[len(prefix):]
        if ".ckpt-" in rest or rest.endswith(".tmp"):
            continue
        if re.search(r"\.\d{4,}$", rest):
            continue  # rotated part of a sub-segment; chain-read from base
        out.append(os.path.join(parent, name))
    return sorted(out)


class _Tenant:
    """Hub-internal record for one hosted workspace."""

    def __init__(self, name: str, ws: Workspace, owner: str, meter: TenantMeter,
                 segment: Optional[str]) -> None:
        self.name = name
        self.ws = ws
        self.members = {owner: "owner"}
        self.meter = meter
        self.segment = segment  # basename of the tenant journal, or None


class WorkspaceHub:
    """Host thousands of named workspaces over one store + one seq space."""

    def __init__(
        self,
        name: str = "hub",
        *,
        store: Optional[ArtifactStore] = None,
        journal_path=None,
        journal_flush_every_n: Optional[int] = None,
        default_quota: Optional[TenantQuota] = None,
        executor_factory: Optional[Callable[[], Any]] = None,
        workspace_defaults: Optional[dict] = None,
    ) -> None:
        self.name = name
        self.store = store or ArtifactStore()
        self._flush_every_n = journal_flush_every_n
        self._journal = self._make_journal(journal_path, journal_flush_every_n)
        self.memo = HubMemoStore()
        if self._journal is not None:
            self.memo.bind_journal(self._journal)
        self.default_quota = default_quota
        # executor_factory builds one *fresh* executor per tenant (executors
        # bind to a single manager); None -> each Workspace defers to
        # KOALJA_EXECUTOR exactly as a standalone one would.
        self._executor_factory = executor_factory
        self._ws_defaults = dict(workspace_defaults or {})
        self._tenants: dict = {}
        self._lock = threading.RLock()

    def _make_journal(self, journal_path, flush_every_n):
        # Same env contract as Workspace._make_journal: False -> off,
        # a Journal instance -> adopt, None -> defer to KOALJA_JOURNAL.
        if journal_path is False:
            return None
        if hasattr(journal_path, "append_batch"):
            return journal_path
        if journal_path is None:
            env = os.environ.get("KOALJA_JOURNAL", "").strip()
            if env.lower() in ("", "0", "false", "no", "off"):
                return None
            import tempfile
            import uuid

            if env.lower() in ("1", "true", "yes", "on"):
                root = os.path.join(tempfile.gettempdir(), "koalja-journals")
            else:
                root = env
            os.makedirs(root, exist_ok=True)
            journal_path = os.path.join(
                root, f"{self.name}-hub-{os.getpid()}-{uuid.uuid4().hex[:8]}.jsonl"
            )
        return Journal(journal_path, flush_every_n=flush_every_n, workspace=self.name)

    @property
    def journal(self):
        return self._journal

    # -- tenant lifecycle ----------------------------------------------------
    def create(
        self,
        name: str,
        owner: str,
        *,
        quota: Optional[TenantQuota] = None,
        **ws_kwargs: Any,
    ) -> "TenantSession":
        """Provision a tenant workspace; returns the owner's session."""
        with self._lock:
            if name in self._tenants:
                raise TenancyError(f"tenant {name!r} already exists")
            safe = _safe(name)
            if any(_safe(t) == safe for t in self._tenants):
                raise TenancyError(
                    f"tenant {name!r} collides with an existing tenant's "
                    f"segment name {safe!r}"
                )
            tjournal = None
            segment = None
            if self._journal is not None:
                seg_path = f"{self._journal.path}.seg-t-{safe}"
                tjournal = Journal(
                    seg_path,
                    flush_every_n=self._flush_every_n,
                    workspace=name,
                    seq_source=self._journal,
                )
                segment = os.path.basename(seg_path)
            kw = dict(self._ws_defaults)
            kw.update(ws_kwargs)
            executor = kw.pop("executor", None)
            if executor is None and self._executor_factory is not None:
                executor = self._executor_factory()
            cache = kw.pop("cache", None)
            if cache is None:
                cache = TenantMemoCache(self.memo, tenant=name)
            ws = Workspace(
                name,
                executor=executor,
                store=self.store,
                cache=cache,
                journal_path=tjournal if tjournal is not None else False,
                **kw,
            )
            q = quota if quota is not None else self.default_quota
            tenant = _Tenant(name, ws, owner, TenantMeter(name, q), segment)
            self._tenants[name] = tenant
            if self._journal is not None:
                self._journal.append(
                    "tenant",
                    {
                        "name": name,
                        "owner": owner,
                        "segment": segment,
                        "quota": q.to_record() if q is not None else None,
                    },
                )
            return TenantSession(self, tenant, owner)

    def _tenant(self, name: str) -> _Tenant:
        t = self._tenants.get(name)
        if t is None:
            raise TenancyError(f"no tenant named {name!r} on hub {self.name!r}")
        return t

    def tenants(self) -> list:
        with self._lock:
            return sorted(self._tenants)

    # -- memberships ---------------------------------------------------------
    def role_of(self, tenant: str, user: str) -> Optional[str]:
        with self._lock:
            return self._tenant(tenant).members.get(user)

    def _require(self, tenant: "_Tenant", user: str, role: str) -> None:
        have = tenant.members.get(user)
        if have is None or _RANK[have] < _RANK[role]:
            raise PermissionDeniedError(
                f"user {user!r} needs role {role!r} on tenant "
                f"{tenant.name!r} (has {have!r})"
            )

    def grant(self, tenant: str, user: str, role: str, *, by: str) -> None:
        if role not in _RANK:
            raise TenancyError(f"unknown role {role!r} (choose from {ROLES})")
        with self._lock:
            t = self._tenant(tenant)
            self._require(t, by, "owner")
            if (
                t.members.get(user) == "owner"
                and role != "owner"
                and sum(1 for r in t.members.values() if r == "owner") == 1
            ):
                raise TenancyError(
                    f"cannot demote {user!r}: last owner of {tenant!r}"
                )
            t.members[user] = role
            if self._journal is not None:
                self._journal.append(
                    "grant", {"tenant": tenant, "user": user, "role": role, "by": by}
                )

    def revoke(self, tenant: str, user: str, *, by: str) -> None:
        with self._lock:
            t = self._tenant(tenant)
            self._require(t, by, "owner")
            if user not in t.members:
                raise TenancyError(f"{user!r} is not a member of {tenant!r}")
            if (
                t.members[user] == "owner"
                and sum(1 for r in t.members.values() if r == "owner") == 1
            ):
                raise TenancyError(
                    f"cannot revoke {user!r}: last owner of {tenant!r}"
                )
            del t.members[user]
            if self._journal is not None:
                self._journal.append(
                    "revoke_grant", {"tenant": tenant, "user": user, "by": by}
                )

    def set_quota(self, tenant: str, quota: Optional[TenantQuota], *, by: str) -> None:
        with self._lock:
            t = self._tenant(tenant)
            self._require(t, by, "owner")
            t.meter.quota = quota
            if self._journal is not None:
                self._journal.append(
                    "quota",
                    {
                        "tenant": tenant,
                        "quota": quota.to_record() if quota is not None else None,
                        "by": by,
                    },
                )

    # -- sessions ------------------------------------------------------------
    def workspace(
        self, name: Optional[str] = None, user: Optional[str] = None
    ) -> "TenantSession":
        """Open a session on a tenant workspace. ``name=None`` reads the
        ``KOALJA_TENANT`` env var; ``user=None`` binds as the tenant's
        (first) owner."""
        if name is None:
            name = os.environ.get("KOALJA_TENANT", "").strip() or None
        if name is None:
            raise TenancyError(
                "no tenant named and KOALJA_TENANT is unset — pass "
                "hub.workspace('tenant-name') or export KOALJA_TENANT"
            )
        with self._lock:
            t = self._tenant(name)
            if user is None:
                owners = sorted(u for u, r in t.members.items() if r == "owner")
                user = owners[0]
            if user not in t.members:
                raise PermissionDeniedError(
                    f"user {user!r} is not a member of tenant {name!r}"
                )
            return TenantSession(self, t, user)

    # -- hub-wide operations -------------------------------------------------
    def flush(self) -> None:
        """Flush every tenant segment, then the hub journal."""
        with self._lock:
            tenants = list(self._tenants.values())
        for t in tenants:
            if t.ws.journal is not None:
                t.ws.journal.flush()
        if self._journal is not None:
            self._journal.flush()

    def shutdown(self) -> None:
        """Stop tenant executors and flush all journals (hub stays usable;
        executors refork lazily on the next wave)."""
        with self._lock:
            tenants = list(self._tenants.values())
        for t in tenants:
            stop = getattr(t.ws.executor, "shutdown", None)
            if stop is not None:
                stop()
        self.flush()

    def stats(self) -> dict:
        with self._lock:
            tenants = dict(self._tenants)
        out = {
            "hub": self.name,
            "tenants": len(tenants),
            "memberships": sum(len(t.members) for t in tenants.values()),
            "memo": self.memo.stats(),
            "store": self.store.stats(),
            "by_tenant": {
                name: t.meter.stats(
                    t.ws._manager.ledger if t.ws._manager is not None else None
                )
                for name, t in tenants.items()
            },
        }
        if self._journal is not None:
            out["journal"] = self._journal.stats()
        return out

    @classmethod
    def from_journal(cls, path: str) -> "RehydratedHub":
        """Rehydrate the hub control plane (tenants, grants, quotas, the
        cross-tenant dedup story) plus per-tenant forensic workspaces from
        a hub journal chain written by a previous process."""
        return RehydratedHub(path)


class TenantSession:
    """Role-enforced facade over one tenant's Workspace.

    Every operation checks the binding user's role first (reader for
    forensic reads, writer for anything that moves data or edits the
    circuit, owner for compaction and membership/quota changes — those last
    two live on the hub), then meters quota around the engine call. The
    underlying Workspace is never handed out by accident: escape through
    ``.ws`` is deliberate and bypasses the control plane.
    """

    def __init__(self, hub: WorkspaceHub, tenant: _Tenant, user: str) -> None:
        self._hub = hub
        self._t = tenant
        self.tenant = tenant.name
        self.user = user

    # deliberate escape hatch (no enforcement beyond this point)
    @property
    def ws(self) -> Workspace:
        return self._t.ws

    @property
    def role(self) -> Optional[str]:
        return self._t.members.get(self.user)

    def _require(self, role: str) -> None:
        self._hub._require(self._t, self.user, role)

    def _ledger(self):
        # Only consult a ledger that already exists: touching ws.ledger
        # would build (and freeze) the circuit mid-declaration. Before the
        # first build the ledger is empty anyway, so the meter reading is
        # identical.
        mgr = self._t.ws._manager
        return mgr.ledger if mgr is not None else None

    # -- breadboard (writer) -------------------------------------------------
    def task(self, *args: Any, **kwargs: Any):
        self._require("writer")
        return self._t.ws.task(*args, **kwargs)

    def source(self, *args: Any, **kwargs: Any):
        self._require("writer")
        return self._t.ws.source(*args, **kwargs)

    def wire(self, *args: Any, **kwargs: Any):
        self._require("writer")
        return self._t.ws.wire(*args, **kwargs)

    def implicit(self, *args: Any, **kwargs: Any):
        self._require("writer")
        return self._t.ws.implicit(*args, **kwargs)

    def __getitem__(self, task: str):
        self._require("reader")
        return self._t.ws[task]

    # -- runtime (writer, metered) -------------------------------------------
    def push(self, task, *, region: str = "local", **payloads: Any):
        self._require("writer")
        ws = self._t.ws
        nbytes = sum(ArtifactStore._nbytes(p) for p in payloads.values())
        self._t.meter.charge_ingress(
            nbytes, ws._name_of(task), ws.registry, self._ledger()
        )
        out = ws.push(task, region=region, **payloads)
        self._t.meter.observe(ws._name_of(task), ws.registry, self._ledger())
        return out

    def inject(self, task, input_name: str, payload: Any, *, region: str = "local"):
        self._require("writer")
        ws = self._t.ws
        self._t.meter.charge_ingress(
            ArtifactStore._nbytes(payload), ws._name_of(task), ws.registry,
            self._ledger(),
        )
        out = ws.inject(task, input_name, payload, region=region)
        self._t.meter.observe(ws._name_of(task), ws.registry, self._ledger())
        return out

    def sample(self, source):
        self._require("writer")
        ws = self._t.ws
        out = ws.sample(source)
        self._t.meter.observe(ws._name_of(source), ws.registry, self._ledger())
        return out

    def ghost(self, *args: Any, **kwargs: Any):
        self._require("writer")
        return self._t.ws.ghost(*args, **kwargs)

    # -- runtime (reader) ----------------------------------------------------
    def pull(self, target):
        self._require("reader")
        ws = self._t.ws
        out = ws.pull(target)
        self._t.meter.observe(ws._name_of(target), ws.registry, self._ledger())
        return out

    def watch(self, target, callback: Optional[Callable] = None):
        self._require("reader")
        return self._t.ws.watch(target, callback)

    # -- forensics (reader; strictly tenant-scoped) --------------------------
    def value_of(self, av):
        self._require("reader")
        return self._t.ws.value_of(av)

    def lineage(self, av):
        self._require("reader")
        return self._t.ws.lineage(av)

    def visitor_log(self, task):
        self._require("reader")
        return self._t.ws.visitor_log(task)

    def traveller_log(self, av):
        self._require("reader")
        return self._t.ws.traveller_log(av)

    def design_map(self):
        self._require("reader")
        return self._t.ws.design_map()

    def stats(self) -> dict:
        self._require("reader")
        return self._t.ws.stats()

    def quota_stats(self) -> dict:
        self._require("reader")
        return self._t.meter.stats(self._ledger())

    def fingerprint(self) -> str:
        self._require("reader")
        return tenant_fingerprint(self._t.ws)

    # -- maintenance (owner) -------------------------------------------------
    def compact_journal(self, **kwargs: Any) -> dict:
        self._require("owner")
        return self._t.ws.compact_journal(**kwargs)


class RehydratedHub:
    """Forensic view of a hub journal chain: the control-plane story (who
    owned what, which grants and quotas applied, which pushes deduped
    against whose runs) plus per-tenant workspace rehydration — each tenant
    replays **alone** from its own segment chain, so the isolation contract
    survives rehydration too. :meth:`merged_workspace` is the operator's
    escape hatch: every segment merged into one hub-wide registry."""

    def __init__(self, path: str) -> None:
        self.path = path
        records, self.truncated, self.chain = read_chain(path)
        self.memberships: dict = {}  # tenant -> {user: role}
        self.quotas: dict = {}
        self.segments: dict = {}  # tenant -> segment basename (or None)
        self.memo = HubMemoStore()
        self.dedup_events: list = []
        for r in records:
            kind, data = r.get("kind"), r.get("data") or {}
            if kind == "tenant":
                name = data.get("name")
                self.memberships[name] = {data.get("owner"): "owner"}
                self.segments[name] = data.get("segment")
                self.quotas[name] = TenantQuota.from_record(data.get("quota"))
            elif kind == "grant":
                self.memberships.setdefault(data.get("tenant"), {})[
                    data.get("user")
                ] = data.get("role")
            elif kind == "revoke_grant":
                self.memberships.get(data.get("tenant"), {}).pop(
                    data.get("user"), None
                )
            elif kind == "quota":
                self.quotas[data.get("tenant")] = TenantQuota.from_record(
                    data.get("quota")
                )
            elif kind == "hub_memo":
                self.memo.restore_offer(
                    data.get("tenant"), data.get("key"), data.get("record")
                )
            elif kind == "cache_hit" and data.get("scope") == "hub":
                self.dedup_events.append(dict(data))

    def tenants(self) -> list:
        return sorted(self.memberships)

    def _segment_path(self, tenant: str) -> str:
        seg = self.segments.get(tenant)
        if seg is None:
            raise TenancyError(
                f"tenant {tenant!r} has no journal segment in {self.path!r}"
            )
        return os.path.join(os.path.dirname(self.path) or ".", seg)

    def workspace(self, tenant: str) -> Workspace:
        """Rehydrate one tenant's workspace from its own chain only."""
        if tenant not in self.memberships:
            raise TenancyError(f"no tenant named {tenant!r} in {self.path!r}")
        base = self._segment_path(tenant)
        zones = _zone_segments(base)
        if zones:
            return Workspace.from_journal([base, *zones])
        return Workspace.from_journal(base)

    def merged_workspace(self) -> Workspace:
        """Operator view: all tenants' records merged into one registry by
        hub seq. Crosses tenant boundaries by design — gate access to this
        the way you would gate root."""
        segs: list = []
        for tenant in self.tenants():
            if self.segments.get(tenant) is None:
                continue
            base = self._segment_path(tenant)
            segs.append(base)
            segs.extend(_zone_segments(base))
        return Workspace.from_journal([self.path, *segs])

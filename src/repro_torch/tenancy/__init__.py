"""repro_torch.tenancy — multi-tenant workspace control plane (hub).

One :class:`WorkspaceHub` hosts many named workspaces over a shared
content-addressed store and a shared cross-tenant memo index, with
per-tenant memberships/roles, journal segments, and transfer quotas::

    from repro_torch.tenancy import WorkspaceHub, TenantQuota

    hub = WorkspaceHub("prod", journal_path="/var/log/koalja/hub.jsonl")
    alice = hub.create("team-a", owner="alice",
                       quota=TenantQuota(hard_bytes=1 << 30))
    hub.grant("team-a", "bob", "reader", by="alice")
    bob = hub.workspace("team-a", user="bob")

See :mod:`repro_torch.tenancy.hub` for the architecture and ``docs/tenancy.md``
for the runnable walkthrough (written for the JAX package; the API is the
same). Port of ``repro.tenancy``, path for path; payloads may be torch
tensors on a card.
"""

from .fingerprint import tenant_fingerprint
from .hub import ROLES, RehydratedHub, TenantSession, WorkspaceHub
from .memo import HubMemoStore, TenantMemoCache
from .quota import (
    PermissionDeniedError,
    QuotaExceededError,
    TenancyError,
    TenantMeter,
    TenantQuota,
)

__all__ = [
    "HubMemoStore",
    "PermissionDeniedError",
    "QuotaExceededError",
    "ROLES",
    "RehydratedHub",
    "TenancyError",
    "TenantMemoCache",
    "TenantMeter",
    "TenantQuota",
    "TenantSession",
    "WorkspaceHub",
    "tenant_fingerprint",
]

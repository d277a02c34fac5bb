"""Smart Task agents (paper §III.I).

A SmartTask wraps plugin user code in policy-guided services so the platform,
not the user, handles: snapshot assembly from incoming links, content-addressed
caching (make semantics), provenance stamping, out-of-band service-call
freezing (§III.D), and anomaly notes.

The user function receives the assembled snapshot as keyword arguments — the
platform analogue of ``<USER CODE> <ARGV list>`` — and returns a dict of
outputs (or a single value for single-output tasks).
"""

from __future__ import annotations

import contextlib
import dataclasses
import hashlib
import inspect
import time
from typing import Any, Callable, Optional

from repro_torch.cache import MemoCache, make_record, snapshot_key

from .av import AnnotatedValue, content_hash, is_ghost
from .hashing import content_hash_batch
from .policy import InputSpec, SnapshotPolicy
from .provenance import ProvenanceRegistry
from .store import ArtifactStore


class FiringBatch(list):
    """Outputs of a *coalesced* ``execute()``: one ``{output: AV}`` dict per
    firing, in firing order. Tasks opted in via ``TaskHandle.coalesce`` drain
    several ready snapshots in one dispatch; the scheduler emits each firing
    separately and in order, so downstream arrival order (merge FCFS) is
    bit-identical to the non-coalesced run — only the per-dispatch overhead
    is amortized."""

    @property
    def last(self) -> dict:
        return self[-1] if self else {}


@dataclasses.dataclass
class ExecutionPlan:
    """A cache-missed firing, frozen between snapshot and user code.

    ``begin_execution`` produces one when the memo layer cannot answer; the
    caller then runs the user function wherever it likes — on this thread
    (``execute``), or in a worker process (:mod:`repro.runtime`) that only
    ever sees the plan's *references* — and completes the firing with
    ``finish_execution`` / ``finish_remote``.
    """

    snap: dict  # input name -> AV | [AVs] (the formed snapshot)
    in_hashes: dict  # input name -> chash | [chashes]
    parent_uids: list  # lineage parents for every output AV
    key: str  # memo key (already looked up — it missed)
    use_cache: bool  # memoize the result (False for sources / cache off)
    # Optional content-dedup closure (multi-tenant hubs): a cache that
    # implements ``plan_dedup(key)`` may hand back a callable that replays
    # the outputs another scope already computed for this key. The firing
    # then skips the user function but keeps every tenant-visible side
    # effect of a real execution (see ``run_user_fn``). Never pickled —
    # plans crossing a process pipe go as ``snapshot_refs()``.
    dedup: Any = None

    def snapshot_refs(self) -> dict:
        """Picklable reference view of the snapshot — ``(uri, chash)`` plus
        AV metadata, never payloads — for shipping to a worker process."""

        def ref(av: AnnotatedValue) -> dict:
            return {
                "uid": av.uid,
                "uri": av.uri,
                "chash": av.chash,
                "region": av.region,
                "meta": dict(av.meta),
            }

        return {
            name: [ref(a) for a in val] if isinstance(val, list) else ref(val)
            for name, val in self.snap.items()
        }


def software_version_of(fn: Callable) -> str:
    """Code hash standing in for the container image digest: the 'software
    version' recorded in every travel document."""
    try:
        src = inspect.getsource(fn)
    except (OSError, TypeError):
        code = getattr(fn, "__code__", None)
        src = repr(code.co_code) + repr(code.co_consts) if code else repr(fn)
    return "v-" + hashlib.sha256(src.encode()).hexdigest()[:12]


class ServiceCall:
    """An out-of-band client-server lookup made forensically traceable
    (paper §III.D: 'if data were read from a mutable external source, say
    DNS, cache the response for forensic traceability')."""

    def __init__(self, name: str, fn: Callable) -> None:
        self.name = name
        self.fn = fn
        self.version = software_version_of(fn)
        self.frozen_responses: list = []

    def __call__(self, *args: Any) -> Any:
        resp = self.fn(*args)
        args_hash, response_hash = content_hash_batch((args, resp))
        self.frozen_responses.append(
            {
                "service": self.name,
                "args_hash": args_hash,
                "response_hash": response_hash,
                "timestamp": time.time(),
            }
        )
        return resp


class SmartTask:
    def __init__(
        self,
        name: str,
        fn: Callable,
        inputs: list,
        outputs: list,
        mode: str = "all_new",
        min_interval_s: float = 0.0,
        region: str = "local",
        cache_ttl_s: Optional[float] = None,
        services: Optional[dict] = None,
        source: bool = False,
        zone: Optional[str] = None,
        coalesce_max: Optional[int] = None,
    ) -> None:
        self.name = name
        self.fn = fn
        self.version = software_version_of(fn)
        self.input_specs = [
            s if isinstance(s, InputSpec) else InputSpec.parse(s) for s in inputs
        ]
        self.outputs = list(outputs)
        self.policy = SnapshotPolicy(
            self.input_specs, mode=mode, min_interval_s=min_interval_s
        )
        self.region = region
        self.cache_ttl_s = cache_ttl_s
        self.services = {
            n: (s if isinstance(s, ServiceCall) else ServiceCall(n, s))
            for n, s in (services or {}).items()
        }
        self.source = source
        # Arrival coalescing (TaskHandle.coalesce): drain up to this many
        # ready snapshots in one execute() dispatch. 1 = classic behavior.
        self.coalesce_max = max(1, int(coalesce_max or 1))
        # Extended-cloud placement (repro.topology): `pinned_zone` is the
        # user's constraint (TaskHandle.place), `zone` the current
        # assignment — rewritten per wave by the manager's PlacementPolicy.
        self.pinned_zone = zone
        self.zone: Optional[str] = None
        self.topology = None
        self.ledger = None
        self.zone_executions: dict = {}
        # (link, src_zone) of ingested AVs, judged against the *final* zone
        # assignment at execute time (a task is in at most one wave at a
        # time, so only its own execution thread touches this list)
        self._pending_zone_refs: list = []
        self.executions = 0
        self.cache_hits = 0
        self.bytes_saved = 0  # output bytes this task's memo hits never remade
        # EWMA of wall seconds per execution (adaptive-runtime feedback;
        # folded into the scheduler's LoadSignals at wave boundaries). Only
        # this task's execution thread writes it — a task is in at most one
        # wave at a time.
        self.service_ewma_s: Optional[float] = None
        # wired by Pipeline
        self.in_links: dict = {}  # input name -> SmartLink
        self.out_links: dict = {}  # output name -> [SmartLink]
        self.last_outputs: dict = {}  # output name -> AnnotatedValue

    # -- extended-cloud placement (repro.topology) ----------------------------
    def bind_topology(self, topology, ledger) -> None:
        """Attach this task to a Topology + TransferLedger (done once by the
        PipelineManager). The initial zone is the pin or the topology
        default; a data-gravity policy may re-place it every wave."""
        if self.pinned_zone is not None and not topology.has_zone(self.pinned_zone):
            raise ValueError(
                f"task {self.name!r} pinned to unknown zone {self.pinned_zone!r} "
                f"(topology {topology.name!r} has {topology.zone_names()})"
            )
        self.topology = topology
        self.ledger = ledger
        if self.zone is None:
            self.zone = self.pinned_zone or topology.default_zone

    # -- arrival handling (called by the pipeline manager) ---------------------
    def ingest(self) -> int:
        """Drain incoming links into the snapshot policy. Returns #AVs taken."""
        n = 0
        for spec in self.input_specs:
            link = self.in_links.get(spec.name)
            if link is None:
                continue
            while True:
                av = link.poll()
                if av is None:
                    break
                av.stamp(self.name, "consumed", self.version, region=self.region)
                if self.ledger is not None:
                    src_zone = av.meta.get("zone")
                    if src_zone is not None:
                        # Defer the crossed-a-zone-edge judgement: at ingest
                        # this task's zone is the *previous* assignment, and
                        # data_gravity may be about to move it to exactly
                        # the zone these AVs came from. The pending list is
                        # settled at execute time, after placement.
                        self._pending_zone_refs.append((link, src_zone))
                self.policy.arrive(spec.name, av)
                n += 1
        return n

    def ready(self) -> bool:
        return self.policy.ready()

    # -- execution ---------------------------------------------------------------
    def _note_service(self, dt: float) -> None:
        """Fold one execution's wall seconds into the service-time EWMA."""
        alpha = 0.3
        prev = self.service_ewma_s
        self.service_ewma_s = dt if prev is None else alpha * dt + (1 - alpha) * prev

    def _charge_compute(self, store: ArtifactStore, plan: "ExecutionPlan") -> None:
        """Charge the ledger's compute account for this firing: the zone
        where the task ran processed the snapshot's input bytes. Per-zone
        sums, so the account (and its derived joules) is independent of
        which backend ran the wave or in what order threads finished."""
        if self.ledger is None:
            return
        total = 0
        for _name, val in plan.snap.items():
            for av in val if isinstance(val, list) else [val]:
                if av.uri.startswith("ghost://"):
                    continue
                total += int(av.meta.get("nbytes") or store.nbytes_of(av.chash) or 0)
        self.ledger.on_execute(self.zone, total)

    def _journal_staging(self, registry: ProvenanceRegistry):
        """Batching window for this firing's journal writes: every record the
        firing produces (visits, AVs, ledger charges, memo inserts) lands in
        one fused ``append_batch`` at window exit — one lock acquisition, one
        encode buffer, one write/fsync decision per firing instead of per
        record."""
        journal = getattr(registry, "journal", None)
        if journal is None or getattr(journal, "closed", False):
            return contextlib.nullcontext()
        return journal.staging()

    def execute(
        self,
        store: ArtifactStore,
        registry: ProvenanceRegistry,
        cache: Optional[MemoCache] = None,
        *,
        emit: bool = True,
    ) -> dict:
        """Form a snapshot, consult the memo cache, run user code if needed,
        and emit output AVs onto outgoing links. Returns {output_name: AV} —
        or a :class:`FiringBatch` of such dicts when this task coalesces and
        more than one snapshot was ready.

        Payloads are fetched lazily: links carried only ``(uri, chash)``
        references, and bytes move just before user code runs — a memo hit
        (or a ghost run) therefore moves nothing at all.

        ``emit=False`` defers the ``_emit`` step to the caller: the event
        scheduler runs a wave's user code concurrently but emits serially in
        wave order, so downstream arrival seqs (merge FCFS) stay
        deterministic regardless of which worker finished first. With a
        FiringBatch the caller must emit each firing in order.
        """
        firings: list = []
        while True:
            with self._journal_staging(registry):
                status, payload = self.begin_execution(store, registry, cache)
                if status == "hit":
                    out = payload
                else:
                    result, dt = self.run_user_fn(payload, store)
                    out = self.finish_execution(
                        payload, result, dt, store, registry, cache, emit=False
                    )
            if emit:
                self._emit(out)
            firings.append(out)
            # Coalescing: drain further ready snapshots in the same dispatch
            # (opt-in; a task is in at most one wave at a time, so draining
            # here races nothing). Firing order matches what the scheduler's
            # requeue loop would have produced wave by wave.
            if len(firings) >= self.coalesce_max or not self.policy.ready():
                break
        if len(firings) == 1:
            return firings[0]
        return FiringBatch(firings)

    def begin_execution(
        self,
        store: ArtifactStore,
        registry: ProvenanceRegistry,
        cache: Optional[MemoCache] = None,
    ) -> tuple:
        """Phase 1 of a firing: settle zone refs, form the snapshot, log
        arrivals, and consult the memo cache. Returns ``("hit", out_avs)``
        when the memo layer answered (AVs minted, nothing left to run), or
        ``("run", ExecutionPlan)`` when user code must execute — locally via
        ``run_user_fn`` + ``finish_execution``, or in a worker process via
        the plan's reference view (:mod:`repro.runtime`). Neither path
        emits; that stays with the caller (the scheduler's serial step)."""
        with self._journal_staging(registry):
            return self._begin_execution(store, registry, cache)

    def _begin_execution(
        self,
        store: ArtifactStore,
        registry: ProvenanceRegistry,
        cache: Optional[MemoCache] = None,
    ) -> tuple:
        # Settle deferred zone-crossing counts now that placement has fixed
        # this firing's zone: a ref "crossed" only if its birth zone differs
        # from where consumption actually happens (hash-only ghost
        # transfer; payload bytes are charged separately at _materialize).
        if self.ledger is not None and self._pending_zone_refs:
            pending, self._pending_zone_refs = self._pending_zone_refs, []
            for link, src_zone in pending:
                if self.zone is not None and src_zone != self.zone:
                    link.crosszone_refs += 1

        snap = self.policy.snapshot()
        in_hashes, parent_uids = {}, []
        for name, val in snap.items():
            avs = val if isinstance(val, list) else [val]
            hs = []
            for av in avs:
                hs.append(av.chash)
                parent_uids.append(av.uid)
                registry.log_visit(self.name, av.uid, "arrived", self.version)
            in_hashes[name] = hs if isinstance(val, list) else hs[0]

        # The output-name promise is part of the key: two tasks sharing one
        # fn but promising different outputs are different computations (a
        # replayed record would emit the wrong names and silently drop the
        # emission). Same fn + same promise still dedups across tasks —
        # that's content identity, the point of make semantics.
        svc = ";".join(
            f"{n}:{s.version}:{len(s.frozen_responses)}" for n, s in self.services.items()
        )
        extra = f"out={','.join(self.outputs)};{svc}"
        key = snapshot_key(
            self.version, in_hashes, extra=extra, policy_mode=self.policy.mode
        )

        # Source tasks are sensors: each firing is a fresh observation of the
        # world, never a cacheable pure function of (no) inputs.
        if self.source:
            cache = None

        if cache is not None:
            rec = cache.lookup(key)
            if rec is not None and not all(
                store.resolvable(uri) for uri, _ in rec["outputs"].values()
            ):
                # Record minted against a different store (a shared MemoCache
                # outlives any one workspace): its URIs don't resolve here,
                # so treat it as a miss and recompute rather than replay
                # dangling references.
                rec = None
            if rec is not None:
                self.cache_hits += 1
                saved = (
                    sum(int(n) for n in rec.get("out_nbytes", {}).values())
                    if isinstance(rec, dict)
                    else 0
                )
                self.bytes_saved += saved
                credit = getattr(cache, "credit_hit", None)
                if credit is not None:
                    credit(rec)
                out_uids = rec.get("out_uids", {}) if isinstance(rec, dict) else {}
                hit_nbytes = rec.get("out_nbytes", {}) if isinstance(rec, dict) else {}
                hit_zone = rec.get("birth_zone") if isinstance(rec, dict) else None
                out_avs = {}
                for oname, (uri, chash) in rec["outputs"].items():
                    orig_uid = out_uids.get(oname)
                    meta = {"cache_hit": True}
                    if orig_uid:
                        meta["memo_of"] = orig_uid
                    if self.zone is not None:
                        # memo AVs carry the *birth* zone of the original
                        # producing run: a hit replays references to bytes
                        # still resident there, so downstream gravity and
                        # the ledger must weigh/bill against that zone, not
                        # wherever this replay happens to run. (Records
                        # minted on flat circuits fall back to the replay
                        # zone — there is no better information.)
                        #
                        # Zone-local tier: when a replica of the content is
                        # *already resident here* (store's per-zone index),
                        # the hit is served from it — the AV carries this
                        # zone, downstream materializations bill nothing
                        # cross-zone, and the ledger credits the bytes the
                        # birth-zone billing would have moved.
                        birth = hit_zone or self.zone
                        n_out = int(hit_nbytes.get(oname, 0))
                        if (
                            birth != self.zone
                            and self.ledger is not None
                            and store.zone_resident(chash, self.zone)
                        ):
                            meta["zone"] = self.zone
                            zone_local = getattr(cache, "note_zone_local_hit", None)
                            if zone_local is not None:
                                zone_local()
                            self.ledger.credit_zone_local(chash, n_out, self.zone)
                        else:
                            meta["zone"] = birth
                        if oname in hit_nbytes:
                            meta["nbytes"] = int(hit_nbytes[oname])
                    av = AnnotatedValue.produce(
                        chash, uri, self.name, self.version, region=self.region,
                        meta=meta,
                    )
                    av.stamp(self.name, "cached", self.version, region=self.region)
                    registry.register_av(av, parents=parent_uids)
                    registry.log_visit(
                        self.name, av.uid, "cache_hit", self.version,
                        note=f"memo_of={orig_uid}" if orig_uid else "",
                    )
                    out_avs[oname] = av
                return ("hit", out_avs)

        # Content-dedup peek (shared hubs): after a *local* miss, a cache
        # implementing ``plan_dedup`` may know another scope already computed
        # this key. Tasks with services stay ineligible — a real run grows
        # their frozen-response log (which feeds later memo keys), and a
        # replay must never diverge from what a solo run would have done.
        dedup = None
        if cache is not None and not self.services:
            peek = getattr(cache, "plan_dedup", None)
            if peek is not None:
                dedup = peek(key)

        plan = ExecutionPlan(
            snap=snap,
            in_hashes=in_hashes,
            parent_uids=parent_uids,
            key=key,
            use_cache=cache is not None,
            dedup=dedup,
        )
        return ("run", plan)

    def run_user_fn(self, plan: ExecutionPlan, store: ArtifactStore) -> tuple:
        """Phase 2 (local): materialize the plan's snapshot and run the user
        function on the calling thread. Returns ``(result, wall_seconds)``."""
        if plan.dedup is not None:
            # Dedup replay: load the outputs some other scope already
            # computed for this content key instead of re-running the user
            # function. The input-side ledger charges a real run would have
            # made at _materialize are replicated in the same snapshot
            # order, so the caller's ``finish_execution`` produces provenance
            # byte-identical to an actual execution. A None replay (the
            # shared payloads were evicted meanwhile) falls through to the
            # real run below.
            replayed = plan.dedup(store)
            if replayed is not None:
                self.account_remote_inputs(store, plan)
                return replayed, 0.0
        # materialize payloads (Principle 2: pin near the dependent) — this
        # is the only point where input bytes actually move
        kwargs = {}
        for name, val in plan.snap.items():
            if isinstance(val, list):
                kwargs[name] = self._materialize_batch(store, val)
            else:
                kwargs[name] = self._materialize(store, val)
        for sname, svc in self.services.items():
            kwargs[sname] = svc

        t0 = time.perf_counter()
        result = self.fn(**kwargs)
        dt = time.perf_counter() - t0
        return result, dt

    def finish_execution(
        self,
        plan: ExecutionPlan,
        result: Any,
        dt: float,
        store: ArtifactStore,
        registry: ProvenanceRegistry,
        cache: Optional[MemoCache] = None,
        *,
        emit: bool = True,
    ) -> dict:
        """Phase 3: count the execution, store outputs, mint + register the
        output AVs, memoize, and (optionally) emit — exactly the tail of the
        classic single-call ``execute``."""
        with self._journal_staging(registry):
            return self._finish_execution(
                plan, result, dt, store, registry, cache, emit=emit
            )

    def _finish_execution(
        self,
        plan: ExecutionPlan,
        result: Any,
        dt: float,
        store: ArtifactStore,
        registry: ProvenanceRegistry,
        cache: Optional[MemoCache] = None,
        *,
        emit: bool = True,
    ) -> dict:
        parent_uids, key = plan.parent_uids, plan.key
        if not plan.use_cache:
            cache = None
        self.executions += 1
        self._note_service(dt)
        if self.zone is not None:
            self.zone_executions[self.zone] = self.zone_executions.get(self.zone, 0) + 1
        self._charge_compute(store, plan)
        registry.log_visit(
            self.name, "-", "executed", self.version, note=f"wall={dt:.6f}s"
        )

        if not isinstance(result, dict):
            if len(self.outputs) != 1:
                raise TypeError(
                    f"task {self.name} returned a single value but declares "
                    f"outputs {self.outputs}"
                )
            result = {self.outputs[0]: result}
        missing = set(self.outputs) - set(result)
        if missing:
            raise KeyError(f"task {self.name} missing outputs {sorted(missing)}")

        out_avs, outputs_rec, out_uids, out_nbytes = {}, {}, {}, {}
        any_ghost = False
        # Batched ingest: one fused content_hash_batch over every output,
        # then one put_batch (single store-lock acquisition) for the
        # non-ghost payloads — digests and counters identical to the old
        # per-output put loop.
        payloads = [result[oname] for oname in self.outputs]
        hashes = content_hash_batch(
            payloads, on_unstable=getattr(store, "_on_unstable", None)
        )
        ghost_flags = [is_ghost(p) for p in payloads]
        stored = store.put_batch(
            [p for p, g in zip(payloads, ghost_flags) if not g],
            hashes=[h for h, g in zip(hashes, ghost_flags) if not g],
        )
        stored_iter = iter(stored)
        for oname, payload, chash, ghost in zip(
            self.outputs, payloads, hashes, ghost_flags
        ):
            if ghost:
                # Ghost outputs never touch the store: the shape spec *is*
                # the metadata, and it rides on the AV itself (§III.K).
                any_ghost = True
                meta = {"ghost": True, "ghost_spec": payload}
                if self.zone is not None:
                    meta["zone"] = self.zone
                av = AnnotatedValue.produce(
                    chash, f"ghost://{chash}", self.name, self.version,
                    region=self.region, meta=meta,
                )
            else:
                uri, chash, nbytes = next(stored_iter)
                meta = None
                if self.zone is not None:
                    # birth certificate for the transfer ledger: outputs are
                    # resident where the task ran, and their size rides the
                    # AV so data-gravity placement can weigh them later.
                    meta = {"zone": self.zone, "nbytes": nbytes}
                    if self.ledger is not None:
                        self.ledger.register_resident(chash, self.zone)
                    store.note_zone_resident(chash, self.zone)
                av = AnnotatedValue.produce(
                    chash, uri, self.name, self.version, region=self.region,
                    meta=meta,
                )
                outputs_rec[oname] = (uri, chash)
                out_uids[oname] = av.uid
                out_nbytes[oname] = nbytes
            registry.register_av(av, parents=parent_uids)
            registry.log_visit(self.name, av.uid, "emitted", self.version)
            out_avs[oname] = av
        if cache is not None and not any_ghost:
            cache.insert(
                key,
                make_record(
                    self.version, outputs_rec, out_uids, out_nbytes,
                    birth_zone=self.zone,
                ),
                ttl_s=self.cache_ttl_s,
            )
        if emit:
            self._emit(out_avs)
        return out_avs

    # -- remote completion (repro.runtime) ----------------------------------
    def account_remote_inputs(self, store: ArtifactStore, plan: ExecutionPlan) -> None:
        """Replicate ``_materialize``'s transfer-ledger charges for a firing
        whose payload fetches happened in a worker process. The worker's
        forked ledger is invisible here, so the parent charges the same
        bytes, in the same snapshot order, against its own ledger — keeping
        cross-zone byte/energy totals identical to an in-process run."""
        if self.ledger is None:
            return
        for _name, val in plan.snap.items():
            for av in val if isinstance(val, list) else [val]:
                if av.uri.startswith("ghost://"):
                    continue
                nbytes = av.meta.get("nbytes") or store.nbytes_of(av.chash) or 0
                self.ledger.on_materialize(
                    av.chash, int(nbytes), av.meta.get("zone"), self.zone
                )
                if self.zone is not None:
                    store.note_zone_resident(av.chash, self.zone)

    def finish_remote(
        self,
        plan: ExecutionPlan,
        outcome: dict,
        store: ArtifactStore,
        registry: ProvenanceRegistry,
        cache: Optional[MemoCache] = None,
        *,
        emit: bool = False,
    ) -> dict:
        """Complete a firing whose user code ran in a worker process.

        ``outcome`` is the worker's reference-only reply (see
        :mod:`repro.runtime.worker`): per-output ``(uri, chash, nbytes)``
        specs, the wall time, and any frozen service responses. All
        provenance side effects — ledger charges, execution counters, AV
        minting, visitor-log entries, memo insert — happen *here*, in the
        parent, in exactly the order ``finish_execution`` produces them; the
        worker only computed bytes and parked them in the shared object
        tier. A retried wave therefore cannot double-register anything: a
        worker that died mid-task left no parent-side state at all."""
        with self._journal_staging(registry):
            return self._finish_remote(
                plan, outcome, store, registry, cache, emit=emit
            )

    def _finish_remote(
        self,
        plan: ExecutionPlan,
        outcome: dict,
        store: ArtifactStore,
        registry: ProvenanceRegistry,
        cache: Optional[MemoCache] = None,
        *,
        emit: bool = False,
    ) -> dict:
        self.account_remote_inputs(store, plan)
        for sname, calls in (outcome.get("services") or {}).items():
            svc = self.services.get(sname)
            if svc is not None:
                svc.frozen_responses.extend(calls)
        dt = float(outcome["wall_s"])
        self.executions += 1
        self._note_service(dt)
        if self.zone is not None:
            self.zone_executions[self.zone] = self.zone_executions.get(self.zone, 0) + 1
        self._charge_compute(store, plan)
        registry.log_visit(
            self.name, "-", "executed", self.version, note=f"wall={dt:.6f}s"
        )
        out_avs, outputs_rec, out_uids, out_nbytes = {}, {}, {}, {}
        any_ghost = False
        for oname in self.outputs:
            spec = outcome["outputs"][oname]
            chash = spec["chash"]
            if spec.get("ghost"):
                any_ghost = True
                meta = {"ghost": True, "ghost_spec": spec.get("ghost_spec")}
                if self.zone is not None:
                    meta["zone"] = self.zone
                av = AnnotatedValue.produce(
                    chash, f"ghost://{chash}", self.name, self.version,
                    region=self.region, meta=meta,
                )
            else:
                nbytes = int(spec["nbytes"])
                uri = store.adopt(chash, nbytes, existed=spec.get("existed", False))
                meta = None
                if self.zone is not None:
                    meta = {"zone": self.zone, "nbytes": nbytes}
                    if self.ledger is not None:
                        self.ledger.register_resident(chash, self.zone)
                    store.note_zone_resident(chash, self.zone)
                av = AnnotatedValue.produce(
                    chash, uri, self.name, self.version, region=self.region,
                    meta=meta,
                )
                outputs_rec[oname] = (uri, chash)
                out_uids[oname] = av.uid
                out_nbytes[oname] = nbytes
            registry.register_av(av, parents=plan.parent_uids)
            registry.log_visit(self.name, av.uid, "emitted", self.version)
            out_avs[oname] = av
        if plan.use_cache and cache is not None and not any_ghost:
            cache.insert(
                plan.key,
                make_record(
                    self.version, outputs_rec, out_uids, out_nbytes,
                    birth_zone=self.zone,
                ),
                ttl_s=self.cache_ttl_s,
            )
        if emit:
            self._emit(out_avs)
        return out_avs

    def _materialize(self, store: ArtifactStore, av: AnnotatedValue) -> Any:
        """Lazy payload fetch: ghosts resolve from AV metadata (zero bytes);
        real artifacts are pinned near this consumer and read locally.

        Under a topology this is the *only* point where zone transport is
        charged: the AV reference crossed for free, and the TransferLedger
        bills the bytes (once per content hash per destination zone) when —
        and only when — a consumer in another zone needs the payload."""
        if av.uri.startswith("ghost://"):
            return av.meta.get("ghost_spec")
        if self.ledger is not None:
            src_zone = av.meta.get("zone")
            nbytes = av.meta.get("nbytes") or store.nbytes_of(av.chash) or 0
            self.ledger.on_materialize(av.chash, int(nbytes), src_zone, self.zone)
            if self.zone is not None:
                # the payload is now replicated here: future memo hits in
                # this zone serve from the local replica (zone-local tier)
                store.note_zone_resident(av.chash, self.zone)
        return store.get(store.pin_local(av.uri, region=av.region))

    def _materialize_batch(self, store: ArtifactStore, avs: list) -> list:
        """Materialize a buffered/window input slice. Ledger charges land in
        exact AV order (the determinism contract); the loop is the data
        plane's per-input seam — batched fetch strategies plug in here
        without touching ``run_user_fn``."""
        return [self._materialize(store, av) for av in avs]

    def _emit(self, out_avs: dict) -> None:
        self.last_outputs.update(out_avs)
        for oname, av in out_avs.items():
            for link in self.out_links.get(oname, []):
                link.offer(av, software_version=self.version)

    def __repr__(self) -> str:
        ins = ", ".join(str(s) for s in self.input_specs)
        return f"SmartTask({ins}) {self.name} ({', '.join(self.outputs)})"

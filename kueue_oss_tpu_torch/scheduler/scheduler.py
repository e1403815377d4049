"""The scheduling cycle, and its seam to the device drain.

A copy of ``kueue_oss_tpu/scheduler/scheduler.py`` (reference:
pkg/scheduler/scheduler.go). One cycle pops the queue heads, snapshots
the store, nominates (flavor assignment and preemption targets), orders
the entries (the classical sort or the fair-sharing DRS tournament),
then admits or preempts with at most one cohort-conflicting admission
per cycle and requeues the rest.

With ``solver="auto"`` (or a ``SolverEngine`` instance) ``run_until_quiet``
first drains the backlog on the device with ``engine.drain(verify=True)``
(every plan entry re-checked by the verify oracle before it commits)
whenever the routing gates let it: ``solver_min_backlog``, the benefit
gate over freed capacity and arrivals, and the drain and host cost
EMAs. Host cycles then mop up what the drain left, or everything when
the drain refuses the backlog (``UnsupportedProblem``) or the backend is
unavailable (``SolverUnavailable``). The ``"auto"`` engine runs on
``device`` ("cuda" unless the caller asks for "cpu"). The host cycle
places TAS podsets on the snapshot's topology trees (the flavor
assigner, the placement with preemption victims removed, the in-cycle
TAS fit re-check and assumed usage, and the second pass for delayed
topology assignments); under the TASDeviceFillCounts gate those trees
run their fill-in counts on ``device`` too, so a host-only scheduler
(``solver=None``) touches the device only with that gate on.

With ``streaming`` (True or a ``config.StreamingConfig``) and a solver
backend, a ``StreamingAdmitter`` (``scheduler/streaming.py``) rides the
engine: ``micro_drain(now)`` admits in-order arrivals to uncontended
ClusterQueues between full solves (a burst of at least
``micro_solve_min`` entries as one lean drain on ``device``), and every
``engine.drain`` re-arms its fences. ``serve(stop)`` is the threaded
loop: it blocks on the queue manager's condition, runs micro-drains and
full cycles under ``_cycle_mu``, and with ``watch_driven`` (the
default) starts the ``stream-watch-drain`` worker that the store watch
wakes on every arrival.

``solver_config`` (a ``config.SolverBackendConfig``) sets the "auto"
engine's delta sessions and its relaxed-arm knobs; its ``socket_path``
(or, when that is unset, the ``KUEUE_SOLVER_SOCKET`` environment
variable) routes the engine's solves through a sidecar
(``solver/service.py`` ``SolverClient.from_config``), with a
``SolverHealth`` breaker from its ``breaker_*`` fields; the engine's
``SolverUnavailable`` then lands in ``solver_counts["unavailable"]``.
Its ``mesh`` sets the engine's mesh mode; its coordinator fields raise
there (ROADMAP Queue A item 9b).

Cut from the copy, each with its ROADMAP Queue A item:

- (no ROADMAP item: nothing in the port would set them) the
  ``clock`` (also ``serve``'s), ``eviction_backoff_max_s`` and
  ``enable_partial_admission`` arguments and ``serve``'s ``backoff``:
  cycles, ``serve`` and ``micro_drain`` without ``now`` time themselves
  on ``time.monotonic``, ``serve`` sleeps on its own fixed ``Backoff``
  (2 ms doubling up to ``poll``), an eviction
  backoff is capped at ``core.eviction.EVICTION_BACKOFF_MAX_S`` (3600
  s) and partial admission follows its PartialAdmission gate (on);
  ``evict_workload``'s ``backoff_max_s``; and ``SolverEngine.supported()``, since the port's
  engine has no mesh or sidecar state that makes a drain unsupported and
  refuses a backlog shape only by raising ``UnsupportedProblem`` at
  export;
- events and logs (the decision recorder, the metrics, the SLO feed,
  the cycle ledger and the persistence intents and flushes are wired as
  in the JAX scheduler: ``obs/``, ``metrics/``, ``persist/``);
- workload slicing, concurrent admission and MultiKueue orchestrated
  preemption: their gates (ElasticJobsViaWorkloadSlices,
  ConcurrentAdmission, MultiKueueOrchestratedPreemption) are off by
  default and the port does not register them (``features.set_gates``
  refuses them), so the JAX scheduler at those defaults never reaches
  them either.

``solver_counts`` counts the drains that ran, what they admitted and
evicted, the plan entries they handed back to the host
(``plan_fallbacks``) and the passes that fell back
(``unsupported``, ``unavailable``).
"""

from __future__ import annotations

import functools
import heapq
import threading
import time
from dataclasses import dataclass, field
from typing import Optional

from kueue_oss_tpu_torch import features, metrics, obs
from kueue_oss_tpu_torch import tas as tas_pkg
from kueue_oss_tpu_torch.api.types import (
    Admission,
    AdmissionCheckState,
    PodSetAssignment,
    Workload,
    WorkloadConditionType,
)
from kueue_oss_tpu_torch.core import eviction
from kueue_oss_tpu_torch.core.queue_manager import QueueManager, RequeueReason
from kueue_oss_tpu_torch.core.quota import compare_drs
from kueue_oss_tpu_torch.core.snapshot import (
    ClusterQueueSnapshot,
    Snapshot,
    build_snapshot,
)
from kueue_oss_tpu_torch.core.store import Store
from kueue_oss_tpu_torch.core.workload_info import (
    WorkloadInfo,
    effective_per_pod_requests,
    effective_priority,
    queue_order_timestamp,
)
from kueue_oss_tpu_torch.scheduler import flavor_assigner as fa
from kueue_oss_tpu_torch.scheduler.flavor_assigner import (
    Assignment,
    FlavorAssigner,
    PodSetReducer,
)
from kueue_oss_tpu_torch.scheduler.preemption import Preemptor, Target
from kueue_oss_tpu_torch.util.expectations import ExpectationsStore
from kueue_oss_tpu_torch.util.primitives import Backoff

# entry status (scheduler.go entryStatus)
NOT_NOMINATED = ""
NOMINATED = "nominated"
ASSUMED = "assumed"
SKIPPED = "skipped"
EVICTED = "evicted"


@dataclass
class Entry:
    info: WorkloadInfo
    assignment: Assignment = field(default_factory=Assignment)
    status: str = NOT_NOMINATED
    inadmissible_msg: str = ""
    requeue_reason: str = RequeueReason.GENERIC
    preemption_targets: list[Target] = field(default_factory=list)
    cq_snapshot: Optional[ClusterQueueSnapshot] = None

    def assignment_usage(self):
        if self.info.obj.is_quota_reserved:
            return {}
        return dict(self.assignment.usage_quota)


@dataclass
class CycleStats:
    cycle: int = 0
    heads: int = 0
    admitted: int = 0
    preempted: int = 0
    skipped: int = 0
    inadmissible: int = 0
    duration_s: float = 0.0


class Scheduler:
    """One-process scheduler over the in-memory store."""

    def __init__(
        self,
        store: Store,
        queues: QueueManager,
        enable_fair_sharing: bool = False,
        solver=None,
        solver_min_backlog: int = 256,
        solver_reengage_fraction: float = 0.05,
        solver_config=None,
        streaming=None,
        device="cuda",
    ) -> None:
        self.store = store
        self.queues = queues
        self.enable_fair_sharing = enable_fair_sharing
        self.preemptor = Preemptor(enable_fair_sharing=enable_fair_sharing)
        self.cycle_count = 0
        #: device drain backend: None (host cycles only), "auto" (a
        #: SolverEngine over this store and queues on ``device``) or a
        #: SolverEngine instance
        self.solver = solver
        self._solver_instance = None
        #: config.SolverBackendConfig whose sessions and relaxed-arm knobs
        #: the "auto" engine takes (None = the engine's defaults)
        self.solver_config = solver_config
        self.device = device
        if solver == "auto":
            from kueue_oss_tpu_torch.device import resolve_device

            self.device = resolve_device(device)  # raises without CUDA
        #: skip the device drain below this many pending workloads:
        #: floods go to the device, trickles stay on host cycles
        #: (0 = always drain)
        self.solver_min_backlog = solver_min_backlog
        #: benefit-aware re-engagement after a flood drain: freed
        #: capacity (or arrivals) must reach max(solver_min_backlog,
        #: fraction * backlog) before the device re-walks the parked
        #: backlog (0 = re-engage on every pass)
        self.solver_reengage_fraction = solver_reengage_fraction
        self._solver_drained_once = False
        self._solver_freed_since_drain = 0
        #: queues.new_pending_total at the last drain
        self._solver_arrivals_mark = 0
        #: arrival-triggered drains back off exponentially while they
        #: admit nothing; a productive drain resets the multiplier
        self._solver_arrival_mult = 1
        self._solver_drain_trigger = None
        #: streaming micro-batched admission between full solves
        #: (scheduler/streaming.py): None/False = off (the cycle-batch
        #: model, unchanged), True = defaults, or a
        #: config.StreamingConfig. Requires a solver backend — commits
        #: ride the engine's commit path so streamed admissions are
        #: indistinguishable in the store from batched ones.
        self.streaming = streaming
        self._streaming_instance = None
        #: serializes cycle bodies and micro-drains across the serve
        #: loop and the watch-driven drain worker (reentrant: the
        #: serve loop's cycle body calls micro_drain itself)
        self._cycle_mu = threading.RLock()
        #: wall of the most recent full schedule() cycle; the serve
        #: loop refuses to skip host cycles longer than the streaming
        #: config's max_cycle_gap (requeue backoffs must expire, even
        #: while micro-drains serve)
        self._last_full_cycle_wall = 0.0
        #: routing cost EMAs: drain wall per exported workload and the
        #: host cycle's wall per admission (None until measured)
        self._drain_cost_ema: Optional[float] = None
        self._host_s_per_adm: Optional[float] = None
        #: min-heap of (requeue_at, workload key) pending backoff expiry
        self._requeue_heap: list[tuple[float, str]] = []
        #: CQs whose usage changed outside entry processing (evictions)
        self._cycle_touched_cqs: set[str] = set()
        #: per-cycle skip counts by bounded reason slug — feeds the
        #: cycle ledger row (reset at each cycle start)
        self._cycle_skip_slugs: dict[str, int] = {}
        #: cq -> (lq, ns) label sets last reported, for gauge zero-fill
        self._lq_reported: dict[str, set] = {}
        #: evictions per workload key (keys the first-eviction counter)
        self.evicted_total: dict[str, int] = {}
        #: in-flight preemption tracking (pkg/util/expectations)
        self.preemption_expectations = ExpectationsStore()
        #: the device drains and the fallbacks of this scheduler
        self.solver_counts = {"drains": 0, "admitted": 0, "evicted": 0,
                              "plan_fallbacks": 0, "unsupported": 0,
                              "unavailable": 0}
        #: the DrainResult of the last drain that ran
        self.last_drain = None

    # ------------------------------------------------------------------
    # Cycle
    # ------------------------------------------------------------------

    def schedule(self, now: Optional[float] = None) -> CycleStats:
        start = time.monotonic()
        now = now if now is not None else start
        self.cycle_count += 1
        stats = CycleStats(cycle=self.cycle_count)
        self.queues.current_time = now  # AFS decay reference point
        obs.slo_engine.advance(now)  # windows roll on idle cycles too
        self._cycle_skip_slugs = {}
        self.requeue_due(now)
        self._run_second_pass(now)

        heads = self.queues.heads()
        stats.heads = len(heads)
        if not heads:
            # still flush the gauges of CQs touched by out-of-cycle
            # evictions or finishes; empty cycles record no ledger row
            for cq_name, counts in (
                    self.queues.drain_dirty_pending_counts().items()):
                metrics.report_pending_workloads(cq_name, *counts)
            if self._cycle_touched_cqs:
                self._flush_metrics(
                    build_snapshot(self.store, device=self.device),
                    entries=[])
            self._persist_flush()
            return stats

        # per-phase walls for the cycle ledger row (the Tracer's phase
        # vocabulary, on perf_counter)
        p0 = time.perf_counter()
        snapshot = build_snapshot(self.store, device=self.device)
        t_snapshot = time.perf_counter() - p0

        p1 = time.perf_counter()
        entries, inadmissible = self._nominate(heads, snapshot, now)
        t_nominate = time.perf_counter() - p1
        stats.inadmissible = len(inadmissible)
        for e in inadmissible:
            # the nomination-stage rejection reason (inactive or missing
            # CQ, namespace mismatch) answers "why is it still pending?"
            self._cycle_skip_slugs["inadmissible"] = (
                self._cycle_skip_slugs.get("inadmissible", 0) + 1)
            obs.recorder.record(
                obs.SKIPPED, e.info.key, cycle=self.cycle_count,
                cluster_queue=e.info.cluster_queue,
                reason=e.inadmissible_msg, reason_slug="inadmissible")

        p2 = time.perf_counter()
        iterator = self._make_iterator(entries, snapshot)
        preempted_workloads: dict[str, WorkloadInfo] = {}
        while iterator.has_next():
            self._process_entry(iterator.pop(), snapshot,
                                preempted_workloads, stats, now)

        for e in entries:
            if e.status not in (ASSUMED, EVICTED):
                self._requeue_and_update(e)
        for e in inadmissible:
            self._requeue_and_update(e)
        t_entries = time.perf_counter() - p2

        stats.duration_s = time.monotonic() - start
        if stats.admitted:
            per_adm = stats.duration_s / stats.admitted
            self._host_s_per_adm = (
                per_adm if self._host_s_per_adm is None
                else 0.7 * self._host_s_per_adm + 0.3 * per_adm)
        result = (metrics.CycleResult.SUCCESS
                  if stats.admitted or stats.preempted
                  else metrics.CycleResult.INADMISSIBLE)
        metrics.observe_admission_attempt(result, stats.duration_s)
        p3 = time.perf_counter()
        self._flush_metrics(snapshot, entries)
        self._persist_flush()
        ledger = obs.cycle_ledger
        if ledger.enabled:
            ledger.record(
                self.cycle_count, obs.HOST_CYCLE,
                breaker=obs.breaker_state_name(),
                duration_s=stats.duration_s,
                phases={"snapshot": round(t_snapshot, 6),
                        "nominate": round(t_nominate, 6),
                        "entries": round(t_entries, 6),
                        "flush": round(time.perf_counter() - p3, 6)},
                heads=stats.heads, admitted=stats.admitted,
                preempted=stats.preempted, skipped=stats.skipped,
                inadmissible=stats.inadmissible,
                skip_slugs=dict(self._cycle_skip_slugs))
        return stats

    def _persist_flush(self) -> None:
        """Cycle-end durability barrier: the WAL's group commit lands
        every record this cycle produced, and the checkpoint cadence
        gets its look."""
        p = getattr(self.store, "persistence", None)
        if p is not None:
            p.flush()

    def _flush_metrics(self, snapshot: Snapshot,
                       entries: list[Entry]) -> None:
        for cq_name, counts in (
                self.queues.drain_dirty_pending_counts().items()):
            metrics.report_pending_workloads(cq_name, *counts)
        touched = {e.info.cluster_queue for e in entries}
        touched.update(self._cycle_touched_cqs)
        self._cycle_touched_cqs.clear()
        self._report_snapshot_metrics(snapshot, touched)

    def _report_snapshot_metrics(self, snapshot: Snapshot,
                                 touched: set[str]) -> None:
        """Per-CQ usage / weighted-share gauges from the post-cycle
        snapshot, limited to the CQs the cycle touched (reference: cache
        usage reporting, metrics.go:733-830)."""
        touched_cohorts: set = set()
        for name in touched:
            cq = snapshot.cluster_queues.get(name)
            if cq is None:
                continue
            metrics.report_cluster_queue_usage(
                cq.name, cq.node.usage, spec_frs=cq.spec.flavor_resources())
            metrics.reserving_active_workloads.set(
                cq.name, value=len(cq.workloads))
            if self.enable_fair_sharing:
                drs = cq.dominant_resource_share()
                metrics.cluster_queue_weighted_share.set(
                    cq.name, value=drs.rounded_weighted_share())
            # per-LocalQueue usage / active gauges (local_queue_* series)
            if metrics._lq_metrics_enabled():
                by_lq: dict[tuple[str, str], dict] = {}
                active_by_lq: dict[tuple[str, str], int] = {}
                admitted_by_lq: dict[tuple[str, str], int] = {}
                for info in cq.workloads.values():
                    lqk = (info.obj.queue_name, info.obj.namespace)
                    active_by_lq[lqk] = active_by_lq.get(lqk, 0) + 1
                    if info.obj.is_admitted:
                        admitted_by_lq[lqk] = admitted_by_lq.get(lqk, 0) + 1
                    agg = by_lq.setdefault(lqk, {})
                    for fr, q in info.usage().items():
                        agg[fr] = agg.get(fr, 0) + q
                # zero-fill LQ samples whose last workload left this CQ
                prev = self._lq_reported.get(name, set())
                stale = prev - set(active_by_lq)
                for lq, ns in stale:
                    metrics.local_queue_reserving_active_workloads.set(
                        lq, ns, value=0)
                    metrics.local_queue_admitted_active_workloads.set(
                        lq, ns, value=0)
                self._lq_reported[name] = set(active_by_lq)
                for (lq, ns), agg in by_lq.items():
                    metrics.local_queue_resource_usage.replace_prefix(
                        (lq, ns), {fr: q for fr, q in agg.items()})
                    metrics.local_queue_resource_reservation.replace_prefix(
                        (lq, ns), {fr: q for fr, q in agg.items()})
                for lq, ns in stale:
                    metrics.local_queue_resource_usage.replace_prefix(
                        (lq, ns), {})
                    metrics.local_queue_resource_reservation.replace_prefix(
                        (lq, ns), {})
                for (lq, ns), n in active_by_lq.items():
                    metrics.local_queue_reserving_active_workloads.set(
                        lq, ns, value=n)
                    metrics.local_queue_admitted_active_workloads.set(
                        lq, ns, value=admitted_by_lq.get((lq, ns), 0))
            # pending requested quantity per resource (kept by the queue)
            q = self.queues.queues.get(name)
            if q is not None:
                metrics.cluster_queue_resource_pending.replace_prefix(
                    (name,),
                    {(r,): v for r, v in q.pending_totals.items()})
            if cq.has_parent():
                touched_cohorts.update(cq.path_parent_to_root())
        # cohort subtree gauges (metrics.go cohort_subtree_*)
        for node in touched_cohorts:
            for (flavor, resource), v in node.node.subtree_quota.items():
                metrics.cohort_subtree_quota.set(
                    node.name, flavor, resource, value=v)
            for (flavor, resource), v in node.node.usage.items():
                metrics.cohort_subtree_resource_reservations.set(
                    node.name, flavor, resource, value=v)
            n_admitted = sum(
                len(c.workloads) for c in node.subtree_cluster_queues())
            metrics.cohort_subtree_admitted_active_workloads.set(
                node.name, value=n_admitted)

    def _solver_engine(self):
        if self.solver is None:
            return None
        if self.solver == "auto":
            if self._solver_instance is None:
                import os

                from kueue_oss_tpu_torch.solver.engine import SolverEngine

                # solver_config.socket_path (programmatic, wins) or the
                # KUEUE_SOLVER_SOCKET fallback routes the solves through
                # the sidecar; the engine's breaker governs its health
                cfg = self.solver_config
                remote = health = None
                sock = (cfg.socket_path
                        if cfg is not None and cfg.socket_path
                        else os.environ.get("KUEUE_SOLVER_SOCKET"))
                if sock:
                    from kueue_oss_tpu_torch.solver.service import (
                        SolverClient,
                    )

                    if cfg is not None:
                        import dataclasses

                        remote = SolverClient.from_config(
                            dataclasses.replace(cfg, socket_path=sock))
                    else:
                        remote = SolverClient(sock)
                if cfg is not None:
                    from kueue_oss_tpu_torch.solver.resilience import (
                        SolverHealth,
                    )

                    health = SolverHealth(cfg.breaker_failure_threshold,
                                          cfg.breaker_cooldown_seconds)
                eng = self._solver_instance = SolverEngine(
                    self.store, self.queues, device=self.device,
                    scheduler=self,
                    enable_fair_sharing=self.enable_fair_sharing,
                    remote=remote, health=health,
                    mesh_mode=(cfg.mesh if cfg is not None else None))
                if cfg is not None:
                    if cfg.sessions_enabled is not None:
                        eng.use_sessions = bool(cfg.sessions_enabled)
                    # the relaxed fast-path arm's knobs (solver/relax.py)
                    eng.relax_enabled = cfg.relax_enabled
                    eng.relax_min_workloads = cfg.relax_min_workloads
                    eng.relax_audit_every = cfg.relax_audit_every
                    eng.relax_iters = cfg.relax_iters
                    eng.relax_support_threshold = (
                        cfg.relax_support_threshold)
                    eng.relax_retry_cooldown_s = (
                        cfg.relax_retry_cooldown_seconds)
            self._ensure_streaming(self._solver_instance)
            return self._solver_instance
        self._ensure_streaming(self.solver)
        return self.solver

    def _streaming_on(self) -> bool:
        """Whether streaming is enabled: truthy value, AND — for a
        StreamingConfig — its ``enabled`` master switch."""
        cfg = self.streaming
        if not cfg:
            return False
        return cfg is True or getattr(cfg, "enabled", True)

    def _ensure_streaming(self, engine) -> None:
        """Wire the StreamingAdmitter onto a freshly resolved engine
        (idempotent; also the path that arms fences on the engine's
        full-solve boundaries via engine.streaming)."""
        if (not self._streaming_on() or engine is None
                or self._streaming_instance is not None):
            return
        from kueue_oss_tpu_torch.scheduler.streaming import (
            StreamingAdmitter,
        )

        cfg = self.streaming
        kwargs = {}
        if cfg is not True and cfg is not None:
            kwargs["max_batch"] = getattr(cfg, "max_batch", 512)
        self._streaming_instance = StreamingAdmitter(
            self.store, self.queues, engine, **kwargs)
        engine.streaming = self._streaming_instance

    def _streaming_admitter(self):
        """The lazily built StreamingAdmitter, or None (streaming off
        or no solver backend configured)."""
        if not self._streaming_on():
            return None
        if self._streaming_instance is None:
            self._ensure_streaming(self._solver_engine())
        return self._streaming_instance

    def _streaming_max_gap(self) -> float:
        cfg = self.streaming
        if cfg is True or cfg is None:
            return 1.0
        return getattr(cfg, "max_cycle_gap_seconds", 1.0)

    def _streaming_watch_driven(self) -> bool:
        """Whether serve() runs the watch-driven drain worker (on by
        default with streaming): arrivals signal the worker straight
        from the store watch stream, so micro-drain latency stays
        event-bound even while the serve loop sleeps on its SlowDown
        backoff or poll tick."""
        if not self._streaming_on():
            return False
        cfg = self.streaming
        if cfg is True:
            return True
        return getattr(cfg, "watch_driven", True)

    def _watch_drain_loop(self, sa, wake, stop) -> None:
        """Watch-driven drain worker: blocks on the arrival signal
        (set by the admitter's store-watch classifier), coalesces
        whatever burst accumulated while a drain ran, and drains
        under the cycle lock. Full-solve requests are deferred to the
        serve loop — the worker only ever runs micro-drains."""
        while not stop.is_set():
            if not wake.wait(timeout=0.2):
                continue
            wake.clear()
            if stop.is_set():
                return
            n = sa.take_arrival_signals()
            if n <= 0:
                continue
            if n > 1:
                # burst backpressure: n arrival signals collapsed
                # into this one drain
                sa.count("stream_demotions_total", "watch_coalesced",
                         by=n - 1)
            with self._cycle_mu:
                sa.drain(time.monotonic())
            if sa.full_solve_pending:
                # spec edit observed mid-window: the HEAVY cycle is
                # the serve loop's job — nudge its condition wait
                self.queues.wakeup()

    def micro_drain(self, now: Optional[float] = None):
        """One streaming micro-batch: admit in-order arrivals for
        every uncontended fast-path CQ sub-cycle (between full
        solves). Returns the MicroDrainResult, or None when streaming
        is off/unarmed."""
        sa = self._streaming_admitter()
        if sa is None:
            return None
        with self._cycle_mu:
            return sa.drain(now if now is not None else time.monotonic())

    def _solver_drain(self, now: Optional[float]) -> bool:
        """Drain the backlog on the device when the gates let it.

        Returns True if a drain changed something. Backlogs the drain
        refuses (podset topology groups, quantities beyond int32) fall
        through to the host cycle loop."""
        engine = self._solver_engine()
        if engine is None or not self.queues.has_pending():
            return False
        from kueue_oss_tpu_torch.solver.resilience import SolverUnavailable
        from kueue_oss_tpu_torch.solver.tensors import UnsupportedProblem

        if self.solver_min_backlog > 0:
            # heap-count heuristic; stale parked entries count, they are
            # owed a retry. Lazy flushing engages only while the device
            # drains floods; at trickle scale the host path runs with
            # exact eager flushes.
            backlog = self.queues.solver_backlog_count()
            if backlog < self.solver_min_backlog:
                if self.queues.lazy_flush:
                    self.queues.set_lazy_flush(False)  # materializes
                # flood processed: the next crossing is a fresh flood
                self._solver_drained_once = False
                return False
            if self._solver_drained_once and self.solver_reengage_fraction:
                # benefit gate: a re-drain re-walks the parked backlog,
                # so it must beat the host cycles it replaces; adaptive
                # once both cost estimates exist, else the flood-sized
                # batch rule
                arrivals = (self.queues.new_pending_total
                            - self._solver_arrivals_mark)
                batch = min(self._solver_freed_since_drain + arrivals,
                            backlog)
                freed = self._solver_freed_since_drain
                if (self._drain_cost_ema is not None
                        and self._host_s_per_adm is not None):
                    predicted = self._drain_cost_ema * backlog
                    freed_ok = freed * self._host_s_per_adm >= predicted
                    arrivals_ok = (batch * self._host_s_per_adm
                                   >= predicted
                                   * self._solver_arrival_mult)
                else:
                    need = max(self.solver_min_backlog,
                               int(self.solver_reengage_fraction
                                   * backlog))
                    freed_ok = freed >= need
                    arrivals_ok = (arrivals
                                   >= need * self._solver_arrival_mult)
                if not (freed_ok or arrivals_ok):
                    # an over-estimated drain cost must not latch the
                    # gate shut: decay it per skipped evaluation
                    if self._drain_cost_ema is not None:
                        self._drain_cost_ema *= 0.99
                    if self.queues.lazy_flush:
                        self.queues.set_lazy_flush(False)
                    return False
                self._solver_drain_trigger = (
                    "freed" if freed_ok else "arrivals")
            if not self.queues.lazy_flush:
                self.queues.set_lazy_flush(True)
        try:
            backlog_now = max(1, self.queues.solver_backlog_count())
            t0 = time.monotonic()
            result = engine.drain(now=now if now is not None else 0.0,
                                  verify=True)
            per_wl = (time.monotonic() - t0) / backlog_now
            if self._drain_cost_ema is None:
                self._drain_cost_ema = per_wl
            else:
                self._drain_cost_ema = (0.7 * self._drain_cost_ema
                                        + 0.3 * per_wl)
        except UnsupportedProblem as e:
            self.queues.materialize_stale_all()
            self._solver_drain_trigger = None
            self.solver_counts["unsupported"] += 1
            obs.recorder.record(
                obs.SOLVER_FALLBACK, obs.CYCLE_SCOPE,
                cycle=self.cycle_count + 1, path=obs.SOLVER,
                reason=str(e) or "problem shape unsupported on-device",
                reason_slug="unsupported")
            return False
        except SolverUnavailable:
            # the backend cannot plan now: the round completes on the
            # host cycle loop
            self.queues.materialize_stale_all()
            self._solver_drain_trigger = None
            self.solver_counts["unavailable"] += 1
            return False
        self.last_drain = result
        self.solver_counts["drains"] += 1
        self.solver_counts["admitted"] += result.admitted
        self.solver_counts["evicted"] += result.evicted
        self.solver_counts["plan_fallbacks"] += result.plan_fallbacks
        self._solver_drained_once = True
        self._solver_freed_since_drain = 0
        self._solver_arrivals_mark = self.queues.new_pending_total
        if self._solver_drain_trigger == "arrivals":
            if result.admitted < self.solver_min_backlog // 4:
                self._solver_arrival_mult = min(
                    64, self._solver_arrival_mult * 2)
            else:
                self._solver_arrival_mult = 1
        elif result.admitted:
            self._solver_arrival_mult = 1
        self._solver_drain_trigger = None
        for key in result.admitted_keys:
            wl = self.store.workloads.get(key)
            if wl is not None and wl.status.admission is not None:
                self._cycle_touched_cqs.add(wl.status.admission.cluster_queue)
        # progress = the plan changed something
        return bool(result.admitted or result.evicted)

    def run_until_quiet(self, max_cycles: int = 10_000,
                        now: Optional[float] = None,
                        tick: float = 0.0) -> int:
        """Run cycles until the pending state stops changing.

        With a solver backend the backlog first drains on the device;
        host cycles then mop up what the drain could not model or
        verify. ``tick`` advances the clock per cycle."""
        cycles = 0
        prev_probe = None
        while cycles < max_cycles:
            self._solver_drain(None if now is None
                               else now + cycles * tick)
            stalled = False
            while cycles < max_cycles:
                pre = self._queue_fingerprint()
                n = None if now is None else now + cycles * tick
                stats = self.schedule(now=n)
                cycles += 1
                if stats.heads == 0:
                    break
                if (stats.admitted == 0 and stats.preempted == 0
                        and self._queue_fingerprint() == pre):
                    stalled = True
                    break
            # mid-loop evictions may have lazily flushed parked entries
            # (stale): loop back so the solver (or the host, after
            # materializing them) retries them before quiescence
            if stalled or not self.queues.any_stale():
                break
            # a full pass that changed neither membership nor the
            # retryable backlog changes nothing more
            probe = (self._queue_fingerprint(),
                     self.queues.solver_backlog_count())
            if probe == prev_probe:
                break
            prev_probe = probe
        return cycles

    def _queue_fingerprint(self):
        return self.queues.membership_fingerprint()

    def serve(self, stop, poll: float = 0.05) -> int:
        """Event-driven scheduler loop for threaded deployments: block on
        the queue manager's condition until pending work arrives, run a
        cycle, repeat until `stop` is set (the reference scheduler
        blocks in manager.Heads() the same way, and wraps the cycle in
        untilWithBackoff). A cycle that makes NO progress — heads that
        immediately requeue (StrictFIFO blocked head, pending
        preemption) keep the queues non-empty — signals SlowDown: the
        loop sleeps on an exponential backoff instead of spinning, and
        any queue event resets it. Returns cycles run."""
        backoff = Backoff(initial=0.002, cap=max(poll, 0.002), factor=2.0)
        # Watch-driven micro-drains: arrivals signal a dedicated
        # drain worker straight from the store watch stream, so the
        # sub-cycle path stays event-bound even while this loop
        # sleeps (poll timeout, SlowDown backoff). The worker and
        # this loop serialize through _cycle_mu.
        sa_watch = (self._streaming_admitter()
                    if self._streaming_watch_driven() else None)
        watch_wake = None
        watch_thread = None
        if sa_watch is not None:
            watch_wake = threading.Event()
            sa_watch.set_arrival_notifier(watch_wake.set)
            watch_thread = threading.Thread(
                target=self._watch_drain_loop,
                args=(sa_watch, watch_wake, stop),
                name="stream-watch-drain", daemon=True)
            watch_thread.start()
        try:
            return self._serve_loop(stop, poll, backoff)
        finally:
            if sa_watch is not None:
                sa_watch.set_arrival_notifier(None)
                watch_wake.set()
                watch_thread.join(timeout=1.0)

    def _serve_loop(self, stop, poll, backoff) -> int:
        # requeue sweeps batch like the reference requeuer
        # (inadmissible_workloads.go:37-47): 1s normally, 10s under
        # SchedulerLongRequeueInterval (re-read per tick so live gate
        # flips take effect like every other gate)
        clock = time.monotonic
        last_sweep = -1e18
        cycles = 0
        idle_rounds = 0
        while not stop.is_set():
            if not self.queues.wait_for_pending(timeout=poll):
                # timeout: re-check stop, serve due requeues/second pass
                # on the batch cadence
                now_c = clock()
                requeue_period = (10.0 if features.enabled(
                    "SchedulerLongRequeueInterval") else 1.0)
                if now_c - last_sweep >= requeue_period:
                    last_sweep = now_c
                    self.requeue_due(now_c)
                # a spec edit (quota/flavor change) landing while the
                # queues are idle must not sit fenced until the next
                # arrival: drain() observes the spec-gen bump even
                # with nothing pending, and the requested full solve
                # runs NOW so capacity changes propagate immediately
                sa = self._streaming_admitter()
                if sa is not None:
                    with self._cycle_mu:
                        sa.drain(now_c)
                        if sa.consume_full_solve_request():
                            sa.count("stream_spec_solves_total")
                            stats = self.schedule(now=clock())
                            self._last_full_cycle_wall = clock()
                            cycles += 1
                            if stats.admitted or stats.preempted:
                                idle_rounds = 0
                continue
            # Streaming fast path (scheduler/streaming.py): between
            # full solves, in-order arrivals to uncontended CQs admit
            # sub-cycle; when the micro-batch resolved everything
            # pending, the heavy cycle is skipped — p50 time-to-admit
            # decouples from the full-solve cadence. Host cycles still
            # run at least every max_cycle_gap (requeue backoffs) and
            # whenever fenced work waits.
            skip_heavy = False
            with self._cycle_mu:
                micro_admitted = 0
                sa = self._streaming_admitter()
                if sa is not None:
                    now_c = clock()
                    micro = sa.drain(now_c)
                    micro_admitted = micro.admitted
                    if sa.consume_full_solve_request():
                        # spec edit observed mid-window: fall through
                        # to the full cycle right now — never skip it
                        sa.count("stream_spec_solves_total")
                    elif ((micro.admitted or micro.parked)
                            and not self.queues.has_pending()
                            and (now_c - self._last_full_cycle_wall
                                 < self._streaming_max_gap())):
                        skip_heavy = True
                if not skip_heavy:
                    # Flood-to-solver routing (run_until_quiet
                    # parity): a backlog past solver_min_backlog
                    # drains through the device in one batched
                    # invocation; the host cycle below mops up the
                    # trickle and anything the solver could not model
                    # or verify.
                    drained = (self._solver_drain(clock())
                               if self.solver else False)
                    pre = self._queue_fingerprint()
                    stats = self.schedule(now=clock())
                    self._last_full_cycle_wall = clock()
                    cycles += 1
            if skip_heavy:
                idle_rounds = 0
                continue
            if (drained or micro_admitted or stats.admitted
                    or stats.preempted
                    or self._queue_fingerprint() != pre):
                idle_rounds = 0  # KeepGoing
            else:
                idle_rounds += 1  # SlowDown
                stop.wait(backoff.wait_time(idle_rounds))
        return cycles

    # ------------------------------------------------------------------
    # Nomination
    # ------------------------------------------------------------------

    def _nominate(self, heads: list[WorkloadInfo], snapshot: Snapshot,
                  now: float) -> tuple[list[Entry], list[Entry]]:
        entries: list[Entry] = []
        inadmissible: list[Entry] = []
        for info in heads:
            e = Entry(info=info)
            e.cq_snapshot = snapshot.cluster_queue(info.cluster_queue)
            if info.cluster_queue in snapshot.inactive_cluster_queues:
                e.inadmissible_msg = (
                    f"ClusterQueue {info.cluster_queue} is inactive")
            elif e.cq_snapshot is None:
                e.inadmissible_msg = (
                    f"ClusterQueue {info.cluster_queue} not found")
            elif not self._namespace_matches(e.cq_snapshot, info.obj):
                e.inadmissible_msg = (
                    "Workload namespace doesn't match ClusterQueue selector")
                e.requeue_reason = RequeueReason.NAMESPACE_MISMATCH
            else:
                assignment, targets = self._assign(info, snapshot, now)
                e.assignment = assignment
                e.preemption_targets = targets
                e.inadmissible_msg = assignment.message()
                info.last_assignment = assignment.last_state
                entries.append(e)
                continue
            inadmissible.append(e)
        return entries, inadmissible

    def _namespace_matches(self, cq: ClusterQueueSnapshot,
                           wl: Workload) -> bool:
        selector = cq.spec.namespace_selector
        if selector is None:
            return True
        labels = self.store.namespaces.get(wl.namespace, {})
        return all(labels.get(k) == v for k, v in selector.items())

    def _assign(self, info: WorkloadInfo, snapshot: Snapshot,
                now: float) -> tuple[Assignment, list[Target]]:
        """scheduler.go getInitialAssignments: full fit, else preempt,
        else partial admission."""
        cq = snapshot.cluster_queue(info.cluster_queue)
        assert cq is not None
        assigner = FlavorAssigner(
            info, cq, snapshot.resource_flavors, oracle=self.preemptor,
            enable_fair_sharing=self.enable_fair_sharing)
        full = assigner.assign()
        mode = full.representative_mode()
        if mode == fa.FIT:
            return full, []
        if mode == fa.PREEMPT:
            targets = self.preemptor.get_targets(info, full, snapshot, now)
            if targets:
                self._update_assignment_for_tas(
                    info, cq, snapshot, full, targets)
                return full, targets

        if (features.enabled("PartialAdmission")
                and info.can_be_partially_admitted()):
            def probe(counts):
                assignment = assigner.assign(counts)
                m = assignment.representative_mode()
                if m == fa.FIT:
                    return (assignment, []), True
                if m == fa.PREEMPT:
                    t = self.preemptor.get_targets(info, assignment,
                                                   snapshot, now)
                    if t:
                        return (assignment, t), True
                return None, False

            result, found = PodSetReducer(info.obj.podsets, probe).search()
            if found:
                if result[1]:
                    self._update_assignment_for_tas(
                        info, cq, snapshot, result[0], result[1])
                return result
        return full, []

    def _update_assignment_for_tas(self, info: WorkloadInfo,
                                   cq: ClusterQueueSnapshot,
                                   snapshot: Snapshot,
                                   assignment: Assignment,
                                   targets: list[Target]) -> None:
        """Recompute topology assignments assuming the preemption victims
        are gone (scheduler.go updateAssignmentForTAS, :759-783)."""
        if assignment.representative_mode() != fa.PREEMPT:
            return
        if not any(fa.is_tas_requested(ps, cq) for ps in info.obj.podsets):
            return
        if info.obj.status.unhealthy_nodes:
            return
        tas_requests = fa.workload_topology_requests(info, cq, assignment)
        if not tas_requests:
            return
        revert = snapshot.simulate_workload_removal(
            [t.info for t in targets])
        try:
            result = cq.find_topology_assignments_for_workload(tas_requests)
        finally:
            revert()
        fa.update_for_tas_result(assignment, result)

    # ------------------------------------------------------------------
    # Iterators
    # ------------------------------------------------------------------

    def _make_iterator(self, entries: list[Entry], snapshot: Snapshot):
        if self.enable_fair_sharing:
            return _FairSharingIterator(entries)
        return _ClassicalIterator(entries)

    # ------------------------------------------------------------------
    # Entry processing
    # ------------------------------------------------------------------

    def _record_skip(self, e: Entry, slug: str,
                     detail: Optional[dict] = None) -> None:
        """Flight-recorder emission for a skipped entry: the bounded slug
        feeds the per-reason counters, the free-form inadmissible_msg
        survives verbatim."""
        self._cycle_skip_slugs[slug] = (
            self._cycle_skip_slugs.get(slug, 0) + 1)
        obs.recorder.record(
            obs.SKIPPED, e.info.key, cycle=self.cycle_count,
            cluster_queue=e.info.cluster_queue,
            reason=e.inadmissible_msg, reason_slug=slug, detail=detail)

    def _process_entry(self, e: Entry, snapshot: Snapshot,
                       preempted_workloads: dict[str, WorkloadInfo],
                       stats: CycleStats, now: float) -> None:
        cq = e.cq_snapshot
        assert cq is not None

        mode = e.assignment.representative_mode()
        if mode == fa.NO_FIT:
            stats.skipped += 1
            # the flavor assigner's no-fit reason is kept, not discarded
            self._record_skip(e, "no_fit", detail=e.assignment.skip_detail())
            return

        if mode == fa.PREEMPT and not e.preemption_targets:
            # preemption needed but no targets: reserve the capacity the
            # entry is entitled to so lower entries can't squat on it
            # (scheduler.go reserveCapacityForUnreclaimablePreempt)
            cq.add_usage(self._quota_to_reserve(e, cq))
            stats.skipped += 1
            self._record_skip(e, "no_candidates")
            return

        # one cohort-conflicting admission per cycle
        if any(t.info.key in preempted_workloads
               for t in e.preemption_targets):
            e.status = SKIPPED
            e.inadmissible_msg = ("Workload has overlapping preemption "
                                  "targets with another workload")
            stats.skipped += 1
            self._record_skip(e, "cohort_conflict")
            return

        # in-flight preemption guard (preemption.go:207-221)
        if mode == fa.PREEMPT and e.preemption_targets:
            pending = self.preemption_expectations.pending_uids()
            if not self.preemption_expectations.satisfied(e.info.key) or any(
                    t.info.obj.uid in pending for t in e.preemption_targets):
                e.status = SKIPPED
                e.requeue_reason = RequeueReason.PENDING_PREEMPTION
                e.inadmissible_msg = ("Workload is waiting for previously "
                                      "issued preemptions")
                stats.skipped += 1
                self._record_skip(e, "pending_preemption")
                return

        usage = e.assignment_usage()
        if not self._fits(snapshot, cq, usage, preempted_workloads,
                          e.preemption_targets, e):
            e.status = SKIPPED
            e.inadmissible_msg = ("Workload no longer fits after "
                                  "processing another workload")
            stats.skipped += 1
            self._record_skip(e, "lost_race")
            return
        for t in e.preemption_targets:
            preempted_workloads[t.info.key] = t.info
        cq.add_usage(usage)

        if mode == fa.PREEMPT:
            self._issue_preemptions(e, now)
            stats.preempted += len(e.preemption_targets)
            return

        # Delayed topology assignment: on a CQ gated by admission checks
        # the topology is computed in a second pass after the checks turn
        # Ready (provisioned capacity may change the tree), so the TAS
        # usage must not be assumed now (KEP-2724 delayed assignment).
        if not self._delays_topology(e):
            self._assume_tas_usage(e, snapshot)
        e.status = NOMINATED
        self._admit(e, now)
        stats.admitted += 1

    @staticmethod
    def _delays_topology(e: Entry) -> bool:
        cq = e.cq_snapshot
        return (cq is not None and bool(cq.spec.admission_checks)
                and any(psa.topology_assignment is not None
                        for psa in e.assignment.podsets))

    @staticmethod
    def _assume_tas_usage(e: Entry, snapshot: Snapshot) -> None:
        """Charge the entry's topology assignment to the TAS snapshots so
        later entries in this cycle see the domain usage (mirrors the
        reference's assume path covering TAS usage in the cache)."""
        podsets = {ps.name: ps for ps in e.info.obj.podsets}
        for psa in e.assignment.podsets:
            ta = psa.topology_assignment
            if ta is None:
                continue
            flavor = next(
                (rec.name for rec in psa.flavors.values()
                 if rec.name in snapshot.tas_flavors), None)
            if flavor is None:
                continue
            ps = podsets.get(psa.name)
            per_pod = (effective_per_pod_requests(ps, e.info.obj.namespace)
                       if ps is not None else {})
            for dom in ta.domains:
                snapshot.tas_flavors[flavor].add_tas_usage(
                    dom.values, per_pod, dom.count)

    @staticmethod
    def _fits(snapshot: Snapshot, cq: ClusterQueueSnapshot, usage,
              preempted_workloads: dict[str, WorkloadInfo],
              targets: list[Target], e: Entry) -> bool:
        infos = list(preempted_workloads.values()) + [t.info
                                                      for t in targets]
        revert = snapshot.simulate_workload_removal(infos)
        try:
            return cq.fits(usage) and Scheduler._tas_fits(e, snapshot)
        finally:
            revert()

    @staticmethod
    def _tas_fits(e: Entry, snapshot: Snapshot) -> bool:
        """Re-validate the entry's topology assignment against current
        domain usage: earlier admissions in this cycle charged the TAS
        snapshots (_assume_tas_usage), which can invalidate a placement
        computed during nomination."""
        if e.info.obj.is_quota_reserved:
            return True
        podsets = {ps.name: ps for ps in e.info.obj.podsets}
        # Accumulate the whole entry's demand per (flavor, leaf) first: a
        # multi-podset workload (leader+workers) or several domains landing
        # on the same leaf must be checked jointly, not one domain at a time.
        demand: dict[tuple[str, tuple[str, ...]], dict[str, int]] = {}
        for psa in e.assignment.podsets:
            ta = psa.topology_assignment
            if ta is None:
                continue
            flavor = next(
                (rec.name for rec in psa.flavors.values()
                 if rec.name in snapshot.tas_flavors), None)
            if flavor is None:
                continue
            ps = podsets.get(psa.name)
            per_pod = (effective_per_pod_requests(ps, e.info.obj.namespace)
                       if ps is not None else {})
            for dom in ta.domains:
                bucket = demand.setdefault((flavor, tuple(dom.values)), {})
                for r, q in per_pod.items():
                    bucket[r] = bucket.get(r, 0) + q * dom.count
                bucket["pods"] = bucket.get("pods", 0) + dom.count
        for (flavor, values), need in demand.items():
            remaining = snapshot.tas_flavors[flavor].remaining_capacity(values)
            if remaining is None:
                return False
            if any(q > remaining.get(r, 0) for r, q in need.items()):
                return False
        return True

    def _quota_to_reserve(self, e: Entry, cq: ClusterQueueSnapshot):
        """scheduler.go quotaResourcesToReserve for Preempt-mode
        entries."""
        reserved = {}
        borrowing = e.assignment.borrows() > 0
        for fr, usage in e.assignment.usage_quota.items():
            quota = cq.quota_for(fr)
            if borrowing:
                if quota.borrowing_limit is None:
                    reserved[fr] = usage
                else:
                    reserved[fr] = min(
                        usage,
                        quota.nominal + quota.borrowing_limit
                        - cq.node.usage.get(fr, 0))
            else:
                reserved[fr] = max(
                    0, min(usage, quota.nominal - cq.node.usage.get(fr, 0)))
        return reserved

    # ------------------------------------------------------------------
    # Admission / preemption / eviction
    # ------------------------------------------------------------------

    def _admit(self, e: Entry, now: float) -> None:
        """Reserve quota and write the Admission into the store
        (scheduler.go admit / assumeWorkload)."""
        wl = self.store.workloads.get(e.info.key)
        if wl is None:
            e.status = SKIPPED
            e.inadmissible_msg = "Workload vanished from the store"
            self._record_skip(e, "vanished")
            return
        p = getattr(self.store, "persistence", None)
        if p is not None:
            # the decision's intent before the store mutation, fenced by
            # the pre-write resource version: recovery matches it to the
            # event at rv+1, or redoes the admission
            p.intent("admit", wl.key, rv=wl.resource_version,
                     cycle=self.cycle_count,
                     cluster_queue=e.info.cluster_queue)
        delay_tas = self._delays_topology(e)
        admission = Admission(
            cluster_queue=e.info.cluster_queue,
            podset_assignments=[
                PodSetAssignment(
                    name=psa.name,
                    flavors={r: rec.name for r, rec in psa.flavors.items()},
                    resource_usage=dict(psa.requests),
                    count=psa.count,
                    topology_assignment=(
                        None if delay_tas else psa.topology_assignment),
                    delayed_topology_request=(
                        "Pending" if delay_tas
                        and psa.topology_assignment is not None else None),
                )
                for psa in e.assignment.podsets
            ],
        )
        wl.status.admission = admission
        wl.set_condition(WorkloadConditionType.QUOTA_RESERVED, True,
                         reason="QuotaReserved", now=now)
        if wl.is_evicted:
            # a quota reservation supersedes a previous eviction
            wl.set_condition(WorkloadConditionType.EVICTED, False,
                             reason="QuotaReserved", now=now)
        # re-admission clears the backoff gate but keeps the count
        if wl.status.requeue_state is not None:
            wl.status.requeue_state.requeue_at = None
        cq_spec = self.store.cluster_queues[e.info.cluster_queue]
        effective_checks = cq_spec.checks_for_flavors(
            admission.assigned_flavors())
        if effective_checks:
            for name in effective_checks:
                wl.status.admission_checks.setdefault(
                    name, AdmissionCheckState(name=name))
        else:
            wl.set_condition(WorkloadConditionType.ADMITTED, True,
                             reason="Admitted", now=now)
            metrics.admitted_workload(e.info.cluster_queue,
                                      now - wl.creation_time,
                                      lq=wl.queue_name,
                                      namespace=wl.namespace,
                                      exemplar={
                                          "cycle": self.cycle_count,
                                          "workload": wl.key})
        self.store.update_workload(wl)
        e.status = ASSUMED
        wait_s = max(now - wl.creation_time, 0.0)
        metrics.quota_reserved_workload(e.info.cluster_queue, wait_s,
                                        lq=wl.queue_name,
                                        namespace=wl.namespace,
                                        exemplar={
                                            "cycle": self.cycle_count,
                                            "workload": wl.key})
        # queue-wait SLI: one time-to-admit observation per admission;
        # the same wait rides the journal detail
        pclass = obs.priority_class_of(self.store, wl)
        obs.slo_engine.observe_admission(
            e.info.cluster_queue, wait_s, priority=wl.priority,
            priority_class=pclass, now=now,
            cycle=self.cycle_count, workload=wl.key)
        obs.recorder.record(
            obs.ASSIGNED, wl.key, cycle=self.cycle_count,
            cluster_queue=e.info.cluster_queue,
            reason=f"Quota reserved in ClusterQueue {e.info.cluster_queue}",
            detail={
                "flavors": {psa.name: dict(psa.flavors)
                            for psa in admission.podset_assignments},
                "borrows": e.assignment.borrows(),
                "admitted": wl.is_admitted,
                "waitSeconds": round(wait_s, 3),
                "priority": wl.priority,
                "priorityClass": pclass,
            })
        # cohort subtree admission counters (metrics.go cohort_subtree_*)
        if e.cq_snapshot is not None and e.cq_snapshot.has_parent():
            for node in e.cq_snapshot.path_parent_to_root():
                metrics.cohort_subtree_admitted_workloads_total.inc(
                    node.name)
        if (self.queues.afs is not None
                and cq_spec.admission_scope is not None
                and cq_spec.admission_scope.admission_mode
                == "UsageBasedAdmissionFairSharing"):
            # entry penalty: charge the admitted usage to the LocalQueue
            # at once (afs/entry_penalties.go)
            by_resource: dict[str, int] = {}
            for (_, r), q in e.assignment.usage_quota.items():
                by_resource[r] = by_resource.get(r, 0) + q
            self.queues.afs.record_admission(
                f"{wl.namespace}/{wl.queue_name}", by_resource, now)

    def _issue_preemptions(self, e: Entry, now: float) -> None:
        # expectations first; each synchronous eviction is observed at
        # once (expectations/store.go)
        self.preemption_expectations.expect_uids(
            e.info.key, [t.info.obj.uid for t in e.preemption_targets])
        for target in e.preemption_targets:
            self.evict_workload(
                target.info.key, reason="Preempted",
                message=f"Preempted to accommodate {e.info.key} due to "
                        f"{target.reason}",
                now=now, preemption_reason=target.reason)
        e.inadmissible_msg += (f". Pending the preemption of "
                               f"{len(e.preemption_targets)} workload(s)")
        e.requeue_reason = RequeueReason.PENDING_PREEMPTION
        e.info.last_assignment = None
        obs.recorder.record(
            obs.NOMINATED, e.info.key, cycle=self.cycle_count,
            cluster_queue=e.info.cluster_queue,
            reason=e.inadmissible_msg, reason_slug="preempting",
            detail={"targets": [t.info.key for t in e.preemption_targets]})

    def evict_workload(self, key: str, reason: str, message: str,
                       now: float, preemption_reason: str = "",
                       backoff_base_s: Optional[float] = None,
                       requeue: bool = True,
                       underlying_cause: str = "",
                       decision_path: str = obs.HOST,
                       decision_cycle: Optional[int] = None) -> None:
        """Evict and finalize through ``core.eviction.evict_workload``
        (one state machine for the host cycle, the drain's plan and the
        controllers), plus the scheduler's own books: the freed-capacity
        count of the routing gate, the backoff heap and the preemption
        expectations. ``requeue=False`` skips the backoff requeue (the
        admission-check rejection and other deactivations);
        ``underlying_cause`` keys the eviction counter beside the
        reason. The eviction is journaled under ``decision_path`` and
        ``decision_cycle`` (the drain's, for a plan's victims)."""
        out = eviction.evict_workload(
            self.store, self.queues, key, reason=reason, message=message,
            now=now, preemption_reason=preemption_reason,
            underlying_cause=underlying_cause,
            backoff_base_s=backoff_base_s, requeue=requeue,
            path=decision_path,
            cycle=(decision_cycle if decision_cycle is not None
                   else self.cycle_count),
            evicted_total=self.evicted_total)
        if out is None:
            return
        wl, was_reserved, cq = out
        if cq:
            self._cycle_touched_cqs.add(cq)
        if was_reserved:
            self._solver_freed_since_drain += 1
        rs = wl.status.requeue_state
        if (requeue and backoff_base_s is not None and rs is not None
                and rs.requeue_at is not None):
            heapq.heappush(self._requeue_heap, (rs.requeue_at, key))
        self.preemption_expectations.observe(wl.uid)

    def requeue_due(self, now: float) -> bool:
        """Re-queue evicted workloads whose backoff expired (a min-heap
        of (requeue_at, key); stale entries are skipped)."""
        added = False
        while self._requeue_heap and self._requeue_heap[0][0] <= now:
            due_at, key = heapq.heappop(self._requeue_heap)
            wl = self.store.workloads.get(key)
            if wl is None:
                continue
            rs = wl.status.requeue_state
            if rs is None or rs.requeue_at != due_at:
                continue  # cleared or rescheduled since
            if not wl.active or wl.is_quota_reserved or wl.is_finished:
                continue
            rs.requeue_at = None
            added |= self.queues.add_or_update_workload(wl)
        return added

    def next_requeue_at(self) -> Optional[float]:
        while self._requeue_heap:
            due_at, key = self._requeue_heap[0]
            wl = self.store.workloads.get(key)
            rs = wl.status.requeue_state if wl is not None else None
            if (wl is None or rs is None or rs.requeue_at != due_at
                    or wl.is_finished or not wl.active):
                heapq.heappop(self._requeue_heap)
                continue
            return due_at
        return None

    def _run_second_pass(self, now: float) -> None:
        """Compute delayed topology assignments for quota-reserved
        workloads whose admission checks turned Ready (scheduler second
        pass, second_pass_queue.go + scheduler.go delayed TAS)."""
        keys = self.queues.take_second_pass_ready(now)
        if not keys:
            return
        snapshot = build_snapshot(self.store, device=self.device)
        for key in keys:
            wl = self.store.workloads.get(key)
            if (wl is None or not wl.is_quota_reserved or wl.is_evicted
                    or wl.is_finished or wl.status.admission is None):
                self.queues.clear_second_pass(key)
                continue
            cq = snapshot.cluster_queue(wl.status.admission.cluster_queue)
            if cq is None:
                self.queues.queue_second_pass(key, now)
                continue
            tas_requests = tas_pkg.requests_from_admission(
                wl, cq, only_pending=True)
            if not tas_requests:
                self.queues.clear_second_pass(key)
                continue
            result = cq.find_topology_assignments_for_workload(tas_requests)
            if any(res.failure for res in result.values()):
                # Capacity not there yet: retry with backoff (1s -> 30s).
                self.queues.queue_second_pass(key, now)
                continue
            podsets = {ps.name: ps for ps in wl.podsets}
            for psa in wl.status.admission.podset_assignments:
                res = result.get(psa.name)
                if res is not None and res.assignment is not None:
                    psa.topology_assignment = res.assignment
                    psa.delayed_topology_request = "Ready"
                    # Charge the new placement so later workloads in this
                    # batch see the domain usage.
                    flavor = next((f for f in psa.flavors.values()
                                   if f in snapshot.tas_flavors), None)
                    ps = podsets.get(psa.name)
                    if flavor is not None and ps is not None:
                        for dom in res.assignment.domains:
                            snapshot.tas_flavors[flavor].add_tas_usage(
                                dom.values,
                                effective_per_pod_requests(ps, wl.namespace),
                                dom.count)
            self.queues.clear_second_pass(key)
            self.store.update_workload(wl)

    def finish_workload(self, key: str, now: float = 0.0) -> None:
        """Mark Finished and release quota (the jobframework Finished
        path, ``core.eviction.finish_workload``)."""
        wl = self.store.workloads.get(key)
        if wl is None:
            return
        if wl.is_quota_reserved:
            self._solver_freed_since_drain += 1
        cq = eviction.finish_workload(self.store, self.queues, key, now)
        if cq:
            self._cycle_touched_cqs.add(cq)

    def _requeue_and_update(self, e: Entry) -> None:
        if (e.status != NOT_NOMINATED
                and e.requeue_reason == RequeueReason.GENERIC):
            e.requeue_reason = RequeueReason.FAILED_AFTER_NOMINATION
        self.queues.requeue_workload(e.info, e.requeue_reason)


# ---------------------------------------------------------------------------
# Entry iterators
# ---------------------------------------------------------------------------


class _ClassicalIterator:
    """scheduler.go makeClassicalIterator: quota-reserved first, fewer
    borrows first, higher priority, FIFO."""

    def __init__(self, entries: list[Entry]) -> None:
        priority_step = features.enabled("PrioritySortingWithinCohort")

        def cmp(a: Entry, b: Entry) -> int:
            aq = a.info.obj.is_quota_reserved
            bq = b.info.obj.is_quota_reserved
            if aq != bq:
                return -1 if aq else 1
            ab, bb = a.assignment.borrows(), b.assignment.borrows()
            if ab != bb:
                return -1 if ab < bb else 1
            if priority_step:
                pa = effective_priority(a.info.obj)
                pb = effective_priority(b.info.obj)
                if pa != pb:
                    return -1 if pa > pb else 1
            ta = queue_order_timestamp(a.info.obj)
            tb = queue_order_timestamp(b.info.obj)
            if ta != tb:
                return -1 if ta < tb else 1
            return 0

        self.entries = sorted(entries, key=functools.cmp_to_key(cmp))
        self._idx = 0

    def has_next(self) -> bool:
        return self._idx < len(self.entries)

    def pop(self) -> Entry:
        e = self.entries[self._idx]
        self._idx += 1
        return e


class _FairSharingIterator:
    """fair_sharing_iterator.go: per-cohort tournament picking, at every
    level, the child whose nominated workload yields the lowest DRS."""

    def __init__(self, entries: list[Entry]) -> None:
        self.cq_to_entry: dict[ClusterQueueSnapshot, Entry] = {}
        for e in entries:
            assert e.cq_snapshot is not None
            self.cq_to_entry[e.cq_snapshot] = e

    def has_next(self) -> bool:
        return bool(self.cq_to_entry)

    def pop(self) -> Entry:
        cq = next(iter(self.cq_to_entry))
        if not cq.has_parent():
            return self.cq_to_entry.pop(cq)
        root = cq.parent().root()
        drs_values, requested_frs = self._compute_drs(root)
        winner = self._run_tournament(root, drs_values, requested_frs)
        assert winner is not None
        del self.cq_to_entry[winner.cq_snapshot]
        return winner

    def _compute_drs(self, root):
        drs_values: dict[tuple[str, str], object] = {}
        requested_frs: dict[str, dict] = {}
        for cq in root.subtree_cluster_queues():
            entry = self.cq_to_entry.get(cq)
            if entry is None:
                continue
            usage = entry.assignment_usage()
            requested_frs[entry.info.key] = usage
            revert = cq.simulate_usage_addition(usage)
            try:
                share = cq.dominant_resource_share()
                for ancestor in cq.path_parent_to_root():
                    drs_values[(ancestor.name, entry.info.key)] = share
                    share = ancestor.dominant_resource_share()
            finally:
                revert()
        return drs_values, requested_frs

    def _run_tournament(self, cohort, drs_values,
                        requested_frs) -> Optional[Entry]:
        candidates: list[Entry] = []
        for child in cohort.child_cohorts():
            c = self._run_tournament(child, drs_values, requested_frs)
            if c is not None:
                candidates.append(c)
        for child_cq in cohort.child_cqs():
            if child_cq in self.cq_to_entry:
                candidates.append(self.cq_to_entry[child_cq])
        if not candidates:
            return None

        non_borrowing_first = features.enabled(
            "FairSharingPrioritizeNonBorrowing")
        priority_step = features.enabled("PrioritySortingWithinCohort")

        def less(a: Entry, b: Entry) -> bool:
            a_drs = drs_values.get((cohort.name, a.info.key))
            b_drs = drs_values.get((cohort.name, b.info.key))
            if a_drs is not None and b_drs is not None:
                if non_borrowing_first:
                    # 1: a subtree not borrowing on the workload's
                    # requested flavors at this level wins
                    # (fair_sharing_iterator.go:180-193)
                    ab = a_drs.is_borrowing_on(
                        requested_frs.get(a.info.key, {}))
                    bb = b_drs.is_borrowing_on(
                        requested_frs.get(b.info.key, {}))
                    if ab != bb:
                        return not ab
                # 2: DRF
                c = compare_drs(a_drs, b_drs)
                if c != 0:
                    return c < 0
            # 3: effective priority (gated like the reference)
            if priority_step:
                pa = effective_priority(a.info.obj)
                pb = effective_priority(b.info.obj)
                if pa != pb:
                    return pa > pb
            # 4: FIFO
            return (queue_order_timestamp(a.info.obj)
                    < queue_order_timestamp(b.info.obj))

        best = candidates[0]
        for cur in candidates[1:]:
            if less(cur, best):
                best = cur
        return best

"""Solver engine: export -> device drain -> apply the plan to the store.

Port of ``kueue_oss_tpu/solver/engine.py`` (``SolverEngine.drain``,
engine.py:448). One drain computes the admission plan of the whole
pending backlog on the device and commits it:

- the lean drain (no ClusterQueue admitting this drain has preemption
  or more than one resource group): ``pending_backlog`` ->
  ``export_problem`` -> ``pad_workloads`` -> ``_session_encode`` ->
  ``_local_tensors`` -> ``solve_backlog`` -> ``_apply_plan``;
- the FULL drain (preemption, several resource groups, fair sharing
  with ``enable_fair_sharing``, or admission fair sharing with an
  ``AfsManager`` on the queues): ``export_problem(include_admitted=True,
  parked=..., afs=..., now=...)`` -> ``_size_caps`` -> the same pad,
  encode and upload -> ``solve_backlog_full(fs_enabled=...)`` ->
  ``_apply_full_plan``, which applies the evictions first
  (``core/eviction.py``), then the admissions in (round, entry) order
  with a flavor per resource group, then the parking.

The export goes through the engine's cross-drain ``ExportCache`` and
its columnar view. With delta sessions on (the default;
``use_sessions = False`` turns them off) each kind's
``HostDeltaSession`` re-lays the padded export into stable slots and
ranks, and a ``DeviceResidentProblem`` keeps the tensors on the device,
writing only a delta's dirty rows; the plan decodes the slotted
``wl_keys``, in which a free slot holds ``""``. Without sessions every
drain uploads the whole padded problem.

Admitted topology-aware (TAS) workloads are placed by the sequential
device placer (``_compute_tas_assignments``). With ``verify=True`` (the
scheduler always drains so) the verify oracle (``native.BatchOracle``,
C++ built with g++, or its Python walk) then re-checks the candidates
in commit order against a fresh snapshot's quota forest, as the
scheduler's fits re-check would: an entry it rejects is not committed
and stays queued for the host cycle, counted in
``DrainResult.plan_fallbacks`` with the failed TAS placements.
``_commit_admission`` writes the admission, its conditions and the
queue transitions, and charges an AFS admission to its LocalQueue. The
FULL plan's evictions go through the scheduler's ``evict_workload``
when the engine has a scheduler, else through ``core/eviction.py``: one
state machine either way. With a streaming admitter attached
(``engine.streaming``, wired by ``Scheduler(streaming=...)``) every
drain is a full-solve boundary: ``note_solve_begin`` before it, and
``note_full_solve`` (or ``note_solve_abort`` when the drain raised)
after it; ``flavor_witness`` serves the admitter's flavor-pick witness
per ``ExportCache.spec_gen``. Stale parked entries (the queue manager's
lazy flushes) export as pending, in rank order. Podset topology groups
and quantities beyond int32 raise ``UnsupportedProblem``.

The lean drain's solve goes through ``_local_solve``: the relaxed arm
(``solver/relax.py``: the projected-gradient LP, on the card in one
launch of ``csrc/relax_lp.cu``, then rounding and an exact repair
through the lean drain) when the cost-EMA router picks it (``relax_force``,
or a live backlog of ``relax_min_workloads`` or more once an exact
baseline exists and while the arm's measured wall per workload is the
lower), else the exact single-device solve. Every ``relax_audit_every``-th
relaxed drain also runs the exact solve and emits its plan; a divergence
or an arm fault demotes the arm for ``relax_retry_cooldown_s`` (a timed
half-open cooldown kept on the engine), counted in ``relax_counts``
under the JAX metric names. ``KUEUE_SOLVER_SESSIONS=0`` starts the
engine with sessions off.

With ``remote=`` (a ``solver/service.py`` ``SolverClient``) the solve
runs in a sidecar process; export, encode, TAS placement (on the
engine's own ``device``), verify and commit stay here. The circuit
breaker ``health`` (a ``SolverHealth``) gates every drain before the
socket is touched: an open breaker raises ``SolverUnavailable`` at
once. The remote round trip runs on one worker thread while this
thread builds the apply's prework (the lean path's snapshot for the
verify and the TAS placement, and the workload refs); every imported
plan passes the plan guard (``_check_plan`` / ``_plan_fault``) before
the store changes, and a transport fault, a malformed result or a
rejected plan counts against the breaker and raises
``SolverUnavailable``, counted in ``remote_counts`` under the JAX
metric names. A half-open probe drain that records no outcome (an
empty backlog, a fault before the socket) frees the probe slot, where
the JAX engine keeps it and stays on host cycles for good. Under a remote the session layer is off when the client's
``use_sessions`` is, frames carry the full crc ``state_checksum`` (the
sidecar re-checks it), and the pad target and session interleave follow
the sidecar's advertised mesh width (``meshutil.align_pad_target``).

Every drain is observed as in the JAX engine: a ``solver_drain`` span on
the attached tracer (the scheduler's, via ``attach_to_scheduler``) with
the sidecar's spans imported beside it under the drain's cycle id, the
decision events (``SOLVER_ADMITTED``, ``solver_parked`` skips, the
fallbacks and their slugs), the admission and solver series, the SLO
feed, and one ``SOLVER_DRAIN`` ledger row with the engine's phases
(export, export_walk, export_scatter, encode, device_put, solve, apply),
the session frame and the resident state's per-drain byte deltas. With
device telemetry on (``obs.devtel.collector``) its compile verdict per
(kernel, arm, shape bucket) replaces the router's warm set, and each
drain folds its transfer bytes and the CUDA allocator's watermark into
the telemetry.

The degradation ladder (``resilience/``) owns the arms' broken flags:
``_relax_broken`` (and its cooldown stamp ``_relax_broken_at``) reads
and reports the ``relax_broken`` condition, and its re-probe is the
controller's single half-open probe. A local solve that raises, on the
lean or the FULL drain, drops that kind's resident state, counts
``solver_fallback_total{device_error}``, reports ``device_error`` (the
solver ladder's host rung), records a ``SOLVER_FALLBACK`` event and
raises ``SolverUnavailable``, so the scheduler finishes the round on
host cycles; the next local solve that lands clears the condition. With
a ``PersistenceManager`` attached to the store, every plan admission
writes its ``admit`` intent before the store mutation, the
``mid_drain`` crash point sits after each committed admission, and a
drain ends in the WAL's group commit (``persistence.flush()``).
``reset_sessions`` drops the sessions and resident states after a
recovery, so the next drain opens with a full SYNC.

The mesh arm (``solver/meshutil.py``, ``solver/sharded.py``): with a
mesh detected from ``mesh_mode`` (``SolverBackendConfig.mesh`` /
``KUEUE_SOLVER_MESH``; "auto" finds one over more than one local
device, or over ``meshutil.set_virtual_devices``), the pad target is
aligned to its width, the session interleaves slots over its shards,
and ``_pick_mesh_arm`` routes a lean or FULL drain onto it by the
per-workload wall of each arm (one probe each; ``mesh_force`` pins it,
``mesh_min_workloads`` floors it). The mesh drains keep their own
resident state (``"lean-mesh"`` / ``"full-mesh"``, block-sharded). A
mesh fault counts ``solver_fallback_total{mesh_error}``, reports
``mesh_broken`` and re-runs the same drain on the single-device arm;
``refresh_mesh`` re-detects (the ladder's heal after
``mesh_retry_cooldown_s``, or a chaos shrink).
"""

from __future__ import annotations

import contextlib
import os
import time
from dataclasses import dataclass, field
from typing import Optional

import numpy as np

from kueue_oss_tpu_torch import metrics, obs, resilience
from kueue_oss_tpu_torch.api.types import (
    Admission,
    AdmissionCheckState,
    PodSetAssignment,
    TopologyAssignment,
    WorkloadConditionType,
)
from kueue_oss_tpu_torch.core.eviction import evict_workload
from kueue_oss_tpu_torch.core.queue_manager import QueueManager, _order_key
from kueue_oss_tpu_torch.core.snapshot import build_snapshot
from kueue_oss_tpu_torch.core.store import Store
from kueue_oss_tpu_torch.core.workload_info import WorkloadInfo
from kueue_oss_tpu_torch.device import resolve_device
from kueue_oss_tpu_torch.native import BatchOracle
from kueue_oss_tpu_torch.obs import devtel
from kueue_oss_tpu_torch.persist import hooks as persist_hooks
from kueue_oss_tpu_torch.scheduler.preemption import (
    _VARIANT_REASON,
    IN_CLUSTER_QUEUE,
    IN_COHORT_FAIR_SHARING,
)
from kueue_oss_tpu_torch.solver.delta import (
    DeviceResidentProblem,
    HostDeltaSession,
    SessionFrame,
)
from kueue_oss_tpu_torch.solver.fair_kernels import V_FAIR_SHARING
from kueue_oss_tpu_torch.solver.full_kernels import (
    FullDrainStats,
    solve_backlog_full,
    to_device_full,
)
from kueue_oss_tpu_torch.solver.kernels import solve_backlog, to_device
from kueue_oss_tpu_torch.solver import meshutil
from kueue_oss_tpu_torch.solver.meshutil import align_pad_target
from kueue_oss_tpu_torch.solver.resilience import (
    HALF_OPEN,
    SolverHealth,
    SolverUnavailable,
)
from kueue_oss_tpu_torch.solver.tas_engine import (
    DeviceTASPlacer,
    device_tas_supported,
)
from kueue_oss_tpu_torch.solver.tensors import (
    ExportCache,
    SolverProblem,
    export_problem,
    flavor_option_ceilings,
    pad_workloads,
    pow2,
)

#: Preempted-condition reason of each candidate variant of the drain
#: (preemption.go): the classical variants and the fair strategy rules
_REASON_OF = {**_VARIANT_REASON, V_FAIR_SHARING: IN_COHORT_FAIR_SHARING}
#: DeviceResidentProblem counters a drain reports (per-drain deltas)
_DEVICE_COUNTERS = ("full_uploads", "delta_updates", "full_upload_bytes",
                    "donated_update_bytes", "donated_full_syncs",
                    "apply_faults")
#: resident-state byte counters the ledger row and devtel read as
#: per-drain deltas (the JAX engine's _device_totals)
_DEVICE_TOTALS = ("donated_update_bytes", "avoided_copy_bytes",
                  "full_upload_bytes", "donated_full_syncs")
#: the engine's drain phases a SOLVER_DRAIN ledger row carries
_LEDGER_PHASES = ("export", "export_walk", "export_scatter", "encode",
                  "device_put")
#: FULL drain lanes per round: up to the ClusterQueue count and this cap
H_MAX_CAP = 1024
#: the FULL drain's per-round search budget in lane x option x group
#: units, by device type: the JAX engine's accelerator and CPU budgets
SEARCH_BUDGET = {"cuda": 8192, "cpu": 512}


@dataclass
class DrainResult:
    admitted: int = 0
    #: workloads that held quota before the drain and lost it (the FULL
    #: drain's victims that were not re-admitted)
    evicted: int = 0
    rounds: int = 0
    #: workload keys admitted, in (round, workload row) order
    admitted_keys: list[str] = field(default_factory=list)
    #: the evicted workloads' keys, in workload row order
    evicted_keys: list[str] = field(default_factory=list)
    #: wall seconds by phase: export (with its columnar split
    #: export_walk / export_scatter), encode (the delta session),
    #: device_put (the upload or the resident update), solve (the drain
    #: and the plan read-back; the relaxed arm's whole solve when it
    #: served), relax_lp and relax_repair (when the relaxed arm ran),
    #: placement, apply (includes placement)
    phases: dict[str, float] = field(default_factory=dict)
    #: the FULL drain's lanes, loop iterations and host reads (None on
    #: the lean path)
    full_stats: Optional[FullDrainStats] = None
    #: the columnar export's mode, dirty rows and rows (empty when the
    #: cache has no columnar view)
    export_stats: dict = field(default_factory=dict)
    #: the delta session's frame (None with sessions off)
    frame: Optional[SessionFrame] = None
    #: this drain's device upload counters: full_uploads,
    #: full_upload_bytes, and with sessions delta_updates,
    #: donated_update_bytes, donated_full_syncs, apply_faults
    device: dict = field(default_factory=dict)
    #: plan entries the verify oracle re-checked (verify=True)
    verified: int = 0
    #: plan entries not committed and left queued for the host cycle:
    #: oracle rejections and failed TAS placements (the JAX engine's
    #: solver_plan_fallbacks_total)
    plan_fallbacks: int = 0
    #: wall seconds of the solve window (after the encode, through the
    #: plan read-back and guard) and of the apply, as the JAX engine
    #: times them for its histogram and ledger row
    solver_time_s: float = 0.0
    apply_time_s: float = 0.0


class SolverEngine:
    """Drains pending backlogs through the device kernels."""

    def __init__(self, store: Store, queues: QueueManager,
                 device="cuda", enable_fair_sharing: bool = False,
                 scheduler=None, remote=None,
                 health: Optional[SolverHealth] = None,
                 mesh_mode: Optional[str] = None) -> None:
        self.store = store
        self.queues = queues
        #: the control plane's device: the local drains and, with a
        #: remote, the TAS placement
        self.device = resolve_device(device)
        #: optional solver/service.SolverClient: the solve runs in a
        #: sidecar process; export, verify and commit stay here
        self.remote = remote
        #: circuit breaker over the remote backend
        self.health = health if health is not None else SolverHealth()
        #: the JAX package's remote-path metrics, by label
        self.remote_counts = {
            "solver_fallback_total": dict.fromkeys(
                ("breaker_open", "backend_error", "plan_rejected"), 0),
            "solver_plan_rejected_total": 0}
        #: pipelined dispatch: one worker for the remote round trip, and
        #: the apply prework this thread builds meanwhile
        self._solve_pool = None
        self._prework: Optional[dict] = None
        #: drains started, and the cycle id the current drain serves (the
        #: scheduler's next cycle), shipped as the request's trace_cycle
        self.drain_count = 0
        self._drain_cycle = 0
        #: host scheduler whose evict_workload applies the FULL plan's
        #: evictions (its freed-capacity and expectation books); None
        #: evicts through core/eviction.py directly
        self.scheduler = scheduler
        #: per-workload eviction tally when there is no scheduler (the
        #: JAX engine's stand-in evictor keeps it)
        self._evicted_total: dict[str, int] = {}
        #: attached tracer; None falls back to the scheduler's, so host
        #: cycles and drains land in one ring
        self.tracer = None
        #: fair sharing (KEP-1714): the DRS entry order and the fair
        #: preemption strategies, on the device (solver/fair_kernels.py)
        self.enable_fair_sharing = enable_fair_sharing
        #: pad the workload axis to at least this size (callers that
        #: drain a growing backlog set the expected peak, so the padded
        #: axis and the session's slot capacity never change)
        self.pad_to = 0
        #: sticky pad high-water mark: the padded workload axis never
        #: shrinks across drains (the JAX engine's recompile guard; the
        #: axis length also sets the drain's round bound)
        self._pad_hwm = 0
        #: cross-drain export memo (event-invalidated) with its columnar
        #: view
        self.export_cache = ExportCache(store)
        #: (spec_gen, ceilings) memo backing flavor_witness()
        self._flavor_witness_cache: Optional[tuple[int, dict]] = None
        #: the StreamingAdmitter whose fences re-arm at every drain
        #: (scheduler/streaming.py); None without streaming
        self.streaming = None
        #: delta sessions, one per drain kind, and the resident device
        #: state of each kind (KUEUE_SOLVER_SESSIONS=0 starts them off)
        self.use_sessions = os.environ.get("KUEUE_SOLVER_SESSIONS") != "0"
        self._delta_sessions: dict[str, HostDeltaSession] = {}
        self._device_states: dict[str, DeviceResidentProblem] = {}
        self._tas_placer: Optional[DeviceTASPlacer] = None
        #: TAS CQs on the device path for the current drain
        self._drain_tas_ready: set[str] = set()
        #: adaptive arm routing: measured solve wall per exported
        #: workload by (kernel kind, arm); the first, compile-tainted
        #: sample of each arm is discarded (the warm set)
        self._arm_ema: dict[tuple[str, str], float] = {}
        self._arm_warm: set[tuple[str, str]] = set()
        #: mesh drains: the mode string ("auto" when None and
        #: KUEUE_SOLVER_MESH is unset, "off", or a device count); the
        #: mesh itself resolves lazily
        self.mesh_mode = mesh_mode
        self._mesh_obj = None
        self._mesh_resolved = False
        #: chaos / device-loss cap on the mesh width (refresh_mesh)
        self._mesh_max_devices = 0
        #: a tripped mesh re-probes after this cooldown (one probe)
        self.mesh_retry_cooldown_s = 300.0
        #: backlogs below this stay on the single device
        self.mesh_min_workloads = 1024
        #: pin drains to the mesh arm regardless of cost estimates
        self.mesh_force = False
        #: called with the arm name ("relax" / "mesh" / "single") right
        #: before each local solve; raising simulates a device fault on
        #: that arm
        self.solve_fault_hook = None
        #: arm that served the most recent local solve
        self.last_drain_arm: Optional[str] = None
        #: the relaxed arm's knobs (SolverBackendConfig's relax_* fields)
        self.relax_enabled = True
        #: backlogs below this stay on the exact arm
        self.relax_min_workloads = 4096
        #: every Nth relax-served drain ALSO runs the exact solve and
        #: compares plans; divergence demotes the arm (0 = never audit)
        self.relax_audit_every = 8
        self.relax_iters = 32
        self.relax_support_threshold = 0.5
        #: demoted-arm cooldown before one re-probe (timed half-open)
        self.relax_retry_cooldown_s = 300.0
        #: pin lean drains to the relax arm (bench/tests only)
        self.relax_force = False
        # the broken flags are ladder conditions (the properties below):
        # a new engine reports both healthy, as the JAX engine does
        self._mesh_broken = False
        self._relax_broken = False
        self._relax_drains = 0
        #: sticky pow2 pad target of the repair's support axis
        self._relax_pad_hwm = 0
        #: stats of the most recent relaxed solve
        self.last_relax_stats = None
        #: result of the most recent audit (None = not audited)
        self.last_relax_audit: Optional[bool] = None
        #: the JAX package's relaxed-arm metrics, by label
        self.relax_counts = {
            "solver_relax_drains_total": dict.fromkeys(
                ("served", "audit_match", "audit_diverged", "error"), 0),
            "solver_fallback_total": dict.fromkeys(
                ("relax_error", "relax_disagreement"), 0)}

    def _tracer(self):
        if self.tracer is not None:
            return self.tracer
        return getattr(self.scheduler, "tracer", None)

    def needs_full_kernel(self, pending: dict[str, list[WorkloadInfo]]
                          ) -> bool:
        """Fair sharing, and preemption, multi-resource-group or
        admission-fair-sharing shapes among the CQs admitting this
        drain, need the FULL drain."""
        if self.enable_fair_sharing:
            return True
        for name in pending:
            cq = self.store.cluster_queues.get(name)
            if cq is None:
                continue
            if cq.preemption.any_enabled or len(cq.resource_groups) > 1:
                return True
            if cq.admission_scope is not None and self.queues.afs is not None:
                return True
        return False

    def _is_tas_cq(self, cq_name: str) -> bool:
        """Any flavor with a Topology makes admissions TAS-placed."""
        spec = self.store.cluster_queues.get(cq_name)
        if spec is None:
            return False
        for rg in spec.resource_groups:
            for fq in rg.flavors:
                fl = self.store.resource_flavors.get(fq.name)
                if fl is not None and fl.topology_name is not None:
                    return True
        return False

    def flavor_witness(self) -> dict[str, dict]:
        """Per-CQ static flavor-option capacity ceilings for the
        streaming flavor-pick witness, cached by ``ExportCache.spec_gen``
        (any quota/flavor/cohort edit invalidates it together with the
        export tensors it mirrors). The streaming admitter combines
        these with the post-solve window snapshot to decide whether a
        multi-flavor pick could be flipped by a capacity event
        (tensors.flavor_option_ceilings, scheduler/streaming.py)."""
        gen = self.export_cache.spec_gen
        cached = self._flavor_witness_cache
        if cached is not None and cached[0] == gen:
            return cached[1]
        witness = flavor_option_ceilings(self.store)
        self._flavor_witness_cache = (gen, witness)
        return witness

    def _tas_device_ready(self, name: str, q) -> bool:
        """Whether this TAS CQ's ENTIRE backlog (heap + parked) is
        device-placeable (all-or-nothing keeps StrictFIFO head order)."""
        spec = self.store.cluster_queues.get(name)
        if spec is None:
            return False
        return all(device_tas_supported(info, self.store, spec)
                   for info in list(q._in_heap.values())
                   + list(q.inadmissible.values()))

    def pending_backlog(self) -> dict[str, list[WorkloadInfo]]:
        """Heap contents per active CQ in rank (pop) order, merged with
        the stale parked entries owed a retry (a lazy flush, in the same
        ``_order_key`` order a physical flush gives). TAS CQs join when
        their whole backlog is device-placeable, else their stale
        entries go back to the heap for the host path; elsewhere
        topology-requesting workloads stay for the host path, and a
        stale one takes its queue's stale entries back to the heap."""
        out: dict[str, list[WorkloadInfo]] = {}
        self._drain_tas_ready = set()
        for name, q in self.queues.queues.items():
            if not q.active:
                continue
            if self._is_tas_cq(name):
                if not self._tas_device_ready(name, q):
                    q.materialize_stale()
                    continue
                self._drain_tas_ready.add(name)
                stale = q.stale_infos()
                infos = q.snapshot_order()
                if stale:
                    infos = sorted(infos + stale, key=_order_key)
                if infos:
                    out[name] = infos
                continue
            stale = q.stale_infos()
            if stale and any(ps.topology_request is not None
                             for i in stale for ps in i.obj.podsets):
                q.materialize_stale()
                stale = []
            infos = q.snapshot_order()
            if stale:
                infos = sorted(infos + stale, key=_order_key)
            infos = [i for i in infos
                     if all(ps.topology_request is None
                            for ps in i.obj.podsets)]
            if infos:
                out[name] = infos
        return out

    def export(
            self,
            pending: Optional[dict[str, list[WorkloadInfo]]] = None,
    ) -> tuple[SolverProblem, dict[str, list[WorkloadInfo]]]:
        """The lean export of ``pending`` (default: the backlog) through
        the engine's export cache, unpadded."""
        if pending is None:
            pending = self.pending_backlog()
        problem = export_problem(self.store, pending,
                                 cache=self.export_cache)
        return problem, pending

    def drain(self, now: float = 0.0, verify: bool = False) -> DrainResult:
        """Solve the whole backlog on the device and commit the plan;
        with ``verify`` the oracle re-checks every entry first. Under a
        remote whose breaker is open it raises ``SolverUnavailable``
        without touching the socket."""
        self.drain_count += 1
        self._drain_cycle = (self.scheduler.cycle_count + 1
                             if self.scheduler is not None
                             else self.drain_count)
        if self.remote is not None and not self.health.allow():
            self.remote_counts["solver_fallback_total"]["breaker_open"] += 1
            metrics.solver_fallback_total.inc("breaker_open")
            obs.recorder.record(
                obs.SOLVER_FALLBACK, obs.CYCLE_SCOPE,
                cycle=self._drain_cycle, path=obs.SOLVER,
                reason="solver backend breaker is open (cooling down); "
                       "admissions degrade to the host cycle",
                reason_slug="breaker_open")
            raise SolverUnavailable(
                "solver backend breaker is open (cooling down)")
        tracer = self._tracer()
        with (tracer.span("solver_drain", cycle=self._drain_cycle)
              if tracer is not None else contextlib.nullcontext()):
            # this drain holds the half-open probe slot
            probe = (self.remote is not None
                     and self.health.state == HALF_OPEN)
            completed = False
            if self.streaming is not None:
                # mark which fences this solve's export can cover:
                # events landing mid-solve keep their subtree fenced
                # past note_full_solve (the solve never saw them)
                self.streaming.note_solve_begin()
            try:
                result = self._drain(now, verify)
                completed = True
                return result
            finally:
                # prework of a drain that failed before its apply must
                # never leak into the next drain (stale workload refs)
                self._prework = None
                # durability barrier: the drain's plan applications are
                # group-committed before the scheduler builds on them
                persistence = getattr(self.store, "persistence", None)
                if persistence is not None:
                    persistence.flush()
                if probe and self.health.state == HALF_OPEN:
                    # the probe recorded no outcome: free its slot
                    self.health.abandon_probe()
                if self.streaming is not None:
                    # full-solve boundary: the streaming fences reset
                    # against the post-solve store (a failed drain
                    # keeps them down — host fallback cycles are not a
                    # parity baseline — but must stop attributing
                    # events to the dead solve)
                    if completed:
                        self.streaming.note_full_solve()
                    else:
                        self.streaming.note_solve_abort()

    def _drain(self, now: float, verify: bool) -> DrainResult:
        pending = self.pending_backlog()
        if self.needs_full_kernel(pending):
            return self._drain_full(now, pending, verify)
        result = DrainResult()
        te = time.monotonic()
        problem = export_problem(self.store, pending,
                                 cache=self.export_cache)
        self._note_export_phase(result, time.monotonic() - te)
        if problem.n_workloads == 0:
            return result
        # the columnar hint rides the unpadded export (its row positions
        # survive padding)
        hint = getattr(problem, "_columnar_hint", None)
        n_live = problem.n_workloads
        self._pad_hwm = max(self._pad_hwm,
                            pow2(max(problem.n_workloads, self.pad_to)))
        problem = pad_workloads(problem, self._pad_target())
        problem, frame = self._session_encode("lean", problem, hint, result)
        dev0 = self._device_totals()
        ts = time.monotonic()
        if self.remote is not None:
            t0 = time.monotonic()
            admitted, opt, admit_round, parked, rounds, _usage = (
                np.asarray(a) for a in self._dispatch_remote(
                    problem, 6, frame, "lean", verify, full=False))
            # guard imported plans only: the in-process drain is trusted
            self._check_plan(problem, admitted, opt, admit_round, parked,
                             rounds=rounds, full=False)
            result.phases["solve"] = time.monotonic() - t0
            self.last_drain_arm = "remote"
        else:
            admitted, opt, admit_round, parked, rounds, _usage = (
                self._local_solve(problem, frame, result, n_live))
        result.rounds = int(rounds)
        result.solver_time_s = time.monotonic() - ts
        metrics.solver_cycle_duration_seconds.observe(
            "solve", value=result.solver_time_s)

        t1 = time.monotonic()
        self._apply_plan(problem, admitted, opt, admit_round, parked, now,
                         result, verify)
        result.phases["apply"] = time.monotonic() - t1
        result.apply_time_s = result.phases["apply"]
        metrics.solver_cycle_duration_seconds.observe(
            "apply", value=result.apply_time_s)
        self._ledger_record(
            result, frame, "lean", dev0,
            parked_n=int(np.asarray(
                parked[:problem.n_workloads]).astype(bool).sum()))
        return result

    # -- cycle ledger (obs/ledger.py) --------------------------------------

    def _device_totals(self) -> dict:
        """Cumulative resident-state byte counters over every resident
        device state; the ledger records per-drain deltas of these."""
        totals = dict.fromkeys(_DEVICE_TOTALS, 0)
        for dev in self._device_states.values():
            for k in totals:
                totals[k] += int(getattr(dev, k, 0))
        return totals

    def _resident_bytes(self) -> int:
        """Problem bytes held on the device now, over every resident
        state — devtel's portable watermark."""
        return sum(int(dev.resident_bytes())
                   for dev in self._device_states.values())

    def _ledger_record(self, result: DrainResult,
                       frame: Optional[SessionFrame], kind: str,
                       dev0: dict, parked_n: int) -> None:
        """One solver ledger row per drain, keyed by the cycle id the
        recorder's events carry: routing, the session frame's kind and
        bytes, the resident state's per-drain byte deltas, and with
        devtel on the drain's transfer, watermark and compile events."""
        ledger = obs.cycle_ledger
        dev1 = self._device_totals()
        device = {k: dev1[k] - dev0.get(k, 0)
                  for k in dev1 if dev1[k] - dev0.get(k, 0)}
        arm = ("remote" if self.remote is not None
               else (self.last_drain_arm or "single"))
        tenant = getattr(self.remote, "tenant", "")
        dtl = devtel.collector
        if dtl.enabled:
            # the transfer family and the watermark flow even with the
            # ledger off
            dtl.note_transfers(arm, tenant, device)
            device.update(dtl.sample_residency(self._resident_bytes(),
                                               self.device))
            events = dtl.compiles.drain_events()
            if events:
                device["compiles"] = len(events)
                device["compile_events"] = events
            dtl.on_drain()
        if not ledger.enabled:
            return
        frame_kind, frame_bytes, frame_reason, session = "legacy", 0, "", {}
        if frame is not None:
            session = dict(frame.stats or {})
            if frame.delta is not None:
                frame_kind = "delta"
                frame_bytes = int(frame.delta.payload_bytes())
            else:
                frame_kind = "sync"
                frame_reason = frame.full_reason or ""
                sess_obj = self._delta_sessions.get(kind)
                if sess_obj is not None:
                    frame_bytes = sess_obj.last_sync_wire_bytes()
        phases = {"solve": round(result.solver_time_s, 6),
                  "apply": round(result.apply_time_s, 6)}
        for k in _LEDGER_PHASES:
            if k in result.phases:
                phases[k] = round(result.phases[k], 6)
        session.update(result.export_stats)
        if tenant:
            session["tenant"] = tenant
        # the farm's grant wait for this drain's solve, echoed back by
        # the sidecar (0 = dedicated / host / farm idle)
        grant_wait_ms = float(getattr(self.remote, "last_grant_wait_ms",
                                      0.0) or 0.0)
        ledger.record(
            self._drain_cycle, obs.SOLVER_DRAIN,
            breaker=obs.breaker_state_name(),
            duration_s=result.solver_time_s + result.apply_time_s,
            phases=phases,
            admitted=result.admitted, evicted=result.evicted,
            parked=parked_n, rounds=result.rounds, solver_arm=arm,
            frame_kind=frame_kind, frame_bytes=frame_bytes,
            frame_reason=frame_reason, session=session,
            grant_wait_ms=grant_wait_ms, device=device)

    # -- the degradation ladder's solver conditions ----------------------

    @property
    def _mesh_broken(self) -> bool:
        return resilience.controller.active(resilience.SOLVER,
                                            "mesh_broken")

    @_mesh_broken.setter
    def _mesh_broken(self, v: bool) -> None:
        resilience.controller.report(
            resilience.SOLVER, "mesh_broken", bool(v),
            cycle=self._drain_cycle,
            reason=("mesh arm tripped" if v
                    else "mesh re-probed; arm restored"))

    @property
    def _relax_broken(self) -> bool:
        return resilience.controller.active(resilience.SOLVER,
                                            "relax_broken")

    @_relax_broken.setter
    def _relax_broken(self, v: bool) -> None:
        resilience.controller.report(
            resilience.SOLVER, "relax_broken", bool(v),
            cycle=self._drain_cycle,
            reason=("relaxed arm demoted" if v
                    else "relaxed arm re-probed; arm restored"))

    @property
    def _relax_broken_at(self) -> float:
        return (resilience.controller.cooldowns.stamp(
            (resilience.SOLVER, "relax_broken")) or 0.0)

    @_relax_broken_at.setter
    def _relax_broken_at(self, t: float) -> None:
        resilience.controller.cooldowns.set_stamp(
            (resilience.SOLVER, "relax_broken"), float(t))

    def _mesh(self):
        """The resolved mesh, or None (one device, off, or tripped by a
        mesh fault). A tripped mesh heals after ``mesh_retry_cooldown_s``
        through the ladder's single half-open probe."""
        if self._mesh_broken:
            if not resilience.controller.begin_probe(
                    resilience.SOLVER, "mesh_broken",
                    self.mesh_retry_cooldown_s):
                return None
            self.refresh_mesh(self._mesh_max_devices)
        if not self._mesh_resolved:
            try:
                self._mesh_obj = meshutil.detect_mesh(
                    self.mesh_mode, self._mesh_max_devices, self.device)
            except Exception:
                self._mesh_obj = None  # backend init failure != crash
            self._mesh_resolved = True
        return self._mesh_obj

    def refresh_mesh(self, max_devices: int = 0) -> int:
        """Re-detect the mesh (the ladder's heal, or a chaos mesh shrink
        capping the width at ``max_devices``): clears ``mesh_broken``,
        drops the mesh-resident states and the mesh arm's cost estimate,
        so the new topology is measured afresh. Returns the new width."""
        self._mesh_max_devices = max_devices
        self._mesh_broken = False
        self._mesh_resolved = False
        for kind in ("lean", "full"):
            self._device_states.pop(kind + "-mesh", None)
            self._arm_ema.pop((kind, "mesh"), None)
            self._arm_warm.discard((kind, "mesh"))
            devtel.collector.forget(kind, "mesh")
        return meshutil.mesh_devices(self._mesh())

    def _pick_mesh_arm(self, kind: str, n_workloads: int):
        """The mesh to drain on, or None for the single device: cost-EMA
        routing with one probe per arm."""
        mesh = self._mesh()
        if mesh is None:
            return None
        if self.mesh_force:
            return mesh
        if n_workloads < self.mesh_min_workloads:
            return None
        e_mesh = self._arm_ema.get((kind, "mesh"))
        e_single = self._arm_ema.get((kind, "single"))
        if e_mesh is None:
            return mesh          # probe the mesh arm first
        if e_single is None:
            return None          # then the single-device arm
        if e_mesh <= e_single:
            # decay the skipped arm so a stale estimate erodes and the
            # loser eventually re-probes
            self._arm_ema[(kind, "single")] = e_single * 0.98
            return mesh
        self._arm_ema[(kind, "mesh")] = e_mesh * 0.98
        return None

    def _note_mesh_failure(self, e: BaseException, kind: str) -> None:
        """A mesh drain fault (device loss, injected): count it, drop the
        mesh-resident state, and degrade to the single device until
        refresh_mesh() or the retry cooldown re-probes. Never silent:
        metered and journaled."""
        reason = (f"mesh drain failed ({e!r}); degrading to the "
                  "single-chip solver arm")
        resilience.controller.report(
            resilience.SOLVER, "mesh_broken", True,
            cycle=self._drain_cycle, reason=reason)
        self._arm_warm.discard((kind, "mesh"))
        devtel.collector.forget(kind, "mesh")
        self._device_states.pop(kind + "-mesh", None)
        metrics.solver_fallback_total.inc("mesh_error")
        metrics.solver_mesh_devices.set(value=0)
        obs.recorder.record(
            obs.SOLVER_FALLBACK, obs.CYCLE_SCOPE, cycle=self._drain_cycle,
            path=obs.SOLVER, reason=reason, reason_slug="mesh_error")

    def reset_sessions(self, reason: str = "restart") -> None:
        """Drop the delta sessions and the resident device states, so
        the next drain of each kind opens with a full SYNC (the recovery
        path: resident state and sidecar sessions are gone across a
        restart, and a store rebuilt by replay is never diffed against
        slot state from before it)."""
        if self._delta_sessions or self._device_states:
            metrics.solver_resync_total.inc(reason)
        self._delta_sessions.clear()
        self._device_states.clear()

    def _clear_device_error(self) -> None:
        """A local solve landed: the device works again, so the
        device_error rung (host cycles) recovers on the ladder."""
        ctl = resilience.controller
        if ctl.active(resilience.SOLVER, "device_error"):
            ctl.report(resilience.SOLVER, "device_error", False,
                       cycle=self._drain_cycle,
                       reason="local solve succeeded; device healthy")

    def _device_fault(self, kind: str, e: BaseException) -> None:
        """The local solve raised: drop the kind's resident state,
        count, report and journal the fault, and raise
        SolverUnavailable so the round completes on host cycles."""
        self._device_states.pop(kind, None)
        metrics.solver_fallback_total.inc("device_error")
        metrics.solver_mesh_devices.set(value=0)
        reason = (f"local solver backend fault ({e!r}); admissions "
                  "degrade to the host cycle")
        resilience.controller.report(
            resilience.SOLVER, "device_error", True,
            cycle=self._drain_cycle, reason=reason)
        obs.recorder.record(
            obs.SOLVER_FALLBACK, obs.CYCLE_SCOPE, cycle=self._drain_cycle,
            path=obs.SOLVER, reason=reason, reason_slug="device_error")
        raise SolverUnavailable(f"local solver backend fault: {e!r}") from e

    # -- the lean solve's arms: relaxed LP, then the exact solve ----------

    def _local_solve(self, problem: SolverProblem,
                     frame: Optional[SessionFrame], result: DrainResult,
                     n_live: int) -> tuple:
        """relax -> mesh -> single-device chain: the relaxed arm when
        the router picks it, falling through to the exact solve on an
        arm fault. Returns the numpy plan (admitted, opt, admit_round,
        parked, rounds, usage)."""
        if self._pick_relax_arm(n_live):
            out = self._relax_solve(problem, frame, result, n_live)
            if out is not None:
                return out
        return self._solve_exact(problem, frame, result, n_live)

    def _note_arm_wall(self, kind: str, arm: str, wall_s: float,
                       n_workloads: int) -> None:
        key = (kind, arm)
        dtl = devtel.collector
        if dtl.enabled and dtl.compile_enabled:
            # devtel's per-(kernel, arm, shape-bucket) verdict replaces
            # the one-shot warm set: a warm arm solving at a new padded
            # width is caught, and a warm arm's first sample is kept
            if dtl.observe_solve(kind, arm, n_workloads, wall_s):
                return
        elif key not in self._arm_warm:
            # compile-tainted probe sample: discard it (the arm stays
            # unmeasured, so the router probes it once more, warm)
            self._arm_warm.add(key)
            return
        per_wl = wall_s / max(1, n_workloads)
        prev = self._arm_ema.get(key)
        self._arm_ema[key] = (
            per_wl if prev is None else 0.7 * prev + 0.3 * per_wl)

    def _relax_available(self) -> bool:
        if not self.relax_enabled:
            return False
        if self._relax_broken:
            # timed half-open through the ladder's cooldown policy: one
            # probe drain re-measures once the cooldown elapses; another
            # fault or divergence re-demotes and restarts the clock
            if not resilience.controller.begin_probe(
                    resilience.SOLVER, "relax_broken",
                    self.relax_retry_cooldown_s):
                return False
            self._relax_broken = False
            self._arm_warm.discard(("lean", "relax"))
            devtel.collector.forget("lean", "relax")
        return True

    def _pick_relax_arm(self, n_live: int) -> bool:
        """Whether this lean drain tries the relaxed arm: probe once
        above the backlog floor after an exact baseline exists, then
        engage only while its measured per-workload wall beats the exact
        arm's (the loser decays so a regressing winner gets
        re-measured)."""
        if not self._relax_available():
            return False
        if self.relax_force:
            return True
        if n_live < self.relax_min_workloads:
            return False
        e_relax = self._arm_ema.get(("lean", "relax"))
        exact = [e for e in (self._arm_ema.get(("lean", "single")),
                             self._arm_ema.get(("lean", "mesh")))
                 if e is not None]
        if e_relax is None:
            # probe only once an exact baseline exists
            return bool(exact)
        if not exact or e_relax <= min(exact):
            return True
        self._arm_ema[("lean", "relax")] = e_relax * 0.98
        return False

    def _note_relax_failure(self, e: Optional[BaseException],
                            slug: str) -> None:
        """Demote the relaxed arm (fault or audit divergence): counted,
        journaled and cooled down, never silent, never wedged open."""
        reason = ("relaxed-arm plan diverged from the exact kernel on "
                  "an audited drain; arm demoted (exact plan emitted)"
                  if slug == "relax_disagreement" else
                  f"relaxed solver arm fault ({e!r}); falling back to "
                  "the exact arms")
        resilience.controller.report(
            resilience.SOLVER, "relax_broken", True,
            cycle=self._drain_cycle, reason=reason)
        self._arm_ema.pop(("lean", "relax"), None)
        self._arm_warm.discard(("lean", "relax"))
        devtel.collector.forget("lean", "relax")
        self.relax_counts["solver_fallback_total"][slug] += 1
        metrics.solver_fallback_total.inc(slug)
        obs.recorder.record(
            obs.SOLVER_FALLBACK, obs.CYCLE_SCOPE,
            cycle=self._drain_cycle, path=obs.SOLVER,
            reason=reason, reason_slug=slug)

    def _relax_solve(self, problem: SolverProblem,
                     frame: Optional[SessionFrame], result: DrainResult,
                     n_live: int) -> Optional[tuple]:
        """One relaxed-arm attempt: the plan, or None to fall through to
        the exact solve (arm fault). Audited drains also run the exact
        solve and emit its plan."""
        from kueue_oss_tpu_torch.solver import relax

        counts = self.relax_counts["solver_relax_drains_total"]
        self._relax_drains += 1
        audit = (self.relax_audit_every > 0
                 and (self._relax_drains == 1
                      or self._relax_drains % self.relax_audit_every == 0))
        self.last_relax_audit = None
        try:
            if self.solve_fault_hook is not None:
                self.solve_fault_hook("relax")
            t0 = time.monotonic()
            # solve_relaxed falls back to the single-device LP when the
            # padded axis does not shard evenly
            out, stats = relax.solve_relaxed(
                problem, iters=self.relax_iters,
                threshold=self.relax_support_threshold, mesh=self._mesh(),
                pad_to=self._relax_pad_hwm, device=self.device)
            wall = time.monotonic() - t0
        except Exception as e:
            self._note_relax_failure(e, "relax_error")
            counts["error"] += 1
            metrics.solver_relax_drains_total.inc("error")
            return None
        self._relax_pad_hwm = max(self._relax_pad_hwm, stats.support_padded)
        self.last_relax_stats = stats
        if stats.live:
            metrics.solver_relax_support_fraction.observe(
                value=stats.support / stats.live)
        result.phases["relax_lp"] = stats.lp_seconds
        result.phases["relax_repair"] = stats.repair_seconds
        self._note_arm_wall("lean", "relax", wall, n_live)
        if audit:
            exact = self._solve_exact(problem, frame, result, n_live)
            agree = relax.plans_agree(out, exact, problem.n_workloads)
            self.last_relax_audit = agree
            if agree:
                counts["audit_match"] += 1
                metrics.solver_relax_drains_total.inc("audit_match")
            else:
                counts["audit_diverged"] += 1
                metrics.solver_relax_drains_total.inc("audit_diverged")
                self._note_relax_failure(None, "relax_disagreement")
            return exact
        # relax-SERVED drain: keep the existing exact-arm resident
        # states current with the frame's delta, so the next exact solve
        # does not find them epoch-stale
        for key in ("lean", "lean-mesh"):
            dev = self._device_states.get(key)
            if frame is None or dev is None:
                continue
            try:
                before = {k: getattr(dev, k) for k in _DEVICE_COUNTERS}
                dev.update(problem, frame, False)
                result.device = {k: getattr(dev, k) - before[k]
                                 for k in _DEVICE_COUNTERS}
            except Exception:
                # the next exact solve re-seeds from the host problem
                self._device_states.pop(key, None)
        result.phases["solve"] = wall
        counts["served"] += 1
        metrics.solver_relax_drains_total.inc("served")
        self.last_drain_arm = "relax"
        return out

    def _solve_exact(self, problem: SolverProblem,
                     frame: Optional[SessionFrame], result: DrainResult,
                     n_live: int, full: bool = False, **caps) -> tuple:
        """The exact drain (lean, or FULL with ``caps``): the mesh arm
        when ``_pick_mesh_arm`` routes there, then the single-device
        arm. A mesh fault is counted (``_note_mesh_failure``) and the
        same drain re-runs on the single device; a fault there is the
        device_error rung (``_device_fault``). The plan is read back
        inside each arm's guarded block, so a device fault surfaces here
        and not mid-apply."""
        kind = "full" if full else "lean"
        mesh = self._pick_mesh_arm(kind, n_live)
        if mesh is not None:
            try:
                # only the fault-prone device work is guarded: the
                # bookkeeping below must not discard a plan
                if self.solve_fault_hook is not None:
                    self.solve_fault_hook("mesh")
                t0 = time.monotonic()
                tensors = self._local_tensors(problem, frame, full, result,
                                              mesh=mesh)
                t1 = time.monotonic()
                out = self._run_kernel(tensors, full, result, mesh, caps)
            except Exception as e:
                self._note_mesh_failure(e, kind)
            else:
                t2 = time.monotonic()
                result.phases["solve"] = t2 - t1
                self._note_arm_wall(kind, "mesh", t2 - t0, n_live)
                self.last_drain_arm = "mesh"
                metrics.solver_mesh_devices.set(
                    value=meshutil.mesh_devices(mesh))
                # both drains row-shard the workload axis
                metrics.solver_shard_imbalance.observe(
                    value=meshutil.shard_imbalance(
                        problem.wl_cqid, problem.n_cqs, mesh))
                self._clear_device_error()
                return out
        try:
            if self.solve_fault_hook is not None:
                self.solve_fault_hook("single")
            t0 = time.monotonic()
            tensors = self._local_tensors(problem, frame, full, result)
            t1 = time.monotonic()
            out = self._run_kernel(tensors, full, result, None, caps)
        except Exception as e:
            self._device_fault(kind, e)
        t2 = time.monotonic()
        result.phases["solve"] = t2 - t1
        self._note_arm_wall(kind, "single", t2 - t0, n_live)
        self.last_drain_arm = "single"
        metrics.solver_mesh_devices.set(value=0)
        self._clear_device_error()
        return out

    @staticmethod
    def _run_kernel(tensors, full: bool, result: DrainResult, mesh,
                    caps: dict) -> tuple:
        """One drain kernel on the arm's tensors, read back to numpy."""
        if not full:
            fn = (solve_backlog if mesh is None
                  else meshutil.lean_mesh_solver(mesh))
            return tuple(a.cpu().numpy() for a in fn(tensors))
        stats = FullDrainStats()
        out = tuple(a.cpu().numpy() for a in solve_backlog_full(
            tensors, stats=stats, mesh=mesh, **caps))
        stats.syncs += 1  # the plan's read-back
        result.full_stats = stats
        return out

    # -- delta sessions and resident device state --------------------------

    def _note_export_phase(self, result: DrainResult,
                           wall_s: float) -> None:
        """The export's wall time and the columnar view's walk / scatter
        split and dirty-row counts."""
        result.phases["export"] = wall_s
        col = self.export_cache.columnar
        stats = col.last_stats if col is not None else {}
        if stats:
            result.phases["export_walk"] = stats.get("walk_s", 0.0)
            result.phases["export_scatter"] = stats.get("scatter_s", 0.0)
            result.export_stats = {
                "export_mode": stats.get("mode", ""),
                "export_dirty_rows": int(stats.get("dirty_rows", 0)),
                "export_rows": int(stats.get("rows", 0))}

    def _pad_target(self) -> int:
        """The sticky pow2 pad high-water mark, aligned so the padded
        axis plus the null row block-shards evenly over the local mesh
        whenever one is available (even on drains routed to the single
        device, so session slots keep stable (shard, row) coordinates
        and both arms solve the same padded problem), and over a remote
        sidecar's advertised mesh width (lcm of both)."""
        remote_w = (int(getattr(self.remote, "remote_mesh_devices", 0))
                    if self.remote is not None else 0)
        return align_pad_target(self._pad_hwm,
                                meshutil.mesh_devices(self._mesh()),
                                remote_w)

    def _session_encode(self, kind: str, problem: SolverProblem, hint,
                        result: DrainResult):
        """The stable slot / rank re-encoding and its frame; (problem,
        None) with sessions off, or under a remote client with its
        sessions off (its deltas would never be sent)."""
        if not self.use_sessions:
            return problem, None
        if (self.remote is not None
                and not getattr(self.remote, "use_sessions", True)):
            return problem, None
        sess = self._delta_sessions.get(kind)
        if sess is None:
            # the FULL drain has no wl_rank tensor (FIFO order rides the
            # timestamp ranks); holding it inert keeps per-CQ rank
            # ripples out of the FULL session's deltas
            neutral = ("wl_rank",) if kind == "full" else ()
            sess = HostDeltaSession(cache=self.export_cache,
                                    neutral_fields=neutral)
            self._delta_sessions[kind] = sess
        # the slot interleave follows the mesh the resident tensors
        # shard over: a sidecar's advertised width, else the local mesh
        # (a width change is one counted interleave_migration resync)
        remote_w = (int(getattr(self.remote, "remote_mesh_devices", 0))
                    if self.remote is not None else 0)
        sess.set_interleave(remote_w if remote_w > 1
                            else meshutil.mesh_devices(self._mesh()))
        # only a sidecar recomputes state_checksum over the frames; the
        # local path may chain the cheap delta checksum
        sess.cheap_checksum = self.remote is None
        t0 = time.monotonic()
        slotted, frame = sess.advance(problem, hint=hint)
        result.phases["encode"] = time.monotonic() - t0
        result.frame = frame
        if frame is not None and frame.full_reason == "interleave_migration":
            metrics.solver_resync_total.inc("interleave_migration")
        return slotted, frame

    def _local_tensors(self, problem: SolverProblem,
                       frame: Optional[SessionFrame], full: bool,
                       result: DrainResult, mesh=None):
        """The drain's device tensors: with a frame, the kind's resident
        state updated by it; without, a fresh upload. With a ``mesh``
        the tensors are block-sharded over it (when the padded axis
        divides), in resident states of their own (``"lean-mesh"`` /
        ``"full-mesh"``), so arm flips never share buffers."""
        t0 = time.monotonic()
        if frame is None:
            tensors = None
            if mesh is not None:
                from kueue_oss_tpu_torch.solver import sharded
                from kueue_oss_tpu_torch.solver.full_kernels import (
                    host_tensors_full,
                )
                from kueue_oss_tpu_torch.solver.kernels import host_tensors

                place = (sharded.maybe_place_full if full
                         else sharded.maybe_place_lean)
                host = (host_tensors_full(problem) if full
                        else host_tensors(problem))
                tensors, _placed = place(host, problem, mesh)
            if tensors is None:
                tensors = (to_device_full(problem, self.device) if full
                           else to_device(problem, self.device))
            result.device = {"full_uploads": 1, "full_upload_bytes": sum(
                int(a.numel() * a.element_size()) for a in tensors)}
        else:
            kind = "full" if full else "lean"
            if mesh is not None:
                kind += "-mesh"
            dev = self._device_states.get(kind)
            if dev is None:
                dev = self._device_states[kind] = DeviceResidentProblem(
                    self.device, mesh=mesh)
            before = {k: getattr(dev, k) for k in _DEVICE_COUNTERS}
            tensors = dev.update(problem, frame, full)
            result.device = {k: getattr(dev, k) - before[k]
                             for k in _DEVICE_COUNTERS}
        result.phases["device_put"] = time.monotonic() - t0
        return tensors

    # -- the remote solve: pipelined dispatch, breaker, plan guard ---------

    def _dispatch_remote(self, problem: SolverProblem, expect: int,
                         frame: Optional[SessionFrame], session_key: str,
                         verify: bool, **solve_kw) -> tuple:
        """Pipelined dispatch: the remote round trip runs on a worker
        thread while this thread builds the apply's prework, so the wire
        time overlaps host work."""
        kw = dict(solve_kw)
        if frame is not None and getattr(self.remote, "supports_sessions",
                                         False):
            kw["frame"] = frame
            kw["session_key"] = session_key
        fut = self._solve_executor().submit(self._remote_solve, problem,
                                            expect, **kw)
        try:
            self._prework = self._build_prework(
                problem, verify, full=bool(solve_kw.get("full")))
        except Exception:
            self._prework = None  # the prework is an optimisation only
        return fut.result()

    def _solve_executor(self):
        if self._solve_pool is None:
            from concurrent.futures import ThreadPoolExecutor

            self._solve_pool = ThreadPoolExecutor(
                max_workers=1, thread_name_prefix="solver-dispatch")
        return self._solve_pool

    def _build_prework(self, problem: SolverProblem, verify: bool,
                       full: bool) -> dict:
        """Plan-independent apply preparation, safe before the plan
        arrives. The FULL path cannot pre-build the oracle's snapshot
        (its evictions change usage before the verify), so it only
        prefetches workload refs; the lean path also builds the snapshot
        its verify and TAS placement would build after the response."""
        pre: dict = {}
        if not full and (verify or self._drain_tas_ready):
            pre["snapshot"] = build_snapshot(self.store)
        pre["wl_of"] = {k: self.store.workloads.get(k)
                        for k in problem.wl_keys if k}
        return pre

    def _take_prework(self) -> dict:
        pre, self._prework = (self._prework or {}), None
        return pre

    def _backend_fault(self, reason: str) -> None:
        self.health.record_failure()
        self.remote_counts["solver_fallback_total"]["backend_error"] += 1
        metrics.solver_fallback_total.inc("backend_error")
        obs.recorder.record(
            obs.SOLVER_FALLBACK, obs.CYCLE_SCOPE, cycle=self._drain_cycle,
            path=obs.SOLVER, reason=reason, reason_slug="backend_error")

    def _remote_solve(self, problem: SolverProblem, expect: int, **kw):
        """One remote solve with breaker accounting: any transport or
        backend fault (a malformed result tuple included) counts against
        the breaker and surfaces as SolverUnavailable. Success is
        recorded only once the plan also passes the guard."""
        if hasattr(self.remote, "trace_cycle"):
            self.remote.trace_cycle = self._drain_cycle
        try:
            out = tuple(self.remote.solve(problem, **kw))
        except SolverUnavailable as e:
            self._backend_fault(str(e))
            raise
        except (OSError, TimeoutError) as e:
            # custom remote stubs may surface raw socket errors
            self._backend_fault(repr(e))
            raise SolverUnavailable(f"solver backend fault: {e!r}") from e
        if len(out) != expect:
            self._backend_fault(
                f"backend returned {len(out)} arrays, expected {expect}")
            raise SolverUnavailable(
                f"solver backend returned {len(out)} arrays, "
                f"expected {expect}")
        self._import_sidecar_spans()
        return out

    def _import_sidecar_spans(self) -> None:
        """Merge the sidecar's solve spans (returned in the response
        header) into the host tracer. The two processes have unrelated
        perf_counter origins, so spans are end-aligned at the moment the
        response arrived: the duration and the shared cycle id are the
        signal, the sub-millisecond start skew is not."""
        tracer = self._tracer()
        spans = getattr(self.remote, "last_spans", None)
        if tracer is None or not spans:
            return
        now_us = int(tracer.clock() * 1e6)
        tenant = str(getattr(self.remote, "tenant", "") or "")
        for sp in spans:
            # best-effort diagnostics: a garbled entry must not abort
            # the drain (the plan itself is guarded separately)
            try:
                dur_us = int(sp.get("dur_us", 0))
                # a span that ended before the response (the farm's
                # grant wait precedes the solve) declares the gap
                skew_us = int(sp.get("end_skew_us", 0))
                args = {str(k): v
                        for k, v in dict(sp.get("args") or {}).items()
                        if k not in ("name", "ts_us", "dur_us", "tid",
                                     "source")}
                args.setdefault("cycle", self._drain_cycle)
                src = str(dict(sp.get("args") or {}).get("source", "")
                          or f"sidecar:{tenant or 'solver'}")
                tracer.add_span(str(sp.get("name", "sidecar_solve")),
                                now_us - skew_us - dur_us, dur_us,
                                source=src, **args)
                if tenant:
                    tracer.track(src, tenant=tenant)
            except Exception:
                continue

    def _check_plan(self, problem: SolverProblem, admitted, opt,
                    admit_round, parked, victim_reason=None, rounds=None,
                    full: bool = False) -> None:
        """Guard an imported plan before any store change: a plan with
        wrong shapes or dtypes, out-of-range flavor options, or
        admissions / parkings of null or padding rows is a backend
        fault, rejected whole (store untouched, counted on the breaker).
        Committed usage is recomputed from the store's own requests, so
        imported tensors never drive the quota arithmetic."""
        fault = self._plan_fault(problem, admitted, opt, admit_round,
                                 parked, victim_reason, rounds, full)
        if fault is None:
            if self.remote is not None:
                self.health.record_success()
            return
        self.remote_counts["solver_plan_rejected_total"] += 1
        metrics.solver_plan_rejected_total.inc()
        if self.remote is not None:
            self.health.record_failure()
            self.remote_counts["solver_fallback_total"]["plan_rejected"] += 1
            metrics.solver_fallback_total.inc("plan_rejected")
        obs.recorder.record(
            obs.SOLVER_FALLBACK, obs.CYCLE_SCOPE, cycle=self._drain_cycle,
            path=obs.SOLVER,
            reason=f"divergent solver plan rejected: {fault}",
            reason_slug="plan_rejected")
        raise SolverUnavailable(f"divergent solver plan rejected: {fault}")

    @staticmethod
    def _plan_fault(problem: SolverProblem, admitted, opt, admit_round,
                    parked, victim_reason, rounds,
                    full: bool) -> Optional[str]:
        """Why the plan is unusable, or None if it checks out."""
        W1 = problem.wl_cqid.shape[0]
        W = W1 - 1
        C = problem.n_cqs
        for name, arr in (("admitted", admitted), ("parked", parked),
                          ("admit_round", admit_round)):
            if arr.ndim != 1 or arr.shape[0] != W1:
                return f"{name} shape {arr.shape} != ({W1},)"
        if victim_reason is not None:
            if victim_reason.ndim != 1 or victim_reason.shape[0] != W1:
                return (f"victim_reason shape {victim_reason.shape} "
                        f"!= ({W1},)")
            # the eviction loop reads int(victim_reason[w]) before other
            # guards could fire: a non-integral dtype must fail here
            if not (victim_reason.dtype == np.bool_
                    or np.issubdtype(victim_reason.dtype, np.integer)):
                return (f"victim_reason dtype {victim_reason.dtype} "
                        "is not integral")
        want_opt_ndim = 2 if full else 1
        if opt.ndim != want_opt_ndim or opt.shape[0] != W1:
            return f"opt shape {opt.shape} incompatible with ({W1}, ...)"
        for name, arr in (("opt", opt), ("admit_round", admit_round)):
            if not np.issubdtype(arr.dtype, np.integer):
                return f"{name} dtype {arr.dtype} is not integral"
        for name, arr in (("admitted", admitted), ("parked", parked)):
            if not (arr.dtype == np.bool_
                    or np.issubdtype(arr.dtype, np.integer)):
                return f"{name} dtype {arr.dtype} is not a flag"
        if rounds is not None:
            r = np.asarray(rounds)
            if r.size != 1 or not (
                    r.dtype == np.bool_
                    or np.issubdtype(r.dtype, np.integer)):
                return (f"rounds is not an integer scalar ({r.dtype}, "
                        f"size {r.size})")
        cq = problem.wl_cqid[:W]
        adm = admitted[:W].astype(bool)
        prk = parked[:W].astype(bool)
        if bool((cq[adm] >= C).any()):
            return "plan admits a null/padding row"
        if bool((cq[prk] >= C).any()):
            return "plan parks a null/padding row"
        if not full and bool((adm & prk).any()):
            return "row both admitted and parked"
        rnd = admit_round[:W]
        floor = -1 if full else 0
        if bool((rnd[adm] < floor).any()):
            return f"admitted row with admit_round below {floor}"
        # flavor-option bounds, only for the rows the apply decodes
        # (FULL: the newly admitted rows, admit_round >= 0)
        n_opt = np.array(
            [len(problem.cq_option_flavors[name])
             for name in problem.cq_names], dtype=np.int64)
        decode = adm & (rnd >= 0) if full else adm
        if not decode.any():
            return None
        cq_d = cq[decode]
        if full:
            ng = problem.cq_ngroups
            if ng is None:
                ng = np.ones(C, dtype=np.int64)
            need_g = int(ng[cq_d].max())
            if opt.shape[1] < need_g:
                return (f"opt group axis {opt.shape[1]} narrower than "
                        f"{need_g} resource groups")
            rows = opt[:W][decode]
            used = np.arange(opt.shape[1])[None, :] < ng[cq_d][:, None]
            bad = used & ((rows < 0) | (rows >= n_opt[cq_d][:, None]))
            if bool(bad.any()):
                return "flavor option index out of range"
        else:
            o = opt[:W][decode]
            if bool(((o < 0) | (o >= n_opt[cq_d])).any()):
                return "flavor option index out of range"
        return None

    def _compute_tas_assignments(self, candidates, result: DrainResult,
                                 snapshot=None):
        """Device-place admitted TAS candidates in admission order.

        Returns (kept_candidates, topology_by_workload_key); candidates
        whose placement failed are dropped and stay queued. ``snapshot``
        is the pipelined dispatch's prework (lean drains only)."""
        t0 = time.monotonic()
        # the FULL path carries a flavor per resource; a TAS CQ has one
        # resource group, so its first flavor is the TAS flavor
        tas_items = [(info, next(iter(flavor.values()))
                      if isinstance(flavor, dict) else flavor)
                     for _wl, cq_name, flavor, info, _u in candidates
                     if cq_name in self._drain_tas_ready and flavor]
        if not tas_items:
            return candidates, {}
        if self._tas_placer is None:
            self._tas_placer = DeviceTASPlacer(self.device)
        if snapshot is None:
            snapshot = build_snapshot(self.store)
        placements = self._tas_placer.place_batch(snapshot, tas_items)
        submitted = {info.key for info, _ in tas_items}
        kept = []
        topo_of: dict[str, TopologyAssignment] = {}
        for cand in candidates:
            _wl, cq_name, _f, info, _usage = cand
            if cq_name in self._drain_tas_ready and info.key in submitted:
                ta = placements.get(info.key)
                if ta is None:
                    result.plan_fallbacks += 1
                    metrics.solver_plan_fallbacks_total.inc()
                    obs.recorder.record(
                        obs.SOLVER_FALLBACK, info.key,
                        cycle=self._drain_cycle, cluster_queue=cq_name,
                        path=obs.SOLVER,
                        reason="device TAS placement failed; workload "
                               "stays queued for the host mop-up cycle",
                        reason_slug="tas_place_failed")
                    continue  # stays queued for the host path
                topo_of[info.key] = ta
            kept.append(cand)
        result.phases["placement"] = time.monotonic() - t0
        return kept, topo_of

    def _verify(self, candidates, verify: bool, result: DrainResult,
                snapshot=None) -> np.ndarray:
        """The oracle's verdict per candidate, in commit order, over a
        fresh snapshot's quota forest (scheduler.go:427 fits
        re-check), or the prework's when it overlapped the solve;
        rejections are counted as plan fallbacks. Without ``verify``
        every candidate passes."""
        if not (verify and candidates):
            return np.ones(len(candidates), dtype=np.uint8)
        if snapshot is None:
            snapshot = build_snapshot(self.store)
        oracle = BatchOracle(snapshot.forest.cqs)
        ok = oracle.verify_and_apply(
            [(cq_name, usage) for _, cq_name, _, _, usage in candidates])
        result.verified += len(candidates)
        result.plan_fallbacks += int(len(candidates) - int(ok.sum()))
        return ok

    def _apply_plan(self, problem: SolverProblem, admitted: np.ndarray,
                    opt: np.ndarray, admit_round: np.ndarray,
                    parked: np.ndarray, now: float,
                    result: DrainResult, verify: bool = False) -> None:
        pre = self._take_prework()
        wl_of = pre.get("wl_of")
        adm_ws = np.nonzero(admitted[:-1])[0]
        order = adm_ws[np.argsort(admit_round[adm_ws], kind="stable")]
        candidates = []
        declared_of: dict[str, set] = {}
        for w in order:
            key = problem.wl_keys[w]
            wl = (wl_of.get(key) if wl_of is not None
                  else self.store.workloads.get(key))
            if wl is None or wl.is_quota_reserved or not wl.active:
                continue
            cq_name = problem.cq_names[problem.wl_cqid[w]]
            flavor = problem.cq_option_flavors[cq_name][opt[w]]
            info = WorkloadInfo(wl, cluster_queue=cq_name)
            declared = declared_of.get(cq_name)
            if declared is None:
                declared = {
                    r for rg in
                    self.store.cluster_queues[cq_name].resource_groups
                    for r in rg.covered_resources}
                declared_of[cq_name] = declared
            plan_usage: dict[tuple[str, str], int] = {}
            for psr in info.total_requests:
                for r, q in psr.requests.items():
                    if r in declared:
                        plan_usage[(flavor, r)] = (
                            plan_usage.get((flavor, r), 0) + q)
            candidates.append((wl, cq_name, flavor, info, plan_usage))

        candidates, topo_of = self._compute_tas_assignments(
            candidates, result, snapshot=pre.get("snapshot"))
        ok = self._verify(candidates, verify, result,
                          snapshot=pre.get("snapshot"))
        for passed, (wl, cq_name, flavor, info, _) in zip(ok, candidates):
            if not passed:
                self._record_rejected(wl, cq_name)
                continue  # stays queued for the host cycle
            flavor_of = {r: flavor for psr in info.total_requests
                         for r in psr.requests}
            self._commit_admission(wl, cq_name, flavor_of, info, now,
                                   result, topology=topo_of.get(wl.key))
        # mirror the drain's inadmissible parking host-side; StrictFIFO
        # blocked heads (not parked) stay in their heaps
        for w in np.nonzero(parked[:problem.n_workloads])[0]:
            cq_name = problem.cq_names[problem.wl_cqid[w]]
            self.queues.queues[cq_name].park(problem.wl_keys[w])
            self._record_parked(problem.wl_keys[w], cq_name)

    def _record_rejected(self, wl, cq_name: str) -> None:
        metrics.solver_plan_fallbacks_total.inc()
        obs.recorder.record(
            obs.SOLVER_FALLBACK, wl.key, cycle=self._drain_cycle,
            cluster_queue=cq_name, path=obs.SOLVER,
            reason="host oracle re-check rejected the plan entry;"
                   " workload stays queued for the host cycle",
            reason_slug="oracle_rejected")

    def _record_parked(self, key: str, cq_name: str) -> None:
        obs.recorder.record(
            obs.SKIPPED, key, cycle=self._drain_cycle,
            cluster_queue=cq_name, path=obs.SOLVER,
            reason="parked inadmissible by the solver plan: no flavor "
                   "option fits at current capacity",
            reason_slug="solver_parked")

    # -- the FULL (preemption / multi-resource-group) drain ----------------

    def _size_caps(self, problem: SolverProblem) -> tuple[int, int]:
        """The FULL drain's lane count h_max and candidate cap p_max.

        h_max: one lane per ClusterQueue up to ``H_MAX_CAP``, within the
        per-round search budget (each lane runs K x g searches), rounded
        down to a power of two with a 64-lane floor, then up to a power
        of two. p_max must cover the largest candidate set: admitted
        workloads with usage in one cohort tree, bounded by the tree's
        population and by its quota over the smallest positive request
        (plus the workloads admitted before the drain, which may predate
        a quota cut). Both follow ``SolverEngine._size_caps`` of the JAX
        package (engine.py:1593-1682)."""
        C = problem.n_cqs
        K = problem.wl_req.shape[1]
        g = max(1, int(problem.cq_ngroups.max()) if C else 1)
        budget = SEARCH_BUDGET[self.device.type]
        lane_cap = max(64, pow2(max(1, budget // max(K * g, 1)) + 1) // 2)
        h_max = max(1, pow2(min(C, H_MAX_CAP, lane_cap)))
        root_of_cq = problem.cq_root
        wl_root = root_of_cq[np.minimum(problem.wl_cqid[:-1], C - 1)]
        counts = np.bincount(wl_root, minlength=problem.n_nodes + 1)
        pop = int(counts.max()) if counts.size else 1
        req = problem.wl_req[:-1].reshape(-1, problem.wl_req.shape[-1])
        req = np.concatenate([req, problem.ad_usage[:-1]], axis=0)
        pos = req > 0
        if not pos.any():
            return h_max, pow2(max(8, pop))
        big = np.iinfo(req.dtype).max
        min_req = np.where(pos.any(axis=0),
                           np.where(pos, req, big).min(axis=0), 0)
        # per-node root: the last valid entry of the ancestor path
        path = problem.path
        null = path.shape[0] - 1
        valid = path != null
        last = np.maximum(valid.shape[1] - 1 - np.argmax(
            valid[:, ::-1], axis=1), 0)
        root_of_node = path[np.arange(path.shape[0]), last]
        root_of_node = np.where(valid.any(axis=1), root_of_node, null)
        tree_quota = np.zeros_like(problem.local_quota)
        np.add.at(tree_quota, root_of_node[:-1], problem.local_quota[:-1])
        adm0 = problem.ad_usage[:-1].any(axis=1)
        adm_counts = np.bincount(wl_root[adm0],
                                 minlength=problem.n_nodes + 1)
        cap = 0
        for rn in np.unique(root_of_cq):
            quota = tree_quota[rn] + problem.subtree[rn]
            per_fr = quota // np.maximum(min_req, 1)
            cap = max(cap, int(per_fr[min_req > 0].sum())
                      + int(adm_counts[rn]))
        return h_max, pow2(max(8, min(pop, max(8, cap))))

    def _drain_full(self, now: float, pending,
                    verify: bool = False) -> DrainResult:
        """Drain a preemption-enabled, multi-resource-group, fair-sharing
        or admission-fair-sharing backlog through solve_backlog_full and
        apply the net plan (reference cycle contract:
        scheduler.go:286-467)."""
        result = DrainResult()
        parked_map: dict[str, list[WorkloadInfo]] = {}
        for name, q in self.queues.queues.items():
            if not q.inadmissible or (self._is_tas_cq(name)
                                      and name not in self._drain_tas_ready):
                continue
            # stale entries export as pending (pending_backlog); only
            # the still-parked ones export as parked
            infos = [i for k, i in q.inadmissible.items()
                     if k not in q._stale
                     and all(ps.topology_request is None
                             for ps in i.obj.podsets)]
            if infos:
                parked_map[name] = infos
        te = time.monotonic()
        problem = export_problem(self.store, pending, include_admitted=True,
                                 parked=parked_map, afs=self.queues.afs,
                                 now=now, cache=self.export_cache)
        self._note_export_phase(result, time.monotonic() - te)
        if problem.n_workloads == 0:
            return result
        hint = getattr(problem, "_columnar_hint", None)
        g_max = int(problem.cq_ngroups.max())
        h_max, p_max = self._size_caps(problem)
        afs = bool(problem.cq_afs.any())
        n_live = problem.n_workloads
        self._pad_hwm = max(self._pad_hwm,
                            pow2(max(problem.n_workloads, self.pad_to)))
        problem = pad_workloads(problem, self._pad_target())
        problem, frame = self._session_encode("full", problem, hint, result)
        dev0 = self._device_totals()
        ts = time.monotonic()
        if self.remote is not None:
            t0 = time.monotonic()
            (admitted, opt, admit_round, parked, rounds, _usage, _wl_usage,
             victim_reason) = (np.asarray(a) for a in self._dispatch_remote(
                 problem, 8, frame, "full", verify, full=True, g_max=g_max,
                 h_max=h_max, p_max=p_max,
                 fs_enabled=self.enable_fair_sharing))
            self._check_plan(problem, admitted, opt, admit_round, parked,
                             victim_reason=victim_reason, rounds=rounds,
                             full=True)
            result.phases["solve"] = time.monotonic() - t0
            self.last_drain_arm = "remote"
        else:
            (admitted, opt, admit_round, parked, rounds, _usage, _wl_usage,
             victim_reason) = self._solve_exact(
                problem, frame, result, n_live, full=True, g_max=g_max,
                h_max=h_max, p_max=p_max,
                fs_enabled=self.enable_fair_sharing, afs=afs)
        result.rounds = int(rounds)
        result.solver_time_s = time.monotonic() - ts
        metrics.solver_cycle_duration_seconds.observe(
            "solve", value=result.solver_time_s)

        t1 = time.monotonic()
        self._apply_full_plan(problem, admitted, opt, admit_round, parked,
                              victim_reason, now, result, verify)
        result.phases["apply"] = time.monotonic() - t1
        result.apply_time_s = result.phases["apply"]
        metrics.solver_cycle_duration_seconds.observe(
            "apply", value=result.apply_time_s)
        W = problem.n_workloads
        self._ledger_record(
            result, frame, "full", dev0,
            parked_n=int((np.asarray(parked[:W]).astype(bool)
                          & ~np.asarray(admitted[:W]).astype(bool)).sum()))
        return result

    def _evict(self, key: str, reason: str, now: float) -> None:
        """Evict a victim of the plan through the one state machine:
        the scheduler's books when there is a scheduler."""
        message = "Preempted by the solver drain plan"
        if self.scheduler is not None:
            self.scheduler.evict_workload(key, reason="Preempted",
                                          message=message, now=now,
                                          preemption_reason=reason,
                                          decision_path=obs.SOLVER,
                                          decision_cycle=self._drain_cycle)
        else:
            evict_workload(self.store, self.queues, key, reason="Preempted",
                           message=message, now=now,
                           preemption_reason=reason, path=obs.SOLVER,
                           cycle=self._drain_cycle,
                           evicted_total=self._evicted_total)

    def _apply_full_plan(self, problem: SolverProblem, admitted, opt,
                         admit_round, parked, victim_reason, now: float,
                         result: DrainResult, verify: bool = False) -> None:
        """Evictions first, then admissions in (round, entry) order with
        a flavor per resource group, then the parking decisions."""
        pre = self._take_prework()
        wl_of = pre.get("wl_of")

        def lookup(key):
            return (wl_of.get(key) if wl_of is not None
                    else self.store.workloads.get(key))

        W = problem.n_workloads
        # 1) evictions: initially admitted workloads that lost their
        #    admission, or were evicted mid-drain and re-admitted
        #    (admit_round >= 0, possibly with another flavor)
        evict_ws = np.nonzero(problem.wl_admitted0[:W]
                              & ~(admitted[:W] & (admit_round[:W] < 0)))[0]
        for w in evict_ws:
            key = problem.wl_keys[w]
            wl = lookup(key)
            if wl is None or not wl.is_quota_reserved:
                continue
            self._evict(key, _REASON_OF.get(int(victim_reason[w]),
                                            IN_CLUSTER_QUEUE), now)
            if not admitted[w]:
                result.evicted += 1
                result.evicted_keys.append(key)

        # 2) admissions in (round, entry order); per-group flavor decode
        adm_ws = np.nonzero(admitted[:W] & (admit_round[:W] >= 0))[0]
        order = adm_ws[np.argsort(admit_round[adm_ws], kind="stable")]
        candidates = []
        for w in order:
            key = problem.wl_keys[w]
            wl = lookup(key)
            if wl is None or wl.is_quota_reserved or not wl.active:
                continue
            cq_name = problem.cq_names[problem.wl_cqid[w]]
            opts = problem.cq_option_flavors[cq_name]
            info = WorkloadInfo(wl, cluster_queue=cq_name)
            flavor_of = {r: opts[opt[w, g]] for r, g in
                         problem.cq_resource_group[cq_name].items()}
            plan_usage: dict[tuple[str, str], int] = {}
            for psr in info.total_requests:
                for r, q in psr.requests.items():
                    if r in flavor_of:
                        fr = (flavor_of[r], r)
                        plan_usage[fr] = plan_usage.get(fr, 0) + q
            candidates.append((wl, cq_name, flavor_of, info, plan_usage))
        # failed placements drop out of the plan before the verify, so
        # the oracle's sequential walk matches what commits
        candidates, topo_of = self._compute_tas_assignments(candidates,
                                                            result)
        ok = self._verify(candidates, verify, result)
        for passed, (wl, cq_name, flavor_of, info, _) in zip(ok, candidates):
            if not passed:
                self._record_rejected(wl, cq_name)
                continue  # stays queued for the host cycle
            self._commit_admission(wl, cq_name, flavor_of, info, now,
                                   result, topology=topo_of.get(wl.key))

        # 3) parking decisions (inadmissible backoff parity)
        for w in np.nonzero(parked[:W] & ~admitted[:W])[0]:
            cq_name = problem.cq_names[problem.wl_cqid[w]]
            self.queues.queues[cq_name].park(problem.wl_keys[w])
            self._record_parked(problem.wl_keys[w], cq_name)

    def _commit_admission(self, wl, cq_name: str,
                          flavor_of: dict[str, str], info: WorkloadInfo,
                          now: float, result: DrainResult,
                          topology: Optional[TopologyAssignment] = None,
                          ) -> None:
        persistence = getattr(self.store, "persistence", None)
        if persistence is not None:
            # the plan entry's intent before the store mutation, fenced
            # like the host path's: a drain killed mid-apply redoes the
            # uncommitted suffix from the recovered backlog
            persistence.intent("admit", wl.key, rv=wl.resource_version,
                               cycle=self._drain_cycle,
                               cluster_queue=cq_name,
                               detail={"path": "solver"})
        admission = Admission(
            cluster_queue=cq_name,
            podset_assignments=[
                PodSetAssignment(
                    name=psr.name,
                    flavors={r: flavor_of[r] for r in psr.requests
                             if r in flavor_of},
                    resource_usage=dict(psr.requests),
                    count=psr.count,
                    topology_assignment=topology,
                )
                for psr in info.total_requests
            ],
        )
        wl.status.admission = admission
        wl.set_condition(WorkloadConditionType.QUOTA_RESERVED, True,
                         reason="QuotaReserved", now=now)
        if wl.is_evicted:
            wl.set_condition(WorkloadConditionType.EVICTED, False,
                             reason="QuotaReserved", now=now)
        if wl.status.requeue_state is not None:
            wl.status.requeue_state.requeue_at = None
        cq_spec = self.store.cluster_queues[cq_name]
        checks = cq_spec.checks_for_flavors(admission.assigned_flavors())
        if checks:
            for ac_name in checks:
                wl.status.admission_checks.setdefault(
                    ac_name, AdmissionCheckState(name=ac_name))
        else:
            wl.set_condition(WorkloadConditionType.ADMITTED, True,
                             reason="Admitted", now=now)
        self.store.update_workload(wl)
        persist_hooks.crash_if("mid_drain")
        self.queues.queues[cq_name].delete(wl.key)
        scope = cq_spec.admission_scope
        if (self.queues.afs is not None and scope is not None
                and scope.admission_mode == "UsageBasedAdmissionFairSharing"):
            # keep the AfsManager in step with the plan's entry penalties
            # (the scheduler's record_admission hook)
            by_resource: dict[str, int] = {}
            for psr in info.total_requests:
                for r, q in psr.requests.items():
                    by_resource[r] = by_resource.get(r, 0) + q
            self.queues.afs.record_admission(
                f"{wl.namespace}/{wl.queue_name}", by_resource, now)
        key = wl.key
        wait_s = max(now - wl.creation_time, 0.0)
        exemplar = {"cycle": self._drain_cycle, "workload": key}
        metrics.quota_reserved_workload(cq_name, wait_s,
                                        lq=wl.queue_name,
                                        namespace=wl.namespace,
                                        exemplar=exemplar)
        if wl.is_admitted:
            metrics.admitted_workload(cq_name, wait_s,
                                      lq=wl.queue_name,
                                      namespace=wl.namespace,
                                      exemplar=exemplar)
        # the queue-wait SLI, as on the host path
        pclass = obs.priority_class_of(self.store, wl)
        obs.slo_engine.observe_admission(
            cq_name, wait_s, priority=wl.priority,
            priority_class=pclass, now=now,
            cycle=self._drain_cycle, workload=key)
        obs.recorder.record(
            obs.SOLVER_ADMITTED, key, cycle=self._drain_cycle,
            cluster_queue=cq_name, path=obs.SOLVER,
            reason=f"Admitted by the solver drain plan into "
                   f"ClusterQueue {cq_name}",
            detail={
                "flavors": dict(flavor_of),
                "placed_with_topology": topology is not None,
                "admitted": wl.is_admitted,
                "waitSeconds": round(wait_s, 3),
                "priority": wl.priority,
                "priorityClass": pclass,
                # the arm that produced the plan (joins the ledger row)
                "solver_arm": ("remote" if self.remote is not None
                               else (self.last_drain_arm or "single")),
            })
        result.admitted += 1
        result.admitted_keys.append(key)

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
Cut from the copy: metrics, the obs recorder and cycle ledger, tracer
spans, persistence intents, the degradation ladder and breaker, the
remote sidecar (so no ``SolverUnavailable`` is raised), pipelined
dispatch, and the mesh and relaxed-LP arms (so the pad target is the
pow2 high-water mark and the session interleave is 1).
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Optional

import numpy as np

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
    #: and the plan read-back), placement, apply (includes placement)
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


class SolverEngine:
    """Drains pending backlogs through the device kernels."""

    def __init__(self, store: Store, queues: QueueManager,
                 device="cuda", enable_fair_sharing: bool = False,
                 scheduler=None) -> None:
        self.store = store
        self.queues = queues
        self.device = resolve_device(device)
        #: host scheduler whose evict_workload applies the FULL plan's
        #: evictions (its freed-capacity and expectation books); None
        #: evicts through core/eviction.py directly
        self.scheduler = scheduler
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
        #: state of each kind
        self.use_sessions = True
        self._delta_sessions: dict[str, HostDeltaSession] = {}
        self._device_states: dict[str, DeviceResidentProblem] = {}
        self._tas_placer: Optional[DeviceTASPlacer] = None
        #: TAS CQs on the device path for the current drain
        self._drain_tas_ready: set[str] = set()

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
        with ``verify`` the oracle re-checks every entry first."""
        completed = False
        if self.streaming is not None:
            # mark which fences this solve's export can cover: events
            # landing mid-solve keep their subtree fenced past
            # note_full_solve (the solve never saw them)
            self.streaming.note_solve_begin()
        try:
            result = self._drain(now, verify)
            completed = True
            return result
        finally:
            if self.streaming is not None:
                # full-solve boundary: the streaming fences reset
                # against the post-solve store (a failed drain keeps
                # them down — host fallback cycles are not a parity
                # baseline — but must stop attributing events to the
                # dead solve)
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
        self._pad_hwm = max(self._pad_hwm,
                            pow2(max(problem.n_workloads, self.pad_to)))
        problem = pad_workloads(problem, self._pad_hwm)
        problem, frame = self._session_encode("lean", problem, hint, result)
        tensors = self._local_tensors(problem, frame, False, result)

        t0 = time.monotonic()
        out = solve_backlog(tensors)
        admitted, opt, admit_round, parked, rounds, _usage = (
            a.cpu().numpy() for a in out)
        result.rounds = int(rounds)
        result.phases["solve"] = time.monotonic() - t0

        t1 = time.monotonic()
        self._apply_plan(problem, admitted, opt, admit_round, parked, now,
                         result, verify)
        result.phases["apply"] = time.monotonic() - t1
        return result

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

    def _session_encode(self, kind: str, problem: SolverProblem, hint,
                        result: DrainResult):
        """The stable slot / rank re-encoding and its frame; (problem,
        None) with sessions off."""
        if not self.use_sessions:
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
        sess.set_interleave(1)
        # the session is local: no receiver recomputes state_checksum,
        # so fast-path frames may chain the cheap delta checksum
        sess.cheap_checksum = True
        t0 = time.monotonic()
        slotted, frame = sess.advance(problem, hint=hint)
        result.phases["encode"] = time.monotonic() - t0
        result.frame = frame
        return slotted, frame

    def _local_tensors(self, problem: SolverProblem,
                       frame: Optional[SessionFrame], full: bool,
                       result: DrainResult):
        """The drain's device tensors: with a frame, the kind's resident
        state updated by it; without, a fresh upload."""
        t0 = time.monotonic()
        if frame is None:
            tensors = (to_device_full(problem, self.device) if full
                       else to_device(problem, self.device))
            result.device = {"full_uploads": 1, "full_upload_bytes": sum(
                int(a.numel() * a.element_size()) for a in tensors)}
        else:
            kind = "full" if full else "lean"
            dev = self._device_states.get(kind)
            if dev is None:
                dev = self._device_states[kind] = DeviceResidentProblem(
                    self.device)
            before = {k: getattr(dev, k) for k in _DEVICE_COUNTERS}
            tensors = dev.update(problem, frame, full)
            result.device = {k: getattr(dev, k) - before[k]
                             for k in _DEVICE_COUNTERS}
        result.phases["device_put"] = time.monotonic() - t0
        return tensors

    def _compute_tas_assignments(self, candidates, result: DrainResult):
        """Device-place admitted TAS candidates in admission order.

        Returns (kept_candidates, topology_by_workload_key); candidates
        whose placement failed are dropped and stay queued."""
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
        placements = self._tas_placer.place_batch(
            build_snapshot(self.store), tas_items)
        submitted = {info.key for info, _ in tas_items}
        kept = []
        topo_of: dict[str, TopologyAssignment] = {}
        for cand in candidates:
            _wl, cq_name, _f, info, _usage = cand
            if cq_name in self._drain_tas_ready and info.key in submitted:
                ta = placements.get(info.key)
                if ta is None:
                    result.plan_fallbacks += 1
                    continue  # stays queued for the host path
                topo_of[info.key] = ta
            kept.append(cand)
        result.phases["placement"] = time.monotonic() - t0
        return kept, topo_of

    def _verify(self, candidates, verify: bool,
                result: DrainResult) -> np.ndarray:
        """The oracle's verdict per candidate, in commit order, over a
        fresh snapshot's quota forest (scheduler.go:427 fits
        re-check); rejections are counted as plan fallbacks. Without
        ``verify`` every candidate passes."""
        if not (verify and candidates):
            return np.ones(len(candidates), dtype=np.uint8)
        oracle = BatchOracle(build_snapshot(self.store).forest.cqs)
        ok = oracle.verify_and_apply(
            [(cq_name, usage) for _, cq_name, _, _, usage in candidates])
        result.verified += len(candidates)
        result.plan_fallbacks += int(len(candidates) - int(ok.sum()))
        return ok

    def _apply_plan(self, problem: SolverProblem, admitted: np.ndarray,
                    opt: np.ndarray, admit_round: np.ndarray,
                    parked: np.ndarray, now: float,
                    result: DrainResult, verify: bool = False) -> None:
        adm_ws = np.nonzero(admitted[:-1])[0]
        order = adm_ws[np.argsort(admit_round[adm_ws], kind="stable")]
        candidates = []
        declared_of: dict[str, set] = {}
        for w in order:
            key = problem.wl_keys[w]
            wl = self.store.workloads.get(key)
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

        candidates, topo_of = self._compute_tas_assignments(candidates,
                                                            result)
        ok = self._verify(candidates, verify, result)
        for passed, (wl, cq_name, flavor, info, _) in zip(ok, candidates):
            if not passed:
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
        self._pad_hwm = max(self._pad_hwm,
                            pow2(max(problem.n_workloads, self.pad_to)))
        problem = pad_workloads(problem, self._pad_hwm)
        problem, frame = self._session_encode("full", problem, hint, result)
        tensors = self._local_tensors(problem, frame, True, result)

        t0 = time.monotonic()
        stats = FullDrainStats()
        out = solve_backlog_full(tensors, g_max=g_max, h_max=h_max,
                                 p_max=p_max, stats=stats,
                                 fs_enabled=self.enable_fair_sharing,
                                 afs=afs)
        (admitted, opt, admit_round, parked, rounds, _usage, _wl_usage,
         victim_reason) = (a.cpu().numpy() for a in out)
        stats.syncs += 1  # the plan's read-back
        result.rounds = int(rounds)
        result.full_stats = stats
        result.phases["solve"] = time.monotonic() - t0

        t1 = time.monotonic()
        self._apply_full_plan(problem, admitted, opt, admit_round, parked,
                              victim_reason, now, result, verify)
        result.phases["apply"] = time.monotonic() - t1
        return result

    def _evict(self, key: str, reason: str, now: float) -> None:
        """Evict a victim of the plan through the one state machine:
        the scheduler's books when there is a scheduler."""
        message = "Preempted by the solver drain plan"
        if self.scheduler is not None:
            self.scheduler.evict_workload(key, reason="Preempted",
                                          message=message, now=now,
                                          preemption_reason=reason)
        else:
            evict_workload(self.store, self.queues, key, reason="Preempted",
                           message=message, now=now,
                           preemption_reason=reason)

    def _apply_full_plan(self, problem: SolverProblem, admitted, opt,
                         admit_round, parked, victim_reason, now: float,
                         result: DrainResult, verify: bool = False) -> None:
        """Evictions first, then admissions in (round, entry) order with
        a flavor per resource group, then the parking decisions."""
        W = problem.n_workloads
        # 1) evictions: initially admitted workloads that lost their
        #    admission, or were evicted mid-drain and re-admitted
        #    (admit_round >= 0, possibly with another flavor)
        evict_ws = np.nonzero(problem.wl_admitted0[:W]
                              & ~(admitted[:W] & (admit_round[:W] < 0)))[0]
        for w in evict_ws:
            key = problem.wl_keys[w]
            wl = self.store.workloads.get(key)
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
            wl = self.store.workloads.get(key)
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
                continue  # stays queued for the host cycle
            self._commit_admission(wl, cq_name, flavor_of, info, now,
                                   result, topology=topo_of.get(wl.key))

        # 3) parking decisions (inadmissible backoff parity)
        for w in np.nonzero(parked[:W] & ~admitted[:W])[0]:
            cq_name = problem.cq_names[problem.wl_cqid[w]]
            self.queues.queues[cq_name].park(problem.wl_keys[w])

    def _commit_admission(self, wl, cq_name: str,
                          flavor_of: dict[str, str], info: WorkloadInfo,
                          now: float, result: DrainResult,
                          topology: Optional[TopologyAssignment] = None,
                          ) -> None:
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
        result.admitted += 1
        result.admitted_keys.append(wl.key)

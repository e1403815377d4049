"""Solver engine: export -> device drain -> apply the plan to the store.

Port of the lean path of ``kueue_oss_tpu/solver/engine.py``
(``SolverEngine.drain``, engine.py:448). One drain computes the
admission plan of the whole pending backlog on the device:
``pending_backlog`` -> ``export_problem`` -> ``pad_workloads`` ->
``to_device`` -> ``solve_backlog`` -> ``_apply_plan``, where admitted
topology-aware (TAS) workloads are placed by the sequential device
placer (``_compute_tas_assignments``) before ``_commit_admission``
writes the admission, its conditions and the queue transitions.

Backlogs that need the FULL (preemption / multi-resource-group) drain
raise ``UnsupportedProblem``; ``verify=True`` raises
``NotImplementedError`` (the host oracle re-check is a later slice).
Cut from the copy: metrics, the obs recorder and cycle ledger, tracer
spans, persistence intents, the degradation ladder, the remote sidecar,
mesh and relaxed-LP arms, delta sessions and resident device state, and
the columnar export cache.
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
from kueue_oss_tpu_torch.core.queue_manager import QueueManager
from kueue_oss_tpu_torch.core.snapshot import build_snapshot
from kueue_oss_tpu_torch.core.store import Store
from kueue_oss_tpu_torch.core.workload_info import WorkloadInfo
from kueue_oss_tpu_torch.device import resolve_device
from kueue_oss_tpu_torch.solver.kernels import solve_backlog, to_device
from kueue_oss_tpu_torch.solver.tas_engine import (
    DeviceTASPlacer,
    device_tas_supported,
)
from kueue_oss_tpu_torch.solver.tensors import (
    SolverProblem,
    UnsupportedProblem,
    export_problem,
    pad_workloads,
    pow2,
)


@dataclass
class DrainResult:
    admitted: int = 0
    #: always 0: the lean drain never preempts
    evicted: int = 0
    rounds: int = 0
    #: workload keys admitted, in (round, workload row) order
    admitted_keys: list[str] = field(default_factory=list)
    #: wall seconds by phase: export, solve, placement, apply (apply
    #: includes placement)
    phases: dict[str, float] = field(default_factory=dict)


class SolverEngine:
    """Drains pending backlogs through the device kernels."""

    def __init__(self, store: Store, queues: QueueManager,
                 device="cuda") -> None:
        self.store = store
        self.queues = queues
        self.device = resolve_device(device)
        #: sticky pad high-water mark: the padded workload axis never
        #: shrinks across drains (the JAX engine's recompile guard; the
        #: axis length also sets the drain's round bound)
        self._pad_hwm = 0
        self._tas_placer: Optional[DeviceTASPlacer] = None
        #: TAS CQs on the device path for the current drain
        self._drain_tas_ready: set[str] = set()

    def needs_full_kernel(self, pending: dict[str, list[WorkloadInfo]]
                          ) -> bool:
        """Preemption or multi-resource-group shapes among the CQs
        admitting this drain need the FULL drain."""
        for name in pending:
            cq = self.store.cluster_queues.get(name)
            if cq is None:
                continue
            if cq.preemption.any_enabled or len(cq.resource_groups) > 1:
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

    def _tas_device_ready(self, name: str, q) -> bool:
        """Whether this TAS CQ's ENTIRE backlog (heap + parked) is
        device-placeable (all-or-nothing keeps StrictFIFO head order)."""
        spec = self.store.cluster_queues.get(name)
        if spec is None:
            return False
        return all(device_tas_supported(info, self.store, spec)
                   for info in list(q.in_heap.values())
                   + list(q.inadmissible.values()))

    def pending_backlog(self) -> dict[str, list[WorkloadInfo]]:
        """Heap contents per active CQ in rank (pop) order. TAS CQs join
        when their whole backlog is device-placeable; elsewhere
        topology-requesting workloads stay for the host path."""
        out: dict[str, list[WorkloadInfo]] = {}
        self._drain_tas_ready = set()
        for name, q in self.queues.queues.items():
            if not q.active:
                continue
            if self._is_tas_cq(name):
                if not self._tas_device_ready(name, q):
                    continue
                self._drain_tas_ready.add(name)
                infos = q.snapshot_order()
            else:
                infos = [i for i in q.snapshot_order()
                         if all(ps.topology_request is None
                                for ps in i.obj.podsets)]
            if infos:
                out[name] = infos
        return out

    def drain(self, now: float = 0.0, verify: bool = False) -> DrainResult:
        """Solve the whole backlog on the device and commit the plan."""
        if verify:
            raise NotImplementedError(
                "verify=True needs the host oracle re-check, which this "
                "port does not have yet")
        pending = self.pending_backlog()
        if self.needs_full_kernel(pending):
            raise UnsupportedProblem(
                "the backlog needs the FULL (preemption / multi-resource-"
                "group) drain, which this port does not have yet")
        result = DrainResult()
        te = time.monotonic()
        problem = export_problem(self.store, pending)
        result.phases["export"] = time.monotonic() - te
        if problem.n_workloads == 0:
            return result
        self._pad_hwm = max(self._pad_hwm, pow2(problem.n_workloads))
        problem = pad_workloads(problem, self._pad_hwm)

        t0 = time.monotonic()
        out = solve_backlog(to_device(problem, self.device))
        admitted, opt, admit_round, parked, rounds, _usage = (
            a.cpu().numpy() for a in out)
        result.rounds = int(rounds)
        result.phases["solve"] = time.monotonic() - t0

        t1 = time.monotonic()
        self._apply_plan(problem, admitted, opt, admit_round, parked, now,
                         result)
        result.phases["apply"] = time.monotonic() - t1
        return result

    def _compute_tas_assignments(self, candidates, result: DrainResult):
        """Device-place admitted TAS candidates in admission order.

        Returns (kept_candidates, topology_by_workload_key); candidates
        whose placement failed are dropped and stay queued."""
        t0 = time.monotonic()
        tas_items = [(info, flavor)
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
                    continue  # stays queued for the host path
                topo_of[info.key] = ta
            kept.append(cand)
        result.phases["placement"] = time.monotonic() - t0
        return kept, topo_of

    def _apply_plan(self, problem: SolverProblem, admitted: np.ndarray,
                    opt: np.ndarray, admit_round: np.ndarray,
                    parked: np.ndarray, now: float,
                    result: DrainResult) -> None:
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
        for wl, cq_name, flavor, info, _ in candidates:
            flavor_of = {r: flavor for psr in info.total_requests
                         for r in psr.requests}
            self._commit_admission(wl, cq_name, flavor_of, info, now,
                                   result, topology=topo_of.get(wl.key))
        # mirror the drain's inadmissible parking host-side; StrictFIFO
        # blocked heads (not parked) stay in their heaps
        for w in np.nonzero(parked[:problem.n_workloads])[0]:
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
        result.admitted += 1
        result.admitted_keys.append(wl.key)

"""Workload lifecycle controller: the admission-check path.

A copy of ``kueue_oss_tpu/controllers/workload_controller.py``
(reference: pkg/controller/core/workload_controller.go) over the
port's scheduler. For a quota-reserved workload it seeds and prunes the
admission-check states against its ClusterQueue's spec, then acts on
them (workload_controller.go:752-834):

- a Rejected check deactivates the workload and evicts it without a
  requeue;
- a Retry check evicts it (quota released, requeued at once);
- all checks Ready admits it, unless a podset still waits for its
  delayed topology assignment: then the workload is queued for the
  scheduler's second pass (``QueueManager.queue_second_pass``), which
  places it and leaves the admission to the next reconcile.

A deactivated workload that still holds quota is evicted without a
requeue. ``reconcile(key, now)`` returns the next deadline at which the
workload must be reconciled again (None: none).

Cut from the copy, since no slice of the port drives them: the
ClusterQueue / LocalQueue stop policies, the PodsReady timeout and its
requeuing strategy (``set_pods_ready``), the maximum execution time,
and the retention GC of finished and deactivated workloads (with the
PodsReady path go its readiness-latency series).
"""

from __future__ import annotations

from typing import Optional

from kueue_oss_tpu_torch import metrics
from kueue_oss_tpu_torch.api.types import (
    AdmissionCheckState,
    CheckState,
    Workload,
    WorkloadConditionType,
)
from kueue_oss_tpu_torch.core.store import Store


class EvictionReason:
    """Reference parity: workload_types.go WorkloadEvictedBy* reasons
    (the ones the copied paths write)."""

    ADMISSION_CHECK = "AdmissionCheck"
    DEACTIVATED = "Deactivated"


class WorkloadReconciler:
    """Drives the admission-check part of the Workload state machine on
    top of the scheduler's eviction and second-pass primitives."""

    def __init__(self, store: Store, scheduler) -> None:
        self.store = store
        self.scheduler = scheduler

    @staticmethod
    def _has_pending_topology(wl: Workload) -> bool:
        """workload.go HasTopologyAssignmentsPending."""
        if wl.status.admission is None:
            return False
        return any(psa.topology_assignment is None
                   and psa.delayed_topology_request == "Pending"
                   for psa in wl.status.admission.podset_assignments)

    def reconcile_all(self, now: float) -> Optional[float]:
        """Sweep every workload; returns the earliest next deadline."""
        deadlines = [self.reconcile(key, now)
                     for key in list(self.store.workloads)]
        due = [d for d in deadlines if d is not None]
        return min(due) if due else None

    def reconcile(self, key: str, now: float) -> Optional[float]:
        wl = self.store.workloads.get(key)
        if wl is None or wl.is_finished:
            return None
        if not wl.active:
            if wl.is_quota_reserved:
                self.scheduler.evict_workload(
                    wl.key, reason=EvictionReason.DEACTIVATED,
                    message="The workload is deactivated", now=now,
                    requeue=False)
            return None
        if wl.is_quota_reserved:
            self._sync_admission_checks(wl, now)
        return None

    def _sync_admission_checks(self, wl: Workload, now: float) -> bool:
        """Returns True if the workload was evicted as a result
        (workload_controller.go:752-834, pkg/workload/admissionchecks.go:
        prune and seed the states against the CQ spec, then act on
        Rejected > Retry > all Ready)."""
        cq_name = (wl.status.admission.cluster_queue
                   if wl.status.admission is not None
                   else self.store.cluster_queue_for(wl))
        cq = self.store.cluster_queues.get(cq_name) if cq_name else None
        if cq is None:
            return False
        assigned = (wl.status.admission.assigned_flavors()
                    if wl.status.admission is not None else None)
        wanted = cq.checks_for_flavors(assigned)
        for name in list(wl.status.admission_checks):
            if name not in wanted:
                del wl.status.admission_checks[name]
        for name in wanted:
            wl.status.admission_checks.setdefault(
                name, AdmissionCheckState(name=name))

        states = wl.status.admission_checks.values()
        rejected = [s for s in states if s.state == CheckState.REJECTED]
        if rejected:
            names = ", ".join(s.name for s in rejected)
            # Rejected is terminal: deactivate so it is not retried
            wl.active = False
            self.scheduler.evict_workload(
                wl.key, reason=EvictionReason.ADMISSION_CHECK,
                message=f"Admission check(s) {names} rejected the workload",
                now=now, requeue=False, underlying_cause="Rejected")
            self.store.update_workload(wl)
            return True
        retry = [s for s in states if s.state == CheckState.RETRY]
        if retry:
            names = ", ".join(s.name for s in retry)
            self.scheduler.evict_workload(
                wl.key, reason=EvictionReason.ADMISSION_CHECK,
                message=f"Admission check(s) {names} requested a retry",
                now=now, underlying_cause="Retry")
            return True
        # no checks at all admits too, as in the reference
        if all(s.state == CheckState.READY for s in states):
            if self._has_pending_topology(wl):
                # Delayed TAS: admission waits for the second pass; the
                # queue manager's iteration map is the dedup
                if not self.scheduler.queues.second_pass_pending(wl.key):
                    self.scheduler.queues.queue_second_pass(wl.key, now)
                return False
            if not wl.is_admitted and wl.is_quota_reserved:
                wl.set_condition(WorkloadConditionType.ADMITTED, True,
                                 reason="Admitted", now=now)
                self.store.update_workload(wl)
                metrics.admitted_workload(cq_name, now - wl.creation_time)
                qr = wl.condition(WorkloadConditionType.QUOTA_RESERVED)
                if qr is not None:
                    metrics.admission_checks_wait_time_seconds.observe(
                        cq_name,
                        value=max(now - qr.last_transition_time, 0.0))
                    if metrics._lq_metrics_enabled():
                        (metrics
                         .local_queue_admission_checks_wait_time_seconds
                         .observe(wl.queue_name, wl.namespace,
                                  value=max(now - qr.last_transition_time,
                                            0.0)))
        return False

"""The eviction state machine, and the finish path a workload leaves by.

``evict_workload`` is the state machine of ``Scheduler.evict_workload``
(``kueue_oss_tpu/scheduler/scheduler.py:1444-1565``), kept once for
both of its callers: the host scheduler's preemptions and the FULL
drain's plan (through ``Scheduler.evict_workload`` when the engine has
a scheduler, directly when it has none). It writes the Evicted /
Preempted / QuotaReserved / Admitted conditions, clears the admission
and its checks, counts the eviction per reason (and its underlying
cause), closes the PodsReady window and requeues: at once, ordered by
the eviction time, or behind an exponential backoff when the caller
passes ``backoff_base_s`` (RequeueState); ``requeue=False`` (a
deactivation, whose workload cannot re-enter anyway) never starts one.
The store update re-queues the workload; the cohort flush wakes its
parked neighbours. The eviction is journaled (a ``PREEMPTED`` or
``EVICTED`` decision event tagged with the caller's ``path`` and
``cycle``) and counted in the eviction series; ``evicted_total`` is the
evictor's per-workload tally that keys the first-eviction counter (the
JAX scheduler's ``evicted_total``). With a ``PersistenceManager``
attached to the store, a ``preempt`` or ``evict`` intent fenced by the
pre-write resource version is written before the store mutation. Cut
from the copy: events and logs.

``finish_workload`` is ``Scheduler.finish_workload``
(``kueue_oss_tpu/scheduler/scheduler.py:1650-1672``): the Finished
condition releases the quota, the finished counters count it, and the
queue manager flushes the cohort's parked workloads.
"""

from __future__ import annotations

from typing import Optional

from kueue_oss_tpu_torch import metrics, obs
from kueue_oss_tpu_torch.api.types import (
    RequeueState,
    WorkloadConditionType,
    WorkloadSchedulingStatsEviction,
)
from kueue_oss_tpu_torch.core.queue_manager import QueueManager
from kueue_oss_tpu_torch.core.store import Store

#: cap of an eviction's exponential requeue backoff
EVICTION_BACKOFF_MAX_S = 3600.0


def evict_workload(store: Store, queues: QueueManager, key: str,
                   reason: str, message: str, now: float,
                   preemption_reason: str = "",
                   underlying_cause: str = "",
                   backoff_base_s: Optional[float] = None,
                   requeue: bool = True, path: str = obs.HOST,
                   cycle: int = 0,
                   evicted_total: Optional[dict] = None):
    """Release the workload's quota and requeue it. Returns (workload,
    whether it held quota, its ClusterQueue), or None when there was
    nothing to evict."""
    wl = store.workloads.get(key)
    if wl is None or wl.is_finished:
        return None
    # resolve the CQ before the admission is cleared: the LQ mapping may
    # be stale, but the quota was released on the admitting CQ
    cq = (wl.status.admission.cluster_queue
          if wl.status.admission is not None
          else store.cluster_queue_for(wl))
    p = getattr(store, "persistence", None)
    if p is not None:
        p.intent("preempt" if preemption_reason else "evict",
                 wl.key, rv=wl.resource_version, cycle=cycle,
                 cluster_queue=cq or "", detail={"reason": reason})
    was_reserved = wl.is_quota_reserved
    wl.set_condition(WorkloadConditionType.EVICTED, True, reason=reason,
                     message=message, now=now)
    if preemption_reason:
        wl.set_condition(WorkloadConditionType.PREEMPTED, True,
                         reason=preemption_reason, message=message, now=now)
    wl.set_condition(WorkloadConditionType.QUOTA_RESERVED, False,
                     reason=reason, now=now)
    wl.set_condition(WorkloadConditionType.ADMITTED, False, reason=reason,
                     now=now)
    wl.status.admission = None
    wl.status.admission_checks.clear()
    for ev in wl.status.eviction_stats:
        if ev.reason == reason and ev.underlying_cause == underlying_cause:
            ev.count += 1
            break
    else:
        wl.status.eviction_stats.append(WorkloadSchedulingStatsEviction(
            reason=reason, underlying_cause=underlying_cause, count=1))
    # the unhealthy-node list and the PodsReady window belong to the
    # admission being released
    wl.status.unhealthy_nodes = []
    ready_cond = wl.status.conditions.pop(WorkloadConditionType.PODS_READY,
                                          None)
    pods_ready_at = (ready_cond.last_transition_time
                     if ready_cond is not None and ready_cond.status
                     else None)
    if requeue and backoff_base_s is not None:
        # exponential requeue backoff: schedulable again at requeue_at
        rs = wl.status.requeue_state or RequeueState()
        rs.count += 1
        rs.requeue_at = now + min(backoff_base_s * (2 ** (rs.count - 1)),
                                  EVICTION_BACKOFF_MAX_S)
        wl.status.requeue_state = rs
    store.update_workload(wl)
    obs.recorder.record(
        obs.PREEMPTED if preemption_reason else obs.EVICTED, wl.key,
        cycle=cycle, cluster_queue=cq or "", path=path, reason=message,
        reason_slug=preemption_reason or reason)
    if evicted_total is None:
        evicted_total = {}
    evicted_total[wl.key] = evicted_total.get(wl.key, 0) + 1
    if cq:
        metrics.evicted_workloads_total.inc(cq, reason)
        # latency = Evicted-condition transition -> quota released; only
        # meaningful when this call released a reservation
        ev = wl.condition(WorkloadConditionType.EVICTED)
        if ev is not None and was_reserved:
            metrics.workload_eviction_latency_seconds.observe(
                cq, reason, value=max(now - ev.last_transition_time, 0.0))
        if evicted_total[wl.key] == 1:
            metrics.evicted_workloads_once_total.inc(cq, reason)
        if metrics._lq_metrics_enabled():
            metrics.local_queue_evicted_workloads_total.inc(
                wl.queue_name, wl.namespace, reason)
        if pods_ready_at is not None:
            metrics.pods_ready_to_evicted_time_seconds.observe(
                cq, reason, value=max(now - pods_ready_at, 0.0))
        if preemption_reason:
            metrics.preempted_workloads_total.inc(cq, preemption_reason)
    queues.report_workload_evicted(wl)
    return wl, was_reserved, cq


def finish_workload(store: Store, queues: QueueManager, key: str,
                    now: float = 0.0) -> Optional[str]:
    """Mark the workload Finished and release its quota (the job
    framework's Finished path). Returns the workload's ClusterQueue."""
    wl = store.workloads.get(key)
    if wl is None:
        return None
    cq = (wl.status.admission.cluster_queue
          if wl.status.admission is not None
          else store.cluster_queue_for(wl))
    wl.set_condition(WorkloadConditionType.FINISHED, True,
                     reason="JobFinished", now=now)
    store.update_workload(wl)
    if cq:
        # the retained-finished gauges are the store's (_track_finished);
        # only the monotone counters live here
        metrics.finished_workloads_total.inc(cq)
        if metrics._lq_metrics_enabled():
            metrics.local_queue_finished_workloads_total.inc(
                wl.queue_name, wl.namespace)
    queues.report_workload_finished(wl)
    return cq

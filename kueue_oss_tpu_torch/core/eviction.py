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
parked neighbours. Cut from the copy: persistence
intents, and the decision recorder, events, logs and metrics (the port
has no observability layer).

``finish_workload`` is ``Scheduler.finish_workload``
(``kueue_oss_tpu/scheduler/scheduler.py:1650-1672``) without its
metrics: the Finished condition releases the quota, and the queue
manager flushes the cohort's parked workloads.
"""

from __future__ import annotations

from typing import Optional

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
                   requeue: bool = True):
    """Release the workload's quota and requeue it. Returns (workload,
    whether it held quota), or None when there was nothing to evict."""
    wl = store.workloads.get(key)
    if wl is None or wl.is_finished:
        return None
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
    wl.status.conditions.pop(WorkloadConditionType.PODS_READY, None)
    if requeue and backoff_base_s is not None:
        # exponential requeue backoff: schedulable again at requeue_at
        rs = wl.status.requeue_state or RequeueState()
        rs.count += 1
        rs.requeue_at = now + min(backoff_base_s * (2 ** (rs.count - 1)),
                                  EVICTION_BACKOFF_MAX_S)
        wl.status.requeue_state = rs
    store.update_workload(wl)
    queues.report_workload_evicted(wl)
    return wl, was_reserved


def finish_workload(store: Store, queues: QueueManager, key: str,
                    now: float = 0.0) -> None:
    """Mark the workload Finished and release its quota (the job
    framework's Finished path)."""
    wl = store.workloads.get(key)
    if wl is None:
        return
    wl.set_condition(WorkloadConditionType.FINISHED, True,
                     reason="JobFinished", now=now)
    store.update_workload(wl)
    queues.report_workload_finished(wl)

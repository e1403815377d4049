"""The eviction state machine the FULL drain's plan applies, and the
finish path a workload leaves by.

``evict_workload`` is a copy of the part of ``Scheduler.evict_workload``
(``kueue_oss_tpu/scheduler/scheduler.py:1444-1565``) that the solver
engine's ``_apply_full_plan`` uses: the Evicted / Preempted /
QuotaReserved / Admitted condition writes, the admission and its
checks cleared, the per-reason eviction counter, the PodsReady window
closed, and the requeue with no backoff (the store update re-queues the
workload, ordered by its eviction time; the cohort flush wakes its
parked neighbours). Cut from the copy:

- persistence intents: the port's store has no write-ahead log;
- the decision recorder, events, logs and metrics: the port has no
  observability layer;
- the exponential requeue backoff and its heap: preemption evictions
  never pass a backoff (only PodsReady evictions do, which the drain
  never issues).

``finish_workload`` is a copy of ``Scheduler.finish_workload``
(``kueue_oss_tpu/scheduler/scheduler.py:1650-1672``) without its
metrics: the Finished condition releases the quota, and the queue
manager flushes the cohort's parked workloads.
"""

from __future__ import annotations

from kueue_oss_tpu_torch.api.types import (
    WorkloadConditionType,
    WorkloadSchedulingStatsEviction,
)
from kueue_oss_tpu_torch.core.queue_manager import QueueManager
from kueue_oss_tpu_torch.core.store import Store


def evict_workload(store: Store, queues: QueueManager, key: str,
                   reason: str, message: str, now: float,
                   preemption_reason: str = "",
                   underlying_cause: str = "") -> None:
    """Release the workload's quota and requeue it immediately."""
    wl = store.workloads.get(key)
    if wl is None or wl.is_finished:
        return
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
    store.update_workload(wl)
    queues.report_workload_evicted(wl)


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

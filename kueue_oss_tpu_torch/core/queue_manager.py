"""Pending-workload queues, one per ClusterQueue.

A copy of ``kueue_oss_tpu/core/queue_manager.py`` (reference:
pkg/cache/queue/manager.go + cluster_queue.go) for BestEffortFIFO and
StrictFIFO queues: the heap members, ordered by (priority desc, queue-order
timestamp asc, uid), the inadmissible (parked) set, and the cohort
flush when capacity frees (a workload deleted, evicted or finished). The drain
reads ``snapshot_order`` and ``inadmissible`` and writes
``delete``/``park``; an eviction re-queues the workload through its
store update and flushes its cohort. The flush is the JAX package's
eager one: parked entries move back into the heap at once, ordered by
the same ``_order_key``, so the drain exports the same pending and
parked rows as the JAX engine over a queue manager without lazy
flushing. Under admission fair sharing the manager only holds the
``AfsManager`` (``afs``): the drain exports the heap order and picks a
UsageBasedAdmissionFairSharing queue's head (the entry of the
LocalQueue with the lowest decayed usage) on the device. Cut from the
copy: the host AFS pop order, the TAS second-pass queue,
solver-managed lazy flushes (no stale entries),
scheduling-equivalence no-fit hashes (only host cycles record them),
metric dirty sets, and the lock/condition the threaded host scheduler
waits on.
"""

from __future__ import annotations

from typing import Iterable, Optional

from kueue_oss_tpu_torch import features
from kueue_oss_tpu_torch.api.types import StopPolicy, Workload
from kueue_oss_tpu_torch.core.store import Store
from kueue_oss_tpu_torch.core.workload_info import (
    WorkloadInfo,
    effective_priority,
    queue_order_timestamp,
)


def _order_key(info: WorkloadInfo) -> tuple:
    # higher priority first, then FIFO on the eviction-aware timestamp
    return (-effective_priority(info.obj), queue_order_timestamp(info.obj),
            info.obj.uid)


class ClusterQueuePendingQueue:
    """Heap + inadmissible parking for one ClusterQueue."""

    def __init__(self, name: str) -> None:
        self.name = name
        #: heap members by key; the host scheduler's pop order is
        #: ``snapshot_order`` (the drain never pops)
        self.in_heap: dict[str, WorkloadInfo] = {}
        self.inadmissible: dict[str, WorkloadInfo] = {}
        self.active = True

    def push(self, info: WorkloadInfo) -> None:
        self.inadmissible.pop(info.key, None)
        if info.key in self.in_heap:
            self.delete(info.key)  # re-push with fresh ordering
        self.in_heap[info.key] = info

    def delete(self, key: str) -> None:
        self.in_heap.pop(key, None)
        self.inadmissible.pop(key, None)

    def snapshot_order(self) -> list[WorkloadInfo]:
        """Heap contents in pop (rank) order, without consuming them."""
        return sorted(self.in_heap.values(), key=_order_key)

    def park(self, key: str) -> None:
        """Move a heap entry to the inadmissible set."""
        info = self.in_heap.get(key)
        if info is not None:
            self.delete(key)
            self.inadmissible[key] = info

    def queue_inadmissible(self) -> bool:
        """Move every parked workload back into the heap (capacity may
        have freed, inadmissible_workloads.go:174)."""
        if not self.inadmissible:
            return False
        parked = list(self.inadmissible.values())
        self.inadmissible.clear()
        for info in parked:
            self.push(info)
        return True


class QueueManager:
    """Reference parity: pkg/cache/queue/manager.go."""

    def __init__(self, store: Store, afs=None) -> None:
        self.store = store
        #: optional AfsManager (admission fair sharing, KEP-4136)
        self.afs = afs
        self.queues: dict[str, ClusterQueuePendingQueue] = {}
        for cq in store.cluster_queues.values():
            self.add_cluster_queue(cq.name)
        # initial LIST: enqueue pending workloads already in the store
        for wl in store.workloads.values():
            self.add_or_update_workload(wl)
        store.watch(self._on_event)

    def add_cluster_queue(self, name: str) -> None:
        spec = self.store.cluster_queues[name]
        if name not in self.queues:
            self.queues[name] = ClusterQueuePendingQueue(name)
        self.queues[name].active = spec.stop_policy == StopPolicy.NONE

    def _on_event(self, event) -> None:
        verb, kind, obj = event
        if kind == "ClusterQueue":
            self.add_cluster_queue(obj.name)
            self.queues[obj.name].queue_inadmissible()
        elif kind == "LocalQueue":
            for wl in list(self.store.workloads.values()):
                if (wl.namespace == obj.namespace
                        and wl.queue_name == obj.name):
                    self.add_or_update_workload(wl)
        elif kind == "Workload":
            if verb in ("add", "update"):
                self.add_or_update_workload(obj)
            elif verb == "delete":
                cq = self._cq_for(obj)
                if cq is not None:
                    self.queues[cq].delete(obj.key)
                    self.flush_cohort_for(cq)

    def _cq_for(self, wl: Workload) -> Optional[str]:
        cq = self.store.cluster_queue_for(wl)
        if cq is None and wl.status.admission is not None:
            cq = wl.status.admission.cluster_queue
        return cq if cq in self.queues else None

    def _local_queue_stopped(self, wl: Workload) -> bool:
        lq = self.store.local_queues.get(f"{wl.namespace}/{wl.queue_name}")
        return lq is not None and lq.stop_policy != StopPolicy.NONE

    def add_or_update_workload(self, wl: Workload) -> bool:
        """Queue a workload if it is pending (active, no quota reserved)."""
        cq = self._cq_for(wl)
        if cq is None:
            return False
        is_ca_parent = (wl.ca_parent
                        and features.enabled("ConcurrentAdmission"))
        if (not wl.active or wl.is_quota_reserved or wl.is_finished
                or is_ca_parent or self._local_queue_stopped(wl)):
            self.queues[cq].delete(wl.key)
            return False
        rs = wl.status.requeue_state
        if rs is not None and rs.requeue_at is not None:
            self.queues[cq].delete(wl.key)  # eviction backoff pending
            return False
        self.queues[cq].push(WorkloadInfo(wl, cluster_queue=cq))
        return True

    def _cohort_members(self, cq_name: str) -> Iterable[str]:
        spec = self.store.cluster_queues.get(cq_name)
        if spec is None or not spec.cohort:
            return [cq_name]

        def root_of(cohort_name: str) -> str:
            seen: set[str] = set()
            cur = cohort_name
            while cur not in seen:
                seen.add(cur)
                spec_c = self.store.cohorts.get(cur)
                if spec_c is None or not spec_c.parent:
                    break
                cur = spec_c.parent
            return cur

        my_root = root_of(spec.cohort)
        return [name for name, other in self.store.cluster_queues.items()
                if other.cohort and root_of(other.cohort) == my_root]

    def report_workload_finished(self, wl: Workload) -> None:
        """A finished workload's freed capacity wakes the parked
        workloads of the cohort."""
        cq = self._cq_for(wl)
        if cq is not None:
            self.flush_cohort_for(cq)

    def report_workload_evicted(self, wl: Workload) -> None:
        """Freed capacity wakes the parked workloads of the cohort."""
        cq = self._cq_for(wl)
        if cq is not None:
            self.flush_cohort_for(cq)

    def flush_cohort_for(self, cq_name: str) -> None:
        """Re-queue inadmissible workloads across the whole cohort."""
        for member in self._cohort_members(cq_name):
            q = self.queues.get(member)
            if q is not None:
                q.queue_inadmissible()

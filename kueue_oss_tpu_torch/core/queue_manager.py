"""Pending-workload queues, one per ClusterQueue.

A copy of ``kueue_oss_tpu/core/queue_manager.py`` (reference:
pkg/cache/queue/manager.go + cluster_queue.go): per-ClusterQueue heaps
ordered by (priority desc, queue-order timestamp asc, uid), StrictFIFO
and BestEffortFIFO requeue behaviour, inadmissible (parked) workloads
and the cohort flush when capacity frees (a workload deleted, evicted
or finished).

The host scheduler pops one head per ClusterQueue (``heads``) and
requeues what it did not admit (``requeue_workload``); a BestEffortFIFO
queue records the scheduling-equivalence class of a parked workload as
known NoFit and parks its equivalent heap entries with it, until the
next flush. The drain reads ``snapshot_order``, ``inadmissible`` and
the stale entries and writes ``delete`` / ``park``. With lazy flushing
(``set_lazy_flush(True)``, which the scheduler turns on while the
device drain serves floods) a flush marks the parked entries stale
instead of re-heaping them: the drain exports them as pending and the
host path re-heaps them (``materialize_stale``) before it schedules.
Under admission fair sharing the head of an AFS ClusterQueue is the
entry of the LocalQueue with the lowest decayed usage.

The second-pass queue holds quota-reserved workloads whose topology
assignment was delayed (admission-check ClusterQueues), with a 1 s ->
30 s exponential backoff per attempt; the scheduler's second pass
takes the ready ones at the start of each cycle.

Every queue mutation of the manager runs under one reentrant mutex,
and its condition signals new pending work: the scheduler's threaded
``serve`` loop blocks in ``wait_for_pending`` as the reference's
manager blocks the scheduler's Heads() on a sync.Cond.

The metrics layer reads ``drain_dirty_pending_counts`` (pending counts
of the queues changed since the last read) and each queue's
``pending_totals`` (requests over heap and stale members).
"""

from __future__ import annotations

import heapq
import itertools
import threading
from typing import Iterable, Optional

from kueue_oss_tpu_torch import features
from kueue_oss_tpu_torch.api.types import (
    QueueingStrategy,
    StopPolicy,
    Workload,
)
from kueue_oss_tpu_torch.core.store import Store
from kueue_oss_tpu_torch.core.workload_info import (
    WorkloadInfo,
    effective_priority,
    queue_order_timestamp,
)


class RequeueReason:
    """Reference parity: pkg/cache/queue RequeueReason values."""

    GENERIC = "Generic"
    FAILED_AFTER_NOMINATION = "FailedAfterNomination"
    PENDING_PREEMPTION = "PendingPreemption"
    PREEMPTION_FAILED = "PreemptionFailed"
    NAMESPACE_MISMATCH = "NamespaceMismatch"


def _order_key(info: WorkloadInfo) -> tuple:
    # higher priority first, then FIFO on the eviction-aware timestamp
    return (-effective_priority(info.obj), queue_order_timestamp(info.obj),
            info.obj.uid)


class ClusterQueuePendingQueue:
    """Heap + inadmissible parking for one ClusterQueue."""

    def __init__(self, name: str, strategy: str,
                 on_change=None) -> None:
        self.name = name
        self.strategy = strategy
        self._heap: list[tuple[tuple, int, WorkloadInfo]] = []
        self._in_heap: dict[str, WorkloadInfo] = {}
        self._counter = itertools.count()
        self.inadmissible: dict[str, WorkloadInfo] = {}
        #: cycle at which inadmissible workloads were last re-queued
        self.queue_inadmissible_cycle = -1
        self.active = True
        #: called with the CQ name on any pending-count mutation (the
        #: manager uses it to keep a dirty set so metric reporting is
        #: O(changed CQs), not O(all CQs))
        self._on_change = on_change or (lambda name: None)
        #: admission-fair-sharing rank fn (info -> decayed LQ usage);
        #: set by the manager for CQs with UsageBasedAdmissionFairSharing
        self.afs_key = None
        #: scheduling-equivalence classes known NoFit since the last
        #: capacity-freed flush (cluster_queue.go noFitSchedulingHashes)
        self.no_fit_hashes: set = set()
        #: XOR accumulator over (key, heap|inadmissible) membership —
        #: mutated O(1) on every queue transition so run_until_quiet can
        #: detect quiescence without walking queue internals
        self.state_hash = 0
        #: solver-managed mode: capacity-freed flushes mark parked
        #: entries STALE instead of physically re-heaping them (the
        #: eager flush is O(parked) per finish — at flood scale that is
        #: millions of heap pushes per run). Stale entries are exported
        #: to the solver as pending; the host path materializes them
        #: (moves them back into the heap) before it ever schedules.
        self.lazy_flush = False
        #: entries parked before the latest capacity-freed flush
        #: (key -> info); they are schedulable-in-waiting, so they count
        #: in pending_totals like heap members
        self._stale: dict[str, WorkloadInfo] = {}
        #: per-resource request totals over heap + stale members,
        #: maintained O(requests) per transition so the metrics flush
        #: never sorts or walks the backlog
        #: (cluster_queue_resource_pending gauges)
        self.pending_totals: dict[str, int] = {}

    _HEAP, _INADM = 1, 2

    def _hx(self, key: str, state: int) -> None:
        self.state_hash ^= hash((key, state))

    def _tot(self, info: WorkloadInfo, sign: int) -> None:
        for psr in info.total_requests:
            for r, v in psr.requests.items():
                nv = self.pending_totals.get(r, 0) + sign * v
                if nv:
                    self.pending_totals[r] = nv
                else:
                    self.pending_totals.pop(r, None)

    def _stale_pop(self, key: str) -> None:
        info = self._stale.pop(key, None)
        if info is not None:
            self._tot(info, -1)

    def __len__(self) -> int:
        return len(self._heap) + len(self.inadmissible)

    @property
    def pending_active(self) -> int:
        return len(self._in_heap)

    @property
    def pending_inadmissible(self) -> int:
        return len(self.inadmissible)

    def push(self, info: WorkloadInfo, check_no_fit: bool = False) -> None:
        """Insert into the heap. With check_no_fit (the PushOrUpdate path,
        cluster_queue.go:371), a BestEffortFIFO queue parks workloads whose
        scheduling-equivalence class is already known NoFit."""
        if (check_no_fit
                and self.strategy == QueueingStrategy.BEST_EFFORT_FIFO
                and info.key not in self._in_heap
                and self.no_fit_hashes
                and features.enabled("SchedulingEquivalenceHashing")
                and info.scheduling_hash() in self.no_fit_hashes):
            if info.key not in self.inadmissible:
                self._hx(info.key, self._INADM)
            self.inadmissible[info.key] = info
            self._stale_pop(info.key)  # updated shape => freshly parked
            self._on_change(self.name)
            return
        if info.key in self.inadmissible:
            del self.inadmissible[info.key]
            self._stale_pop(info.key)
            self._hx(info.key, self._INADM)
        if info.key in self._in_heap:
            # Re-push with fresh ordering (priority/timestamps may change).
            self.delete(info.key)
        self._in_heap[info.key] = info
        self._tot(info, +1)
        self._hx(info.key, self._HEAP)
        heapq.heappush(self._heap, (_order_key(info), next(self._counter), info))
        self._on_change(self.name)

    def pop_head(self) -> Optional[WorkloadInfo]:
        if self.afs_key is not None and self._in_heap:
            # Admission fair sharing: the head is the entry whose
            # LocalQueue has the lowest decayed usage (KEP-4136); the
            # static heap order is the tie-break. O(n) scan — usage decays
            # between cycles, so the rank can't be baked into the heap.
            info = min(self._in_heap.values(),
                       key=lambda i: (self.afs_key(i), _order_key(i)))
            del self._in_heap[info.key]
            self._tot(info, -1)
            self._hx(info.key, self._HEAP)
            # The AFS path never pops _heap, so stale tuples would pile up
            # forever; rebuild once they dominate (amortized O(1)).
            if len(self._heap) > 2 * len(self._in_heap):
                self._heap = [(k, c, i) for k, c, i in self._heap
                              if self._in_heap.get(i.key) is i]
                heapq.heapify(self._heap)
            self._on_change(self.name)
            return info
        while self._heap:
            _, _, info = heapq.heappop(self._heap)
            if self._in_heap.get(info.key) is info:
                del self._in_heap[info.key]
                self._tot(info, -1)
                self._hx(info.key, self._HEAP)
                self._on_change(self.name)
                return info
        return None

    def delete(self, key: str) -> None:
        live = self._in_heap.pop(key, None)
        if live is not None:
            self._tot(live, -1)
            self._hx(key, self._HEAP)
            self._on_change(self.name)
        if key in self.inadmissible:
            self._hx(key, self._INADM)
            self._on_change(self.name)
        self.inadmissible.pop(key, None)
        self._stale_pop(key)

    def snapshot_order(self) -> list[WorkloadInfo]:
        """Heap contents in pop (rank) order, without consuming them."""
        return sorted(self._in_heap.values(), key=_order_key)

    def park(self, key: str) -> None:
        """Move a heap entry to the inadmissible set (external decision).

        Re-parking an already-parked entry refreshes it: a stale entry
        the solver retried and could not admit is parked *again* (it is
        no longer owed a retry until the next capacity-freed flush)."""
        info = self._in_heap.get(key)
        if info is not None:
            self.delete(key)
            self.inadmissible[key] = info
            self._hx(key, self._INADM)
            self._on_change(self.name)
        elif key in self.inadmissible:
            self._stale_pop(key)

    def requeue_if_not_present(self, info: WorkloadInfo, reason: str,
                               pop_cycle: int = -1) -> bool:
        """Requeue semantics (reference: cluster_queue.go requeueIfNotPresent).

        StrictFIFO always goes back to the heap (the head blocks the queue).
        BestEffortFIFO parks generically-inadmissible workloads until an
        event in the cohort frees capacity; scheduling-affecting reasons go
        straight back to the heap. A capacity-freed flush that fired after
        this workload was popped (queue_inadmissible_cycle >= pop_cycle)
        also sends it to the heap, so mid-cycle events aren't lost.
        """
        if info.key in self._in_heap or info.key in self.inadmissible:
            return False
        if (self.strategy == QueueingStrategy.STRICT_FIFO
                or reason != RequeueReason.GENERIC
                or (pop_cycle >= 0
                    and self.queue_inadmissible_cycle >= pop_cycle)):
            self.push(info)
            return True
        self.inadmissible[info.key] = info
        self._hx(info.key, self._INADM)
        self._on_change(self.name)
        self._handle_inadmissible_hash(info)
        return False

    def _handle_inadmissible_hash(self, info: WorkloadInfo) -> None:
        """Record the parked workload's equivalence class as NoFit and
        bulk-move equivalent heap entries to inadmissible, so the scheduler
        never pays a nomination cycle for a shape it just rejected
        (cluster_queue.go handleInadmissibleHash, :559-575)."""
        if (self.strategy != QueueingStrategy.BEST_EFFORT_FIFO
                or not features.enabled("SchedulingEquivalenceHashing")):
            return
        h = info.scheduling_hash()
        self.no_fit_hashes.add(h)
        equivalent = [k for k, i in self._in_heap.items()
                      if i.scheduling_hash() == h]
        for k in equivalent:
            self.park(k)

    def queue_inadmissible(self, cycle: int) -> bool:
        """Move all parked workloads back into the heap. Known-NoFit
        classes reset: freed capacity may fit them now
        (inadmissible_workloads.go:174).

        In solver-managed (lazy) mode the move is virtual: every parked
        entry becomes STALE in O(parked) set construction — no heap
        pushes. The solver exports stale entries as pending; the host
        path materializes them first (materialize_stale)."""
        self.no_fit_hashes.clear()
        if self.lazy_flush:
            self.queue_inadmissible_cycle = cycle
            if not self.inadmissible:
                return False
            changed = False
            for k, info in self.inadmissible.items():
                if k not in self._stale:
                    self._stale[k] = info
                    self._tot(info, +1)  # schedulable-in-waiting again
                    changed = True
            if changed:
                self._on_change(self.name)
            return True
        if not self.inadmissible:
            self.queue_inadmissible_cycle = cycle
            return False
        parked = list(self.inadmissible.values())
        self.inadmissible.clear()
        for info in parked:
            self._stale_pop(info.key)
            self._hx(info.key, self._INADM)
            self.push(info)
        self.queue_inadmissible_cycle = cycle
        self._on_change(self.name)
        return True

    def stale_infos(self) -> list[WorkloadInfo]:
        """Parked entries owed a retry since the last capacity-freed
        flush (lazy mode)."""
        return list(self._stale.values())

    def materialize_stale(self) -> bool:
        """Physically re-heap stale entries (host-path handoff)."""
        if not self._stale:
            return False
        for k in list(self._stale):
            info = self.inadmissible.pop(k, None)
            self._stale_pop(k)
            if info is not None:
                self._hx(k, self._INADM)
                self.push(info)
        self._on_change(self.name)
        return True


class QueueManager:
    """Reference parity: pkg/cache/queue/manager.go."""

    def __init__(self, store: Store, afs=None) -> None:
        self.store = store
        #: guards all queue mutations; the condition signals new pending
        #: work the way the reference's manager blocks scheduler Heads()
        #: on a sync.Cond (manager.go Heads/CleanUpOnContext)
        self._mu = threading.RLock()
        self._cond = threading.Condition(self._mu)
        self.queues: dict[str, ClusterQueuePendingQueue] = {}
        #: CQs whose pending counts changed since the last drain
        self.dirty_cqs: set[str] = set()
        self.cycle = 0
        #: optional AfsManager (admission fair sharing, KEP-4136)
        self.afs = afs
        #: the current scheduling cycle's time, the AFS decay reference
        self.current_time = 0.0
        #: solver-managed lazy capacity-freed flushes (set_lazy_flush)
        self.lazy_flush = False
        #: monotone count of new pending entries (each key counted once,
        #: the first time it queues): the scheduler's re-engagement gate
        #: diffs it to see a fresh arrival flood
        self.new_pending_total = 0
        self._counted_pending: set[str] = set()
        #: second-pass queue (second_pass_queue.go): min-heap of
        #: (ready_at, workload key) plus per-key attempt counts driving
        #: the 1s -> 30s exponential backoff
        self._second_pass_heap: list[tuple[float, str]] = []
        self._second_pass_iteration: dict[str, int] = {}
        for cq in store.cluster_queues.values():
            self.add_cluster_queue(cq.name)
        # initial LIST: enqueue pending workloads already in the store
        for wl in store.workloads.values():
            self.add_or_update_workload(wl)
        store.watch(self._on_event)

    # -- second pass (TAS delayed assignment; second_pass_queue.go) ---------

    SECOND_PASS_INITIAL_BACKOFF_S = 1.0
    SECOND_PASS_MAX_BACKOFF_S = 30.0

    def queue_second_pass(self, key: str, now: float) -> float:
        """Schedule a workload for a second scheduling pass with
        exponential delay (manager.go:868 QueueSecondPassIfNeeded).
        Returns the ready-at time."""
        it = self._second_pass_iteration.get(key, 0) + 1
        self._second_pass_iteration[key] = it
        delay = min(self.SECOND_PASS_INITIAL_BACKOFF_S * (2 ** (it - 1)),
                    self.SECOND_PASS_MAX_BACKOFF_S)
        ready_at = now + delay
        heapq.heappush(self._second_pass_heap, (ready_at, key))
        return ready_at

    def take_second_pass_ready(self, now: float) -> list[str]:
        out = []
        while self._second_pass_heap and self._second_pass_heap[0][0] <= now:
            _, key = heapq.heappop(self._second_pass_heap)
            out.append(key)
        return out

    def clear_second_pass(self, key: str) -> None:
        self._second_pass_iteration.pop(key, None)

    def second_pass_pending(self, key: str) -> bool:
        return key in self._second_pass_iteration

    # -- CQ lifecycle ------------------------------------------------------

    def add_cluster_queue(self, name: str) -> None:
        spec = self.store.cluster_queues[name]
        if name not in self.queues:
            self.queues[name] = ClusterQueuePendingQueue(
                name, spec.queueing_strategy,
                on_change=self.dirty_cqs.add)
            self.queues[name].lazy_flush = self.lazy_flush
        q = self.queues[name]
        q.strategy = spec.queueing_strategy
        q.active = spec.stop_policy == StopPolicy.NONE
        if (self.afs is not None and spec.admission_scope is not None
                and features.enabled("AdmissionFairSharing")
                and spec.admission_scope.admission_mode
                == "UsageBasedAdmissionFairSharing"):
            q.afs_key = lambda info: self.afs.ordering_key(
                f"{info.obj.namespace}/{info.obj.queue_name}",
                self.current_time)
        else:
            q.afs_key = None

    def _on_event(self, event) -> None:
        with self._mu:
            self._on_event_locked(event)
            self._cond.notify_all()

    def _on_event_locked(self, event) -> None:
        verb, kind, obj = event
        if kind == "ClusterQueue":
            self.add_cluster_queue(obj.name)
            self.queues[obj.name].queue_inadmissible(self.cycle)
        elif kind == "LocalQueue":
            # a resumed or stopped LQ re-evaluates its pending workloads
            for wl in list(self.store.workloads.values()):
                if (wl.namespace == obj.namespace
                        and wl.queue_name == obj.name):
                    self.add_or_update_workload(wl)
        elif kind == "Workload":
            if verb in ("add", "update"):
                self.add_or_update_workload(obj)
            elif verb == "delete":
                self._counted_pending.discard(obj.key)
                cq = self._cq_for(obj)
                if cq is not None:
                    self.queues[cq].delete(obj.key)
                    self.flush_cohort_for(cq)

    # -- workload flow -----------------------------------------------------

    def _cq_for(self, wl: Workload) -> Optional[str]:
        cq = self.store.cluster_queue_for(wl)
        if cq is None and wl.status.admission is not None:
            cq = wl.status.admission.cluster_queue
        return cq if cq in self.queues else None

    def _local_queue_stopped(self, wl: Workload) -> bool:
        lq = self.store.local_queues.get(f"{wl.namespace}/{wl.queue_name}")
        return lq is not None and lq.stop_policy != StopPolicy.NONE

    def add_or_update_workload(self, wl: Workload) -> bool:
        """Queue a workload if it is pending (active, no quota
        reserved)."""
        with self._mu:
            queued = self._add_or_update_locked(wl)
            if queued:
                self._cond.notify_all()
            return queued

    def _add_or_update_locked(self, wl: Workload) -> bool:
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
            # eviction backoff pending; Scheduler.requeue_due clears it
            self.queues[cq].delete(wl.key)
            return False
        if wl.key not in self._counted_pending:
            self._counted_pending.add(wl.key)
            self.new_pending_total += 1
        self.queues[cq].push(WorkloadInfo(wl, cluster_queue=cq),
                             check_no_fit=True)
        return True

    def requeue_workload(self, info: WorkloadInfo, reason: str) -> bool:
        """Re-fetch the latest object state and requeue
        (manager.go:645)."""
        with self._mu:
            wl = self.store.workloads.get(info.key)
            if (wl is None or not wl.active or wl.is_quota_reserved
                    or wl.is_finished or self._local_queue_stopped(wl)):
                return False
            fresh = WorkloadInfo(wl, cluster_queue=info.cluster_queue)
            fresh.last_assignment = info.last_assignment
            q = self.queues.get(info.cluster_queue)
            if q is None:
                return False
            requeued = q.requeue_if_not_present(
                fresh, reason, pop_cycle=info.pop_cycle)
            if requeued:
                self._cond.notify_all()
            return requeued

    # -- heads -------------------------------------------------------------

    def heads(self) -> list[WorkloadInfo]:
        """Pop the head of every active ClusterQueue (one per CQ); the
        scheduler requeues the heads it does not admit."""
        with self._mu:
            self.cycle += 1
            out: list[WorkloadInfo] = []
            for q in self.queues.values():
                if not q.active:
                    continue
                head = q.pop_head()
                if head is not None:
                    head.pop_cycle = self.cycle
                    out.append(head)
            return out

    def wait_for_pending(self, timeout: Optional[float] = None) -> bool:
        """Block until some queue has pending work (or timeout); the
        reference scheduler blocks in manager.Heads() the same way."""
        with self._cond:
            if self.has_pending():
                return True
            self._cond.wait(timeout)
            return self.has_pending()

    def wakeup(self) -> None:
        """Wake any blocked wait_for_pending (shutdown / external
        nudge)."""
        with self._cond:
            self._cond.notify_all()

    def has_pending(self) -> bool:
        with self._mu:
            return any(len(q._in_heap) > 0 or len(q._stale) > 0
                       for q in self.queues.values() if q.active)

    def set_lazy_flush(self, on: bool) -> None:
        """Toggle solver-managed lazy flushing; turning it off hands any
        stale entries back to the host path."""
        with self._mu:
            self.lazy_flush = on
            for q in self.queues.values():
                q.lazy_flush = on
                if not on:
                    q.materialize_stale()
            self._cond.notify_all()

    def any_stale(self) -> bool:
        with self._mu:
            return any(q._stale for q in self.queues.values() if q.active)

    def materialize_stale_all(self) -> bool:
        """Re-heap every stale entry (before host cycles run with the
        solver disengaged)."""
        with self._mu:
            moved = False
            for q in self.queues.values():
                moved = q.materialize_stale() or moved
            if moved:
                self._cond.notify_all()
            return moved

    def solver_backlog_count(self) -> int:
        """Pending work the solver would drain: heap entries plus stale
        parked entries owed a retry."""
        with self._mu:
            return sum(len(q._in_heap) + len(q._stale)
                       for q in self.queues.values() if q.active)

    def cqs_with_pending(self) -> list[str]:
        """Active CQs holding any drainable work (heap or stale) —
        the streaming fast path's per-tick candidate list
        (scheduler/streaming.py), read in one pass under the mutex."""
        with self._mu:
            return [name for name, q in self.queues.items()
                    if q.active and (q._in_heap or q._stale)]

    def membership_fingerprint(self) -> int:
        """Order-insensitive digest of every queue's (key, heap|parked)
        membership (run_until_quiet's quiescence probe)."""
        with self._mu:
            acc = 0
            for name, q in self.queues.items():
                acc ^= hash((name, q.state_hash))
            return acc

    def drain_dirty_pending_counts(self) -> dict[str, tuple[int, int]]:
        """Pending counts for CQs that changed since the last drain —
        O(changed CQs) so the scheduler's metric refresh stays off the
        all-CQs path."""
        with self._mu:
            dirty, self.dirty_cqs = self.dirty_cqs, set()
            out = {}
            for name in dirty:
                q = self.queues.get(name)
                if q is not None:
                    out[name] = (q.pending_active, q.pending_inadmissible)
            return out

    def pending_counts(self) -> dict[str, tuple[int, int]]:
        with self._mu:
            return {
                name: (q.pending_active, q.pending_inadmissible)
                for name, q in self.queues.items()
            }

    # -- capacity-freed events ---------------------------------------------

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

    def flush_cohort_for(self, cq_name: str) -> None:
        """Re-queue inadmissible workloads across the whole cohort
        (QueueAssociatedInadmissibleWorkloadsAfter)."""
        with self._mu:
            for member in self._cohort_members(cq_name):
                q = self.queues.get(member)
                if q is not None:
                    q.queue_inadmissible(self.cycle)
            self._cond.notify_all()

    def report_workload_finished(self, wl: Workload) -> None:
        cq = self._cq_for(wl)
        if cq is not None:
            self.flush_cohort_for(cq)

    def report_workload_evicted(self, wl: Workload) -> None:
        cq = self._cq_for(wl)
        if cq is not None:
            self.flush_cohort_for(cq)

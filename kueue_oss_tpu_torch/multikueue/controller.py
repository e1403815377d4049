"""The MultiKueue admission-check controller.

A copy of ``kueue_oss_tpu/multikueue/controller.py`` (reference:
pkg/controller/admissionchecks/multikueue/workload.go) as far as a hub
with in-process workers drives it. For every hub workload whose
ClusterQueue carries the MultiKueue admission check it nominates
workers through its dispatcher, mirrors the workload to them, races
their admissions (first wins, the losers' mirrors are withdrawn), flips
the check Ready, syncs the winner's status back (PodsReady, Finished,
an eviction in the worker redoes the race) and re-dispatches when the
winner is lost past ``worker_lost_timeout_s`` (controllers.go:111).
The hub's ``WorkloadReconciler`` then admits the workload.

Cut from the copy: the external-framework adapters for custom job
kinds (``externalframeworks.py``, JAX ``:255``) and the remote
(socket) workers' error handling: every worker here is in process.
"""

from __future__ import annotations

from typing import Optional

from kueue_oss_tpu_torch import features
from kueue_oss_tpu_torch.api.types import (
    CheckState,
    PodSet,
    Workload,
    WorkloadConditionType,
)
from kueue_oss_tpu_torch.core.store import Store
from kueue_oss_tpu_torch.multikueue.cluster import MultiKueueCluster
from kueue_oss_tpu_torch.multikueue.dispatcher import AllAtOnceDispatcher

MULTIKUEUE_CONTROLLER_NAME = "kueue.x-k8s.io/multikueue"

#: owner prefix marking a mirrored workload on a worker (the reference
#: uses the kueue.x-k8s.io/multikueue-origin label)
ORIGIN_LABEL = "multikueue-origin"


class MultiKueueController:
    def __init__(self, hub_store: Store, hub_scheduler,
                 clusters: list[MultiKueueCluster],
                 dispatcher=None,
                 worker_lost_timeout_s: float = 900.0,
                 check_name: str = "multikueue") -> None:
        self.store = hub_store
        self.scheduler = hub_scheduler
        self.clusters = {c.name: c for c in clusters}
        self.dispatcher = dispatcher or AllAtOnceDispatcher()
        if hasattr(self.dispatcher, "bind"):
            # pricing dispatchers (WhatIf) need the worker environments
            self.dispatcher.bind(self.clusters)
        self.worker_lost_timeout_s = worker_lost_timeout_s
        self.check_name = check_name

    # -- main loop ----------------------------------------------------------

    def reconcile_all(self, now: float) -> None:
        if not features.enabled("MultiKueue"):
            return
        for c in self.clusters.values():
            if c.active:
                c.mark_seen(now)
        for wl in list(self.store.workloads.values()):
            # eviction clears the check states: a workload with remote
            # state left keeps reconciling until its mirrors are gone
            if (self.check_name in wl.status.admission_checks
                    or wl.status.cluster_name is not None
                    or wl.status.nominated_cluster_names):
                self.reconcile(wl, now)

    def reconcile(self, wl: Workload, now: float) -> None:
        if (wl.is_finished or not wl.active
                or not wl.is_quota_reserved):
            # finished, deactivated, or reservation lost on the hub:
            # withdraw all mirrors and reset remote state
            self._cleanup_remotes(wl, keep=None)
            wl.status.nominated_cluster_names = []
            wl.status.cluster_name = None
            return
        state = wl.status.admission_checks.get(self.check_name)
        if state is None:
            return

        winner = wl.status.cluster_name
        if winner is not None:
            self._sync_winner(wl, winner, state, now)
            return

        # race phase: mirrors on the nominated workers
        active_names = [c.name for c in self.clusters.values() if c.active]
        new = self.dispatcher.nominate(wl, active_names, now)
        if new:
            wl.status.nominated_cluster_names.extend(new)
        for name in wl.status.nominated_cluster_names:
            cluster = self.clusters.get(name)
            if cluster is None or not cluster.active:
                continue
            self._ensure_mirror(wl, cluster)

        # under MultiKueueWaitForWorkloadAdmitted the race is won by
        # full admission, else by quota reservation
        wait_admitted = features.enabled("MultiKueueWaitForWorkloadAdmitted")
        for name in wl.status.nominated_cluster_names:
            cluster = self.clusters.get(name)
            if cluster is None or not cluster.active:
                continue
            mirror = cluster.environment.store.workloads.get(wl.key)
            won = (mirror is not None
                   and (mirror.is_admitted if wait_admitted
                        else mirror.is_quota_reserved))
            if won:
                wl.status.cluster_name = name
                wl.status.nominated_cluster_names = []
                state.state = CheckState.READY
                state.message = f"The workload got reservation on \"{name}\""
                self._cleanup_remotes(wl, keep=name)
                if hasattr(self.dispatcher, "clear"):
                    self.dispatcher.clear(wl.key)
                self.store.update_workload(wl)
                return

    # -- winner tracking ----------------------------------------------------

    def _sync_winner(self, wl: Workload, winner: str, state,
                     now: float) -> None:
        cluster = self.clusters.get(winner)
        if cluster is None:
            # removed from the config: lost at once, no grace
            lost = True
        elif not cluster.active:
            lost = now - cluster.last_seen >= self.worker_lost_timeout_s
        else:
            lost = False
        if lost:
            # worker lost past the timeout: redo the admission race
            wl.status.cluster_name = None
            wl.status.nominated_cluster_names = []
            state.state = CheckState.RETRY
            state.message = f"Worker cluster \"{winner}\" is lost"
            self.store.update_workload(wl)
            return
        if cluster is None or not cluster.active:
            return  # transiently unreachable; wait for the timeout
        mirror = cluster.environment.store.workloads.get(wl.key)
        if mirror is None:
            wl.status.cluster_name = None
            state.state = CheckState.RETRY
            state.message = f"Mirror lost on worker \"{winner}\""
            self.store.update_workload(wl)
            return
        if (not mirror.is_quota_reserved and not mirror.is_finished
                and features.enabled(
                    "MultiKueueRedoAdmissionOnEvictionInWorker")):
            # the worker evicted the mirror: withdraw it first (a fresh
            # race could pick another worker while it re-admits), then
            # redo the hub-side race
            self._cleanup_remotes(wl, keep=None)
            if hasattr(self.dispatcher, "clear"):
                self.dispatcher.clear(wl.key)
            wl.status.cluster_name = None
            wl.status.nominated_cluster_names = []
            state.state = CheckState.RETRY
            state.message = (f"The workload got evicted on worker "
                             f"\"{winner}\"")
            self.store.update_workload(wl)
            return
        # the worker's PodsReady condition reaches the hub workload
        ready = mirror.condition(WorkloadConditionType.PODS_READY)
        if ready is not None:
            cur = wl.condition(WorkloadConditionType.PODS_READY)
            if cur is None or cur.status != ready.status:
                wl.set_condition(
                    WorkloadConditionType.PODS_READY, ready.status,
                    reason=ready.reason, message=ready.message, now=now)
                if ready.status:
                    wl.status.requeue_state = None
                self.store.update_workload(wl)
        if mirror.is_finished and not wl.is_finished:
            fin = mirror.condition(WorkloadConditionType.FINISHED)
            wl.set_condition(WorkloadConditionType.FINISHED, True,
                             reason=fin.reason if fin else "JobFinished",
                             message=fin.message if fin else "", now=now)
            self.store.update_workload(wl)
            self.scheduler.queues.report_workload_finished(wl)
            self._cleanup_remotes(wl, keep=None)

    # -- mirroring ----------------------------------------------------------

    def _ensure_mirror(self, wl: Workload,
                       cluster: MultiKueueCluster) -> None:
        wstore = cluster.environment.store
        if wl.key in wstore.workloads:
            return
        mirror = Workload(
            name=wl.name,
            namespace=wl.namespace,
            queue_name=wl.queue_name,
            priority=wl.priority,  # resolved on the hub
            podsets=[PodSet(
                name=ps.name, count=ps.count, requests=dict(ps.requests),
                min_count=ps.min_count,
                topology_request=ps.topology_request,
                node_selector=dict(ps.node_selector),
                tolerations=list(ps.tolerations),
            ) for ps in wl.podsets],
            creation_time=wl.creation_time,
            owner=f"{ORIGIN_LABEL}/{wl.key}",
        )
        wstore.add_workload(mirror)

    def _cleanup_remotes(self, wl: Workload, keep: Optional[str]) -> None:
        for name, cluster in self.clusters.items():
            if name == keep or not cluster.active:
                continue
            wstore = cluster.environment.store
            mirror = wstore.workloads.get(wl.key)
            if mirror is None:
                continue
            cluster.environment.scheduler.evict_workload(
                mirror.key, reason="MultiKueueCleanup",
                message="another worker won the admission race",
                now=cluster.last_seen, requeue=False)
            wstore.delete_workload(mirror.key)

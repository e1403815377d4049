"""Node-failure detection and recovery.

A copy of ``kueue_oss_tpu/controllers/failure_recovery.py`` (reference:
the TAS node watchers behind the TASFailedNodeReplacement* gates, and
pkg/controller/failurerecovery/pod_termination_controller.go:60-263).

A node NotReady (or deleted) past the grace period is appended to the
``unhealthy_nodes`` of every admitted workload whose topology
assignment uses it. With TASFailedNodeReplacement on, a workload with
one failed node is re-placed in place against a fresh snapshot:
``find_topology_assignments_for_workload(..., workload=wl)`` moves the
failed node's pods and keeps the rest (tas_flavor_snapshot.go:614-758).
Under TASDeviceFillCounts that placement runs its fill-in counts on the
scheduler's device (one ``csrc/fill_counts.cu`` launch per fill on a
CUDA device). When no replacement is possible the workload is evicted:
at once under TASFailedNodeReplacementFailFast, otherwise after the
recovery timeout.

The snapshot is built on ``scheduler.device``, as the scheduler's own
second pass builds it.
"""

from __future__ import annotations

from kueue_oss_tpu_torch import features
from kueue_oss_tpu_torch.api.types import Workload
from kueue_oss_tpu_torch.core.snapshot import build_snapshot
from kueue_oss_tpu_torch.core.store import Store


class NodeFailureController:
    def __init__(self, store: Store, scheduler,
                 grace_period_s: float = 30.0,
                 recovery_timeout_s: float = 300.0) -> None:
        self.store = store
        self.scheduler = scheduler
        self.grace_period_s = grace_period_s
        self.recovery_timeout_s = recovery_timeout_s
        #: node name -> first time it was observed NotReady/missing
        self._not_ready_since: dict[str, float] = {}
        #: workload key -> time its node was declared unhealthy
        self._unhealthy_since: dict[str, float] = {}

    # -- node health tracking ----------------------------------------------

    def _failed_nodes(self, now: float) -> set[str]:
        """Nodes NotReady (or referenced by assignments but deleted) for
        longer than the grace period."""
        observed: set[str] = set()
        for node in self.store.nodes.values():
            if not node.ready:
                observed.add(node.name)
        for wl in self.store.admitted_workloads():
            for name in self._assigned_nodes(wl):
                if name not in self.store.nodes:
                    observed.add(name)
        for name in observed:
            self._not_ready_since.setdefault(name, now)
        for name in list(self._not_ready_since):
            if name not in observed:
                del self._not_ready_since[name]  # recovered
        return {name for name, since in self._not_ready_since.items()
                if now - since >= self.grace_period_s}

    @staticmethod
    def _assigned_nodes(wl: Workload) -> set[str]:
        out: set[str] = set()
        if wl.status.admission is None:
            return out
        for psa in wl.status.admission.podset_assignments:
            ta = psa.topology_assignment
            if ta is None:
                continue
            for dom in ta.domains:
                if dom.values:
                    out.add(dom.values[-1])  # host level is last
        return out

    # -- reconcile ----------------------------------------------------------

    def reconcile(self, now: float) -> None:
        failed = self._failed_nodes(now)
        for wl in list(self.store.admitted_workloads()):
            # prune nodes that recovered before acting: a flapping node
            # must not strand the workload unhealthy
            if wl.status.unhealthy_nodes:
                still_bad = [
                    n for n in wl.status.unhealthy_nodes
                    if n not in self.store.nodes
                    or not self.store.nodes[n].ready]
                if still_bad != wl.status.unhealthy_nodes:
                    wl.status.unhealthy_nodes = still_bad
                    self.store.update_workload(wl)
                if not still_bad:
                    self._unhealthy_since.pop(wl.key, None)
            bad = self._assigned_nodes(wl) & failed
            new = sorted(bad - set(wl.status.unhealthy_nodes))
            if new:
                wl.status.unhealthy_nodes.extend(new)
                self.store.update_workload(wl)
            if not wl.status.unhealthy_nodes:
                continue
            # the recovery clock starts at this instance's first
            # observation (covers state from before a restart)
            self._unhealthy_since.setdefault(wl.key, now)
            self._try_recover(wl, now)

    def _try_recover(self, wl: Workload, now: float) -> None:
        replaced = False
        if (features.enabled("TASFailedNodeReplacement")
                and len(wl.status.unhealthy_nodes) == 1):
            replaced = self._attempt_replacement(wl, now)
        if replaced:
            wl.status.unhealthy_nodes = []
            self._unhealthy_since.pop(wl.key, None)
            self.store.update_workload(wl)
            return
        fail_fast = features.enabled("TASFailedNodeReplacementFailFast")
        waited = now - self._unhealthy_since.get(wl.key, now)
        if fail_fast or waited >= self.recovery_timeout_s:
            # stuck on a dead node: release it so it can reschedule
            self._unhealthy_since.pop(wl.key, None)
            self.scheduler.evict_workload(
                wl.key, reason="NodeFailures",
                message=f"node(s) {wl.status.unhealthy_nodes} failed and "
                        "no replacement was possible",
                now=now, underlying_cause="NodeFailures")

    # -- in-place replacement (second-pass analog) --------------------------

    def _attempt_replacement(self, wl: Workload, now: float) -> bool:
        cq_name = (wl.status.admission.cluster_queue
                   if wl.status.admission is not None else None)
        if cq_name is None:
            return False
        snapshot = build_snapshot(self.store, device=self.scheduler.device)
        cq = snapshot.cluster_queue(cq_name)
        if cq is None:
            return False
        from kueue_oss_tpu_torch import tas as tas_pkg

        tas_requests = tas_pkg.requests_from_admission(wl, cq)
        if not tas_requests:
            return False
        # the workload's own usage stays charged: only the failed node's
        # pods move, the surviving domains keep their capacity
        result = cq.find_topology_assignments_for_workload(
            tas_requests, workload=wl)
        by_name = {}
        for ps_name, res in result.items():
            if res.failure:
                return False
            by_name[ps_name] = res.assignment
        for psa in wl.status.admission.podset_assignments:
            if psa.topology_assignment is not None and psa.name in by_name:
                psa.topology_assignment = by_name[psa.name]
        return True

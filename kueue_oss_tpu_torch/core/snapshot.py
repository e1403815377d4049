"""Per-cycle scheduling snapshot over the quota forest.

A copy of ``kueue_oss_tpu/core/snapshot.py`` (reference:
pkg/cache/scheduler/snapshot.go, clusterqueue_snapshot.go,
cohort_snapshot.go): the cohort forest with admitted usage charged, the
ClusterQueue and cohort views the host scheduler cycle reads (fits,
available, borrowing, usage simulation, dominant resource share) and
one TAS domain tree per TAS flavor with admitted topology usage
assumed. The snapshot is built once per cycle (and per drain) and then
mutated freely (usage simulation, workload removal) without touching
the store. ``ClusterQueueSnapshot.find_topology_assignments_for_workload``
places a workload's TAS podsets on those trees (the host placement of
``tas/snapshot.py``); the trees run their fill-in counts on ``device``
when the TASDeviceFillCounts gate is on, and touch no device otherwise.
"""

from __future__ import annotations

from typing import Callable, Iterable, Iterator, Optional

from kueue_oss_tpu_torch import features
from kueue_oss_tpu_torch.api.types import (
    ClusterQueue,
    FlavorResource,
    ResourceFlavor,
    ResourceQuota,
    StopPolicy,
)
from kueue_oss_tpu_torch.core.quota import (
    DRS,
    QuotaForest,
    QuotaNode,
    dominant_resource_share,
)
from kueue_oss_tpu_torch.core.store import Store
from kueue_oss_tpu_torch.core.workload_info import (
    WorkloadInfo,
    effective_per_pod_requests,
)
from kueue_oss_tpu_torch.tas.snapshot import (
    TASAssignmentResult,
    TASFlavorSnapshot,
    TASPodSetRequest,
    build_tas_flavor_snapshot,
)


class CohortSnapshot:
    """A cohort node plus navigation to child CQ snapshots."""

    def __init__(self, node: QuotaNode, snapshot: "Snapshot") -> None:
        self.node = node
        self._snapshot = snapshot

    @property
    def name(self) -> str:
        return self.node.name

    def has_parent(self) -> bool:
        return self.node.parent is not None

    def parent(self) -> Optional["CohortSnapshot"]:
        if self.node.parent is None:
            return None
        return self._snapshot.cohort_snapshot(self.node.parent)

    def root(self) -> "CohortSnapshot":
        return self._snapshot.cohort_snapshot(self.node.root())

    def child_cohorts(self) -> list["CohortSnapshot"]:
        return [self._snapshot.cohort_snapshot(c)
                for c in self.node.children.values() if not c.is_cq]

    def child_cqs(self) -> list["ClusterQueueSnapshot"]:
        return [self._snapshot.cq_for_node(c)
                for c in self.node.children.values() if c.is_cq]

    def child_count(self) -> int:
        return len(self.node.children)

    def subtree_cluster_queues(self) -> Iterator["ClusterQueueSnapshot"]:
        yield from self.child_cqs()
        for coh in self.child_cohorts():
            yield from coh.subtree_cluster_queues()

    def is_within_nominal(self, frs: Iterable[FlavorResource]) -> bool:
        return self.node.is_within_nominal(frs)

    def borrowing_with(self, fr: FlavorResource, val: int) -> bool:
        return self.node.borrowing_with(fr, val)

    def dominant_resource_share(self) -> DRS:
        return dominant_resource_share(self.node)

    def __eq__(self, other: object) -> bool:
        return isinstance(other, CohortSnapshot) and other.node is self.node

    def __hash__(self) -> int:
        return id(self.node)


class ClusterQueueSnapshot:
    """Reference parity: pkg/cache/scheduler/clusterqueue_snapshot.go."""

    def __init__(self, spec: ClusterQueue, node: QuotaNode,
                 snapshot: "Snapshot", generation: int) -> None:
        self.spec = spec
        self.name = spec.name
        self.node = node
        self._snapshot = snapshot
        self.generation = generation
        #: admitted workloads (holding quota) by workload key
        self.workloads: dict[str, WorkloadInfo] = {}
        cq_flavors = [fq.name for rg in spec.resource_groups
                      for fq in rg.flavors]
        self.tas_flavors: dict[str, TASFlavorSnapshot] = {
            f: snapshot.tas_flavors[f] for f in cq_flavors
            if f in snapshot.tas_flavors}
        self._tas_only = bool(cq_flavors) and (
            len(self.tas_flavors) == len(set(cq_flavors)))

    # -- TAS ---------------------------------------------------------------

    def is_tas_only(self) -> bool:
        """Every flavor of the CQ is a TAS flavor (IsTASOnly)."""
        return self._tas_only

    def find_topology_assignments_for_workload(
        self,
        tas_requests: dict[str, list[TASPodSetRequest]],
        simulate_empty: bool = False,
        workload=None,
    ) -> dict[str, TASAssignmentResult]:
        """Per-flavor placement (clusterqueue_snapshot.go:191)."""
        result: dict[str, TASAssignmentResult] = {}
        for flavor, requests in tas_requests.items():
            snap = self._snapshot.tas_flavors.get(flavor)
            if snap is None:
                for tr in requests:
                    result[tr.podset.name] = TASAssignmentResult(
                        failure=f"flavor {flavor} has no TAS information")
                continue
            result.update(snap.find_topology_assignments(
                requests, simulate_empty=simulate_empty, workload=workload))
        return result

    # -- hierarchy ---------------------------------------------------------

    def has_parent(self) -> bool:
        return self.node.parent is not None

    def parent(self) -> Optional[CohortSnapshot]:
        if self.node.parent is None:
            return None
        return self._snapshot.cohort_snapshot(self.node.parent)

    def path_parent_to_root(self) -> Iterator[CohortSnapshot]:
        cur = self.node.parent
        while cur is not None:
            yield self._snapshot.cohort_snapshot(cur)
            cur = cur.parent

    # -- quota queries -----------------------------------------------------

    def quota_for(self, fr: FlavorResource) -> ResourceQuota:
        q = self.node.quotas.get(fr)
        return q if q is not None else ResourceQuota(name=fr[1], nominal=0)

    def available(self, fr: FlavorResource) -> int:
        return self.node.available(fr)

    def potential_available(self, fr: FlavorResource) -> int:
        return self.node.potential_available(fr)

    def borrowing(self, fr: FlavorResource) -> bool:
        return self.node.usage.get(fr, 0) > self.node.subtree_quota.get(fr, 0)

    def borrowing_with(self, fr: FlavorResource, val: int) -> bool:
        return self.node.borrowing_with(fr, val)

    def is_within_nominal(self, frs: Iterable[FlavorResource]) -> bool:
        return self.node.is_within_nominal(frs)

    def fits(self, usage: dict[FlavorResource, int]) -> bool:
        return self.node.fits(usage)

    def rg_by_resource(self, resource: str):
        for rg in self.spec.resource_groups:
            if resource in rg.covered_resources:
                return rg
        return None

    # -- usage mutation ----------------------------------------------------

    def add_usage(self, usage: dict[FlavorResource, int]) -> None:
        for fr, v in usage.items():
            self.node.add_usage(fr, v)

    def remove_usage(self, usage: dict[FlavorResource, int]) -> None:
        for fr, v in usage.items():
            self.node.remove_usage(fr, v)

    def simulate_usage_addition(
            self, usage: dict[FlavorResource, int]) -> Callable[[], None]:
        self.add_usage(usage)
        return lambda: self.remove_usage(usage)

    def simulate_usage_removal(
            self, usage: dict[FlavorResource, int]) -> Callable[[], None]:
        self.remove_usage(usage)
        return lambda: self.add_usage(usage)

    # -- fair sharing ------------------------------------------------------

    def dominant_resource_share(
            self, wl_req: Optional[dict[FlavorResource, int]] = None) -> DRS:
        return dominant_resource_share(self.node, wl_req)

    def __eq__(self, other: object) -> bool:
        return (isinstance(other, ClusterQueueSnapshot)
                and other.node is self.node)

    def __hash__(self) -> int:
        return id(self.node)

    def __repr__(self) -> str:
        return f"CQSnapshot({self.name})"


class Snapshot:
    """Whole-cluster scheduling snapshot."""

    def __init__(self, forest: QuotaForest,
                 cluster_queues: dict[str, ClusterQueueSnapshot],
                 resource_flavors: dict[str, ResourceFlavor],
                 inactive_cluster_queues: frozenset[str] = frozenset(),
                 tas_flavors: Optional[dict[str, TASFlavorSnapshot]] = None,
                 ) -> None:
        self.forest = forest
        self.cluster_queues = cluster_queues
        self.resource_flavors = resource_flavors
        self.inactive_cluster_queues = inactive_cluster_queues
        #: TAS domain trees keyed by ResourceFlavor name
        self.tas_flavors: dict[str, TASFlavorSnapshot] = tas_flavors or {}
        self._cohort_snapshots: dict[int, CohortSnapshot] = {}
        self._node_to_cq: dict[int, ClusterQueueSnapshot] = {
            id(cq.node): cq for cq in cluster_queues.values()}

    def cluster_queue(self, name: str) -> Optional[ClusterQueueSnapshot]:
        return self.cluster_queues.get(name)

    def cq_for_node(self, node: QuotaNode) -> ClusterQueueSnapshot:
        return self._node_to_cq[id(node)]

    def cohort_snapshot(self, node: QuotaNode) -> CohortSnapshot:
        cs = self._cohort_snapshots.get(id(node))
        if cs is None:
            cs = CohortSnapshot(node, self)
            self._cohort_snapshots[id(node)] = cs
        return cs

    # -- workload add / remove (preemption simulation) ---------------------

    def _tas_usage_entries(self, info: WorkloadInfo):
        """(flavor, domain values, per-pod requests, count) of every TAS
        domain an admitted workload holds."""
        wl = info.obj
        if wl.status.admission is None or not self.tas_flavors:
            return
        podsets = {ps.name: ps for ps in wl.podsets}
        for psa in wl.status.admission.podset_assignments:
            ta = psa.topology_assignment
            if ta is None:
                continue
            flavor = next((f for f in psa.flavors.values()
                           if f in self.tas_flavors), None)
            if flavor is None:
                continue
            ps = podsets.get(psa.name)
            per_pod = (effective_per_pod_requests(ps, wl.namespace)
                       if ps is not None else {})
            for dom in ta.domains:
                yield flavor, tuple(dom.values), per_pod, dom.count

    def _apply_tas_usage(self, info: WorkloadInfo, sign: int) -> None:
        for flavor, values, per_pod, count in self._tas_usage_entries(info):
            snap = self.tas_flavors[flavor]
            if sign > 0:
                snap.add_tas_usage(values, per_pod, count)
            else:
                snap.remove_tas_usage(values, per_pod, count)

    def remove_workload(self, info: WorkloadInfo) -> None:
        cq = self.cluster_queues[info.cluster_queue]
        cq.workloads.pop(info.key, None)
        cq.remove_usage(info.usage())
        self._apply_tas_usage(info, -1)

    def add_workload(self, info: WorkloadInfo) -> None:
        cq = self.cluster_queues[info.cluster_queue]
        cq.workloads[info.key] = info
        cq.add_usage(info.usage())
        self._apply_tas_usage(info, +1)

    def simulate_workload_removal(
            self, infos: list[WorkloadInfo]) -> Callable[[], None]:
        """Remove only the usage (not queue membership); O(1) revert."""
        for info in infos:
            self.cluster_queues[info.cluster_queue].remove_usage(info.usage())
            self._apply_tas_usage(info, -1)

        def revert() -> None:
            for info in infos:
                self.cluster_queues[info.cluster_queue].add_usage(
                    info.usage())
                self._apply_tas_usage(info, +1)

        return revert


def build_snapshot(store: Store, device="cuda") -> Snapshot:
    """A snapshot of the store's current state. Its TAS trees use the
    BestFit profile, as the JAX package's ``build_snapshot`` does by
    default; ``device`` is where they run their fill-in counts under
    TASDeviceFillCounts."""
    forest = QuotaForest()
    forest.build(store.cluster_queues.values(), store.cohorts.values())

    tas_flavors: dict[str, TASFlavorSnapshot] = {}
    for rf in store.resource_flavors.values():
        if rf.topology_name is None:
            continue
        if not features.enabled("TopologyAwareScheduling"):
            continue
        topology = store.topologies.get(rf.topology_name)
        if topology is None:
            continue
        tas_flavors[rf.name] = build_tas_flavor_snapshot(
            topology.name, topology.levels, store.nodes.values(),
            flavor_node_labels=rf.node_labels, tolerations=rf.tolerations,
            profile_mixed=False, device=device)

    cqs: dict[str, ClusterQueueSnapshot] = {}
    snapshot = Snapshot(
        forest, cqs, dict(store.resource_flavors),
        inactive_cluster_queues=frozenset(
            name for name, cq in store.cluster_queues.items()
            if cq.stop_policy != StopPolicy.NONE),
        tas_flavors=tas_flavors)
    for name, spec in store.cluster_queues.items():
        cqs[name] = ClusterQueueSnapshot(
            spec, forest.cqs[name], snapshot,
            generation=store.cq_generation.get(name, 0))
    snapshot._node_to_cq = {id(cq.node): cq for cq in cqs.values()}

    for info in store.admitted_infos():
        if info.cluster_queue not in cqs:
            continue  # CQ deleted since admission
        snapshot.add_workload(info)
    return snapshot

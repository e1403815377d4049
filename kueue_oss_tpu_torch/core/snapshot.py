"""Per-drain scheduling snapshot over the quota forest.

A copy of the parts of ``kueue_oss_tpu/core/snapshot.py`` the drain
reads (reference: pkg/cache/scheduler/snapshot.go): the cohort forest
with admitted usage charged, and one TAS domain tree per TAS flavor
with admitted topology usage assumed. Cut from the copy: the
ClusterQueue/cohort snapshot views, workload removal and the
preemption-simulation helpers of the host scheduler.
"""

from __future__ import annotations

from kueue_oss_tpu_torch import features
from kueue_oss_tpu_torch.core.quota import QuotaForest
from kueue_oss_tpu_torch.core.store import Store
from kueue_oss_tpu_torch.core.workload_info import (
    WorkloadInfo,
    effective_per_pod_requests,
)
from kueue_oss_tpu_torch.tas.snapshot import (
    TASFlavorSnapshot,
    build_tas_flavor_snapshot,
)


class Snapshot:
    """Whole-cluster scheduling snapshot."""

    def __init__(self, forest: QuotaForest,
                 tas_flavors: dict[str, TASFlavorSnapshot]) -> None:
        self.forest = forest
        #: TAS domain trees keyed by ResourceFlavor name
        self.tas_flavors = tas_flavors

    def add_workload(self, info: WorkloadInfo) -> None:
        """Charge an admitted workload's quota usage to its CQ and assume
        the TAS domains its admission holds."""
        node = self.forest.cqs[info.cluster_queue]
        for fr, v in info.usage().items():
            node.add_usage(fr, v)
        wl = info.obj
        if wl.status.admission is None or not self.tas_flavors:
            return
        podsets = {ps.name: ps for ps in wl.podsets}
        for psa in wl.status.admission.podset_assignments:
            ta = psa.topology_assignment
            if ta is None:
                continue
            flavor = next(
                (f for f in psa.flavors.values() if f in self.tas_flavors),
                None)
            if flavor is None:
                continue
            ps = podsets.get(psa.name)
            per_pod = (effective_per_pod_requests(ps, wl.namespace)
                       if ps is not None else {})
            for dom in ta.domains:
                self.tas_flavors[flavor].add_tas_usage(dom.values, per_pod,
                                                       dom.count)


def build_snapshot(store: Store) -> Snapshot:
    """Build a snapshot from the store's current state (the drain's
    placement uses the BestFit profile, ``profile_mixed=False``, as the
    JAX package's ``build_snapshot`` does by default)."""
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
            topology.levels, store.nodes.values(),
            flavor_node_labels=rf.node_labels, profile_mixed=False)

    snapshot = Snapshot(forest, tas_flavors)
    for info in store.admitted_infos():
        if info.cluster_queue not in forest.cqs:
            continue  # CQ deleted since admission
        snapshot.add_workload(info)
    return snapshot

"""In-memory object store — the control-plane state the drain reads
and commits to.

A copy of ``kueue_oss_tpu/core/store.py`` with the same watch contract:
writers emit ``(verb, kind, obj)`` events to subscribers (the queue
manager). Cut from the copy: metrics (retained-finished gauges),
persistence hooks, ``clone`` and the conditional-write client path.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional

from kueue_oss_tpu_torch import features
from kueue_oss_tpu_torch.api.types import (
    ClusterQueue,
    Cohort,
    LocalQueue,
    Node,
    ResourceFlavor,
    Topology,
    Workload,
)

Event = tuple[str, str, object]  # (verb, kind, obj)


class Store:
    def __init__(self) -> None:
        self.cluster_queues: dict[str, ClusterQueue] = {}
        self.cohorts: dict[str, Cohort] = {}
        self.local_queues: dict[str, LocalQueue] = {}  # key "ns/name"
        self.resource_flavors: dict[str, ResourceFlavor] = {}
        self.topologies: dict[str, Topology] = {}
        self.workloads: dict[str, Workload] = {}  # key "ns/name"
        self.nodes: dict[str, Node] = {}
        self._watchers: list[Callable[[Event], None]] = []
        #: workloads currently holding quota, maintained on every write
        self._admitted: dict[str, Workload] = {}

    # -- watch -------------------------------------------------------------

    def watch(self, fn: Callable[[Event], None]) -> None:
        self._watchers.append(fn)

    def _emit(self, verb: str, kind: str, obj: object) -> None:
        for fn in self._watchers:
            fn((verb, kind, obj))

    # -- writers -----------------------------------------------------------

    def upsert_cluster_queue(self, cq: ClusterQueue) -> None:
        verb = "update" if cq.name in self.cluster_queues else "add"
        self.cluster_queues[cq.name] = cq
        self._emit(verb, "ClusterQueue", cq)

    def upsert_cohort(self, cohort: Cohort) -> None:
        if cohort.parent and not features.enabled("HierarchicalCohorts"):
            cohort = dataclasses.replace(cohort, parent=None)
        self.cohorts[cohort.name] = cohort
        self._emit("update", "Cohort", cohort)

    def upsert_local_queue(self, lq: LocalQueue) -> None:
        self.local_queues[lq.key] = lq
        self._emit("update", "LocalQueue", lq)

    def upsert_resource_flavor(self, rf: ResourceFlavor) -> None:
        self.resource_flavors[rf.name] = rf
        self._emit("update", "ResourceFlavor", rf)

    def upsert_topology(self, t: Topology) -> None:
        self.topologies[t.name] = t
        self._emit("update", "Topology", t)

    def upsert_node(self, node: Node) -> None:
        self.nodes[node.name] = node
        self._emit("update", "Node", node)

    def add_workload(self, wl: Workload) -> None:
        wl.resource_version += 1
        self.workloads[wl.key] = wl
        self._index_workload(wl)
        self._emit("add", "Workload", wl)

    def update_workload(self, wl: Workload) -> None:
        wl.resource_version += 1
        self.workloads[wl.key] = wl
        self._index_workload(wl)
        self._emit("update", "Workload", wl)

    def delete_workload(self, key: str) -> Optional[Workload]:
        wl = self.workloads.pop(key, None)
        self._admitted.pop(key, None)
        if wl is not None:
            self._emit("delete", "Workload", wl)
        return wl

    def _index_workload(self, wl: Workload) -> None:
        if wl.is_quota_reserved and not wl.is_finished:
            self._admitted[wl.key] = wl
        else:
            self._admitted.pop(wl.key, None)

    # -- readers -----------------------------------------------------------

    def cluster_queue_for(self, wl: Workload) -> Optional[str]:
        lq = self.local_queues.get(f"{wl.namespace}/{wl.queue_name}")
        return lq.cluster_queue if lq is not None else None

    def admitted_infos(self) -> list:
        """WorkloadInfo for every workload holding quota, charged to the
        CQ recorded in its admission (workload.go:299)."""
        from kueue_oss_tpu_torch.core.workload_info import WorkloadInfo

        out = []
        for wl in self._admitted.values():
            if wl.status.admission is not None:
                cq_name = wl.status.admission.cluster_queue
            else:
                cq_name = self.cluster_queue_for(wl)
                if cq_name is None:
                    continue
            out.append(WorkloadInfo(wl, cluster_queue=cq_name))
        return out

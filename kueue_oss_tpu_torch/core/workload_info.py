"""Workload domain logic: request totals, priority, queue order.

A copy of ``kueue_oss_tpu/core/workload_info.py`` (reference:
pkg/workload/workload.go). Cut from the copy: the request-shaping
config (LimitRange defaults and resource transformations, empty by
default; the port has no Configuration loader) and the flavor cursor,
which only the host scheduler reads.
"""

from __future__ import annotations

from dataclasses import dataclass, field

from kueue_oss_tpu_torch import features
from kueue_oss_tpu_torch.api.types import (
    FlavorResource,
    Workload,
    WorkloadConditionType,
)


def effective_per_pod_requests(ps, namespace: str) -> dict[str, int]:
    """Per-pod requests — the shape every accounting and placement path
    must agree on. The JAX package applies the process-wide requests
    config here (LimitRange defaults, resource transformations); its
    default is empty, and the port has no way to set one."""
    return dict(ps.requests)


@dataclass
class PodSetResources:
    """Total (count-scaled) requests of one podset plus its flavors."""

    name: str
    requests: dict[str, int] = field(default_factory=dict)
    count: int = 0
    flavors: dict[str, str] = field(default_factory=dict)

    def scaled_to(self, count: int) -> "PodSetResources":
        if self.count == 0 or count == self.count:
            return PodSetResources(self.name, dict(self.requests), self.count,
                                   dict(self.flavors))
        scaled = {r: (q // self.count) * count
                  for r, q in self.requests.items()}
        return PodSetResources(self.name, scaled, count, dict(self.flavors))


class WorkloadInfo:
    """A Workload enriched with request totals."""

    def __init__(self, obj: Workload, cluster_queue: str = "") -> None:
        self.obj = obj
        self.cluster_queue = cluster_queue
        self.total_requests: list[PodSetResources] = [
            PodSetResources(
                name=ps.name,
                requests={r: q * ps.count for r, q in
                          effective_per_pod_requests(
                              ps, obj.namespace).items()},
                count=ps.count,
            )
            for ps in obj.podsets
        ]
        adm = obj.status.admission
        if adm is not None:
            for psr in self.total_requests:
                for psa in adm.podset_assignments:
                    if psa.name == psr.name:
                        psr.flavors = dict(psa.flavors)
                        psr.requests = dict(psa.resource_usage)
                        psr.count = psa.count
        rp = obj.status.reclaimable_pods
        if rp and features.enabled("ReclaimablePods"):
            self.total_requests = [
                psr.scaled_to(max(0, psr.count - rp.get(psr.name, 0)))
                if rp.get(psr.name, 0) else psr
                for psr in self.total_requests]

    @property
    def key(self) -> str:
        return self.obj.key

    def usage(self) -> dict[FlavorResource, int]:
        """Quota usage keyed by (flavor, resource), from assigned flavors."""
        out: dict[FlavorResource, int] = {}
        for psr in self.total_requests:
            for resource, qty in psr.requests.items():
                flavor = psr.flavors.get(resource)
                if flavor is None:
                    continue
                fr = (flavor, resource)
                out[fr] = out.get(fr, 0) + qty
        return out

    def scheduling_hash(self) -> tuple:
        """Shape key of the BestEffortFIFO NoFit dedup: same podset
        shapes, priority and ClusterQueue (workload.go:227-230)."""
        podsets = {ps.name: ps for ps in self.obj.podsets}

        def ps_shape(psr: PodSetResources) -> tuple:
            ps = podsets.get(psr.name)
            topo = None
            if ps is not None and ps.topology_request is not None:
                tr = ps.topology_request
                topo = (tr.required, tr.preferred, tr.unconstrained,
                        tr.podset_group_name,
                        tr.podset_slice_required_topology,
                        tr.podset_slice_size)
            return (psr.name, psr.count,
                    ps.min_count if ps is not None else None,
                    topo, tuple(sorted(psr.requests.items())))

        return (self.cluster_queue, effective_priority(self.obj),
                self.obj.allowed_flavor,
                tuple(ps_shape(psr) for psr in self.total_requests))

    def can_be_partially_admitted(self) -> bool:
        return any(ps.min_count is not None for ps in self.obj.podsets)

    def __repr__(self) -> str:
        return f"WorkloadInfo({self.key}@{self.cluster_queue})"


#: annotation carrying an additive priority boost (gated)
PRIORITY_BOOST_ANNOTATION = "kueue.x-k8s.io/priority-boost"


def effective_priority(wl: Workload) -> int:
    """Workload priority plus the PriorityBoost annotation (gated)."""
    boost = 0
    if features.enabled("PriorityBoost"):
        raw = wl.annotations.get(PRIORITY_BOOST_ANNOTATION, "")
        if raw:
            try:
                boost = int(raw)
            except ValueError:
                boost = 0
    return wl.priority + boost


def queue_order_timestamp(wl: Workload) -> float:
    """Eviction-aware ordering timestamp (workload.Ordering)."""
    evicted = wl.status.conditions.get(WorkloadConditionType.EVICTED)
    if evicted is not None and evicted.status:
        return evicted.last_transition_time
    return wl.creation_time


def quota_reservation_time(wl: Workload, now: float) -> float:
    """When the current quota reservation was made (``now`` if none)."""
    cond = wl.status.conditions.get(WorkloadConditionType.QUOTA_RESERVED)
    if cond is None or not cond.status:
        return now
    return cond.last_transition_time

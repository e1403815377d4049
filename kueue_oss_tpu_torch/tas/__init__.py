"""Topology-aware scheduling (TAS) of the port.

A copy of ``kueue_oss_tpu/tas`` (reference: pkg/cache/scheduler/tas_*.go,
KEP-2724): places podsets onto a topology tree (e.g. block > rack >
host) honoring required/preferred/unconstrained levels, slice grouping,
leader co-location, and unhealthy-node replacement.
"""

from kueue_oss_tpu_torch.core.workload_info import effective_per_pod_requests
from kueue_oss_tpu_torch.tas.snapshot import (
    TASAssignmentResult,
    TASFlavorSnapshot,
    TASPodSetRequest,
    build_tas_flavor_snapshot,
)


def requests_from_admission(wl, cq_snapshot,
                            only_pending: bool = False):
    """Per-flavor TASPodSetRequests rebuilt from a recorded admission
    (used by the second pass, where no live Assignment object exists).
    With only_pending, limits to podsets whose DelayedTopologyRequest is
    still Pending."""
    podsets = {ps.name: ps for ps in wl.podsets}
    out: dict[str, list[TASPodSetRequest]] = {}
    if wl.status.admission is None:
        return out
    for psa in wl.status.admission.podset_assignments:
        if only_pending:
            if (psa.delayed_topology_request != "Pending"
                    or psa.topology_assignment is not None):
                continue
        elif psa.topology_assignment is None:
            continue
        ps = podsets.get(psa.name)
        if ps is None:
            continue
        tas_flavor = next((f for f in psa.flavors.values()
                           if f in cq_snapshot.tas_flavors), None)
        if tas_flavor is None:
            continue
        out.setdefault(tas_flavor, []).append(TASPodSetRequest(
            podset=ps,
            single_pod_requests=effective_per_pod_requests(
                ps, wl.namespace),
            count=psa.count,
            flavor=tas_flavor,
            implied=ps.topology_request is None,
            podset_group_name=(
                ps.topology_request.podset_group_name
                if ps.topology_request is not None else None),
        ))
    return out


__all__ = [
    "TASAssignmentResult",
    "TASFlavorSnapshot",
    "TASPodSetRequest",
    "build_tas_flavor_snapshot",
    "requests_from_admission",
]

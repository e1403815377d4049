"""Flavor assignment: map each podset resource onto a ResourceFlavor.

A copy of ``kueue_oss_tpu/scheduler/flavor_assigner.py`` (reference:
pkg/scheduler/flavorassigner/flavorassigner.go). Walks the
ClusterQueue's ordered flavor list per resource group, classifying each
flavor into a mode lattice NoFit < Preempt < Fit with a borrowing level,
honoring the FlavorFungibility early-stop policy and resuming from the
last-tried flavor cursor across cycles; taints and node selectors filter
flavors, and ``PodSetReducer`` searches reduced counts for partial
admission. After the quota assignment, the podsets that
``is_tas_requested`` and got a TAS flavor are placed on the topology
(``_update_for_tas``: Fit places with the real usage, Preempt on an
empty tree). Under QuotaCheckStrategy=IgnoreUndeclared (the
Configuration's ``resources`` section) a resource that no resource
group covers does not take part in the quota check.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional, Protocol

from kueue_oss_tpu_torch import features
from kueue_oss_tpu_torch.api.types import (
    FlavorFungibility,
    FlavorFungibilityPolicy,
    FlavorFungibilityPreference,
    FlavorResource,
    PodSet,
    PreemptionPolicyValue,
    ResourceFlavor,
    Taint,
    TopologyAssignment,
)
from kueue_oss_tpu_torch.core.snapshot import ClusterQueueSnapshot
from kueue_oss_tpu_torch.core.workload_info import (
    AssignmentClusterQueueState,
    WorkloadInfo,
    effective_per_pod_requests,
    ignore_undeclared_resources,
)
from kueue_oss_tpu_torch.tas.snapshot import TASPodSetRequest

# FlavorAssignmentMode — public lattice (flavorassigner.go:362-377).
NO_FIT = 0
PREEMPT = 1
FIT = 2
MODE_NAMES = {NO_FIT: "NoFit", PREEMPT: "Preempt", FIT: "Fit"}

# preemptionMode — internal lattice (flavorassigner.go:429-437).
P_NOFIT = 0
P_NO_CANDIDATES = 1  # preemption possible by quota, but no targets found
P_PREEMPT = 2
P_RECLAIM = 3
P_FIT = 4


def preemption_to_assignment_mode(pmode: int) -> int:
    if pmode == P_NOFIT:
        return NO_FIT
    if pmode == P_FIT:
        return FIT
    return PREEMPT


# granularMode = (preemption_mode, borrowing_level); lower borrowing level =
# quota sourced more locally = better.
GranularMode = tuple[int, int]

WORST_MODE: GranularMode = (P_NOFIT, 1 << 30)
BEST_MODE: GranularMode = (P_FIT, 0)


def is_preferred(a: GranularMode, b: GranularMode,
                 fungibility: FlavorFungibility) -> bool:
    """True if mode a beats mode b under the configured preference
    (flavorassigner.go:439-470)."""
    if a[0] == P_NOFIT:
        return False
    if b[0] == P_NOFIT:
        return True

    def borrowing_over_preemption() -> bool:
        if a[0] != b[0]:
            return a[0] > b[0]
        return a[1] < b[1]

    def preemption_over_borrowing() -> bool:
        if a[1] != b[1]:
            return a[1] < b[1]
        return a[0] > b[0]

    if fungibility.preference == FlavorFungibilityPreference.PREEMPTION_OVER_BORROWING:
        return preemption_over_borrowing()
    return borrowing_over_preemption()


def should_try_next_flavor(mode: GranularMode,
                           fungibility: FlavorFungibility) -> bool:
    """flavorassigner.go:1000-1017."""
    pmode, borrow_level = mode
    if pmode in (P_NOFIT, P_NO_CANDIDATES):
        return True
    if pmode in (P_PREEMPT, P_RECLAIM) and (
            fungibility.when_can_preempt == FlavorFungibilityPolicy.TRY_NEXT_FLAVOR):
        return True
    if borrow_level != 0 and (
            fungibility.when_can_borrow == FlavorFungibilityPolicy.TRY_NEXT_FLAVOR):
        return True
    return False


# ---------------------------------------------------------------------------
# Assignment result model
# ---------------------------------------------------------------------------


@dataclass
class FlavorAssignmentRec:
    name: str  # flavor
    mode: int  # FlavorAssignmentMode
    borrow: int = 0
    tried_flavor_idx: int = -1


@dataclass
class PodSetAssignmentResult:
    name: str
    count: int
    requests: dict[str, int] = field(default_factory=dict)
    flavors: dict[str, FlavorAssignmentRec] = field(default_factory=dict)
    reasons: list[str] = field(default_factory=list)
    topology_assignment: Optional[TopologyAssignment] = None

    def representative_mode(self) -> int:
        if self.requests and not self.flavors:
            return NO_FIT
        mode = FIT
        for rec in self.flavors.values():
            mode = min(mode, rec.mode)
        return mode

    def set_mode(self, mode: int) -> None:
        for rec in self.flavors.values():
            rec.mode = mode

    def cap_mode(self, mode: int) -> None:
        for rec in self.flavors.values():
            rec.mode = min(rec.mode, mode)


@dataclass
class Assignment:
    podsets: list[PodSetAssignmentResult] = field(default_factory=list)
    usage_quota: dict[FlavorResource, int] = field(default_factory=dict)
    last_state: Optional[AssignmentClusterQueueState] = None

    def representative_mode(self) -> int:
        if not self.podsets:
            return FIT
        return min(ps.representative_mode() for ps in self.podsets)

    def borrows(self) -> int:
        """Max borrowing level across assigned flavors (Assignment.Borrows)."""
        return max(
            (rec.borrow for ps in self.podsets for rec in ps.flavors.values()),
            default=0,
        )

    def skip_detail(self) -> dict:
        """Structured no-fit explanation for the decision flight
        recorder: the representative mode plus each podset's reason
        list, verbatim."""
        return {
            "mode": MODE_NAMES[self.representative_mode()],
            "podsets": {ps.name: list(ps.reasons)
                        for ps in self.podsets if ps.reasons},
        }

    def message(self) -> str:
        reasons = [r for ps in self.podsets for r in ps.reasons]
        return "; ".join(dict.fromkeys(reasons)) if reasons else "couldn't assign flavors"

    def podset_by_name(self, name: str) -> Optional[PodSetAssignmentResult]:
        for ps in self.podsets:
            if ps.name == name:
                return ps
        return None


# ---------------------------------------------------------------------------
# Preemption oracle protocol (implemented in scheduler.preemption)
# ---------------------------------------------------------------------------

# PreemptionPossibility values
NO_CANDIDATES = "NoCandidates"
POSSIBILITY_PREEMPT = "Preempt"
POSSIBILITY_RECLAIM = "Reclaim"


class PreemptionOracle(Protocol):
    def simulate_preemption(
        self, cq: ClusterQueueSnapshot, wl: WorkloadInfo,
        fr: FlavorResource, quantity: int,
    ) -> tuple[str, int]: ...


POSSIBILITY_TO_PMODE = {
    NO_CANDIDATES: P_NO_CANDIDATES,
    POSSIBILITY_PREEMPT: P_PREEMPT,
    POSSIBILITY_RECLAIM: P_RECLAIM,
}


# ---------------------------------------------------------------------------
# Hierarchical helpers
# ---------------------------------------------------------------------------


def _node_height(cohort) -> int:
    max_height = min(cohort.child_count(), 1)
    for child in cohort.child_cohorts():
        max_height = max(max_height, _node_height(child) + 1)
    return max_height


def find_height_of_lowest_subtree_that_fits(
    cq: ClusterQueueSnapshot, fr: FlavorResource, val: int
) -> tuple[int, bool]:
    """Height of the lowest cohort subtree that could absorb val of fr.

    Reference parity: classical/hierarchical_preemption.go:221-243. Returns
    (height, subtree_is_proper) where height doubles as the "borrowing
    level" used to rank flavors, and subtree_is_proper indicates that a
    subtree smaller than the whole hierarchy fits (hierarchical reclaim is
    possible).
    """
    if not cq.borrowing_with(fr, val) or not cq.has_parent():
        return 0, cq.has_parent()
    remaining = val - cq.node.local_available(fr)
    for tracking in cq.path_parent_to_root():
        if not tracking.borrowing_with(fr, remaining):
            return _node_height(tracking), tracking.has_parent()
        remaining -= tracking.node.local_available(fr)
    return _node_height(cq.parent().root()), False


# ---------------------------------------------------------------------------
# Flavor ↔ podset compatibility (taints / node selector)
# ---------------------------------------------------------------------------


def _untolerated_taint(podset: PodSet, flavor: ResourceFlavor) -> Optional[Taint]:
    tolerations = list(podset.tolerations) + list(flavor.tolerations)
    for taint in flavor.node_taints:
        if taint.effect not in ("NoSchedule", "NoExecute"):
            continue
        if not any(t.tolerates(taint) for t in tolerations):
            return taint
    return None


def _selector_matches(podset: PodSet, flavor: ResourceFlavor,
                      allowed_keys: frozenset[str]) -> bool:
    """Node-selector subset match against the flavor's node labels,
    restricted to keys the resource group's flavors define
    (flavorassigner.go flavorSelector)."""
    for k, v in podset.node_selector.items():
        if k in allowed_keys and flavor.node_labels.get(k) != v:
            return False
    return True


# ---------------------------------------------------------------------------
# TAS helpers (reference: flavorassigner/tas_flavorassigner.go)
# ---------------------------------------------------------------------------


def is_tas_requested(podset: PodSet, cq: ClusterQueueSnapshot) -> bool:
    """Explicit topology request, or implied because the CQ is TAS-only
    (tas_flavorassigner.go:216-225)."""
    return podset.topology_request is not None or cq.is_tas_only()


def tas_flavor_mismatch(podset: PodSet, flavor: ResourceFlavor,
                        cq: ClusterQueueSnapshot) -> Optional[str]:
    """checkPodSetAndFlavorMatchForTAS (tas_flavorassigner.go:170-208)."""
    if is_tas_requested(podset, cq):
        if podset.topology_request is None and cq.is_tas_only():
            return None  # implied: every flavor in the CQ is a TAS flavor
        if flavor.topology_name is None:
            return (f"flavor {flavor.name} does not support "
                    "TopologyAwareScheduling")
        snap = cq.tas_flavors.get(flavor.name)
        if snap is None:
            return f"flavor {flavor.name} information missing in TAS cache"
        if not snap.has_level(podset):
            return (f"flavor {flavor.name} does not contain the requested "
                    "topology level")
        return None
    if flavor.topology_name is not None:
        return f"flavor {flavor.name} supports only TopologyAwareScheduling"
    return None


def workload_topology_requests(
    wl: WorkloadInfo, cq: ClusterQueueSnapshot, assignment: Assignment
) -> dict[str, list[TASPodSetRequest]]:
    """Per-flavor TAS placement requests for a quota-assigned workload
    (Assignment.WorkloadsTopologyRequests, tas_flavorassigner.go:40-84)."""
    out: dict[str, list[TASPodSetRequest]] = {}
    for ps in wl.obj.podsets:
        if not is_tas_requested(ps, cq):
            continue
        psa = assignment.podset_by_name(ps.name)
        if psa is None or not psa.flavors or psa.count == 0:
            continue
        tas_flavor = next(
            (rec.name for rec in psa.flavors.values()
             if rec.name in cq.tas_flavors), None)
        if tas_flavor is None:
            psa.reasons.append("no TAS flavor assigned")
            continue
        out.setdefault(tas_flavor, []).append(TASPodSetRequest(
            podset=ps,
            single_pod_requests=effective_per_pod_requests(
                ps, wl.obj.namespace),
            count=psa.count,
            flavor=tas_flavor,
            implied=ps.topology_request is None,
            podset_group_name=(
                ps.topology_request.podset_group_name
                if ps.topology_request is not None else None),
        ))
    return out


def update_for_tas_result(assignment: Assignment, result: dict) -> None:
    """Attach successful topology assignments to their podsets
    (Assignment.UpdateForTASResult, flavorassigner.go:81-92)."""
    for name, res in result.items():
        psa = assignment.podset_by_name(name)
        if psa is not None and res.assignment is not None:
            psa.topology_assignment = res.assignment


# ---------------------------------------------------------------------------
# The assigner
# ---------------------------------------------------------------------------


class FlavorAssigner:
    def __init__(
        self,
        wl: WorkloadInfo,
        cq: ClusterQueueSnapshot,
        resource_flavors: dict[str, ResourceFlavor],
        oracle: PreemptionOracle,
        enable_fair_sharing: bool = False,
    ) -> None:
        self.wl = wl
        self.cq = cq
        self.resource_flavors = resource_flavors
        self.oracle = oracle
        self.enable_fair_sharing = enable_fair_sharing
        if (wl.last_assignment is not None
                and wl.last_assignment.cluster_queue_generation != cq.generation):
            wl.last_assignment = None  # cursor outdated (flavorassigner.go:571)

    def assign(self, counts: Optional[list[int]] = None) -> Assignment:
        """Compute flavor assignment for all podsets (optionally scaled)."""
        requests = [
            psr if counts is None else psr.scaled_to(counts[i])
            for i, psr in enumerate(self.wl.total_requests)
        ]
        assignment = Assignment(
            last_state=AssignmentClusterQueueState(
                cluster_queue_generation=self.cq.generation),
        )

        # Group podsets that must share flavor choices (TAS podset groups).
        groups: dict[str, list[int]] = {}
        for i, ps in enumerate(self.wl.obj.podsets):
            key = str(i)
            tr = ps.topology_request
            if tr is not None and tr.podset_group_name:
                key = f"group/{tr.podset_group_name}"
            groups.setdefault(key, []).append(i)

        for ps_ids in groups.values():
            group_requests: dict[str, int] = {}
            for i in ps_ids:
                for r, q in requests[i].requests.items():
                    group_requests[r] = group_requests.get(r, 0) + q

            group_flavors: dict[str, FlavorAssignmentRec] = {}
            group_reasons: list[str] = []
            failed = False
            for res in group_requests:
                if self.cq.rg_by_resource(res) is None:
                    if group_requests[res] == 0:
                        continue
                    if ignore_undeclared_resources():
                        # QuotaCheckStrategy=IgnoreUndeclared: the
                        # resource simply doesn't participate in quota
                        continue
                    group_reasons.append(
                        f"resource {res} unavailable in ClusterQueue")
                    failed = True
                    break
                if res in group_flavors:
                    continue
                flavors, reasons = self._find_flavor_for_podsets(
                    ps_ids, group_requests, res, assignment.usage_quota)
                group_reasons.extend(reasons)
                if not flavors:
                    failed = True
                    break
                group_flavors.update(flavors)

            for i in ps_ids:
                psa = PodSetAssignmentResult(
                    name=requests[i].name,
                    count=requests[i].count,
                    requests=dict(requests[i].requests),
                    reasons=list(group_reasons),
                )
                if not failed:
                    psa.flavors = {
                        r: group_flavors[r]
                        for r in requests[i].requests
                        if r in group_flavors
                    }
                self._append(assignment, psa, i)
            if failed:
                return assignment
        self._update_for_tas(assignment)
        return assignment

    def _update_for_tas(self, assignment: Assignment) -> None:
        """Topology placement after quota assignment (flavorassigner.go
        assignFlavors TAS tail, :733-765).

        Fit: place with real usage; a placement failure downgrades the
        failing podset to Preempt. Preempt (not node-replacement): place
        on an empty cluster; failure means NoFit even after preempting
        everything, success keeps the TAS podsets at Preempt because
        the free quota may be fragmented across domains.
        """
        if assignment.representative_mode() == NO_FIT:
            return
        tas_requests = workload_topology_requests(self.wl, self.cq, assignment)
        if not tas_requests:
            return
        if assignment.representative_mode() == FIT:
            result = self.cq.find_topology_assignments_for_workload(
                tas_requests, workload=self.wl.obj)
            failed = False
            for name, res in result.items():
                if res.failure:
                    psa = assignment.podset_by_name(name)
                    if psa is not None:
                        psa.reasons.append(res.failure)
                        psa.set_mode(PREEMPT)
                    failed = True
                    break
            if not failed:
                update_for_tas_result(assignment, result)
        if (assignment.representative_mode() == PREEMPT
                and not self.wl.obj.status.unhealthy_nodes):
            result = self.cq.find_topology_assignments_for_workload(
                tas_requests, simulate_empty=True)
            for name, res in result.items():
                if res.failure:
                    psa = assignment.podset_by_name(name)
                    if psa is not None:
                        psa.reasons.append(res.failure)
                        psa.set_mode(NO_FIT)
                    return
            for requests in tas_requests.values():
                for tr in requests:
                    psa = assignment.podset_by_name(tr.podset.name)
                    if psa is not None:
                        psa.cap_mode(PREEMPT)

    def _append(self, assignment: Assignment,
                psa: PodSetAssignmentResult, ps_idx: int) -> None:
        assignment.podsets.append(psa)
        cursor: dict[str, int] = {}
        for res, rec in psa.flavors.items():
            fr = (rec.name, res)
            assignment.usage_quota[fr] = (
                assignment.usage_quota.get(fr, 0) + psa.requests.get(res, 0))
            cursor[res] = rec.tried_flavor_idx
        ls = assignment.last_state
        assert ls is not None
        while len(ls.last_tried_flavor_idx) <= ps_idx:
            ls.last_tried_flavor_idx.append({})
        ls.last_tried_flavor_idx[ps_idx] = cursor

    def _find_flavor_for_podsets(
        self,
        ps_ids: list[int],
        requests: dict[str, int],
        res_name: str,
        assignment_usage: dict[FlavorResource, int],
    ) -> tuple[dict[str, FlavorAssignmentRec], list[str]]:
        rg = self.cq.rg_by_resource(res_name)
        assert rg is not None
        reasons: list[str] = []
        covered = {r: v for r, v in requests.items()
                   if r in rg.covered_resources}
        allowed_keys = frozenset(
            k
            for fq in rg.flavors
            for k in self.resource_flavors.get(
                fq.name, ResourceFlavor(name=fq.name)).node_labels
        )

        # gate FlavorFungibility: when off, custom fungibility policies
        # are ignored and the default (Borrow / TryNextFlavor) applies
        fungibility = (self.cq.spec.flavor_fungibility
                       if features.enabled("FlavorFungibility")
                       else FlavorFungibility())
        best: dict[str, FlavorAssignmentRec] = {}
        best_mode = WORST_MODE
        num_flavors = len(rg.flavors)

        start = 0
        if self.wl.last_assignment is not None:
            start = self.wl.last_assignment.next_flavor_to_try(
                ps_ids[0], res_name)
        attempted_idx = -1
        for idx in range(start, num_flavors):
            attempted_idx = idx
            f_name = rg.flavors[idx].name
            # A concurrent-admission variant is pinned to its flavor
            # (reference: WorkloadAllowedResourceFlavorAnnotation,
            # flavorassigner IsFlavorAllowedForVariant check).
            if (self.wl.obj.allowed_flavor is not None
                    and f_name != self.wl.obj.allowed_flavor):
                reasons.append(
                    f"flavor {f_name} not allowed for this variant")
                continue
            flavor = self.resource_flavors.get(f_name)
            if flavor is None:
                reasons.append(f"flavor {f_name} not found")
                continue

            flavor_ok = True
            for psid in ps_ids:
                ps = self.wl.obj.podsets[psid]
                taint = _untolerated_taint(ps, flavor)
                if taint is not None:
                    reasons.append(
                        f"untolerated taint {taint.key} in flavor {f_name}")
                    flavor_ok = False
                    break
                if not _selector_matches(ps, flavor, allowed_keys):
                    reasons.append(
                        f"flavor {f_name} doesn't match node affinity")
                    flavor_ok = False
                    break
                tas_reason = tas_flavor_mismatch(ps, flavor, self.cq)
                if tas_reason is not None:
                    reasons.append(tas_reason)
                    flavor_ok = False
                    break
            if not flavor_ok:
                continue

            assignments: dict[str, FlavorAssignmentRec] = {}
            representative = BEST_MODE
            for r_name, val in covered.items():
                fr = (f_name, r_name)
                pmode, borrow, why = self._fits_resource_quota(
                    fr, assignment_usage.get(fr, 0), val)
                if why:
                    reasons.extend(why)
                mode: GranularMode = (pmode, borrow)
                if is_preferred(representative, mode, fungibility):
                    representative = mode
                if representative[0] == P_NOFIT:
                    break
                assignments[r_name] = FlavorAssignmentRec(
                    name=f_name,
                    mode=preemption_to_assignment_mode(pmode),
                    borrow=borrow,
                )

            if not should_try_next_flavor(
                    representative, fungibility):
                best = assignments
                best_mode = representative
                break
            if is_preferred(representative, best_mode,
                            fungibility):
                best = assignments
                best_mode = representative

        for rec in best.values():
            rec.tried_flavor_idx = (
                -1 if attempted_idx == num_flavors - 1 else attempted_idx)
        return best, reasons

    def _fits_resource_quota(
        self, fr: FlavorResource, assumed: int, request: int
    ) -> tuple[int, int, list[str]]:
        """Classify one (flavor, resource) into the preemption-mode lattice.

        Reference parity: flavorassigner.go:1071-1108.
        """
        available = self.cq.available(fr)
        max_capacity = self.cq.potential_available(fr)
        val = assumed + request

        if val > max_capacity:
            return P_NOFIT, 0, [
                f"insufficient quota for {fr[1]} in flavor {fr[0]}, request "
                f"{val} > maximum capacity {max_capacity}"]

        borrow, may_reclaim = find_height_of_lowest_subtree_that_fits(
            self.cq, fr, val)
        if val <= available:
            return P_FIT, borrow, []

        reasons = [
            f"insufficient unused quota for {fr[1]} in flavor {fr[0]}, "
            f"{val - available} more needed"]
        nominal = self.cq.quota_for(fr).nominal
        if val <= nominal or may_reclaim or self._can_preempt_while_borrowing():
            possibility, borrow_after = self.oracle.simulate_preemption(
                self.cq, self.wl, fr, val)
            return POSSIBILITY_TO_PMODE[possibility], borrow_after, reasons
        return P_NOFIT, borrow, reasons

    def _can_preempt_while_borrowing(self) -> bool:
        preemption = self.cq.spec.preemption
        return (
            preemption.borrow_within_cohort.policy != PreemptionPolicyValue.NEVER
            or (self.enable_fair_sharing
                and preemption.reclaim_within_cohort != PreemptionPolicyValue.NEVER)
        )


class PodSetReducer:
    """Binary search over reduced pod counts for partial admission.

    Reference parity: flavorassigner/podset_reducer.go (KEP-420) — searches
    the largest total count, interpolating each podset between min_count and
    count, for which the probe function succeeds.
    """

    def __init__(self, podsets: list[PodSet], probe) -> None:
        self.podsets = podsets
        self.probe = probe

    def _counts_for(self, step: int, max_steps: int) -> list[int]:
        out = []
        for ps in self.podsets:
            lo = ps.min_count if ps.min_count is not None else ps.count
            out.append(ps.count - ((ps.count - lo) * step) // max_steps)
        return out

    def search(self):
        max_steps = max(
            (ps.count - (ps.min_count if ps.min_count is not None else ps.count)
             for ps in self.podsets),
            default=0,
        )
        if max_steps == 0:
            return None, False
        # Find smallest step (largest counts) that fits: binary search over
        # the monotone predicate probe(counts(step)).
        lo, hi = 1, max_steps
        best = None
        while lo <= hi:
            mid = (lo + hi) // 2
            result, ok = self.probe(self._counts_for(mid, max_steps))
            if ok:
                best = result
                hi = mid - 1
            else:
                lo = mid + 1
        return best, best is not None

"""API object model: the subset the TAS solver drain touches.

A copy of ``kueue_oss_tpu/api/types.py`` restricted to the objects the
drain reads or writes (reference: apis/kueue/v1beta2/*_types.go). Field
names and defaults are the JAX package's, so the same store builder
works against either package. Quantities are plain integers in
canonical units. Fair-sharing weights and admission scopes (AFS) are
carried so that a store can state them; the port's drain refuses a
backlog that needs either. Cut from the copy: node taints, priority
classes, admission-check objects, MultiKueue and workload-slicing
fields.
"""

from __future__ import annotations

import itertools
from dataclasses import dataclass, field
from typing import Optional

#: (flavor_name, resource_name) — the key of every quota/usage map.
FlavorResource = tuple[str, str]


class QueueingStrategy:
    STRICT_FIFO = "StrictFIFO"
    BEST_EFFORT_FIFO = "BestEffortFIFO"


class StopPolicy:
    NONE = "None"
    HOLD = "Hold"
    HOLD_AND_DRAIN = "HoldAndDrain"


class PreemptionPolicyValue:
    NEVER = "Never"
    LOWER_PRIORITY = "LowerPriority"
    LOWER_OR_NEWER_EQUAL_PRIORITY = "LowerOrNewerEqualPriority"
    ANY = "Any"


@dataclass
class BorrowWithinCohort:
    policy: str = PreemptionPolicyValue.NEVER
    max_priority_threshold: Optional[int] = None


@dataclass
class PreemptionPolicy:
    within_cluster_queue: str = PreemptionPolicyValue.NEVER
    reclaim_within_cohort: str = PreemptionPolicyValue.NEVER
    borrow_within_cohort: BorrowWithinCohort = field(
        default_factory=BorrowWithinCohort)

    @property
    def any_enabled(self) -> bool:
        return (self.within_cluster_queue != PreemptionPolicyValue.NEVER
                or self.reclaim_within_cohort != PreemptionPolicyValue.NEVER)


class FlavorFungibilityPolicy:
    BORROW = "Borrow"
    PREEMPT = "Preempt"
    TRY_NEXT_FLAVOR = "TryNextFlavor"


class FlavorFungibilityPreference:
    BORROWING_OVER_PREEMPTION = "BorrowingOverPreemption"
    PREEMPTION_OVER_BORROWING = "PreemptionOverBorrowing"


@dataclass
class FairSharing:
    weight: float = 1.0


@dataclass
class AdmissionScope:
    admission_mode: str = "UsageBasedAdmissionFairSharing"


@dataclass
class FlavorFungibility:
    when_can_borrow: str = FlavorFungibilityPolicy.BORROW
    when_can_preempt: str = FlavorFungibilityPolicy.TRY_NEXT_FLAVOR
    preference: Optional[str] = None


@dataclass
class AdmissionCheckStrategyRule:
    name: str
    on_flavors: list[str] = field(default_factory=list)


@dataclass
class AdmissionChecksStrategy:
    admission_checks: list[AdmissionCheckStrategyRule] = field(
        default_factory=list)


# ---------------------------------------------------------------------------
# ResourceFlavor / Topology / Node
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class Taint:
    key: str
    value: str = ""
    effect: str = "NoSchedule"


@dataclass(frozen=True)
class Toleration:
    key: str = ""
    operator: str = "Equal"
    value: str = ""
    effect: str = ""

    def tolerates(self, taint: Taint) -> bool:
        if self.effect and self.effect != taint.effect:
            return False
        if not self.key:
            return self.operator == "Exists"
        if self.key != taint.key:
            return False
        if self.operator == "Exists":
            return True
        return self.value == taint.value


@dataclass
class ResourceFlavor:
    name: str
    node_labels: dict[str, str] = field(default_factory=dict)
    node_taints: list[Taint] = field(default_factory=list)
    tolerations: list[Toleration] = field(default_factory=list)
    #: Topology enabling TAS for this flavor (KEP-2724)
    topology_name: Optional[str] = None


@dataclass
class Topology:
    """Ordered levels, broadest first."""

    name: str
    levels: list[str] = field(default_factory=list)


#: label key marking the host level of a topology
HOSTNAME_LABEL = "kubernetes.io/hostname"


@dataclass
class Node:
    name: str
    labels: dict[str, str] = field(default_factory=dict)
    #: allocatable capacity in canonical units; "pods" defaults to 110
    allocatable: dict[str, int] = field(default_factory=dict)
    ready: bool = True

    def __post_init__(self) -> None:
        self.labels.setdefault(HOSTNAME_LABEL, self.name)
        self.allocatable.setdefault("pods", 110)


# ---------------------------------------------------------------------------
# Quota model
# ---------------------------------------------------------------------------


@dataclass
class ResourceQuota:
    name: str
    nominal: int = 0
    borrowing_limit: Optional[int] = None
    lending_limit: Optional[int] = None


@dataclass
class FlavorQuotas:
    name: str
    resources: list[ResourceQuota] = field(default_factory=list)


@dataclass
class ResourceGroup:
    covered_resources: list[str] = field(default_factory=list)
    flavors: list[FlavorQuotas] = field(default_factory=list)


def iter_quotas(resource_groups: list[ResourceGroup]):
    """Yield ((flavor, resource), ResourceQuota) across resource groups."""
    for rg in resource_groups:
        for fq in rg.flavors:
            for rq in fq.resources:
                yield (fq.name, rq.name), rq


@dataclass
class ClusterQueue:
    name: str
    cohort: Optional[str] = None
    resource_groups: list[ResourceGroup] = field(default_factory=list)
    queueing_strategy: str = QueueingStrategy.BEST_EFFORT_FIFO
    preemption: PreemptionPolicy = field(default_factory=PreemptionPolicy)
    flavor_fungibility: FlavorFungibility = field(
        default_factory=FlavorFungibility)
    fair_sharing: FairSharing = field(default_factory=FairSharing)
    admission_scope: Optional[AdmissionScope] = None
    admission_checks: list[str] = field(default_factory=list)
    admission_checks_strategy: Optional[AdmissionChecksStrategy] = None
    stop_policy: str = StopPolicy.NONE

    def checks_for_flavors(self, flavors) -> list[str]:
        """Effective admission checks for an assignment using
        ``flavors`` (plain checks always; strategy rules when onFlavors
        is empty or intersects the assignment)."""
        names = list(self.admission_checks)
        if self.admission_checks_strategy is not None:
            fset = None if flavors is None else set(flavors)
            for rule in self.admission_checks_strategy.admission_checks:
                if rule.name in names:
                    continue
                if (fset is None or not rule.on_flavors
                        or fset & set(rule.on_flavors)):
                    names.append(rule.name)
        return names


@dataclass
class Cohort:
    name: str
    parent: Optional[str] = None
    resource_groups: list[ResourceGroup] = field(default_factory=list)
    fair_sharing: FairSharing = field(default_factory=FairSharing)


@dataclass
class LocalQueue:
    name: str
    namespace: str = "default"
    cluster_queue: str = ""
    stop_policy: str = StopPolicy.NONE

    @property
    def key(self) -> str:
        return f"{self.namespace}/{self.name}"


# ---------------------------------------------------------------------------
# Workload
# ---------------------------------------------------------------------------


@dataclass
class PodSetSliceConstraint:
    topology: str = ""
    size: int = 1


@dataclass
class PodSetTopologyRequest:
    required: Optional[str] = None
    preferred: Optional[str] = None
    unconstrained: bool = False
    podset_group_name: Optional[str] = None
    podset_slice_required_topology: Optional[str] = None
    podset_slice_size: Optional[int] = None
    podset_slice_constraints: list[PodSetSliceConstraint] = field(
        default_factory=list)


@dataclass
class PodSet:
    name: str = "main"
    count: int = 1
    #: per-pod requests in canonical units
    requests: dict[str, int] = field(default_factory=dict)
    #: minimum acceptable count for partial admission; None disables
    min_count: Optional[int] = None
    topology_request: Optional[PodSetTopologyRequest] = None
    node_selector: dict[str, str] = field(default_factory=dict)
    tolerations: list[Toleration] = field(default_factory=list)


class WorkloadConditionType:
    QUOTA_RESERVED = "QuotaReserved"
    ADMITTED = "Admitted"
    EVICTED = "Evicted"
    PREEMPTED = "Preempted"
    FINISHED = "Finished"
    PODS_READY = "PodsReady"


@dataclass
class Condition:
    type: str
    status: bool
    reason: str = ""
    message: str = ""
    last_transition_time: float = 0.0


@dataclass
class TopologyDomainAssignment:
    values: list[str] = field(default_factory=list)
    count: int = 0


@dataclass
class TopologyAssignment:
    levels: list[str] = field(default_factory=list)
    domains: list[TopologyDomainAssignment] = field(default_factory=list)


@dataclass
class PodSetAssignment:
    name: str
    #: resource -> flavor name chosen for it
    flavors: dict[str, str] = field(default_factory=dict)
    resource_usage: dict[str, int] = field(default_factory=dict)
    count: int = 0
    topology_assignment: Optional[TopologyAssignment] = None


@dataclass
class Admission:
    cluster_queue: str
    podset_assignments: list[PodSetAssignment] = field(default_factory=list)

    def assigned_flavors(self) -> set:
        return {f for psa in self.podset_assignments
                for f in psa.flavors.values()}


class CheckState:
    PENDING = "Pending"


@dataclass
class AdmissionCheckState:
    name: str
    state: str = CheckState.PENDING
    message: str = ""


@dataclass
class RequeueState:
    count: int = 0
    requeue_at: Optional[float] = None


@dataclass
class WorkloadSchedulingStatsEviction:
    reason: str
    underlying_cause: str = ""
    count: int = 0


@dataclass
class WorkloadStatus:
    conditions: dict[str, Condition] = field(default_factory=dict)
    admission: Optional[Admission] = None
    admission_checks: dict[str, AdmissionCheckState] = field(
        default_factory=dict)
    requeue_state: Optional[RequeueState] = None
    eviction_stats: list[WorkloadSchedulingStatsEviction] = field(
        default_factory=list)
    unhealthy_nodes: list[str] = field(default_factory=list)
    reclaimable_pods: dict[str, int] = field(default_factory=dict)


_uid_counter = itertools.count(1)


@dataclass
class Workload:
    name: str
    namespace: str = "default"
    queue_name: str = ""
    priority: int = 0
    annotations: dict[str, str] = field(default_factory=dict)
    podsets: list[PodSet] = field(default_factory=list)
    active: bool = True
    creation_time: float = 0.0
    uid: int = 0
    ca_parent: bool = False
    allowed_flavor: Optional[str] = None
    resource_version: int = 0
    status: WorkloadStatus = field(default_factory=WorkloadStatus)

    def __post_init__(self) -> None:
        if self.uid == 0:
            self.uid = next(_uid_counter)
        if not self.podsets:
            self.podsets = [PodSet()]

    @property
    def key(self) -> str:
        return f"{self.namespace}/{self.name}"

    def has_condition(self, ctype: str) -> bool:
        c = self.status.conditions.get(ctype)
        return c is not None and c.status

    def set_condition(self, ctype: str, status: bool, reason: str = "",
                      message: str = "", now: float = 0.0) -> None:
        # last_transition_time only moves when the status flips
        prev = self.status.conditions.get(ctype)
        if prev is not None and prev.status == status:
            now = prev.last_transition_time
        self.status.conditions[ctype] = Condition(
            type=ctype, status=status, reason=reason, message=message,
            last_transition_time=now)

    @property
    def is_quota_reserved(self) -> bool:
        return self.has_condition(WorkloadConditionType.QUOTA_RESERVED)

    @property
    def is_admitted(self) -> bool:
        return self.has_condition(WorkloadConditionType.ADMITTED)

    @property
    def is_finished(self) -> bool:
        return self.has_condition(WorkloadConditionType.FINISHED)

    @property
    def is_evicted(self) -> bool:
        return self.has_condition(WorkloadConditionType.EVICTED)

"""Preemption target search: classical heuristic and fair-sharing (DRS).

A copy of ``kueue_oss_tpu/scheduler/preemption.py``, whole. Reference
parity: pkg/scheduler/preemption/{preemption.go,
classical/candidate_generator.go, classical/hierarchical_preemption.go,
fairsharing/*}. The classical path removes candidates from the snapshot in
a legality-and-priority order until the preemptor fits, then greedily adds
back; the fair path runs a DRS tournament over the cohort tree applying the
configured strategy rules (S2-a LessThanOrEqualToFinalShare, S2-b
LessThanInitialShare). The reason constants and ``_VARIANT_REASON``
also name the Preempted condition of the FULL drain's victims
(``solver/engine.py``).
"""

from __future__ import annotations

import functools
from dataclasses import dataclass
from typing import Iterator, Optional

from kueue_oss_tpu_torch import features

from kueue_oss_tpu_torch.api.types import (
    FlavorResource,
    PreemptionPolicyValue,
    Workload,
)
from kueue_oss_tpu_torch.core.quota import DRS, compare_drs, negative_drs
from kueue_oss_tpu_torch.core.snapshot import (
    ClusterQueueSnapshot,
    CohortSnapshot,
    Snapshot,
)
from kueue_oss_tpu_torch.core.workload_info import (
    WorkloadInfo,
    effective_priority,
    queue_order_timestamp,
    quota_reservation_time,
)
from kueue_oss_tpu_torch.scheduler import flavor_assigner as fa

# Preemption reasons (reference: workload_types.go reason constants).
IN_CLUSTER_QUEUE = "InClusterQueue"
IN_COHORT_RECLAMATION = "InCohortReclamation"
IN_COHORT_FAIR_SHARING = "InCohortFairSharing"
IN_COHORT_RECLAIM_WHILE_BORROWING = "InCohortReclaimWhileBorrowing"

# preemptionVariant (classical/candidate_generator.go)
V_NEVER = 0
V_WITHIN_CQ = 1
V_HIERARCHICAL_RECLAIM = 2
V_RECLAIM_WITHOUT_BORROWING = 3
V_RECLAIM_WHILE_BORROWING = 4

_VARIANT_REASON = {
    V_WITHIN_CQ: IN_CLUSTER_QUEUE,
    V_HIERARCHICAL_RECLAIM: IN_COHORT_RECLAMATION,
    V_RECLAIM_WITHOUT_BORROWING: IN_COHORT_RECLAMATION,
    V_RECLAIM_WHILE_BORROWING: IN_COHORT_RECLAIM_WHILE_BORROWING,
}


@dataclass
class Target:
    info: WorkloadInfo
    reason: str
    cq: ClusterQueueSnapshot


# ---------------------------------------------------------------------------
# Legality & ordering
# ---------------------------------------------------------------------------


#: same-priority preemption timestamp gap under the gate
#: (preemption_policy.go:30 timestampPreemptionBuffer)
TIMESTAMP_PREEMPTION_BUFFER_S = 300.0


def satisfies_preemption_policy(preemptor: Workload, candidate: Workload,
                                policy: str) -> bool:
    """common/preemption_policy.go SatisfiesPreemptionPolicy."""
    lower_priority = effective_priority(preemptor) > effective_priority(candidate)
    if policy == PreemptionPolicyValue.LOWER_PRIORITY:
        return lower_priority
    if policy == PreemptionPolicyValue.LOWER_OR_NEWER_EQUAL_PRIORITY:
        newer_equal = (
            effective_priority(preemptor) == effective_priority(candidate)
            and queue_order_timestamp(preemptor) < queue_order_timestamp(candidate)
        )
        if newer_equal and features.enabled(
                "SchedulerTimestampPreemptionBuffer"):
            # a marginally-newer equal-priority candidate is spared:
            # the gap must exceed the buffer (preemption_policy.go:44)
            newer_equal = (
                queue_order_timestamp(candidate)
                - queue_order_timestamp(preemptor)
                > TIMESTAMP_PREEMPTION_BUFFER_S)
        return lower_priority or newer_equal
    return policy == PreemptionPolicyValue.ANY


def candidates_ordering(a: WorkloadInfo, b: WorkloadInfo, cq_name: str,
                        now: float) -> int:
    """common/ordering.go CandidatesOrdering: evicted first, other-CQ first,
    lower priority first, more recently admitted first."""
    a_evicted, b_evicted = a.obj.is_evicted, b.obj.is_evicted
    if a_evicted != b_evicted:
        return -1 if a_evicted else 1
    a_same, b_same = a.cluster_queue == cq_name, b.cluster_queue == cq_name
    if a_same != b_same:
        return 1 if a_same else -1
    pa, pb = effective_priority(a.obj), effective_priority(b.obj)
    if pa != pb:
        return -1 if pa < pb else 1
    ta = quota_reservation_time(a.obj, now)
    tb = quota_reservation_time(b.obj, now)
    if ta != tb:
        return 1 if ta < tb else -1  # more recently admitted first
    return -1 if a.obj.uid < b.obj.uid else (1 if a.obj.uid > b.obj.uid else 0)


def _sort_candidates(cands: list["_CandidateElem"], cq_name: str,
                     now: float) -> None:
    cands.sort(key=functools.cmp_to_key(
        lambda x, y: candidates_ordering(x.wl, y.wl, cq_name, now)))


def workload_uses_resources(wl: WorkloadInfo,
                            frs: set[FlavorResource]) -> bool:
    for psr in wl.total_requests:
        for res, flv in psr.flavors.items():
            if (flv, res) in frs:
                return True
    return False


# ---------------------------------------------------------------------------
# Classical candidate generation (hierarchical)
# ---------------------------------------------------------------------------


@dataclass
class _CandidateElem:
    wl: WorkloadInfo
    lca: Optional[CohortSnapshot]
    variant: int


class _HierarchicalCtx:
    def __init__(self, wl: WorkloadInfo, cq: ClusterQueueSnapshot,
                 frs_need_preemption: set[FlavorResource],
                 requests: dict[FlavorResource, int]) -> None:
        self.wl = wl
        self.cq = cq
        self.frs = frs_need_preemption
        self.requests = requests


def is_borrowing_within_cohort_forbidden(
        cq: ClusterQueueSnapshot) -> tuple[bool, Optional[int]]:
    bwc = cq.spec.preemption.borrow_within_cohort
    if bwc.policy == PreemptionPolicyValue.NEVER:
        return True, None
    return False, bwc.max_priority_threshold


def _classify_variant(ctx: _HierarchicalCtx, wl: WorkloadInfo,
                      hierarchical_advantage: bool) -> int:
    if not workload_uses_resources(wl, ctx.frs):
        return V_NEVER
    if wl.cluster_queue == ctx.cq.name:
        policy = ctx.cq.spec.preemption.within_cluster_queue
    else:
        policy = ctx.cq.spec.preemption.reclaim_within_cohort
    if not satisfies_preemption_policy(ctx.wl.obj, wl.obj, policy):
        return V_NEVER
    if wl.cluster_queue == ctx.cq.name:
        return V_WITHIN_CQ
    if hierarchical_advantage:
        return V_HIERARCHICAL_RECLAIM
    forbidden, threshold = is_borrowing_within_cohort_forbidden(ctx.cq)
    if forbidden:
        return V_RECLAIM_WITHOUT_BORROWING
    cand_pri = effective_priority(wl.obj)
    inc_pri = effective_priority(ctx.wl.obj)
    if _above_borrowing_threshold(cand_pri, inc_pri, threshold):
        return V_RECLAIM_WITHOUT_BORROWING
    return V_RECLAIM_WHILE_BORROWING


def _above_borrowing_threshold(cand_pri: int, inc_pri: int,
                               threshold: Optional[int]) -> bool:
    if cand_pri >= inc_pri:
        return True
    if threshold is None:
        return False
    return cand_pri > threshold


def _candidates_from_cq(cq: ClusterQueueSnapshot, lca: Optional[CohortSnapshot],
                        ctx: _HierarchicalCtx,
                        hierarchical_advantage: bool) -> list[_CandidateElem]:
    out = []
    for wl in cq.workloads.values():
        variant = _classify_variant(ctx, wl, hierarchical_advantage)
        if variant != V_NEVER:
            out.append(_CandidateElem(wl, lca, variant))
    return out


def _quantities_fit_in_quota(node, requests: dict[FlavorResource, int]):
    """resource_node.go QuantitiesFitInQuota."""
    fits = True
    remaining = {}
    for fr, v in requests.items():
        if node.usage.get(fr, 0) + v > node.subtree_quota.get(fr, 0):
            fits = False
        remaining[fr] = max(0, v - node.local_available(fr))
    return fits, remaining


def _collect_hierarchical_candidates(
        ctx: _HierarchicalCtx) -> tuple[list[_CandidateElem], list[_CandidateElem]]:
    """hierarchical_preemption.go collectCandidatesForHierarchicalReclaim."""
    hierarchy_cands: list[_CandidateElem] = []
    priority_cands: list[_CandidateElem] = []
    if (not ctx.cq.has_parent()
            or ctx.cq.spec.preemption.reclaim_within_cohort
            == PreemptionPolicyValue.NEVER):
        return hierarchy_cands, priority_cands
    prev_subtree: Optional[CohortSnapshot] = None
    advantage, remaining = _quantities_fit_in_quota(ctx.cq.node, ctx.requests)
    for subtree_root in ctx.cq.path_parent_to_root():
        target = hierarchy_cands if advantage else priority_cands
        _collect_in_subtree(ctx, subtree_root, subtree_root, prev_subtree,
                            advantage, target)
        fits, remaining = _quantities_fit_in_quota(subtree_root.node, remaining)
        advantage = advantage or fits
        prev_subtree = subtree_root
    return hierarchy_cands, priority_cands


def _collect_in_subtree(ctx: _HierarchicalCtx, current: CohortSnapshot,
                        subtree_root: CohortSnapshot,
                        skip: Optional[CohortSnapshot],
                        advantage: bool, out: list[_CandidateElem]) -> None:
    for child in current.child_cohorts():
        if skip is not None and child == skip:
            continue
        if child.is_within_nominal(ctx.frs):
            continue
        _collect_in_subtree(ctx, child, subtree_root, skip, advantage, out)
    for child_cq in current.child_cqs():
        if child_cq == ctx.cq:
            continue
        if not child_cq.is_within_nominal(ctx.frs):
            out.extend(_candidates_from_cq(child_cq, subtree_root, ctx, advantage))


class CandidateIterator:
    """classical/candidate_generator.go candidateIterator."""

    def __init__(self, ctx: _HierarchicalCtx, snapshot: Snapshot,
                 now: float) -> None:
        self.ctx = ctx
        self.snapshot = snapshot
        same_queue: list[_CandidateElem] = []
        if ctx.cq.spec.preemption.within_cluster_queue != PreemptionPolicyValue.NEVER:
            same_queue = _candidates_from_cq(ctx.cq, None, ctx, False)
        hierarchy, priority_cands = _collect_hierarchical_candidates(ctx)
        for group in (same_queue, priority_cands, hierarchy):
            _sort_candidates(group, ctx.cq.name, now)

        def split_evicted(group):
            ev = [c for c in group if c.wl.obj.is_evicted]
            non = [c for c in group if not c.wl.obj.is_evicted]
            return ev, non

        eh, nh = split_evicted(hierarchy)
        ep, np_ = split_evicted(priority_cands)
        es, ns = split_evicted(same_queue)
        self.candidates: list[_CandidateElem] = eh + ep + es + nh + np_ + ns
        self.no_candidate_from_other_queues = not hierarchy and not priority_cands
        self.no_candidate_for_hierarchical_reclaim = not hierarchy
        self._idx = 0

    def reset(self) -> None:
        self._idx = 0

    def next(self, borrow: bool) -> tuple[Optional[WorkloadInfo], str]:
        while self._idx < len(self.candidates):
            cand = self.candidates[self._idx]
            self._idx += 1
            if self._valid(cand, borrow):
                return cand.wl, _VARIANT_REASON[cand.variant]
        return None, ""

    def _valid(self, cand: _CandidateElem, borrow: bool) -> bool:
        if self.ctx.cq.name == cand.wl.cluster_queue:
            return True
        if borrow and cand.variant == V_RECLAIM_WITHOUT_BORROWING:
            return False
        cq = self.snapshot.cluster_queue(cand.wl.cluster_queue)
        if cq is None or cq.is_within_nominal(self.ctx.frs):
            return False
        for node in cq.path_parent_to_root():
            if cand.lca is not None and node == cand.lca:
                break
            if node.is_within_nominal(self.ctx.frs):
                return False
        return True


# ---------------------------------------------------------------------------
# Fair-sharing strategies & tournament ordering
# ---------------------------------------------------------------------------


def less_than_or_equal_to_final_share(preemptor_new: DRS, _target_old: DRS,
                                      target_new: DRS) -> bool:
    """Rule S2-a."""
    return compare_drs(preemptor_new, target_new) <= 0


def less_than_initial_share(preemptor_new: DRS, target_old: DRS,
                            _target_new: DRS) -> bool:
    """Rule S2-b."""
    return compare_drs(preemptor_new, target_old) < 0


DEFAULT_FS_STRATEGIES = (less_than_or_equal_to_final_share,
                         less_than_initial_share)


class _TargetCQ:
    def __init__(self, ordering: "_CQOrdering", cq: ClusterQueueSnapshot):
        self.ordering = ordering
        self.cq = cq

    def in_cluster_queue_preemption(self) -> bool:
        return self.cq is self.ordering.preemptor_cq

    def has_workload(self) -> bool:
        return bool(self.ordering.cq_to_targets.get(self.cq.name))

    def pop_workload(self) -> WorkloadInfo:
        return self.ordering.cq_to_targets[self.cq.name].pop(0)

    # -- almost-LCA share computation (fairsharing/least_common_ancestor.go)

    def _lca(self) -> CohortSnapshot:
        for ancestor in self.cq.path_parent_to_root():
            if ancestor in self.ordering.preemptor_ancestors:
                return ancestor
        raise RuntimeError("no least common ancestor")

    @staticmethod
    def _almost_lca(cq: ClusterQueueSnapshot, lca: CohortSnapshot):
        node = cq
        for ancestor in cq.path_parent_to_root():
            if ancestor == lca:
                return node
            node = ancestor
        raise RuntimeError("no almost-LCA")

    def compute_shares(self) -> tuple[DRS, DRS]:
        lca = self._lca()
        pre = self._almost_lca(self.ordering.preemptor_cq, lca)
        tgt = self._almost_lca(self.cq, lca)
        return pre.dominant_resource_share(), tgt.dominant_resource_share()

    def compute_target_share_after_removal(self, wl: WorkloadInfo) -> DRS:
        revert = self.cq.simulate_usage_removal(wl.usage())
        try:
            lca = self._lca()
            tgt = self._almost_lca(self.cq, lca)
            return tgt.dominant_resource_share()
        finally:
            revert()


class _CQOrdering:
    """fairsharing/ordering.go TargetClusterQueueOrdering — DRS tournament."""

    def __init__(self, preemptor_cq: ClusterQueueSnapshot,
                 candidates: list[WorkloadInfo], now: float) -> None:
        self.preemptor_cq = preemptor_cq
        self.now = now
        self.preemptor_ancestors = set(preemptor_cq.path_parent_to_root())
        self.cq_to_targets: dict[str, list[WorkloadInfo]] = {}
        for c in candidates:
            self.cq_to_targets.setdefault(c.cluster_queue, []).append(c)
        self.pruned_cqs: set[ClusterQueueSnapshot] = set()
        self.pruned_cohorts: set[CohortSnapshot] = set()

    def iter(self) -> Iterator[_TargetCQ]:
        if not self.preemptor_cq.has_parent():
            target = _TargetCQ(self, self.preemptor_cq)
            while target.has_workload():
                yield target
            return
        root = self.preemptor_cq.parent().root()
        while root not in self.pruned_cohorts:
            target = self._next_target(root)
            if target is not None:
                yield target

    def drop_queue(self, target: _TargetCQ) -> None:
        self.pruned_cqs.add(target.cq)

    def _next_target(self, cohort: CohortSnapshot) -> Optional[_TargetCQ]:
        highest_cq: Optional[ClusterQueueSnapshot] = None
        highest_cq_drs = negative_drs()
        for cq in cohort.child_cqs():
            if cq in self.pruned_cqs:
                continue
            drs = cq.dominant_resource_share()
            has_wl = bool(self.cq_to_targets.get(cq.name))
            if (not drs.borrowing and cq is not self.preemptor_cq) or not has_wl:
                self.pruned_cqs.add(cq)
            elif compare_drs(drs, highest_cq_drs) == 0 and highest_cq is not None:
                new_wl = self.cq_to_targets[cq.name][0]
                cur_wl = self.cq_to_targets[highest_cq.name][0]
                if candidates_ordering(new_wl, cur_wl, self.preemptor_cq.name,
                                       self.now) < 0:
                    highest_cq = cq
            elif compare_drs(drs, highest_cq_drs) > 0:
                highest_cq_drs = drs
                highest_cq = cq

        highest_cohort: Optional[CohortSnapshot] = None
        highest_cohort_drs = negative_drs()
        for child in cohort.child_cohorts():
            if child in self.pruned_cohorts:
                continue
            drs = child.dominant_resource_share()
            on_path = child in self.preemptor_ancestors
            if not drs.borrowing and not on_path:
                self.pruned_cohorts.add(child)
            elif compare_drs(drs, highest_cohort_drs) >= 0:
                highest_cohort_drs = drs
                highest_cohort = child

        if highest_cohort is None and highest_cq is None:
            self.pruned_cohorts.add(cohort)
            return None
        if highest_cq is not None and (
                highest_cohort is None
                or compare_drs(highest_cq_drs, highest_cohort_drs) >= 0):
            return _TargetCQ(self, highest_cq)
        return self._next_target(highest_cohort)  # type: ignore[arg-type]


# ---------------------------------------------------------------------------
# The Preemptor
# ---------------------------------------------------------------------------


class _PreemptionCtx:
    def __init__(self, preemptor: WorkloadInfo, cq: ClusterQueueSnapshot,
                 snapshot: Snapshot, usage: dict[FlavorResource, int],
                 frs: set[FlavorResource], now: float) -> None:
        self.preemptor = preemptor
        self.cq = cq
        self.snapshot = snapshot
        self.usage = usage
        self.frs = frs
        self.now = now


class Preemptor:
    def __init__(self, enable_fair_sharing: bool = False,
                 fs_strategies=DEFAULT_FS_STRATEGIES) -> None:
        self.enable_fair_sharing = enable_fair_sharing
        self.fs_strategies = fs_strategies

    # -- public API --------------------------------------------------------

    def get_targets(self, wl: WorkloadInfo, assignment: fa.Assignment,
                    snapshot: Snapshot, now: float = 0.0) -> list[Target]:
        cq = snapshot.cluster_queue(wl.cluster_queue)
        assert cq is not None
        frs = {
            (rec.name, res)
            for ps in assignment.podsets
            for res, rec in ps.flavors.items()
            if rec.mode == fa.PREEMPT
        }
        usage = dict(assignment.usage_quota)
        return self._get_targets(
            _PreemptionCtx(wl, cq, snapshot, usage, frs, now))

    def simulate_preemption(self, cq: ClusterQueueSnapshot, wl: WorkloadInfo,
                            fr: FlavorResource,
                            quantity: int) -> tuple[str, int]:
        """preemption_oracle.go SimulatePreemption."""
        snapshot = cq._snapshot
        targets = self._get_targets(_PreemptionCtx(
            wl, cq, snapshot, {fr: quantity}, {fr}, 0.0))
        if not targets:
            borrow, _ = fa.find_height_of_lowest_subtree_that_fits(
                cq, fr, quantity)
            return fa.NO_CANDIDATES, borrow
        infos = [t.info for t in targets]
        revert = snapshot.simulate_workload_removal(infos)
        borrow_after, _ = fa.find_height_of_lowest_subtree_that_fits(
            cq, fr, quantity)
        revert()
        if any(t.info.cluster_queue == cq.name for t in targets):
            return fa.POSSIBILITY_PREEMPT, borrow_after
        return fa.POSSIBILITY_RECLAIM, borrow_after

    # -- dispatch ----------------------------------------------------------

    def _get_targets(self, ctx: _PreemptionCtx) -> list[Target]:
        if self.enable_fair_sharing:
            return self._fair_preemptions(ctx)
        return self._classical_preemptions(ctx)

    # -- classical ---------------------------------------------------------

    def _classical_preemptions(self, ctx: _PreemptionCtx) -> list[Target]:
        hctx = _HierarchicalCtx(ctx.preemptor, ctx.cq, ctx.frs, ctx.usage)
        it = CandidateIterator(hctx, ctx.snapshot, ctx.now)
        borrow_forbidden, _ = is_borrowing_within_cohort_forbidden(ctx.cq)
        if it.no_candidate_from_other_queues or (
                borrow_forbidden and not self._queue_under_nominal(ctx)):
            attempts = [True]
        elif borrow_forbidden and it.no_candidate_for_hierarchical_reclaim:
            attempts = [False, True]
        else:
            attempts = [True, False]

        for allow_borrowing in attempts:
            targets: list[Target] = []
            it.reset()
            while True:
                cand, reason = it.next(allow_borrowing)
                if cand is None:
                    break
                ctx.snapshot.remove_workload(cand)
                targets.append(Target(
                    cand, reason,
                    ctx.snapshot.cluster_queue(cand.cluster_queue)))
                if self._workload_fits(ctx, allow_borrowing):
                    targets = self._fill_back(ctx, targets, allow_borrowing)
                    self._restore(ctx.snapshot, targets)
                    return targets
            self._restore(ctx.snapshot, targets)
        return []

    def _fill_back(self, ctx: _PreemptionCtx, targets: list[Target],
                   allow_borrowing: bool) -> list[Target]:
        """Re-add targets (newest first, excluding the last) while still
        fitting (preemption.go fillBackWorkloads)."""
        i = len(targets) - 2
        while i >= 0:
            ctx.snapshot.add_workload(targets[i].info)
            if self._workload_fits(ctx, allow_borrowing):
                targets[i] = targets[-1]
                targets.pop()
            else:
                ctx.snapshot.remove_workload(targets[i].info)
            i -= 1
        return targets

    @staticmethod
    def _restore(snapshot: Snapshot, targets: list[Target]) -> None:
        for t in targets:
            snapshot.add_workload(t.info)

    def _workload_fits(self, ctx: _PreemptionCtx, allow_borrowing: bool) -> bool:
        for fr, v in ctx.usage.items():
            if not allow_borrowing and ctx.cq.borrowing_with(fr, v):
                return False
            if v > ctx.cq.available(fr):
                return False
        return True

    def _workload_fits_fs(self, ctx: _PreemptionCtx) -> bool:
        """Fair sharing pre-adds the incoming usage; remove it around the
        fit check (preemption.go workloadFitsForFairSharing)."""
        revert = ctx.cq.simulate_usage_removal(ctx.usage)
        try:
            return self._workload_fits(ctx, True)
        finally:
            revert()

    def _queue_under_nominal(self, ctx: _PreemptionCtx) -> bool:
        for fr in ctx.frs:
            if ctx.cq.node.usage.get(fr, 0) >= ctx.cq.quota_for(fr).nominal:
                return False
        return True

    # -- fair sharing ------------------------------------------------------

    def _find_fs_candidates(self, ctx: _PreemptionCtx) -> list[WorkloadInfo]:
        """preemption.go findCandidates."""
        out: list[WorkloadInfo] = []
        pre = ctx.cq.spec.preemption
        if pre.within_cluster_queue != PreemptionPolicyValue.NEVER:
            for wl in ctx.cq.workloads.values():
                if (satisfies_preemption_policy(
                        ctx.preemptor.obj, wl.obj, pre.within_cluster_queue)
                        and workload_uses_resources(wl, ctx.frs)):
                    out.append(wl)
        if ctx.cq.has_parent() and (
                pre.reclaim_within_cohort != PreemptionPolicyValue.NEVER):
            for cohort_cq in ctx.cq.parent().root().subtree_cluster_queues():
                if cohort_cq == ctx.cq:
                    continue
                if not any(cohort_cq.borrowing(fr) for fr in ctx.frs):
                    continue
                for wl in cohort_cq.workloads.values():
                    if (satisfies_preemption_policy(
                            ctx.preemptor.obj, wl.obj, pre.reclaim_within_cohort)
                            and workload_uses_resources(wl, ctx.frs)):
                        out.append(wl)
        return out

    def _fair_preemptions(self, ctx: _PreemptionCtx) -> list[Target]:
        candidates = self._find_fs_candidates(ctx)
        if not candidates:
            return []
        candidates.sort(key=functools.cmp_to_key(
            lambda a, b: candidates_ordering(a, b, ctx.cq.name, ctx.now)))

        revert_sim = ctx.cq.simulate_usage_addition(ctx.usage)
        try:
            fits, targets, retry = self._run_first_fs_strategy(
                ctx, candidates, self.fs_strategies[0])
            if not fits and len(self.fs_strategies) > 1:
                fits, targets = self._run_second_fs_strategy(ctx, retry, targets)
        finally:
            revert_sim()

        if not fits:
            self._restore(ctx.snapshot, targets)
            return []
        # fill back with the incoming usage still present semantics: the
        # reference reverts the simulation before fillBack, then uses the
        # allowBorrowing=true fit check.
        targets = self._fill_back(ctx, targets, True)
        self._restore(ctx.snapshot, targets)
        return targets

    def _run_first_fs_strategy(
        self, ctx: _PreemptionCtx, candidates: list[WorkloadInfo], strategy
    ) -> tuple[bool, list[Target], list[WorkloadInfo]]:
        # FairSharingPreemptWithinNominal (beta, on): a preemptor whose
        # CQ stays within nominal quota on the contested resources —
        # the incoming usage is already simulated by the caller — is
        # entitled to preempt cross-CQ candidates UNCONDITIONALLY,
        # bypassing the DRS strategy check (preemption.go:377-412); no
        # retry candidates are produced for the second strategy.
        within_nominal = (
            features.enabled("FairSharingPreemptWithinNominal")
            and ctx.cq.is_within_nominal(ctx.frs))
        ordering = _CQOrdering(ctx.cq, candidates, ctx.now)
        targets: list[Target] = []
        retry: list[WorkloadInfo] = []
        for cand_cq in ordering.iter():
            if cand_cq.in_cluster_queue_preemption():
                wl = cand_cq.pop_workload()
                ctx.snapshot.remove_workload(wl)
                targets.append(Target(wl, IN_CLUSTER_QUEUE, cand_cq.cq))
                if self._workload_fits_fs(ctx):
                    return True, targets, []
                continue
            if within_nominal:
                wl = cand_cq.pop_workload()
                ctx.snapshot.remove_workload(wl)
                targets.append(Target(wl, IN_COHORT_RECLAMATION,
                                      cand_cq.cq))
                if self._workload_fits_fs(ctx):
                    return True, targets, []
                continue
            preemptor_new, target_old = cand_cq.compute_shares()
            while cand_cq.has_workload():
                wl = cand_cq.pop_workload()
                target_new = cand_cq.compute_target_share_after_removal(wl)
                if strategy(preemptor_new, target_old, target_new):
                    ctx.snapshot.remove_workload(wl)
                    targets.append(Target(wl, IN_COHORT_FAIR_SHARING, cand_cq.cq))
                    if self._workload_fits_fs(ctx):
                        return True, targets, []
                    break  # re-evaluate CQ ordering with changed shares
                retry.append(wl)
        return False, targets, retry

    def _run_second_fs_strategy(
        self, ctx: _PreemptionCtx, retry: list[WorkloadInfo],
        targets: list[Target]
    ) -> tuple[bool, list[Target]]:
        ordering = _CQOrdering(ctx.cq, retry, ctx.now)
        for cand_cq in ordering.iter():
            preemptor_new, target_old = cand_cq.compute_shares()
            if less_than_initial_share(preemptor_new, target_old, DRS()):
                wl = cand_cq.pop_workload()
                ctx.snapshot.remove_workload(wl)
                targets.append(Target(wl, IN_COHORT_FAIR_SHARING, cand_cq.cq))
                if self._workload_fits_fs(ctx):
                    return True, targets
            ordering.drop_queue(cand_cq)
        return False, targets

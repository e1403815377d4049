"""Hierarchical quota algebra over the cohort forest.

A copy of ``kueue_oss_tpu/core/quota.py`` (reference:
pkg/cache/scheduler/resource_node.go:66-233): per (flavor, resource)
pair every node holds its quotas, subtree quota and usage; a cohort's
subtree quota is its own nominal plus what each child shares upward;
usage bubbles past local capacity. The drain export reads these node
quantities. The host dominant resource share (DRS,
pkg/cache/scheduler/fair_sharing.go:140-191) is the scalar form of the
fair drain's ``fair_kernels.drs_all``. Cut from the copy: the scalar
``available`` walk and the usage removal (the drain computes both on
the device).
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Iterable, Optional

from kueue_oss_tpu_torch import features
from kueue_oss_tpu_torch.api.types import (
    ClusterQueue,
    Cohort,
    FlavorResource,
    ResourceQuota,
    iter_quotas,
)

MAX_SHARE = float("inf")


@dataclass
class QuotaNode:
    """One node of the cohort forest (a ClusterQueue leaf or a Cohort)."""

    name: str
    is_cq: bool
    quotas: dict[FlavorResource, ResourceQuota] = field(default_factory=dict)
    subtree_quota: dict[FlavorResource, int] = field(default_factory=dict)
    usage: dict[FlavorResource, int] = field(default_factory=dict)
    parent: Optional["QuotaNode"] = None
    children: dict[str, "QuotaNode"] = field(default_factory=dict)
    #: fair-sharing weight from the spec
    fair_weight: float = 1.0

    def local_quota(self, fr: FlavorResource) -> int:
        q = self.quotas.get(fr)
        if (q is not None and q.lending_limit is not None
                and features.enabled("LendingLimit")):
            return max(0, self.subtree_quota.get(fr, 0) - q.lending_limit)
        return 0

    def local_available(self, fr: FlavorResource) -> int:
        return max(0, self.local_quota(fr) - self.usage.get(fr, 0))

    def borrowing_limit(self, fr: FlavorResource) -> Optional[int]:
        q = self.quotas.get(fr)
        return q.borrowing_limit if q is not None else None

    def potential_available(self, fr: FlavorResource) -> int:
        """Max capacity reachable assuming the whole tree were empty."""
        if self.parent is None:
            return self.subtree_quota.get(fr, 0)
        avail = self.local_quota(fr) + self.parent.potential_available(fr)
        bl = self.borrowing_limit(fr)
        if bl is not None:
            avail = min(self.subtree_quota.get(fr, 0) + bl, avail)
        return avail

    def root(self) -> "QuotaNode":
        node = self
        while node.parent is not None:
            node = node.parent
        return node

    def add_usage(self, fr: FlavorResource, val: int) -> None:
        """Add usage, bubbling the part above local capacity upward."""
        local_available = self.local_available(fr)
        self.usage[fr] = self.usage.get(fr, 0) + val
        if self.parent is not None and val > local_available:
            self.parent.add_usage(fr, val - local_available)


class CohortCycleError(Exception):
    pass


def _collect_quotas(owner: str,
                    resource_groups) -> dict[FlavorResource, ResourceQuota]:
    out: dict[FlavorResource, ResourceQuota] = {}
    for key, rq in iter_quotas(resource_groups):
        if key in out:
            raise ValueError(f"{owner} declares duplicate quota for {key}")
        out[key] = rq
    return out


class QuotaForest:
    """The cohort forest built from API objects; cohorts named by a CQ
    but never declared are synthesized empty."""

    def __init__(self) -> None:
        self.nodes: dict[str, QuotaNode] = {}
        self.cqs: dict[str, QuotaNode] = {}

    def build(self, cluster_queues: Iterable[ClusterQueue],
              cohorts: Iterable[Cohort] = ()) -> None:
        self.nodes.clear()
        self.cqs.clear()
        cohorts = list(cohorts)
        cohort_by_name = {c.name: c for c in cohorts}

        def ensure_cohort(name: str) -> QuotaNode:
            key = f"cohort/{name}"
            if key not in self.nodes:
                spec = cohort_by_name.get(name)
                node = QuotaNode(name=name, is_cq=False)
                if spec is not None:
                    node.fair_weight = spec.fair_sharing.weight
                    node.quotas = _collect_quotas(
                        f"cohort {name}", spec.resource_groups)
                self.nodes[key] = node
                if spec is not None and spec.parent:
                    parent = ensure_cohort(spec.parent)
                    node.parent = parent
                    parent.children[key] = node
            return self.nodes[key]

        for c in cohorts:
            ensure_cohort(c.name)
        for cq in cluster_queues:
            node = QuotaNode(name=cq.name, is_cq=True,
                             fair_weight=cq.fair_sharing.weight)
            node.quotas = _collect_quotas(f"cq {cq.name}", cq.resource_groups)
            key = f"cq/{cq.name}"
            self.nodes[key] = node
            self.cqs[cq.name] = node
            if cq.cohort:
                parent = ensure_cohort(cq.cohort)
                node.parent = parent
                parent.children[key] = node
        self._check_cycles()
        self.refresh()

    def _check_cycles(self) -> None:
        for node in self.nodes.values():
            seen = set()
            cur: Optional[QuotaNode] = node
            while cur is not None:
                if id(cur) in seen:
                    raise CohortCycleError(f"cycle through cohort {cur.name}")
                seen.add(id(cur))
                cur = cur.parent

    def roots(self) -> list[QuotaNode]:
        out = [n for n in self.nodes.values()
               if n.parent is None and not n.is_cq]
        out += [n for n in self.cqs.values() if n.parent is None]
        return out

    def refresh(self) -> None:
        """Recompute subtree quota and cohort usage bottom-up."""
        for root in self.roots():
            _refresh_node(root)


def _refresh_node(node: QuotaNode) -> None:
    node.subtree_quota = {fr: q.nominal for fr, q in node.quotas.items()}
    if node.is_cq:
        return
    usage: dict[FlavorResource, int] = {}
    for child in node.children.values():
        _refresh_node(child)
        for fr, q in child.subtree_quota.items():
            node.subtree_quota[fr] = (
                node.subtree_quota.get(fr, 0) + q - child.local_quota(fr))
        for fr, cu in child.usage.items():
            usage[fr] = usage.get(fr, 0) + max(0, cu - child.local_quota(fr))
    node.usage = usage


# ---------------------------------------------------------------------------
# Fair sharing (dominant resource share)
# ---------------------------------------------------------------------------


@dataclass
class DRS:
    """Dominant resource share of a node, with precise comparison.

    Reference parity: pkg/cache/scheduler/fair_sharing.go DRS.
    """

    fair_weight: float = 1.0
    unweighted_ratio: float = 0.0
    dominant_resource: str = ""
    borrowing: bool = False
    borrowed_frs: tuple[FlavorResource, ...] = ()

    @property
    def is_zero(self) -> bool:
        return self.unweighted_ratio == 0

    def is_borrowing_on(self, requested: dict[FlavorResource, int]) -> bool:
        return any(requested.get(fr, 0) > 0 for fr in self.borrowed_frs)

    @property
    def _zero_weight_borrows(self) -> bool:
        return self.fair_weight == 0 and not self.is_zero

    def precise_weighted_share(self) -> float:
        if self.is_zero:
            return 0.0
        if self.fair_weight == 0:
            return MAX_SHARE
        return self.unweighted_ratio / self.fair_weight

    def rounded_weighted_share(self) -> int:
        if self._zero_weight_borrows:
            return (1 << 63) - 1
        return math.ceil(self.precise_weighted_share())


def negative_drs() -> DRS:
    return DRS(unweighted_ratio=-1.0)


def compare_drs(a: DRS, b: DRS) -> int:
    """Lower = preferred for admission, higher = preferred for preemption.

    Zero-weight borrowers sort above everything else; among themselves
    they compare on the unweighted ratio.
    """
    if a._zero_weight_borrows and b._zero_weight_borrows:
        return _cmp(a.unweighted_ratio, b.unweighted_ratio)
    if a._zero_weight_borrows:
        return 1
    if b._zero_weight_borrows:
        return -1
    return _cmp(a.precise_weighted_share(), b.precise_weighted_share())


def _cmp(a: float, b: float) -> int:
    return (a > b) - (a < b)


def dominant_resource_share(
    node: QuotaNode, wl_req: Optional[dict[FlavorResource, int]] = None
) -> DRS:
    """DRS of node with (optionally) a workload's usage hypothetically
    added.

    ratio = max over resources of
        (sum of borrowed-above-subtree-quota across that resource's
        flavors) * 1000 / (lendable capacity for the resource in the
        cohort tree)
    weighted by 1/fair_weight.
    """
    drs = DRS(fair_weight=node.fair_weight)
    if node.parent is None:
        return drs
    wl_req = wl_req or {}

    borrowing: dict[str, int] = {}
    borrowed_frs: list[FlavorResource] = []
    for fr, quota in node.subtree_quota.items():
        amount_borrowed = wl_req.get(fr, 0) + node.usage.get(fr, 0) - quota
        if amount_borrowed > 0:
            borrowing[fr[1]] = borrowing.get(fr[1], 0) + amount_borrowed
            borrowed_frs.append(fr)
    if not borrowing:
        return drs
    drs.borrowing = True
    drs.borrowed_frs = tuple(borrowed_frs)

    lendable = calculate_lendable(node.parent)
    for rname, b in borrowing.items():
        lr = lendable.get(rname, 0)
        if lr > 0:
            ratio = b * 1000.0 / lr
            if ratio > drs.unweighted_ratio or (
                ratio == drs.unweighted_ratio and rname < drs.dominant_resource
            ):
                drs.unweighted_ratio = ratio
                drs.dominant_resource = rname
    return drs


def calculate_lendable(node: QuotaNode) -> dict[str, int]:
    """Per-resource capacity the node could reach, summed over flavors."""
    root = node.root()
    lendable: dict[str, int] = {}
    for fr in root.subtree_quota:
        lendable[fr[1]] = lendable.get(fr[1], 0) + node.potential_available(fr)
    return lendable

"""Hierarchical quota algebra over the cohort forest.

A copy of ``kueue_oss_tpu/core/quota.py`` (reference:
pkg/cache/scheduler/resource_node.go:66-233): per (flavor, resource)
pair every node holds its quotas, subtree quota and usage; a cohort's
subtree quota is its own nominal plus what each child shares upward;
usage bubbles past local capacity. The drain export reads these node
quantities. Cut from the copy: the scalar ``available`` walk (the
drain computes it on the device) and dominant-resource-share fair
sharing (the fair-sharing drain is a later slice).
"""

from __future__ import annotations

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
    #: fair-sharing weight from the spec (exported, read by no drain)
    fair_weight: float = 1.0

    def local_quota(self, fr: FlavorResource) -> int:
        q = self.quotas.get(fr)
        if (q is not None and q.lending_limit is not None
                and features.enabled("LendingLimit")):
            return max(0, self.subtree_quota.get(fr, 0) - q.lending_limit)
        return 0

    def local_available(self, fr: FlavorResource) -> int:
        return max(0, self.local_quota(fr) - self.usage.get(fr, 0))

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

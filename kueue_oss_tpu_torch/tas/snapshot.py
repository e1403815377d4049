"""TAS flavor snapshot: the topology domain tree of one TAS flavor.

A copy of the tree half of ``kueue_oss_tpu/tas/snapshot.py``
(reference: pkg/cache/scheduler/tas_flavor_snapshot.go, KEP-2724):
leaves carry free capacity (node allocatable) and assumed TAS usage;
every ancestor domain is registered per level, keyed by its level
values (a domain's parent is its id without the last value).
``solver/tas_kernels.build_levels`` flattens the tree into the dense
per-level arrays the device placer runs on. Cut from the copy: the host
two-phase placement algorithm (balanced placement, multi-layer slices,
leader groups, node replacement, taint filtering) — on the drain path
the device placer replaces it — and the gated device fill-in-counts
caller (``TASDeviceFillCounts``, off by default).
"""

from __future__ import annotations

from typing import Iterable, Optional

from kueue_oss_tpu_torch.api.types import HOSTNAME_LABEL, Node

Requests = dict[str, int]


def _add(dst: Requests, src: Requests, scale: int = 1) -> None:
    for r, q in src.items():
        dst[r] = dst.get(r, 0) + q * scale


class Domain:
    """One topology domain (tas_flavor_snapshot.go:51-89)."""

    __slots__ = ("id", "level_values")

    def __init__(self, domain_id: tuple[str, ...]) -> None:
        self.id = domain_id
        self.level_values = domain_id


class LeafDomain(Domain):
    __slots__ = ("free_capacity", "tas_usage")

    def __init__(self, domain_id: tuple[str, ...]) -> None:
        super().__init__(domain_id)
        self.free_capacity: Requests = {}
        self.tas_usage: Requests = {}


class TASFlavorSnapshot:
    """Topology tree for one TAS ResourceFlavor."""

    def __init__(self, levels: list[str], profile_mixed: bool) -> None:
        self.levels = list(levels)
        #: LeastFreeCapacity for unconstrained podsets
        self.profile_mixed = profile_mixed
        self.leaves: dict[tuple[str, ...], LeafDomain] = {}
        self.domains_per_level: list[dict[tuple[str, ...], Domain]] = [
            {} for _ in levels]
        self.is_lowest_level_node = (
            bool(levels) and levels[-1] == HOSTNAME_LABEL)

    def add_node(self, node: Node) -> Optional[tuple[str, ...]]:
        """Register a ready node's capacity under its leaf domain."""
        values = tuple(node.labels.get(k, "") for k in self.levels)
        if any(v == "" for v in values):
            return None  # node not part of this topology
        leaf = self.leaves.get(values)
        if leaf is None:
            leaf = LeafDomain(values)
            self.leaves[values] = leaf
        _add(leaf.free_capacity, node.allocatable)
        return values

    def initialize(self) -> None:
        """Register every leaf and its ancestors at their levels."""
        for leaf in self.leaves.values():
            self.domains_per_level[len(leaf.id) - 1][leaf.id] = leaf
            values = leaf.id[:-1]
            while values and values not in self.domains_per_level[
                    len(values) - 1]:
                self.domains_per_level[len(values) - 1][values] = Domain(
                    values)
                values = values[:-1]

    def add_tas_usage(self, domain_values: Iterable[str],
                      single_pod_requests: Requests, count: int) -> None:
        leaf = self._leaf_for_values(tuple(domain_values))
        if leaf is None:
            return  # backing node deleted / not ready
        _add(leaf.tas_usage, single_pod_requests, scale=count)
        leaf.tas_usage["pods"] = leaf.tas_usage.get("pods", 0) + count

    def _leaf_for_values(self,
                         values: tuple[str, ...]) -> Optional[LeafDomain]:
        """Resolve assignment values (hostname-only or full path)."""
        leaf = self.leaves.get(values)
        if leaf is not None:
            return leaf
        if len(values) == 1 and self.is_lowest_level_node:
            for candidate in self.leaves.values():
                if candidate.level_values[-1] == values[0]:
                    return candidate
        return None

    def level_index(self, key: str) -> Optional[int]:
        try:
            return self.levels.index(key)
        except ValueError:
            return None


def build_tas_flavor_snapshot(
    levels: list[str],
    nodes: Iterable[Node],
    flavor_node_labels: Optional[dict[str, str]] = None,
    profile_mixed: bool = False,
) -> TASFlavorSnapshot:
    """Build and initialize a snapshot from the ready nodes matching the
    flavor's nodeLabels."""
    snap = TASFlavorSnapshot(levels, profile_mixed=profile_mixed)
    selector = flavor_node_labels or {}
    for node in nodes:
        if not node.ready:
            continue
        if all(node.labels.get(k) == v for k, v in selector.items()):
            snap.add_node(node)
    snap.initialize()
    return snap

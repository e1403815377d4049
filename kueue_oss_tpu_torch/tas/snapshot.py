"""TAS flavor snapshot: topology tree + two-phase placement.

A copy of ``kueue_oss_tpu/tas/snapshot.py`` (reference:
pkg/cache/scheduler/tas_flavor_snapshot.go, KEP-2724). The snapshot
holds the topology domain tree for one TAS ResourceFlavor: leaves carry
free capacity (node allocatable minus non-TAS usage) and TAS usage;
placement runs in two phases:

  1. fill counts: per-leaf pod/slice/leader capacity from the podset's
     per-pod requests (after taint/selector/affinity filtering), rolled
     up the tree (tas_flavor_snapshot.go:1568-1719);
  2. placement: find the best level/domain set at or above the
     requested level (findLevelWithFitDomains, :1236-1321), then walk
     down level-by-level minimizing the number of domains used
     (updateCountsToMinimumGeneric, :1405-1469), finally emitting the
     lowest-level assignment (buildAssignment, :1490-1501).

Supported: required/preferred/unconstrained levels, slice grouping
(podset_slice_required_topology + size) including multi-layer nested
slice constraints (gate TASMultiLayerTopology), balanced placement
(gate TASBalancedPlacement; tas_balanced_placement.go), leader/worker
podset groups, BestFit and LeastFreeCapacity profiles, unhealthy-node
replacement (findReplacementAssignment, :614-656).

With the TASDeviceFillCounts gate on, phase 1's division and roll-up
run on the snapshot's ``device`` through ``solver/cuda_tas.fill_counts``
(on a CUDA device one launch of ``csrc/fill_counts.cu`` per
``_fill_in_counts`` call; on the CPU its plain version, ``tas_kernels.
fill_counts_ext``); the leaf filtering and every phase-2 tie-break stay
on the host.
With the gate off (the default) no code here touches a device.
``solver/tas_kernels.build_levels`` flattens the same tree for the
drain's device placer. Cut from the copy: ``add_non_tas_usage``,
``has_node`` and ``fits``, which nothing in the port calls (the JAX
package calls them only from its tests).
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Iterable, Optional

from kueue_oss_tpu_torch import features
from kueue_oss_tpu_torch.api.types import (
    HOSTNAME_LABEL,
    Node,
    PodSet,
    Toleration,
    TopologyAssignment,
    TopologyDomainAssignment,
    Workload,
)

Requests = dict[str, int]


def count_in(requests: Requests, capacity: Requests) -> int:
    """How many pods with `requests` fit into `capacity`."""
    fit = 1 << 30
    for r, q in requests.items():
        if q <= 0:
            continue
        fit = min(fit, capacity.get(r, 0) // q)
    return max(fit, 0)


def _limiting_resource(requests: Requests, capacity: Requests) -> str:
    for r, q in requests.items():
        if q > 0 and capacity.get(r, 0) // q <= 0:
            return r
    return ""


def _add(dst: Requests, src: Requests, scale: int = 1) -> None:
    for r, q in src.items():
        dst[r] = dst.get(r, 0) + q * scale


def _sub(dst: Requests, src: Requests) -> None:
    for r, q in src.items():
        dst[r] = dst.get(r, 0) - q


class Domain:
    """One topology domain (tas_flavor_snapshot.go:51-89).

    `state`/`slice_state`/`leader_state` (+ with-leader variants) are
    scratch fields of the placement algorithm: in phase 1 they hold how
    many pods/slices/leaders *can* fit; in phase 2 they are overwritten
    with how many *are* assigned.
    """

    __slots__ = ("id", "level_values", "parent", "children", "state",
                 "slice_state", "state_with_leader",
                 "slice_state_with_leader", "leader_state")

    def __init__(self, domain_id: tuple[str, ...],
                 level_values: tuple[str, ...]) -> None:
        self.id = domain_id
        self.level_values = level_values
        self.parent: Optional[Domain] = None
        self.children: list[Domain] = []
        self.state = 0
        self.slice_state = 0
        self.state_with_leader = 0
        self.slice_state_with_leader = 0
        self.leader_state = 0


class LeafDomain(Domain):
    __slots__ = ("free_capacity", "tas_usage", "node", "_remaining")

    def __init__(self, domain_id, level_values) -> None:
        super().__init__(domain_id, level_values)
        self.free_capacity: Requests = {}
        self.tas_usage: Requests = {}
        self.node: Optional[Node] = None
        #: per-call scratch for the device fill path (remaining capacity
        #: after host-side filtering; None between calls)
        self._remaining: Optional[Requests] = None


@dataclass
class TASPodSetRequest:
    """Placement request for one podset on one TAS flavor
    (reference: TASPodSetRequests, tas_flavor_snapshot.go:356-367)."""

    podset: PodSet
    single_pod_requests: Requests
    count: int
    flavor: str
    implied: bool = False
    podset_group_name: Optional[str] = None


@dataclass
class TASAssignmentResult:
    assignment: Optional[TopologyAssignment] = None
    failure: str = ""


class TASFlavorSnapshot:
    """Topology tree for one TAS ResourceFlavor."""

    def __init__(self, topology_name: str, levels: list[str],
                 tolerations: Optional[list[Toleration]] = None,
                 profile_mixed: bool = False, device="cuda") -> None:
        self.topology_name = topology_name
        self.levels = list(levels)
        self.tolerations = list(tolerations or [])
        #: LeastFreeCapacity for unconstrained podsets (TASProfileMixed gate)
        self.profile_mixed = profile_mixed
        self.leaves: dict[tuple[str, ...], LeafDomain] = {}
        self.domains: dict[tuple[str, ...], Domain] = {}
        self.roots: dict[tuple[str, ...], Domain] = {}
        self.domains_per_level: list[dict[tuple[str, ...], Domain]] = [
            {} for _ in levels]
        self.is_lowest_level_node = (
            bool(levels) and levels[-1] == HOSTNAME_LABEL)
        #: run phase 1 (fill-in counts: the per-leaf capacity division
        #: and the per-level roll-up) on ``device`` via
        #: solver/cuda_tas.fill_counts, keeping host-side leaf
        #: filtering and EVERY phase-2 tie-break (balanced DP included);
        #: see the TASDeviceFillCounts gate
        self.use_device_fill = False
        #: where the device fill runs; read only when use_device_fill is
        #: on ("cuda" raises there without a CUDA device)
        self.device = device
        self._device_tree = None  # (parents, lex-ordered domain lists)
        self._fill_tree = None  # cuda_tas.PlacerTree of those parents

    # ------------------------------------------------------------------
    # Construction
    # ------------------------------------------------------------------

    def add_node(self, node: Node) -> Optional[tuple[str, ...]]:
        """Register a ready node's capacity under its leaf domain."""
        values = tuple(node.labels.get(k, "") for k in self.levels)
        if any(v == "" for v in values):
            return None  # node not part of this topology
        leaf = self.leaves.get(values)
        if leaf is None:
            leaf = LeafDomain(values, values)
            self.leaves[values] = leaf
        if self.is_lowest_level_node:
            leaf.node = node
        _add(leaf.free_capacity, node.allocatable)
        return values

    def initialize(self) -> None:
        """Connect leaves to parent domains up to the roots."""
        self._device_tree = self._fill_tree = None
        for leaf in self.leaves.values():
            self.domains[leaf.id] = leaf
            self.domains_per_level[len(leaf.level_values) - 1][leaf.id] = leaf
            self._link_ancestors(leaf)

    def _link_ancestors(self, dom: Domain) -> None:
        if len(dom.level_values) == 1:
            self.roots[dom.id] = dom
            return
        parent_values = dom.level_values[:-1]
        parent = self.domains.get(parent_values)
        if parent is None:
            parent = Domain(parent_values, parent_values)
            self.domains[parent_values] = parent
            self.domains_per_level[len(parent_values) - 1][parent_values] = parent
            self._link_ancestors(parent)
        dom.parent = parent
        parent.children.append(dom)

    def add_tas_usage(self, domain_values: Iterable[str],
                      single_pod_requests: Requests, count: int) -> None:
        leaf = self._leaf_for_values(tuple(domain_values))
        if leaf is None:
            return  # backing node deleted / not ready
        _add(leaf.tas_usage, single_pod_requests, scale=count)
        leaf.tas_usage["pods"] = leaf.tas_usage.get("pods", 0) + count

    def remove_tas_usage(self, domain_values: Iterable[str],
                         single_pod_requests: Requests, count: int) -> None:
        leaf = self._leaf_for_values(tuple(domain_values))
        if leaf is None:
            return
        _add(leaf.tas_usage, single_pod_requests, scale=-count)
        leaf.tas_usage["pods"] = leaf.tas_usage.get("pods", 0) - count

    def _leaf_for_values(self, values: tuple[str, ...]) -> Optional[LeafDomain]:
        """Resolve assignment values (hostname-only or full path) to a leaf."""
        leaf = self.leaves.get(values)
        if leaf is not None:
            return leaf
        if len(values) == 1 and self.is_lowest_level_node:
            for candidate in self.leaves.values():
                if candidate.level_values[-1] == values[0]:
                    return candidate
        return None

    # ------------------------------------------------------------------
    # Level helpers
    # ------------------------------------------------------------------

    def level_index(self, key: str) -> Optional[int]:
        try:
            return self.levels.index(key)
        except ValueError:
            return None

    def has_level(self, podset: PodSet) -> bool:
        tr = podset.topology_request
        key = self._level_key(podset)
        if key is None:
            return False
        if self.level_index(key) is None:
            return False
        if tr is not None and tr.podset_slice_required_topology is not None:
            if self.level_index(tr.podset_slice_required_topology) is None:
                return False
        return True

    def _level_key(self, podset: PodSet,
                   implied: bool = False) -> Optional[str]:
        tr = podset.topology_request
        if tr is not None:
            if tr.required is not None:
                return tr.required
            if tr.preferred is not None:
                return tr.preferred
            if tr.podset_slice_required_topology is not None and not (
                    tr.required or tr.preferred):
                return self.levels[0]
            if tr.unconstrained:
                return self.levels[-1]
        if implied:
            return self.levels[-1]
        return None

    # ------------------------------------------------------------------
    # Fit re-check (the scheduler's _tas_fits)
    # ------------------------------------------------------------------

    def remaining_capacity(self, domain_values: Iterable[str]) -> Optional[Requests]:
        """Free capacity minus assumed TAS usage for one leaf domain; None
        if the domain is unknown (e.g. the node left the snapshot)."""
        leaf = self._leaf_for_values(tuple(domain_values))
        if leaf is None:
            return None
        remaining = dict(leaf.free_capacity)
        _sub(remaining, leaf.tas_usage)
        return remaining

    # ------------------------------------------------------------------
    # Main entry: grouped placement over podsets
    # ------------------------------------------------------------------

    def find_topology_assignments(
        self,
        requests: list[TASPodSetRequest],
        simulate_empty: bool = False,
        workload: Optional[Workload] = None,
    ) -> dict[str, TASAssignmentResult]:
        """Place all podset requests, respecting group co-location and
        accumulating assumed usage between groups
        (FindTopologyAssignmentsForFlavor, tas_flavor_snapshot.go:519-594).
        """
        result: dict[str, TASAssignmentResult] = {}
        assumed: dict[tuple[str, ...], Requests] = {}

        groups: dict[str, list[TASPodSetRequest]] = {}
        order: list[str] = []
        for idx, tr in enumerate(requests):
            key = tr.podset_group_name or f"__solo_{idx}"
            if key not in groups:
                groups[key] = []
                order.append(key)
            groups[key].append(tr)

        unhealthy = list(workload.status.unhealthy_nodes) if workload else []
        # Replacement only applies to a workload that still holds a topology
        # assignment; a requeued workload with a stale unhealthy list is
        # placed from scratch. More than one failed node is beyond repair —
        # fail so the caller evicts (reference: single-node replacement,
        # tas_flavor_snapshot.go:614).
        has_prior = (
            workload is not None and workload.status.admission is not None
            and any(psa.topology_assignment is not None
                    for psa in workload.status.admission.podset_assignments))
        if (unhealthy and has_prior
                and not features.enabled("TASFailedNodeReplacement")):
            reason = (f"node(s) {sorted(unhealthy)} in the topology "
                      "assignment are unhealthy (replacement disabled)")
            for key in order:
                for tr in groups[key]:
                    result[tr.podset.name] = TASAssignmentResult(failure=reason)
            return result
        if unhealthy and has_prior and len(unhealthy) > 1:
            reason = (f"nodes {sorted(unhealthy)} in the topology assignment "
                      "are unhealthy; only a single node can be replaced")
            for key in order:
                for tr in groups[key]:
                    result[tr.podset.name] = TASAssignmentResult(failure=reason)
            return result
        for key in order:
            trs = groups[key]
            if unhealthy and has_prior:
                for tr in trs:
                    res = self._replace_unhealthy(tr, workload, unhealthy[0],
                                                  assumed)
                    result[tr.podset.name] = res
                    if res.failure:
                        return result
                continue

            if len(trs) > 2:
                reason = (f"podset group {key!r} has {len(trs)} podsets; "
                          "at most 2 (leader + workers) are supported")
                for tr in trs:
                    result[tr.podset.name] = TASAssignmentResult(
                        failure=reason)
                return result
            leader, workers = self._split_leader(trs)
            if leader is not None and leader.count != 1:
                reason = (f"leader podset {leader.podset.name!r} must have "
                          f"count 1, got {leader.count}")
                for tr in trs:
                    result[tr.podset.name] = TASAssignmentResult(
                        failure=reason)
                return result
            assignments, reason = self._place(workers, leader, assumed,
                                              simulate_empty)
            for tr in trs:
                result[tr.podset.name] = TASAssignmentResult(
                    assignment=assignments.get(tr.podset.name),
                    failure=reason)
            if reason:
                return result
            for tr in trs:
                self._assume(assumed, assignments.get(tr.podset.name), tr)
        return result

    @staticmethod
    def _split_leader(trs: list[TASPodSetRequest]):
        """Two grouped podsets = (leader, workers), leader has the lower
        count (findLeaderAndWorkers, tas_flavor_snapshot.go:596-609)."""
        workers = trs[0]
        leader = None
        if len(trs) > 1:
            leader = trs[1]
            if leader.count > workers.count:
                leader, workers = workers, leader
        return leader, workers

    def _assume(self, assumed, ta: Optional[TopologyAssignment],
                tr: TASPodSetRequest) -> None:
        if ta is None:
            return
        for dom in ta.domains:
            leaf = self._leaf_for_values(tuple(dom.values))
            if leaf is None:
                continue
            bucket = assumed.setdefault(leaf.id, {})
            _add(bucket, tr.single_pod_requests, scale=dom.count)
            bucket["pods"] = bucket.get("pods", 0) + dom.count

    # ------------------------------------------------------------------
    # Unhealthy-node replacement
    # ------------------------------------------------------------------

    def _replace_unhealthy(self, tr: TASPodSetRequest,
                           workload: Workload, unhealthy_node: str,
                           assumed) -> TASAssignmentResult:
        """Re-place only the pods that sat on the unhealthy node, keeping
        the rest of the assignment (findReplacementAssignment,
        tas_flavor_snapshot.go:614-656)."""
        psa = None
        if workload.status.admission is not None:
            for cand in workload.status.admission.podset_assignments:
                if cand.name == tr.podset.name:
                    psa = cand
        if psa is None or psa.topology_assignment is None:
            # Inconsistent state: the workload holds a prior assignment for
            # some podsets but not this one — fail so the caller evicts
            # rather than silently admitting without a placement.
            return TASAssignmentResult(failure=(
                f"podset {tr.podset.name!r} has no prior topology assignment "
                "to repair"))
        existing = TopologyAssignment(
            levels=list(psa.topology_assignment.levels),
            domains=[TopologyDomainAssignment(list(d.values), d.count)
                     for d in psa.topology_assignment.domains
                     if d.values[-1] != unhealthy_node],
        )
        missing = sum(
            d.count for d in psa.topology_assignment.domains
            if d.values[-1] == unhealthy_node)
        for dom in existing.domains:
            if self._leaf_for_values(tuple(dom.values)) is None:
                return TASAssignmentResult(failure=(
                    f"existing topology assignment contains stale domain "
                    f"{dom.values}"))
        if missing == 0:
            return TASAssignmentResult(assignment=existing)

        required_domain = self._required_replacement_domain(
            tr, existing, missing)
        sub = TASPodSetRequest(
            podset=tr.podset, single_pod_requests=tr.single_pod_requests,
            count=missing, flavor=tr.flavor, implied=tr.implied)
        assignments, reason = self._place(
            sub, None, assumed, False,
            required_replacement_domain=required_domain,
            excluded_node=unhealthy_node)
        if reason:
            return TASAssignmentResult(failure=reason)
        replacement = assignments.get(tr.podset.name)
        if replacement is None or not replacement.domains:
            return TASAssignmentResult(failure=(
                f"cannot find replacement assignment for unhealthy node "
                f"{unhealthy_node}"))
        merged = self._merge_assignments(existing, replacement)
        self._assume(assumed, replacement, sub)
        return TASAssignmentResult(assignment=merged)

    def _required_replacement_domain(
        self, tr: TASPodSetRequest, existing: TopologyAssignment,
        missing: int
    ) -> Optional[tuple[str, ...]]:
        """Confine the replacement to the domain whose required-level or
        slice grouping the failure broke (requiredReplacementDomain,
        tas_flavor_snapshot.go:680-731)."""
        key = self._level_key(tr.podset, tr.implied)
        if key is None:
            return None
        level_idx = self.level_index(key)
        if level_idx is None or not existing.domains:
            return None
        tr_req = tr.podset.topology_request

        slice_size = 1
        if tr_req is not None and tr_req.podset_slice_required_topology:
            slice_size = tr_req.podset_slice_size or 1
        if slice_size > 1 and missing % slice_size != 0:
            slice_level = self.level_index(
                tr_req.podset_slice_required_topology)
            if slice_level is None:
                return None
            per_domain: dict[tuple[str, ...], int] = {}
            for dom in existing.domains:
                leaf = self._leaf_for_values(tuple(dom.values))
                if leaf is None:
                    continue
                anc = leaf.level_values[:slice_level + 1]
                per_domain[anc] = per_domain.get(anc, 0) + dom.count
            for domain_id, cnt in per_domain.items():
                if (cnt + missing) % slice_size == 0:
                    return domain_id
            return None

        if tr_req is None or tr_req.required is None:
            return None
        leaf = self._leaf_for_values(tuple(existing.domains[0].values))
        if leaf is None:
            return None
        return leaf.level_values[:level_idx + 1]

    def _merge_assignments(self, a: TopologyAssignment,
                           b: TopologyAssignment) -> TopologyAssignment:
        by_values: dict[tuple[str, ...], int] = {}
        for dom in list(a.domains) + list(b.domains):
            key = tuple(dom.values)
            by_values[key] = by_values.get(key, 0) + dom.count

        def sort_key(values: tuple[str, ...]):
            leaf = self._leaf_for_values(values)
            return leaf.level_values if leaf is not None else values

        return TopologyAssignment(
            levels=list(a.levels),
            domains=[
                TopologyDomainAssignment(list(v), by_values[v])
                for v in sorted(by_values, key=sort_key)
            ],
        )

    # ------------------------------------------------------------------
    # Phase 1: capacity counting
    # ------------------------------------------------------------------

    def _fill_in_counts(
        self,
        tr: TASPodSetRequest,
        leader: Optional[TASPodSetRequest],
        assumed,
        simulate_empty: bool,
        slice_size: int,
        slice_level_idx: int,
        required_replacement_domain: Optional[tuple[str, ...]],
        excluded_node: Optional[str] = None,
    ) -> dict:
        """Compute per-leaf pod/leader capacity and roll it up
        (fillInCounts, tas_flavor_snapshot.go:1568-1646)."""
        for dom in self.domains.values():
            dom.state = dom.state_with_leader = 0
            dom.slice_state = dom.slice_state_with_leader = 0
            dom.leader_state = 0

        req = dict(tr.single_pod_requests)
        req["pods"] = req.get("pods", 0) + 1
        leader_req = None
        if leader is not None:
            leader_req = dict(leader.single_pod_requests)
            leader_req["pods"] = leader_req.get("pods", 0) + 1

        tolerations = list(tr.podset.tolerations) + self.tolerations
        stats = {"taints": 0, "selector": 0, "domain": 0, "resources": {},
                 "total": 0}
        for leaf in self.leaves.values():
            stats["total"] += 1
            if excluded_node is not None and (
                    leaf.level_values[-1] == excluded_node):
                stats["domain"] += 1
                continue
            if self.is_lowest_level_node and leaf.node is not None:
                taint = self._untolerated(leaf.node, tolerations)
                if taint is not None:
                    stats["taints"] += 1
                    continue
                if not all(leaf.node.labels.get(k) == v
                           for k, v in tr.podset.node_selector.items()):
                    stats["selector"] += 1
                    continue
            if required_replacement_domain is not None and (
                    leaf.level_values[:len(required_replacement_domain)]
                    != required_replacement_domain):
                stats["domain"] += 1
                continue
            remaining = dict(leaf.free_capacity)
            if not simulate_empty:
                _sub(remaining, leaf.tas_usage)
            if leaf.id in assumed:
                _sub(remaining, assumed[leaf.id])
            if self.use_device_fill:
                leaf._remaining = remaining  # device path consumes below
                continue
            leaf.state = count_in(req, remaining)
            if leaf.state == 0:
                limiting = _limiting_resource(req, remaining)
                if limiting:
                    stats["resources"][limiting] = (
                        stats["resources"].get(limiting, 0) + 1)
            leaf.leader_state = 0
            if leader_req is not None and count_in(leader_req, remaining) > 0:
                leaf.leader_state = 1
                _sub(remaining, leader_req)
            leaf.state_with_leader = count_in(req, remaining)
        leader_required = leader is not None
        if self.use_device_fill:
            self._device_fill(req, leader_req, slice_size, slice_level_idx,
                              stats)
            return stats
        for root in self.roots.values():
            self._roll_up(root, slice_size, slice_level_idx, 0,
                          leader_required)
        return stats

    def _device_fill(self, req: Requests, leader_req: Optional[Requests],
                     slice_size: int, slice_level_idx: int,
                     stats: dict) -> None:
        """Phase 1 on the device: one ``cuda_tas.fill_counts`` call
        computes every domain's (state, state_with_leader, leader_state,
        slice_state, slice_state_with_leader): the division and
        per-level segment-sum roll-up the host otherwise does
        recursively (_roll_up). Leaves the host loop's filter decisions
        intact: a filtered leaf never set ``_remaining`` and exports
        zero capacity. The inputs are built in numpy as the JAX package
        builds them (an out-of-range request raises in the int32
        assignment); the leaf capacity and the request vector go up in
        one pinned copy, the kernel's [5, N] states come back in one. A
        build or launch failure raises; there is no host fallback."""
        import numpy as np
        import torch

        from kueue_oss_tpu_torch.device import resolve_device
        from kueue_oss_tpu_torch.solver import cuda_tas

        dev = resolve_device(self.device)
        parents, per_level = self._device_tree_arrays()
        leaves = per_level[-1] if per_level else []
        if not leaves:
            return  # no domain to fill
        if self._fill_tree is None:
            # the tree and its child ranges, once per snapshot
            self._fill_tree = cuda_tas.PlacerTree(parents)
        remaining = [leaf._remaining for leaf in leaves]
        vocab = set(req) | set(leader_req or ())
        for rem in remaining:
            if rem:
                vocab.update(rem)
        vocab = sorted(vocab)
        R = max(1, len(vocab))
        ridx = {r: j for j, r in enumerate(vocab)}
        # a filtered leaf (no _remaining) exports zero capacity
        unfiltered = np.asarray([rem is not None for rem in remaining])
        cap = np.zeros((len(leaves), R), dtype=np.int64)
        for r, j in ridx.items():
            cap[:, j] = [rem.get(r, 0) if rem else 0 for rem in remaining]
        np.maximum(cap, 0, out=cap)
        for leaf in leaves:
            leaf._remaining = None
        # per_pod [R], leader_per_pod [R], has_leader, slice_size,
        # slice_level after the [D, R] capacity, in one int32 buffer
        per_pod = np.zeros((R,), dtype=np.int32)
        for r, q in req.items():
            per_pod[ridx[r]] = q
        leader_pp = np.zeros((R,), dtype=np.int32)
        if leader_req is not None:
            for r, q in leader_req.items():
                leader_pp[ridx[r]] = q
        scalars = np.asarray([leader_req is not None, slice_size,
                              slice_level_idx], dtype=np.int32)
        staged = torch.from_numpy(np.concatenate([
            np.minimum(cap, 1 << 30).astype(np.int32).ravel(), per_pod,
            leader_pp, scalars]))
        if dev.type == "cuda":
            staged = staged.pin_memory().to(dev, non_blocking=True)
        n_cap = cap.size
        states = cuda_tas.fill_counts(
            self._fill_tree, staged[:n_cap].view(len(leaves), R),
            staged[n_cap:]).cpu().numpy()
        domains = [dom for doms in per_level for dom in doms]
        for dom, (st, swl, ls, ss, sswl) in zip(domains,
                                                states.T.tolist()):
            dom.state = st
            dom.state_with_leader = swl
            dom.leader_state = ls
            dom.slice_state = ss
            dom.slice_state_with_leader = sswl
        # limiting-resource stats for zero-capacity leaves (host parity:
        # taint/selector/domain-filtered leaves were already counted
        # under their own stats keys by the host filter loop and must
        # not double-count as resource-limited)
        leaf_st = states[0, len(domains) - len(leaves):]
        for i in np.nonzero(unfiltered & (leaf_st == 0))[0]:
            limiting = _limiting_resource(
                req, {r: int(cap[i, j]) for r, j in ridx.items()})
            if limiting:
                stats["resources"][limiting] = (
                    stats["resources"].get(limiting, 0) + 1)

    def _device_tree_arrays(self):
        """Lex-ordered per-level domain lists + parent index arrays
        (build_levels' layout, cached per snapshot)."""
        if self._device_tree is None:
            import numpy as np

            per_level = [sorted(self.domains_per_level[l].values(),
                                key=lambda d: d.level_values)
                         for l in range(len(self.levels))]
            index = [{d.id: i for i, d in enumerate(doms)}
                     for doms in per_level]
            parents = []
            for l, doms in enumerate(per_level):
                if l == 0:
                    parents.append(np.zeros(len(doms), dtype=np.int32))
                else:
                    parents.append(np.asarray(
                        [index[l - 1][d.id[:-1]] for d in doms],
                        dtype=np.int32))
            self._device_tree = (parents, per_level)
        return self._device_tree

    @staticmethod
    def _untolerated(node: Node, tolerations: list[Toleration]):
        for taint in node.taints:
            if taint.effect not in ("NoSchedule", "NoExecute"):
                continue
            if not any(t.tolerates(taint) for t in tolerations):
                return taint
        return None

    def _roll_up(self, dom: Domain, slice_size: int, slice_level_idx: int,
                 level: int, leader_required: bool) -> None:
        """fillInCountsHelper (tas_flavor_snapshot.go:1658-1719)."""
        if not dom.children:
            if level == slice_level_idx:
                dom.slice_state = dom.state // slice_size
                dom.slice_state_with_leader = (
                    dom.state_with_leader // slice_size)
            return
        total = 0
        slice_total = 0
        has_leader_contributor = False
        min_state_diff = 1 << 30
        min_slice_diff = 1 << 30
        leader_state = 0
        for child in dom.children:
            self._roll_up(child, slice_size, slice_level_idx, level + 1,
                          leader_required)
            total += child.state
            slice_total += child.slice_state
            if not leader_required or child.leader_state > 0:
                has_leader_contributor = True
                min_state_diff = min(
                    min_state_diff, child.state - child.state_with_leader)
                min_slice_diff = min(
                    min_slice_diff,
                    child.slice_state - child.slice_state_with_leader)
            leader_state = max(leader_state, child.leader_state)
        dom.state = total
        dom.leader_state = leader_state
        slice_with_leader = 0
        if has_leader_contributor:
            dom.state_with_leader = total - min_state_diff
            slice_with_leader = slice_total - min_slice_diff
        else:
            dom.state_with_leader = 0
        if level == slice_level_idx:
            slice_total = dom.state // slice_size
            slice_with_leader = dom.state_with_leader // slice_size
        dom.slice_state = slice_total
        dom.slice_state_with_leader = slice_with_leader

    # ------------------------------------------------------------------
    # Phase 2: placement
    # ------------------------------------------------------------------

    def _place(
        self,
        tr: TASPodSetRequest,
        leader: Optional[TASPodSetRequest],
        assumed,
        simulate_empty: bool,
        required_replacement_domain: Optional[tuple[str, ...]] = None,
        excluded_node: Optional[str] = None,
    ) -> tuple[dict[str, TopologyAssignment], str]:
        """findTopologyAssignment (tas_flavor_snapshot.go:804-999)."""
        tr_req = tr.podset.topology_request
        required = tr_req is not None and tr_req.required is not None
        unconstrained = (
            (tr_req is not None and tr_req.unconstrained) or tr.implied
            or (tr_req is not None
                and tr_req.podset_slice_required_topology is not None
                and tr_req.required is None and tr_req.preferred is None))

        key = self._level_key(tr.podset, tr.implied)
        if key is None:
            return {}, "topology level not specified"
        level_idx = self.level_index(key)
        if level_idx is None:
            return {}, f"no requested topology level: {key}"

        slice_size = 1
        slice_level_idx = len(self.levels) - 1
        if tr_req is not None and tr_req.podset_slice_required_topology:
            idx = self.level_index(tr_req.podset_slice_required_topology)
            if idx is None:
                return {}, (
                    "no requested topology level for slices: "
                    f"{tr_req.podset_slice_required_topology}")
            slice_level_idx = idx
            if tr_req.podset_slice_size is None:
                return {}, "slice topology requested, but slice size not provided"
            slice_size = tr_req.podset_slice_size
            if level_idx > slice_level_idx:
                return {}, (
                    f"podset slice topology "
                    f"{tr_req.podset_slice_required_topology} is above the "
                    f"podset topology {key}")
            if tr.count % slice_size != 0:
                return {}, (
                    f"pod count {tr.count} not divisible by slice size "
                    f"{slice_size}")

        slice_size_at_level, reason = self._build_slice_size_at_level(
            tr_req, slice_size, slice_level_idx)
        if reason:
            return {}, reason

        leader_count = 1 if leader is not None else 0
        stats = self._fill_in_counts(
            tr, leader, assumed, simulate_empty, slice_size, slice_level_idx,
            required_replacement_domain, excluded_node=excluded_node)

        least_free = unconstrained and self.profile_mixed

        # balanced placement (gate TASBalancedPlacement; preferred-level
        # requests only — tas_flavor_snapshot.go:906-917)
        use_balanced = False
        fit_domains = None
        fit_level = level_idx
        if (features.enabled("TASBalancedPlacement") and not required
                and not unconstrained):
            cand, threshold = self._find_best_balanced(
                level_idx, slice_level_idx, tr.count, leader_count,
                slice_size)
            if threshold > 0:
                fit_domains, fit_level, reason = self._apply_balanced(
                    cand, level_idx, slice_level_idx, tr.count,
                    leader_count, slice_size, threshold)
                if reason:
                    return {}, reason
                use_balanced = True

        if not use_balanced:
            fit_level, fit_domains, reason = self._find_level_with_fit(
                level_idx, tr.count, leader_count, slice_size, required,
                unconstrained, least_free, stats)
            if reason:
                return {}, reason
            fit_domains = self._consume_minimum(
                fit_domains, tr.count, leader_count, slice_size, least_free,
                slices=True)
        cur_level = fit_level
        while (cur_level < min(len(self.levels) - 1, slice_level_idx)
               and not use_balanced):
            lower = [c for d in fit_domains for c in d.children]
            fit_domains = self._consume_minimum(
                self._sorted(lower, least_free), tr.count, leader_count,
                slice_size, least_free, slices=True)
            cur_level += 1
        while cur_level < len(self.levels) - 1:
            # below (or, after balanced placement, possibly still above)
            # the outermost slice level: per-parent assignment, with inner
            # slice layers re-grouping children at their own size
            # (tas_flavor_snapshot.go:938-971)
            if cur_level < slice_level_idx:
                size_on_level = slice_size
            else:
                size_on_level = slice_size_at_level.get(cur_level + 1, 1)
            new_fit: list[Domain] = []
            for dom in fit_domains:
                if size_on_level > 1:
                    # the pre-filled sliceState was computed for the
                    # outermost slice level; inner layers re-derive it
                    # BEFORE sorting (the sort keys on slice_state)
                    for d in dom.children:
                        d.slice_state = d.state // size_on_level
                        d.slice_state_with_leader = (
                            d.state_with_leader // size_on_level)
                children = self._sorted(dom.children, least_free)
                new_fit.extend(self._consume_minimum(
                    children, dom.state, dom.leader_state, size_on_level,
                    least_free, slices=size_on_level > 1))
            fit_domains = new_fit
            cur_level += 1

        assignments: dict[str, TopologyAssignment] = {}
        if leader is not None:
            leader_domains = []
            worker_domains = []
            for dom in fit_domains:
                if dom.leader_state > 0:
                    copy = Domain(dom.id, dom.level_values)
                    copy.state = dom.leader_state
                    leader_domains.append(copy)
                if dom.state > 0:
                    worker_domains.append(dom)
            assignments[leader.podset.name] = self._build(leader_domains)
            fit_domains = worker_domains
        assignments[tr.podset.name] = self._build(fit_domains)
        return assignments, ""

    # ------------------------------------------------------------------
    # multi-layer slice constraints (buildSliceSizeAtLevel,
    # tas_flavor_snapshot.go:1001-1060)
    # ------------------------------------------------------------------

    def _build_slice_size_at_level(self, tr_req, slice_size: int,
                                   slice_level_idx: int):
        """Level index -> inner slice size for nested slice layers.

        The first constraint mirrors the outer slice (skipped); each
        inner layer must sit strictly below its parent layer and evenly
        divide its size; intermediate levels inherit the layer's size so
        they distribute in multiples of it."""
        out: dict[int, int] = {}
        if (not features.enabled("TASMultiLayerTopology") or tr_req is None
                or not tr_req.podset_slice_constraints):
            return out, ""
        layers = tr_req.podset_slice_constraints
        inner = layers[1:] if len(layers) > 1 else []
        prev_size = slice_size
        prev_idx = slice_level_idx
        for layer in inner:
            idx = self.level_index(layer.topology)
            if idx is None:
                return None, ("no requested topology level for additional "
                              f"slice layer: {layer.topology}")
            if idx <= prev_idx:
                return None, (
                    f"additional slice layer topology {layer.topology} must "
                    f"be at a lower level than {self.levels[prev_idx]}")
            if prev_size % layer.size != 0:
                return None, (
                    f"additional slice layer size {layer.size} must evenly "
                    f"divide parent layer size {prev_size}")
            for lvl in range(prev_idx + 1, idx + 1):
                out[lvl] = layer.size
            prev_size = layer.size
            prev_idx = idx
        return out, ""

    # ------------------------------------------------------------------
    # balanced placement (tas_balanced_placement.go)
    # ------------------------------------------------------------------

    def _clone_domain(self, d: Domain) -> Domain:
        c = Domain(d.id, d.level_values)
        c.state = d.state
        c.state_with_leader = d.state_with_leader
        c.slice_state = d.slice_state
        c.slice_state_with_leader = d.slice_state_with_leader
        c.leader_state = d.leader_state
        c.children = [self._clone_domain(ch) for ch in d.children]
        return c

    @staticmethod
    def _clear_state(d: Domain) -> None:
        d.state = d.slice_state = 0
        d.state_with_leader = d.slice_state_with_leader = 0
        d.leader_state = 0
        for c in d.children:
            TASFlavorSnapshot._clear_state(c)

    @staticmethod
    def _clear_leader_capacity(d: Domain) -> None:
        d.state_with_leader = d.slice_state_with_leader = 0
        d.leader_state = 0
        for c in d.children:
            TASFlavorSnapshot._clear_leader_capacity(c)

    def _evaluate_greedy(self, domains: list[Domain], slice_count: int,
                         leader_count: int):
        """evaluateGreedyAssignment: (fits, #domains used, last domain
        with leader, last domain without)."""
        selected = 0
        last = last_with_leader = None
        rem_slices = slice_count
        rem_leaders = leader_count
        idx = 0
        if leader_count > 0:
            sorted_wl = self._sorted_with_leader(domains, False)
            while (rem_leaders > 0 and idx < len(sorted_wl)
                   and sorted_wl[idx].leader_state > 0):
                selected += 1
                last_with_leader = sorted_wl[idx]
                rem_leaders -= sorted_wl[idx].leader_state
                rem_slices -= sorted_wl[idx].slice_state_with_leader
                idx += 1
            rest = self._sorted(sorted_wl[idx:], False)
        else:
            rest = self._sorted(domains, False)
        if rem_leaders > 0:
            return False, 0, None, None
        i = 0
        while rem_slices > 0 and i < len(rest) and rest[i].slice_state > 0:
            selected += 1
            last = rest[i]
            rem_slices -= rest[i].slice_state
            i += 1
        if rem_slices > 0:
            return False, 0, None, None
        return True, selected, last_with_leader, last

    @staticmethod
    def _balance_threshold(slice_count: int, selected: int,
                           last_with_leader, last) -> int:
        """Max possible minimum slices per domain in a balanced plan."""
        threshold = slice_count // selected
        if last_with_leader is not None:
            threshold = min(threshold,
                            last_with_leader.slice_state_with_leader)
        if last is not None:
            threshold = min(threshold, last.slice_state)
        return threshold

    def _prune_below_threshold(self, domains: list[Domain], threshold: int,
                               slice_size: int, slice_level_idx: int,
                               level: int, leader_required: bool) -> None:
        """pruneDomainsBelowThreshold: drop capacity of subtrees that
        cannot hold `threshold` slices, then re-roll counts."""
        def prune_node(d: Domain) -> None:
            if d.slice_state < threshold:
                self._clear_state(d)
                return
            if (leader_required and d.leader_state > 0
                    and d.slice_state_with_leader < threshold):
                self._clear_leader_capacity(d)

        for d in domains:
            for c in d.children:
                prune_node(c)
        for d in domains:
            self._roll_up(d, slice_size, slice_level_idx, level,
                          leader_required)
            prune_node(d)

    @staticmethod
    def _entropy(sizes: list[int]) -> float:
        total = sum(sizes)
        if total <= 0:
            return 0.0
        e = 0.0
        for s in sizes:
            if s > 0:
                p = s / total
                e += -p * math.log2(p)
        return e

    def _select_optimal_set(self, domains: list[Domain], slice_count: int,
                            leader_count: int, slice_size: int,
                            by_entropy: bool) -> Optional[list[Domain]]:
        """selectOptimalDomainSetToFit: DP over domains finding a set of
        exactly the greedy-minimal cardinality that fits leaders+slices,
        preferring the tightest total capacity."""
        fits, optimal_n, _, _ = self._evaluate_greedy(
            domains, slice_count, leader_count)
        if not fits:
            return None
        if by_entropy:
            domains = sorted(domains, key=lambda d: (
                -d.leader_state, -d.slice_state_with_leader,
                -self._entropy([c.state for c in d.children])))
        # placements[i][(leaders_left, capacity_left)] -> domain list
        placements: list[dict[tuple[int, int], list[Domain]]] = [
            {} for _ in range(optimal_n + 1)]
        placements[0][(leader_count, slice_count * slice_size)] = []
        for d in domains:
            for i in range(optimal_n, 0, -1):
                for (lead, cap) in sorted(placements[i - 1]):
                    if lead <= 0 and cap <= 0:
                        continue
                    before = placements[i - 1][(lead, cap)]
                    nxt = before + [d]
                    if lead > 0 and d.leader_state > 0:
                        k = (lead - d.leader_state,
                             cap - d.state_with_leader)
                        placements[i].setdefault(k, nxt)
                    if d.slice_state > 0:
                        k = (lead, cap - d.state)
                        placements[i].setdefault(k, nxt)
        best_cap = None
        best = None
        for (lead, cap), doms in placements[optimal_n].items():
            if lead == 0 and cap <= 0 and (best_cap is None
                                           or cap > best_cap):
                best_cap = cap
                best = doms
        return best

    def _place_slices_balanced(self, domains: list[Domain],
                               slice_count: int, leader_count: int,
                               slice_size: int, threshold: int):
        """placeSlicesOnDomainsBalanced: give every selected domain
        `threshold` slices, distributing the remainder (and leaders)
        front-first."""
        result = self._select_optimal_set(domains, slice_count,
                                          leader_count, slice_size, False)
        if result is None:
            return None, ("TAS Balanced Placement: Cannot find optimal "
                          "domain set to fit the request")
        if slice_count < len(result) * threshold:
            return None, ("TAS Balanced Placement: Not enough slices to "
                          "meet the threshold")
        result = self._sorted_with_leader(result, False)
        extra_left = slice_count - len(result) * threshold
        leaders_left = leader_count
        for dom in result:
            if leaders_left > 0:
                take = min(dom.slice_state_with_leader - threshold,
                           extra_left)
                dom.leader_state = 1
                leaders_left -= 1
            elif extra_left > 0:
                take = min(dom.slice_state - threshold, extra_left)
                dom.leader_state = 0
            else:
                dom.leader_state = 0
                take = 0
            dom.state = (threshold + take) * slice_size
            dom.slice_state = threshold + take
            dom.slice_state_with_leader = dom.slice_state
            dom.state_with_leader = dom.state - dom.leader_state
            extra_left -= take
        if extra_left > 0 or leaders_left > 0:
            return None, ("TAS Balanced Placement: Not all slices or "
                          "leaders could be placed")
        return result, ""

    def _find_best_balanced(self, level_idx: int, slice_level_idx: int,
                            count: int, leader_count: int,
                            slice_size: int):
        """findBestDomainsForBalancedPlacement: per sibling group at the
        requested level, compute the balance threshold, prune, and keep
        the best (highest threshold, then fewest domains)."""
        slice_count = count // slice_size

        def lower(doms):
            if level_idx < slice_level_idx:
                return [c for d in doms for c in d.children]
            return doms

        if level_idx == 0:
            groups = [list(self.domains_per_level[0].values())]
        else:
            groups = [list(d.children)
                      for d in self.domains_per_level[level_idx - 1].values()]

        best_threshold = 0
        best_count = 0
        best: Optional[list[Domain]] = None
        for siblings in groups:
            cand = [self._clone_domain(d) for d in siblings]
            fits, selected, lwl, last = self._evaluate_greedy(
                lower(cand), slice_count, leader_count)
            if not fits:
                continue
            threshold = self._balance_threshold(slice_count, selected,
                                                lwl, last)
            thr_leader = threshold
            if leader_count > 0 and last is not None:
                thr_leader = min(threshold, last.slice_state_with_leader)
            if threshold < best_threshold:
                continue
            self._prune_below_threshold(
                cand, threshold, slice_size, slice_level_idx, level_idx,
                leader_count > 0)
            ok, n_doms, _, _ = self._evaluate_greedy(
                cand, slice_count, leader_count)
            if not ok and thr_leader < threshold:
                # retry at the lower threshold that reserves leader room
                if thr_leader <= 0 or thr_leader < best_threshold:
                    continue
                threshold = thr_leader
                cand = [self._clone_domain(d) for d in siblings]
                self._prune_below_threshold(
                    cand, threshold, slice_size, slice_level_idx,
                    level_idx, leader_count > 0)
                ok, n_doms, _, _ = self._evaluate_greedy(
                    cand, slice_count, leader_count)
            if not ok:
                continue
            if threshold > best_threshold or (
                    threshold == best_threshold
                    and (best is None or n_doms < best_count)):
                best_threshold = threshold
                best_count = n_doms
                best = cand
        return best, best_threshold

    def _apply_balanced(self, cand: list[Domain], level_idx: int,
                        slice_level_idx: int, count: int,
                        leader_count: int, slice_size: int,
                        threshold: int):
        """applyBalancedPlacementAlgorithm: select the optimal set (one
        level down when the request sits above the slice level) and
        distribute slices evenly."""
        slice_count = count // slice_size
        if level_idx < slice_level_idx:
            result = self._select_optimal_set(
                cand, slice_count, leader_count, slice_size, True)
            if result is None:
                return None, 0, ("TAS Balanced Placement: Cannot find "
                                 "optimal domain set to fit the request")
            cand = [c for d in result for c in d.children]
            fit_level = level_idx + 1
        else:
            fit_level = level_idx
        cand, reason = self._place_slices_balanced(
            cand, slice_count, leader_count, slice_size, threshold)
        if reason:
            return None, 0, reason
        return cand, fit_level, ""

    def _find_level_with_fit(self, level_idx: int, count: int,
                             leader_count: int, slice_size: int,
                             required: bool, unconstrained: bool,
                             least_free: bool, stats) -> tuple:
        """findLevelWithFitDomains (tas_flavor_snapshot.go:1236-1321)."""
        domains = list(self.domains_per_level[level_idx].values())
        if not domains:
            return 0, None, f"no topology domains at level: {self.levels[level_idx]}"
        sorted_doms = self._sorted_with_leader(domains, least_free)
        top = sorted_doms[0]
        slice_count = count // slice_size

        if (not least_free and top.slice_state_with_leader >= slice_count
                and top.leader_state >= leader_count):
            top = self._best_fit_slices(sorted_doms, slice_count, leader_count)

        if least_free:
            for cand in sorted_doms:
                if cand.slice_state >= slice_count:
                    return level_idx, [cand], ""
            if required:
                return 0, None, self._not_fit_message(
                    sorted_doms[-1].state, slice_count, slice_size, stats)

        if top.slice_state_with_leader < slice_count or (
                top.leader_state < leader_count):
            if required:
                return 0, None, self._not_fit_message(
                    top.slice_state, slice_count, slice_size, stats)
            if level_idx > 0 and not unconstrained:
                return self._find_level_with_fit(
                    level_idx - 1, count, leader_count, slice_size, required,
                    unconstrained, least_free, stats)
            # accumulate multiple domains greedily, leaders first
            results: list[Domain] = []
            remaining_slices = slice_count
            remaining_leaders = leader_count
            idx = 0
            while (remaining_leaders > 0 and idx < len(sorted_doms)
                   and sorted_doms[idx].leader_state > 0):
                dom = sorted_doms[idx]
                if (not least_free
                        and dom.slice_state_with_leader >= remaining_slices):
                    dom = self._best_fit_slices(
                        sorted_doms[idx:], remaining_slices, remaining_leaders)
                results.append(dom)
                remaining_leaders -= dom.leader_state
                remaining_slices -= dom.slice_state_with_leader
                idx += 1
            if remaining_leaders > 0:
                return 0, None, self._not_fit_message(
                    leader_count - remaining_leaders, slice_count, slice_size,
                    stats)
            rest = self._sorted(sorted_doms[idx:], least_free)
            for i in range(len(rest)):
                if remaining_slices <= 0:
                    break
                dom = rest[i]
                if not least_free and dom.slice_state >= remaining_slices:
                    dom = self._best_fit_slices(rest[i:], remaining_slices, 0)
                results.append(dom)
                remaining_slices -= dom.slice_state
            if remaining_slices > 0:
                return 0, None, self._not_fit_message(
                    slice_count - remaining_slices, slice_count, slice_size,
                    stats)
            return level_idx, results, ""
        return level_idx, [top], ""

    @staticmethod
    def _best_fit_slices(domains: list[Domain], needed: int,
                         leader_count: int) -> Domain:
        """First domain with the smallest sufficient capacity
        (findBestFitDomainBy, tas_flavor_snapshot.go:1216-1231)."""
        def state(d: Domain) -> int:
            return (d.slice_state_with_leader if leader_count > 0
                    else d.slice_state)

        best = domains[0]
        for dom in domains:
            if needed <= state(dom) < state(best):
                best = dom
        return best

    @staticmethod
    def _best_fit_pods(domains: list[Domain], needed: int,
                       leader_count: int) -> Domain:
        def state(d: Domain) -> int:
            return d.state_with_leader if leader_count > 0 else d.state

        best = domains[0]
        for dom in domains:
            if needed <= state(dom) < state(best):
                best = dom
        return best

    def _consume_minimum(self, domains: list[Domain], count: int,
                         leader_count: int, slice_size: int,
                         least_free: bool, slices: bool) -> list[Domain]:
        """Assign `count` pods (or count/slice_size slices) onto the fewest
        domains, leaders first (updateCountsToMinimumGeneric,
        tas_flavor_snapshot.go:1405-1469)."""
        result: list[Domain] = []
        remaining = count // slice_size if slices else count
        remaining_leaders = leader_count
        for i, dom in enumerate(domains):
            if remaining_leaders > 0:
                dom, done = self._consume_with_leader(
                    dom, domains[i:], remaining, remaining_leaders,
                    least_free, slice_size, slices)
                if done:
                    result.append(dom)
                    return result
                if slices:
                    remaining -= dom.slice_state_with_leader
                    remaining_leaders -= dom.leader_state
                else:
                    remaining -= dom.state_with_leader
                    remaining_leaders -= dom.leader_state
                result.append(dom)
                continue
            if slices:
                if not least_free and dom.slice_state >= remaining:
                    dom = self._best_fit_slices(domains[i:], remaining, 0)
                dom.leader_state = 0
                if dom.slice_state >= remaining:
                    dom.state = remaining * slice_size
                    dom.slice_state = remaining
                    result.append(dom)
                    return result
                dom.state = dom.slice_state * slice_size
                remaining -= dom.slice_state
                result.append(dom)
            else:
                if not least_free and dom.state >= remaining:
                    dom = self._best_fit_pods(domains[i:], remaining, 0)
                dom.leader_state = 0
                if dom.state >= remaining:
                    dom.state = remaining
                    result.append(dom)
                    return result
                remaining -= dom.state
                result.append(dom)
        # all domains consumed; remaining should be 0 when callers sized
        # the domain set correctly
        return result

    def _consume_with_leader(self, dom: Domain, rest: list[Domain],
                             remaining: int, remaining_leaders: int,
                             least_free: bool, slice_size: int,
                             slices: bool) -> tuple[Domain, bool]:
        """consumeWithLeadersGeneric (tas_flavor_snapshot.go:1348-1403)."""
        def with_leader(d: Domain) -> int:
            return d.slice_state_with_leader if slices else d.state_with_leader

        if (not least_free and with_leader(dom) >= remaining
                and dom.leader_state >= remaining_leaders):
            if slices:
                dom = self._best_fit_slices(rest, remaining, remaining_leaders)
            else:
                dom = self._best_fit_pods(rest, remaining, remaining_leaders)
        if with_leader(dom) >= remaining and dom.leader_state >= remaining_leaders:
            if slices:
                dom.slice_state = remaining
                dom.slice_state_with_leader = remaining
            else:
                dom.state_with_leader = remaining
            dom.leader_state = remaining_leaders
            dom.state = remaining * slice_size if slices else remaining
            return dom, True
        if slices:
            dom.slice_state_with_leader = min(
                dom.slice_state_with_leader, remaining)
            dom.leader_state = min(dom.leader_state, remaining_leaders)
            dom.state = dom.slice_state_with_leader * slice_size
        else:
            dom.state_with_leader = min(dom.state_with_leader, remaining)
            dom.leader_state = min(dom.leader_state, remaining_leaders)
            dom.state = dom.state_with_leader
        return dom, False

    # -- sorting (sortedDomains / sortedDomainsWithLeader) ------------------

    def _sorted(self, domains: list[Domain], least_free: bool) -> list[Domain]:
        if least_free:
            return sorted(domains, key=lambda d: (
                d.slice_state, d.state, d.level_values))
        return sorted(domains, key=lambda d: (
            -d.slice_state, d.state, d.level_values))

    def _sorted_with_leader(self, domains: list[Domain],
                            least_free: bool) -> list[Domain]:
        if least_free:
            return sorted(domains, key=lambda d: (
                -d.leader_state, d.slice_state_with_leader,
                d.state_with_leader, d.level_values))
        return sorted(domains, key=lambda d: (
            -d.leader_state, -d.slice_state_with_leader,
            d.state_with_leader, d.level_values))

    # -- output -------------------------------------------------------------

    def _build(self, domains: list[Domain]) -> TopologyAssignment:
        """buildAssignment (tas_flavor_snapshot.go:1490-1501): lex order;
        hostname-only values when the lowest level is the hostname."""
        domains = sorted(domains, key=lambda d: d.level_values)
        level_idx = len(self.levels) - 1 if self.is_lowest_level_node else 0
        return TopologyAssignment(
            levels=self.levels[level_idx:],
            domains=[
                TopologyDomainAssignment(
                    values=list(d.level_values[level_idx:]), count=d.state)
                for d in domains if d.state > 0
            ],
        )

    def _not_fit_message(self, fit, total, slice_size, stats) -> str:
        unit = "pod" if slice_size == 1 else "slice"
        if fit <= 0:
            msg = (f"topology {self.topology_name!r} doesn't allow to fit any "
                   f"of {total} {unit}(s)")
        else:
            msg = (f"topology {self.topology_name!r} allows to fit only "
                   f"{fit} out of {total} {unit}(s)")
        exclusions = []
        if stats["taints"]:
            exclusions.append(f"taints: {stats['taints']}")
        if stats["selector"]:
            exclusions.append(f"nodeSelector: {stats['selector']}")
        if stats["domain"]:
            exclusions.append(f"topologyDomain: {stats['domain']}")
        for res, cnt in sorted(stats["resources"].items()):
            exclusions.append(f"resource {res!r}: {cnt}")
        if exclusions:
            msg += (f". Total nodes: {stats['total']}; excluded: "
                    + ", ".join(exclusions))
        return msg


def build_tas_flavor_snapshot(
    topology_name: str,
    levels: list[str],
    nodes: Iterable[Node],
    flavor_node_labels: Optional[dict[str, str]] = None,
    tolerations: Optional[list[Toleration]] = None,
    profile_mixed: Optional[bool] = None,
    device="cuda",
) -> TASFlavorSnapshot:
    """Build and initialize a snapshot from ready nodes matching the
    flavor's nodeLabels (tas_flavor.go / tas_nodes_cache.go analog).
    profile_mixed defaults from the TASProfileMixed gate; ``device`` is
    where the fill-in counts run under TASDeviceFillCounts."""
    if profile_mixed is None:
        profile_mixed = features.enabled("TASProfileMixed")
    snap = TASFlavorSnapshot(topology_name, levels, tolerations,
                             profile_mixed=profile_mixed, device=device)
    # phase-1 fill-in counts on the device, every phase-2 tie-break
    # (balanced DP, multilayer descent) host-side
    snap.use_device_fill = features.enabled("TASDeviceFillCounts")
    selector = flavor_node_labels or {}
    for node in nodes:
        if not node.ready:
            continue
        if all(node.labels.get(k) == v for k, v in selector.items()):
            snap.add_node(node)
    snap.initialize()
    return snap

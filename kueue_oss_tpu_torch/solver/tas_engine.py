"""Device TAS placement for the solver drain.

Port of ``kueue_oss_tpu/solver/tas_engine.py``: TAS workloads whose
shapes the extended placer supports (single podset; required, preferred
or unconstrained levels; single-layer podset slices; BestFit and
LeastFreeCapacity profiles) are admitted by the quota drain like any
other workload, then placed on the device by the sequential placer in
admission order. A placement failure drops the admission from the
committed plan: the workload stays queued.

Reference parity: scheduler.go:759-783 (TAS assignment after quota),
tas_flavor_snapshot.go:804-999 (findTopologyAssignment).
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from kueue_oss_tpu_torch import features
from kueue_oss_tpu_torch.api.types import (
    TopologyAssignment,
    TopologyDomainAssignment,
)
from kueue_oss_tpu_torch.core.workload_info import (
    WorkloadInfo,
    effective_per_pod_requests,
)
from kueue_oss_tpu_torch.solver import cuda_tas
from kueue_oss_tpu_torch.solver.tas_kernels import build_levels


def _topology_of_cq(store, spec) -> Optional[str]:
    """The single topology shared by EVERY flavor of the CQ, or None
    when the CQ mixes TAS and non-TAS flavors (or topologies)."""
    topo = None
    for rg in spec.resource_groups:
        for fq in rg.flavors:
            fl = store.resource_flavors.get(fq.name)
            if fl is None or fl.topology_name is None:
                return None
            if topo is None:
                topo = fl.topology_name
            elif fl.topology_name != topo:
                return None
    return topo


def _is_unconstrained(ps) -> bool:
    """The host's unconstrained test, including the implied and
    slice-only forms."""
    tr = ps.topology_request
    if tr is None:
        return True  # implied request on a TAS-only CQ
    if tr.unconstrained:
        return True
    return (tr.podset_slice_required_topology is not None
            and tr.required is None and tr.preferred is None)


def device_tas_supported(info: WorkloadInfo, store, spec) -> bool:
    """Shape gate: can the device placer reproduce the host placement
    for this workload exactly?"""
    if _topology_of_cq(store, spec) is None:
        return False
    if len(info.obj.podsets) != 1:
        return False  # leaders / groups / multi-podset: host path
    if info.obj.status.unhealthy_nodes:
        return False  # node replacement is host-only
    if info.can_be_partially_admitted():
        return False  # PodSetReducer search is host-only
    tr = info.obj.podsets[0].topology_request
    if tr is not None:
        if tr.podset_group_name:
            return False
        if tr.podset_slice_constraints and len(
                tr.podset_slice_constraints) > 1:
            return False  # nested multi-layer slices: host DP
        if (features.enabled("TASBalancedPlacement")
                and tr.required is None
                and not _is_unconstrained(info.obj.podsets[0])):
            return False  # balanced placement DP is host-only
    return True


class DeviceTASPlacer:
    """Places drain-admitted TAS workloads with the sequential device
    placer: one ``cuda_tas.tas_place_sequential`` call per TAS flavor,
    one step per admission with the leaf-capacity carry between them."""

    def __init__(self, device) -> None:
        self.device = torch.device(device)
        #: full parent structure -> the checked tree with its offsets
        self._trees: dict[tuple, cuda_tas.PlacerTree] = {}

    def _tree_for(self, levels) -> cuda_tas.PlacerTree:
        key = tuple(np.asarray(p, dtype=np.int32).tobytes()
                    for p in levels.parents)
        tree = self._trees.get(key)
        if tree is None:
            tree = cuda_tas.PlacerTree(levels.parents)
            self._trees[key] = tree
        return tree

    def _place(self, tree, *inputs):
        """The batch's sequential placement (one kernel launch on a CUDA
        device); returns (sels, leads, oks, capacity after)."""
        return cuda_tas.tas_place_sequential(tree, *inputs)

    def place_batch(self, snapshot, items):
        """Place ``items`` (admission-ordered (info, flavor) pairs).
        Returns {workload key: TopologyAssignment | None}; None marks a
        placement failure."""
        out: dict[str, Optional[TopologyAssignment]] = {}
        by_flavor: dict[str, list] = {}
        for info, flavor in items:
            by_flavor.setdefault(flavor, []).append(info)

        for flavor, infos in by_flavor.items():
            snap = snapshot.tas_flavors.get(flavor)
            if snap is None:
                for info in infos:
                    out[info.key] = None
                continue
            levels = build_levels(snap)
            R = len(levels.resources)
            res_idx = {r: j for j, r in enumerate(levels.resources)}
            leaf_l = len(levels.parents) - 1
            M = len(infos)
            per_pod = np.zeros((M, max(1, R)), dtype=np.int32)
            count = np.zeros((M,), dtype=np.int32)
            level = np.zeros((M,), dtype=np.int32)
            required = np.zeros((M,), dtype=bool)
            unconstrained = np.zeros((M,), dtype=bool)
            least_free = np.zeros((M,), dtype=bool)
            sl_size = np.ones((M,), dtype=np.int32)
            sl_level = np.full((M,), leaf_l, dtype=np.int32)
            feasible = np.ones((M,), dtype=bool)
            for m, info in enumerate(infos):
                ps = info.obj.podsets[0]
                tr = ps.topology_request
                reqs = effective_per_pod_requests(ps, info.obj.namespace)
                for r, v in reqs.items():
                    j = res_idx.get(r)
                    if j is None:
                        if v > 0:
                            feasible[m] = False  # resource absent
                    else:
                        per_pod[m, j] = v
                count[m] = info.total_requests[0].count
                unc = _is_unconstrained(ps)
                unconstrained[m] = unc
                least_free[m] = unc and snap.profile_mixed
                key_level = None
                if tr is not None and tr.required is not None:
                    required[m] = True
                    key_level = tr.required
                elif tr is not None and tr.preferred is not None:
                    key_level = tr.preferred
                if unc or key_level is None:
                    level[m] = leaf_l
                else:
                    idx = snap.level_index(key_level)
                    if idx is None:
                        feasible[m] = False
                        idx = leaf_l
                    level[m] = idx
                if (tr is not None
                        and tr.podset_slice_required_topology is not None):
                    sidx = snap.level_index(
                        tr.podset_slice_required_topology)
                    if (sidx is None or tr.podset_slice_size is None
                            or level[m] > sidx
                            or count[m] % max(tr.podset_slice_size, 1)):
                        feasible[m] = False
                    else:
                        sl_level[m] = sidx
                        sl_size[m] = tr.podset_slice_size

            # rows the host pre-check rejected must not consume capacity
            bad = ~feasible
            count[bad] = 0
            per_pod[bad] = 0
            sl_size[bad] = 1
            tree = self._tree_for(levels)

            def dev(a):
                return torch.as_tensor(a, device=self.device)

            sels, _leads, oks, _cap = self._place(
                tree,
                dev(levels.leaf_capacity), dev(per_pod), dev(count),
                dev(level), dev(required), dev(unconstrained),
                dev(least_free), dev(sl_size), dev(sl_level),
                torch.zeros((M, max(1, R)), dtype=torch.int32,
                            device=self.device),
                torch.zeros((M,), dtype=torch.bool, device=self.device))
            sels = sels.cpu().numpy()
            oks = oks.cpu().numpy() & feasible
            # buildAssignment parity (tas_flavor_snapshot.go:1490-1501):
            # hostname-only values when the lowest level is the hostname
            lvl0 = (len(snap.levels) - 1 if snap.is_lowest_level_node
                    else 0)
            for m, info in enumerate(infos):
                if not oks[m]:
                    out[info.key] = None
                    continue
                domains = [
                    TopologyDomainAssignment(
                        values=list(levels.leaf_names[d][lvl0:]),
                        count=int(sels[m, d]))
                    for d in np.nonzero(sels[m])[0]
                ]
                out[info.key] = TopologyAssignment(
                    levels=list(snap.levels[lvl0:]), domains=domains)
        return out

"""Snapshot -> dense tensor export for the lean drain.

Port of ``kueue_oss_tpu/solver/tensors.py``: the cohort forest flattens
into parents-first node arrays over a global (flavor, resource)
vocabulary, and the pending backlog into per-workload flavor-option
request tensors. Quantities are int32 after gcd-based unit scaling.

Only the lean (fit-only) shape is exported: ``include_admitted``,
``parked`` and ``afs`` exports and multi-resource-group ClusterQueues
raise ``UnsupportedProblem`` (the FULL drain is a later slice), and the
dataclass carries the lean fields only. Cut from the copy: the
cross-drain ``ExportCache`` and its columnar assembly view — the export
here is the classic per-workload walk.
"""

from __future__ import annotations

import dataclasses
import math
from collections import deque
from dataclasses import dataclass, field
from typing import Optional

import numpy as np

from kueue_oss_tpu_torch.api.types import (
    FlavorFungibilityPolicy,
    FlavorResource,
    QueueingStrategy,
    ResourceFlavor,
)
from kueue_oss_tpu_torch.core.snapshot import build_snapshot
from kueue_oss_tpu_torch.core.store import Store
from kueue_oss_tpu_torch.core.workload_info import (
    WorkloadInfo,
    effective_priority,
    queue_order_timestamp,
)

#: "infinity" for missing borrowing limits; headroom against overflow
BIG = np.int32(1 << 30)
#: quantities must stay below this after scaling so sums can't overflow
MAX_QUANTITY = 1 << 28


class UnsupportedProblem(Exception):
    """Raised when a backlog needs a drain this port does not have."""


def pow2(n: int) -> int:
    """Next power of two >= n (the padding bucket of every axis)."""
    p = 1
    while p < n:
        p *= 2
    return p


@dataclass
class SolverProblem:
    """Dense lean-drain instance. Node axis is [N+1] (last row = null
    node); workload axis is [W+1] (last row = null workload)."""

    # --- node (CQ + cohort) arrays, parents-first topo order -------------
    parent: np.ndarray        # [N+1] int32, null node index N for roots
    depth: np.ndarray         # [N+1] int32
    height: np.ndarray        # [N+1] int32 (cohort height; CQs are 0)
    has_parent: np.ndarray    # [N+1] bool
    path: np.ndarray          # [N+1, D] int32 ancestor chain, padded with N
    nominal: np.ndarray       # [N+1, F] int32
    subtree: np.ndarray       # [N+1, F] int32
    local_quota: np.ndarray   # [N+1, F] int32
    has_borrow: np.ndarray    # [N+1, F] bool
    borrow_limit: np.ndarray  # [N+1, F] int32 (BIG when unset)
    usage0: np.ndarray        # [N+1, F] int32

    # --- ClusterQueue arrays (C = number of CQs) --------------------------
    cq_node: np.ndarray       # [C] int32 node index of each CQ
    cq_strict: np.ndarray     # [C] bool (StrictFIFO)
    cq_try_next: np.ndarray   # [C] bool (whenCanBorrow == TryNextFlavor)
    cq_nflavors: np.ndarray   # [C] int32 number of flavor options

    # --- workload arrays --------------------------------------------------
    wl_cqid: np.ndarray       # [W+1] int32 CQ id (C for null)
    wl_rank: np.ndarray       # [W+1] int32 FIFO rank within its CQ
    wl_prio: np.ndarray       # [W+1] int32
    wl_ts: np.ndarray         # [W+1] int32 (dense timestamp rank)
    wl_uid: np.ndarray        # [W+1] int32
    wl_req: np.ndarray        # [W+1, K, F] int32 request under option k
    wl_valid: np.ndarray      # [W+1, K] bool option exists & selectable

    # --- host-side decode tables -----------------------------------------
    fr_list: list[FlavorResource] = field(default_factory=list)
    node_names: list[str] = field(default_factory=list)
    cq_names: list[str] = field(default_factory=list)
    wl_keys: list[str] = field(default_factory=list)
    #: per CQ: ordered flavor names (option k -> flavor)
    cq_option_flavors: dict[str, list[str]] = field(default_factory=dict)
    scale: int = 1

    @property
    def n_nodes(self) -> int:
        return self.parent.shape[0] - 1

    @property
    def n_cqs(self) -> int:
        return self.cq_node.shape[0]

    @property
    def n_workloads(self) -> int:
        return self.wl_cqid.shape[0] - 1


#: the lean drain's array fields, in declaration order
ARRAY_FIELDS = tuple(f.name for f in dataclasses.fields(SolverProblem)
                     if f.type == "np.ndarray")


def pad_workloads(problem: SolverProblem, target_w: int) -> SolverProblem:
    """Pad the workload axis to ``target_w`` rows (plus the null row).

    Padding rows carry the null CQ id (C), no valid options and rank
    BIG, so they are inert; ``wl_uid`` pads with BIG so padding never
    aliases a real uid. Inert rows go BEFORE the null row, which stays
    the last row.
    """
    W = problem.n_workloads
    if target_w <= W:
        return problem
    pad = target_w - W

    def pad1(arr, fill):
        filler = np.full((pad,) + arr.shape[1:], fill, dtype=arr.dtype)
        return np.concatenate([arr[:-1], filler, arr[-1:]])

    return dataclasses.replace(
        problem,
        wl_cqid=pad1(problem.wl_cqid, problem.n_cqs),
        wl_rank=pad1(problem.wl_rank, BIG),
        wl_prio=pad1(problem.wl_prio, 0),
        wl_ts=pad1(problem.wl_ts, 0),
        wl_uid=pad1(problem.wl_uid, BIG),
        wl_req=pad1(problem.wl_req, 0),
        wl_valid=pad1(problem.wl_valid, False),
        wl_keys=list(problem.wl_keys) + [""] * pad,
    )


def _untolerated_taint(podset, flavor: ResourceFlavor):
    tolerations = list(podset.tolerations) + list(flavor.tolerations)
    for taint in flavor.node_taints:
        if taint.effect not in ("NoSchedule", "NoExecute"):
            continue
        if not any(t.tolerates(taint) for t in tolerations):
            return taint
    return None


def _selector_matches(podset, flavor: ResourceFlavor,
                      allowed_keys: frozenset[str]) -> bool:
    """Node-selector subset match against the flavor's node labels,
    restricted to keys the resource group's flavors define."""
    for k, v in podset.node_selector.items():
        if k in allowed_keys and flavor.node_labels.get(k) != v:
            return False
    return True


def _flavor_compatible(info: WorkloadInfo, flavor: ResourceFlavor,
                       allowed_keys: frozenset[str]) -> bool:
    for ps in info.obj.podsets:
        if _untolerated_taint(ps, flavor) is not None:
            return False
        if not _selector_matches(ps, flavor, allowed_keys):
            return False
    return True


def order_nodes(forest) -> list:
    """Cohort-forest nodes in parents-first BFS order — the node axis."""
    nodes = []
    queue: deque = deque()
    for root in forest.roots():
        queue.append(root)
        while queue:
            n = queue.popleft()
            nodes.append(n)
            queue.extend(n.children.values())
    return nodes


def _workload_options(store: Store, info: WorkloadInfo, spec,
                      fr_index: dict, K: int, F: int):
    """(valid [K], req [K, F]) of one workload: for each flavor option,
    whether it is selectable and the request totals it would charge."""
    wl = info.obj
    valid = np.zeros(K, dtype=bool)
    req = np.zeros((K, F), dtype=np.int64)
    totals: dict[str, int] = {}
    for psr in info.total_requests:
        for rname, q in psr.requests.items():
            totals[rname] = totals.get(rname, 0) + q
    covered = {r for rg in spec.resource_groups
               for r in rg.covered_resources}
    if not spec.resource_groups or any(
            q > 0 and r not in covered for r, q in totals.items()):
        # undeclared resource: no option can ever fit (oracle parity)
        return valid, req
    k = -1
    for rg in spec.resource_groups:
        allowed_keys = frozenset(
            key for fq in rg.flavors
            for key in store.resource_flavors.get(
                fq.name, ResourceFlavor(name=fq.name)).node_labels)
        for fq in rg.flavors:
            k += 1
            flavor = store.resource_flavors.get(fq.name)
            if flavor is None:
                continue
            if (wl.allowed_flavor is not None
                    and fq.name != wl.allowed_flavor):
                continue
            if not _flavor_compatible(info, flavor, allowed_keys):
                continue
            valid[k] = True
            for rname, q in totals.items():
                if rname in rg.covered_resources:
                    req[k, fr_index[(fq.name, rname)]] = q
    return valid, req


def export_problem(
    store: Store,
    pending: dict[str, list[WorkloadInfo]],
    include_admitted: bool = False,
    parked: Optional[dict] = None,
    afs=None,
) -> SolverProblem:
    """Build the lean SolverProblem from the store and the backlog.

    ``pending`` maps CQ name -> workloads in FIFO-heap (rank) order.
    Shapes outside the lean drain raise UnsupportedProblem.
    """
    if include_admitted or parked or afs is not None:
        raise UnsupportedProblem(
            "admitted/parked/AFS exports feed the FULL drain, which this "
            "port does not have yet")
    for name in pending:
        if len(store.cluster_queues[name].resource_groups) > 1:
            raise UnsupportedProblem(
                f"ClusterQueue {name} has multiple resource groups")
    forest = build_snapshot(store).forest

    nodes = order_nodes(forest)
    index = {id(n): i for i, n in enumerate(nodes)}
    n_nodes = len(nodes)
    null = n_nodes

    # ---- FR vocabulary ---------------------------------------------------
    frs: set[FlavorResource] = set()
    for n in nodes:
        frs.update(n.quotas.keys())
        frs.update(n.usage.keys())
    for infos in pending.values():
        for info in infos:
            cq = store.cluster_queues[info.cluster_queue]
            for rg in cq.resource_groups:
                for fq in rg.flavors:
                    for r in rg.covered_resources:
                        frs.add((fq.name, r))
    fr_list = sorted(frs)
    fr_index = {fr: i for i, fr in enumerate(fr_list)}
    F = max(1, len(fr_list))

    # ---- node arrays -----------------------------------------------------
    parent = np.full(n_nodes + 1, null, dtype=np.int32)
    depth = np.zeros(n_nodes + 1, dtype=np.int32)
    has_parent = np.zeros(n_nodes + 1, dtype=bool)
    nominal = np.zeros((n_nodes + 1, F), dtype=np.int64)
    subtree = np.zeros((n_nodes + 1, F), dtype=np.int64)
    local_quota = np.zeros((n_nodes + 1, F), dtype=np.int64)
    has_borrow = np.zeros((n_nodes + 1, F), dtype=bool)
    borrow_limit = np.zeros((n_nodes + 1, F), dtype=np.int64)
    usage0 = np.zeros((n_nodes + 1, F), dtype=np.int64)
    for i, n in enumerate(nodes):
        if n.parent is not None:
            parent[i] = index[id(n.parent)]
            has_parent[i] = True
            depth[i] = depth[parent[i]] + 1
        for fr, q in n.quotas.items():
            j = fr_index[fr]
            nominal[i, j] = q.nominal
            if q.borrowing_limit is not None:
                has_borrow[i, j] = True
                borrow_limit[i, j] = q.borrowing_limit
        for fr, v in n.subtree_quota.items():
            subtree[i, fr_index[fr]] = v
        for fr, v in n.usage.items():
            usage0[i, fr_index[fr]] = v
        for j, fr in enumerate(fr_list):
            local_quota[i, j] = n.local_quota(fr)

    D = int(depth.max()) + 1 if n_nodes else 1
    path = np.full((n_nodes + 1, D), null, dtype=np.int32)
    for i in range(n_nodes):
        cur, d = i, 0
        while cur != null and d < D:
            path[i, d] = cur
            cur = parent[cur]
            d += 1

    # height: distance to the furthest leaf over cohort edges only
    # (classical/hierarchical_preemption.go getNodeHeight)
    height = np.zeros(n_nodes + 1, dtype=np.int32)
    for i in range(n_nodes - 1, -1, -1):
        n = nodes[i]
        h = min(len(n.children), 1)
        for c in n.children.values():
            if not c.is_cq:
                h = max(h, height[index[id(c)]] + 1)
        height[i] = h

    # ---- CQ arrays -------------------------------------------------------
    cq_names = sorted(forest.cqs.keys())
    C = len(cq_names)
    cq_node = np.zeros(C, dtype=np.int32)
    cq_strict = np.zeros(C, dtype=bool)
    cq_try_next = np.zeros(C, dtype=bool)
    cq_nflavors = np.zeros(C, dtype=np.int32)
    cq_option_flavors: dict[str, list[str]] = {}
    K = 1
    for cid, name in enumerate(cq_names):
        spec = store.cluster_queues[name]
        cq_node[cid] = index[id(forest.cqs[name])]
        cq_strict[cid] = (spec.queueing_strategy
                          == QueueingStrategy.STRICT_FIFO)
        cq_try_next[cid] = (spec.flavor_fungibility.when_can_borrow
                            == FlavorFungibilityPolicy.TRY_NEXT_FLAVOR)
        options = [fq.name for rg in spec.resource_groups
                   for fq in rg.flavors]
        cq_option_flavors[name] = options
        cq_nflavors[cid] = len(options)
        K = max(K, len(options))
    cq_id = {name: i for i, name in enumerate(cq_names)}

    # ---- workload arrays -------------------------------------------------
    all_infos: list[WorkloadInfo] = []
    wl_cqid_l, wl_rank_l = [], []
    for infos in pending.values():
        for rank, info in enumerate(infos):
            all_infos.append(info)
            wl_cqid_l.append(cq_id[info.cluster_queue])
            wl_rank_l.append(rank)
    W = len(all_infos)
    wl_cqid = np.asarray(wl_cqid_l + [C], dtype=np.int32)
    wl_rank = np.asarray(wl_rank_l + [int(BIG)], dtype=np.int32)
    wl_prio = np.zeros(W + 1, dtype=np.int32)
    wl_ts = np.zeros(W + 1, dtype=np.int32)
    wl_uid = np.zeros(W + 1, dtype=np.int32)
    wl_req = np.zeros((W + 1, K, F), dtype=np.int64)
    wl_valid = np.zeros((W + 1, K), dtype=bool)
    raw_ts = np.zeros(W, dtype=np.float64)
    for w, info in enumerate(all_infos):
        spec = store.cluster_queues[info.cluster_queue]
        for ps in info.obj.podsets:
            if (ps.topology_request is not None
                    and ps.topology_request.podset_group_name):
                raise UnsupportedProblem(
                    f"workload {info.key} uses podset topology groups")
        wl_prio[w] = effective_priority(info.obj)
        wl_uid[w] = info.obj.uid
        raw_ts[w] = queue_order_timestamp(info.obj)
        wl_valid[w], wl_req[w] = _workload_options(
            store, info, spec, fr_index, K, F)
    # timestamps export as dense ranks: only relative order matters, and
    # ties must stay ties for the uid tiebreak
    if W:
        wl_ts[:W] = np.unique(raw_ts, return_inverse=True)[1]

    # ---- unit scaling ----------------------------------------------------
    scale = 0
    for arr in (nominal, borrow_limit[has_borrow], usage0, subtree,
                local_quota, wl_req):
        flat = np.asarray(arr, dtype=np.int64).ravel()
        if flat.size:
            scale = math.gcd(scale, int(np.gcd.reduce(flat)))
    scale = max(scale, 1)

    def scaled(a: np.ndarray) -> np.ndarray:
        out = a // scale
        if out.size and out.max() >= MAX_QUANTITY:
            raise UnsupportedProblem(
                "quantities too large for int32 solver tensors")
        return out.astype(np.int32)

    return SolverProblem(
        parent=parent,
        depth=depth,
        height=height,
        has_parent=has_parent,
        path=path,
        nominal=scaled(nominal),
        subtree=scaled(subtree),
        local_quota=scaled(local_quota),
        has_borrow=has_borrow,
        borrow_limit=np.where(has_borrow, scaled(borrow_limit),
                              BIG).astype(np.int32),
        usage0=scaled(usage0),
        cq_node=cq_node,
        cq_strict=cq_strict,
        cq_try_next=cq_try_next,
        cq_nflavors=cq_nflavors,
        wl_cqid=wl_cqid,
        wl_rank=wl_rank,
        wl_prio=wl_prio,
        wl_ts=wl_ts,
        wl_uid=wl_uid,
        wl_req=scaled(wl_req),
        wl_valid=wl_valid,
        fr_list=fr_list,
        node_names=[n.name for n in nodes],
        cq_names=cq_names,
        wl_keys=[i.key for i in all_infos],
        cq_option_flavors=cq_option_flavors,
        scale=scale,
    )

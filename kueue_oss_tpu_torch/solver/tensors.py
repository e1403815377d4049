"""Snapshot -> dense tensor export for the lean and FULL drains.

Port of ``kueue_oss_tpu/solver/tensors.py``: the cohort forest flattens
into parents-first node arrays over a global (flavor, resource)
vocabulary, and the backlog into per-workload flavor-option request
tensors. Quantities are int32 after gcd-based unit scaling.

The workload axis holds the pending heap, then (``parked``) the parked
workloads and (``include_admitted``) the workloads holding quota, which
the FULL drain may evict. The flavor-option axis K spans (resource
group, flavor) pairs; a workload picks one option per group. The FULL
fields (preemption policies, admitted rows, equivalence classes,
option groups) are exported on every call, as the JAX package does,
and so are the fair-sharing weights. With an ``AfsManager`` (``afs``)
the admission-fair-sharing fields carry dense LocalQueue ids, entry
penalties and the LocalQueues' decayed usage at ``now``.

``ExportCache`` is the cross-drain memo the engine keeps: per-workload
rows, shapes interned for the request gather, class tokens, and the
columnar view of ``solver/columnar.py``.
"""

from __future__ import annotations

import dataclasses
import math
from collections import deque
from dataclasses import dataclass, field
from typing import Optional

import numpy as np

from kueue_oss_tpu_torch import features
from kueue_oss_tpu_torch.api.types import (
    FlavorFungibilityPolicy,
    FlavorFungibilityPreference,
    FlavorResource,
    PreemptionPolicyValue,
    QueueingStrategy,
    ResourceFlavor,
)
from kueue_oss_tpu_torch.core.snapshot import Snapshot, build_snapshot
from kueue_oss_tpu_torch.core.store import Store
from kueue_oss_tpu_torch.core.workload_info import (
    WorkloadInfo,
    effective_priority,
    queue_order_timestamp,
    quota_reservation_time,
)

#: "infinity" for missing borrowing limits; headroom against overflow
BIG = np.int32(1 << 30)
#: quantities must stay below this after scaling so sums can't overflow
MAX_QUANTITY = 1 << 28


#: same-priority preemption timestamp gap under the
#: SchedulerTimestampPreemptionBuffer gate (preemption_policy.go:30; the
#: JAX package keeps it in scheduler/preemption.py)
TIMESTAMP_PREEMPTION_BUFFER_S = 300.0


class UnsupportedProblem(Exception):
    """Raised when a backlog needs a drain this port does not have."""


def pow2(n: int) -> int:
    """Next power of two >= n (the padding bucket of every axis)."""
    p = 1
    while p < n:
        p *= 2
    return p


def ts_buffer_ranks(distinct_ts: np.ndarray, raw_ts: np.ndarray,
                    inv_ts: np.ndarray) -> np.ndarray:
    """The newer-equal threshold ranks (``wl_ts_buf``): each row's own
    dense timestamp rank, or under the SchedulerTimestampPreemptionBuffer
    gate the rank of the last distinct timestamp within the buffer."""
    if features.enabled("SchedulerTimestampPreemptionBuffer"):
        return np.searchsorted(
            distinct_ts, raw_ts + TIMESTAMP_PREEMPTION_BUFFER_S,
            side="right") - 1
    return inv_ts


#: preemption-policy encoding shared with the FULL drain
POLICY_NEVER = 0
POLICY_LOWER_PRIORITY = 1
POLICY_LOWER_OR_NEWER_EQUAL = 2
POLICY_ANY = 3

_POLICY_CODE = {
    PreemptionPolicyValue.NEVER: POLICY_NEVER,
    PreemptionPolicyValue.LOWER_PRIORITY: POLICY_LOWER_PRIORITY,
    PreemptionPolicyValue.LOWER_OR_NEWER_EQUAL_PRIORITY:
        POLICY_LOWER_OR_NEWER_EQUAL,
    PreemptionPolicyValue.ANY: POLICY_ANY,
}

#: sentinel for "no borrowWithinCohort maxPriorityThreshold"
NO_THRESHOLD = np.int32(-(1 << 31) + 1)


@dataclass
class SolverProblem:
    """Dense drain instance. Node axis is [N+1] (last row = null node);
    workload axis is [W+1] (last row = null workload). The fields are
    declared in the JAX ``SolverProblem``'s order, which
    ``delta.state_checksum`` hashes them in."""

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
    cq_root_height: np.ndarray  # [C] int32 height of the CQ's root cohort
    cq_nflavors: np.ndarray   # [C] int32 number of flavor options

    # --- workload arrays --------------------------------------------------
    wl_cqid: np.ndarray       # [W+1] int32 CQ id (C for null)
    wl_rank: np.ndarray       # [W+1] int32 FIFO rank within its CQ
    wl_prio: np.ndarray       # [W+1] int32
    wl_ts: np.ndarray         # [W+1] int32 (dense timestamp rank)
    wl_uid: np.ndarray        # [W+1] int32
    wl_req: np.ndarray        # [W+1, K, F] int32 request under option k
    wl_valid: np.ndarray      # [W+1, K] bool option exists & selectable

    # --- FULL drain fields ------------------------------------------------
    wl_parked0: Optional[np.ndarray] = None    # [W+1] bool initially parked
    wl_admitted0: Optional[np.ndarray] = None  # [W+1] bool initially admitted
    wl_evicted0: Optional[np.ndarray] = None   # [W+1] bool Evicted condition
    wl_admit_rank: Optional[np.ndarray] = None  # [W+1] int32 reservation rank
    ad_usage: Optional[np.ndarray] = None      # [W+1, F] int32 admission usage
    cq_within_policy: Optional[np.ndarray] = None   # [C] int32 POLICY_*
    cq_reclaim_policy: Optional[np.ndarray] = None  # [C] int32 POLICY_*
    cq_bwc_forbidden: Optional[np.ndarray] = None   # [C] bool
    cq_bwc_threshold: Optional[np.ndarray] = None   # [C] int32
    cq_preempt_try_next: Optional[np.ndarray] = None  # [C] bool
    cq_pref_pob: Optional[np.ndarray] = None    # [C] bool PreemptionOverBorrowing
    cq_fair_weight: Optional[np.ndarray] = None  # [C] float32
    cq_root: Optional[np.ndarray] = None        # [C] int32 root node
    cq_opt_group: Optional[np.ndarray] = None   # [C, K] int32 (-1 none)
    cq_ngroups: Optional[np.ndarray] = None     # [C] int32
    fr_resource: Optional[np.ndarray] = None    # [F] int32 resource id
    node_fair_weight: Optional[np.ndarray] = None  # [N+1] float32
    #: scheduling-equivalence class per workload (BestEffortFIFO NoFit
    #: dedup); n_classes is the sentinel class of StrictFIFO workloads
    wl_class: Optional[np.ndarray] = None       # [W+1] int32
    class_root: Optional[np.ndarray] = None     # [n_classes+1] int32
    n_classes: int = 0
    #: admission fair sharing: dense LocalQueue id (0 = none) and the
    #: admission penalty of each workload of a UsageBasedAdmission-
    #: FairSharing ClusterQueue
    wl_lq: Optional[np.ndarray] = None          # [W+1] int32
    wl_afs_penalty: Optional[np.ndarray] = None  # [W+1] float32
    #: newer-equal preemption threshold rank (own timestamp rank)
    wl_ts_buf: Optional[np.ndarray] = None      # [W+1] int32
    #: decayed LocalQueue usage at export time; entry 0 is unused
    lq_penalty0: Optional[np.ndarray] = None    # [L+1] float32
    cq_afs: Optional[np.ndarray] = None         # [C] bool
    #: raw inputs behind the dense encodings
    wl_raw_ts: Optional[np.ndarray] = None      # [W+1] float64
    wl_raw_admit_ts: Optional[np.ndarray] = None  # [W+1] float64
    wl_class_tok: Optional[np.ndarray] = None   # [W+1] int64 (-1 none)
    class_tok_root: Optional[np.ndarray] = None  # [n_toks] int32
    n_resources: int = 1
    #: timestamp rank assigned to round-r evictions: ts_evict_base + r
    ts_evict_base: int = 0
    #: reservation rank of round-r re-admissions: admit_rank_base + r
    admit_rank_base: int = 0

    # --- host-side decode tables -----------------------------------------
    fr_list: list[FlavorResource] = field(default_factory=list)
    node_names: list[str] = field(default_factory=list)
    cq_names: list[str] = field(default_factory=list)
    wl_keys: list[str] = field(default_factory=list)
    #: per CQ: ordered flavor names (option k -> flavor, spanning groups)
    cq_option_flavors: dict[str, list[str]] = field(default_factory=dict)
    #: per CQ: resource name -> resource group index (admission decode)
    cq_resource_group: dict[str, dict[str, int]] = field(
        default_factory=dict)
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
#: the FULL drain's extra array fields, in declaration order
FULL_ARRAY_FIELDS = tuple(
    f.name for f in dataclasses.fields(SolverProblem)
    if f.type == "Optional[np.ndarray]")


def pad_workloads(problem: SolverProblem, target_w: int) -> SolverProblem:
    """Pad the workload axis to ``target_w`` rows (plus the null row).

    Padding rows carry the null CQ id (C), no valid options, rank BIG,
    the sentinel class and no initial state, so they are inert;
    ``wl_uid`` pads with BIG so padding never aliases a real uid. Inert
    rows go BEFORE the null row, which stays the last row.
    """
    W = problem.n_workloads
    if target_w <= W:
        return problem
    pad = target_w - W

    def pad1(arr, fill):
        if arr is None:
            return None
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
        wl_parked0=pad1(problem.wl_parked0, False),
        wl_admitted0=pad1(problem.wl_admitted0, False),
        wl_evicted0=pad1(problem.wl_evicted0, False),
        wl_admit_rank=pad1(problem.wl_admit_rank, 0),
        ad_usage=pad1(problem.ad_usage, 0),
        wl_class=pad1(problem.wl_class, problem.n_classes),
        wl_lq=pad1(problem.wl_lq, 0),
        wl_afs_penalty=pad1(problem.wl_afs_penalty, 0.0),
        wl_ts_buf=pad1(problem.wl_ts_buf, 0),
        wl_raw_ts=pad1(problem.wl_raw_ts, 0.0),
        wl_raw_admit_ts=pad1(problem.wl_raw_admit_ts, 0.0),
        wl_class_tok=pad1(problem.wl_class_tok, -1),
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


class _WlRow:
    """Per-workload cached export quantities (drain-invariant)."""

    __slots__ = ("stamp", "cid", "prio", "uid", "raw_ts", "evicted",
                 "shape_id", "class_tok", "lq_key", "totals",
                 "usage_fs", "usage_qs", "admit_ts")

    def __init__(self, stamp, cid, prio, uid, raw_ts, evicted, shape_id,
                 class_tok, lq_key, totals, usage_fs, usage_qs, admit_ts):
        self.stamp = stamp
        self.cid = cid
        self.prio = prio
        self.uid = uid
        self.raw_ts = raw_ts
        self.evicted = evicted
        self.shape_id = shape_id
        self.class_tok = class_tok
        self.lq_key = lq_key
        self.totals = totals
        self.usage_fs = usage_fs
        self.usage_qs = usage_qs
        self.admit_ts = admit_ts


class ExportCache:
    """Cross-drain memo for :func:`export_problem`.

    Keeps per-workload rows and interns request tensors by scheduling
    shape (CQ, pinned flavor, resource totals, per-podset selector /
    tolerations: the inputs of the option-validity walk), so repeated
    drains assemble ``wl_req`` / ``wl_valid`` with one gather. The
    interning is cross-drain state: the shape stack feeds the unit
    scale's gcd and the class tokens are session-stable, so a drain's
    problem equals the JAX engine's only when both keep one cache.

    Invalidation is event-driven: a Workload event drops that key's row;
    any other kind bumps ``spec_gen``, which retires every derived table
    through the stamp check on the next export. The stamp also holds
    the FR vocabulary, the CQ name order and K; the JAX stamp's gate
    values and requests-config generation are constants in the port
    (``features``), so they are left out.
    """

    def __init__(self, store: Store, subscribe: bool = True) -> None:
        self.store = store
        self.spec_gen = 0
        self.rows: dict[str, _WlRow] = {}
        #: interned scheduling shapes; shape 0 is the all-invalid row
        self._shape_ids: dict[tuple, int] = {}
        self._shape_valid: list[np.ndarray] = []
        self._shape_req: list[np.ndarray] = []
        self._stack_valid: Optional[np.ndarray] = None
        self._stack_req: Optional[np.ndarray] = None
        #: interned (cid, scheduling_hash) -> class token; token -> root
        self._class_toks: dict[tuple, int] = {}
        self._tok_root: list[int] = []
        self._stamp: Optional[tuple] = None
        self._fr_index: dict[FlavorResource, int] = {}
        #: per-spec-gen CQ tables: covered resources + selector key sets
        self._cq_gen = -1
        self._cq_covered: list[set] = []
        self._cq_allowed_keys: list[list[frozenset]] = []
        #: workload keys and CQ names touched since the last
        #: consume_dirty(): delta-session frame statistics (the delta
        #: itself compares content)
        self.dirty_keys: set[str] = set()
        self.dirty_cqs: set[str] = set()
        self.events_seen = 0
        #: incremental columnar assembly view (solver/columnar.py); only
        #: subscribed caches get one, since an unsubscribed cache never
        #: sees the events that invalidate its columns
        self.columnar = None
        if subscribe:
            store.watch(self._on_event)
            from kueue_oss_tpu_torch.solver.columnar import ColumnarStore

            self.columnar = ColumnarStore(self)

    def _on_event(self, event) -> None:
        verb, kind, obj = event
        self.events_seen += 1
        if kind == "Workload":
            self.rows.pop(obj.key, None)
            self.dirty_keys.add(obj.key)
            if self.columnar is not None:
                self.columnar.note_dirty(obj.key)
            lq = self.store.local_queues.get(
                f"{obj.namespace}/{obj.queue_name}")
            if lq is not None:
                self.dirty_cqs.add(lq.cluster_queue)
        else:
            self.spec_gen += 1
            name = getattr(obj, "name", None)
            if kind == "ClusterQueue" and name:
                self.dirty_cqs.add(name)

    def consume_dirty(self) -> tuple[set[str], set[str]]:
        """Return-and-clear the dirty sets (one delta emission's worth)."""
        keys, cqs = self.dirty_keys, self.dirty_cqs
        self.dirty_keys, self.dirty_cqs = set(), set()
        return keys, cqs

    def dirty_snapshot(self) -> tuple[int, frozenset, frozenset]:
        """Non-consuming view (spec_gen, dirty keys, dirty CQs)."""
        return (self.spec_gen, frozenset(self.dirty_keys),
                frozenset(self.dirty_cqs))

    # -- derived-table lifecycle ------------------------------------------

    def refresh(self, fr_list: list, cq_names: list[str], K: int,
                F: int) -> tuple:
        """Return the stamp rows must carry, clearing derived state when
        anything it covers changed since the previous export."""
        stamp = (self.spec_gen, tuple(fr_list), tuple(cq_names), K)
        if stamp != self._stamp:
            self._stamp = stamp
            self.rows.clear()
            self._shape_ids.clear()
            self._shape_valid = [np.zeros(K, dtype=bool)]
            self._shape_req = [np.zeros((K, max(1, F)), dtype=np.int64)]
            self._stack_valid = None
            self._stack_req = None
            self._class_toks.clear()
            self._tok_root = []
            self._fr_index = {fr: i for i, fr in enumerate(fr_list)}
        return self._stamp

    def cq_tables(self, cq_names: list[str]) -> None:
        """Per-CQ covered-resource sets and selector key universes,
        cached per spec generation."""
        if self._cq_gen == self.spec_gen and len(self._cq_covered) == len(
                cq_names):
            return
        self._cq_gen = self.spec_gen
        self._cq_covered = []
        self._cq_allowed_keys = []
        for name in cq_names:
            spec = self.store.cluster_queues[name]
            self._cq_covered.append({r for rg in spec.resource_groups
                                     for r in rg.covered_resources})
            self._cq_allowed_keys.append([frozenset(
                key for fq in rg.flavors
                for key in self.store.resource_flavors.get(
                    fq.name, ResourceFlavor(name=fq.name)).node_labels)
                for rg in spec.resource_groups])

    def shape_matrices(self) -> tuple[np.ndarray, np.ndarray]:
        if (self._stack_valid is None
                or self._stack_valid.shape[0] != len(self._shape_valid)):
            self._stack_valid = np.stack(self._shape_valid)
            self._stack_req = np.stack(self._shape_req)
        return self._stack_valid, self._stack_req

    # -- row building ------------------------------------------------------

    def row(self, info: WorkloadInfo, cid: int, stamp: tuple,
            strict: bool, root: int, K: int, F: int) -> _WlRow:
        r = self.rows.get(info.key)
        if r is not None and r.stamp is stamp:
            return r
        r = self._build_row(info, cid, stamp, strict, root, K, F)
        self.rows[info.key] = r
        return r

    def _build_row(self, info: WorkloadInfo, cid: int, stamp: tuple,
                   strict: bool, root: int, K: int, F: int) -> _WlRow:
        wl = info.obj
        for ps in wl.podsets:
            if (ps.topology_request is not None
                    and ps.topology_request.podset_group_name):
                raise UnsupportedProblem(
                    f"workload {info.key} uses podset topology groups")
        totals: dict[str, int] = {}
        for psr in info.total_requests:
            for rname, q in psr.requests.items():
                totals[rname] = totals.get(rname, 0) + q
        shape_id = self._shape_id(info, cid, totals, K, F)
        if not features.enabled("SchedulingEquivalenceHashing") or strict:
            tok = -1
        else:
            ckey = (cid, info.scheduling_hash())
            tok = self._class_toks.get(ckey)
            if tok is None:
                tok = len(self._tok_root)
                self._class_toks[ckey] = tok
                self._tok_root.append(int(root))
        usage_fs = usage_qs = None
        admit_ts = 0.0
        if wl.status.admission is not None:
            fs, qs = [], []
            for fr, q in info.usage().items():
                j = self._fr_index.get(fr)
                if j is not None:
                    fs.append(j)
                    qs.append(q)
            usage_fs = np.asarray(fs, dtype=np.int64)
            usage_qs = np.asarray(qs, dtype=np.int64)
            admit_ts = quota_reservation_time(wl, 0.0)
        return _WlRow(
            stamp, cid, effective_priority(wl), wl.uid,
            queue_order_timestamp(wl), wl.is_evicted, shape_id, tok,
            f"{wl.namespace}/{wl.queue_name}", totals, usage_fs, usage_qs,
            admit_ts)

    def _shape_id(self, info: WorkloadInfo, cid: int,
                  totals: dict[str, int], K: int, F: int) -> int:
        wl = info.obj
        spec = self.store.cluster_queues[info.cluster_queue]
        if not spec.resource_groups:
            return 0
        shape_key = (
            cid, wl.allowed_flavor, tuple(sorted(totals.items())),
            tuple((tuple(sorted(ps.node_selector.items())),
                   tuple(ps.tolerations)) for ps in wl.podsets),
        )
        sid = self._shape_ids.get(shape_key)
        if sid is not None:
            return sid
        covered = self._cq_covered[cid]
        if any(q > 0 and r not in covered for r, q in totals.items()):
            # undeclared resource: no option can ever fit (oracle
            # parity); intern to the all-invalid row
            self._shape_ids[shape_key] = 0
            return 0
        valid = np.zeros(K, dtype=bool)
        req = np.zeros((K, max(1, F)), dtype=np.int64)
        k = -1
        for g, rg in enumerate(spec.resource_groups):
            allowed_keys = self._cq_allowed_keys[cid][g]
            for fq in rg.flavors:
                k += 1
                flavor = self.store.resource_flavors.get(fq.name)
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
                        req[k, self._fr_index[(fq.name, rname)]] = q
        sid = len(self._shape_valid)
        self._shape_ids[shape_key] = sid
        self._shape_valid.append(valid)
        self._shape_req.append(req)
        return sid


def export_problem(
    store: Store,
    pending: dict[str, list[WorkloadInfo]],
    snapshot: Optional[Snapshot] = None,
    include_admitted: bool = False,
    parked: Optional[dict[str, list[WorkloadInfo]]] = None,
    afs=None,
    now: float = 0.0,
    cache: Optional[ExportCache] = None,
    columnar: bool = True,
) -> SolverProblem:
    """Build the SolverProblem from the store and the backlog.

    ``pending`` maps CQ name -> workloads in FIFO-heap (rank) order.
    ``parked`` maps CQ name -> inadmissible workloads; they export with
    ``wl_parked0`` set, so the FULL drain retries them when an in-drain
    eviction frees capacity in their cohort. With ``include_admitted``
    the workloads holding quota follow on the same axis as eviction
    candidates (their usage rides ``ad_usage``; the node ``usage0``
    still includes it). ``afs`` (an ``AfsManager``) exports the
    admission-fair-sharing inputs with usage decayed to ``now``. Podset
    topology groups raise UnsupportedProblem.

    ``cache`` is the cross-drain ``ExportCache``; without one a
    throwaway unsubscribed cache serves this export alone. A cache with
    a columnar view answers from it (``solver/columnar.py``) unless the
    caller pins a ``snapshot`` or passes ``columnar=False``; the view
    hands back to the per-row walk below whenever it cannot prove its
    answer identical (AFS-active exports).
    """
    col = getattr(cache, "columnar", None) if cache is not None else None
    if col is not None and snapshot is None and columnar:
        out = col.export(pending, include_admitted=include_admitted,
                         parked=parked, afs=afs, now=now)
        if out is not None:
            return out

    forest = (snapshot or build_snapshot(store)).forest

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
    node_fair_weight = np.ones(n_nodes + 1, dtype=np.float32)
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
        node_fair_weight[i] = n.fair_weight

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
    cq_root_height = np.zeros(C, dtype=np.int32)
    cq_nflavors = np.zeros(C, dtype=np.int32)
    cq_within_policy = np.zeros(C, dtype=np.int32)
    cq_reclaim_policy = np.zeros(C, dtype=np.int32)
    cq_bwc_forbidden = np.zeros(C, dtype=bool)
    cq_bwc_threshold = np.full(C, NO_THRESHOLD, dtype=np.int32)
    cq_preempt_try_next = np.zeros(C, dtype=bool)
    cq_pref_pob = np.zeros(C, dtype=bool)
    cq_fair_weight = np.ones(C, dtype=np.float32)
    cq_root = np.zeros(C, dtype=np.int32)
    cq_ngroups = np.ones(C, dtype=np.int32)
    cq_option_flavors: dict[str, list[str]] = {}
    cq_resource_group: dict[str, dict[str, int]] = {}
    cq_groups: dict[str, list[int]] = {}
    K = 1
    for cid, name in enumerate(cq_names):
        spec = store.cluster_queues[name]
        node = forest.cqs[name]
        root = node.root()
        cq_node[cid] = index[id(node)]
        cq_strict[cid] = (spec.queueing_strategy
                          == QueueingStrategy.STRICT_FIFO)
        fung = spec.flavor_fungibility
        cq_try_next[cid] = (fung.when_can_borrow
                            == FlavorFungibilityPolicy.TRY_NEXT_FLAVOR)
        cq_preempt_try_next[cid] = (
            fung.when_can_preempt == FlavorFungibilityPolicy.TRY_NEXT_FLAVOR)
        cq_pref_pob[cid] = (
            fung.preference
            == FlavorFungibilityPreference.PREEMPTION_OVER_BORROWING)
        cq_root_height[cid] = height[index[id(root)]]
        cq_root[cid] = index[id(root)]
        pre = spec.preemption
        cq_within_policy[cid] = _POLICY_CODE[pre.within_cluster_queue]
        cq_reclaim_policy[cid] = _POLICY_CODE[pre.reclaim_within_cohort]
        bwc = pre.borrow_within_cohort
        cq_bwc_forbidden[cid] = bwc.policy == PreemptionPolicyValue.NEVER
        if bwc.max_priority_threshold is not None:
            cq_bwc_threshold[cid] = bwc.max_priority_threshold
        cq_fair_weight[cid] = spec.fair_sharing.weight
        groups: list[int] = []
        options: list[str] = []
        rg_of_resource: dict[str, int] = {}
        for g, rg in enumerate(spec.resource_groups):
            for r in rg.covered_resources:
                rg_of_resource[r] = g
            for fq in rg.flavors:
                groups.append(g)
                options.append(fq.name)
        cq_groups[name] = groups
        cq_option_flavors[name] = options
        cq_resource_group[name] = rg_of_resource
        cq_ngroups[cid] = max(1, len(spec.resource_groups))
        cq_nflavors[cid] = len(options)
        K = max(K, len(options))
    cq_opt_group = np.full((C, K), -1, dtype=np.int32)
    for cid, name in enumerate(cq_names):
        for k, g in enumerate(cq_groups[name]):
            cq_opt_group[cid, k] = g
    cq_id = {name: i for i, name in enumerate(cq_names)}

    # ---- workload rows: heap, then parked, then admitted -----------------
    # Per-workload quantities come from ExportCache rows (built once per
    # workload state, dropped by store events); request tensors are
    # interned by scheduling shape and assembled with one gather.
    if cache is None:
        cache = ExportCache(store, subscribe=False)
    stamp = cache.refresh(fr_list, cq_names, K, F)
    cache.cq_tables(cq_names)

    all_infos: list[WorkloadInfo] = []
    wl_cqid_l, wl_rank_l = [], []
    for infos in pending.values():
        for rank, info in enumerate(infos):
            all_infos.append(info)
            wl_cqid_l.append(cq_id[info.cluster_queue])
            wl_rank_l.append(rank)
    n_heap = len(all_infos)
    for infos in (parked or {}).values():
        for info in infos:
            all_infos.append(info)
            wl_cqid_l.append(cq_id[info.cluster_queue])
            wl_rank_l.append(int(BIG))
    n_pending = len(all_infos)
    if include_admitted:
        for info in store.admitted_infos():
            if info.cluster_queue in cq_id:
                all_infos.append(info)
                wl_cqid_l.append(cq_id[info.cluster_queue])
                wl_rank_l.append(int(BIG))
    W = len(all_infos)
    rows = [cache.row(info, cid, stamp, bool(cq_strict[cid]),
                      int(cq_root[cid]), K, F)
            for info, cid in zip(all_infos, wl_cqid_l)]

    wl_cqid = np.asarray(wl_cqid_l + [C], dtype=np.int32)
    wl_rank = np.asarray(wl_rank_l + [int(BIG)], dtype=np.int32)
    wl_prio = np.zeros(W + 1, dtype=np.int32)
    wl_ts = np.zeros(W + 1, dtype=np.int32)
    wl_uid = np.zeros(W + 1, dtype=np.int32)
    wl_req = np.zeros((W + 1, K, F), dtype=np.int64)
    wl_valid = np.zeros((W + 1, K), dtype=bool)
    wl_admitted0 = np.zeros(W + 1, dtype=bool)
    wl_admitted0[n_pending:W] = True
    wl_parked0 = np.zeros(W + 1, dtype=bool)
    wl_parked0[n_heap:n_pending] = True
    wl_evicted0 = np.zeros(W + 1, dtype=bool)
    wl_admit_rank = np.zeros(W + 1, dtype=np.int32)
    ad_usage = np.zeros((W + 1, F), dtype=np.int64)
    if W:
        wl_prio[:W] = np.fromiter((r.prio for r in rows), np.int64, W)
        wl_uid[:W] = np.fromiter((r.uid for r in rows), np.int64, W)
        wl_evicted0[:W] = np.fromiter((r.evicted for r in rows), bool, W)
        shape_ids = np.fromiter((r.shape_id for r in rows), np.int64, W)
        stack_valid, stack_req = cache.shape_matrices()
        wl_valid[:W] = stack_valid[shape_ids]
        wl_req[:W] = stack_req[shape_ids]

    # scheduling-equivalence classes (per CQ; StrictFIFO workloads get
    # the sentinel class and never dedup-park): interned tokens densified
    # per export
    toks = (np.fromiter((r.class_tok for r in rows), np.int64, W)
            if W else np.zeros(0, dtype=np.int64))
    pos = toks >= 0
    if pos.any():
        uniq, inv_c = np.unique(toks[pos], return_inverse=True)
        n_classes = len(uniq)
        wl_class = np.full(W + 1, n_classes, dtype=np.int32)
        wl_class[np.nonzero(pos)[0]] = inv_c
        class_root = np.concatenate(
            [np.asarray(cache._tok_root, dtype=np.int32)[uniq],
             [n_nodes]]).astype(np.int32)
    else:
        n_classes = 0
        wl_class = np.zeros(W + 1, dtype=np.int32)
        class_root = np.asarray([n_nodes], dtype=np.int32)

    # timestamps export as dense ranks: only relative order matters, and
    # ties must stay ties for the uid tiebreak
    wl_ts_buf = np.zeros(W + 1, dtype=np.int32)
    wl_raw_ts = np.zeros(W + 1, dtype=np.float64)
    wl_raw_admit_ts = np.zeros(W + 1, dtype=np.float64)
    n_ts = n_admit_rank = 0
    if W:
        raw_ts = np.fromiter((r.raw_ts for r in rows), np.float64, W)
        wl_raw_ts[:W] = raw_ts
        distinct_ts, inv_ts = np.unique(raw_ts, return_inverse=True)
        n_ts = len(distinct_ts)
        wl_ts[:W] = inv_ts
        wl_ts_buf[:W] = ts_buffer_ranks(distinct_ts, raw_ts, inv_ts)
    if W > n_pending:
        raw_admit = np.fromiter((r.admit_ts for r in rows[n_pending:]),
                                np.float64, W - n_pending)
        wl_raw_admit_ts[n_pending:W] = raw_admit
        distinct_admit, inv_a = np.unique(raw_admit, return_inverse=True)
        n_admit_rank = len(distinct_admit)
        wl_admit_rank[n_pending:W] = inv_a + 1
        for w in range(n_pending, W):
            r = rows[w]
            if r.usage_fs is not None and r.usage_fs.size:
                ad_usage[w, r.usage_fs] = r.usage_qs

    # ---- unit scaling ----------------------------------------------------
    # the gcd covers every divided quantity; the interned shape matrix
    # stands in for wl_req (a superset of this export's shapes, so any
    # common divisor still divides every present quantity)
    scale = 0
    for arr in (nominal, borrow_limit[has_borrow], usage0, subtree,
                local_quota, cache.shape_matrices()[1], ad_usage):
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

    resources = sorted({fr[1] for fr in fr_list}) or ["_"]
    res_index = {r: i for i, r in enumerate(resources)}
    fr_resource = np.asarray([res_index[fr[1]] for fr in fr_list] or [0],
                             dtype=np.int32)

    # ---- admission fair sharing (KEP-4136): dense LQ ids + penalties ----
    # Only UsageBasedAdmissionFairSharing CQs participate; the penalty
    # increment is flavor-independent (requests are per resource), so it
    # exports as one scalar per workload (afs/entry_penalties.go).
    wl_lq = np.zeros(W + 1, dtype=np.int32)
    wl_afs_penalty = np.zeros(W + 1, dtype=np.float32)
    cq_afs = np.zeros(C, dtype=bool)
    lq_pen_list: list[float] = [0.0]
    if afs is not None:
        for cid, name in enumerate(cq_names):
            scope = store.cluster_queues[name].admission_scope
            cq_afs[cid] = (
                scope is not None
                and scope.admission_mode == "UsageBasedAdmissionFairSharing")
        if cq_afs.any():
            lq_index: dict[str, int] = {}
            for w, r in enumerate(rows):
                if not cq_afs[r.cid]:
                    continue
                li = lq_index.get(r.lq_key)
                if li is None:
                    li = len(lq_pen_list)
                    lq_index[r.lq_key] = li
                    lq_pen_list.append(
                        float(afs.weighted_usage(r.lq_key, now)))
                wl_lq[w] = li
                wl_afs_penalty[w] = afs.entry_penalty(r.lq_key, r.totals)
    lq_penalty0 = np.asarray(lq_pen_list, dtype=np.float32)

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
        cq_root_height=cq_root_height,
        wl_parked0=wl_parked0,
        wl_admitted0=wl_admitted0,
        wl_evicted0=wl_evicted0,
        wl_admit_rank=wl_admit_rank,
        ad_usage=scaled(ad_usage),
        cq_within_policy=cq_within_policy,
        cq_reclaim_policy=cq_reclaim_policy,
        cq_bwc_forbidden=cq_bwc_forbidden,
        cq_bwc_threshold=cq_bwc_threshold,
        cq_preempt_try_next=cq_preempt_try_next,
        cq_pref_pob=cq_pref_pob,
        cq_fair_weight=cq_fair_weight,
        cq_root=cq_root,
        cq_opt_group=cq_opt_group,
        cq_ngroups=cq_ngroups,
        fr_resource=fr_resource,
        node_fair_weight=node_fair_weight,
        wl_class=wl_class,
        class_root=class_root,
        n_classes=n_classes,
        wl_lq=wl_lq,
        wl_afs_penalty=wl_afs_penalty,
        wl_ts_buf=wl_ts_buf,
        lq_penalty0=lq_penalty0,
        cq_afs=cq_afs,
        wl_raw_ts=wl_raw_ts,
        wl_raw_admit_ts=wl_raw_admit_ts,
        wl_class_tok=np.concatenate([toks, [-1]]).astype(np.int64),
        class_tok_root=np.asarray(cache._tok_root, dtype=np.int32),
        n_resources=len(resources),
        ts_evict_base=n_ts + 1,
        admit_rank_base=n_admit_rank + 2,
        fr_list=fr_list,
        node_names=[n.name for n in nodes],
        cq_names=cq_names,
        wl_keys=[i.key for i in all_infos],
        cq_option_flavors=cq_option_flavors,
        cq_resource_group=cq_resource_group,
        scale=scale,
    )

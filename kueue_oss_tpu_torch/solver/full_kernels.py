"""The preemption-capable (FULL) admission drain over dense tensors.

Port of ``kueue_oss_tpu/solver/full_kernels.py`` (its single-device
path). The drain extends the lean one (``kernels.py``) with the
reference's preemption, on a workload axis that holds pending, parked
and admitted workloads alike:

- head selection by (-priority, timestamp, uid) over the pending set;
  within an admission-fair-sharing (AFS) ClusterQueue the LocalQueue
  with the lowest decayed usage goes first (KEP-4136), and each
  admission charges its entry penalty to its LocalQueue;
- per resource group nomination and the assigner's flavor walk over
  granular preemption modes (flavorassigner.go:812-951);
- a per-round candidate table per cohort root, and the classical victim
  search (preemption.go:271-341) for every (head, option) lane: the
  legality masks, the hierarchical advantage rings, the 7-bucket order,
  two allow-borrowing attempts with the infeasibility precheck, the
  bulk-skip removal walk, the fill-back and the borrow-after level;
  under fair sharing the fair search (``fair_kernels.fair_search``)
  takes its place;
- the entry scan (scheduler.go:337-467), in the classical entry order
  or, under fair sharing, one ``fair_kernels.fair_entry_pick`` per pop
  on the mutated usage: reserve-and-park, one
  overlapping preemption skip, the fits re-check under the removal of
  the victims, evictions, admissions;
- the round's bookkeeping: evicted workloads re-enter the pending set
  ordered by their eviction round, NoFit equivalence classes park, and
  evictions flush their cohort's parked workloads.

Translation rules, shared with the lean port: int32 everywhere, updates
out of place, a Python round loop with one progress read per round, and
the in-round ``lax.scan`` over C entries as a Python loop that indexes
with [1]-shaped tensors. The JAX program's ``vmap`` over lanes becomes
an explicit leading lane axis [L]; each batched ``while_loop`` becomes a
loop whose iterations update only the lanes whose own condition holds
and which ends when no lane's condition holds (one ``.any()`` read per
iteration). JAX's ``mode="drop"`` scatters write into a sink row that is
sliced away, and boolean / int8 scatter-max/min with repeated indices
go through ``scatter_reduce`` on an integer dtype. Every device-to-host
read is counted in ``FullDrainStats.syncs``.

``solve_backlog_full_batched`` is the JAX package's ``jit(vmap(...))``
of the drain over a scenario axis (the FULL what-if sweep), written with
an explicit leading axis S as ``kernels.solve_backlog_batched`` is:
every scenario keeps its own round count and stamps and freezes once
its own condition fails; the victim searches, the flavor walk and the
entry scan's path walks run the single-problem functions above on
``_lane_view``s, whose reads address each lane's own scenario.

Cut from the copy: the ``shard_map`` lane sharding and ``debug_drain``.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import NamedTuple, Optional

import numpy as np
import torch

from kueue_oss_tpu_torch.solver.kernels import (
    BIG,
    M_FIT,
    M_NOFIT,
    M_PREEMPT,
    _add_usage_along_path_flat,
    _avail_along_path_flat,
    _available_all_b,
    _batched_tensors,
    _borrow_levels_b,
    _potential_available_all_b,
    _refresh_cohort_usage_b,
    _rows,
    available_all,
    borrow_levels,
    potential_available_all,
    refresh_cohort_usage,
)
from kueue_oss_tpu_torch.solver.ops import (
    INT32,
    arange,
    lexsort,
    segment_max,
    segment_max_rows,
    segment_min,
    segment_min_rows,
    segment_sum,
    segment_sum_rows,
)
from kueue_oss_tpu_torch.solver.tensors import (
    NO_THRESHOLD,
    POLICY_ANY,
    POLICY_LOWER_OR_NEWER_EQUAL,
    POLICY_LOWER_PRIORITY,
    POLICY_NEVER,
    SolverProblem,
)

# candidate variants (classical/candidate_generator.go)
V_NEVER = 0
V_WITHIN_CQ = 1
V_HIERARCHICAL_RECLAIM = 2
V_RECLAIM_WITHOUT_BORROWING = 3
V_RECLAIM_WHILE_BORROWING = 4

# preemption-mode lattice (flavorassigner.go:429-437)
P_NOFIT = 0
P_NO_CANDIDATES = 1
P_PREEMPT = 2
P_RECLAIM = 3
P_FIT = 4

#: cap on borrow levels when packing granular modes into one sort key
B_CAP = 64


class FullTensors(NamedTuple):
    """Device-side mirror of the FULL SolverProblem."""

    parent: torch.Tensor
    depth: torch.Tensor
    height: torch.Tensor
    has_parent: torch.Tensor
    is_cq: torch.Tensor
    path: torch.Tensor
    subtree: torch.Tensor
    local_quota: torch.Tensor
    nominal: torch.Tensor
    has_borrow: torch.Tensor
    borrow_limit: torch.Tensor
    usage0: torch.Tensor
    cq_node: torch.Tensor
    cq_strict: torch.Tensor
    cq_try_next: torch.Tensor
    cq_nflavors: torch.Tensor
    cq_within_policy: torch.Tensor
    cq_reclaim_policy: torch.Tensor
    cq_bwc_forbidden: torch.Tensor
    cq_bwc_threshold: torch.Tensor
    cq_preempt_try_next: torch.Tensor
    cq_pref_pob: torch.Tensor
    cq_fair_weight: torch.Tensor
    cq_root: torch.Tensor
    cq_opt_group: torch.Tensor    # [C, K]
    cq_opt_pos: torch.Tensor      # [C, K] position of option in its group
    cq_ngroups: torch.Tensor
    wl_cqid: torch.Tensor
    wl_prio: torch.Tensor
    wl_ts0: torch.Tensor
    wl_uid: torch.Tensor
    wl_req: torch.Tensor
    wl_valid: torch.Tensor
    wl_parked0: torch.Tensor
    wl_admitted0: torch.Tensor
    wl_evicted0: torch.Tensor
    wl_admit_rank0: torch.Tensor
    ad_usage: torch.Tensor
    fr_resource: torch.Tensor     # [F] int32 resource id per FR column
    res_onehot: torch.Tensor      # [F, R] int32
    node_fair_weight: torch.Tensor  # [N+1] float32
    wl_class: torch.Tensor        # [W+1] int32 equivalence class
    class_root: torch.Tensor      # [n_classes+1] int32
    wl_lq: torch.Tensor           # [W+1] int32 dense LocalQueue id (AFS)
    wl_ts_buf: torch.Tensor       # [W+1] int32 newer-eq threshold rank
    wl_afs_penalty: torch.Tensor  # [W+1] float32 admission penalty (AFS)
    lq_penalty0: torch.Tensor     # [L+1] float32 decayed start penalties
    cq_afs: torch.Tensor          # [C] bool UsageBasedAdmissionFairSharing
    ts_evict_base: torch.Tensor   # 0-d int32
    admit_rank_base: torch.Tensor  # 0-d int32


#: FullTensors fields that are float32; the bool ones are listed below;
#: every other field is int32
FLOAT_FIELDS = frozenset({"cq_fair_weight", "node_fair_weight",
                          "wl_afs_penalty", "lq_penalty0"})
BOOL_FIELDS = frozenset({"has_parent", "is_cq", "has_borrow", "cq_strict",
                         "cq_try_next", "cq_bwc_forbidden",
                         "cq_preempt_try_next", "cq_pref_pob", "wl_valid",
                         "wl_parked0", "wl_admitted0", "wl_evicted0",
                         "cq_afs"})


def field_dtype(name: str):
    """The numpy dtype of a FullTensors field."""
    if name in BOOL_FIELDS:
        return np.bool_
    if name in FLOAT_FIELDS:
        return np.float32
    return np.int32


def host_tensors_full(p: SolverProblem) -> FullTensors:
    """The FULL drain's inputs as host (numpy) arrays."""
    is_cq = np.zeros(p.parent.shape[0], dtype=bool)
    is_cq[p.cq_node] = True
    C, K = p.cq_opt_group.shape
    opt_pos = np.zeros((C, K), dtype=np.int32)
    for c in range(C):
        counts: dict[int, int] = {}
        for k in range(K):
            g = int(p.cq_opt_group[c, k])
            if g < 0:
                continue
            opt_pos[c, k] = counts.get(g, 0)
            counts[g] = counts.get(g, 0) + 1
    return FullTensors(
        parent=p.parent, depth=p.depth, height=p.height,
        has_parent=p.has_parent, is_cq=is_cq, path=p.path,
        subtree=p.subtree, local_quota=p.local_quota, nominal=p.nominal,
        has_borrow=p.has_borrow, borrow_limit=p.borrow_limit,
        usage0=p.usage0, cq_node=p.cq_node, cq_strict=p.cq_strict,
        cq_try_next=p.cq_try_next, cq_nflavors=p.cq_nflavors,
        cq_within_policy=p.cq_within_policy,
        cq_reclaim_policy=p.cq_reclaim_policy,
        cq_bwc_forbidden=p.cq_bwc_forbidden,
        cq_bwc_threshold=p.cq_bwc_threshold,
        cq_preempt_try_next=p.cq_preempt_try_next,
        cq_pref_pob=p.cq_pref_pob, cq_fair_weight=p.cq_fair_weight,
        cq_root=p.cq_root, cq_opt_group=p.cq_opt_group, cq_opt_pos=opt_pos,
        cq_ngroups=p.cq_ngroups, wl_cqid=p.wl_cqid, wl_prio=p.wl_prio,
        wl_ts0=p.wl_ts, wl_uid=p.wl_uid, wl_req=p.wl_req,
        wl_valid=p.wl_valid, wl_parked0=p.wl_parked0,
        wl_admitted0=p.wl_admitted0, wl_evicted0=p.wl_evicted0,
        wl_admit_rank0=p.wl_admit_rank, ad_usage=p.ad_usage,
        fr_resource=p.fr_resource,
        res_onehot=np.eye(p.n_resources, dtype=np.int32)[p.fr_resource],
        node_fair_weight=p.node_fair_weight, wl_class=p.wl_class,
        class_root=p.class_root, wl_lq=p.wl_lq, wl_ts_buf=p.wl_ts_buf,
        wl_afs_penalty=p.wl_afs_penalty, lq_penalty0=p.lq_penalty0,
        cq_afs=p.cq_afs,
        ts_evict_base=np.asarray(p.ts_evict_base, dtype=np.int32),
        admit_rank_base=np.asarray(p.admit_rank_base, dtype=np.int32),
    )


def tensors_to_device(host: FullTensors, device) -> FullTensors:
    """Upload host arrays, keeping their dtypes."""
    return FullTensors(*(torch.as_tensor(np.ascontiguousarray(a),
                                         device=device) for a in host))


def to_device_full(p: SolverProblem, device) -> FullTensors:
    return tensors_to_device(host_tensors_full(p), device)


@dataclass
class FullDrainStats:
    """What one FULL drain did on the device, and what it read back."""

    rounds: int = 0
    #: victim searches run: lanes summed over rounds
    lanes: int = 0
    #: victim-walk iterations: the classical bulk-skip removal walk (one
    #: per victim tried) and the fair strategy loop (one candidate
    #: popped per iteration)
    walk_iterations: int = 0
    #: fill-back iterations
    fill_iterations: int = 0
    #: sequential victim removals in the entry scans' fits re-checks
    removal_steps: int = 0
    #: fair entry picks (one host read each)
    entry_picks: int = 0
    #: device-to-host reads (each one synchronises with the device)
    syncs: int = 0

    def read(self, x: torch.Tensor):
        """``x.tolist()``, counted as one synchronisation."""
        self.syncs += 1
        return x.tolist()


# ---------------------------------------------------------------------------
# small helpers
# ---------------------------------------------------------------------------


def _i32(x: torch.Tensor) -> torch.Tensor:
    return x.to(INT32)


def _with_last(x: torch.Tensor, value) -> torch.Tensor:
    """``x.at[-1].set(value)`` out of place. (Item assignment of a
    Python scalar would copy it from the host: one synchronisation.)"""
    return torch.cat([x[:-1], torch.full_like(x[-1:], value)])


def _scatter_sink(x: torch.Tensor, idx: torch.Tensor,
                  vals: torch.Tensor) -> torch.Tensor:
    """``x.at[idx].set(vals, mode="drop")`` where every dropped write
    addresses ``len(x)``: the writes go to a sink row that is sliced
    away. Kept indices must be distinct."""
    return torch.cat([x, x[:1]]).index_put((idx.long(),), vals)[:-1]


def _scatter_bool(x: torch.Tensor, idx: torch.Tensor, vals: torch.Tensor,
                  reduce: str) -> torch.Tensor:
    """``x.at[idx].max(vals)`` (``reduce="amax"``) or ``.min``, exact
    with repeated indices, for bool or int8 ``x``."""
    out = x.to(INT32).scatter_reduce(0, idx.long(), vals.to(INT32),
                                     reduce=reduce, include_self=True)
    return out.to(x.dtype)


class _PerLane:
    """A scenario-batched tensor [S, N, ...] read lane by lane: ``v[idx]``
    with ``idx`` [L, ...] gathers row ``idx`` of each lane's own scenario
    (``ls`` [L]), so the single-problem lane code runs unchanged on the
    batched drain's lanes; ``shape`` is one scenario's."""

    __slots__ = ("x", "ls")

    def __init__(self, x: torch.Tensor, ls: torch.Tensor) -> None:
        self.x = x
        self.ls = ls

    @property
    def shape(self):
        return self.x.shape[1:]

    def __getitem__(self, idx: torch.Tensor) -> torch.Tensor:
        idx = idx.long()
        return self.x[self.ls.reshape((-1,) + (1,) * (idx.dim() - 1)), idx]


#: FullTensors fields that are 0-d in one problem ([S] when batched)
_SCALAR_FIELDS = frozenset({"ts_evict_base", "admit_rank_base"})


def _lane_view(t: FullTensors, ls: torch.Tensor) -> FullTensors:
    """The batched tensors ``t`` as each lane ``ls`` [L] sees them: the
    0-d fields as [L] values, every other field a ``_PerLane``."""
    return FullTensors(*(x[ls] if name in _SCALAR_FIELDS
                         else _PerLane(x, ls)
                         for name, x in zip(FullTensors._fields, t)))


def _per_lane(x, L: int) -> torch.Tensor:
    """Each of L lanes' own copy of a round-state or tree tensor: a
    ``_PerLane``'s scenario rows, or L copies of a shared tensor."""
    if isinstance(x, _PerLane):
        return x.x[x.ls]
    return x.unsqueeze(0).repeat((L,) + (1,) * x.dim())


def _refresh_per_lane(t, rows: torch.Tensor) -> torch.Tensor:
    """``refresh_cohort_usage`` of lane-batched CQ rows [L, N+1, F],
    over each lane's own tree in the batched drain."""
    if not isinstance(t.is_cq, _PerLane):
        return refresh_cohort_usage(t, rows)
    L = rows.shape[0]
    tree = FullTensors(*(
        _per_lane(getattr(t, f), L) if f in ("is_cq", "depth", "parent",
                                              "local_quota")
        else getattr(t, f) for f in FullTensors._fields))
    return _refresh_cohort_usage_b(tree, rows)


# ---------------------------------------------------------------------------
# per-lane path walks (usage [L, N+1, F], one CQ node per lane)
# ---------------------------------------------------------------------------


def _avail_path(t, usage, cq_node):
    """available() of each lane's CQ under that lane's usage; [L, F]."""
    L = cq_node.shape[0]
    lanes = torch.arange(L, device=usage.device)
    path = t.path[cq_node].long()
    null = t.parent.shape[0] - 1
    avail = torch.zeros((L, t.subtree.shape[1]), dtype=INT32,
                        device=usage.device)
    started = torch.zeros((L, 1), dtype=torch.bool, device=usage.device)
    for d in range(path.shape[1] - 1, -1, -1):
        node = path[:, d]
        is_valid = (node != null)[:, None]
        usage_n = usage[lanes, node]
        subtree_n = t.subtree[node]
        local_q = t.local_quota[node]
        local_avail = torch.clamp(local_q - usage_n, min=0)
        stored = subtree_n - local_q
        used_in_parent = torch.clamp(usage_n - local_q, min=0)
        clamp = torch.where(t.has_borrow[node],
                            stored - used_in_parent + t.borrow_limit[node],
                            BIG)
        child_avail = local_avail + torch.minimum(avail, clamp)
        cand = torch.where(started, child_avail, subtree_n - usage_n)
        avail = torch.where(is_valid, cand, avail)
        started = started | is_valid
    return avail


def _add_path(t, usage, cq_node, val):
    """addUsage with bubbling (resource_node.go:137-145) per lane."""
    lanes = torch.arange(cq_node.shape[0], device=usage.device)
    path = t.path[cq_node].long()
    null = t.parent.shape[0] - 1
    for d in range(path.shape[1]):
        node = path[:, d]
        is_valid = (node != null)[:, None]
        local_avail = torch.clamp(t.local_quota[node] - usage[lanes, node],
                                  min=0)
        usage = usage.index_put((lanes, node), torch.where(is_valid, val, 0),
                                accumulate=True)
        val = torch.clamp(val - local_avail, min=0)
    return usage


def _remove_path(t, usage, cq_node, val):
    """removeUsage with bubbling (resource_node.go:147-158) per lane:
    the parent's share shrinks by min(val, usage stored in parent)."""
    lanes = torch.arange(cq_node.shape[0], device=usage.device)
    path = t.path[cq_node].long()
    null = t.parent.shape[0] - 1
    for d in range(path.shape[1]):
        node = path[:, d]
        is_valid = (node != null)[:, None]
        stored = usage[lanes, node] - t.local_quota[node]
        usage = usage.index_put((lanes, node), torch.where(is_valid, -val, 0),
                                accumulate=True)
        val = torch.where(stored > 0, torch.minimum(val, stored), 0)
    return usage


def _height_path(t, usage, cq_node, req):
    """FindHeightOfLowestSubtreeThatFits per lane under mid-search usage
    (classical/hierarchical_preemption.go:221-243); level [L, F]."""
    lanes = torch.arange(cq_node.shape[0], device=usage.device)
    path = t.path[cq_node].long()
    null = t.parent.shape[0] - 1
    found = req == 0
    level = torch.zeros_like(req)
    rem = req
    root = cq_node.long()
    for d in range(path.shape[1]):
        node = path[:, d]
        valid = node != null
        root = torch.where(valid, node, root)
        usage_n = usage[lanes, node]
        not_borrowing = usage_n + rem <= t.subtree[node]
        newly = (~found) & not_borrowing & valid[:, None]
        level = torch.where(newly, t.height[node][:, None], level)
        found = found | newly
        la = torch.clamp(t.local_quota[node] - usage_n, min=0)
        rem = torch.where(found | ~valid[:, None], rem, rem - la)
    return torch.where(found, level, t.height[root][:, None])


def _workload_fits(t, usage, cq_node, req, allow_borrow):
    """_workload_fits (preemption.py:555) per lane: every requested FR
    fits available(); without allow_borrow the CQ also stays within its
    subtree quota."""
    lanes = torch.arange(cq_node.shape[0], device=usage.device)
    avail = _avail_path(t, usage, cq_node)
    nz = req > 0
    fits_avail = (~nz | (req <= avail)).all(dim=-1)
    no_borrow_ok = (~nz | (usage[lanes, cq_node.long()] + req
                           <= t.subtree[cq_node.long()])).all(dim=-1)
    return fits_avail & (allow_borrow | no_borrow_ok)


# ---------------------------------------------------------------------------
# head selection: per-CQ min by (-priority, ts, uid) over the pending set
# ---------------------------------------------------------------------------


def select_heads_full(t: FullTensors, admitted, parked, ts,
                      lq_penalty=None):
    """Each CQ's head row, W_null where the CQ has none; [C] int32.

    With ``lq_penalty`` (admission fair sharing, KEP-4136), within a
    UsageBasedAdmissionFairSharing CQ the head comes from the entries
    whose LocalQueue carries the lowest decayed usage; the (priority,
    ts, uid) order breaks ties (queue_manager afs_key). Segment C
    collects the padding rows; the JAX program gathers its per-CQ
    minima and maxima clamped to C-1 for them instead, which changes
    only segment C, and segment C is dropped."""
    C = t.cq_node.shape[0]
    W1 = t.wl_cqid.shape[0]
    W_null = W1 - 1
    pending = (~admitted & ~parked)[:-1]
    seg = t.wl_cqid[:-1]
    segl = seg.long()
    if lq_penalty is not None:
        is_afs = t.cq_afs[torch.clamp(seg, max=C - 1).long()]
        pen = lq_penalty[t.wl_lq[:-1].long()]
        min_pen = segment_min(torch.where(pending & is_afs, pen,
                                          float("inf")), seg, C + 1)
        pending = pending & (~is_afs | (pen == min_pen[segl]))
    prio = t.wl_prio[:-1]
    max_prio = segment_max(torch.where(pending, prio, -BIG), seg, C + 1)
    c1 = pending & (prio == max_prio[segl])
    min_ts = segment_min(torch.where(c1, ts[:-1], BIG), seg, C + 1)
    c2 = c1 & (ts[:-1] == min_ts[segl])
    uid = t.wl_uid[:-1]
    min_uid = segment_min(torch.where(c2, uid, BIG), seg, C + 1)
    c3 = c2 & (uid == min_uid[segl])
    w_idx = arange(W1 - 1, ts.device)
    head_w = segment_min(torch.where(c3, w_idx, W_null), seg, C + 1)[:C]
    has_head = max_prio[:C] > -BIG
    return _i32(torch.where(has_head, head_w, W_null))


# ---------------------------------------------------------------------------
# per-group nomination and the assigner's flavor walk
# ---------------------------------------------------------------------------


def nominate_full(t: FullTensors, usage, avail, pot, cand_w, cursor,
                  g_max: int, fs_enabled: bool = False):
    """Classify each CQ's head across (group, flavor) options.

    Per resource group the walk mirrors findFlavorForPodSets: start at
    the group's flavor cursor, prefer Fit per the whenCanBorrow policy,
    fall back to Preempt. The entry's mode is the worst group mode; its
    usage is the sum of the chosen options' requests. Returns (mode [C],
    k_chosen [C, G], req_total [C, F], borrow [C], next_cursor [C, G],
    opt_fit, opt_preempt, opt_level, group_active, valid)."""
    C, K = t.cq_opt_group.shape
    dev = usage.device
    cw = cand_w.long()
    rows = torch.arange(C, device=dev)
    req = t.wl_req[cw]                                   # [C,K,F]
    grp = t.cq_opt_group
    pos = t.cq_opt_pos
    cursor_k = torch.gather(cursor[cw], 1, grp.clamp(min=0).long())
    valid = t.wl_valid[cw] & (grp >= 0) & (pos >= cursor_k)

    cqn = t.cq_node.long()
    avail_cq = avail[cqn][:, None, :]
    pot_cq = pot[cqn][:, None, :]
    nominal_cq = t.nominal[cqn][:, None, :]
    level, may_reclaim = borrow_levels(t, usage, cand_w)

    nonzero = req > 0
    fit_fr = (~nonzero) | (req <= avail_cq)
    within_cap = (~nonzero) | (req <= pot_cq)
    # flavorassigner.go:1071-1108: preemption is considered within
    # nominal, where a higher subtree could reclaim, or where the CQ may
    # preempt while borrowing (borrowWithinCohort enabled; under fair
    # sharing also any reclaimWithinCohort policy other than Never)
    can_pwb = ~t.cq_bwc_forbidden
    if fs_enabled:
        can_pwb = can_pwb | (t.cq_reclaim_policy != POLICY_NEVER)
    can_pwb = can_pwb[:, None, None]
    preemptish_fr = (~nonzero) | (
        within_cap & ((req <= nominal_cq) | may_reclaim | can_pwb))
    opt_fit = valid & fit_fr.all(dim=-1)
    opt_preempt = valid & (fit_fr | preemptish_fr).all(dim=-1)
    opt_level = torch.where(nonzero, level, 0).amax(dim=-1)    # [C,K]

    k_idx = arange(K, dev)[None, :]

    def first_true(mask):
        return torch.where(mask, k_idx, K).amin(dim=1)

    mode = torch.full((C,), M_FIT, dtype=INT32, device=dev)
    req_total = torch.zeros((C, req.shape[2]), dtype=INT32, device=dev)
    borrow = torch.zeros((C,), dtype=INT32, device=dev)
    active_cols, k_cols, cursor_cols = [], [], []
    any_nonzero = nonzero.any(dim=-1)
    for g in range(g_max):
        in_g = grp == g
        has_g = in_g.any(dim=1)
        active = (in_g & any_nonzero).any(dim=1)
        fit_g = opt_fit & in_g
        pre_g = opt_preempt & in_g & ~opt_fit
        k_default = first_true(fit_g)
        k_nonborrow = first_true(fit_g & (opt_level == 0))
        lvl_key = torch.where(fit_g, opt_level * K + k_idx, BIG)
        k_bestlvl = _i32(torch.argmin(lvl_key, dim=1))
        k_try_next = torch.where(
            k_nonborrow < K, k_nonborrow,
            torch.where(fit_g.any(dim=1), k_bestlvl, K))
        k_fit = torch.where(t.cq_try_next, k_try_next, k_default)
        any_fit = k_fit < K
        k_preempt = first_true(pre_g)
        any_preempt = k_preempt < K
        k_g = torch.where(any_fit, k_fit,
                          torch.where(any_preempt, k_preempt,
                                      first_true(in_g)))
        k_g = torch.clamp(k_g, max=K - 1)
        kl = k_g.long()
        mode_g = _i32(torch.where(any_fit, M_FIT, torch.where(
            any_preempt, M_PREEMPT, M_NOFIT)))
        # inactive groups (no requested resources) are vacuous fits
        mode_g = torch.where(active & has_g, mode_g, M_FIT)
        mode = torch.minimum(mode, mode_g)
        k_cols.append(torch.where(active, k_g, 0))
        req_total = req_total + torch.where(active[:, None],
                                            req[rows, kl], 0)
        borrow = torch.maximum(borrow,
                               torch.where(active, opt_level[rows, kl], 0))
        # flavor cursor per group (flavorassigner.go:843)
        early_break = torch.where(t.cq_try_next, k_nonborrow < K, any_fit)
        pos_g = pos[rows, kl]
        n_in_g = in_g.sum(dim=1, dtype=INT32)
        nc = torch.where(early_break & (pos_g < n_in_g - 1), pos_g + 1, 0)
        cursor_cols.append(torch.where(active, nc, 0))
        active_cols.append(active)
    k_chosen = _i32(torch.stack(k_cols, dim=1))
    next_cursor = _i32(torch.stack(cursor_cols, dim=1))
    group_active = torch.stack(active_cols, dim=1)
    return (mode, k_chosen, req_total, borrow, next_cursor,
            opt_fit, opt_preempt, opt_level, group_active, valid)


def walk_assign(t: FullTensors, head_w, pmode_k, borrow_k, valid_k,
                group_active_row, g_max: int):
    """The assigner's flavor walk over granular modes, per lane (head).

    Emulates _find_flavor_for_podsets (flavorassigner.go:812-951): per
    resource group the first option where should_try_next_flavor is
    false wins; otherwise the best option by is_preferred — (pmode desc,
    borrow asc, index asc) under BorrowingOverPreemption, (borrow asc,
    pmode desc, index asc) under PreemptionOverBorrowing. Inputs carry a
    leading lane axis [H]. Returns (mode [H], k_out [H, G], req [H, F],
    borrow [H], next_cursor [H, G], pmode_sel [H, G])."""
    C = t.cq_node.shape[0]
    K = t.cq_opt_group.shape[1]
    dev = head_w.device
    H = head_w.shape[0]
    lanes = torch.arange(H, device=dev)
    hw = head_w.long()
    cqi = torch.clamp(t.wl_cqid[hw], max=C - 1).long()
    grp = t.cq_opt_group[cqi]                    # [H,K]
    pos = t.cq_opt_pos[cqi]
    req_k = t.wl_req[hw]                         # [H,K,F]
    pmode_k = torch.where(valid_k, pmode_k, P_NOFIT)
    is_pre_pm = (pmode_k == P_PREEMPT) | (pmode_k == P_RECLAIM)
    stn = ((pmode_k == P_NOFIT) | (pmode_k == P_NO_CANDIDATES)
           | (is_pre_pm & t.cq_preempt_try_next[cqi][:, None])
           | ((borrow_k != 0) & t.cq_try_next[cqi][:, None]))
    brk = valid_k & ~stn
    k_idx = arange(K, dev)[None, :]
    bor = torch.clamp(borrow_k, max=B_CAP - 1)
    key_bop = ((P_FIT - pmode_k) * B_CAP + bor) * K + k_idx
    key_pob = (bor * (P_FIT + 1) + (P_FIT - pmode_k)) * K + k_idx
    key = torch.where(t.cq_pref_pob[cqi][:, None], key_pob, key_bop)
    eligible = valid_k & (pmode_k > P_NOFIT)

    req = torch.zeros((H, req_k.shape[2]), dtype=INT32, device=dev)
    borrow = torch.zeros((H,), dtype=INT32, device=dev)
    mode = torch.full((H,), M_FIT, dtype=INT32, device=dev)
    k_cols, cursor_cols, pm_cols = [], [], []
    for g in range(g_max):
        in_g = grp == g
        has_g = in_g.any(dim=1)
        active = group_active_row[:, g]
        k_brk = torch.where(brk & in_g, k_idx, K).amin(dim=1)
        elig_g = eligible & in_g
        any_elig = elig_g.any(dim=1)
        k_best = _i32(torch.argmin(torch.where(elig_g, key, BIG), dim=1))
        k_first = torch.where(in_g, k_idx, K).amin(dim=1)
        k_g = torch.where(k_brk < K, k_brk,
                          torch.where(any_elig, k_best,
                                      torch.clamp(k_first, max=K - 1)))
        kl = k_g.long()
        pm_g = torch.where((k_brk < K) | any_elig, pmode_k[lanes, kl],
                           P_NOFIT)
        m_g = _i32(torch.where(pm_g == P_FIT, M_FIT, torch.where(
            pm_g == P_NOFIT, M_NOFIT, M_PREEMPT)))
        m_g = torch.where(active & has_g, m_g, M_FIT)
        mode = torch.minimum(mode, m_g)
        k_cols.append(torch.where(active, k_g, 0))
        pm_cols.append(torch.where(active & has_g, pm_g, P_FIT))
        req = req + torch.where(active[:, None], req_k[lanes, kl], 0)
        borrow = torch.maximum(
            borrow, torch.where(active, borrow_k[lanes, kl], 0))
        # flavor cursor (flavorassigner.go:843,939-947): the next attempt
        # resumes after the break position; walking off the end resets
        pos_brk = pos[lanes, torch.clamp(k_brk, max=K - 1).long()]
        n_in_g = in_g.sum(dim=1, dtype=INT32)
        nc = torch.where((k_brk < K) & (pos_brk < n_in_g - 1),
                         pos_brk + 1, 0)
        cursor_cols.append(torch.where(active, nc, 0))
    return (mode, _i32(torch.stack(k_cols, dim=1)), req, borrow,
            _i32(torch.stack(cursor_cols, dim=1)),
            _i32(torch.stack(pm_cols, dim=1)))


# ---------------------------------------------------------------------------
# classical preemption search
# ---------------------------------------------------------------------------


def build_candidate_table(t: FullTensors, admitted, admit_rank, wl_usage,
                          a_max: int):
    """Per-cohort-root admitted-candidate table, [N+1, A] int32.

    Candidates are admitted workloads with nonzero usage, per root in
    the shared order (priority asc, admit_rank desc, uid asc)
    (common/ordering.go); rows pad with W_null and keep the first
    ``a_max`` candidates. Dropped writes (non-candidates and positions
    past ``a_max``) go to a sink cell that is sliced away."""
    W1 = t.wl_cqid.shape[0]
    W_null = W1 - 1
    N1 = t.parent.shape[0]
    C = t.cq_node.shape[0]
    dev = admitted.device
    root_of = t.cq_root[torch.clamp(t.wl_cqid[:-1], max=C - 1).long()]
    elig = admitted[:-1] & (wl_usage[:-1] > 0).any(dim=1)
    order = lexsort((t.wl_uid[:-1], -admit_rank[:-1],
                     t.wl_prio[:-1])).long()
    rank = torch.zeros(W1 - 1, dtype=INT32, device=dev).index_put(
        (order,), arange(W1 - 1, dev))
    root_eff = torch.where(elig, root_of, N1)
    sorted_w = lexsort((rank, root_eff)).long()
    elig_s = elig[sorted_w]
    root_s = root_of[sorted_w]
    counts = segment_sum(_i32(elig), root_of, N1)
    offsets = torch.cumsum(counts, dim=0, dtype=INT32) - counts
    pos = arange(W1 - 1, dev) - offsets[root_s.long()]
    keep = elig_s & (pos < a_max)
    row = torch.where(keep, root_s, N1).long()
    col = torch.where(keep, pos, a_max).long()
    table = torch.full((N1 + 1, a_max + 1), W_null, dtype=INT32,
                       device=dev)
    table = table.index_put((row, col), _i32(sorted_w))
    return table[:N1, :a_max]


def classical_search(t: FullTensors, usage0_round, wl_usage, admitted,
                     evicted_f, ts, head_w, req, avail_cq, cands,
                     p_max: int, stats: FullDrainStats):
    """Victim search for every lane (one preemptor each).

    ``head_w`` [L], ``req`` [L, F], ``avail_cq`` [L, F] and ``cands``
    [L, P] (the preemptor root's row of build_candidate_table) carry the
    lane axis; the round state is shared, or, in the scenario-batched
    drain, ``t`` and the state are ``_lane_view`` / ``_PerLane`` reads
    of each lane's own scenario. Returns (success [L], cand_w
    [L, P] int32 W_null padded, victims [L, P] bool, victim_reason
    [L, P] int8, any_same_cq [L], borrow_after [L] int32). Mirrors
    Preemptor._classical_preemptions: candidate legality and order, two
    allow-borrowing attempts of the remove-until-fits walk, then
    fillBackWorkloads; the walk skips every currently invalid candidate
    in one step (pop-time validity only flips true -> false as removals
    shrink usage), so each iteration removes one victim."""
    W1 = t.wl_cqid.shape[0]
    W_null = W1 - 1
    C_n = t.cq_node.shape[0]
    N1 = t.parent.shape[0]
    null_node = N1 - 1
    D = t.path.shape[1]
    dev = head_w.device
    L, P = cands.shape
    lanes = torch.arange(L, device=dev)
    lanes_p = lanes[:, None].expand(L, P)
    hw = head_w.long()
    cqid = t.wl_cqid[hw]
    cqi = torch.clamp(cqid, max=C_n - 1).long()
    cq_node = t.cq_node[cqi].long()
    my_path = t.path[cq_node]                                # [L,D]
    d_idx = arange(D, dev)
    p_idx = arange(P, dev)

    # FRs needing preemption: requested and not fitting current avail
    frs_mask = (req > 0) & (req > avail_cq)                  # [L,F]

    # ---- candidate legality (candidate_generator.go:34-160) ----------
    cl = cands.long()
    present = cands != W_null
    cand_cqid = t.wl_cqid[cl]                                # [L,P]
    cand_node = t.cq_node[torch.clamp(cand_cqid, max=C_n - 1).long()]
    cand_node_l = cand_node.long()
    is_adm = present & admitted[cl] & (cands != head_w[:, None])
    uses = ((wl_usage[cl] * frs_mask[:, None, :]) > 0).any(dim=-1)
    same_cq = cand_cqid == cqid[:, None]
    prio_p = t.wl_prio[hw][:, None]
    prio_c = t.wl_prio[cl]
    lower = prio_p > prio_c
    # newer-equal: beyond the preemptor's threshold rank; a preemptor
    # evicted in this drain was evicted "now" (nothing is newer)
    buf_p = torch.where(ts[hw] >= t.ts_evict_base, BIG, t.wl_ts_buf[hw])
    newer_eq = (prio_p == prio_c) & (ts[cl] > buf_p[:, None])
    policy = torch.where(same_cq, t.cq_within_policy[cqi][:, None],
                         t.cq_reclaim_policy[cqi][:, None])
    sat = torch.where(
        policy == POLICY_NEVER, False,
        torch.where(policy == POLICY_LOWER_PRIORITY, lower,
                    torch.where(policy == POLICY_LOWER_OR_NEWER_EQUAL,
                                lower | newer_eq, policy == POLICY_ANY)))
    legal = is_adm & uses & sat

    # ---- LCA ring + hierarchical advantage ---------------------------
    cand_path = t.path[cand_node_l]                          # [L,P,D]
    is_anc = (cand_path[:, :, :, None]
              == my_path[:, None, None, :]).any(dim=2)       # [L,P,Dp]
    is_anc = is_anc & (my_path[:, None, :] != null_node)
    lca_d = torch.where(is_anc, d_idx, D).amin(dim=-1)       # [L,P]
    other_ok = (lca_d >= 1) & (lca_d < D)
    lca_c = torch.clamp(lca_d, max=D - 1).long()

    # advantage chain along my path over the REQUESTED FRs only
    nz_req = req > 0
    u_cq = usage0_round[cq_node]
    adv = (~nz_req | (u_cq + req <= t.subtree[cq_node])).all(dim=-1)
    rem = torch.clamp(req - torch.clamp(t.local_quota[cq_node] - u_cq,
                                        min=0), min=0)
    adv_cols = [torch.zeros(L, dtype=torch.bool, device=dev)]
    for d in range(1, D):
        node = my_path[:, d].long()
        ok = node != null_node
        adv_cols.append(adv)
        u_n = usage0_round[node]
        fits_d = (~nz_req | (u_n + rem <= t.subtree[node])).all(dim=-1) & ok
        rem = torch.clamp(rem - torch.clamp(t.local_quota[node] - u_n,
                                            min=0), min=0)
        adv = adv | fits_d
    hier_adv = torch.gather(torch.stack(adv_cols, dim=1), 1, lca_c)

    # collection-time within-nominal pruning on round-start usage: the
    # candidate's CQ and every cohort strictly below the LCA must be
    # over nominal for some needed FR (_collect_in_subtree)
    cand_over = ~(~frs_mask[:, None, :] | (usage0_round[cand_node_l]
                                           <= t.subtree[cand_node_l])
                  ).all(dim=-1)
    lca_node = torch.gather(my_path, 1, lca_c)
    seen_lca = torch.cumsum(_i32(cand_path == lca_node[..., None]),
                            dim=-1) > 0
    strictly_below = ~seen_lca & (cand_path != null_node) & (d_idx != 0)
    cp = cand_path.long()
    node_over = ~(~frs_mask[:, None, None, :]
                  | (usage0_round[cp] <= t.subtree[cp])).all(dim=-1)
    path_over = (~strictly_below | node_over).all(dim=-1)
    other_legal = legal & ~same_cq & other_ok & cand_over & path_over
    legal_all = other_legal | (legal & same_cq)

    # ---- variants & groups -------------------------------------------
    thr = t.cq_bwc_threshold[cqi][:, None]
    above_thr = (prio_c >= prio_p) | ((thr != int(NO_THRESHOLD))
                                      & (prio_c > thr))
    bwc_forbidden = t.cq_bwc_forbidden[cqi]
    variant = _i32(torch.where(
        same_cq, V_WITHIN_CQ,
        torch.where(hier_adv, V_HIERARCHICAL_RECLAIM,
                    torch.where(bwc_forbidden[:, None] | above_thr,
                                V_RECLAIM_WITHOUT_BORROWING,
                                V_RECLAIM_WHILE_BORROWING))))
    group_rank = _i32(torch.where(same_cq, 2, torch.where(hier_adv, 0, 1)))

    # ---- ordering: a stable 7-bucket sort of the shared order --------
    not_evicted = ~evicted_f[cl]
    bucket = torch.where(legal_all,
                         torch.where(not_evicted, 3 + group_rank,
                                     group_rank), 6)
    perm = torch.argsort(bucket * p_max + p_idx, dim=-1)    # unique keys
    cand_ok = torch.gather(bucket, 1, perm) < 6
    cand_w = torch.where(cand_ok, torch.gather(cands, 1, perm), W_null)
    cand_valid = cand_ok
    cand_variant = torch.where(cand_valid, torch.gather(variant, 1, perm),
                               V_NEVER)
    cand_lca = torch.where(cand_valid, torch.gather(lca_d, 1, perm), 0)

    # per-candidate walk state on the permuted axis
    cwl = cand_w.long()
    v_cqid = t.wl_cqid[cwl]
    v_node = t.cq_node[torch.clamp(v_cqid, max=C_n - 1).long()].long()
    v_path = t.path[v_node].long()                           # [L,P,D]
    v_usage = wl_usage[cwl]                                  # [L,P,F]
    v_same = cand_valid & (v_cqid == cqid[:, None])
    v_lnode = torch.gather(my_path, 1,
                           torch.clamp(cand_lca, max=D - 1).long())
    v_seen = torch.cumsum(_i32(v_path == v_lnode[..., None]),
                          dim=-1) > 0
    v_below = ~v_seen & (v_path != null_node) & (d_idx != 0)
    sub_vnode = t.subtree[v_node]
    sub_vpath = t.subtree[v_path]

    # ---- attempt schedule (preemption.py:508-515) --------------------
    no_other = ~other_legal.any(dim=-1)
    no_hier = ~(other_legal & hier_adv).any(dim=-1)
    under_nominal = (~frs_mask | (usage0_round[cq_node]
                                  < t.nominal[cq_node])).all(dim=-1)
    single = no_other | (bwc_forbidden & ~under_nominal)
    f_then_t = ~single & bwc_forbidden & no_hier
    first_borrow = ~f_then_t
    has_second = ~single

    usage_init = _per_lane(usage0_round, L)
    rows0 = torch.where(_per_lane(t.is_cq, L)[..., None], usage_init, 0)

    def attempt(allow_borrow, run):
        # infeasibility precheck: remove every candidate this attempt
        # could ever pop; available() is monotone in usage, so if the
        # preemptor does not fit even then, no subset can succeed
        removable = cand_valid & ~(
            allow_borrow[:, None]
            & (cand_variant == V_RECLAIM_WITHOUT_BORROWING))
        rows_min = rows0.index_put(
            (lanes_p, v_node),
            -torch.where(removable[..., None], v_usage, 0), accumulate=True)
        usage_min = _refresh_per_lane(t, rows_min)
        run = run & _workload_fits(t, usage_min, cq_node, req, allow_borrow)

        usage_l = usage_init
        victims = torch.zeros((L, P), dtype=torch.bool, device=dev)
        fitted = torch.zeros(L, dtype=torch.bool, device=dev)
        cursor = torch.zeros(L, dtype=INT32, device=dev)
        while True:
            active = run & ~fitted & (cursor < p_max)
            if not stats.read(active.any()):
                break
            stats.walk_iterations += 1
            # bulk pop-time validity (_valid) under the current usage
            cq_over = (frs_mask[:, None, :]
                       & (usage_l[lanes_p, v_node] > sub_vnode)).any(dim=-1)
            wn = (~frs_mask[:, None, None, :]
                  | (usage_l[lanes[:, None, None], v_path] <= sub_vpath)
                  ).all(dim=-1)
            path_ok = (~v_below | ~wn).all(dim=-1)
            valid_now = removable & (v_same | (cq_over & path_ok))
            j = torch.where(valid_now & (p_idx >= cursor[:, None]), p_idx,
                            p_max).amin(dim=-1)
            has = j < p_max
            jc = torch.clamp(j, max=p_max - 1).long()
            u_row = torch.where(has[:, None], v_usage[lanes, jc], 0)
            usage_n = _remove_path(t, usage_l, v_node[lanes, jc], u_row)
            victims_n = victims.index_put((lanes, jc),
                                          victims[lanes, jc] | has)
            fitted_n = has & _workload_fits(t, usage_n, cq_node, req,
                                            allow_borrow)
            usage_l = torch.where(active[:, None, None], usage_n, usage_l)
            victims = torch.where(active[:, None], victims_n, victims)
            fitted = torch.where(active, fitted_n, fitted)
            cursor = torch.where(active, j + 1, cursor)

        # fillBackWorkloads: re-add earlier victims (not the last one)
        # newest-first while the preemptor still fits; a fitted lane runs
        # exactly nv - 1 steps, so one read bounds the loop
        vseq = torch.cumsum(_i32(victims), dim=-1) - 1
        nv = torch.where(victims, vseq + 1, 0).amax(dim=-1)
        s = nv - 2
        n_steps = stats.read(torch.where(fitted, nv - 1, 0).amax())
        vcur = victims
        for _ in range(n_steps):
            stats.fill_iterations += 1
            active = fitted & (s >= 0)
            match = victims & (vseq == s[:, None])
            slot = torch.argmax(_i32(match), dim=-1)
            tryit = match.any(dim=-1)
            u_row = torch.where(tryit[:, None], v_usage[lanes, slot], 0)
            node = v_node[lanes, slot]
            usage_a = _add_path(t, usage_l, node, u_row)
            still = _workload_fits(t, usage_a, cq_node, req, allow_borrow)
            # fit held -> the candidate stays re-added (not a victim);
            # fit broke -> undo the re-add, it remains a victim
            usage_b = _remove_path(t, usage_a, node, torch.where(
                (tryit & ~still)[:, None], u_row, 0))
            vcur_n = vcur.index_put((lanes, slot),
                                    vcur[lanes, slot] & ~(tryit & still))
            usage_l = torch.where(active[:, None, None], usage_b, usage_l)
            vcur = torch.where(active[:, None], vcur_n, vcur)
            s = torch.where(active, s - 1, s)
        return fitted, vcur, usage_l

    ones = torch.ones(L, dtype=torch.bool, device=dev)
    ok1, v1, u1 = attempt(first_borrow, ones)
    ok2, v2, u2 = attempt(f_then_t, has_second & ~ok1)
    success = ok1 | ok2
    victims = torch.where(ok1[:, None], v1, torch.where(ok2[:, None], v2,
                                                        False))
    usage_after = torch.where(ok1[:, None, None], u1,
                              torch.where(ok2[:, None, None], u2,
                                          usage_init))
    level_f = _height_path(t, usage_after, cq_node, req)
    borrow_after = torch.where(frs_mask, level_f, 0).amax(dim=-1)
    reason = torch.where(victims, cand_variant, V_NEVER).to(torch.int8)
    any_same_cq = (victims & (v_cqid == cqid[:, None])
                   & cand_valid).any(dim=-1)
    return success, _i32(cand_w), victims, reason, any_same_cq, borrow_after


def _run_searches(t, usage, wl_usage, admitted, evicted, ts, flat_w,
                  flat_req, flat_avail, flat_cands, p_max,
                  stats: FullDrainStats, fs_enabled: bool = False,
                  lendable_r=None):
    """The per-lane victim searches (the single-device branch of the
    JAX program; the lanes are one batch): the fair search under fair
    sharing, else the classical one."""
    stats.lanes += flat_w.shape[0]
    if fs_enabled:
        from kueue_oss_tpu_torch.solver.fair_kernels import fair_search

        return fair_search(t, lendable_r, usage, wl_usage, admitted,
                           evicted, ts, flat_w, flat_req, flat_avail,
                           flat_cands, p_max, stats)
    return classical_search(t, usage, wl_usage, admitted, evicted, ts,
                            flat_w, flat_req, flat_avail, flat_cands,
                            p_max, stats)


# ---------------------------------------------------------------------------
# round scan: entry processing with preemption issue (scheduler.go:337-467)
# ---------------------------------------------------------------------------


def _quota_to_reserve(t, usage_cq, cq_node, req, borrow):
    """scheduler.go quotaResourcesToReserve for Preempt/NoCandidates."""
    nominal_cq = t.nominal[cq_node]
    reserve_borrowing = torch.where(
        t.has_borrow[cq_node],
        torch.minimum(req, nominal_cq + t.borrow_limit[cq_node] - usage_cq),
        req)
    reserve_nominal = torch.minimum(req, nominal_cq - usage_cq)
    return torch.clamp(torch.where(borrow[:, None] > 0, reserve_borrowing,
                                   reserve_nominal), min=0)


def full_round_scan(t: FullTensors, state, cand_w, mode, k_chosen, req_c,
                    borrow, lane_of_entry, lane_success, lane_cand_w,
                    lane_victims, lane_reason, p_max: int,
                    stats: FullDrainStats, fs_enabled: bool = False,
                    lendable_r=None, afs: bool = False):
    """Process the round's entries in order; returns the updated state
    parts, (admitted, preempted) per entry and whether any entry
    admitted or evicted.

    The order is the classical sort (borrow, -priority, timestamp, uid)
    or, under fair sharing, the dynamic per-pop DRS tournament
    (fair_sharing_iterator.go: each pop re-evaluates shares on the
    mutated usage): one ``fair_entry_pick`` on the device per pop, whose
    entry is read back (one read per pop), until no entry is active or
    after C pops. Both orders run the same per-entry step.

    ``state`` holds usage_full and usage_net ([N+1, F], bubbled, with
    reservations), cq_rows, admitted, parked, wl_usage, victims_all,
    victim_reason, lq_penalty and ts. One read per call brings each
    entry's lane, the lanes' success flags and their last victim slots
    to the host: an entry whose lane found no targets cannot preempt, so
    its preemption block is skipped, and the sequential victim removal
    of the fits re-check runs exactly to the lane's last victim slot.
    The removals stay sequential: the bubbling ``min`` of removeUsage
    makes the result depend on their order. With ``afs`` each admission
    in an AFS ClusterQueue charges its entry penalty to its LocalQueue,
    one [1]-index add at a time (a batched float add with repeated
    indices would not be deterministic on CUDA).
    """
    C = cand_w.shape[0]
    W_null = t.wl_cqid.shape[0] - 1
    dev = cand_w.device
    H, P = lane_victims.shape
    cw = cand_w.long()
    active = (cand_w != W_null) & (mode != M_NOFIT)
    n_slots = torch.where(lane_victims, arange(P, dev) + 1, 0).amax(dim=-1)
    if fs_enabled:
        host = stats.read(torch.cat([lane_of_entry, _i32(lane_success),
                                     _i32(n_slots),
                                     active.sum(dtype=INT32)[None]]))
    else:
        sort_borrow = torch.where(active, borrow, BIG)
        order = lexsort((t.wl_uid[cw], state["ts"][cw], -t.wl_prio[cw],
                         sort_borrow)).long()
        host = stats.read(torch.cat([lane_of_entry[order],
                                     _i32(lane_success), _i32(n_slots)]))
    lane_at = host[:C]
    lane_ok = host[C:C + H]
    lane_slots = host[C + H:C + 2 * H]

    s = {k: state[k] for k in ("cq_rows", "admitted", "parked", "wl_usage",
                               "victims_all", "victim_reason",
                               "lq_penalty")}
    s["usage_full"] = state["usage_full"][None]
    s["usage_net"] = state["usage_net"][None]
    s["any_adm"] = torch.zeros(1, dtype=torch.bool, device=dev)
    s["any_evict"] = torch.zeros(1, dtype=torch.bool, device=dev)
    no = torch.zeros(1, dtype=torch.bool, device=dev)

    def step(w, c, m, req, brw, lane):
        """One entry: ``w``, ``c`` (entry index), ``m``, ``req``,
        ``brw`` are [1]-shaped slices, ``lane`` the host's lane index
        (-1 when the entry was not searched). Updates ``s``; returns
        (admitted, preempted), each [1]."""
        usage_full, usage_net = s["usage_full"], s["usage_net"]
        admitted, wl_usage = s["admitted"], s["wl_usage"]
        cq_node = t.cq_node[c].long()
        is_active = (w != W_null) & (m != M_NOFIT)
        has_targets = lane >= 0 and bool(lane_ok[lane])

        if lane >= 0 and not has_targets:
            # Preempt / NoCandidates: reserve entitled capacity and park
            is_reserve = is_active & (m == M_PREEMPT)
            reserve = torch.where(is_reserve[:, None], _quota_to_reserve(
                t, usage_full[0, cq_node], cq_node, req, brw), 0)
            usage_full = _add_path(t, usage_full, cq_node, reserve)
            usage_net = _add_path(t, usage_net, cq_node, reserve)
            s["parked"] = s["parked"].index_put(
                (w,), s["parked"][w] | (is_reserve & ~t.cq_strict[c]))

        do_preempt = no
        if has_targets:
            # overlap check (one conflicting preemption per cycle)
            vm = lane_victims[lane:lane + 1]                    # [1,P]
            vw = lane_cand_w[lane].long()                       # [P]
            overlap = (vm & s["victims_all"][vw][None]).any(dim=-1)
            is_preempt = is_active & (m == M_PREEMPT) & ~overlap
            # fits re-check with the lane's own victims removed (earlier
            # preemptions are already out of usage_net)
            v_nodes = t.cq_node[torch.clamp(t.wl_cqid[vw],
                                            max=C - 1).long()].long()
            usage_probe = usage_net
            for k in range(lane_slots[lane]):
                stats.removal_steps += 1
                row = torch.where((vm[:, k] & is_preempt)[:, None],
                                  wl_usage[vw[k:k + 1]], 0)
                usage_probe = _remove_path(t, usage_probe,
                                           v_nodes[k:k + 1], row)
            avail_now = _avail_path(t, usage_probe, cq_node)
            still_fits = ((req == 0) | (req <= avail_now)).all(dim=-1)
            # issue preemptions (scheduler.go issuePreemptions)
            do_preempt = is_preempt & still_fits
            usage_net = torch.where(do_preempt[:, None, None], usage_probe,
                                    usage_net)
            evict_now = (do_preempt[:, None] & vm)[0]           # [P]
            s["victims_all"] = _with_last(
                _scatter_bool(s["victims_all"], vw, evict_now, "amax"), False)
            s["victim_reason"] = _with_last(_scatter_bool(
                s["victim_reason"], vw,
                torch.where(evict_now, lane_reason[lane], 0), "amax"), 0)
            admitted = _scatter_bool(admitted, vw, ~evict_now, "amin")
            # durable rows: the victims' usage leaves their CQ rows
            s["cq_rows"] = s["cq_rows"].index_add(0, v_nodes, -torch.where(
                evict_now[:, None], wl_usage[vw], 0))
            # the preemptor charges its usage for the rest of the round
            entry_usage = torch.where(do_preempt[:, None], req, 0)
            usage_full = _add_path(t, usage_full, cq_node, entry_usage)
            usage_net = _add_path(t, usage_net, cq_node, entry_usage)
            s["any_evict"] = s["any_evict"] | do_preempt

        # Fit: re-check under the current usage, then admit
        avail_fit = _avail_path(t, usage_net, cq_node)
        fit_ok = ((req == 0) | (req <= avail_fit)).all(dim=-1)
        do_admit = is_active & (m == M_FIT) & fit_ok
        admit_vec = torch.where(do_admit[:, None], req, 0)
        s["usage_full"] = _add_path(t, usage_full, cq_node, admit_vec)
        s["usage_net"] = _add_path(t, usage_net, cq_node, admit_vec)
        s["cq_rows"] = s["cq_rows"].index_add(0, cq_node, admit_vec)
        s["admitted"] = admitted.index_put((w,), admitted[w] | do_admit)
        s["wl_usage"] = wl_usage.index_put(
            (w,), torch.where(do_admit[:, None], req, wl_usage[w]))
        if afs:
            # AFS entry penalty: charge the admitted usage to the
            # LocalQueue (afs/entry_penalties.go)
            s["lq_penalty"] = s["lq_penalty"].index_add(
                0, t.wl_lq[w].long(), torch.where(
                    do_admit & t.cq_afs[c], t.wl_afs_penalty[w], 0.0))
        s["any_adm"] = s["any_adm"] | do_admit
        return do_admit, do_preempt

    adm_flags, pre_flags = [], []
    if fs_enabled:
        from kueue_oss_tpu_torch.solver.fair_kernels import fair_entry_pick

        e_idx = arange(C, dev)
        act = active
        n_active = host[-1]
        picked = []
        for _ in range(C):
            if n_active == 0:
                break
            e = fair_entry_pick(t, lendable_r, s["usage_net"][0], cand_w,
                                req_c, state["ts"], act)
            stats.entry_picks += 1
            e_host = stats.read(e)
            if e_host >= C:
                # nothing picked: the state is unchanged, so every later
                # pop would pick nothing too (JAX runs them as no-ops)
                break
            c = e.reshape(1).long()
            da, dp = step(cw[c], c, mode[c], req_c[c], borrow[c],
                          lane_at[e_host])
            act = act & (e_idx != e)
            n_active -= 1
            picked.append(c)
            adm_flags.append(da)
            pre_flags.append(dp)
        order = (torch.cat(picked) if picked
                 else torch.zeros(0, dtype=torch.long, device=dev))
    else:
        slot_w = cw[order]
        slot_m = mode[order]
        slot_req = req_c[order]
        slot_b = borrow[order]
        for i in range(C):
            da, dp = step(slot_w[i:i + 1], order[i:i + 1], slot_m[i:i + 1],
                          slot_req[i:i + 1], slot_b[i:i + 1], lane_at[i])
            adm_flags.append(da)
            pre_flags.append(dp)

    # per-slot flags back to entry order
    zeros = torch.zeros(C, dtype=torch.bool, device=dev)
    adm_entry = zeros.index_put((order,), torch.cat(adm_flags + [no[:0]]))
    pre_entry = zeros.index_put((order,), torch.cat(pre_flags + [no[:0]]))
    return {
        "usage_full": s["usage_full"][0], "usage_net": s["usage_net"][0],
        "cq_rows": s["cq_rows"], "admitted": s["admitted"],
        "parked": s["parked"], "wl_usage": s["wl_usage"],
        "victims_all": s["victims_all"],
        "victim_reason": s["victim_reason"],
        "lq_penalty": s["lq_penalty"],
    }, adm_entry, pre_entry, s["any_adm"][0], s["any_evict"][0]


# ---------------------------------------------------------------------------
# the drain loop
# ---------------------------------------------------------------------------


def round_body(t: FullTensors, state, pot, g_max: int, h_max: int,
               p_max: int, stats: FullDrainStats, fs_enabled: bool = False,
               lendable_r=None, afs: bool = False):
    """One reference cycle; returns (new_state, debug). Fair sharing
    (``fs_enabled``) needs ``lendable_r`` (``fair_kernels.
    lendable_by_resource``); ``afs`` turns on the admission-fair-sharing
    head order and entry penalties (some ClusterQueue has
    ``cq_afs``)."""
    W1 = t.wl_cqid.shape[0]
    C = t.cq_node.shape[0]
    N1 = t.parent.shape[0]
    W_null = W1 - 1
    K = t.cq_opt_group.shape[1]
    dev = t.wl_cqid.device

    rounds = state["rounds"]
    admitted = state["admitted"]
    ts = state["ts"]
    usage = state["usage"]                # round start (victims charged)
    wl_usage = state["wl_usage"]
    class_nofit = state["class_nofit"]
    wl_class = t.wl_class.long()
    # scheduling-equivalence dedup (cluster_queue.go:371): a workload
    # whose class is known NoFit parks before head selection
    parked = _with_last(state["parked"] | (~admitted & class_nofit[wl_class]),
                        False)
    parked_before = parked
    cursor_before = state["cursor"]

    cand_w = select_heads_full(
        t, admitted, parked, ts,
        lq_penalty=state["lq_penalty"] if afs else None)
    cw = cand_w.long()
    avail = available_all(t, usage)
    (mode, k_chosen, req_c, borrow, next_cursor, opt_fit, opt_preempt,
     opt_level, group_active, opt_valid) = nominate_full(
        t, usage, avail, pot, cand_w, state["cursor"], g_max, fs_enabled)
    is_head = cand_w != W_null

    # ---- heads needing victim-search simulation ----------------------
    # a fit under default fungibility (whenCanPreempt=TryNextFlavor,
    # BorrowingOverPreemption) beats every preempt option in the walk
    any_preemptish = (opt_preempt & ~opt_fit).any(dim=1)
    fit_wins = (mode == M_FIT) & t.cq_preempt_try_next & ~t.cq_pref_pob
    needs_search = (is_head & any_preemptish & ~fit_wins
                    & (mode != M_NOFIT))

    # ---- compact searching heads into h_max lanes (entry order) ------
    # (~needs_search sorts False first; heads past h_max wait a round)
    ekey = lexsort((t.wl_uid[cw], ts[cw], -t.wl_prio[cw],
                    torch.where(needs_search, borrow, BIG),
                    _i32(~needs_search))).long()
    pe_sorted = needs_search[ekey]
    pos = torch.cumsum(_i32(pe_sorted), dim=0, dtype=INT32) - 1
    lane_cq = _scatter_sink(
        torch.full((h_max,), C, dtype=INT32, device=dev),
        torch.where(pe_sorted & (pos < h_max), pos, h_max), _i32(ekey))
    lane_valid = lane_cq < C
    lane_cqc = torch.clamp(lane_cq, max=C - 1).long()
    lane_w = torch.where(lane_valid, cand_w[lane_cqc], W_null)
    lane_avail = avail[t.cq_node[lane_cqc].long()]
    lane_of_entry = _scatter_sink(
        torch.full((C,), -1, dtype=INT32, device=dev),
        torch.where(lane_valid, lane_cq, C), arange(h_max, dev))

    # ---- per-option victim-search simulation over [H, K] -------------
    cand_table = build_candidate_table(t, admitted, state["admit_rank"],
                                       wl_usage, p_max)
    lane_cands = cand_table[t.cq_root[lane_cqc].long()]     # [H,P]
    evicted = state["evicted"]
    flat_w = lane_w.repeat_interleave(K)
    flat_req = t.wl_req[lane_w.long()].reshape(h_max * K, -1)
    flat_avail = lane_avail.repeat_interleave(K, dim=0)
    flat_cands = lane_cands.repeat_interleave(K, dim=0)
    (s_succ, s_cand_w, s_victims, s_reason, s_same, s_borrow) = (
        _run_searches(t, usage, wl_usage, admitted, evicted, ts, flat_w,
                      flat_req, flat_avail, flat_cands, p_max, stats,
                      fs_enabled, lendable_r))

    # granular-mode table per (lane, option)
    sim_pmode = _i32(torch.where(
        s_succ, torch.where(s_same, P_PREEMPT, P_RECLAIM),
        P_NO_CANDIDATES)).reshape(h_max, K)
    sim_borrow = s_borrow.reshape(h_max, K)
    fit_l = opt_fit[lane_cqc]
    pre_l = (opt_preempt & ~opt_fit)[lane_cqc]
    pmode_k = torch.where(fit_l, P_FIT,
                          torch.where(pre_l, sim_pmode, P_NOFIT))
    borrow_k = torch.where(fit_l, opt_level[lane_cqc],
                           torch.where(pre_l, sim_borrow, 0))

    # ---- the assigner's walk picks each lane's final assignment ------
    (l_mode, l_k, l_req, l_borrow, l_next_cursor, _l_pmode_sel) = (
        walk_assign(t, lane_w, pmode_k, borrow_k, opt_valid[lane_cqc],
                    group_active[lane_cqc], g_max))
    l_req = torch.where(lane_valid[:, None], l_req, 0)
    lane_target = torch.where(lane_valid, lane_cq, C)
    mode = _scatter_sink(mode, lane_target, l_mode)
    k_chosen = _scatter_sink(k_chosen, lane_target, l_k)
    req_c = _scatter_sink(req_c, lane_target, l_req)
    borrow = _scatter_sink(borrow, lane_target, l_borrow)
    next_cursor = _scatter_sink(next_cursor, lane_target, l_next_cursor)

    # ---- final victim set for each preempting lane -------------------
    if g_max == 1:
        # one group: the chosen option's simulation IS the final search
        idx = arange(h_max, dev).long() * K + l_k[:, 0].long()
        lane_success = s_succ[idx]
        lane_cand_w = s_cand_w[idx]
        lane_victims = s_victims[idx]
        lane_reason = s_reason[idx]
    else:
        # several groups: GetTargets re-runs on the combined usage
        (lane_success, lane_cand_w, lane_victims, lane_reason, _s,
         _b) = _run_searches(t, usage, wl_usage, admitted, evicted, ts,
                             lane_w, l_req, lane_avail, lane_cands, p_max,
                             stats, fs_enabled, lendable_r)
    lane_success = lane_success & lane_valid & (l_mode == M_PREEMPT)

    # compact victims to the front of each lane's slot axis (stable)
    key = torch.where(lane_victims, arange(p_max, dev), p_max)
    perm = torch.argsort(key, dim=-1, stable=True)
    lane_cand_w = torch.gather(lane_cand_w, 1, perm)
    lane_victims = torch.gather(lane_victims, 1, perm)
    lane_reason = torch.gather(lane_reason, 1, perm)

    # park NoFit heads of BestEffortFIFO queues (post-walk modes); the
    # CQs without a head all rewrite the null row's own value
    park_now = is_head & (mode == M_NOFIT) & ~t.cq_strict
    parked = parked.index_put((cw,), parked[cw] | park_now)

    # ---- entry scan --------------------------------------------------
    scan_state = {
        "usage_full": usage, "usage_net": usage,
        "cq_rows": state["cq_rows"], "admitted": admitted,
        "parked": parked, "wl_usage": wl_usage,
        "victims_all": torch.zeros(W1, dtype=torch.bool, device=dev),
        "victim_reason": state["victim_reason"], "ts": ts,
        "lq_penalty": state["lq_penalty"],
    }
    out, adm_entry, pre_entry, any_adm, any_evict = full_round_scan(
        t, scan_state, cand_w, mode, k_chosen, req_c, borrow,
        lane_of_entry, lane_success, lane_cand_w, lane_victims,
        lane_reason, p_max, stats, fs_enabled, lendable_r, afs)
    admitted = out["admitted"]
    parked = out["parked"]
    wl_usage = out["wl_usage"]
    victims = out["victims_all"]

    # ---- bookkeeping for evicted victims ------------------------------
    ts = torch.where(victims, t.ts_evict_base + rounds, ts)
    evicted_f = evicted | victims
    admit_rank = torch.where(victims, 0, state["admit_rank"])
    # re-admissions: clear Evicted, stamp the reservation rank; the
    # ordering timestamp reverts to creation. Rows of CQs without a new
    # admission all address the null row and rewrite its own value.
    newly = adm_entry & is_head
    adm_w = torch.where(newly, cand_w, W_null).long()
    ts = ts.index_put((adm_w,), torch.where(newly, t.wl_ts0[adm_w],
                                            ts[adm_w]))
    evicted_f = evicted_f.index_put(
        (adm_w,), torch.where(newly, False, evicted_f[adm_w]))
    admit_rank = admit_rank.index_put(
        (adm_w,), torch.where(newly, t.admit_rank_base + rounds,
                              admit_rank[adm_w]))
    evicted_f = _with_last(evicted_f, False)

    # chosen options + admit round for the decode
    opt = state["opt"]
    opt = opt.index_put((adm_w,), torch.where(newly[:, None], k_chosen,
                                              opt[adm_w]))
    admit_round = state["admit_round"]
    admit_round = admit_round.index_put(
        (adm_w,), torch.where(newly, rounds, admit_round[adm_w]))

    # flavor cursors: pending heads resume their walk; an entry that
    # issued preemptions restarts from flavor 0; evicted workloads too
    keep = is_head & ~admitted[cw]
    new_cur = torch.where(pre_entry[:, None], 0, next_cursor)
    cursor = state["cursor"].index_put(
        (cw,), torch.where(keep[:, None], new_cur, state["cursor"][cw]))
    cursor = torch.where(victims[:, None], 0, cursor)

    # ---- NoFit equivalence classes (handleInadmissibleHash) ----------
    newly_parked = parked & ~parked_before
    n_cls = class_nofit.shape[0]
    class_nofit = _with_last(_scatter_bool(
        class_nofit, torch.where(newly_parked, t.wl_class, n_cls - 1),
        newly_parked, "amax"), False)
    parked = _with_last(parked | (~admitted & class_nofit[wl_class]), False)

    # ---- capacity-freed flush: unpark cohort roots with evictions ----
    victim_roots = t.cq_root[torch.clamp(t.wl_cqid[:-1], max=C - 1).long()]
    freed_root = _scatter_bool(
        torch.zeros(N1, dtype=torch.bool, device=dev), victim_roots,
        victims[:-1], "amax")
    wl_root = t.cq_root[torch.clamp(t.wl_cqid, max=C - 1).long()]
    parked = parked & ~freed_root[wl_root.long()]
    class_nofit = class_nofit & ~freed_root[t.class_root.long()]

    usage_next = refresh_cohort_usage(t, out["cq_rows"])
    progress = (any_adm | any_evict | (parked & ~parked_before).any()
                | (cursor != cursor_before).any())
    new_state = {
        "usage": usage_next, "cq_rows": out["cq_rows"],
        "admitted": admitted, "parked": parked, "ts": ts,
        "evicted": evicted_f, "admit_rank": admit_rank,
        "wl_usage": wl_usage, "cursor": cursor, "opt": opt,
        "admit_round": admit_round, "class_nofit": class_nofit,
        "victim_reason": out["victim_reason"],
        "lq_penalty": out["lq_penalty"], "progress": progress,
        "rounds": rounds + 1,
    }
    debug = {
        "cand_w": cand_w, "mode": mode, "req_c": req_c,
        "victims": victims, "adm_entry": adm_entry,
        "lane_w": lane_w, "lane_success": lane_success,
        "lane_cand_w": lane_cand_w, "lane_victims": lane_victims,
    }
    return new_state, debug


def _init_state(t: FullTensors, g_max: int):
    W1 = t.wl_cqid.shape[0]
    dev = t.wl_cqid.device
    return {
        "usage": t.usage0,
        "cq_rows": torch.where(t.is_cq[:, None], t.usage0, 0),
        "admitted": t.wl_admitted0,
        "parked": t.wl_parked0,
        "ts": t.wl_ts0,
        "evicted": t.wl_evicted0,
        "admit_rank": t.wl_admit_rank0,
        "wl_usage": t.ad_usage,
        "cursor": torch.zeros((W1, g_max), dtype=INT32, device=dev),
        "opt": torch.zeros((W1, g_max), dtype=INT32, device=dev),
        "admit_round": torch.full((W1,), -1, dtype=INT32, device=dev),
        "victim_reason": torch.zeros(W1, dtype=torch.int8, device=dev),
        "lq_penalty": t.lq_penalty0,
        "class_nofit": torch.zeros(t.class_root.shape[0], dtype=torch.bool,
                                   device=dev),
        "progress": torch.ones((), dtype=torch.bool, device=dev),
        "rounds": 0,
    }


def debug_drain(problem: SolverProblem, g_max: int, h_max: int = 8,
                p_max: int = 32, max_rounds: int = 64, verbose: bool = True,
                fs_enabled: bool = False, device="cuda"):
    """Python-loop drain printing per-round events (development aid):
    each round's heads with their mode and summed request, admissions
    and evictions, by workload key; stops on the first round without
    progress or after ``max_rounds``. Returns the final state. The
    rounds are ``round_body``'s, as in ``solve_backlog_full``, on
    ``device`` ("cuda" unless the caller asks for the CPU)."""
    from kueue_oss_tpu_torch.device import resolve_device

    t = to_device_full(problem, resolve_device(device))
    pot = potential_available_all(t)
    if fs_enabled:
        from kueue_oss_tpu_torch.solver.fair_kernels import (
            lendable_by_resource,
        )

        lendable_r = lendable_by_resource(t, pot)
    else:
        lendable_r = None
    afs = (problem.cq_afs is not None
           and bool(np.asarray(problem.cq_afs).any()))
    stats = FullDrainStats()
    state = _init_state(t, g_max)
    W_null = t.wl_cqid.shape[0] - 1

    def name(w):
        w = int(w)
        return problem.wl_keys[w] if w < W_null else "-"

    for r in range(max_rounds):
        state, dbg = round_body(t, state, pot, g_max, h_max, p_max, stats,
                                fs_enabled, lendable_r, afs)
        if verbose:
            cand_w = dbg["cand_w"].cpu().numpy()
            heads = [(name(w), int(m), int(b))
                     for w, m, b in zip(cand_w, dbg["mode"].cpu().numpy(),
                                        dbg["req_c"].sum(1).cpu().numpy())
                     if int(w) != W_null]
            evs = [name(i) for i, v in
                   enumerate(dbg["victims"].cpu().numpy()[:-1]) if v]
            adms = [name(w) for w, a in zip(cand_w,
                                            dbg["adm_entry"].cpu().numpy())
                    if a and int(w) != W_null]
            print(f"round {r}: heads(mode,req)={heads} "
                  f"admitted={adms} evicted={evs}")
        if not bool(state["progress"]):
            break
    return state


def solve_backlog_full(t: FullTensors, g_max: int, h_max: int = 32,
                       p_max: int = 128, round_cap: int = 0,
                       stats: Optional[FullDrainStats] = None,
                       fs_enabled: bool = False, afs: bool = False):
    """Drain the backlog with preemption until quiescent (or
    ``round_cap`` rounds, when set; the bound is 2 W1 + C + 5), under
    fair sharing when ``fs_enabled``. ``afs`` says whether any
    ClusterQueue uses admission fair sharing (``cq_afs.any()``, known
    to the host at export).

    Returns (admitted [W+1] bool, opt [W+1, G] int32, admit_round [W+1]
    int32, parked [W+1] bool, rounds 0-d int32, usage [N+1, F], wl_usage
    [W+1, F], victim_reason [W+1] int8) on the problem's device.
    ``stats`` (when given) accumulates the lanes, loop iterations and
    host reads of the drain."""
    if stats is None:
        stats = FullDrainStats()
    W1 = t.wl_cqid.shape[0]
    C = t.cq_node.shape[0]
    pot = potential_available_all(t)
    lendable_r = None
    if fs_enabled:
        from kueue_oss_tpu_torch.solver.fair_kernels import (
            lendable_by_resource,
        )

        lendable_r = lendable_by_resource(t, pot)
    bound = 2 * W1 + C + 5
    if round_cap:
        bound = min(bound, round_cap)
    state = _init_state(t, g_max)
    progress = True
    while progress and state["rounds"] < bound:
        state, _ = round_body(t, state, pot, g_max, h_max, p_max, stats,
                              fs_enabled, lendable_r, afs)
        progress = stats.read(state["progress"])
    stats.rounds += state["rounds"]
    return (_with_last(state["admitted"], False), state["opt"],
            state["admit_round"], _with_last(state["parked"], False),
            torch.tensor(state["rounds"], dtype=INT32,
                         device=t.wl_cqid.device),
            state["usage"], state["wl_usage"], state["victim_reason"])


# ---------------------------------------------------------------------------
# Scenario-batched drain (the FULL what-if sweep, sim/batch.py)
# ---------------------------------------------------------------------------

#: FullTensors fields on the [W+1] workload axis: the rows a resident
#: sweep patches when workloads churn (sim/resident.py)
FULL_WL_FIELDS = ("wl_cqid", "wl_prio", "wl_ts0", "wl_uid", "wl_req",
                  "wl_valid", "wl_parked0", "wl_admitted0",
                  "wl_evicted0", "wl_admit_rank0", "ad_usage",
                  "wl_class", "wl_lq", "wl_ts_buf", "wl_afs_penalty")

#: FullTensors fields the scenario overlay layer varies: the FULL twins
#: of kernels.BATCHABLE_FIELDS (the lean ``wl_ts`` is ``wl_ts0`` here;
#: the lean ``wl_rank`` has no FULL twin: heads go by (priority, ts,
#: uid) and masked rows leave the per-CQ segments through ``wl_cqid =
#: C``)
FULL_BATCHABLE_FIELDS = frozenset({
    "nominal", "subtree", "local_quota", "has_borrow", "borrow_limit",
    "usage0", "wl_cqid", "wl_prio", "wl_ts0", "wl_valid", "wl_req",
})

#: Every FullTensors field: no host step depends on an array's content,
#: so any field may carry the scenario axis; FULL_BATCHABLE_FIELDS is the
#: documented overlay subset
ALL_FULL_FIELDS = frozenset(FullTensors._fields)

# The batched helpers below are the round's functions with a leading
# scenario axis S on every tensor. Per-lane work (the victim searches,
# the flavor walk, the entry scan's path walks) runs the single-problem
# functions on ``_lane_view``s; scatters address flat ``s * rows + row``
# indices (or a scenario index beside the row index), so no scenario's
# write reaches another's rows.


def _scatter_rows(x: torch.Tensor, idx: torch.Tensor,
                  vals: torch.Tensor) -> torch.Tensor:
    """``x.at[s, idx[s]].set(vals[s], mode="drop")`` for every scenario
    s, where each dropped write addresses ``x.shape[1]``: a sink column
    that is sliced away. Kept indices must be distinct per scenario."""
    s = torch.arange(x.shape[0], device=x.device)[:, None].expand_as(idx)
    return torch.cat([x, x[:, :1]], dim=1).index_put(
        (s, idx.long()), vals)[:, :-1]


def _scatter_bool_rows(x: torch.Tensor, idx: torch.Tensor,
                       vals: torch.Tensor, reduce: str) -> torch.Tensor:
    """``_scatter_bool`` per scenario: x [S, R], idx and vals [S, ...]
    (repeated indices within a scenario reduce exactly)."""
    S, R = x.shape
    base = torch.arange(S, device=x.device).reshape(
        (S,) + (1,) * (idx.dim() - 1)) * R
    flat = (base + idx.long()).reshape(-1)
    return _scatter_bool(x.reshape(-1), flat, vals.reshape(-1),
                         reduce).view(S, R)


def _with_last_rows(x: torch.Tensor, value) -> torch.Tensor:
    """``x[:, -1] = value`` out of place (the per-scenario null row)."""
    return torch.cat([x[:, :-1], torch.full_like(x[:, -1:], value)], dim=1)


def _select_heads_full_b(t: FullTensors, admitted, parked, ts,
                         lq_penalty=None):
    """``select_heads_full`` per scenario; [S, C] int32."""
    C = t.cq_node.shape[1]
    W1 = t.wl_cqid.shape[1]
    W_null = W1 - 1
    pending = (~admitted & ~parked)[:, :-1]
    seg = t.wl_cqid[:, :-1]
    segl = seg.long()
    if lq_penalty is not None:
        is_afs = _rows(t.cq_afs, torch.clamp(seg, max=C - 1))
        pen = _rows(lq_penalty, t.wl_lq[:, :-1])
        min_pen = segment_min_rows(torch.where(pending & is_afs, pen,
                                               float("inf")), seg, C + 1)
        pending = pending & (~is_afs | (pen == min_pen.gather(1, segl)))
    prio = t.wl_prio[:, :-1]
    max_prio = segment_max_rows(torch.where(pending, prio, -BIG), seg,
                                C + 1)
    c1 = pending & (prio == max_prio.gather(1, segl))
    min_ts = segment_min_rows(torch.where(c1, ts[:, :-1], BIG), seg, C + 1)
    c2 = c1 & (ts[:, :-1] == min_ts.gather(1, segl))
    uid = t.wl_uid[:, :-1]
    min_uid = segment_min_rows(torch.where(c2, uid, BIG), seg, C + 1)
    c3 = c2 & (uid == min_uid.gather(1, segl))
    w_idx = arange(W1 - 1, ts.device)[None, :]
    head_w = segment_min_rows(torch.where(c3, w_idx, W_null), seg,
                              C + 1)[:, :C]
    has_head = max_prio[:, :C] > -BIG
    return _i32(torch.where(has_head, head_w, W_null))


def _take(x: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    """``x[s, c, k[s, c]]`` for x [S, C, K, ...] and k [S, C]."""
    idx = k.long().reshape(k.shape + (1,) * (x.dim() - 2))
    idx = idx.expand(k.shape + (1,) + tuple(x.shape[3:]))
    return torch.gather(x, 2, idx).squeeze(2)


def _nominate_full_b(t: FullTensors, usage, avail, pot, cand_w, cursor,
                     g_max: int):
    """``nominate_full`` per scenario (fair sharing off): every [C, ...]
    result gains the leading scenario axis."""
    S, C = cand_w.shape
    K = t.cq_opt_group.shape[2]
    dev = usage.device
    req = _rows(t.wl_req, cand_w)                        # [S,C,K,F]
    grp = t.cq_opt_group
    pos = t.cq_opt_pos
    cursor_k = torch.gather(_rows(cursor, cand_w), 2,
                            grp.clamp(min=0).long())
    valid = _rows(t.wl_valid, cand_w) & (grp >= 0) & (pos >= cursor_k)

    avail_cq = _rows(avail, t.cq_node)[:, :, None, :]
    pot_cq = _rows(pot, t.cq_node)[:, :, None, :]
    nominal_cq = _rows(t.nominal, t.cq_node)[:, :, None, :]
    level, may_reclaim = _borrow_levels_b(t, usage, cand_w, req)

    nonzero = req > 0
    fit_fr = (~nonzero) | (req <= avail_cq)
    within_cap = (~nonzero) | (req <= pot_cq)
    can_pwb = (~t.cq_bwc_forbidden)[:, :, None, None]
    preemptish_fr = (~nonzero) | (
        within_cap & ((req <= nominal_cq) | may_reclaim | can_pwb))
    opt_fit = valid & fit_fr.all(dim=-1)                 # [S,C,K]
    opt_preempt = valid & (fit_fr | preemptish_fr).all(dim=-1)
    opt_level = torch.where(nonzero, level, 0).amax(dim=-1)

    k_idx = arange(K, dev)[None, None, :]

    def first_true(mask):
        return torch.where(mask, k_idx, K).amin(dim=-1)

    mode = torch.full((S, C), M_FIT, dtype=INT32, device=dev)
    req_total = torch.zeros((S, C, req.shape[3]), dtype=INT32, device=dev)
    borrow = torch.zeros((S, C), dtype=INT32, device=dev)
    active_cols, k_cols, cursor_cols = [], [], []
    any_nonzero = nonzero.any(dim=-1)
    for g in range(g_max):
        in_g = grp == g
        has_g = in_g.any(dim=-1)
        active = (in_g & any_nonzero).any(dim=-1)
        fit_g = opt_fit & in_g
        pre_g = opt_preempt & in_g & ~opt_fit
        k_default = first_true(fit_g)
        k_nonborrow = first_true(fit_g & (opt_level == 0))
        lvl_key = torch.where(fit_g, opt_level * K + k_idx, BIG)
        k_bestlvl = _i32(torch.argmin(lvl_key, dim=-1))
        k_try_next = torch.where(
            k_nonborrow < K, k_nonborrow,
            torch.where(fit_g.any(dim=-1), k_bestlvl, K))
        k_fit = torch.where(t.cq_try_next, k_try_next, k_default)
        any_fit = k_fit < K
        k_preempt = first_true(pre_g)
        any_preempt = k_preempt < K
        k_g = torch.where(any_fit, k_fit,
                          torch.where(any_preempt, k_preempt,
                                      first_true(in_g)))
        k_g = torch.clamp(k_g, max=K - 1)
        mode_g = _i32(torch.where(any_fit, M_FIT, torch.where(
            any_preempt, M_PREEMPT, M_NOFIT)))
        mode_g = torch.where(active & has_g, mode_g, M_FIT)
        mode = torch.minimum(mode, mode_g)
        k_cols.append(torch.where(active, k_g, 0))
        req_total = req_total + torch.where(active[..., None],
                                            _take(req, k_g), 0)
        borrow = torch.maximum(
            borrow, torch.where(active, _take(opt_level, k_g), 0))
        early_break = torch.where(t.cq_try_next, k_nonborrow < K, any_fit)
        pos_g = _take(pos, k_g)
        n_in_g = in_g.sum(dim=-1, dtype=INT32)
        nc = torch.where(early_break & (pos_g < n_in_g - 1), pos_g + 1, 0)
        cursor_cols.append(torch.where(active, nc, 0))
        active_cols.append(active)
    k_chosen = _i32(torch.stack(k_cols, dim=-1))
    next_cursor = _i32(torch.stack(cursor_cols, dim=-1))
    group_active = torch.stack(active_cols, dim=-1)
    return (mode, k_chosen, req_total, borrow, next_cursor,
            opt_fit, opt_preempt, opt_level, group_active, valid)


def _build_candidate_table_b(t: FullTensors, admitted, admit_rank,
                             wl_usage, a_max: int):
    """``build_candidate_table`` per scenario: [S, N+1, A] int32."""
    S, W1 = admitted.shape
    W = W1 - 1
    W_null = W
    N1 = t.parent.shape[1]
    C = t.cq_node.shape[1]
    dev = admitted.device
    root_of = _rows(t.cq_root, torch.clamp(t.wl_cqid[:, :-1], max=C - 1))
    elig = admitted[:, :-1] & (wl_usage[:, :-1] > 0).any(dim=-1)
    order = lexsort((t.wl_uid[:, :-1], -admit_rank[:, :-1],
                     t.wl_prio[:, :-1])).long()
    rank = torch.zeros((S, W), dtype=INT32, device=dev).scatter(
        1, order, arange(W, dev)[None, :].expand(S, W))
    root_eff = torch.where(elig, root_of, N1)
    sorted_w = lexsort((rank, root_eff)).long()
    elig_s = elig.gather(1, sorted_w)
    root_s = root_of.gather(1, sorted_w)
    counts = segment_sum_rows(_i32(elig), root_of, N1)
    offsets = torch.cumsum(counts, dim=1, dtype=INT32) - counts
    pos = arange(W, dev)[None, :] - offsets.gather(1, root_s.long())
    keep = elig_s & (pos < a_max)
    row = torch.where(keep, root_s, N1).long()
    col = torch.where(keep, pos, a_max).long()
    cell = row * (a_max + 1) + col
    table = torch.full((S, (N1 + 1) * (a_max + 1)), W_null, dtype=INT32,
                       device=dev).scatter(1, cell, _i32(sorted_w))
    return table.view(S, N1 + 1, a_max + 1)[:, :N1, :a_max]


def _remove_path_flat(usage, path, valid, lq, val):
    """removeUsage with bubbling along each scenario's path: ``usage``
    [S*(N+1), F] flat, ``path`` [S, D] flat rows, ``lq`` the path's local
    quotas [S, D, F], ``val`` [S, F] (``_remove_path`` on flat rows)."""
    for d in range(path.shape[1]):
        node = path[:, d]
        stored = usage[node] - lq[:, d]
        usage = usage.index_add(0, node,
                                torch.where(valid[:, d:d + 1], -val, 0))
        val = torch.where(stored > 0, torch.minimum(val, stored), 0)
    return usage


def _full_round_scan_b(t: FullTensors, state, cand_w, mode, k_chosen,
                       req_c, borrow, lane_of_entry, lane_success,
                       lane_cand_w, lane_victims, lane_reason,
                       stats: FullDrainStats, afs: bool):
    """``full_round_scan`` (classical order) for every scenario at once:
    step i processes the i-th entry of each scenario's own entry order.

    As in ``kernels._round_scan_b``, what the scan does not change (each
    slot's request and CQ, the quotas along its path, every lane's
    victims' paths and quotas) is gathered once before the loop, and the
    usage is addressed through flat ``s * (N+1) + node`` rows. One read
    per call brings each slot's lane, the lanes' success flags and their
    last victim slots to the host; a step runs its reserve block when
    some scenario's entry was searched and found no targets, its
    preemption block when some scenario's entry has targets, and its
    sequential victim removals to the largest last slot among the
    scenarios, each removal masked to the scenarios it belongs to (a
    masked removal is a no-op, as under the JAX ``vmap``)."""
    S, C = cand_w.shape
    W1 = t.wl_cqid.shape[1]
    W_null = W1 - 1
    N1, F = state["usage_full"].shape[1:]
    H, P = lane_victims.shape[1:]
    null = N1 - 1
    dev = cand_w.device
    sidx = torch.arange(S, device=dev)
    s2 = sidx[:, None]
    s3 = s2[:, :, None]
    active = (cand_w != W_null) & (mode != M_NOFIT)
    cw = cand_w.long()
    sort_borrow = torch.where(active, borrow, BIG)
    order = lexsort((_rows(t.wl_uid, cw), _rows(state["ts"], cw),
                     -_rows(t.wl_prio, cw), sort_borrow)).long()   # [S,C]
    slot_lane = lane_of_entry.gather(1, order).long()
    n_slots = torch.where(lane_victims, arange(P, dev) + 1, 0).amax(dim=-1)
    host = stats.read(torch.cat([slot_lane.reshape(-1),
                                 _i32(lane_success).reshape(-1),
                                 _i32(n_slots).reshape(-1)]))
    lane_at = [host[s * C:(s + 1) * C] for s in range(S)]
    lane_ok = [host[S * C + s * H:S * C + (s + 1) * H] for s in range(S)]
    lane_slots = [host[S * (C + H) + s * H:S * (C + H) + (s + 1) * H]
                  for s in range(S)]

    # per slot: the entry, its CQ and the quotas along its path
    slot_w = cw.gather(1, order)
    slot_m = mode.gather(1, order)
    slot_node = t.cq_node.gather(1, order).long()
    slot_path = _rows(t.path, slot_node).long()                # [S,C,D]
    lq = t.local_quota[s3, slot_path]                          # [S,C,D,F]
    sub = t.subtree[s3, slot_path]
    is_active = (slot_w != W_null) & (slot_m != M_NOFIT)
    has_targets = (slot_lane >= 0) & lane_success.gather(
        1, slot_lane.clamp(min=0))

    def front(x):  # [S,C,...] -> [C,S,...]: step i reads one block
        return x.transpose(0, 1).contiguous()

    steps = [front(x) for x in (
        slot_w, slot_m, req_c.gather(1, order[..., None].expand(S, C, F)),
        borrow.gather(1, order) > 0, slot_lane.clamp(min=0),
        is_active & (slot_m == M_PREEMPT) & (slot_lane >= 0) & ~has_targets,
        is_active & (slot_m == M_PREEMPT) & has_targets,
        is_active & (slot_m == M_FIT), t.cq_strict.gather(1, order),
        t.nominal[s2, slot_node], t.has_borrow[s2, slot_node],
        t.borrow_limit[s2, slot_node], s3 * N1 + slot_path,
        slot_path != null, lq, sub, sub - lq,
        t.has_borrow[s3, slot_path], t.borrow_limit[s3, slot_path],
        s2 * N1 + slot_node, t.cq_afs.gather(1, order),
        _rows(t.wl_lq, slot_w).long(), _rows(t.wl_afs_penalty, slot_w))]
    # per lane: its victims' CQ rows and the quotas along their paths
    v_node = _rows(t.cq_node, torch.clamp(_rows(t.wl_cqid, lane_cand_w),
                                          max=C - 1)).long()  # [S,H,P]
    v_path = _rows(t.path, v_node).long()                     # [S,H,P,D]
    v_lq = t.local_quota[sidx[:, None, None, None], v_path]
    v_fpath = sidx[:, None, None, None] * N1 + v_path
    v_valid = v_path != null
    v_row = s3 * N1 + v_node

    u_full = state["usage_full"].reshape(S * N1, F)
    u_net = state["usage_net"].reshape(S * N1, F)
    cq_rows = state["cq_rows"].reshape(S * N1, F)
    admitted, parked = state["admitted"], state["parked"]
    wl_usage, victim_reason = state["wl_usage"], state["victim_reason"]
    victims_all = torch.zeros((S, W1), dtype=torch.bool, device=dev)
    lq_pen = state["lq_penalty"]
    any_adm = torch.zeros(S, dtype=torch.bool, device=dev)
    any_evict = torch.zeros(S, dtype=torch.bool, device=dev)
    adm_flags, pre_flags = [], []
    for i in range(C):
        (w, m, req, borrows, lc, reserves, preempts, fits, strict, nom,
         hb_cq, bl_cq, path, valid, lq_i, sub_i, stored_i, hb, bl, row,
         afs_cq, lq_row, afs_pen) = (x[i] for x in steps)
        lanes_i = [lane_at[s][i] for s in range(S)]
        oks = [ln >= 0 and bool(lane_ok[s][ln])
               for s, ln in enumerate(lanes_i)]

        if any(ln >= 0 and not ok for ln, ok in zip(lanes_i, oks)):
            # Preempt / NoCandidates: reserve entitled capacity and park
            # (scheduler.go quotaResourcesToReserve)
            usage_cq = u_full[row]
            reserve = torch.clamp(torch.where(
                borrows[:, None],
                torch.where(hb_cq, torch.minimum(req, nom + bl_cq - usage_cq),
                            req),
                torch.minimum(req, nom - usage_cq)), min=0)
            reserve = torch.where(reserves[:, None], reserve, 0)
            u_full = _add_usage_along_path_flat(u_full, path, valid, lq_i,
                                                reserve)
            u_net = _add_usage_along_path_flat(u_net, path, valid, lq_i,
                                               reserve)
            parked = parked.index_put(
                (sidx, w), parked[sidx, w] | (reserves & ~strict))

        do_preempt = torch.zeros(S, dtype=torch.bool, device=dev)
        if any(oks):
            # overlap check (one conflicting preemption per cycle)
            vm = lane_victims[sidx, lc]                         # [S,P]
            vw = lane_cand_w[sidx, lc].long()                   # [S,P]
            overlap = (vm & victims_all[s2, vw]).any(dim=-1)
            is_preempt = preempts & ~overlap
            v_usage = wl_usage[s2, vw]                          # [S,P,F]
            vp, vv, vq = v_fpath[sidx, lc], v_valid[sidx, lc], v_lq[sidx, lc]
            usage_probe = u_net
            for k in range(max(lane_slots[s][ln] for s, ln in
                               enumerate(lanes_i) if oks[s])):
                stats.removal_steps += 1
                usage_probe = _remove_path_flat(
                    usage_probe, vp[:, k], vv[:, k], vq[:, k],
                    torch.where((vm[:, k] & is_preempt)[:, None],
                                v_usage[:, k], 0))
            avail_now = _avail_along_path_flat(usage_probe, path, valid,
                                               lq_i, sub_i, stored_i, hb, bl)
            still_fits = ((req == 0) | (req <= avail_now)).all(dim=-1)
            do_preempt = is_preempt & still_fits
            u_net = torch.where(do_preempt.repeat_interleave(N1)[:, None],
                                usage_probe, u_net)
            evict_now = do_preempt[:, None] & vm                # [S,P]
            victims_all = _with_last_rows(_scatter_bool_rows(
                victims_all, vw, evict_now, "amax"), False)
            victim_reason = _with_last_rows(_scatter_bool_rows(
                victim_reason, vw,
                torch.where(evict_now, lane_reason[sidx, lc], 0), "amax"), 0)
            admitted = _scatter_bool_rows(admitted, vw, ~evict_now, "amin")
            cq_rows = cq_rows.index_add(
                0, v_row[sidx, lc].reshape(-1), -torch.where(
                    evict_now[..., None], v_usage, 0).reshape(S * P, F))
            entry_usage = torch.where(do_preempt[:, None], req, 0)
            u_full = _add_usage_along_path_flat(u_full, path, valid, lq_i,
                                                entry_usage)
            u_net = _add_usage_along_path_flat(u_net, path, valid, lq_i,
                                               entry_usage)
            any_evict = any_evict | do_preempt

        # Fit: re-check under the current usage, then admit
        avail_fit = _avail_along_path_flat(u_net, path, valid, lq_i, sub_i,
                                           stored_i, hb, bl)
        do_admit = fits & ((req == 0) | (req <= avail_fit)).all(dim=-1)
        admit_vec = torch.where(do_admit[:, None], req, 0)
        u_full = _add_usage_along_path_flat(u_full, path, valid, lq_i,
                                            admit_vec)
        u_net = _add_usage_along_path_flat(u_net, path, valid, lq_i,
                                           admit_vec)
        cq_rows = cq_rows.index_add(0, row, admit_vec)
        admitted = admitted.index_put((sidx, w), admitted[sidx, w] | do_admit)
        wl_usage = wl_usage.index_put(
            (sidx, w), torch.where(do_admit[:, None], req, wl_usage[sidx, w]))
        if afs:
            # AFS entry penalty: one LocalQueue row per scenario a step
            lq_pen = lq_pen.index_put(
                (sidx, lq_row), torch.where(do_admit & afs_cq, afs_pen, 0.0),
                accumulate=True)
        any_adm = any_adm | do_admit
        adm_flags.append(do_admit)
        pre_flags.append(do_preempt)

    zeros = torch.zeros((S, C), dtype=torch.bool, device=dev)
    adm_entry = zeros.scatter(1, order, torch.stack(adm_flags, dim=1))
    pre_entry = zeros.scatter(1, order, torch.stack(pre_flags, dim=1))
    return {
        "usage_full": u_full.view(S, N1, F), "usage_net": u_net.view(S, N1, F),
        "cq_rows": cq_rows.view(S, N1, F), "admitted": admitted,
        "parked": parked, "wl_usage": wl_usage, "victims_all": victims_all,
        "victim_reason": victim_reason, "lq_penalty": lq_pen,
    }, adm_entry, pre_entry, any_adm, any_evict


def _round_body_b(t: FullTensors, state, pot, g_max: int, h_max: int,
                  p_max: int, stats: FullDrainStats, afs: bool):
    """``round_body`` for every scenario at once; returns the new state
    (frozen lanes are the caller's business)."""
    S, W1 = t.wl_cqid.shape
    C = t.cq_node.shape[1]
    N1 = t.parent.shape[1]
    W_null = W1 - 1
    K = t.cq_opt_group.shape[2]
    F = t.subtree.shape[2]
    dev = t.wl_cqid.device
    sidx = torch.arange(S, device=dev)
    s2 = sidx[:, None]

    rounds = state["rounds"]
    admitted = state["admitted"]
    ts = state["ts"]
    usage = state["usage"]
    wl_usage = state["wl_usage"]
    class_nofit = state["class_nofit"]
    parked = _with_last_rows(
        state["parked"] | (~admitted & _rows(class_nofit, t.wl_class)),
        False)
    parked_before = parked
    cursor_before = state["cursor"]

    cand_w = _select_heads_full_b(
        t, admitted, parked, ts,
        lq_penalty=state["lq_penalty"] if afs else None)
    cw = cand_w.long()
    avail = _available_all_b(t, usage)
    (mode, k_chosen, req_c, borrow, next_cursor, opt_fit, opt_preempt,
     opt_level, group_active, opt_valid) = _nominate_full_b(
        t, usage, avail, pot, cand_w, state["cursor"], g_max)
    is_head = cand_w != W_null

    any_preemptish = (opt_preempt & ~opt_fit).any(dim=-1)
    fit_wins = (mode == M_FIT) & t.cq_preempt_try_next & ~t.cq_pref_pob
    needs_search = (is_head & any_preemptish & ~fit_wins
                    & (mode != M_NOFIT))

    # ---- each scenario's searching heads in h_max lanes (entry order) --
    ekey = lexsort((_rows(t.wl_uid, cw), _rows(ts, cw), -_rows(t.wl_prio, cw),
                    torch.where(needs_search, borrow, BIG),
                    _i32(~needs_search))).long()
    pe_sorted = needs_search.gather(1, ekey)
    pos = torch.cumsum(_i32(pe_sorted), dim=1, dtype=INT32) - 1
    lane_cq = _scatter_rows(
        torch.full((S, h_max), C, dtype=INT32, device=dev),
        torch.where(pe_sorted & (pos < h_max), pos, h_max), _i32(ekey))
    lane_valid = lane_cq < C
    lane_cqc = torch.clamp(lane_cq, max=C - 1).long()
    lane_w = torch.where(lane_valid, cand_w.gather(1, lane_cqc), W_null)
    lane_avail = _rows(avail, t.cq_node.gather(1, lane_cqc))   # [S,H,F]
    lane_of_entry = _scatter_rows(
        torch.full((S, C), -1, dtype=INT32, device=dev),
        torch.where(lane_valid, lane_cq, C),
        arange(h_max, dev)[None, :].expand(S, h_max))

    # ---- per-option victim searches over [S * H * K] lanes ------------
    cand_table = _build_candidate_table_b(t, admitted, state["admit_rank"],
                                          wl_usage, p_max)
    lane_cands = cand_table[s2, _rows(t.cq_root, lane_cqc).long()]
    L = S * h_max * K
    ls_k = sidx.repeat_interleave(h_max * K)
    view = (_lane_view(t, ls_k), _PerLane(usage, ls_k),
            _PerLane(wl_usage, ls_k), _PerLane(admitted, ls_k),
            _PerLane(state["evicted"], ls_k), _PerLane(ts, ls_k))
    (s_succ, s_cand_w, s_victims, s_reason, s_same, s_borrow) = (
        _run_searches(*view, lane_w.repeat_interleave(K, dim=1).reshape(L),
                      _rows(t.wl_req, lane_w).reshape(L, F),
                      lane_avail.repeat_interleave(K, dim=1).reshape(L, F),
                      lane_cands.repeat_interleave(K, dim=1).reshape(
                          L, p_max), p_max, stats))

    sim_pmode = _i32(torch.where(
        s_succ, torch.where(s_same, P_PREEMPT, P_RECLAIM),
        P_NO_CANDIDATES)).reshape(S, h_max, K)
    sim_borrow = s_borrow.reshape(S, h_max, K)
    fit_l = _rows(opt_fit, lane_cqc)
    pre_l = _rows(opt_preempt & ~opt_fit, lane_cqc)
    pmode_k = torch.where(fit_l, P_FIT,
                          torch.where(pre_l, sim_pmode, P_NOFIT))
    borrow_k = torch.where(fit_l, _rows(opt_level, lane_cqc),
                           torch.where(pre_l, sim_borrow, 0))

    # ---- the assigner's walk over [S * H] lanes -----------------------
    ls_h = sidx.repeat_interleave(h_max)
    SH = S * h_max
    (l_mode, l_k, l_req, l_borrow, l_next_cursor, _l_pmode_sel) = (
        walk_assign(_lane_view(t, ls_h), lane_w.reshape(SH),
                    pmode_k.reshape(SH, K), borrow_k.reshape(SH, K),
                    _rows(opt_valid, lane_cqc).reshape(SH, K),
                    _rows(group_active, lane_cqc).reshape(SH, g_max),
                    g_max))
    l_mode = l_mode.view(S, h_max)
    l_k = l_k.view(S, h_max, g_max)
    l_req = torch.where(lane_valid[..., None], l_req.view(S, h_max, F), 0)
    lane_target = torch.where(lane_valid, lane_cq, C)
    mode = _scatter_rows(mode, lane_target, l_mode)
    k_chosen = _scatter_rows(k_chosen, lane_target, l_k)
    req_c = _scatter_rows(req_c, lane_target, l_req)
    borrow = _scatter_rows(borrow, lane_target, l_borrow.view(S, h_max))
    next_cursor = _scatter_rows(next_cursor, lane_target,
                                l_next_cursor.view(S, h_max, g_max))

    # ---- final victim set of each preempting lane ---------------------
    if g_max == 1:
        idx = (sidx[:, None] * (h_max * K) + arange(h_max, dev)[None, :] * K
               + l_k[..., 0]).reshape(SH).long()
        lane_success = s_succ[idx]
        lane_cand_w = s_cand_w[idx]
        lane_victims = s_victims[idx]
        lane_reason = s_reason[idx]
    else:
        view_h = (_lane_view(t, ls_h), _PerLane(usage, ls_h),
                  _PerLane(wl_usage, ls_h), _PerLane(admitted, ls_h),
                  _PerLane(state["evicted"], ls_h), _PerLane(ts, ls_h))
        (lane_success, lane_cand_w, lane_victims, lane_reason, _s,
         _b) = _run_searches(*view_h, lane_w.reshape(SH),
                             l_req.reshape(SH, F),
                             lane_avail.reshape(SH, F),
                             lane_cands.reshape(SH, p_max), p_max, stats)
    lane_success = (lane_success.view(S, h_max) & lane_valid
                    & (l_mode == M_PREEMPT))
    key = torch.where(lane_victims, arange(p_max, dev), p_max)
    perm = torch.argsort(key, dim=-1, stable=True)
    lane_cand_w = torch.gather(lane_cand_w, 1, perm).view(S, h_max, p_max)
    lane_victims = torch.gather(lane_victims, 1, perm).view(S, h_max, p_max)
    lane_reason = torch.gather(lane_reason, 1, perm).view(S, h_max, p_max)

    park_now = is_head & (mode == M_NOFIT) & ~t.cq_strict
    parked = parked.index_put((s2, cw), parked[s2, cw] | park_now)

    # ---- entry scan ---------------------------------------------------
    scan_state = {
        "usage_full": usage, "usage_net": usage,
        "cq_rows": state["cq_rows"], "admitted": admitted,
        "parked": parked, "wl_usage": wl_usage,
        "victim_reason": state["victim_reason"], "ts": ts,
        "lq_penalty": state["lq_penalty"],
    }
    out, adm_entry, pre_entry, any_adm, any_evict = _full_round_scan_b(
        t, scan_state, cand_w, mode, k_chosen, req_c, borrow,
        lane_of_entry, lane_success, lane_cand_w, lane_victims,
        lane_reason, stats, afs)
    admitted = out["admitted"]
    parked = out["parked"]
    wl_usage = out["wl_usage"]
    victims = out["victims_all"]

    # ---- bookkeeping, each scenario stamping its own round ------------
    r_col = rounds[:, None]
    ts = torch.where(victims, t.ts_evict_base[:, None] + r_col, ts)
    evicted_f = state["evicted"] | victims
    admit_rank = torch.where(victims, 0, state["admit_rank"])
    newly = adm_entry & is_head
    adm_w = torch.where(newly, cand_w, W_null).long()
    ts = ts.index_put((s2, adm_w), torch.where(
        newly, t.wl_ts0[s2, adm_w], ts[s2, adm_w]))
    evicted_f = evicted_f.index_put(
        (s2, adm_w), torch.where(newly, False, evicted_f[s2, adm_w]))
    admit_rank = admit_rank.index_put(
        (s2, adm_w), torch.where(newly, t.admit_rank_base[:, None] + r_col,
                                 admit_rank[s2, adm_w]))
    evicted_f = _with_last_rows(evicted_f, False)
    opt = state["opt"].index_put((s2, adm_w), torch.where(
        newly[..., None], k_chosen, state["opt"][s2, adm_w]))
    admit_round = state["admit_round"].index_put(
        (s2, adm_w), torch.where(newly, r_col,
                                 state["admit_round"][s2, adm_w]))
    keep = is_head & ~admitted[s2, cw]
    new_cur = torch.where(pre_entry[..., None], 0, next_cursor)
    cursor = state["cursor"].index_put((s2, cw), torch.where(
        keep[..., None], new_cur, state["cursor"][s2, cw]))
    cursor = torch.where(victims[..., None], 0, cursor)

    # ---- NoFit equivalence classes ------------------------------------
    newly_parked = parked & ~parked_before
    n_cls = class_nofit.shape[1]
    class_nofit = _with_last_rows(_scatter_bool_rows(
        class_nofit, torch.where(newly_parked, t.wl_class, n_cls - 1),
        newly_parked, "amax"), False)
    parked = _with_last_rows(
        parked | (~admitted & _rows(class_nofit, t.wl_class)), False)

    # ---- capacity-freed flush: unpark cohort roots with evictions -----
    victim_roots = _rows(t.cq_root, torch.clamp(t.wl_cqid[:, :-1],
                                                max=C - 1))
    freed_root = _scatter_bool_rows(
        torch.zeros((S, N1), dtype=torch.bool, device=dev), victim_roots,
        victims[:, :-1], "amax")
    wl_root = _rows(t.cq_root, torch.clamp(t.wl_cqid, max=C - 1))
    parked = parked & ~_rows(freed_root, wl_root)
    class_nofit = class_nofit & ~_rows(freed_root, t.class_root)

    usage_next = _refresh_cohort_usage_b(t, out["cq_rows"])
    progress = (any_adm | any_evict | (parked & ~parked_before).any(dim=1)
                | (cursor != cursor_before).flatten(1).any(dim=1))
    return {
        "usage": usage_next, "cq_rows": out["cq_rows"],
        "admitted": admitted, "parked": parked, "ts": ts,
        "evicted": evicted_f, "admit_rank": admit_rank,
        "wl_usage": wl_usage, "cursor": cursor, "opt": opt,
        "admit_round": admit_round, "class_nofit": class_nofit,
        "victim_reason": out["victim_reason"],
        "lq_penalty": out["lq_penalty"], "progress": progress,
        "rounds": rounds + 1,
    }


def solve_backlog_full_batched(t: FullTensors, overrides: dict,
                               g_max: int, h_max: int = 32,
                               p_max: int = 128, round_cap: int = 0,
                               stats: Optional[FullDrainStats] = None,
                               afs: bool = False):
    """Solve S counterfactual variants of one FULL problem in one batched
    drain: the JAX package's ``jit(vmap(_solve_full_impl))`` with an
    explicit leading scenario axis.

    ``overrides`` maps FullTensors field names to stacked [S, ...]
    variants; unnamed fields are shared (broadcast views, no copy).
    Returns the ``solve_backlog_full`` 8-tuple with a leading scenario
    axis on every output (``rounds`` [S]). Each lane runs exactly its
    own drain: its state, round count and per-round stamps advance only
    while its own ``progress & rounds < bound`` holds, as under the JAX
    ``vmap(while_loop)``; the loop reads one bool per round (whether any
    lane is live). Fair sharing is off (the what-if sweeps never turn it
    on); ``afs`` says whether the base problem has an admission-fair-
    sharing ClusterQueue. The victim-search lanes number S x h_max x K,
    each with its [N+1, F] usage walks and [p_max] candidate columns:
    callers size S from ``sim.batch.LaneBudget``. ``stats`` (when given)
    accumulates lanes, loop iterations and host reads."""
    if not overrides:
        raise ValueError("batched full solve needs at least one "
                         "scenario-varying field (use "
                         "solve_backlog_full otherwise)")
    bad = set(overrides) - ALL_FULL_FIELDS
    if bad:
        raise ValueError(
            f"fields {sorted(bad)} are not FullTensors fields; "
            f"batchable: {sorted(ALL_FULL_FIELDS)}")
    if stats is None:
        stats = FullDrainStats()
    t = _batched_tensors(t, overrides)
    S, W1 = t.wl_cqid.shape
    # the 0-d fields upload as [1]: one value per scenario, [S]
    t = t._replace(**{f: getattr(t, f).reshape(S) for f in _SCALAR_FIELDS})
    C = t.cq_node.shape[1]
    dev = t.wl_cqid.device
    pot = _potential_available_all_b(t)
    bound = 2 * W1 + C + 5
    if round_cap:
        bound = min(bound, round_cap)
    state = {
        "usage": t.usage0.contiguous(),
        "cq_rows": torch.where(t.is_cq[..., None], t.usage0, 0),
        "admitted": t.wl_admitted0.contiguous(),
        "parked": t.wl_parked0.contiguous(),
        "ts": t.wl_ts0.contiguous(),
        "evicted": t.wl_evicted0.contiguous(),
        "admit_rank": t.wl_admit_rank0.contiguous(),
        "wl_usage": t.ad_usage.contiguous(),
        "cursor": torch.zeros((S, W1, g_max), dtype=INT32, device=dev),
        "opt": torch.zeros((S, W1, g_max), dtype=INT32, device=dev),
        "admit_round": torch.full((S, W1), -1, dtype=INT32, device=dev),
        "victim_reason": torch.zeros((S, W1), dtype=torch.int8,
                                     device=dev),
        "lq_penalty": t.lq_penalty0.contiguous(),
        "class_nofit": torch.zeros(t.class_root.shape, dtype=torch.bool,
                                   device=dev),
        "rounds": torch.zeros(S, dtype=INT32, device=dev),
    }
    live = torch.ones(S, dtype=torch.bool, device=dev)
    host_rounds = 0
    while host_rounds < bound:
        new = _round_body_b(t, state, pot, g_max, h_max, p_max, stats, afs)
        host_rounds += 1
        # lanes whose condition failed keep their state (vmap's select)
        for k, v in state.items():
            state[k] = torch.where(
                live.reshape((S,) + (1,) * (v.dim() - 1)), new[k], v)
        live = live & new["progress"] & (state["rounds"] < bound)
        if not stats.read(live.any()):
            break
    stats.rounds += host_rounds
    return (_with_last_rows(state["admitted"], False), state["opt"],
            state["admit_round"], _with_last_rows(state["parked"], False),
            state["rounds"], state["usage"], state["wl_usage"],
            state["victim_reason"])

"""The lean admission drain over dense quota tensors.

Port of ``kueue_oss_tpu/solver/kernels.py``. The drain reproduces the
reference scheduler's cycle semantics (pkg/scheduler/scheduler.go:
286-467) over the whole backlog on the device:

  round (= one reference cycle):
    1. head selection   — per-CQ lowest-rank pending workload (segment min)
    2. nomination       — batched flavor-option classification against
                          the hierarchical availability
    3. entry ordering   — lexsort by (borrow level, -priority, timestamp)
    4. admission scan   — in entry order: re-check fit under the current
                          usage, bubble usage up the cohort path;
                          Preempt-mode entries reserve and park
    5. rebuild          — cohort usage recomputed bottom-up from CQ rows

The JAX ``while_loop`` is a Python loop with one ``progress.item()`` per
round and the same ``rounds < W1 + C + 2`` bound; the in-round
``lax.scan`` is a loop over the C entries. Updates are out of place, as
in JAX. Quantities are int32 throughout.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from kueue_oss_tpu_torch.solver.ops import (
    INT32,
    arange,
    lexsort,
    segment_min,
)
from kueue_oss_tpu_torch.solver.tensors import BIG as _BIG, SolverProblem

#: tensors.BIG as a Python int (a weak scalar in torch.where, like JAX's)
BIG = int(_BIG)

# candidate modes
M_NOFIT = 0
M_PREEMPT = 1
M_FIT = 2


class ProblemTensors(NamedTuple):
    """Device-side mirror of SolverProblem."""

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
    wl_cqid: torch.Tensor
    wl_rank: torch.Tensor
    wl_prio: torch.Tensor
    wl_ts: torch.Tensor
    wl_uid: torch.Tensor
    wl_req: torch.Tensor
    wl_valid: torch.Tensor


def host_tensors(p: SolverProblem) -> ProblemTensors:
    """The lean drain's inputs as host (numpy) arrays (the resident
    state of solver/delta.py builds its uploads from these)."""
    is_cq = np.zeros(p.parent.shape[0], dtype=bool)
    is_cq[p.cq_node] = True
    return ProblemTensors(**{
        name: is_cq if name == "is_cq" else getattr(p, name)
        for name in ProblemTensors._fields})


def to_device(p: SolverProblem, device) -> ProblemTensors:
    """Upload the problem to ``device`` (int32/bool dtypes kept)."""
    return ProblemTensors(*(torch.as_tensor(np.ascontiguousarray(a),
                                            device=device)
                            for a in host_tensors(p)))


# ---------------------------------------------------------------------------
# Hierarchical quota algebra, tensorized (resource_node.go)
# ---------------------------------------------------------------------------


def refresh_cohort_usage(t: ProblemTensors,
                         usage: torch.Tensor) -> torch.Tensor:
    """Recompute cohort rows bottom-up from ClusterQueue rows: a
    parent's usage is the sum over children of max(0, usage - local).
    ``usage`` is [N+1, F] or lane-batched [L, N+1, F]."""
    u = torch.where(t.is_cq[:, None], usage, 0)
    depth_col = t.depth[:, None]
    parent = t.parent.long()
    node_dim = u.dim() - 2
    for d in range(t.path.shape[1] - 1, 0, -1):
        contrib = torch.where(depth_col == d,
                              torch.clamp(u - t.local_quota, min=0), 0)
        u = u.index_add(node_dim, parent, contrib)
    return u


def available_all(t: ProblemTensors, usage: torch.Tensor) -> torch.Tensor:
    """available() for every node, level-wise from the roots down."""
    avail = t.subtree - usage  # correct for depth-0 (roots)
    local_avail = torch.clamp(t.local_quota - usage, min=0)
    stored = t.subtree - t.local_quota
    used_in_parent = torch.clamp(usage - t.local_quota, min=0)
    clamp = torch.where(t.has_borrow,
                        stored - used_in_parent + t.borrow_limit, BIG)
    depth_col = t.depth[:, None]
    parent = t.parent.long()
    for d in range(1, t.path.shape[1]):
        cand = local_avail + torch.minimum(avail[parent], clamp)
        avail = torch.where(depth_col == d, cand, avail)
    return avail


def potential_available_all(t: ProblemTensors) -> torch.Tensor:
    """potentialAvailable() for every node (resource_node.go:122-133)."""
    pot = t.subtree  # roots
    cap = torch.where(t.has_borrow, t.subtree + t.borrow_limit, BIG)
    depth_col = t.depth[:, None]
    parent = t.parent.long()
    for d in range(1, t.path.shape[1]):
        cand = torch.minimum(t.local_quota + pot[parent], cap)
        pot = torch.where(depth_col == d, cand, pot)
    return pot


def borrow_levels(t: ProblemTensors, usage: torch.Tensor,
                  cand_w: torch.Tensor):
    """FindHeightOfLowestSubtreeThatFits, batched over candidates and
    options. Returns (level [C,K,F] int32, may_reclaim [C,K,F] bool)."""
    null = t.parent.shape[0] - 1
    req = t.wl_req[cand_w]                        # [C,K,F]
    paths = t.path[t.cq_node]                     # [C,D]
    d_max = paths.shape[1]
    level = torch.zeros_like(req)
    may_reclaim = torch.zeros(req.shape, dtype=torch.bool,
                              device=req.device)
    found = req == 0
    rem = req
    for d in range(d_max):
        node = paths[:, d]                        # [C]
        node_valid = (node != null)[:, None, None]
        usage_n = usage[node][:, None, :]
        subtree_n = t.subtree[node][:, None, :]
        la_n = torch.clamp(t.local_quota[node] - usage[node],
                           min=0)[:, None, :]
        not_borrowing = usage_n + rem <= subtree_n
        newly = (~found) & not_borrowing & node_valid
        level = torch.where(newly, t.height[node][:, None, None], level)
        may_reclaim = torch.where(
            newly, t.has_parent[node][:, None, None], may_reclaim)
        found = found | newly
        rem = torch.where(found | ~node_valid, rem, rem - la_n)
    # not found anywhere: whole-hierarchy height, no proper subtree
    root_idx = paths[:, d_max - 1]
    for d in range(d_max - 2, -1, -1):
        root_idx = torch.where(root_idx == null, paths[:, d], root_idx)
    root_h = t.height[root_idx][:, None, None]
    level = torch.where(found, level, root_h)
    return level, may_reclaim


def nominate(t: ProblemTensors, usage, avail, pot, cand_w, cursor):
    """Classify each CQ's head: (mode, chosen option, borrow level, next
    cursor) — flavorassigner fitsResourceQuota + fungibility selection
    with the LastTriedFlavorIdx cursor (flavorassigner.go:843,939-947)."""
    req = t.wl_req[cand_w]                        # [C,K,F]
    K = req.shape[1]
    k_idx = arange(K, req.device)[None, :]
    cursor_c = cursor[cand_w][:, None]            # [C,1]
    valid = t.wl_valid[cand_w] & (k_idx >= cursor_c)  # [C,K]
    avail_cq = avail[t.cq_node][:, None, :]       # [C,1,F]
    pot_cq = pot[t.cq_node][:, None, :]
    nominal_cq = t.nominal[t.cq_node][:, None, :]

    level, may_reclaim = borrow_levels(t, usage, cand_w)

    nonzero = req > 0
    fit_fr = (~nonzero) | (req <= avail_cq)               # [C,K,F]
    within_cap = (~nonzero) | (req <= pot_cq)
    preemptish_fr = (~nonzero) | (
        within_cap & ((req <= nominal_cq) | may_reclaim))

    opt_fit = valid & fit_fr.all(dim=-1)                  # [C,K]
    opt_preempt = valid & (fit_fr | preemptish_fr).all(dim=-1)
    opt_level = torch.where(nonzero, level, 0).amax(dim=-1)  # [C,K]

    def first_true(mask):  # [C,K] -> [C] first index or K
        return torch.where(mask, k_idx, K).amin(dim=1)

    # default policy (whenCanBorrow=Borrow): first fitting option
    k_default = first_true(opt_fit)
    # TryNextFlavor: first non-borrowing fit, else the fit with the
    # lowest borrow level (ties -> earliest flavor)
    k_nonborrow = first_true(opt_fit & (opt_level == 0))
    lvl_key = torch.where(opt_fit, opt_level * K + k_idx, BIG)
    k_bestlvl = torch.argmin(lvl_key, dim=1).to(INT32)
    k_try_next = torch.where(
        k_nonborrow < K, k_nonborrow,
        torch.where(opt_fit.any(dim=1), k_bestlvl, K))
    k_fit = torch.where(t.cq_try_next, k_try_next, k_default)

    any_fit = k_fit < K
    k_preempt = first_true(opt_preempt & ~opt_fit)
    any_preempt = k_preempt < K

    k_chosen = torch.where(any_fit, k_fit,
                           torch.where(any_preempt, k_preempt, 0)).to(INT32)
    mode = torch.where(any_fit, M_FIT,
                       torch.where(any_preempt, M_PREEMPT, M_NOFIT)).to(INT32)
    borrow = torch.gather(opt_level, 1, k_chosen[:, None].long())[:, 0]

    # flavor cursor for re-nomination: the search breaks early only at a
    # fit the fungibility policy accepts; walking off the end resets it
    early_break = torch.where(t.cq_try_next, k_nonborrow < K, any_fit)
    next_cursor = torch.where(
        early_break & (k_chosen < t.cq_nflavors - 1), k_chosen + 1, 0)
    return mode, k_chosen, borrow, next_cursor.to(INT32)


# ---------------------------------------------------------------------------
# In-round admission scan (entry order, usage bubbling)
# ---------------------------------------------------------------------------


def _avail_along_path(t: ProblemTensors, usage: torch.Tensor,
                      cq_node: torch.Tensor) -> torch.Tensor:
    """available() for one CQ under the current usage, root -> leaf.
    ``cq_node`` is a [1] index tensor; returns [1, F]."""
    path = t.path[cq_node]                        # [1, D]
    null = t.parent.shape[0] - 1
    avail = torch.zeros((1, t.subtree.shape[1]), dtype=INT32,
                        device=usage.device)
    started = torch.zeros(1, dtype=torch.bool, device=usage.device)
    for d in range(path.shape[1] - 1, -1, -1):
        node = path[:, d]                         # [1]
        is_valid = node != null
        usage_n = usage[node]
        subtree_n = t.subtree[node]
        local_q = t.local_quota[node]
        local_avail = torch.clamp(local_q - usage_n, min=0)
        stored = subtree_n - local_q
        used_in_parent = torch.clamp(usage_n - local_q, min=0)
        clamp = torch.where(t.has_borrow[node],
                            stored - used_in_parent + t.borrow_limit[node],
                            BIG)
        root_avail = subtree_n - usage_n
        child_avail = local_avail + torch.minimum(avail, clamp)
        cand = torch.where(started, child_avail, root_avail)
        avail = torch.where(is_valid, cand, avail)
        started = started | is_valid
    return avail


def _add_usage_along_path(t: ProblemTensors, usage: torch.Tensor,
                          cq_node: torch.Tensor,
                          val: torch.Tensor) -> torch.Tensor:
    """addUsage with bubbling (resource_node.go:137-145) along one path.
    ``cq_node`` is a [1] index tensor, ``val`` [1, F]."""
    path = t.path[cq_node]
    null = t.parent.shape[0] - 1
    for d in range(path.shape[1]):
        node = path[:, d]
        is_valid = node != null
        local_avail = torch.clamp(t.local_quota[node] - usage[node], min=0)
        usage = usage.index_add(0, node, torch.where(is_valid, val, 0))
        val = torch.clamp(val - local_avail, min=0)
    return usage


def _round_scan(t: ProblemTensors, usage, cq_usage, admitted, parked,
                cand_w, mode, k_chosen, borrow):
    """Process this round's nominated heads in entry order.

    ``usage`` is the working tensor (admissions + reservations,
    bubbled); ``cq_usage`` carries only durable CQ-row usage. Cohort rows
    are rebuilt from it at round end, which drops reservations — like
    the reference's fresh per-cycle snapshot.

    Each step addresses its slot through [1]-shaped index tensors (a
    slice of the slot arrays): indexing with a 0-d device tensor would
    read it back to the host, one synchronisation per index.
    """
    W_null = t.wl_rank.shape[0] - 1
    prio = t.wl_prio[cand_w]
    ts = t.wl_ts[cand_w]
    uid = t.wl_uid[cand_w]
    active = (cand_w != W_null) & (mode != M_NOFIT)
    sort_borrow = torch.where(active, borrow, BIG)
    order = lexsort((uid, ts, -prio, sort_borrow)).long()
    slot_w = cand_w.long()[order]
    slot_node = t.cq_node.long()[order]
    slot_strict = t.cq_strict[order]
    slot_m = mode[order]
    slot_k = k_chosen.long()[order]
    slot_b = borrow[order]
    any_admitted = torch.zeros(1, dtype=torch.bool, device=cand_w.device)
    for i in range(order.shape[0]):
        w, cq_node, m = slot_w[i:i + 1], slot_node[i:i + 1], slot_m[i:i + 1]
        req = t.wl_req[w, slot_k[i:i + 1]]        # [1, F]
        is_active = (w != W_null) & (m != M_NOFIT)

        # Preempt mode: reserve entitled capacity and park
        # (scheduler.go reserveCapacityForUnreclaimablePreempt)
        usage_cq = usage[cq_node]
        nominal_cq = t.nominal[cq_node]
        reserve_borrowing = torch.where(
            t.has_borrow[cq_node],
            torch.minimum(req, nominal_cq + t.borrow_limit[cq_node]
                          - usage_cq), req)
        reserve_nominal = torch.minimum(req, nominal_cq - usage_cq)
        reserve = torch.clamp(
            torch.where(slot_b[i:i + 1] > 0, reserve_borrowing,
                        reserve_nominal), min=0)
        is_preempt = is_active & (m == M_PREEMPT)
        usage = _add_usage_along_path(
            t, usage, cq_node, torch.where(is_preempt, reserve, 0))
        # Preempt-no-targets heads park for BestEffortFIFO and stay
        # (still blocking) for StrictFIFO
        parked = parked.index_put(
            (w,), parked[w] | (is_preempt & ~slot_strict[i:i + 1]))

        # Fit mode: re-check under current usage, then admit
        avail_now = _avail_along_path(t, usage, cq_node)
        still_fits = ((req == 0) | (req <= avail_now)).all(dim=1)
        do_admit = is_active & (m == M_FIT) & still_fits
        admit_vec = torch.where(do_admit, req, 0)
        usage = _add_usage_along_path(t, usage, cq_node, admit_vec)
        cq_usage = cq_usage.index_add(0, cq_node, admit_vec)
        admitted = admitted.index_put((w,), admitted[w] | do_admit)
        any_admitted = any_admitted | do_admit
    return cq_usage, admitted, parked, any_admitted.reshape(())


# ---------------------------------------------------------------------------
# The drain loop
# ---------------------------------------------------------------------------


def _select_heads(t: ProblemTensors, admitted, parked):
    """Per-CQ lowest-rank pending workload (two-pass int32 segment min)."""
    C = t.cq_node.shape[0]
    W1 = t.wl_rank.shape[0]
    W_null = W1 - 1
    pending = ~admitted & ~parked
    rank_eff = torch.where(pending, t.wl_rank, BIG)
    cqid = t.wl_cqid[:-1]
    # segment C collects the padding rows; the JAX program gathers it
    # clamped to C-1 instead, which only changes segment C's head, and
    # that head is dropped below
    min_rank = segment_min(rank_eff[:-1], cqid, C + 1)
    w_idx = arange(W1 - 1, rank_eff.device)
    is_head = rank_eff[:-1] == min_rank[cqid.long()]
    head_w = segment_min(torch.where(is_head, w_idx, W_null), cqid,
                         C + 1)[:C]
    has_head = min_rank[:C] < BIG
    return torch.where(has_head, head_w, W_null).to(INT32)


def solve_backlog(t: ProblemTensors):
    """Drain the backlog: run reference-equivalent cycles until
    quiescent.

    Returns (admitted [W+1] bool, chosen_option [W+1] int32,
    admit_round [W+1] int32, parked [W+1] bool, rounds int32 0-d,
    final usage [N+1, F]) on the problem's device.
    """
    W1 = t.wl_rank.shape[0]
    C = t.cq_node.shape[0]
    W_null = W1 - 1
    device = t.wl_rank.device
    pot = potential_available_all(t)

    usage = t.usage0
    admitted = torch.zeros(W1, dtype=torch.bool, device=device)
    parked = torch.zeros(W1, dtype=torch.bool, device=device)
    cursor = torch.zeros(W1, dtype=INT32, device=device)
    opt = torch.zeros(W1, dtype=INT32, device=device)
    admit_round = torch.full((W1,), -1, dtype=INT32, device=device)
    rounds = 0
    progress = True
    while progress and rounds < W1 + C + 2:
        parked_before = parked
        cursor_before = cursor
        cand_w = _select_heads(t, admitted, parked)
        cand_l = (cand_w.long(),)
        avail = available_all(t, usage)
        mode, k_chosen, borrow, next_cursor = nominate(
            t, usage, avail, pot, cand_w, cursor)

        # Park NoFit heads of BestEffortFIFO queues; StrictFIFO heads
        # stay and block their queue. Entries for CQs without a head
        # all address the null row and rewrite its own value, so the
        # repeated indices agree.
        is_head = cand_w != W_null
        park_now = is_head & (mode == M_NOFIT) & ~(t.cq_strict & is_head)
        parked = parked.index_put(cand_l, parked[cand_w] | park_now)

        was_admitted = admitted
        cq_usage, admitted, parked, any_admitted = _round_scan(
            t, usage, usage, admitted, parked, cand_w, mode, k_chosen,
            borrow)
        usage = refresh_cohort_usage(t, cq_usage)

        newly = admitted[cand_w] & ~was_admitted[cand_w]
        opt = opt.index_put(cand_l, torch.where(newly, k_chosen,
                                                opt[cand_w]))
        admit_round = admit_round.index_put(
            cand_l, torch.where(newly, rounds, admit_round[cand_w]))
        # heads that stay pending resume at the recorded flavor cursor
        keep = is_head & ~admitted[cand_w]
        cursor = cursor.index_put(
            cand_l, torch.where(keep, next_cursor, cursor[cand_w]))

        # progress = any admission, any head parked, or any cursor move
        progress_t = (any_admitted | (parked & ~parked_before).any()
                      | (cursor != cursor_before).any())
        progress = bool(progress_t.item())
        rounds += 1
    admitted = admitted.clone()
    parked = parked.clone()
    admitted[W_null] = False
    parked[W_null] = False
    return (admitted, opt, admit_round, parked,
            torch.tensor(rounds, dtype=INT32, device=device), usage)

"""Fair-sharing kernels: DRS, the target tournament, the fair victim
search and the admission-order tournament.

Port of ``kueue_oss_tpu/solver/fair_kernels.py``, which mirrors the
host fair-sharing stack:

- DRS math (core/quota.py ``dominant_resource_share``; reference
  pkg/cache/scheduler/fair_sharing.go:140-173): per node, the max over
  resources of (borrowed above the subtree quota) * 1000 / (the lendable
  capacity of the parent), divided by the fair weight; zero-weight
  borrowers sort above everything;
- the target-CQ tournament (fairsharing/ordering.go): descend from the
  root picking the highest-share child, pruning non-borrowing branches;
- the preemption strategy rules S2-a LessThanOrEqualToFinalShare and
  S2-b LessThanInitialShare (preemption.go:371-534) with the almost-LCA
  share comparison (fairsharing/least_common_ancestor.go);
- the per-cohort entry tournament of the admission order
  (fair_sharing_iterator.go:44-130), ``fair_entry_pick``, which
  ``full_kernels.full_round_scan`` calls once per pop.

Translation rules beyond ``full_kernels``'s: the JAX program's int32
matmuls against the FR -> resource one-hot are ``ops.resource_sum``
(CUDA has no integer matmul); shares are float32 computed in the JAX
op order (``borrowed * 1000.0 / lendable``, then ``/ max(w, 1e-30)``)
and compared exactly; ``fair_search`` carries an explicit lane axis,
and its two batched ``while_loop``s become masked loops over the lanes
whose own condition holds: the strategy loop reads one ``.any()`` per
iteration, the fill-back one trip bound.
"""

from __future__ import annotations

import torch

from kueue_oss_tpu_torch import features
from kueue_oss_tpu_torch.solver.full_kernels import (
    V_HIERARCHICAL_RECLAIM,
    V_WITHIN_CQ,
    FullDrainStats,
    _add_path,
    _height_path,
    _i32,
    _remove_path,
    _workload_fits,
)
from kueue_oss_tpu_torch.solver.kernels import BIG
from kueue_oss_tpu_torch.solver.ops import (
    INT32,
    arange,
    resource_sum,
    segment_min,
    segment_min_rows,
)
from kueue_oss_tpu_torch.solver.tensors import (
    POLICY_ANY,
    POLICY_LOWER_OR_NEWER_EQUAL,
    POLICY_LOWER_PRIORITY,
    POLICY_NEVER,
)

#: synthetic candidate variant of fair-sharing victims (the classical
#: V_* codes live in full_kernels; the engine maps it to
#: InCohortFairSharing)
V_FAIR_SHARING = 5


def lendable_by_resource(t, pot):
    """calculate_lendable for every node's PARENT: [N+1, R].

    lendable[n, r] = the sum over resource r's FR columns of
    potentialAvailable(parent(n)); usage-independent, computed once.
    """
    lend_nodes = resource_sum(pot, t.fr_resource, t.res_onehot.shape[1])
    out = lend_nodes[t.parent.long()]
    return torch.where(t.has_parent[:, None], out, 0)


def drs_all(t, usage, lendable_r):
    """DRS of every node under ``usage`` ([..., N+1, F], any leading
    lane axes): (zwb bool, share f32, borrowing bool, unweighted f32),
    each [..., N+1].

    Reference: fair_sharing.go dominantResourceShare. Nodes without a
    parent have zero DRS."""
    borrowed = torch.clamp(usage - t.subtree, min=0)
    borrowed_r = resource_sum(borrowed, t.fr_resource, lendable_r.shape[1])
    borrowing = (borrowed_r > 0).any(dim=-1) & t.has_parent
    ratio = torch.where(
        (lendable_r > 0) & (borrowed_r > 0),
        borrowed_r.float() * 1000.0 / lendable_r.float(), 0.0)
    unweighted = torch.where(t.has_parent, ratio.amax(dim=-1), 0.0)
    w = t.node_fair_weight
    share = torch.where(w > 0, unweighted / torch.clamp(w, min=1e-30), 0.0)
    zwb = (w == 0) & (unweighted > 0)
    return zwb, share, borrowing, unweighted


def drs_gt(a_zwb, a_share, a_unw, b_zwb, b_share, b_unw):
    """compare_drs(a, b) > 0 (higher share = preferred for preemption)."""
    return torch.where(
        a_zwb & b_zwb, a_unw > b_unw,
        torch.where(a_zwb, True, torch.where(b_zwb, False,
                                             a_share > b_share)))


def drs_ge(a_zwb, a_share, a_unw, b_zwb, b_share, b_unw):
    return torch.where(
        a_zwb & b_zwb, a_unw >= b_unw,
        torch.where(a_zwb, True, torch.where(b_zwb, False,
                                             a_share >= b_share)))


def drs_le(a_zwb, a_share, a_unw, b_zwb, b_share, b_unw):
    return ~drs_gt(a_zwb, a_share, a_unw, b_zwb, b_share, b_unw)


def drs_lt(a_zwb, a_share, a_unw, b_zwb, b_share, b_unw):
    return ~drs_ge(a_zwb, a_share, a_unw, b_zwb, b_share, b_unw)


def _almost_lca_node(t, cq_node, lca_node):
    """Per lane, the node on ``cq_node``'s path just below
    ``lca_node``; [L]."""
    path = t.path[cq_node.long()]                            # [L,D]
    D = path.shape[1]
    lca_d = torch.where(path == lca_node[:, None], arange(D, path.device),
                        D).amin(dim=-1)
    return torch.gather(path, 1, torch.clamp(lca_d - 1, min=0)
                        .long()[:, None])[:, 0]


def _lca_of(t, my_path, other_cq_node):
    """Per lane, the first node on ``my_path`` that is an ancestor of
    ``other_cq_node``, and its path position; ([L], [L])."""
    null = t.parent.shape[0] - 1
    other_path = t.path[other_cq_node.long()]               # [L,D]
    D = my_path.shape[1]
    is_anc = (other_path[:, :, None] == my_path[:, None, :]).any(dim=1)
    is_anc = is_anc & (my_path != null)
    lca_d = torch.where(is_anc, arange(D, my_path.device), D).amin(dim=-1)
    node = torch.gather(my_path, 1, torch.clamp(lca_d, max=D - 1)
                        .long()[:, None])[:, 0]
    return node, lca_d


def fair_search(t, lendable_r, usage0_round, wl_usage, admitted, evicted_f,
                ts, head_w, req, avail_cq, cands, p_max: int,
                stats: FullDrainStats):
    """Fair-sharing victim search for every lane (one preemptor each).

    Mirrors Preemptor._fair_preemptions: candidate collection
    (_find_fs_candidates), the DRS tournament over target CQs, strategy
    rules S2-a then S2-b, fill-back. ``head_w`` [L], ``req`` [L, F],
    ``avail_cq`` [L, F] and ``cands`` [L, P] (the preemptor root's row
    of build_candidate_table) carry the lane axis. Same return contract
    as ``full_kernels.classical_search``: (success [L], cand_w [L, P],
    victims [L, P], reason [L, P] int8, any_same_cq [L], borrow_after
    [L])."""
    W_null = t.wl_cqid.shape[0] - 1
    C = t.cq_node.shape[0]
    N1 = t.parent.shape[0]
    null_node = N1 - 1
    D = t.path.shape[1]
    dev = head_w.device
    L = head_w.shape[0]
    lanes = torch.arange(L, device=dev)
    hw = head_w.long()
    cqid = t.wl_cqid[hw]
    cqi = torch.clamp(cqid, max=C - 1).long()
    cq_node = t.cq_node[cqi].long()
    my_path = t.path[cq_node]                                # [L,D]
    p_idx = arange(p_max, dev)

    frs_mask = (req > 0) & (req > avail_cq)                  # [L,F]

    # ---- candidate collection (_find_fs_candidates) ------------------
    cl = cands.long()
    present = cands != W_null
    cand_cqid = t.wl_cqid[cl]                                # [L,P]
    cand_node = t.cq_node[torch.clamp(cand_cqid, max=C - 1).long()].long()
    is_adm = present & admitted[cl] & (cands != head_w[:, None])
    uses = ((wl_usage[cl] * frs_mask[:, None, :]) > 0).any(dim=-1)
    same_cq = cand_cqid == cqid[:, None]
    prio_p = t.wl_prio[hw][:, None]
    prio_c = t.wl_prio[cl]
    lower = prio_p > prio_c
    buf_p = torch.where(ts[hw] >= t.ts_evict_base, BIG, t.wl_ts_buf[hw])
    newer_eq = (prio_p == prio_c) & (ts[cl] > buf_p[:, None])

    def sat(policy):
        policy = policy[:, None]
        return torch.where(
            policy == POLICY_NEVER, False,
            torch.where(policy == POLICY_LOWER_PRIORITY, lower,
                        torch.where(policy == POLICY_LOWER_OR_NEWER_EQUAL,
                                    lower | newer_eq, policy == POLICY_ANY)))

    own_legal = same_cq & sat(t.cq_within_policy[cqi])
    # other CQs: same cohort forest, candidate CQ borrowing on a needed FR
    other_path = t.path[cand_node]                           # [L,P,D]
    shares_tree = ((other_path[:, :, :, None] == my_path[:, None, None, :])
                   & (my_path[:, None, None, :] != null_node)
                   ).flatten(2).any(dim=-1)
    cq_borrowing = (frs_mask[:, None, :]
                    & (usage0_round[cand_node] > t.subtree[cand_node])
                    ).any(dim=-1)
    has_par = t.has_parent[cq_node]
    other_legal = (~same_cq & has_par[:, None] & shares_tree & cq_borrowing
                   & sat(t.cq_reclaim_policy[cqi]))
    legal = is_adm & uses & (own_legal | other_legal)

    # ---- candidate ordering: a stable bucket sort of the shared order:
    # legal first, evicted first, other-CQ candidates before own ones
    not_evicted = ~evicted_f[cl]
    bucket = torch.where(legal, _i32(not_evicted) * 2 + _i32(same_cq), 4)
    perm = torch.argsort(bucket * p_max + p_idx, dim=-1, stable=True)
    cand_valid = torch.gather(bucket, 1, perm) < 4
    cand_w = torch.where(cand_valid, torch.gather(cands, 1, perm), W_null)
    cwl = cand_w.long()
    slot_cqid = torch.where(cand_valid, t.wl_cqid[cwl], C)   # [L,P]
    v_node = t.cq_node[torch.clamp(t.wl_cqid[cwl], max=C - 1).long()]
    v_usage = wl_usage[cwl]                                  # [L,P,F]

    # ---- state: the incoming usage simulated on the preemptor's CQ for
    # the whole strategy phase (cq.simulate_usage_addition) -------------
    usage_init = usage0_round.unsqueeze(0).repeat(L, 1, 1)
    usage_sim = _add_path(t, usage_init, cq_node, req)

    # FairSharingPreemptWithinNominal: a preemptor whose CQ is not
    # borrowing on any contested FR, with the incoming usage simulated,
    # preempts cross-CQ candidates unconditionally (preemption.go:
    # 377-412); those victims carry the InCohortReclamation reason
    if features.enabled("FairSharingPreemptWithinNominal"):
        within_nominal = ~(frs_mask & (usage_sim[lanes, cq_node]
                                       > t.subtree[cq_node])).any(dim=-1)
    else:
        within_nominal = torch.zeros(L, dtype=torch.bool, device=dev)

    n_idx = arange(N1, dev)
    on_my_path = ((my_path[:, :, None] == n_idx)
                  & (my_path[:, :, None] != null_node)).any(dim=1)  # [L,N1]
    root_d = torch.where(my_path != null_node, arange(D, dev),
                         0).amax(dim=-1)
    root_node = my_path[lanes, root_d.long()]
    is_cohort = ~t.is_cq & (n_idx != null_node)
    cq_nodes = t.cq_node.long()
    cq_parent = t.parent[cq_nodes]
    not_mine = arange(C, dev)[None, :] != cqi[:, None]       # [L,C]

    def head_slot(consumed, only_retry, retry):
        """Per-CQ first unconsumed candidate slot: [L, C], p_max or
        above where none."""
        ok = cand_valid & ~consumed & (~only_retry[:, None] | retry)
        eff = torch.where(ok, p_idx, p_max)
        return segment_min_rows(eff, slot_cqid, C + 1)[:, :C]

    def tournament(zwb, share, borrowing, unw, pruned_cq, pruned_cohort,
                   heads):
        """One descent (_CQOrdering._next_target) per lane: (target [L],
        C where none; the new pruned sets). At most D levels."""
        prune_now = (~borrowing[:, cq_nodes] & not_mine) | ~(heads < p_max)
        pruned_cq = pruned_cq | prune_now
        pruned_cohort = pruned_cohort | (is_cohort & ~borrowing & ~on_my_path)
        cq_zwb = zwb[:, cq_nodes]
        cq_share = share[:, cq_nodes]
        cq_unw = unw[:, cq_nodes]
        current = root_node
        target = torch.full((L,), C, dtype=INT32, device=dev)
        done = torch.zeros(L, dtype=torch.bool, device=dev)
        for _ in range(D):
            # best CQ child of `current`: lexicographic max of (zwb,
            # share or unweighted), ties to the lower head slot
            elig_cq = ((cq_parent == current[:, None]) & ~pruned_cq
                       & ~done[:, None])
            key_share = torch.where(elig_cq, cq_share, -1.0)
            key_unw = torch.where(elig_cq, cq_unw, -1.0)
            any_elig = elig_cq.any(dim=-1)
            m_zwb = (cq_zwb & elig_cq).any(dim=-1)
            sel = elig_cq & (cq_zwb == m_zwb[:, None])
            m_share = torch.where(sel, key_share, -1.0).amax(dim=-1)
            m_unw = torch.where(sel, key_unw, -1.0).amax(dim=-1)
            is_top = sel & torch.where(m_zwb[:, None],
                                       key_unw == m_unw[:, None],
                                       key_share == m_share[:, None])
            best_cq = _i32(torch.argmin(
                torch.where(is_top, heads, p_max + 1), dim=-1))
            best_cq = torch.where(any_elig, best_cq, C)

            # best cohort child; the host iterates children in order and
            # updates on >=, so the last maximum wins
            elig_co = ((t.parent == current[:, None]) & is_cohort
                       & ~pruned_cohort & ~done[:, None])
            co_share = torch.where(elig_co, share, -1.0)
            co_unw = torch.where(elig_co, unw, -1.0)
            any_co = elig_co.any(dim=-1)
            c_zwb = (zwb & elig_co).any(dim=-1)
            selc = elig_co & (zwb == c_zwb[:, None])
            c_share = torch.where(selc, co_share, -1.0).amax(dim=-1)
            c_unw = torch.where(selc, co_unw, -1.0).amax(dim=-1)
            is_topc = selc & torch.where(c_zwb[:, None],
                                         co_unw == c_unw[:, None],
                                         co_share == c_share[:, None])
            best_co = torch.where(is_topc, n_idx, -1).amax(dim=-1)

            none_found = ~any_elig & ~any_co
            # prune the current cohort when nothing remains below it
            cur = current.long()
            pruned_cohort = pruned_cohort.index_put(
                (lanes, cur), pruned_cohort[lanes, cur]
                | (none_found & ~done))
            cq_wins = any_elig & (~any_co | drs_ge(m_zwb, m_share, m_unw,
                                                   c_zwb, c_share, c_unw))
            target = torch.where(~done & cq_wins, best_cq, target)
            done = done | none_found | cq_wins
            current = torch.where(done, current, torch.clamp(best_co, min=0))
        return target, pruned_cq, pruned_cohort

    # ---- strategy phases ---------------------------------------------
    u = usage_sim
    consumed = torch.zeros((L, p_max), dtype=torch.bool, device=dev)
    retry = torch.zeros_like(consumed)
    victims = torch.zeros_like(consumed)
    vseq = torch.full((L, p_max), -1, dtype=INT32, device=dev)
    nv = torch.zeros(L, dtype=INT32, device=dev)
    pruned_cq = torch.zeros((L, C), dtype=torch.bool, device=dev)
    pruned_cohort = torch.zeros((L, N1), dtype=torch.bool, device=dev)
    fitted = torch.zeros(L, dtype=torch.bool, device=dev)
    phase = torch.ones(L, dtype=INT32, device=dev)
    it = torch.zeros(L, dtype=INT32, device=dev)
    it_cap = 2 * p_max + N1
    while True:
        root_dead = pruned_cohort[lanes, root_node]
        active = ~fitted & (it < it_cap) & ~((phase == 2) & root_dead)
        if not stats.read(active.any()):
            break
        stats.walk_iterations += 1
        heads = head_slot(consumed, phase == 2, retry)
        zwb, share, borrowing, unw = drs_all(t, u, lendable_r)
        target, pcq_n, pco_n = tournament(zwb, share, borrowing, unw,
                                          pruned_cq, pruned_cohort, heads)
        # parentless preemptor: only its own CQ is a target
        # (_CQOrdering.iter() root-less branch)
        target = torch.where(
            has_par, target,
            torch.where(heads[lanes, cqi] < p_max, _i32(cqi), C))
        has_target = target < C
        tc = torch.clamp(target, max=C - 1).long()
        slot = heads[lanes, tc]
        slot_ok = has_target & (slot < p_max)
        sc = torch.clamp(slot, max=p_max - 1).long()
        a_node = v_node[lanes, sc]
        is_own = has_target & (target == cqi)

        # preemptor_new / target_old almost-LCA shares
        tgt_node = t.cq_node[tc]
        lca, _ = _lca_of(t, my_path, tgt_node)
        pre_n = _almost_lca_node(t, cq_node, lca).long()
        tgt_n = _almost_lca_node(t, tgt_node, lca).long()
        p_key = (zwb[lanes, pre_n], share[lanes, pre_n], unw[lanes, pre_n])
        t_key = (zwb[lanes, tgt_n], share[lanes, tgt_n], unw[lanes, tgt_n])

        # target_new: the target's almost-LCA share after removing the
        # head candidate
        u_try = _remove_path(t, u, a_node, torch.where(
            slot_ok[:, None], v_usage[lanes, sc], 0))
        zwb2, share2, _b2, unw2 = drs_all(t, u_try, lendable_r)
        n_key = (zwb2[lanes, tgt_n], share2[lanes, tgt_n],
                 unw2[lanes, tgt_n])

        # phase 1 = S2-a LessThanOrEqualToFinalShare (own-CQ pops skip
        # the rule; a within-nominal preemptor bypasses it for cross-CQ
        # candidates too); phase 2 = S2-b LessThanInitialShare
        s2a = drs_le(*p_key, *n_key)
        s2b = drs_lt(*p_key, *t_key)
        accept = slot_ok & torch.where(phase == 1,
                                       is_own | within_nominal | s2a, s2b)

        u_n = torch.where(accept[:, None, None], u_try, u)
        consumed_n = consumed.index_put((lanes, sc),
                                        consumed[lanes, sc] | slot_ok)
        # phase-1 rejections go to the retry list (the S2-b pass)
        retry_n = retry.index_put(
            (lanes, sc), retry[lanes, sc]
            | (slot_ok & ~accept & (phase == 1) & ~is_own))
        victims_n = victims.index_put((lanes, sc), victims[lanes, sc] | accept)
        vseq_n = vseq.index_put((lanes, sc),
                                torch.where(accept, nv, vseq[lanes, sc]))
        nv_n = nv + _i32(accept)
        fitted_n = accept & _workload_fits(
            t, _remove_path(t, u_n, cq_node, req), cq_node, req, True)
        # S2-b drops the queue after one attempt, whatever the outcome
        pcq_n = pcq_n.index_put((lanes, tc), pcq_n[lanes, tc]
                                | (has_target & (phase == 2)))
        # root pruned in phase 1 -> phase 2 with fresh pruning state
        # over the retry list; consumed slots stay consumed
        dead_n = pco_n[lanes, root_node] | ~has_target
        to_phase2 = (phase == 1) & dead_n & ~fitted_n
        pcq_n = pcq_n & ~to_phase2[:, None]
        pco_n = pco_n & ~to_phase2[:, None]
        consumed_n = torch.where(to_phase2[:, None], consumed_n & ~retry_n,
                                 consumed_n)
        phase_n = torch.where(to_phase2, 2, phase)

        a1 = active[:, None]
        u = torch.where(active[:, None, None], u_n, u)
        consumed = torch.where(a1, consumed_n, consumed)
        retry = torch.where(a1, retry_n, retry)
        victims = torch.where(a1, victims_n, victims)
        vseq = torch.where(a1, vseq_n, vseq)
        nv = torch.where(active, nv_n, nv)
        pruned_cq = torch.where(a1, pcq_n, pruned_cq)
        pruned_cohort = torch.where(a1, pco_n, pruned_cohort)
        fitted = torch.where(active, fitted_n, fitted)
        phase = torch.where(active, phase_n, phase)
        it = torch.where(active, it + 1, it)

    # ---- fill back (incoming usage reverted; allowBorrowing=true):
    # victims newest-first from sequence nv - 2 down to 0, so a fitted
    # lane runs exactly nv - 1 steps
    u_fb = _remove_path(t, u, cq_node, req)
    s = nv - 2
    n_steps = stats.read(torch.where(fitted, nv - 1, 0).amax())
    for _ in range(n_steps):
        stats.fill_iterations += 1
        active = fitted & (s >= 0)
        match = victims & (vseq == s[:, None])
        slot = torch.argmax(_i32(match), dim=-1)
        tryit = match.any(dim=-1)
        u_row = torch.where(tryit[:, None], v_usage[lanes, slot], 0)
        node = v_node[lanes, slot]
        u_a = _add_path(t, u_fb, node, u_row)
        still = _workload_fits(t, u_a, cq_node, req, True)
        u_b = _remove_path(t, u_a, node, torch.where(
            (tryit & ~still)[:, None], u_row, 0))
        victims_n = victims.index_put(
            (lanes, slot), victims[lanes, slot] & ~(tryit & still))
        u_fb = torch.where(active[:, None, None], u_b, u_fb)
        victims = torch.where(active[:, None], victims_n, victims)
        s = torch.where(active, s - 1, s)

    victims = victims & fitted[:, None]
    success = fitted
    level_f = _height_path(t, torch.where(success[:, None, None], u_fb,
                                          usage_init), cq_node, req)
    borrow_after = torch.where(frs_mask, level_f, 0).amax(dim=-1)
    victim_same = victims & (t.wl_cqid[cwl] == cqid[:, None])
    any_same_cq = victim_same.any(dim=-1)
    # within-nominal bypass victims are entitlement reclamations
    # (InCohortReclamation), not fair-sharing preemptions
    cross_reason = torch.where(within_nominal, V_HIERARCHICAL_RECLAIM,
                               V_FAIR_SHARING)
    reason = torch.where(
        victims, torch.where(victim_same, V_WITHIN_CQ, cross_reason[:, None]),
        0).to(torch.int8)
    return success, _i32(cand_w), victims, reason, any_same_cq, borrow_after


# ---------------------------------------------------------------------------
# admission-order tournament (fair_sharing_iterator.go)
# ---------------------------------------------------------------------------


def fair_entry_pick(t, lendable_r, usage, cand_w, req_c, ts, active):
    """The next entry to process under fair sharing; 0-d int32, C if
    none.

    Mirrors _FairSharingIterator.pop(): take the first remaining entry's
    root cohort, compute per-entry DRS values along its path with the
    entry's usage hypothetically added (on the current, mutated usage),
    and run the per-cohort tournament bottom-up: at every cohort the
    child with the lowest share wins, ties broken by higher priority,
    then earlier timestamp."""
    C = cand_w.shape[0]
    N1 = t.parent.shape[0]
    null_node = N1 - 1
    D = t.path.shape[1]
    dev = cand_w.device
    cq_nodes = t.cq_node.long()
    paths = t.path[cq_nodes].long()                          # [C,D]

    # per-entry DRS along its path with the entry usage added
    # (_compute_drs: simulate_usage_addition, then shares up the path)
    v = req_c
    rows_new = []
    for d in range(D):
        node = paths[:, d]
        ok = (node != null_node)[:, None]
        la = torch.clamp(t.local_quota[node] - usage[node], min=0)
        rows_new.append(usage[node] + torch.where(ok, v, 0))
        v = torch.clamp(v - la, min=0)
    rows_new = torch.stack(rows_new, dim=1)                  # [C,D,F]
    borrowed = torch.clamp(rows_new - t.subtree[paths], min=0)
    lend = lendable_r[paths]                                 # [C,D,R]
    borrowed_r = resource_sum(borrowed, t.fr_resource, lend.shape[2])
    ratio = torch.where((lend > 0) & (borrowed_r > 0),
                        borrowed_r.float() * 1000.0 / lend.float(), 0.0)
    unw = torch.where(t.has_parent[paths], ratio.amax(dim=2), 0.0)
    w = t.node_fair_weight[paths]
    share = torch.where(w > 0, unw / torch.clamp(w, min=1e-30), 0.0)
    zwb = (w == 0) & (unw > 0)

    # FairSharingPrioritizeNonBorrowing: the leading tournament key
    # prefers subtrees NOT borrowing on the entry's requested
    # flavor-resources at this level (fair_sharing_iterator.go:180-193)
    fs_nonborrow = features.enabled("FairSharingPrioritizeNonBorrowing")
    prio_step = features.enabled("PrioritySortingWithinCohort")
    if fs_nonborrow:
        borrow_on_req = (((borrowed > 0) & (req_c[:, None, :] > 0))
                         .any(dim=2) & t.has_parent[paths])  # [C,D]

    # bottom-up winner propagation over the cohort forest
    prio = t.wl_prio[cand_w.long()]
    ets = ts[cand_w.long()]
    e_idx = arange(C, dev)
    win = torch.full((N1,), C, dtype=INT32, device=dev).index_put(
        (cq_nodes,), torch.where(active, e_idx, C))
    depth_cq = t.depth[cq_nodes]
    n_idx = arange(N1, dev)
    for d in range(D - 1, 0, -1):
        contend = (t.depth == d) & (win < C) & (n_idx != null_node)
        ec = torch.clamp(win, max=C - 1).long()
        # position of this node on the entry's path
        j = torch.clamp(depth_cq[ec] - d, 0, D - 1).long()
        seg = torch.where(contend, t.parent, null_node)
        # lexicographic segment-min: [not borrowing on the requested
        # resources first when gated,] zwb asc, value asc, -prio asc, ts
        # asc, entry index asc
        if fs_nonborrow:
            k_bor = _i32(torch.where(contend, borrow_on_req[ec, j], True))
            m_b = segment_min(k_bor, seg, N1)
            contend = contend & (k_bor == m_b[seg.long()])
        z = zwb[ec, j]
        k_zwb = _i32(torch.where(contend, z, True))
        k_val = torch.where(contend, torch.where(z, unw[ec, j], share[ec, j]),
                            float("inf"))
        # the priority tie-break is gated like the host's step 3 (a
        # constant key = a skipped step)
        k_prio = (torch.where(contend, -prio[ec], BIG) if prio_step
                  else torch.zeros_like(prio[ec]))
        k_ts = torch.where(contend, ets[ec], BIG)
        segl = seg.long()
        m_z = segment_min(k_zwb, seg, N1)
        c1 = contend & (k_zwb == m_z[segl])
        m_v = segment_min(torch.where(c1, k_val, float("inf")), seg, N1)
        c2 = c1 & (k_val == m_v[segl])
        m_p = segment_min(torch.where(c2, k_prio, BIG), seg, N1)
        c3 = c2 & (k_prio == m_p[segl])
        m_t = segment_min(torch.where(c3, k_ts, BIG), seg, N1)
        c4 = c3 & (k_ts == m_t[segl])
        m_e = segment_min(torch.where(c4, _i32(ec), C), seg, N1)
        win = torch.where((t.depth == d - 1) & (m_e < C) & ~t.is_cq, m_e,
                          win)

    # the host pops from the FIRST remaining entry's root tree; [1]
    # index tensors (a 0-d index would be read back to the host)
    first_e = torch.where(active, e_idx, C).amin(dim=0, keepdim=True)
    fc = torch.clamp(first_e, max=C - 1).long()
    # a parentless CQ's entry wins directly
    winner = torch.where(t.has_parent[t.cq_node[fc].long()],
                         win[t.cq_root[fc].long()], first_e)
    return torch.where(first_e < C, winner, C)[0]

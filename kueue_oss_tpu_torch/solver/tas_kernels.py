"""TAS placement on the device: dense per-level capacity tensors.

Port of ``kueue_oss_tpu/solver/tas_kernels.py`` (the extended placer and
its sequential drain). The topology tree (block -> rack -> host) becomes
one dense int32 array per level: ``parents[l][d]`` indexes level l-1;
leaf capacities are a [D_leaf, R] matrix. Placement of one podset:

  phase 1 (fillInCounts, tas_flavor_snapshot.go:1568-1719): the leaf
    pass (``leaf_fn``: by default ``cuda_tas.leaf_states``, the CUDA
    kernel) then one segment reduction per level for pods, slices and
    leader states;
  phase 2 (findLevelWithFitDomains + updateCountsToMinimumGeneric,
    :1236-1469): pick the start level/domain, then descend minimizing
    the number of domains per sibling group.

Each ``jax.jit`` closure of the JAX module is a plain function here; the
``lax.scan`` of the sequential placer is a Python loop over admissions
with the capacity carry on the device. This is the plain version of
``cuda_tas.tas_place_sequential``, which runs the whole loop in one
kernel launch. Per-step scalars (count, levels,
flags) are 0-d device tensors, so a step makes no host synchronisation.
Every integer stays int32 and wraps like the JAX program.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from kueue_oss_tpu_torch.solver import cuda_tas
from kueue_oss_tpu_torch.solver.ops import (
    INT32,
    arange,
    cummax,
    cumsum,
    floor_div,
    lexsort,
    segment_max,
    segment_min,
    segment_sum,
    sum_i32,
)

BIG = 1 << 30


@dataclass
class TASLevels:
    """Dense tree: level l has D_l domains ordered lexicographically by
    their level values; parents[l] maps into level l-1 (parents[0]=0)."""

    parents: list[np.ndarray]          # per level: [D_l] int32
    leaf_capacity: np.ndarray          # [D_leaf, R] int32
    leaf_names: list[tuple[str, ...]]  # decode table
    resources: list[str]


def build_levels(snapshot) -> TASLevels:
    """Flatten a TASFlavorSnapshot's domain tree (lex order per level,
    matching buildAssignment's sort)."""
    levels = []
    for l in range(len(snapshot.levels)):
        doms = sorted(snapshot.domains_per_level[l].values(),
                      key=lambda d: d.level_values)
        levels.append(doms)
    index = [{d.id: i for i, d in enumerate(doms)} for doms in levels]
    parents = []
    for l, doms in enumerate(levels):
        if l == 0:
            parents.append(np.zeros(len(doms), dtype=np.int32))
        else:
            parents.append(np.asarray(
                [index[l - 1][d.id[:-1]] for d in doms], dtype=np.int32))
    resources = sorted({r for d in levels[-1] for r in d.free_capacity})
    cap = np.zeros((len(levels[-1]), max(1, len(resources))),
                   dtype=np.int64)
    for i, d in enumerate(levels[-1]):
        for j, r in enumerate(resources):
            cap[i, j] = max(0, d.free_capacity.get(r, 0)
                            - d.tas_usage.get(r, 0))
    return TASLevels(
        parents=parents,
        leaf_capacity=np.minimum(cap, BIG).astype(np.int32),
        leaf_names=[d.id for d in levels[-1]],
        resources=resources,
    )


def fill_counts_ext(parents, leaf_capacity, per_pod, leader_per_pod,
                    has_leader, slice_size, slice_level,
                    leaf_fn=cuda_tas.leaf_states):
    """Phase 1 with slice and leader states (fillInCounts +
    fillInCountsHelper). ``parents`` are device int32 tensors;
    ``has_leader``/``slice_size``/``slice_level`` 0-d device tensors.

    Returns per level l a dict with st (pods), swl (pods with the leader
    hosted somewhere below), ls (leader capacity 0/1), ss (slices), sswl
    (slices with leader). ``leaf_fn`` is the leaf pass: the CUDA kernel
    by default, ``cuda_tas.leaf_states_reference`` for an all-PyTorch
    placer.
    """
    n_levels = len(parents)
    st, swl, ls = leaf_fn(leaf_capacity, per_pod, leader_per_pod,
                          has_leader)
    ss_div = torch.clamp(slice_size, min=1)
    leaf_l = n_levels - 1
    at_sl = slice_level == leaf_l
    ss = torch.where(at_sl, floor_div(st, ss_div), 0)
    sswl = torch.where(at_sl, floor_div(swl, ss_div), 0)
    out = {leaf_l: dict(st=st, swl=swl, ls=ls, ss=ss, sswl=sswl)}

    for l in range(n_levels - 1, 0, -1):
        n_up = parents[l - 1].shape[0]
        seg = parents[l]
        c = out[l]
        total = segment_sum(c["st"], seg, n_up)
        slice_total = segment_sum(c["ss"], seg, n_up)
        # leader contributors: children able to host the leader (or no
        # leader requested at all)
        contrib = ~has_leader | (c["ls"] > 0)
        any_contrib = segment_max(contrib.to(INT32), seg, n_up) > 0
        state_diff = torch.where(contrib, c["st"] - c["swl"], BIG)
        slice_diff = torch.where(contrib, c["ss"] - c["sswl"], BIG)
        min_sd = segment_min(state_diff, seg, n_up)
        min_ssd = segment_min(slice_diff, seg, n_up)
        ls_up = segment_max(c["ls"], seg, n_up)
        swl_up = torch.where(any_contrib, total - min_sd, 0)
        sswl_up = torch.where(any_contrib, slice_total - min_ssd, 0)
        at_sl = slice_level == (l - 1)
        ss_up = torch.where(at_sl, floor_div(total, ss_div), slice_total)
        sswl_up = torch.where(at_sl, floor_div(swl_up, ss_div), sswl_up)
        out[l - 1] = dict(st=total, swl=swl_up, ls=ls_up, ss=ss_up,
                          sswl=sswl_up)
    return out


def _unit_views(c, l, slice_level):
    """Unit-space (u_state, u_swl) at level l: slices at or above the
    slice level, pods below."""
    in_slices = slice_level >= l
    u_state = torch.where(in_slices, c["ss"], c["st"])
    u_swl = torch.where(in_slices, c["sswl"], c["swl"])
    return u_state, u_swl


def _greedy_segment_lead(c, l, slice_level, seg, need_of_seg, lead_of_seg,
                         n_seg, least_free):
    """Per sibling group: route the (0/1) leader, then minimize domains
    (updateCountsToMinimumGeneric + consumeWithLeadersGeneric).
    ``need_of_seg`` is in the level's units. Returns (take [D] units,
    lead_take [D] bool)."""
    u_state, u_swl = _unit_views(c, l, slice_level)
    ss_key = c["ss"]
    st_key = c["st"]
    ls = c["ls"]
    D = u_state.shape[0]
    idx = arange(D, u_state.device)
    seg_l = seg.long()
    need = need_of_seg[seg_l]
    lead_here = lead_of_seg[seg_l]

    # ---- leader domain (sortedDomainsWithLeader order) ----------------
    sswl_key = torch.where(least_free, c["sswl"], -c["sswl"])
    k1 = -ls
    m1 = segment_min(torch.where(lead_here, k1, BIG), seg, n_seg)
    c1 = lead_here & (k1 == m1[seg_l])
    m2 = segment_min(torch.where(c1, sswl_key, BIG), seg, n_seg)
    c2 = c1 & (sswl_key == m2[seg_l])
    m3 = segment_min(torch.where(c2, c["swl"], BIG), seg, n_seg)
    c3 = c2 & (c["swl"] == m3[seg_l])
    top_lead = segment_min(torch.where(c3, idx, BIG), seg, n_seg)  # [S]
    top_of = torch.clamp(top_lead[seg_l], max=D - 1).long()
    top_fits = (u_swl[top_of] >= need) & (ls[top_of] > 0)
    # best-fit swap over u_swl when the top fits everything and we are
    # not least-free
    elig_bf = lead_here & (ls > 0) & (u_swl >= need) & top_fits & (
        ~least_free)
    bf_min = segment_min(torch.where(elig_bf, u_swl, BIG), seg, n_seg)
    is_bf = elig_bf & (u_swl == bf_min[seg_l])
    bf_first = segment_min(torch.where(is_bf, idx, BIG), seg, n_seg)
    lead_dom = torch.where(bf_first < BIG, bf_first, top_lead)  # [S]
    has_lead_dom = (lead_dom < BIG) & lead_of_seg & (
        segment_max(ls, seg, n_seg) > 0)
    lead_dom_c = torch.clamp(lead_dom, max=D - 1)
    is_lead = (idx == lead_dom_c[seg_l]) & has_lead_dom[seg_l]
    lead_take_units = torch.where(is_lead, torch.minimum(u_swl, need), 0)

    # ---- the rest: normal greedy on remaining need --------------------
    taken = segment_sum(lead_take_units, seg, n_seg)
    rest_need = torch.clamp(need_of_seg - taken, min=0)
    state_rest = torch.where(is_lead, 0, u_state)
    # ordering: (±slice_state, state, idx); leader domain excluded
    ss_sort = torch.where(least_free, ss_key, -ss_key)
    key = torch.where(is_lead, BIG, 0).to(INT32)
    order = lexsort((idx, st_key, ss_sort, key, seg)).long()
    take_sorted = _consume_in_order(state_rest[order], seg[order],
                                    rest_need, n_seg)
    take = torch.zeros_like(u_state).index_copy_(0, order, take_sorted)
    return take + lead_take_units, is_lead


def _consume_in_order(s_sorted, seg_sorted, need_of_seg, n_seg):
    """updateCountsToMinimumGeneric on a pre-sorted domain sequence:
    take full domains until the remainder fits one, then best-fit the
    remainder (a no-op refinement under least-free ascending order)."""
    D = s_sorted.shape[0]
    idx = arange(D, s_sorted.device)
    seg_l = seg_sorted.long()
    need = need_of_seg[seg_l]
    csum = cumsum(s_sorted)
    is_start = torch.ones(D, dtype=torch.bool, device=s_sorted.device)
    is_start[1:] = seg_sorted[1:] != seg_sorted[:-1]
    base = torch.where(is_start, csum - s_sorted, 0)
    base = cummax(torch.where(is_start, base, -1))
    prefix_excl = csum - s_sorted - base
    remaining = torch.clamp(need - prefix_excl, min=0)
    covers = (s_sorted >= remaining) & (remaining > 0)
    pos_cover = torch.where(covers, idx, BIG)
    q = segment_min(pos_cover, seg_sorted, n_seg)
    q_of = q[seg_l]
    full_take = torch.where((idx < q_of) & (remaining > 0), s_sorted, 0)
    rem_at_q = torch.where(idx == q_of, remaining, 0)
    rem_of_seg = segment_max(rem_at_q, seg_sorted, n_seg)
    r = rem_of_seg[seg_l]
    elig = (idx >= q_of) & (s_sorted >= r) & (r > 0)
    s_min = segment_min(torch.where(elig, s_sorted, BIG), seg_sorted, n_seg)
    is_best = elig & (s_sorted == s_min[seg_l])
    first_best = segment_min(torch.where(is_best, idx, BIG), seg_sorted,
                             n_seg)
    bf_take = torch.where(idx == first_best[seg_l], r, 0)
    return full_take + bf_take


def make_placer_ext(parents_np: list[np.ndarray], device,
                    leaf_fn=cuda_tas.leaf_states):
    """Placer with slice + leader support for one tree shape.

    ``place(leaf_capacity, per_pod, count, requested_level, required,
    unconstrained, least_free, slice_size, slice_level, leader_per_pod,
    has_leader)`` — tensors on ``device``, scalars as 0-d tensors —
    returns (worker_leaf_sel [D_leaf] pods, leader_leaf int32 (-1 when
    none), feasible bool). Covers findTopologyAssignment for
    single-layer slices and a count-1 leader podset
    (tas_flavor_snapshot.go:804-999).
    """
    parents = [torch.as_tensor(np.asarray(p, dtype=np.int32), device=device)
               for p in parents_np]
    n_levels = len(parents)
    aranges = [arange(p.shape[0], device) for p in parents]

    def place(leaf_capacity, per_pod, count, requested_level, required,
              unconstrained, least_free, slice_size, slice_level,
              leader_per_pod, has_leader):
        cs = fill_counts_ext(parents, leaf_capacity, per_pod,
                             leader_per_pod, has_leader, slice_size,
                             slice_level, leaf_fn)
        ss_div = torch.clamp(slice_size, min=1)
        slice_count = floor_div(count, ss_div)

        def units_at(l):
            # placement units at level l (need conversions cross SL)
            return torch.where(slice_level >= l, slice_count, count)

        # ---- findLevelWithFitDomains at the requested level, walking
        # up for preferred requests ------------------------------------
        # device fills, not host copies: a step never waits on the stream
        chosen_level = torch.full((), -1, dtype=INT32, device=device)
        chosen_dom = torch.zeros((), dtype=INT32, device=device)
        for l in range(n_levels - 1, -1, -1):
            c = cs[l]
            u_state, u_swl = _unit_views(c, l, slice_level)
            nd = units_at(l)
            ok_lead = (c["ls"] > 0) | ~has_leader
            # least-free still must hold the leader when one exists
            fits = torch.where(least_free & ~has_leader, u_state >= nd,
                               (u_swl >= nd) & ok_lead)
            key_lf = torch.where(fits, aranges[l], BIG)
            key_bf = torch.where(fits, u_swl, BIG)
            d_lf = torch.argmin(key_lf).to(INT32)
            d_bf = torch.argmin(key_bf).to(INT32)
            d = torch.where(least_free, d_lf, d_bf)
            okl = fits.any()
            allowed = torch.where(required | unconstrained,
                                  requested_level == l,
                                  requested_level >= l)
            hit = okl & allowed & (chosen_level < 0) & (
                requested_level >= l)
            chosen_level = torch.where(hit, l, chosen_level)
            chosen_dom = torch.where(hit & (chosen_level == l), d,
                                     chosen_dom)
        single_fit = chosen_level >= 0

        # ---- seed: single domain, or greedy multi-domain -------------
        sel = [torch.zeros_like(cs[l]["st"]) for l in range(n_levels)]
        lead = [torch.zeros(cs[l]["st"].shape, dtype=torch.bool,
                            device=device) for l in range(n_levels)]
        feasible = torch.zeros((), dtype=torch.bool, device=device)
        greedy_level = torch.where(unconstrained, requested_level, 0)
        for l in range(n_levels):
            c = cs[l]
            is_single = single_fit & (chosen_level == l)
            one_hot = aranges[l] == chosen_dom
            seed_single = torch.where(one_hot, units_at(l), 0)
            seed_lead = one_hot & has_leader
            seg = torch.zeros_like(c["st"])
            g, gl = _greedy_segment_lead(
                c, l, slice_level, seg, units_at(l).reshape(1),
                has_leader.reshape(1), 1, least_free)
            u_state, u_swl = _unit_views(c, l, slice_level)
            cap_ok = torch.where(
                has_leader,
                (sum_i32(torch.where(gl, u_swl, u_state)) >= units_at(l))
                & (gl.any() | ~has_leader),
                sum_i32(u_state) >= units_at(l))
            use_greedy = (~single_fit) & (greedy_level == l) & ~required
            sel[l] = torch.where(is_single, seed_single,
                                 torch.where(use_greedy & cap_ok, g, sel[l]))
            lead[l] = torch.where(is_single, seed_lead & has_leader,
                                  torch.where(use_greedy & cap_ok,
                                              gl & has_leader, lead[l]))
            feasible = feasible | is_single | (use_greedy & cap_ok)
        start = torch.where(single_fit, chosen_level, greedy_level)

        # ---- descend --------------------------------------------------
        for l in range(n_levels - 1):
            par = parents[l + 1]
            n_par = cs[l]["st"].shape[0]
            # parents at or above SL hold slices, children below pods
            below_sl = slice_level < (l + 1)
            need_par = torch.where(below_sl & (slice_level >= l),
                                   sel[l] * ss_div, sel[l])
            computed, comp_lead = _greedy_segment_lead(
                cs[l + 1], l + 1, slice_level, par, need_par, lead[l],
                n_par, least_free)
            keep = start >= (l + 1)
            sel[l + 1] = torch.where(keep, sel[l + 1], computed)
            lead[l + 1] = torch.where(keep, lead[l + 1], comp_lead)

        leaf = n_levels - 1
        leaf_pods = torch.where(slice_level >= leaf, sel[leaf] * ss_div,
                                sel[leaf])
        total_ok = sum_i32(leaf_pods) == count
        feasible = feasible & total_ok & (~has_leader | lead[leaf].any())
        leader_leaf = torch.where(
            has_leader & feasible,
            torch.argmax(lead[leaf].to(INT32)).to(INT32), -1)
        return leaf_pods, leader_leaf, feasible

    return place


def make_sequential_placer_ext(parents_np: list[np.ndarray], device,
                               leaf_fn=cuda_tas.leaf_states):
    """Sequential device drain through the slice/leader-capable placer:
    M podsets placed one after another, the leaf-capacity carry updated
    in between (worker pods and the leader's row). Inputs are [M, ...]
    device tensors; returns (sels [M, D_leaf], leads [M], oks [M],
    leaf_capacity_after). ``leaf_fn`` as in ``fill_counts_ext``."""
    place = make_placer_ext(parents_np, device, leaf_fn)

    def place_all(leaf_capacity, per_pod, count, level, required,
                  unconstrained, least_free, slice_size, slice_level,
                  leader_per_pod, has_leader):
        cap = leaf_capacity
        D = cap.shape[0]
        leaf_idx = arange(D, cap.device)
        sels, leads, oks = [], [], []
        for m in range(per_pod.shape[0]):
            pp, hl, lpp = per_pod[m], has_leader[m], leader_per_pod[m]
            sel, lead_leaf, ok = place(
                cap, pp, count[m], level[m], required[m], unconstrained[m],
                least_free[m], slice_size[m], slice_level[m], lpp, hl)
            take = torch.where(ok, sel, 0)
            cap = cap - take[:, None] * pp[None, :]
            lead_onehot = (leaf_idx == lead_leaf) & ok & hl
            cap = cap - torch.where(lead_onehot[:, None], lpp[None, :], 0)
            sels.append(sel * ok.to(sel.dtype))
            leads.append(torch.where(ok, lead_leaf, -1))
            oks.append(ok)
        if not sels:
            return (torch.zeros((0, D), dtype=INT32, device=cap.device),
                    torch.zeros(0, dtype=INT32, device=cap.device),
                    torch.zeros(0, dtype=torch.bool, device=cap.device),
                    cap)
        return torch.stack(sels), torch.stack(leads), torch.stack(oks), cap

    return place_all

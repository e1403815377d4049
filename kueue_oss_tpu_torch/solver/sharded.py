"""Mesh drains: workloads block-sharded over a single-process mesh.

Port of ``kueue_oss_tpu/solver/sharded.py``. The workload axis (the
dimension that grows: backlogs of 10^5-10^7 entries) is block-sharded
over the mesh's ``wl`` axis (``meshutil.MeshTensors``); the node / quota
state is replicated.

- **Lean drain** (``make_sharded_drain``, JAX :146-310). Each round
  makes three collectives through ``meshutil``:

  1. per-CQ head rank: ``pmin`` over the shards' [C] segment minima;
  2. per-CQ head index: ``pmin`` over a [C] vector (two-pass argmin);
  3. candidate payload: ``psum`` of the [C, K, F] request rows and the
     [C] metadata (each head lives on exactly one shard).

  The nomination and the entry scan over the C candidate rows are
  replicated state (they touch only [C]- and [N, F]-sized tensors); the
  port runs them once, on the mesh's first device, and broadcasts their
  [C] results, where JAX's ``shard_map`` runs them on every device. Each
  shard then updates the plan of its own rows. Per-round collective
  volume is ~C*K*F ints whatever the backlog size, and the result is the
  whole ``solve_backlog`` contract (admitted, opt, admit_round, parked,
  rounds, usage), bit-identical to the single-device drain on the same
  padded problem.
- **FULL drain** (``solve_backlog_full_sharded``, JAX :390-439): the
  [W+1] fields (``full_kernels.FULL_WL_FIELDS``) live block-sharded
  between drains; a drain joins them once through ``all_gather`` on the
  first device (the rows the round's bookkeeping gathers under GSPMD),
  and the victim searches, the round's dominant cost, split their lane
  axis over the shards (``full_kernels._run_searches``).
- **Relaxed LP** (``make_sharded_relax_lp``, JAX :313-338): the row
  fields and x block-shard; each iteration's only collective is one
  ``psum`` of the [C, F] per-ClusterQueue load, added in shard order.
  On the card both per-shard steps are hand kernels
  (``cuda_relax.relax_lp_shard_load`` / ``relax_lp_shard_step``).

Sharded code never runs the unsharded drain and slices its result: the
workload axis is joined only through ``meshutil.all_gather``.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from kueue_oss_tpu_torch.solver import meshutil
from kueue_oss_tpu_torch.solver.kernels import (
    M_NOFIT,
    ProblemTensors,
    _round_scan,
    available_all,
    host_tensors,
    nominate,
    potential_available_all,
    refresh_cohort_usage,
)
from kueue_oss_tpu_torch.solver.meshutil import Mesh, MeshTensors
from kueue_oss_tpu_torch.solver.ops import INT32, arange, segment_min
from kueue_oss_tpu_torch.solver.tensors import BIG as _BIG, SolverProblem

BIG = int(_BIG)

#: the lean ProblemTensors fields on the workload axis (block-sharded);
#: every other field is replicated
LEAN_WL_FIELDS = ("wl_cqid", "wl_rank", "wl_prio", "wl_ts", "wl_uid",
                  "wl_req", "wl_valid")


def pad_workloads(p: SolverProblem, multiple: int) -> SolverProblem:
    """Pad the lean workload axis so (W+1) divides evenly over the mesh.

    Padding rows follow the null row and replicate it (rank BIG, the null
    CQ id, no options), so they are never selected as heads; ``wl_uid``
    pads with BIG (a real uid-0 row must stay distinguishable from
    padding).
    """
    W1 = p.wl_cqid.shape[0]
    target = ((W1 + multiple - 1) // multiple) * multiple
    pad = target - W1
    if pad == 0:
        return p
    C = p.cq_node.shape[0]

    def pad1(a, fill):
        widths = [(0, pad)] + [(0, 0)] * (a.ndim - 1)
        return np.pad(a, widths, constant_values=fill)

    return dataclasses.replace(
        p,
        wl_cqid=pad1(p.wl_cqid, C),
        wl_rank=pad1(p.wl_rank, BIG),
        wl_prio=pad1(p.wl_prio, 0),
        wl_ts=pad1(p.wl_ts, 0),
        wl_uid=pad1(p.wl_uid, BIG),
        wl_req=pad1(p.wl_req, 0),
        wl_valid=pad1(p.wl_valid, False),
    )


def place_lean_tensors(host: ProblemTensors, mesh: Mesh) -> MeshTensors:
    """Mesh-place lean host arrays: workload rows block-sharded,
    tree / CQ state replicated. The padded axis must divide evenly
    (``meshutil.align_pad_target``)."""
    return meshutil.place(host, mesh, LEAN_WL_FIELDS)


def _placeable(problem: SolverProblem, mesh, min_rows: int) -> bool:
    return (mesh is not None
            and meshutil.mesh_divisible(mesh, problem.wl_cqid.shape[0])
            and meshutil.live_rows(problem.wl_cqid,
                                   problem.n_cqs) >= min_rows)


def maybe_place_lean(host: ProblemTensors, problem: SolverProblem, mesh,
                     min_rows: int = 0):
    """Mesh-place lean tensors when the policy allows: a mesh exists,
    the padded axis divides evenly, and the live row count clears
    ``min_rows``. One policy, shared by the resident device state and
    the engine's sessionless path. Returns (MeshTensors or None,
    placed)."""
    if not _placeable(problem, mesh, min_rows):
        return None, False
    return place_lean_tensors(host, mesh), True


def _local_heads(tl: ProblemTensors, C: int, w_offset: int, admitted,
                 parked):
    """Per-CQ (min rank, head index) over one shard's rows. Empty
    segments hold INT32_MAX, as JAX's segment_min. The padding id C
    gathers its own segment (JAX clamps it to C-1, which changes only
    segment C's heads, and those are dropped)."""
    B = tl.wl_rank.shape[0]
    pending = ~admitted & ~parked
    rank_eff = torch.where(pending, tl.wl_rank, BIG)
    min_rank = segment_min(rank_eff, tl.wl_cqid, C + 1)
    w_global = arange(B, rank_eff.device) + w_offset
    is_head = rank_eff == min_rank[tl.wl_cqid.long()]
    head_w = segment_min(torch.where(is_head & pending, w_global, BIG),
                         tl.wl_cqid, C + 1)[:C]
    return min_rank[:C], head_w


def _scatter_max(x: torch.Tensor, idx: torch.Tensor,
                 vals: torch.Tensor) -> torch.Tensor:
    """``x.at[idx].max(vals)``: repeated indices keep the largest value
    (bool through int32), in any order."""
    if x.dtype == torch.bool:
        return x.to(INT32).scatter_reduce(
            0, idx, vals.to(INT32), "amax", include_self=True).bool()
    return x.scatter_reduce(0, idx, vals.to(x.dtype), "amax",
                            include_self=True)


def make_sharded_drain(mesh: Mesh):
    """The lean mesh drain: call with ``MeshTensors`` of a padded
    problem whose workload axis divides evenly; returns the whole
    solve_backlog tuple (admitted, opt, admit_round, parked, rounds,
    usage) on the first device, bit-identical to the single-device drain
    on the same padded problem."""
    n = mesh.size

    def drain(mt: MeshTensors):
        if not isinstance(mt, MeshTensors) or mt.mesh != mesh:
            raise ValueError("the lean mesh drain takes tensors placed on "
                             "its mesh (sharded.place_lean_tensors)")
        shards = mt.shards
        tl0 = shards[0]
        lead = mesh.lead
        C = tl0.cq_node.shape[0]
        B = mt.block
        W1 = B * n
        K, F = tl0.wl_req.shape[1], tl0.wl_req.shape[2]
        offsets = [s * B for s in range(n)]
        pot = potential_available_all(tl0)
        cq_ids = arange(C, lead)
        null_int = torch.zeros(1, dtype=INT32, device=lead)

        usage = tl0.usage0
        admitted = [torch.zeros(B, dtype=torch.bool, device=d)
                    for d in mesh.devices]
        parked = [a.clone() for a in admitted]
        opt = [torch.zeros(B, dtype=INT32, device=d) for d in mesh.devices]
        admit_round = [torch.full((B,), -1, dtype=INT32, device=d)
                       for d in mesh.devices]
        cursor_c = torch.zeros(C + 1, dtype=INT32, device=lead)
        prev_head = torch.full((C,), BIG, dtype=INT32, device=lead)
        rounds = 0
        progress = True
        while progress and rounds < W1 + C + 2:
            # head selection across shards: two pmins
            heads = [_local_heads(sh, C, off, adm, prk) for sh, off, adm,
                     prk in zip(shards, offsets, admitted, parked)]
            min_rank = meshutil.pmin(mesh, [h[0] for h in heads])
            head_w = meshutil.pmin(mesh, [
                torch.where(h[0] == mr, h[1], BIG)
                for h, mr in zip(heads, min_rank)])

            # candidate payload: psum of each shard's one-hot rows
            mine, lws = [], []
            pay = {"req": [], "valid": [], "prio": [], "ts": [], "uid": []}
            for sh, off, mr, hw in zip(shards, offsets, min_rank, head_w):
                local_w = hw - off
                m = (mr < BIG) & (local_w >= 0) & (local_w < B)
                lw = torch.clamp(local_w, 0, B - 1).long()
                mine.append(m)
                lws.append(lw)
                pay["req"].append(torch.where(m[:, None, None],
                                              sh.wl_req[lw], 0))
                pay["valid"].append(torch.where(
                    m[:, None], sh.wl_valid[lw], False).to(INT32))
                pay["prio"].append(torch.where(m, sh.wl_prio[lw], 0))
                pay["ts"].append(torch.where(m, sh.wl_ts[lw], 0))
                pay["uid"].append(torch.where(m, sh.wl_uid[lw], 0))
            req_c = meshutil.psum(mesh, pay["req"])[0]
            valid_c = meshutil.psum(mesh, pay["valid"])[0] > 0
            prio_c = meshutil.psum(mesh, pay["prio"])[0]
            ts_c = meshutil.psum(mesh, pay["ts"])[0]
            uid_c = meshutil.psum(mesh, pay["uid"])[0]

            # replicated nomination and entry scan over the candidate
            # rows (candidates map 1:1 to CQ slots), once on the lead
            has_head = min_rank[0] < BIG
            hw0 = head_w[0]
            t_cand = tl0._replace(
                wl_cqid=torch.cat([cq_ids, null_int + C]),
                wl_rank=torch.cat([torch.where(has_head, min_rank[0], BIG),
                                   null_int + BIG]),
                wl_prio=torch.cat([prio_c, null_int]),
                wl_ts=torch.cat([ts_c, null_int.to(ts_c.dtype)]),
                wl_uid=torch.cat([uid_c, null_int]),
                wl_req=torch.cat([req_c, torch.zeros(
                    (1, K, F), dtype=req_c.dtype, device=lead)]),
                wl_valid=torch.cat([valid_c, torch.zeros(
                    (1, K), dtype=torch.bool, device=lead)]),
            )
            cand_idx = torch.where(has_head, cq_ids, C).to(INT32)
            # the flavor cursor belongs to a workload: reset it when a
            # CQ's head changed since the last round
            same_head = hw0 == prev_head
            cursor_eff = torch.cat([torch.where(same_head, cursor_c[:C], 0),
                                    null_int])
            avail = available_all(tl0, usage)
            mode, k_chosen, borrow, next_cursor = nominate(
                t_cand, usage, avail, pot, cand_idx, cursor_eff)
            park_now = has_head & (mode == M_NOFIT) & ~(tl0.cq_strict
                                                       & has_head)
            adm_c = torch.zeros(C + 1, dtype=torch.bool, device=lead)
            # JAX writes park_now at cand_idx: heads at their own slot,
            # every other entry (False) at slot C
            park_c = torch.cat([park_now, torch.zeros(
                1, dtype=torch.bool, device=lead)])
            cq_usage, adm_c, park_c, any_admitted = _round_scan(
                t_cand, usage, usage, adm_c, park_c, cand_idx, mode,
                k_chosen, borrow)
            usage = refresh_cohort_usage(tl0, cq_usage)
            adm_slot = adm_c[:C]
            park_slot = park_c[:C]
            keep = has_head & ~adm_slot
            cursor_next = torch.where(keep, next_cursor, 0)
            cursor_changed = (has_head & (cursor_next != cursor_eff[:C])
                              ).any()
            cursor_c = torch.cat([cursor_next.to(INT32), cursor_c[C:]])
            prev_head = hw0

            # each shard updates the plan of its own rows (scatter-max:
            # clipped indices of slots a shard does not own write the
            # inert fill)
            for s, (adm_s, park_s, k_s) in enumerate(zip(
                    meshutil.broadcast(mesh, adm_slot),
                    meshutil.broadcast(mesh, park_slot),
                    meshutil.broadcast(mesh, k_chosen))):
                newly = mine[s] & adm_s
                admitted[s] = _scatter_max(admitted[s], lws[s], newly)
                parked[s] = _scatter_max(parked[s], lws[s],
                                         mine[s] & park_s)
                opt[s] = _scatter_max(opt[s], lws[s],
                                      torch.where(newly, k_s, 0))
                admit_round[s] = _scatter_max(
                    admit_round[s], lws[s], torch.where(newly, rounds, -1))
            progress_t = (any_admitted | (park_slot & has_head).any()
                          | cursor_changed)
            progress = bool(progress_t.item())
            rounds += 1
        return (meshutil.all_gather(mesh, admitted)[0],
                meshutil.all_gather(mesh, opt)[0],
                meshutil.all_gather(mesh, admit_round)[0],
                meshutil.all_gather(mesh, parked)[0],
                torch.tensor(rounds, dtype=INT32, device=lead), usage)

    return drain


def solve_backlog_sharded(problem: SolverProblem, mesh: Mesh):
    """Pad, place and drain a lean problem over the mesh. Returns the
    plan on the host, sliced back to the caller's rows: (admitted [W+1]
    bool, opt [W+1] int32, admit_round [W+1] int32, parked [W+1] bool,
    rounds int, usage [N+1, F]), the ``solve_backlog`` contract."""
    padded = pad_workloads(problem, mesh.size)
    t = place_lean_tensors(host_tensors(padded), mesh)
    admitted, opt, admit_round, parked, rounds, usage = (
        meshutil.host_replicated(meshutil.lean_mesh_solver(mesh)(t)))
    W1 = problem.wl_cqid.shape[0]
    admitted = admitted[:W1].copy()
    parked = parked[:W1].copy()
    opt = opt[:W1].copy()
    admit_round = admit_round[:W1].copy()
    admitted[-1] = False
    parked[-1] = False
    return admitted, opt, admit_round, parked, int(rounds), usage


# ---------------------------------------------------------------------------
# FULL drain
# ---------------------------------------------------------------------------


def place_full_tensors(host, mesh: Mesh) -> MeshTensors:
    """Mesh-place FULL host arrays: the workload-axis fields
    (``full_kernels.FULL_WL_FIELDS``) block-sharded, everything else
    replicated. The padded axis must divide evenly."""
    from kueue_oss_tpu_torch.solver.full_kernels import FULL_WL_FIELDS

    return meshutil.place(host, mesh, FULL_WL_FIELDS)


def maybe_place_full(host, problem: SolverProblem, mesh, min_rows: int = 0):
    """Mesh-place FULL tensors under ``maybe_place_lean``'s policy.
    Returns (MeshTensors or None, placed)."""
    if not _placeable(problem, mesh, min_rows):
        return None, False
    return place_full_tensors(host, mesh), True


def solve_backlog_full_sharded(problem: SolverProblem, mesh: Mesh,
                               g_max: int, h_max: int = 32,
                               p_max: int = 128, fs_enabled: bool = False,
                               round_cap: int = 0, stats=None):
    """The preemption-capable drain over the mesh, row- and
    lane-sharded: the rows block-shard between drains, and the victim
    searches split their lane axis over the shards.

    Padding inserts inert null-row replicas BEFORE the final null row
    (``tensors.pad_workloads``), so every write addressed to the null
    row lands where the single-device drain puts it, and the result is
    unpadded: it equals ``solve_backlog_full`` bit for bit, uneven row
    counts included. Returns the 8 outputs as host numpy arrays.
    """
    from kueue_oss_tpu_torch.solver.full_kernels import (
        host_tensors_full,
        solve_backlog_full,
    )
    from kueue_oss_tpu_torch.solver.tensors import pad_workloads as pad_rows

    W1 = problem.wl_cqid.shape[0]
    target_w = W1 - 1 + ((-W1) % mesh.size)
    padded = pad_rows(problem, target_w)
    t = place_full_tensors(host_tensors_full(padded), mesh)
    afs = (padded.cq_afs is not None
           and bool(np.asarray(padded.cq_afs).any()))
    out = meshutil.host_replicated(solve_backlog_full(
        t, g_max, h_max, p_max, round_cap=round_cap, stats=stats,
        fs_enabled=fs_enabled, afs=afs, mesh=mesh))
    if target_w + 1 == W1:
        return out

    def unpad(a):
        # real rows kept their indices; the null row moved to the end
        return np.concatenate([a[: W1 - 1], a[-1:]])

    admitted, opt, admit_round, parked, rounds, usage, wl_usage, vr = out
    return (unpad(admitted), unpad(opt), unpad(admit_round),
            unpad(parked), rounds, usage, unpad(wl_usage), unpad(vr))


# ---------------------------------------------------------------------------
# Relaxed LP
# ---------------------------------------------------------------------------

#: RelaxLP fields on the workload axis (x shards with them)
RELAX_WL_FIELDS = ("r", "s", "live", "wl_cqid")


def make_sharded_relax_lp(mesh: Mesh, iters: int):
    """The mesh-sharded projected-gradient LP of the relaxed arm: call
    with the host ``RelaxLP`` (``relax.build_lp``) of a problem whose
    row count divides by the mesh width; returns x [W+1] float32 on the
    first device. Per iteration each shard sums its rows' [C, F] load
    (``cuda_relax.relax_lp_shard_load``), ``meshutil.psum`` adds the
    loads in shard order, and each shard prices the tree and steps its
    rows (``cuda_relax.relax_lp_shard_step``). Equal to the
    single-device LP up to the float order of that sum."""
    from kueue_oss_tpu_torch.solver import cuda_relax
    from kueue_oss_tpu_torch.solver.relax import RelaxLP

    def run(lp: RelaxLP) -> torch.Tensor:
        mt = meshutil.place(lp, mesh, RELAX_WL_FIELDS)
        shards = mt.shards
        x = [torch.where(sh.live, 0.5, 0.0).to(torch.float32)
             for sh in shards]
        if lp.cq_node.shape[0] and iters:
            index = [cuda_relax.shard_index(lp, s, mesh.size, dev)
                     if dev.type == "cuda" else None
                     for s, dev in enumerate(mesh.devices)]
            for i in range(iters):
                loads = [cuda_relax.relax_lp_shard_load(sh, xs, ix)
                         for sh, xs, ix in zip(shards, x, index)]
                total = meshutil.psum(mesh, loads)
                x = [cuda_relax.relax_lp_shard_step(sh, xs, ld, i, iters,
                                                    ix)
                     for sh, xs, ld, ix in zip(shards, x, total, index)]
        return meshutil.all_gather(mesh, x)[0]

    return run

"""Batched solve layer: S counterfactual worlds, one batched drain.

A copy of ``kueue_oss_tpu/sim/batch.py``. The lean drain solves ONE
padded admission problem; this module stacks S scenario overlays of
that problem along a leading scenario axis and runs
``kernels.solve_backlog_batched`` (the same drain with an explicit
scenario axis), so S counterfactual admission cycles share every
round's launches. The lean drain is pure integer/boolean arithmetic and
the batched loop freezes finished lanes, so the batched plans are
**bit-identical** to solving each scenario alone — the sequential path
below is kept as the per-scenario oracle and the parity check is part
of the report.

Scenario-axis padding mirrors the JAX package's (a power of two, inert
repeats of scenario 0). The FULL-kernel sweeps run the preemption drain
(``full_kernels.solve_backlog_full_batched``) in chunks a
:class:`LaneBudget` sizes from a device-byte budget; rows past the
budget's cap go to the relax tier (``solve_scenarios_relax``: the S
scenarios' relaxed LPs in one launch of the relax kernel, then each
scenario's rounding and exact repair), always reported per row and in
the log and counted in ``metrics.whatif_retier_total``. With a solver
mesh (``meshutil.Mesh``) whose width divides the padded scenario axis,
``solve_scenarios`` block-shards the scenarios over it: each shard
solves its block with ``solve_backlog_batched`` on its device, and the
blocks join in scenario order (``meshutil.all_gather``); scenarios never
interact, so the plans are the unsharded batch's.
"""

from __future__ import annotations

import logging
import time
from dataclasses import dataclass, field
from typing import Optional

import numpy as np
import torch

from kueue_oss_tpu_torch import metrics

from kueue_oss_tpu_torch.device import resolve_device
from kueue_oss_tpu_torch.solver.kernels import (
    ProblemTensors,
    solve_backlog,
    solve_backlog_batched,
    to_device,
)
from kueue_oss_tpu_torch.solver.tensors import BIG, SolverProblem, pow2

log = logging.getLogger(__name__)


@dataclass
class BatchSolveResult:
    """Stacked plans for S scenarios (numpy, leading scenario axis)."""

    admitted: np.ndarray      # [S, W+1] bool
    opt: np.ndarray           # [S, W+1] int32
    admit_round: np.ndarray   # [S, W+1] int32
    parked: np.ndarray        # [S, W+1] bool
    rounds: np.ndarray        # [S] int32
    usage: np.ndarray         # [S, N+1, F] int32
    #: scenario-axis width actually dispatched (pow2-padded)
    batch_width: int = 0
    #: wall seconds of the batched drain, read-back included (reported,
    #: never part of the plan)
    solve_seconds: float = 0.0
    #: host reads of the drain: one per round (whether any lane is
    #: live) plus the final read-back
    host_reads: int = 0
    #: mesh width the scenario axis was sharded over (0 = one device)
    mesh_devices: int = 0

    def plan(self, i: int) -> tuple:
        return (self.admitted[i], self.opt[i], self.admit_round[i],
                self.parked[i], self.rounds[i], self.usage[i])


def stack_overlays(problem: SolverProblem, overlays: list[dict],
                   ) -> dict[str, np.ndarray]:
    """Stack per-scenario replacement arrays into [S, ...] batches.

    The union of touched fields is batched; scenarios that left a field
    untouched contribute the base array, so every scenario sees a fully
    consistent world."""
    fields = sorted({name for ov in overlays for name in ov})
    stacked: dict[str, np.ndarray] = {}
    for name in fields:
        base = getattr(problem, name)
        stacked[name] = np.stack(
            [np.asarray(ov.get(name, base)) for ov in overlays])
    return stacked


def pad_scenario_axis(stacked: dict[str, np.ndarray], target_s: int,
                      ) -> dict[str, np.ndarray]:
    """Pad the scenario axis to ``target_s`` with inert repeats of
    scenario 0 (results beyond the real S are sliced off)."""
    if not stacked:
        return stacked
    S = next(iter(stacked.values())).shape[0]
    if target_s <= S:
        return stacked
    out = {}
    for name, arr in stacked.items():
        reps = np.repeat(arr[:1], target_s - S, axis=0)
        out[name] = np.concatenate([arr, reps], axis=0)
    return out


def _maybe_shard_scenarios(stacked: dict, mesh) -> tuple[list, int]:
    """Block-shard the scenario axis over the solver mesh when it
    divides evenly: ([(device, block overlay)] in shard order, width);
    otherwise ([(None, stacked)], 0) for the single-device path."""
    from kueue_oss_tpu_torch.solver.meshutil import mesh_devices

    n = mesh_devices(mesh)
    S = next(iter(stacked.values())).shape[0]
    if n < 2 or S % n != 0:
        return [(None, stacked)], 0
    b = S // n
    return [(dev, {name: arr[s * b:(s + 1) * b]
                   for name, arr in stacked.items()})
            for s, dev in enumerate(mesh.devices)], n


def _fetch(out) -> tuple:
    return tuple(a.cpu().numpy() for a in out)


def solve_scenarios(problem: SolverProblem, overlays: list[dict],
                    tensors: Optional[ProblemTensors] = None,
                    mesh=None, pad_pow2: bool = True, device="cuda",
                    ) -> BatchSolveResult:
    """Solve every scenario overlay of ``problem`` in one batched drain.

    ``problem`` must already be workload-axis padded (pad_workloads).
    ``tensors`` lets callers reuse uploaded tensors (their device then
    wins); by default the base problem uploads once to ``device`` and is
    shared (unbatched) across the whole batch.
    """
    if not overlays:
        raise ValueError("need at least one scenario overlay")
    S = len(overlays)
    stacked = stack_overlays(problem, overlays)
    if not stacked:
        # every scenario equals the base problem (a pure-base sweep):
        # batch a no-op field so shapes still carry the scenario axis
        stacked = {"usage0": np.repeat(problem.usage0[None], S, axis=0)}
    target_s = pow2(S) if pad_pow2 else S
    stacked = pad_scenario_axis(stacked, target_s)
    blocks, mesh_devs = _maybe_shard_scenarios(stacked, mesh)
    if tensors is None:
        tensors = to_device(problem, mesh.lead if mesh_devs
                            else resolve_device(device))
    counts = {"host_reads": 0}
    t0 = time.monotonic()
    if mesh_devs:
        from kueue_oss_tpu_torch.solver import meshutil

        parts = [solve_backlog_batched(
            type(tensors)(*(a.to(dev) for a in tensors)), block, counts)
            for dev, block in blocks]
        out = _fetch(meshutil.all_gather(mesh, [p[k] for p in parts])[0]
                     for k in range(len(parts[0])))
    else:
        out = _fetch(solve_backlog_batched(tensors, stacked, counts))
    wall = time.monotonic() - t0
    admitted, opt, admit_round, parked, rounds, usage = out
    return BatchSolveResult(
        admitted=admitted[:S], opt=opt[:S], admit_round=admit_round[:S],
        parked=parked[:S], rounds=rounds[:S], usage=usage[:S],
        batch_width=target_s, solve_seconds=wall,
        host_reads=counts["host_reads"] + 1, mesh_devices=mesh_devs)


def predict_rounds(problem: SolverProblem,
                   overlays: list[dict]) -> np.ndarray:
    """Cheap per-scenario proxy for the drain's round count: the
    deepest per-CQ live backlog under each overlay.

    The batched loop runs every lane to the SLOWEST lane's round count
    (finished lanes freeze but still ride the launches), so a batch
    mixing a 3-round scenario with a 60-round one wastes ~95% of the
    short lane's work. Per-CQ depth upper-bounds the admission rounds
    (one head decision per CQ per round) and is O(W) to compute, making
    it the bucketing key."""
    C = problem.n_cqs
    base = {name: np.asarray(getattr(problem, name))
            for name in ("wl_cqid", "wl_rank", "wl_valid")}
    preds = np.empty(len(overlays), dtype=np.int64)
    for i, ov in enumerate(overlays):
        cqid = np.asarray(ov.get("wl_cqid", base["wl_cqid"]))
        rank = np.asarray(ov.get("wl_rank", base["wl_rank"]))
        valid = np.asarray(ov.get("wl_valid", base["wl_valid"]))
        live = ((cqid[:-1] < C) & (rank[:-1] < BIG)
                & valid[:-1].any(axis=1))
        depth = np.bincount(cqid[:-1][live], minlength=C + 1)[:C]
        preds[i] = int(depth.max()) if depth.size else 0
    return preds


def solve_scenarios_bucketed(
        problem: SolverProblem, overlays: list[dict],
        tensors: Optional[ProblemTensors] = None, mesh=None,
        pad_pow2: bool = True, min_batch: int = 8, device="cuda",
        ) -> tuple[BatchSolveResult, dict[int, int], int]:
    """Round-skew bucketing: group scenarios by pow2(predicted round
    count) and dispatch each bucket as its own batch, so short
    scenarios stop riding a batch to the longest scenario's round
    count. Results stitch back into the ORIGINAL scenario order —
    per-scenario plans are bit-identical to the unbucketed batch (lanes
    never interact), which the parity oracle still verifies.

    Returns (stitched result, {pow2 round bucket -> scenario count},
    dispatch count). Sweeps below ``min_batch`` wide, or whose
    predictions land in one bucket, dispatch unbucketed."""
    preds = predict_rounds(problem, overlays)
    buckets: dict[int, list[int]] = {}
    for i, p in enumerate(preds):
        buckets.setdefault(pow2(max(int(p), 1)), []).append(i)
    stats = {b: len(idxs) for b, idxs in sorted(buckets.items())}
    if tensors is None and len(buckets) > 1:
        # upload the shared base tensors ONCE for every bucket's drain
        tensors = to_device(problem, resolve_device(device))
    if len(overlays) < min_batch or len(buckets) < 2:
        return (solve_scenarios(problem, overlays, tensors=tensors,
                                mesh=mesh, pad_pow2=pad_pow2,
                                device=device), stats, 1)
    S = len(overlays)
    parts = []
    for b in sorted(buckets):
        idxs = buckets[b]
        parts.append((idxs, solve_scenarios(
            problem, [overlays[i] for i in idxs], tensors=tensors,
            mesh=mesh, pad_pow2=pad_pow2, device=device)))
    first = parts[0][1]

    def stitched(name):
        ref = getattr(first, name)
        out = np.empty((S,) + ref.shape[1:], dtype=ref.dtype)
        for idxs, r in parts:
            out[idxs] = getattr(r, name)
        return out

    return (BatchSolveResult(
        admitted=stitched("admitted"), opt=stitched("opt"),
        admit_round=stitched("admit_round"), parked=stitched("parked"),
        rounds=stitched("rounds"), usage=stitched("usage"),
        batch_width=sum(r.batch_width for _, r in parts),
        solve_seconds=sum(r.solve_seconds for _, r in parts),
        host_reads=sum(r.host_reads for _, r in parts),
        mesh_devices=max(r.mesh_devices for _, r in parts)),
        stats, len(parts))


def solve_scenarios_sequential(problem: SolverProblem,
                               overlays: list[dict],
                               tensors: Optional[ProblemTensors] = None,
                               device="cuda") -> BatchSolveResult:
    """The oracle path: each scenario solved alone through the exact
    single-problem drain (``solve_backlog``). Bit-identical to the
    batch by construction; kept for parity checks and the
    batched-vs-sequential speedup measurement."""
    if tensors is None:
        tensors = to_device(problem, resolve_device(device))
    dev = tensors.wl_rank.device
    outs = []
    t0 = time.monotonic()
    for ov in overlays:
        t = tensors._replace(**{
            k: torch.as_tensor(np.ascontiguousarray(v), device=dev)
            for k, v in ov.items()})
        outs.append(_fetch(solve_backlog(t)))
    wall = time.monotonic() - t0
    return BatchSolveResult(
        admitted=np.stack([o[0] for o in outs]),
        opt=np.stack([o[1] for o in outs]),
        admit_round=np.stack([o[2] for o in outs]),
        parked=np.stack([o[3] for o in outs]),
        rounds=np.stack([o[4] for o in outs]),
        usage=np.stack([o[5] for o in outs]),
        batch_width=1, solve_seconds=wall,
        host_reads=sum(int(o[4]) + 1 for o in outs))


@dataclass
class ParityResult:
    checked: int = 0
    identical: bool = True
    mismatches: list = field(default_factory=list)


def check_parity(batch: BatchSolveResult, seq: BatchSolveResult,
                 indices) -> ParityResult:
    """Bitwise plan comparison between the batch and the sequential
    oracle for the given scenario indices."""
    res = ParityResult()
    for pos, i in enumerate(indices):
        res.checked += 1
        for name, a, b in (
                ("admitted", batch.admitted[i], seq.admitted[pos]),
                ("opt", batch.opt[i], seq.opt[pos]),
                ("admit_round", batch.admit_round[i],
                 seq.admit_round[pos]),
                ("parked", batch.parked[i], seq.parked[pos]),
                ("rounds", batch.rounds[i], seq.rounds[pos]),
                ("usage", batch.usage[i], seq.usage[pos])):
            if not np.array_equal(np.asarray(a), np.asarray(b)):
                res.identical = False
                res.mismatches.append({"scenario": int(i),
                                       "field": name})
    return res


# ---------------------------------------------------------------------------
# FULL-kernel sweeps: lane-budgeted chunking + relax approximate tier
# ---------------------------------------------------------------------------

#: per-row tier markers in tiered sweep results
FULL_TIER = "full"
RELAX_TIER = "relax"

#: lean overlay field -> FullTensors field. Identity unless listed;
#: ``wl_rank`` has no FULL twin (the FULL drain selects heads by
#: (priority, ts, uid) and masked rows leave the per-CQ segment
#: reductions through ``wl_cqid = C`` + ``wl_valid = False``, which
#: every arrival overlay sets alongside the rank).
_FULL_RENAME = {"wl_ts": "wl_ts0"}
_FULL_DROP = frozenset({"wl_rank"})


def to_full_fields(fields: dict) -> dict:
    """Translate a lean overlay dict (SolverProblem field names) to the
    FULL drain's FullTensors field names."""
    return {_FULL_RENAME.get(k, k): v for k, v in fields.items()
            if k not in _FULL_DROP}


def full_caps(problem: SolverProblem, h_cap: int = 64,
              h_work_budget: int = 512) -> tuple[int, int, int]:
    """Static caps (g_max, h_max, p_max) for a FULL-kernel sweep.

    A lighter sizing than the drain engine's: the engine optimizes the
    round latency of ONE live drain, while a sweep multiplies every lane
    by S, so lanes here default to the CQ count under a smaller work
    budget. The caps depend on the problem alone (never on the device),
    so the card and the CPU run the same program. Chunked/sequential
    parity holds for ANY caps because both paths share them."""
    C = problem.n_cqs
    K = problem.wl_req.shape[1] if problem.wl_req.ndim == 3 else 1
    g_max = max(1, int(problem.cq_ngroups.max()) if C else 1)
    lane_cap = max(16, pow2(
        max(1, h_work_budget // max(K * g_max, 1)) + 1) // 2)
    h_max = max(1, pow2(min(max(C, 1), h_cap, lane_cap)))
    if C:
        wl_root = np.asarray(problem.cq_root)[
            np.minimum(np.asarray(problem.wl_cqid)[:-1], C - 1)]
        counts = np.bincount(wl_root, minlength=problem.n_nodes + 1)
        pop = int(counts.max()) if counts.size else 1
    else:
        pop = 1
    return g_max, h_max, pow2(max(8, pop))


def _pow2_floor(n: int) -> int:
    return 1 << (int(n).bit_length() - 1) if n >= 1 else 0


@dataclass
class SweepPlan:
    """A lane-budget dispatch plan over S scenarios (see LaneBudget)."""

    #: contiguous (start, width) FULL-tier chunks, in scenario order
    chunks: list = field(default_factory=list)
    #: scenarios solved exactly (the prefix [0, full_count))
    full_count: int = 0
    #: scenario indices re-tiered to the relax LP, with the reason —
    #: NEVER silent: plan() logs every entry
    relax_idx: list = field(default_factory=list)
    retier_reason: Optional[str] = None
    #: pow2 chunk width the budget allows (0: one scenario > budget)
    chunk_width: int = 0
    #: the planner's per-scenario device-byte estimate
    per_scenario_bytes: int = 0


@dataclass
class LaneBudget:
    """Sizes FULL-sweep chunks from a device-byte budget.

    The FULL drain's round fans out h_max x K victim searches, each
    carrying its own [N+1, F] usage walk and [p_max] candidate columns;
    batching S scenarios multiplies ALL of that by S. The planner
    estimates the per-scenario transient footprint (``lane_bytes``),
    floors the scenario chunk to a power of two that fits
    ``budget_bytes``, and dispatches ceil(S / chunk) chunks — the uneven
    tail pads to its own pow2 width with inert repeats.

    Two re-tier conditions route scenarios to the relax LP instead
    (reported per row and in the log): a single scenario exceeding the
    budget (chunk width 0), or a mega-sweep beyond
    ``max_full_scenarios`` (overflow rows only).
    """

    budget_bytes: int = 256 << 20
    #: hard cap on exactly-solved scenarios per sweep; overflow rows
    #: are relax-tier (mega-sweep triage, not a silent truncation)
    max_full_scenarios: int = 256

    def lane_bytes(self, problem: SolverProblem, g_max: int,
                   h_max: int, p_max: int) -> int:
        """Per-scenario device bytes of the dominant sweep state."""
        W1 = problem.wl_cqid.shape[0]
        N1 = problem.parent.shape[0]
        F = problem.wl_req.shape[-1]
        K = problem.wl_req.shape[1] if problem.wl_req.ndim == 3 else 1
        D = problem.path.shape[1]
        lanes = h_max * K
        # each victim-search lane: ~3 usage walks [N+1, F] i32 plus
        # [p_max] candidate columns (usage [F], path [D] x2, ancestor
        # [D, D] bool, ~16 scalar i32 columns)
        per_lane = (3 * N1 * F * 4
                    + p_max * (F * 4 + 2 * D * 4 + D * D + 16 * 4))
        # plan/state rows: per-workload plan + usage tables + the
        # [N+1, p_max] candidate table the searches gather from
        state = (W1 * (F * 4 + 8 * g_max + 28)
                 + 2 * N1 * F * 4 + N1 * p_max * 4)
        return lanes * per_lane + state

    def chunk_width_for(self, problem: SolverProblem, g_max: int,
                        h_max: int, p_max: int) -> int:
        per = self.lane_bytes(problem, g_max, h_max, p_max)
        return _pow2_floor(self.budget_bytes // per)

    def plan(self, n_scenarios: int, problem: SolverProblem,
             g_max: int, h_max: int, p_max: int) -> SweepPlan:
        """Plan chunks + tiers for ``n_scenarios``; logs every re-tier."""
        per = self.lane_bytes(problem, g_max, h_max, p_max)
        width = _pow2_floor(self.budget_bytes // per)
        plan = SweepPlan(chunk_width=width, per_scenario_bytes=per)
        if width == 0:
            plan.relax_idx = list(range(n_scenarios))
            plan.retier_reason = "scenario_exceeds_lane_budget"
        else:
            plan.full_count = min(n_scenarios, self.max_full_scenarios)
            plan.relax_idx = list(range(plan.full_count, n_scenarios))
            if plan.relax_idx:
                plan.retier_reason = "sweep_above_full_cap"
            start = 0
            while start < plan.full_count:
                w = min(width, plan.full_count - start)
                plan.chunks.append((start, w))
                start += w
        if plan.relax_idx:
            metrics.whatif_retier_total.inc(plan.retier_reason,
                                            by=len(plan.relax_idx))
            log.warning(
                "lane budget re-tiered %d/%d scenarios to the relax "
                "LP (%s): indices %s (budget %d B, per-scenario %d B, "
                "chunk %d)", len(plan.relax_idx), n_scenarios,
                plan.retier_reason, plan.relax_idx[:16],
                self.budget_bytes, per, width)
        return plan


@dataclass
class FullSweepResult:
    """Stacked FULL-kernel plans for S scenarios (numpy, leading
    scenario axis). Superset of BatchSolveResult: the preemption drain
    also reports per-workload usage and victim reasons."""

    admitted: np.ndarray       # [S, W+1] bool
    opt: np.ndarray            # [S, W+1, g] int32
    admit_round: np.ndarray    # [S, W+1] int32
    parked: np.ndarray         # [S, W+1] bool
    rounds: np.ndarray         # [S] int32
    usage: np.ndarray          # [S, N+1, F] int32
    wl_usage: np.ndarray       # [S, W+1, F] int32
    victim_reason: np.ndarray  # [S, W+1] int8
    #: per-scenario solve tier ("full" exact / "relax" approximate)
    tier: list = field(default_factory=list)
    #: scenario indices the budget re-tiered, and why (audit trail)
    retier_idx: list = field(default_factory=list)
    retier_reason: Optional[str] = None
    #: FULL-tier chunk widths dispatched, in order
    chunks: list = field(default_factory=list)
    batch_width: int = 0
    solve_seconds: float = 0.0
    #: host reads of the FULL drains (every round's live read and the
    #: inner loops' reads) plus one read-back per chunk
    host_reads: int = 0
    #: per FULL-tier chunk: dispatched width, wall seconds, host rounds
    #: and host reads
    chunk_stats: list = field(default_factory=list)

    def plan(self, i: int) -> tuple:
        """The lean six-tuple plan contract for scenario ``i`` (opt
        collapsed to the first group's choice for KPI consumers)."""
        opt = self.opt[i]
        return (self.admitted[i], opt[..., 0] if opt.ndim == 2 else opt,
                self.admit_round[i], self.parked[i], self.rounds[i],
                self.usage[i])

    def preemptions(self, i: int, n_workloads: int) -> int:
        return int((self.victim_reason[i][:n_workloads] > 0).sum())


def _full_tensors(problem: SolverProblem, device):
    from kueue_oss_tpu_torch.solver.full_kernels import to_device_full

    return to_device_full(problem, resolve_device(device))


def _afs(problem: SolverProblem) -> bool:
    """Whether the base problem has an admission-fair-sharing CQ (the
    FULL drain's ``afs`` switch; ``cq_afs`` is not an overlay field)."""
    return problem.cq_afs is not None and bool(np.any(problem.cq_afs))


def sweep_order(specs) -> list[int]:
    """Skew-aware dispatch order for a chunked FULL sweep.

    A chunk's lanes all ride to the chunk's MAX drain-round count
    (finished lanes freeze), so one contended scenario in a chunk bills
    its round count to every lane sharing the drain. Grouping scenarios
    with similar expected contention — identical quota cuts first, then
    backlog fraction — keeps each chunk's max near its mean. Returns a
    permutation of ``range(len(specs))`` for ``solve_scenarios_full(...,
    order=)``; the stitch inverts it, so results stay in caller order
    (and bitwise identical — lane membership never changes lane
    arithmetic)."""
    def key(s):
        qs = tuple(sorted((str(k), float(v))
                          for k, v in (s.quota_scale or {}).items()))
        return (min((f for _, f in qs), default=1.0), qs,
                -float(getattr(s, "arrival_scale", 1.0) or 1.0))

    return sorted(range(len(specs)), key=lambda i: key(specs[i]))


def solve_scenarios_full(problem: SolverProblem, overlays: list[dict],
                         g_max: int, h_max: int, p_max: int,
                         tensors=None, chunk: int = 0,
                         pad_pow2: bool = True,
                         order: Optional[list] = None,
                         device="cuda") -> FullSweepResult:
    """Solve every scenario overlay through the FULL preemption drain in
    lane-budgeted chunks of ``solve_backlog_full_batched``.

    ``overlays`` use LEAN field names (the scenario layer's contract);
    translation to FullTensors names happens after stacking. ``chunk``
    is the LaneBudget chunk width (0 = everything in one drain); chunks
    are contiguous ranges of the dispatch sequence, so the stitch is a
    concatenate — bitwise identical to the sequential FULL oracle at any
    chunk width because lanes never interact. ``order`` (a permutation
    of the scenario indices, e.g. ``sweep_order(specs)``) picks the
    dispatch sequence and the stitch inverts it, so results are ALWAYS
    in ``overlays`` order. ``tensors`` (uploaded FullTensors) win over
    ``device``."""
    from kueue_oss_tpu_torch.solver.full_kernels import (
        FullDrainStats,
        solve_backlog_full_batched,
    )

    if not overlays:
        raise ValueError("need at least one scenario overlay")
    S = len(overlays)
    if order is not None:
        order = [int(i) for i in order]
        if sorted(order) != list(range(S)):
            raise ValueError(
                "order must be a permutation of the scenario indices")
        dispatch = [overlays[i] for i in order]
    else:
        dispatch = overlays
    if tensors is None:
        tensors = _full_tensors(problem, device)
    afs = _afs(problem)
    width = chunk if chunk else S
    parts = []
    chunk_widths = []
    chunk_stats = []
    total_width = 0
    reads = 0
    t0 = time.monotonic()
    for start in range(0, S, width):
        ovs = dispatch[start:start + width]
        stacked = stack_overlays(problem, ovs)
        if not stacked:
            stacked = {"usage0": np.repeat(problem.usage0[None],
                                           len(ovs), axis=0)}
        stacked = to_full_fields(stacked)
        target_s = pow2(len(ovs)) if pad_pow2 else len(ovs)
        stacked = pad_scenario_axis(stacked, target_s)
        stats = FullDrainStats()
        t1 = time.monotonic()
        out = _fetch(solve_backlog_full_batched(
            tensors, stacked, g_max, h_max=h_max, p_max=p_max,
            stats=stats, afs=afs))
        parts.append(tuple(a[:len(ovs)] for a in out))
        chunk_widths.append(target_s)
        total_width += target_s
        reads += stats.syncs + 1
        metrics.whatif_full_chunks_total.inc()
        chunk_stats.append({"width": target_s,
                            "seconds": time.monotonic() - t1,
                            "rounds": stats.rounds,
                            "host_reads": stats.syncs + 1})
    wall = time.monotonic() - t0
    fields = [np.concatenate([p[j] for p in parts]) for j in range(8)]
    if order is not None:  # stitch back to caller (overlays) order
        inv = np.argsort(np.asarray(order, dtype=np.int64))
        fields = [f[inv] for f in fields]
    return FullSweepResult(
        *fields, tier=[FULL_TIER] * S, chunks=chunk_widths,
        batch_width=total_width, solve_seconds=wall, host_reads=reads,
        chunk_stats=chunk_stats)


def solve_scenarios_sequential_full(
        problem: SolverProblem, overlays: list[dict],
        g_max: int, h_max: int, p_max: int,
        tensors=None, device="cuda") -> FullSweepResult:
    """The FULL-kernel oracle: each scenario solved alone through
    ``solve_backlog_full``. Parity target for the chunked sweep; never
    a fallback of it."""
    from kueue_oss_tpu_torch.solver.full_kernels import (
        FullDrainStats,
        solve_backlog_full,
    )

    if not overlays:
        raise ValueError("need at least one scenario overlay")
    if tensors is None:
        tensors = _full_tensors(problem, device)
    dev = tensors.wl_cqid.device
    afs = _afs(problem)
    outs = []
    stats = FullDrainStats()
    t0 = time.monotonic()
    for ov in overlays:
        t = tensors._replace(**{
            k: torch.tensor(np.asarray(v), dtype=getattr(tensors, k).dtype,
                            device=dev)
            for k, v in to_full_fields(ov).items()})
        outs.append(_fetch(solve_backlog_full(
            t, g_max, h_max=h_max, p_max=p_max, stats=stats, afs=afs)))
    wall = time.monotonic() - t0
    return FullSweepResult(
        *[np.stack([o[j] for o in outs]) for j in range(8)],
        tier=[FULL_TIER] * len(overlays), batch_width=1,
        solve_seconds=wall, host_reads=stats.syncs + len(outs))


#: result-field names of the FULL plan, in drain output order
_FULL_FIELDS = ("admitted", "opt", "admit_round", "parked", "rounds",
                "usage", "wl_usage", "victim_reason")


def check_parity_full(batch: FullSweepResult, seq: FullSweepResult,
                      indices) -> ParityResult:
    """Bitwise plan comparison for FULL sweeps — all eight output
    tensors, including per-workload usage and victim reasons."""
    res = ParityResult()
    for pos, i in enumerate(indices):
        res.checked += 1
        for name in _FULL_FIELDS:
            a = getattr(batch, name)[i]
            b = getattr(seq, name)[pos]
            if not np.array_equal(np.asarray(a), np.asarray(b)):
                res.identical = False
                res.mismatches.append({"scenario": int(i),
                                       "field": name})
    return res


def stack_relax_lps(problem: SolverProblem, overlays: list[dict]):
    """Each overlay's world of ``problem`` and its relaxed LP, and the
    LPs stacked on a leading scenario axis (numpy): (problems, lps,
    stacked)."""
    import dataclasses

    from kueue_oss_tpu_torch.solver.relax import RelaxLP, build_lp

    probs, lps = [], []
    for ov in overlays:
        p = (dataclasses.replace(
            problem, **{k: np.asarray(v) for k, v in ov.items()})
            if ov else problem)
        probs.append(p)
        lps.append(build_lp(p))
    stacked = RelaxLP(*[np.stack([getattr(lp, f) for lp in lps])
                        for f in RelaxLP._fields])
    return probs, lps, stacked


def solve_scenarios_relax(problem: SolverProblem, overlays: list[dict],
                          iters: int = 32,
                          device="cuda") -> FullSweepResult:
    """The approximate tier: the relaxed LP of every scenario in one
    ``cuda_relax.relax_lp`` call (one kernel launch on the card, the
    plain loop per scenario on the CPU), then per scenario the rounding
    and the exact repair on the small support, on ``device``. Fit-only
    by construction: no victims are modeled."""
    from kueue_oss_tpu_torch.solver import cuda_relax
    from kueue_oss_tpu_torch.solver.relax import (
        lp_to_device,
        repair,
        rounded_support,
    )

    if not overlays:
        raise ValueError("need at least one scenario overlay")
    device = resolve_device(device)
    t0 = time.monotonic()
    probs, lps, stacked = stack_relax_lps(problem, overlays)
    index = None if device.type == "cpu" else cuda_relax.lp_index(
        stacked.wl_cqid, stacked.parent, stacked.cq_node, problem.n_cqs,
        live=stacked.live)
    xs = cuda_relax.relax_lp(lp_to_device(stacked, device), iters,
                             index).cpu().numpy()
    S = len(overlays)
    W1 = problem.wl_cqid.shape[0]
    N1 = problem.parent.shape[0]
    F = problem.wl_req.shape[-1]
    out = FullSweepResult(
        admitted=np.zeros((S, W1), dtype=bool),
        opt=np.zeros((S, W1), dtype=np.int32),
        admit_round=np.zeros((S, W1), dtype=np.int32),
        parked=np.zeros((S, W1), dtype=bool),
        rounds=np.zeros(S, dtype=np.int32),
        usage=np.zeros((S, N1, F), dtype=np.int32),
        wl_usage=np.zeros((S, W1, F), dtype=np.int32),
        victim_reason=np.zeros((S, W1), dtype=np.int8),
        tier=[RELAX_TIER] * S, batch_width=S)
    for i, (p, lp) in enumerate(zip(probs, lps)):
        sel = rounded_support(xs[i], p, np.asarray(lp.live))
        (admitted, opt, admit_round, parked, rounds, usage), _ = repair(
            p, sel, np.asarray(lp.live), device=device)
        out.admitted[i] = admitted
        out.opt[i] = opt
        out.admit_round[i] = admit_round
        out.parked[i] = parked
        out.rounds[i] = rounds
        out.usage[i] = usage
    out.solve_seconds = time.monotonic() - t0
    return out


def solve_scenarios_tiered(problem: SolverProblem,
                           overlays: list[dict],
                           budget: Optional[LaneBudget] = None,
                           caps: Optional[tuple] = None,
                           tensors=None, relax_iters: int = 32,
                           pad_pow2: bool = True,
                           order: Optional[list] = None,
                           device="cuda") -> FullSweepResult:
    """The sweep entry the what-if engine uses: LaneBudget plans the
    chunks and tiers, FULL chunks solve exactly, overflow solves on the
    relax tier, and the stitched result carries a per-row ``tier`` plus
    the re-tier audit trail. ``order`` is the skew-aware dispatch
    permutation over ALL scenarios (``sweep_order``); the FULL-tier
    subset dispatches in its induced sub-order. The relax rows run on
    ``device`` (the device of ``tensors`` when given)."""
    if not overlays:
        raise ValueError("need at least one scenario overlay")
    budget = budget or LaneBudget()
    g_max, h_max, p_max = caps or full_caps(problem)
    if tensors is not None:
        device = tensors.wl_cqid.device
    plan = budget.plan(len(overlays), problem, g_max, h_max, p_max)
    parts = []
    if plan.full_count:
        sub_order = None
        if order is not None:
            rank = {int(i): k for k, i in enumerate(order)}
            sub_order = sorted(range(plan.full_count),
                               key=lambda i: rank.get(i, i))
        parts.append(solve_scenarios_full(
            problem, overlays[:plan.full_count], g_max, h_max, p_max,
            tensors=tensors, chunk=plan.chunk_width,
            pad_pow2=pad_pow2, order=sub_order, device=device))
    if plan.relax_idx:
        parts.append(solve_scenarios_relax(
            problem, [overlays[i] for i in plan.relax_idx],
            iters=relax_iters, device=device))
    if len(parts) == 1:
        res = parts[0]
    else:
        full, relax = parts
        # opt shapes differ across tiers ([W+1, g] vs [W+1]): widen the
        # relax rows to the FULL layout (choice in group 0)
        r_opt = relax.opt
        if full.opt.ndim == 3 and r_opt.ndim == 2:
            widened = np.zeros(
                (r_opt.shape[0],) + full.opt.shape[1:],
                dtype=full.opt.dtype)
            widened[..., 0] = r_opt
            r_opt = widened
        res = FullSweepResult(
            *[np.concatenate([getattr(full, n),
                              r_opt if n == "opt"
                              else getattr(relax, n)])
              for n in _FULL_FIELDS],
            tier=full.tier + relax.tier,
            batch_width=full.batch_width + relax.batch_width,
            solve_seconds=full.solve_seconds + relax.solve_seconds,
            host_reads=full.host_reads, chunk_stats=full.chunk_stats)
        res.chunks = full.chunks
    res.retier_idx = plan.relax_idx
    res.retier_reason = plan.retier_reason
    return res

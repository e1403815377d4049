"""Batched solve layer: S counterfactual worlds, one batched drain.

A copy of the lean half of ``kueue_oss_tpu/sim/batch.py``. The lean
drain solves ONE padded admission problem; this module stacks S
scenario overlays of that problem along a leading scenario axis and
runs ``kernels.solve_backlog_batched`` (the same drain with an explicit
scenario axis), so S counterfactual admission cycles share every
round's launches. The lean drain is pure integer/boolean arithmetic and
the batched loop freezes finished lanes, so the batched plans are
**bit-identical** to solving each scenario alone — the sequential path
below is kept as the per-scenario oracle and the parity check is part
of the report.

Scenario-axis padding mirrors the JAX package's (a power of two, inert
repeats of scenario 0). ``solve_scenarios_relax`` is the approximate
relax tier of the FULL sweeps: the S scenarios' relaxed LPs in one
launch of the relax kernel (one cluster per scenario, the JAX
``jit(vmap(lp_loop))``), then each scenario's rounding and exact repair.
The rest of the FULL-kernel sweeps (the lane budget, the FULL tier and
the tiered dispatch) wait for ROADMAP Queue A item 7b; the
scenario-axis mesh for item 9.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Optional

import numpy as np
import torch

from kueue_oss_tpu_torch.device import resolve_device
from kueue_oss_tpu_torch.solver.kernels import (
    ProblemTensors,
    solve_backlog,
    solve_backlog_batched,
    to_device,
)
from kueue_oss_tpu_torch.solver.tensors import BIG, SolverProblem, pow2


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


def _maybe_shard_scenarios(mesh) -> None:
    """The single-device path only: a scenario-axis mesh is ROADMAP
    Queue A item 9."""
    if mesh is not None:
        raise NotImplementedError(
            "scenario-axis sharding over a device mesh: ROADMAP Queue A "
            "item 9")


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
    _maybe_shard_scenarios(mesh)
    if tensors is None:
        tensors = to_device(problem, resolve_device(device))
    counts = {"host_reads": 0}
    t0 = time.monotonic()
    out = _fetch(solve_backlog_batched(tensors, stacked, counts))
    wall = time.monotonic() - t0
    admitted, opt, admit_round, parked, rounds, usage = out
    return BatchSolveResult(
        admitted=admitted[:S], opt=opt[:S], admit_round=admit_round[:S],
        parked=parked[:S], rounds=rounds[:S], usage=usage[:S],
        batch_width=target_s, solve_seconds=wall,
        host_reads=counts["host_reads"] + 1)


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
        host_reads=sum(r.host_reads for _, r in parts)),
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
# The relax tier of the FULL-kernel sweeps
# ---------------------------------------------------------------------------

#: per-row tier markers in tiered sweep results
FULL_TIER = "full"
RELAX_TIER = "relax"


@dataclass
class FullSweepResult:
    """Stacked plans of S scenarios from the relax tier (numpy,
    leading scenario axis). The FULL tier's per-workload usage, victim
    reasons and re-tier trail come with ROADMAP Queue A item 7b."""

    admitted: np.ndarray       # [S, W+1] bool
    opt: np.ndarray            # [S, W+1, g] int32
    admit_round: np.ndarray    # [S, W+1] int32
    parked: np.ndarray         # [S, W+1] bool
    rounds: np.ndarray         # [S] int32
    usage: np.ndarray          # [S, N+1, F] int32
    #: per-scenario solve tier ("full" exact / "relax" approximate)
    tier: list = field(default_factory=list)
    batch_width: int = 0
    solve_seconds: float = 0.0

    def plan(self, i: int) -> tuple:
        """The lean six-tuple plan contract for scenario ``i`` (opt
        collapsed to the first group's choice for KPI consumers)."""
        opt = self.opt[i]
        return (self.admitted[i], opt[..., 0] if opt.ndim == 2 else opt,
                self.admit_round[i], self.parked[i], self.rounds[i],
                self.usage[i])


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
